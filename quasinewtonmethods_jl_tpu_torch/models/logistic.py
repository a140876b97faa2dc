"""Bayesian logistic-regression MAP objective — the PyTorch port of
``quasinewtonmethods_jl_tpu/models/logistic.py``.

BASELINE.md config 3 (n = 100 parameters, 500 observations): the
representative statistical log-density of the reference's use, MAP and
mode-finding as HMC chain initialisation (reference README.md:14). The
log-posterior is

  Σ_i [y_i log σ(x_iᵀw) + (1 - y_i) log σ(-x_iᵀw)] - ‖w‖² / (2 σ_prior²),

with log σ as `torch.nn.functional.logsigmoid` (the stable form of
``jax.nn.log_sigmoid``). Like the JAX model it has no analytic gradient:
`ProbabilityModel` derives it with ``torch.func``.

JAX draws the design X, the true weights and the labels y with
``jax.random``, which torch cannot reproduce: the port's model takes ``X``
(n_obs, n) and ``y`` (n_obs,) as arrays (how the tests and `chip_smoke.py`
carry one dataset to both packages), and otherwise draws them by JAX's
recipe from a ``torch.Generator`` seeded with ``seed``, on the CPU so that
every device gets the same draw: X = N(0, 1) / sqrt(n), w_true = N(0, 1),
y = 1[u < σ(X w_true)] with u uniform. The model's tensors follow the
point it is evaluated at (device and dtype); pass ``device=`` and
``dtype=`` of the solve to spare a copy per evaluation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import ProbabilityModel

__all__ = ["LogisticRegressionMAP"]


def _tensor(a, dtype, device):
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.array(a))  # a writable copy (JAX arrays are not)
    return a.to(dtype=dtype, device=device)


class LogisticRegressionMAP(ProbabilityModel):
    """Logistic-regression posterior over ``dimension`` weights, its data
    ``X`` (n_obs, dimension) and ``y`` (n_obs,) kept on ``device`` in
    ``dtype``."""

    def __init__(self, dimension: int = 100, n_obs: int = 500, prior_scale: float = 10.0,
                 seed: int = 0, dtype=torch.float64, device=None, X=None, y=None):
        super().__init__(dimension)
        if (X is None) != (y is None):
            raise ValueError("pass both X and y, or neither")
        if X is None:
            gen = torch.Generator().manual_seed(seed)
            X = torch.randn(n_obs, dimension, generator=gen, dtype=dtype) / (
                torch.sqrt(torch.tensor(float(dimension), dtype=dtype)))
            w_true = torch.randn(dimension, generator=gen, dtype=dtype)
            u = torch.rand(n_obs, generator=gen, dtype=dtype)
            y = (u < torch.sigmoid(X @ w_true)).to(dtype)
        self.X = _tensor(X, dtype, device)
        self.y = _tensor(y, dtype, device)
        if self.X.shape != (self.X.shape[0], dimension) or self.y.shape != self.X.shape[:1]:
            raise ValueError(f"X must be (n_obs, {dimension}) and y (n_obs,), got "
                             f"{tuple(self.X.shape)} and {tuple(self.y.shape)}")
        self.prior_scale = float(prior_scale)

    @property
    def n_obs(self) -> int:
        return self.X.shape[0]

    def _on(self, w):
        """X and y on w's device and in its dtype."""
        return (self.X.to(device=w.device, dtype=w.dtype),
                self.y.to(device=w.device, dtype=w.dtype))

    def logdensity(self, w):
        X, y = self._on(w)
        logits = X @ w
        # y log σ(z) + (1 - y) log(1 - σ(z)) = y log σ(z) + (1 - y) log σ(-z)
        loglik = torch.sum(
            y * torch.nn.functional.logsigmoid(logits)
            + (1.0 - y) * torch.nn.functional.logsigmoid(-logits)
        )
        logprior = -0.5 * torch.sum(w * w) / (self.prior_scale**2)
        return loglik + logprior
