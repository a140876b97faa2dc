"""Poisson GLM log-posterior (count-data MAP) — the PyTorch port of
``quasinewtonmethods_jl_tpu/models/poisson.py``.

Counts with a log link,

    y_i ~ Poisson(exp(x_iᵀw)),   w ~ N(0, prior_scale² I),

log-posterior (dropping the data-only log y! term)

    Σ_i [ y_i·x_iᵀw − exp(x_iᵀw) ] − ‖w‖²/(2·prior_scale²).

Strictly concave in w; unlike the logistic fixture its exp() overflows at
bad iterates, which exercises the line search's finite halving. Like the
JAX model it has no analytic gradient: `ProbabilityModel` derives it with
``torch.func``.

JAX draws X, the true weights and y with ``jax.random``, which torch cannot
reproduce: the port's model takes ``X`` (n_obs, n) and ``y`` (n_obs,) as
arrays (how the tests and `chip_smoke.py` carry one dataset to both
packages), and otherwise draws them by JAX's recipe from a
``torch.Generator`` seeded with ``seed``, on the CPU so that every device
gets the same draw: X = N(0, 1) / sqrt(n), w_true = 0.5·N(0, 1), y =
Poisson(exp(X w_true)). The model's tensors follow the point it is
evaluated at (device and dtype); pass ``device=`` and ``dtype=`` of the
solve to spare a copy per evaluation.
"""

from __future__ import annotations

import torch

from ..api import ProbabilityModel
from .logistic import _tensor

__all__ = ["PoissonRegressionMAP"]


class PoissonRegressionMAP(ProbabilityModel):
    """Poisson-regression posterior over ``dimension`` weights, its data
    ``X`` (n_obs, dimension) and ``y`` (n_obs,) kept on ``device`` in
    ``dtype``."""

    def __init__(self, dimension: int = 50, n_obs: int = 400, prior_scale: float = 10.0,
                 seed: int = 0, dtype=torch.float64, device=None, X=None, y=None):
        super().__init__(dimension)
        if (X is None) != (y is None):
            raise ValueError("pass both X and y, or neither")
        if X is None:
            gen = torch.Generator().manual_seed(seed)
            X = torch.randn(n_obs, dimension, generator=gen, dtype=dtype) / (
                torch.sqrt(torch.tensor(float(dimension), dtype=dtype)))
            w_true = 0.5 * torch.randn(dimension, generator=gen, dtype=dtype)
            y = torch.poisson(torch.exp(X @ w_true), generator=gen)
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
        eta = X @ w
        loglik = torch.sum(y * eta - torch.exp(eta))
        logprior = -0.5 * torch.sum(w * w) / (self.prior_scale**2)
        return loglik + logprior
