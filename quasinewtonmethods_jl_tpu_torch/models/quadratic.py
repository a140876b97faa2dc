"""Ill-conditioned quadratic log-density — the PyTorch port of
``quasinewtonmethods_jl_tpu/models/quadratic.py``.

BASELINE.md config 2 (n=256): a spectrum spanning ``condition`` orders of
magnitude stresses the line search and the inverse-Hessian update. The
eigenvalues are the JAX model's, log-spaced in [1/condition, 1]. JAX draws
the optimum ``x_star`` with ``jax.random``, which torch cannot reproduce:
the port's model takes ``x_star`` as an array (how the tests carry JAX's
across), and otherwise draws it from a ``torch.Generator`` seeded with
``seed`` (on the CPU, so every device gets the same draw). The model's
tensors follow the point it is evaluated at (device and dtype); pass
``device=`` and ``dtype=`` of the solve to spare a copy per evaluation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..api import ProbabilityModel

__all__ = ["IllConditionedQuadratic", "quadratic_logdensity"]


def _spectrum(n: int, condition: float, dtype, device) -> torch.Tensor:
    # log-spaced eigenvalues in [1/condition, 1]
    return torch.logspace(-math.log10(condition), 0.0, n, dtype=dtype, device=device)


def quadratic_logdensity(theta, diag, x_star):
    """-(1/2) (theta - x*)ᵀ D (theta - x*); maximum 0 at x*."""
    r = theta - x_star
    return -0.5 * torch.sum(diag * r * r)


class IllConditionedQuadratic(ProbabilityModel):
    """Quadratic with known optimum ``x_star`` and conditioning
    ``condition``, its tensors kept on ``device`` in ``dtype``."""

    def __init__(self, dimension: int, condition: float = 1e4, seed: int = 0,
                 dtype=torch.float64, device=None, x_star=None):
        super().__init__(dimension)
        self.condition = float(condition)
        self.diag = _spectrum(dimension, condition, dtype, device)
        if x_star is None:
            x_star = torch.randn(dimension, generator=torch.Generator().manual_seed(seed),
                                 dtype=dtype)
        elif not isinstance(x_star, torch.Tensor):
            x_star = torch.as_tensor(np.array(x_star))  # a writable copy (JAX arrays are not)
        self.x_star = x_star.to(dtype=dtype, device=device)

    def _on(self, theta):
        """diag and x_star on theta's device and in its dtype."""
        return (self.diag.to(device=theta.device, dtype=theta.dtype),
                self.x_star.to(device=theta.device, dtype=theta.dtype))

    def logdensity(self, theta):
        return quadratic_logdensity(theta, *self._on(theta))

    def logdensity_and_gradient(self, theta):
        diag, x_star = self._on(theta)
        r = theta - x_star
        return -0.5 * torch.sum(diag * r * r), -diag * r
