"""Extended Rosenbrock log-density (maximization form) — the PyTorch port of
``quasinewtonmethods_jl_tpu/models/rosenbrock.py``.

The reference's canonical fixture and the benchmark objective (reference:
test/runtests.jl:4-33, README.md:19-48): the *negated* extended Rosenbrock
with the coupled-pair indexing (theta[i], theta[i+N]) for N = n >> 1, plus
a quadratic tail term when n is odd. Maximum 0 at theta = 1⃗. Both functions
take one lane's (n,) tensor; the fleet engine maps them over lanes.
"""

from __future__ import annotations

import torch

from ..api import ProbabilityModel, _value_and_grad

__all__ = ["rosenbrock_logdensity", "rosenbrock_value_and_grad", "Rosenbrock"]


def rosenbrock_logdensity(theta: torch.Tensor) -> torch.Tensor:
    """-sum_i 100 (theta[i+N] - theta[i]^2)^2 + (1 - theta[i])^2, odd tail
    -(1 - theta[-1])^2. Maximum 0 at 1⃗. Matches test/runtests.jl:5-17."""
    n = theta.shape[0]
    half = n >> 1
    a = theta[:half]
    b = theta[half : 2 * half]
    s = -torch.sum(100.0 * (b - a * a) ** 2 + (1.0 - a) ** 2)
    if n % 2:
        delta = 1.0 - theta[-1]
        s = s - delta * delta
    return s


def rosenbrock_value_and_grad(theta: torch.Tensor):
    """Analytic value+gradient, mirroring ∂logdensity! (test/runtests.jl:19-33)."""
    n = theta.shape[0]
    half = n >> 1
    a = theta[:half]
    b = theta[half : 2 * half]
    r = b - a * a
    s = -torch.sum(100.0 * r * r + (1.0 - a) ** 2)
    ga = 400.0 * r * a + 2.0 * (1.0 - a)
    gb = -200.0 * r
    if n % 2:
        delta = 1.0 - theta[-1]
        s = s - delta * delta
        grad = torch.cat([ga, gb, (2.0 * delta).reshape(1)])
    else:
        grad = torch.cat([ga, gb])
    return s, grad


class Rosenbrock(ProbabilityModel):
    """Model-object flavor of the fixture (README.md:19 ``struct Rosenbrock end``)."""

    def __init__(self, dimension: int, analytic_gradient: bool = False):
        super().__init__(dimension)
        self._analytic = analytic_gradient

    def logdensity(self, theta):
        return rosenbrock_logdensity(theta)

    def logdensity_and_gradient(self, theta):
        if self._analytic:
            return rosenbrock_value_and_grad(theta)
        return _value_and_grad(rosenbrock_logdensity)(theta)
