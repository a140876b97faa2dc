"""Neal's funnel — the PyTorch port of
``quasinewtonmethods_jl_tpu/models/funnel.py``.

    v ~ N(0, 3²),   x_i | v ~ N(0, e^v),  i = 1..n-1

with log-density (maximization convention, like every fixture here)

    -v²/18 − (n−1)·v/2 − e^{−v}·‖x‖²/2.

Its MAP is known exactly: θ* = (v*, 0, …, 0) with v* = −σ²(n−1)/2 =
−4.5·(n−1), where the Hessian's eigenvalues span 1/σ² to e^{−v*} (about
7·10⁵ already at n = 4): an extreme-curvature convergence fixture. At
v* the factor e^{−v} overflows float32 once n > 20; solve it in float64.
"""

from __future__ import annotations

import torch

__all__ = ["funnel_logdensity", "FUNNEL_V_STD"]

FUNNEL_V_STD = 3.0


def funnel_logdensity(theta: torch.Tensor) -> torch.Tensor:
    """theta = [v, x_1..x_{n-1}]; returns the funnel log-density (scalar)."""
    v = theta[0]
    x = theta[1:]
    n_x = x.shape[0]
    return (
        -0.5 * v * v / (FUNNEL_V_STD**2)
        - 0.5 * n_x * v
        - 0.5 * torch.exp(-v) * torch.sum(x * x)
    )
