"""Laplace approximation of the log marginal likelihood (model evidence) —
the PyTorch port of ``quasinewtonmethods_jl_tpu/laplace.py``.

At the mode x* with curvature in hand, the Gaussian integral gives

    log Z  ≈  L(x*) + (n/2)·log(2π) − (1/2)·log det(−H)

(H = ∇²L at the mode, negative definite under the maximization
convention), so a MAP fleet becomes a fleet of evidence estimates: model
comparison, Bayes factors, the empirical-Bayes objectives that
`optimize_implicit` differentiates.

Curvature sources:

  * exact: ``obj`` given → ``torch.func.hessian`` at x* (O(n²) memory, the
    right choice at MAP-scale n). Exact for Gaussians.
  * the solver's inverse Hessian B ≈ (−H)⁻¹ of a BFGS state: free, but a
    secant-subspace estimate — a cheap screen, not a certified value.
  * an L-BFGS state's history rings: log det H by the compact-form
    determinant identity (`ops.lbfgs_compact.lbfgs_logdet_inv_hessian`,
    O(m³ + m²n)), with no n×n matrix.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .api import as_logdensity
from .ops.lbfgs_compact import lbfgs_logdet_inv_hessian

__all__ = ["laplace_evidence"]

_LOG_2PI = math.log(2.0 * math.pi)


def _positive_logdet(A: torch.Tensor) -> torch.Tensor:
    """log det A where det A > 0, else NaN (in-band: no Gaussian integral
    exists at a point that is not a proper interior maximum)."""
    sign, logdet = torch.linalg.slogdet(A)
    return torch.where(sign > 0, logdet, torch.full_like(logdet, float("nan")))


def laplace_evidence(
    result,
    obj: Optional[Callable] = None,
) -> torch.Tensor:
    """log Z under the Laplace approximation at a solve result's mode.

    ``result``: an `OptimizeResult` (scalar or fleet), an L-BFGS result, or
    any result with ``x`` and ``fun`` when ``obj`` is given (a
    `PolishResult`). With ``obj`` the Hessian is exact at x* (recommended);
    without it the solver's curvature stands in for (−H)⁻¹: log Z ≈ L* +
    (n/2) log 2π + (1/2) log det B, by the dense slogdet of a BFGS state's
    B or the compact-form identity over an L-BFGS state's rings.

    Failed lanes (NaN ``fun``, the in-band contract) give NaN. Returns a
    0-d tensor for a single solve, (batch,) for a fleet.
    """
    x = result.x
    fun = result.fun
    batched = x.ndim == 2
    const = 0.5 * x.shape[-1] * _LOG_2PI

    if obj is not None:
        hess = torch.func.hessian(as_logdensity(obj))
        if batched:
            hess = torch.func.vmap(hess)
        with torch.no_grad():
            ld = _positive_logdet(-hess(x))
        return fun + const - 0.5 * ld

    state = result.state
    if hasattr(state, "B"):
        return fun + const + 0.5 * _positive_logdet(state.B)
    if hasattr(state, "S") and hasattr(state, "hist"):
        logdet = lbfgs_logdet_inv_hessian
        if batched:
            logdet = torch.func.vmap(logdet)
        return fun + const + 0.5 * logdet(state.S, state.Y, state.hist, state.gamma)
    raise ValueError(
        "result carries no curvature (neither dense B nor L-BFGS rings); "
        "pass obj= for an exact-Hessian Laplace evidence"
    )
