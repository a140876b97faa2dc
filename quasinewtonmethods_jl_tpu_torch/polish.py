"""Evidence-grade polish: safeguarded Newton refinement of a converged
fleet — the PyTorch port of ``quasinewtonmethods_jl_tpu/polish.py``.

The f32 fleet on the card certifies max|∇| < 1e-3; Laplace evidence and
B-as-covariance want tighter modes. A few exact-Hessian Newton steps on the
converged lanes drive the gradient to the objective's evaluation floor
(quadratic convergence: 2-3 steps from 1e-3). In f32 that floor is set by
the gradient's own rounding at the mode, so the polish is usually run in
f64 (``dtype=torch.float64``): a few steps on a converged fleet cost little
next to the solve.

A step is kept only where it is finite and lowers max|∇| (a lane at its
floor keeps its iterate; ``improved`` says which lanes moved). Lanes that
had not converged are never moved and get NaN ``fun``.

JAX scans the steps inside one jitted program; here a Python loop of
``steps`` iterations runs torch ops whose masks stay on the device: the
polish reads nothing back.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .api import as_logdensity, as_value_and_grad
from .state import Status

__all__ = ["PolishResult", "polish_newton"]


class PolishResult(NamedTuple):
    """Refined modes and the before/after certificate.

    x: (batch, n) (or (n,)) polished iterates
    fun: objective at x (NaN where the input lane had failed)
    grad: gradient at x
    grad_norm_before / grad_norm_after: per-lane max|∇|
    improved: bool per lane — a Newton step was accepted
    """

    x: torch.Tensor
    fun: torch.Tensor
    grad: torch.Tensor
    grad_norm_before: torch.Tensor
    grad_norm_after: torch.Tensor
    improved: torch.Tensor


def polish_newton(
    obj,
    result,
    steps: int = 3,
    value_and_grad_fn: Optional[Callable] = None,
    dtype=None,
) -> PolishResult:
    """Refine a solve result's modes with safeguarded Newton steps.

    ``result``: any result with ``x`` and ``status`` (scalar or fleet, BFGS
    or L-BFGS). The Hessian is ``torch.func.hessian`` of the log-density,
    the step solves (−H) d = ∇, and a fleet runs under ``torch.func.vmap``.
    ``dtype`` recasts the stage (e.g. ``torch.float64`` for an f32 fleet:
    the promotion is what buys gradients below float32's floor).
    Non-converged lanes pass through untouched with NaN ``fun``.
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    vag = as_value_and_grad(obj, value_and_grad_fn)
    hess = torch.func.hessian(as_logdensity(obj))
    x = result.x if dtype is None else result.x.to(dtype)
    ok = result.status == int(Status.CONVERGED)
    if x.ndim == 2:
        vag, hess = torch.func.vmap(vag), torch.func.vmap(hess)
    with torch.no_grad():
        _, g0 = vag(x)
        norm0 = g0.abs().amax(-1)
        xc, gc, normc = x, g0, norm0
        improved = torch.zeros_like(ok)
        for _ in range(steps):
            H = hess(xc)
            # maximization: −H is positive definite at a proper mode; solve_ex
            # gives inf/NaN on a singular lane (as JAX's solve does) where
            # linalg.solve would raise, and checks nothing on the host
            d = torch.linalg.solve_ex(-H, gc[..., None])[0][..., 0]
            x_new = xc + d
            _, g_new = vag(x_new)
            norm_new = g_new.abs().amax(-1)
            take = torch.isfinite(norm_new) & (norm_new < normc) & ok
            xc = torch.where(take[..., None], x_new, xc)
            gc = torch.where(take[..., None], g_new, gc)
            normc = torch.where(take, norm_new, normc)
            improved |= take
        f1 = vag(xc)[0]
    f1 = torch.where(ok, f1, torch.full_like(f1, float("nan")))
    return PolishResult(x=xc, fun=f1, grad=gc, grad_norm_before=norm0, grad_norm_after=normc,
                        improved=improved)
