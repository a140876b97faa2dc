"""Inverse-BFGS rank-2 update fused with the search direction — the PyTorch
port of ``quasinewtonmethods_jl_tpu/ops/bfgs.py`` (reference:
src/QuasiNewtonMethods.jl:34-69 `BFGS_update!`, :144-148 `initial_B⁻¹!`).

The single-lane `bfgs_update` is the numerics oracle the fleet update
(ops/kernels/bfgs_kernel.py) is tested against; `dfp_update` and
`sr1_update` (Broyden-family breadth beyond the reference) are the scalar
driver's other ``update_method``s. Sign conventions
(maximization): y = grad_old - grad_new, d = B⁻¹ grad_new,
m = gradᵀ B⁻¹ grad (> 0 certifies ascent; m <= 0 triggers the identity
reset in the driver).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "initial_inv_hessian",
    "bfgs_update",
    "bfgs_update_reference",
    "dfp_update",
    "sr1_update",
    "SR1_SKIP_TOL",
    "h0_gamma",
    "H0_GAMMA_CLIP",
]


def initial_inv_hessian(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity inverse-Hessian reset (reference :144-148)."""
    return torch.eye(n, dtype=dtype, device=device)


H0_GAMMA_CLIP = (1e-3, 1e3)


def h0_gamma(sty, yty, fresh, dtype):
    """Barzilai–Borwein H0 scaling factor for a *fresh* (identity) B
    (Nocedal & Wright eq. 6.20): sᵀy/yᵀy clipped to `H0_GAMMA_CLIP` where
    the lane is fresh and the pair has positive curvature, else 1.
    ``torch.clamp`` keeps a NaN ratio NaN, as ``jnp.clip`` does."""
    gamma = torch.clamp(sty / yty, *H0_GAMMA_CLIP)
    return torch.where(fresh & (sty > 0), gamma, torch.ones((), dtype=dtype, device=gamma.device))


def bfgs_update(
    B: torch.Tensor,  # (n, n) current inverse Hessian approximation
    s: torch.Tensor,  # (n,) previous accepted step (alpha * direction)
    grad_new: torch.Tensor,  # (n,) gradient at the new iterate
    grad_old: torch.Tensor,  # (n,) gradient at the previous iterate
    fresh=None,  # optional () bool tensor: B is a fresh identity -> H0-scale it
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One inverse-BFGS update; returns (B_new, direction, m), step for step
    as src/QuasiNewtonMethods.jl:34-69 (see the JAX `bfgs_update`).

    IEEE in-band failure propagation is intentional: sᵀy == 0 gives
    inf/NaN, m becomes NaN, the driver's ``m <= 0`` reset test is false
    for NaN, and the line search then fails — the reference's failure path.
    """
    dtype = B.dtype
    y = grad_old - grad_new
    sty = torch.dot(s, y)
    if fresh is not None:
        yty = torch.dot(y, y)
        B = B * h0_gamma(sty, yty, fresh, dtype)
    rho = 1.0 / sty
    By = B @ y
    ytBy = torch.dot(y, By)
    Bys = By * rho
    c1 = (1.0 + ytBy * rho) * rho
    B_new = B + c1 * torch.outer(s, s) - torch.outer(Bys, s) - torch.outer(s, Bys)
    d = B_new @ grad_new
    m = torch.dot(d, grad_new)
    return B_new, d, m


def bfgs_update_reference(B, s, grad_new, grad_old):
    """Loop-free but deliberately naive formulation for testing: the same
    quantities as `bfgs_update` through the textbook Sherman–Morrison form
    B ← V B Vᵀ + ρ ssᵀ with V = I − ρ syᵀ, ρ = 1/sᵀy, an independently
    derived expression the two are cross-checked against."""
    y = grad_old - grad_new
    rho = 1.0 / (s @ y)
    V = torch.eye(B.shape[0], dtype=B.dtype, device=B.device) - rho * torch.outer(s, y)
    B_new = V @ B @ V.T + rho * torch.outer(s, s)
    d = B_new @ grad_new
    m = d @ grad_new
    return B_new, d, m


def dfp_update(B, s, grad_new, grad_old, fresh=None):
    """One inverse-DFP update, B ← B − (By)(By)ᵀ/yᵀBy + ssᵀ/sᵀy; returns
    (B_new, direction, m) with `bfgs_update`'s conventions, optional H0
    scaling and in-band failure (sᵀy == 0 gives a NaN m)."""
    dtype = B.dtype
    y = grad_old - grad_new
    sty = torch.dot(s, y)
    if fresh is not None:
        yty = torch.dot(y, y)
        B = B * h0_gamma(sty, yty, fresh, dtype)
    By = B @ y
    ytBy = torch.dot(y, By)
    B_new = B - torch.outer(By, By) / ytBy + torch.outer(s, s) / sty
    d = B_new @ grad_new
    m = torch.dot(d, grad_new)
    return B_new, d, m


# SR1 safeguard (Nocedal & Wright 6.26): skip the update when |uᵀy| is tiny
# relative to ||u||·||y||.
SR1_SKIP_TOL = 1e-8


def sr1_update(B, s, grad_new, grad_old, fresh=None):
    """One inverse-SR1 update, B ← B + uuᵀ/uᵀy with u = s − By, skipped
    (B unchanged) where |uᵀy| < `SR1_SKIP_TOL`·||u||·||y||; the skip guards
    its own division, so a skipped update stays finite. SR1 does not keep B
    definite: the driver's m <= 0 reset is the safety net."""
    dtype = B.dtype
    y = grad_old - grad_new
    sty = torch.dot(s, y)
    if fresh is not None:
        yty = torch.dot(y, y)
        B = B * h0_gamma(sty, yty, fresh, dtype)
    u = s - B @ y
    uty = torch.dot(u, y)
    skip = torch.abs(uty) < SR1_SKIP_TOL * (torch.linalg.vector_norm(u) * torch.linalg.vector_norm(y))
    denom = torch.where(skip, torch.ones((), dtype=dtype, device=B.device), uty)
    B_new = torch.where(skip, B, B + torch.outer(u, u) / denom)
    d = B_new @ grad_new
    m = torch.dot(d, grad_new)
    return B_new, d, m
