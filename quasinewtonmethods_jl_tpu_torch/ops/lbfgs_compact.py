"""Compact-representation L-BFGS (Byrd–Nocedal–Schnabel 1994) — the PyTorch
port of ``quasinewtonmethods_jl_tpu/ops/lbfgs_compact.py``.

The same inverse Hessian as the two-loop recursion (ops/lbfgs.py), written
as two (m, n) contractions and two small triangular solves:

    H = γI + [S, γY] M [Sᵀ; γYᵀ],   R = triu(SᵀY), D = diag(SᵀY),
    M = [ R⁻ᵀ(D + γYᵀY)R⁻¹   −R⁻ᵀ ]
        [ −R⁻¹                0    ]

    Hg = γg + Sᵀ·top + γYᵀ·bottom,  a = R⁻¹(Sg), bottom = −a,
    top = R⁻ᵀ[(D + γYᵀY)a − γ(Yg)]

Ring slots hold oldest..newest in 0..hist-1, so R is upper triangular.
Slots at or above ``hist`` may hold stale pairs (a steepest-ascent reset
clears only ``hist``): `_masked_compact_setup` zeroes them and gives R and
D unit entries there, so the solves stay well posed. The last three
functions hand the estimate to later stages (its diagonal, its log
determinant, an exact low-rank spectral form) without forming an (n, n)
matrix.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "lbfgs_direction_compact",
    "lbfgs_diag_inv_hessian",
    "lbfgs_logdet_inv_hessian",
    "lbfgs_lowrank_inv_hessian",
]


def _solve_r(R, b):
    """R⁻¹ b for an upper-triangular R and a vector or a matrix b."""
    if b.ndim == 1:
        return torch.linalg.solve_triangular(R, b[:, None], upper=True)[:, 0]
    return torch.linalg.solve_triangular(R, b, upper=True)


def _solve_rt(R, b):
    """R⁻ᵀ b (JAX's ``solve_triangular(R, b, lower=False, trans=1)``)."""
    if b.ndim == 1:
        return torch.linalg.solve_triangular(R.mT, b[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(R.mT, b, upper=False)


def _masked_compact_setup(S, Y, hist):
    """The one home of the stale-slot masking invariant (module docstring):
    zero the rows at slots >= hist, build the Gram pieces on the masked
    rings, and pad R and D with unit entries there."""
    mh = S.shape[0]
    vmask = (torch.arange(mh, device=S.device) < hist).to(S.dtype)
    Sm = S * vmask[:, None]
    Ym = Y * vmask[:, None]
    SY = Sm @ Ym.T  # (m, m): SY[i, j] = s_i·y_j, stale rows and columns 0
    YY = Ym @ Ym.T
    unit_invalid = 1.0 - vmask
    R = torch.triu(SY) + torch.diag_embed(unit_invalid)
    D = torch.diagonal(SY) + unit_invalid  # (m,)
    return vmask, Sm, Ym, SY, YY, R, D


def lbfgs_direction_compact(
    S: torch.Tensor,  # (m, n) step history, oldest..newest in 0..hist-1
    Y: torch.Tensor,  # (m, n) gradient-difference history
    rho: torch.Tensor,  # (m,) unused (the two-loop's signature)
    hist: torch.Tensor,  # () int32 valid pair count
    gamma: torch.Tensor,  # () H0 scaling
    g: torch.Tensor,  # (n,) current gradient
) -> Tuple[torch.Tensor, torch.Tensor]:
    """d ≈ B⁻¹g (ascent direction) and m_dir = dᵀg, compact form."""
    _vmask, Sm, Ym, _SY, YY, R, D = _masked_compact_setup(S, Y, hist)
    Sg = Sm @ g
    Yg = Ym @ g
    a = _solve_r(R, Sg)
    top = _solve_rt(R, D * a + gamma * (YY @ a) - gamma * Yg)
    d = gamma * g + S.T @ top - gamma * (Y.T @ a)
    return d, torch.dot(d, g)


def lbfgs_diag_inv_hessian(S, Y, hist, gamma) -> torch.Tensor:
    """diag(H) of the compact-form estimate in O(m²·n):

        diag(H)_j = γ + v_jᵀ (D + γYᵀY) v_j − 2γ (v_j · Y[:, j]),
        v_j = R⁻¹ S[:, j]

    (the large-n MAP-to-sampler handoff's diagonal mass)."""
    _vmask, Sm, Ym, _SY, YY, R, D = _masked_compact_setup(S, Y, hist)
    G = torch.diag_embed(D) + gamma * YY
    V = _solve_r(R, Sm)  # (m, n): v_j in column j
    quad = torch.einsum("aj,ab,bj->j", V, G, V)
    cross = torch.sum(V * Ym, dim=0)
    return gamma + quad - 2.0 * gamma * cross


def lbfgs_logdet_inv_hessian(S, Y, hist, gamma) -> torch.Tensor:
    """log det H of the compact-form estimate in O(m³ + m²·n), by the
    matrix determinant lemma: log det H = n·log γ + log det(I_2m +
    (1/γ)·M·(UᵀU)) with U = [Sᵀ, γYᵀ]. NaN (in-band) where the estimate is
    not positive definite."""
    n, mh = S.shape[1], S.shape[0]
    _vmask, Sm, Ym, SY, YY, R, D = _masked_compact_setup(S, Y, hist)
    SS = Sm @ Sm.T
    UtU = torch.cat([torch.cat([SS, gamma * SY], dim=1),
                     torch.cat([gamma * SY.T, gamma * gamma * YY], dim=1)], dim=0)
    # M @ UᵀU through the block structure: top = R⁻ᵀ[(D + γYYᵀ)R⁻¹X_top -
    # X_bot], bottom = -R⁻¹X_top
    X_top, X_bot = UtU[:mh], UtU[mh:]
    RinvX = _solve_r(R, X_top)
    G = torch.diag_embed(D) + gamma * YY
    MX = torch.cat([_solve_rt(R, G @ RinvX - X_bot), -RinvX], dim=0)
    K = torch.eye(2 * mh, dtype=S.dtype, device=S.device) + MX / gamma
    sign, logdet_k = torch.linalg.slogdet(K)
    logdet = n * torch.log(gamma) + logdet_k
    return torch.where(sign > 0, logdet, torch.full_like(logdet, float("nan")))


def lbfgs_lowrank_inv_hessian(S, Y, hist, gamma) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gamma, Q, sig): the compact-form estimate as the exact spectral
    low-rank form H = γ·(I − QQᵀ) + Q·diag(sig)·Qᵀ, Q (n, 2m) orthonormal,
    from a QR of U = [Sᵀ, γYᵀ] and an eigendecomposition of the projected
    2m x 2m middle; ``sig`` is clamped positive (1e-10)."""
    mh = S.shape[0]
    _vmask, Sm, Ym, _SY, YY, R, D = _masked_compact_setup(S, Y, hist)
    U = torch.cat([Sm.T, gamma * Ym.T], dim=1)  # (n, 2m)
    Q, Rt = torch.linalg.qr(U)
    G = torch.diag_embed(D) + gamma * YY
    Rt_top, Rt_bot = Rt[:, :mh], Rt[:, mh:]
    A = _solve_r(R, Rt_top.T)  # (m, 2m)
    MX = torch.cat([_solve_rt(R, G @ A - Rt_bot.T), -A], dim=0)  # M Rtᵀ
    S_mid = Rt @ MX
    S_mid = 0.5 * (S_mid + S_mid.T)
    sig_rel, P = torch.linalg.eigh(S_mid)
    sig = torch.clamp(gamma + sig_rel, min=1e-10)
    return gamma, Q @ P, sig
