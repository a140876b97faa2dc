"""L-BFGS history ring and two-loop recursion — the PyTorch port of
``quasinewtonmethods_jl_tpu/ops/lbfgs.py``.

Limited-memory BFGS keeps the last m (step, gradient-difference) pairs and
applies the inverse Hessian implicitly in O(m·n), the regime where an
(n, n) matrix is too large. Sign conventions are the reference's
maximization form: y = grad_old - grad_new, the recursion gives an ascent
direction d ≈ B⁻¹∇, and m_dir = dᵀ∇ > 0 certifies ascent.

The ring shifts on push (slot hist-1 is always the newest pair) and every
branch is a ``torch.where`` over 0-d tensors, so nothing is read on the
host; the recursion's ``lax.fori_loop`` over m is a Python loop over the
static m. Every contraction over n goes through the injectable ``dot``
(``torch.dot`` by default): under a 'model'-sharded parameter axis it is a
local partial dot plus an all-reduce (`parallel.mesh.psum_dot`).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["lbfgs_direction", "lbfgs_push"]


def lbfgs_push(
    S: torch.Tensor,  # (m, n) step history (oldest..newest in 0..hist-1)
    Y: torch.Tensor,  # (m, n) gradient-difference history
    rho: torch.Tensor,  # (m,) 1/(sᵀy)
    hist: torch.Tensor,  # () int32 valid pair count
    gamma: torch.Tensor,  # () H0 scaling
    step: torch.Tensor,  # (n,) accepted step s_k = alpha*d
    y: torch.Tensor,  # (n,) grad_old - grad_new
    dot: Callable = torch.dot,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Push a curvature pair into the ring if it has positive curvature.

    The cautious rule: a pair with sᵀy <= 0 is skipped (it would corrupt
    the implicit inverse Hessian). A full ring drops its oldest pair.
    gamma becomes sᵀy/yᵀy of an accepted pair (Barzilai–Borwein H0)."""
    mh = S.shape[0]
    sty = dot(step, y)
    yty = dot(y, y)
    accept = sty > 0.0
    # a full ring drops slot 0 and appends; else the pair goes to slot hist
    shift = accept & (hist >= mh)
    write = (torch.arange(mh, device=S.device) == hist) & accept & ~shift

    def push(ring, value):
        appended = torch.where(write.view((mh,) + (1,) * (ring.ndim - 1)), value, ring)
        return torch.where(shift, torch.cat([ring[1:], value.expand_as(ring[:1])]), appended)

    S_new = push(S, step[None])
    Y_new = push(Y, y[None])
    rho_new = push(rho, (1.0 / sty)[None])
    hist_new = torch.where(accept, torch.clamp(hist + 1, max=mh), hist)
    gamma_new = torch.where(accept, sty / yty, gamma).to(S.dtype)
    return S_new, Y_new, rho_new, hist_new, gamma_new


def lbfgs_direction(
    S: torch.Tensor,
    Y: torch.Tensor,
    rho: torch.Tensor,
    hist: torch.Tensor,
    gamma: torch.Tensor,
    g: torch.Tensor,  # (n,) current gradient
    dot: Callable = torch.dot,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-loop recursion: d ≈ B⁻¹g (ascent direction) and m_dir = dᵀg.
    Slots at or above ``hist`` take no part (their coefficients are 0);
    ``dot`` is the contraction over n (see the module docstring)."""
    mh = S.shape[0]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    q = g
    alphas = []
    for j in range(mh):  # newest first: round j reads slot hist-1-j
        valid = j < hist
        # a one-element index tensor: indexing with a 0-d device tensor
        # would read it on the host
        i = torch.clamp(hist - 1 - j, min=0).reshape(1).to(torch.int64)
        a = torch.where(valid, rho.index_select(0, i)[0] * dot(S.index_select(0, i)[0], q), zero)
        q = q - a * Y.index_select(0, i)[0]
        alphas.append(a)
    # slot i's coefficient came from round hist-1-i (slots >= hist unused)
    slots = torch.arange(mh, device=g.device)
    alphas = torch.stack(alphas).index_select(0, torch.clamp(hist - 1 - slots, min=0).to(torch.int64))
    q = q * gamma
    for i in range(mh):
        valid = i < hist
        b = torch.where(valid, rho[i] * dot(Y[i], q), zero)
        q = q + torch.where(valid, alphas[i] - b, zero) * S[i]
    return q, dot(q, g)
