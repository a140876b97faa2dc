"""Weak-Wolfe line search (bracketing + safeguarded cubic), maximization
form — the PyTorch port of ``quasinewtonmethods_jl_tpu/ops/wolfe.py``.

For φ(a) = f(x + a·d) with φ'(0) = m > 0 the weak Wolfe conditions are

    Armijo (sufficient increase):   φ(a) >= φ(0) + c1·a·m
    curvature:                      φ'(a) <= c2·m

and the search brackets them (Lewis & Overton): lo = 0, hi = +inf, a = 1;
a trial that fails Armijo becomes hi, one that only fails curvature becomes
lo; the next trial is 2·lo while hi = inf, else `wolfe_propose` inside
[lo, hi]. With ``approx=True`` the Hager–Zhang approximate conditions
(slope brackets guarded by a value non-decrease up to ``approx_eps``) also
accept, and the bracket update is slope-driven (see the JAX module for the
derivation and the endgame it fixes).

`wolfe_linesearch` is the one-lane search in eager form (a Python loop over
0-d tensors); the fleet engines run the masked lockstep form
(batched_solve._batched_wolfe) built from the same proposal. NaN flows as
in the JAX search: ``torch.clamp`` / ``torch.maximum`` keep a NaN, and
`wolfe_propose` falls back to the midpoint on a NaN or degenerate cubic.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from .linesearch import _scalar

__all__ = ["Wolfe", "WolfeResult", "wolfe_propose", "wolfe_linesearch"]


@dataclasses.dataclass(frozen=True)
class Wolfe:
    """Weak-Wolfe hyperparameters, with the JAX package's fields, defaults
    and validation. c1 < c2 is required (standard: 1e-4, 0.9). ``interp``
    is the interior proposal once a finite bracket exists: "cubic"
    (safeguarded Hermite) or "bisection" (midpoint). ``approx`` turns on
    the Hager–Zhang approximate Wolfe acceptance with value tolerance
    ``approx_eps``·|φ(0)|."""

    c1: float = 1e-4
    c2: float = 0.9
    iterations: int = 50
    interp: str = "cubic"
    approx: bool = False
    approx_eps: float = 1e-6

    def __post_init__(self):
        if not (0.0 < self.c1 < self.c2 < 1.0):
            raise ValueError(f"need 0 < c1 < c2 < 1, got c1={self.c1}, c2={self.c2}")
        if self.interp not in ("cubic", "bisection"):
            raise ValueError(f"interp must be 'cubic' or 'bisection', got {self.interp!r}")
        if self.approx_eps < 0.0:
            raise ValueError(f"approx_eps must be >= 0, got {self.approx_eps}")


class WolfeResult(NamedTuple):
    alpha: torch.Tensor  # accepted step (0.0 on failure)
    f_final: torch.Tensor  # φ(alpha)
    slope_final: torch.Tensor  # φ'(alpha)
    n_fev: torch.Tensor  # int32 value+grad evaluations
    iterations: torch.Tensor  # int32
    failed: torch.Tensor  # bool


def wolfe_propose(lo, flo, slo, hi, fhi, shi, interp: str):
    """Next trial inside a finite bracket [lo, hi] (maximization form).

    "cubic": maximizer of the Hermite cubic through (lo, flo, slo) and
    (hi, fhi, shi), clipped into [lo + 0.1w, hi - 0.1w] (w = hi - lo), the
    midpoint where that is NaN or the discriminant is negative.
    "bisection": the midpoint. Elementwise, so it serves one lane or a
    fleet."""
    mid = 0.5 * (lo + hi)
    if interp == "bisection":
        return mid
    w = hi - lo
    d1 = -(slo + shi) + 3.0 * (flo - fhi) / (lo - hi)
    disc = d1 * d1 - slo * shi
    d2 = torch.sqrt(torch.clamp(disc, min=0.0))  # lo < hi: sign(hi - lo) = +1
    a = hi - w * (-shi + d2 - d1) / (-shi + slo + 2.0 * d2)
    a = torch.minimum(torch.maximum(a, lo + 0.1 * w), hi - 0.1 * w)  # jnp.clip
    return torch.where(torch.isfinite(a) & (disc >= 0.0), a, mid)


def _wolfe_consts(ls: Wolfe, like: torch.Tensor):
    return _scalar(ls.c1, like), _scalar(ls.c2, like)


def _accepts(ls: Wolfe, c1, c2, f0, m, a, fa, sa):
    """The (approximate) Wolfe acceptance test, elementwise."""
    ok = (fa >= f0 + c1 * a * m) & (sa <= c2 * m)
    if ls.approx:
        bar = f0 - ls.approx_eps * torch.abs(f0)
        ok = ok | ((sa >= (2.0 * c1 - 1.0) * m) & (sa <= c2 * m) & (fa >= bar))
    return ok


def _shrinks(ls: Wolfe, c1, f0, m, a, fa, sa):
    """Which trials become the bracket's hi (elementwise): past the 1-D
    maximum, below the value bar or non-finite under ``approx`` (the
    slope-driven rule); Armijo failures otherwise (a NaN value fails)."""
    if ls.approx:
        bar = f0 - ls.approx_eps * torch.abs(f0)
        bad = ~(torch.isfinite(fa) & torch.isfinite(sa))
        return (sa <= 0.0) | (fa < bar) | bad
    return ~(fa >= f0 + c1 * a * m)


def wolfe_linesearch(
    phi_vag: Callable[[torch.Tensor], tuple],
    f0: torch.Tensor,
    m: torch.Tensor,
    ls: Wolfe = Wolfe(),
) -> WolfeResult:
    """Run the weak-Wolfe search for one lane.

    Args:
      phi_vag: ``alpha -> (f(x + alpha d), grad(x + alpha d) @ d)`` on a 0-d
        alpha: value and directional derivative along the ray.
      f0: 0-d objective at alpha = 0.
      m: 0-d directional derivative at 0 (> 0 for an ascent direction).
      ls: hyperparameters.
    """
    return _wolfe(phi_vag, f0, m, ls)[0]


def _wolfe(phi_vag, f0, m, ls: Wolfe):
    """`wolfe_linesearch`, the number of host reads it made (one per round
    plus the one that ends the search) and whether it failed, as the last
    read found it (a Python bool)."""
    c1, c2 = _wolfe_consts(ls, f0)
    one = torch.ones((), dtype=f0.dtype, device=f0.device)
    lo, flo, slo = torch.zeros_like(one), f0, m
    hi = torch.full_like(one, float("inf"))
    fhi = shi = torch.full_like(one, float("nan"))
    a = one
    fa, sa = phi_vag(one)
    it = reads = 0
    # acceptance is tested before each round, so the accepting trial is
    # never followed by a wasted evaluation; a NaN m or f0 can never
    # accept, so such a search fails at once (the in-band alpha = 0)
    live = torch.isfinite(m) & torch.isfinite(f0)
    while True:
        reads += 1
        ok = _accepts(ls, c1, c2, f0, m, a, fa, sa)
        # with the outcome were the search to stop here: alpha == 0
        go, failed = torch.stack([live & ~ok, ~ok | (a == 0.0)]).tolist()
        if not go or it >= ls.iterations:
            break
        shrink = _shrinks(ls, c1, f0, m, a, fa, sa)
        hi = torch.where(shrink, a, hi)
        fhi = torch.where(shrink, fa, fhi)
        shi = torch.where(shrink, sa, shi)
        lo = torch.where(shrink, lo, a)
        flo = torch.where(shrink, flo, fa)
        slo = torch.where(shrink, slo, sa)
        # expand while the bracket is open, else propose inside it
        inner = wolfe_propose(lo, flo, slo, hi, fhi, shi, ls.interp)
        a = torch.where(torch.isinf(hi), 2.0 * lo, inner)
        fa, sa = phi_vag(a)
        it += 1

    alpha = torch.where(ok, a, torch.zeros_like(a))
    return WolfeResult(
        alpha=alpha,
        f_final=fa,
        slope_final=sa,
        n_fev=_scalar(it + 1, f0, torch.int32),
        iterations=_scalar(it, f0, torch.int32),
        failed=alpha == 0.0,  # the same in-band sentinel as backtracking
    ), reads, failed
