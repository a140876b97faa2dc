"""Backtracking line search (quadratic / cubic interpolation), maximization
form — the PyTorch port of ``quasinewtonmethods_jl_tpu/ops/linesearch.py``
(reference: src/QuasiNewtonMethods.jl:72-80 `BackTracking`, :165-232
`linesearch!`).

`backtracking_linesearch` is the one-lane search in eager form: the
reference's two phases — (A) halve alpha until the objective is finite,
(B) the Armijo sufficient-*increase* loop with interpolated proposals —
are two Python loops over 0-d tensors. The fleet engine runs its own
masked lockstep form (batched_solve._batched_linesearch) built from the
same proposals.

Conventions preserved from the reference:
  * the Armijo test is ``f(x + a*d) >= f0 + a*c1*m`` with ``m = gradᵀd > 0``;
  * failure is in-band: alpha == 0 (src/QuasiNewtonMethods.jl:193);
  * NaN-robust clamping via nanmin/nanmax (:224-225);
  * the cubic degenerates to ``m / (2b)`` when its cubic coefficient is
    negligible (:211-212).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..utils.scalars import finite_halving_limit, nanmax, nanmin, sqrt_tolerance

__all__ = ["BackTracking", "LineSearchResult", "backtracking_linesearch", "run_linesearch"]


@dataclasses.dataclass(frozen=True)
class BackTracking:
    """Backtracking line-search hyperparameters, with the reference's
    defaults (src/QuasiNewtonMethods.jl:72-80). ``order`` 2 always proposes
    by quadratic interpolation of (f(0), f'(0), f(a)); order 3 by a cubic
    through the last two trial points (quadratic on the first round)."""

    order: int = 2
    c1: float = 1e-4
    rho_hi: float = 0.5
    rho_lo: float = 0.1
    iterations: int = 1000

    def __post_init__(self):
        if self.order not in (2, 3):
            raise ValueError(f"BackTracking order must be 2 or 3, got {self.order}")


class LineSearchResult(NamedTuple):
    """Result of one line search; ``alpha == 0`` is the in-band failure
    sentinel (src/QuasiNewtonMethods.jl:193)."""

    alpha: torch.Tensor  # accepted step size (0.0 on failure)
    f_final: torch.Tensor  # objective at x + alpha*d (stale on failure)
    n_fev: torch.Tensor  # int32: objective evaluations performed
    iterations: torch.Tensor  # int32: Armijo backtracking rounds used
    failed: torch.Tensor  # bool: iteration budget exhausted


def _quadratic_proposal(m, a2, fx1, f0):
    # Minimizer (in the backtracking sense) of the quadratic interpolating
    # f(0)=f0, f'(0)=m, f(a2)=fx1 (reference :205).
    return -(m * a2 * a2) / (2.0 * (fx1 - f0 - m * a2))


def _cubic_proposal(m, a1, a2, fx0, fx1, f0, eps, sqrttol):
    # Cubic through (a1, fx0) and (a2, fx1) with f(0)=f0, f'(0)=m, with the
    # degenerate fallback m/(2b) and the NaN-guarded discriminant clamp
    # (reference :207-219).
    denom = 1.0 / (a1 * a1 * a2 * a2 * (a2 - a1))
    r1 = fx1 - f0 - m * a2
    r0 = fx0 - f0 - m * a1
    a = (a1 * a1 * r1 - a2 * a2 * r0) * denom
    b = (-a1 * a1 * a1 * r1 + a2 * a2 * a2 * r0) * denom
    degenerate = torch.abs(a) <= eps + sqrttol * torch.abs(a)
    disc = nanmax(b * b - 3.0 * a * m, torch.zeros_like(b))
    root = (torch.sqrt(disc) + b) / (-3.0 * a)
    return torch.where(degenerate, m / (2.0 * b), root)


def _scalar(value, like: torch.Tensor, dtype=None) -> torch.Tensor:
    # torch.full fills on the device; torch.tensor(value, device=cuda) would
    # copy from the host and synchronise the stream
    return torch.full((), value, dtype=dtype or like.dtype, device=like.device)


def backtracking_linesearch(
    phi: Callable[[torch.Tensor], torch.Tensor],
    f0: torch.Tensor,
    m: torch.Tensor,
    ls: BackTracking = BackTracking(),
) -> LineSearchResult:
    """Run the backtracking line search for one maximization step.

    Args:
      phi: trial evaluator, ``phi(alpha) = logdensity(x + alpha * d)`` on a
        0-d alpha; each round costs one evaluation.
      f0: 0-d objective value at alpha = 0.
      m: 0-d directional derivative ``gradᵀ d`` at alpha = 0.
      ls: hyperparameters.
    """
    return _backtracking(phi, f0, m, ls)[0]


def _backtracking(phi, f0, m, ls: BackTracking):
    """`backtracking_linesearch`, the number of host reads it made (one per
    round plus the one that ends the search) and whether it failed, as the
    last read found it (a Python bool)."""
    c1 = _scalar(ls.c1, f0)
    rho_hi = _scalar(ls.rho_hi, f0)
    rho_lo = _scalar(ls.rho_lo, f0)
    eps = _scalar(torch.finfo(f0.dtype).eps, f0)
    sqrttol = _scalar(sqrt_tolerance(f0.dtype), f0)
    one = _scalar(1.0, f0)

    # Initial trial at alpha = 1 (reference :169-174).
    a1, a2 = one, one
    fx1 = phi(one)
    fx0 = f0
    n_fev = 1
    # A search with non-finite m (or f0) can never satisfy Armijo: fail
    # fast, outcome-identical to burning the budget.
    live = torch.isfinite(m) & torch.isfinite(f0)

    def sufficient():
        return fx1 >= f0 + a2 * c1 * m

    # Phase A halves alpha until the objective is finite (reference
    # :176-184; a1 takes the previous a2); phase B is the Armijo
    # sufficient-increase loop (:186-230), where a NaN fx1 keeps the loop
    # running, exactly like the reference. One read per round says whether
    # each phase's condition holds.
    halvings = iteration = reads = 0
    in_a = True
    while True:
        reads += 1
        # with the outcome were the search to stop here: alpha == 0
        go_a, go_b, failed = torch.stack([live & ~torch.isfinite(fx1), live & ~sufficient(),
                                          ~sufficient() | (a2 == 0.0)]).tolist()
        in_a = in_a and go_a and halvings < finite_halving_limit(f0.dtype)
        if in_a:
            a1, a2 = a2, 0.5 * a2
            halvings += 1
        elif go_b and iteration < ls.iterations:
            iteration += 1
            quad = _quadratic_proposal(m, a2, fx1, f0)
            if ls.order == 2 or iteration == 1:
                at = quad
            else:
                at = _cubic_proposal(m, a1, a2, fx0, fx1, f0, eps, sqrttol)
            a1 = a2
            at = nanmin(at, a2 * rho_hi)  # avoid too-small reductions
            a2 = nanmax(at, a2 * rho_lo)  # avoid too-big reductions
            fx0 = fx1
        else:
            break
        fx1 = phi(a2)
        n_fev += 1

    alpha = torch.where(sufficient(), a2, torch.zeros_like(a2))
    # alpha == 0 covers budget exhaustion and the underflow path where alpha
    # shrinks to exactly 0 (reference :284).
    return LineSearchResult(
        alpha=alpha,
        f_final=fx1,
        n_fev=_scalar(n_fev, f0, torch.int32),
        iterations=_scalar(iteration, f0, torch.int32),
        failed=alpha == 0.0,
    ), reads, failed


def run_linesearch(ls, f, vag, x, d, f0, m, dot=None):
    """Run the configured line search from ``x`` along ``d``.

    Returns ``(alpha, failed, extra_fev, extra_gev)``. BackTracking trials
    are value-only (``f``), so ``extra_gev`` is 0; Wolfe trials evaluate
    value and gradient (``vag``: the curvature test needs the slope gradᵀd)
    and count toward both counters. Any other ``ls`` raises TypeError.

    ``dot`` (``torch.dot`` by default) takes the Wolfe trial slope: on a
    'model'-sharded vector it must be the all-reduced dot
    (`parallel.mesh.psum_dot`), or each rank sees its own partial slope,
    their searches take different turns and the collectives deadlock.
    """
    return _run_linesearch(ls, f, vag, x, d, f0, m, dot)[:4]


def _run_linesearch(ls, f, vag, x, d, f0, m, dot=None):
    """`run_linesearch` and, last, the number of host reads it made and
    whether the search failed, as a Python bool from its last read."""
    from .wolfe import Wolfe, _wolfe

    if isinstance(ls, Wolfe):

        def phi_vag(alpha):
            fv, gv = vag(x + alpha * d)
            return fv, (dot or torch.dot)(gv, d)

        wr, reads, failed = _wolfe(phi_vag, f0, m, ls)
        return wr.alpha, wr.failed, wr.n_fev, wr.n_fev, reads, failed
    if not isinstance(ls, BackTracking):
        raise TypeError(f"ls must be a BackTracking or a Wolfe, got {type(ls).__name__}")

    def phi(alpha):
        return f(x + alpha * d)

    lsr, reads, failed = _backtracking(phi, f0, m, ls)
    return lsr.alpha, lsr.failed, lsr.n_fev, torch.zeros_like(lsr.n_fev), reads, failed
