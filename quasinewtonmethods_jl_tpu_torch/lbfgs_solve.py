"""The scalar L-BFGS driver — the PyTorch port of
``quasinewtonmethods_jl_tpu/lbfgs_solve.py`` (`optimize_lbfgs`,
`optimize_lbfgs_from_state`), the large-n companion of `solve.optimize`.

The outer structure is the BFGS driver's (the reference optimize!
skeleton, src/QuasiNewtonMethods.jl:237-292) with the dense update replaced
by an m-pair history ring (ops/lbfgs.py). Limited memory forces three
differences: a curvature pair is pushed after an accepted step and skipped
where sᵀy <= 0 (the cautious rule); an m_dir <= 0 reset clears the ring and
takes steepest ascent; H0 is γ = sᵀy/yᵀy.

Each iteration evaluates at the top and classifies; JAX's
``lax.cond(finish, advance)`` is a Python ``if`` on the status just read.
A failed line search ends the loop before the next evaluation, as JAX's
loop condition does; the search's own last read says so. The host reads
the device once per iteration plus once per line-search round, and a
resume once more for its lifetime ``k``; every read is counted in
``optimize_lbfgs.host_syncs``. `_lbfgs_loop`'s ``dot=`` / ``max_abs=``
hooks take every contraction over n and the convergence test's max|g|, so
the 'model'-sharded path (`parallel.mesh.optimize_lbfgs_sharded`) runs
this loop unmodified on parameter shards.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from .api import as_value_and_grad, as_value_fn
from .ops.lbfgs import lbfgs_direction, lbfgs_push
from .ops.lbfgs_compact import lbfgs_direction_compact
from .ops.linesearch import BackTracking, _run_linesearch
from .ops.wolfe import Wolfe
from .solve import (
    MAX_ITERATIONS_DEFAULT,
    STALL_LIMIT_DEFAULT,
    _cap_status,
    _classify_scalar,
    _host_read,
)
from .state import LBFGSState, Status, init_lbfgs_state
from .utils.device import as_device_state, as_device_tensor

__all__ = ["LBFGSResult", "optimize_lbfgs", "optimize_lbfgs_from_state"]

_RUNNING = int(Status.RUNNING)
_DIRECTIONS = {"compact": lbfgs_direction_compact, "two_loop": lbfgs_direction}


class LBFGSResult(NamedTuple):
    """`OptimizeResult`'s fields with the L-BFGS state."""

    x: torch.Tensor
    fun: torch.Tensor
    grad: torch.Tensor
    status: torch.Tensor
    iterations: torch.Tensor
    n_fev: torch.Tensor
    n_gev: torch.Tensor
    n_resets: torch.Tensor
    last_value: torch.Tensor
    state: LBFGSState

    @property
    def converged(self) -> torch.Tensor:
        return self.status == Status.CONVERGED


def _direction_fn(direction_method: str):
    if direction_method not in _DIRECTIONS:
        raise ValueError(f"unknown direction_method {direction_method!r}; use 'compact' or "
                         "'two_loop'")
    return _DIRECTIONS[direction_method]


def _advance(s: LBFGSState, f0, g, stall, vag, f, ls, direction_fn, dot):
    """Push the pair of the previous accepted step (a never-stepped state's
    zero step has sᵀy = 0 and is skipped), take the direction, reset on
    non-ascent, search and step (JAX `advance`, :124-170). Returns the new
    state and whether the search failed (a Python bool, from its last
    read)."""
    S, Y, rho, hist, gamma = lbfgs_push(s.S, s.Y, s.rho, s.hist, s.gamma, s.step, s.grad_old - g,
                                        dot=dot)
    d, m = direction_fn(S, Y, rho, hist, gamma, g)
    # indefinite direction: clear the history and restart from steepest
    # ascent (the dense driver's B = I reset, reference :272-280)
    reset = m <= 0.0
    d = torch.where(reset, g, d)
    m = torch.where(reset, dot(g, g), m)
    hist = torch.where(reset, torch.zeros_like(hist), hist)
    gamma = torch.where(reset, torch.ones_like(gamma), gamma)
    alpha, ls_failed, ls_fev, ls_gev, reads, failed = _run_linesearch(ls, f, vag, s.x, d, f0, m,
                                                                      dot)
    optimize_lbfgs.host_syncs += reads
    # explicit mask: 0 * a NaN direction would destroy x
    step = torch.where(ls_failed, torch.zeros_like(d), alpha * d)
    return LBFGSState(
        x=s.x + step,
        grad=g,
        grad_old=g,
        step=step,
        S=S,
        Y=Y,
        rho=rho,
        hist=hist,
        gamma=gamma,
        fun=f0,
        k=s.k + 1,
        status=torch.where(ls_failed, int(Status.LINESEARCH_FAILURE), s.status),  # s is RUNNING
        n_fev=s.n_fev + 1 + ls_fev,
        n_gev=s.n_gev + 1 + ls_gev,
        n_resets=s.n_resets + reset.to(torch.int32),
        stall=stall,
    ), failed


def _lbfgs_loop(vag, f, state: LBFGSState, ls, tol, max_iterations: int,
                direction_method: str = "compact", stall_limit: int = STALL_LIMIT_DEFAULT,
                fresh_start: bool = False, dot: Callable = torch.dot,
                max_abs: Optional[Callable] = None) -> LBFGSState:
    """Iterate while RUNNING and the lifetime ``k`` < ``max_iterations``
    (JAX `_lbfgs_loop`); ``fresh_start`` knows k == 0 without a read.

    ``dot`` and ``max_abs`` are injectable contraction and reduction hooks
    (``torch.dot`` and max|g| by default): the sharded path substitutes a
    local op plus an all-reduce, so the whole loop runs unmodified on
    parameter shards. ``direction_method`` 'two_loop' is the one whose
    dots take the hook; the compact form's matmuls do not."""
    direction_fn = _direction_fn(direction_method)
    if direction_method == "two_loop":
        two_loop = direction_fn

        def direction_fn(S, Y, rho, hist, gamma, g):
            return two_loop(S, Y, rho, hist, gamma, g, dot=dot)
    s = state
    tol = torch.full((), tol, dtype=s.x.dtype, device=s.x.device)
    k = 0 if fresh_start else _host_read(optimize_lbfgs, s.k)[0]
    while k < max_iterations:
        f0, g = vag(s.x)
        status_pre, stall = _classify_scalar(f0, g, s.fun, s.stall, tol, stall_limit, max_abs)
        (pre,) = _host_read(optimize_lbfgs, status_pre)
        if pre != _RUNNING:  # finish: record the evaluation that ended it
            s = s._replace(grad=g, fun=f0, status=status_pre, n_fev=s.n_fev + 1,
                           n_gev=s.n_gev + 1, stall=stall)
            break
        s, failed = _advance(s, f0, g, stall, vag, f, ls, direction_fn, dot)
        k += 1
        if failed:  # LINESEARCH_FAILURE: JAX's loop condition stops here
            break
    return s._replace(status=_cap_status(s.status))


def _result_from_state(state: LBFGSState) -> LBFGSResult:
    return LBFGSResult(
        x=state.x,
        fun=torch.where(state.status == int(Status.CONVERGED), state.fun,
                        torch.full_like(state.fun, float("nan"))),
        grad=state.grad,
        status=state.status,
        iterations=state.k,
        n_fev=state.n_fev,
        n_gev=state.n_gev,
        n_resets=state.n_resets,
        last_value=state.fun,
        state=state,
    )


def _run(obj, state, ls, tol, max_iterations, value_and_grad_fn, direction_method, stall_limit,
         fresh_start) -> LBFGSResult:
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    with torch.no_grad():
        return _result_from_state(_lbfgs_loop(vag, f, state, ls, tol, max_iterations,
                                              direction_method, stall_limit, fresh_start))


def optimize_lbfgs(
    obj,
    x0,
    history: int = 10,
    ls: Union[BackTracking, Wolfe] = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    direction_method: str = "compact",
    stall_limit: int = STALL_LIMIT_DEFAULT,
) -> LBFGSResult:
    """Maximize a log-density with L-BFGS(``history``) and a line search:
    the O(m·n) large-n path, with `optimize`'s callback protocol, line
    searches, tolerances and in-band status contract.
    ``direction_method``: 'compact' (default, the Byrd–Nocedal–Schnabel
    form) or 'two_loop' (the classic recursion); they agree to rounding.
    ``x0``: a tensor's device is where the solve runs; anything else goes
    to the CUDA card. Host reads are counted in
    ``optimize_lbfgs.host_syncs``."""
    x0 = as_device_tensor(x0, "x0")
    return _run(obj, init_lbfgs_state(x0, history), ls, tol, max_iterations, value_and_grad_fn,
                direction_method, stall_limit, True)


def optimize_lbfgs_from_state(
    obj,
    state: LBFGSState,
    ls: Union[BackTracking, Wolfe] = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    direction_method: str = "compact",
    stall_limit: int = STALL_LIMIT_DEFAULT,
) -> LBFGSResult:
    """Resume an L-BFGS solve from a saved rank-1 `LBFGSState`, history
    ring included: re-armed to RUNNING with a fresh stall budget; counters
    continue and ``max_iterations`` bounds the lifetime ``k``. Tensor
    leaves keep their device; numpy leaves (`lbfgs_state_to_numpy`) go to
    the CUDA card."""
    state = as_device_state(state)
    if state.x.ndim != 1:
        raise ValueError(
            f"expected a single solve's LBFGSState (x of shape (n,)), got x shape "
            f"{tuple(state.x.shape)}; batched states resume through "
            "optimize_lbfgs_batched_fused_from_state"
        )
    state = state._replace(status=torch.full_like(state.status, _RUNNING),
                           stall=torch.zeros_like(state.stall))
    return _run(obj, state, ls, tol, max_iterations, value_and_grad_fn, direction_method,
                stall_limit, False)


# Host reads of the device (statuses, a resume's k, line-search rounds),
# summed over calls; set it to 0 before a solve to count that solve alone.
optimize_lbfgs.host_syncs = 0
