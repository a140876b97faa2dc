"""The scalar BFGS driver — the PyTorch port of
``quasinewtonmethods_jl_tpu/solve.py`` (`optimize`, `optimize_from_state`),
the reference's only entry point ``optimize!`` (src/QuasiNewtonMethods.jl:
237-292), with the solve result and driver defaults the fleet engines share.

The loop is the JAX driver's *rotated* one: the first evaluation and the
sentinel first iteration (m = -1, reference :263-264) are peeled, and each
later iteration runs update -> line search -> step -> evaluate at the new
iterate -> classify, so ``(fun, grad)`` always hold the evaluation at ``x``.
A failed line search re-evaluates the unmoved iterate and does not count
that evaluation (the reference exits without one), which keeps ``n_fev`` and
``n_gev`` equal to JAX's.

JAX runs the loop as one ``lax.while_loop``; here a Python loop on the host
drives 0-d tensors, which stay on their device. The host reads the device
once per iteration (the status, to stop) and once per round of the
single-lane line search; a resume also reads its lifetime ``k`` once with the
first status. Every read is counted in ``optimize.host_syncs``. JAX's
``jit=`` argument is not ported (there is nothing to compile), as the fleet
engine's ``unroll`` was not.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from .api import as_value_and_grad, as_value_fn
from .ops.bfgs import bfgs_update, dfp_update, initial_inv_hessian, sr1_update
from .ops.linesearch import BackTracking, _run_linesearch
from .ops.wolfe import Wolfe
from .state import BFGSState, Status, init_bfgs_state
from .utils.device import as_device_state, as_device_tensor

__all__ = [
    "OptimizeResult",
    "optimize",
    "optimize_from_state",
    "MAX_ITERATIONS_DEFAULT",
    "STALL_LIMIT_DEFAULT",
]

# The reference hardcodes N = 10_000 outer iterations (:250).
MAX_ITERATIONS_DEFAULT = 10_000

# Stall detector: a monotone ascent method that fails to strictly increase
# the objective for this many consecutive iterations is grinding below
# floating-point resolution; exit in-band (LINESEARCH_FAILURE) instead of
# crawling to the iteration cap. stall_limit=0 disables it.
STALL_LIMIT_DEFAULT = 50

# Broyden-family inverse updates of the dense driver (beyond the
# reference, which is BFGS-only, :34-69).
_UPDATE_FNS = {"bfgs": bfgs_update, "dfp": dfp_update, "sr1": sr1_update}

_RUNNING = int(Status.RUNNING)


class OptimizeResult(NamedTuple):
    """Solve result. ``fun`` keeps the reference's in-band contract: the
    maximized log-density on convergence, NaN otherwise. ``last_value`` is
    the final objective value regardless of status."""

    x: torch.Tensor  # final iterate (reference `optimum`, :149)
    fun: torch.Tensor  # converged value or NaN (reference return, :261/:291)
    grad: torch.Tensor  # last evaluated gradient (reference `gradient`, :150)
    status: torch.Tensor  # int32 Status code
    iterations: torch.Tensor  # int32 outer iterations executed
    n_fev: torch.Tensor  # int32 objective evaluations
    n_gev: torch.Tensor  # int32 gradient evaluations
    n_resets: torch.Tensor  # int32 steepest-ascent restarts
    last_value: torch.Tensor  # final objective value (even on failure)
    state: BFGSState  # full solver state

    @property
    def converged(self) -> torch.Tensor:
        return self.status == Status.CONVERGED


def _classify_scalar(f1, g1, prev_fun, prev_stall, tol, stall_limit, max_abs=None):
    """(status, stall) of the evaluation (f1, g1) at the current iterate,
    the scalar drivers' status test. Non-finite precedes convergence
    (:255 / :257), which precedes the stall exit; a NaN ``prev_fun`` (no
    earlier value) counts as an improvement. ``max_abs`` takes max|g1| (a
    max over ranks on a sharded vector)."""
    improved = torch.isnan(prev_fun) | (f1 > prev_fun)
    stall = torch.where(improved, torch.zeros_like(prev_stall), prev_stall + 1)
    status = torch.full_like(prev_stall, _RUNNING)
    if stall_limit:
        status = torch.where(stall >= stall_limit, int(Status.LINESEARCH_FAILURE), status)
    gmax = g1.abs().amax() if max_abs is None else max_abs(g1)
    status = torch.where(gmax < tol, int(Status.CONVERGED), status)
    status = torch.where(~torch.isfinite(f1), int(Status.NONFINITE_VALUE), status)
    return status, stall


def _cap_status(status):
    """A solve that stopped while RUNNING hit its iteration cap (the
    reference falls off its for-loop and returns NaN, :288-291)."""
    return torch.where(status == _RUNNING, int(Status.MAX_ITERATIONS), status)


def _check_update_method(update_method: str):
    if update_method not in _UPDATE_FNS:
        raise ValueError(
            f"update_method must be one of {sorted(_UPDATE_FNS)}, got {update_method!r}"
        )
    return _UPDATE_FNS[update_method]


def _host_read(engine, *values) -> list:
    """``values`` (0-d integer or bool tensors) on the host in one device
    read, counted in ``engine.host_syncs``."""
    engine.host_syncs += 1
    return torch.stack([v.to(torch.int64) for v in values]).tolist()


def _advance(s: BFGSState, first: bool, vag, f, ls, tol, eye, update_fn, h0_scale,
             stall_limit) -> BFGSState:
    """One rotated iteration (JAX `advance`, :161-224)."""
    f0, g = s.fun, s.grad  # the rotation invariant: the evaluation at s.x
    if first:
        # sentinel m = -1 forces the steepest-ascent branch (:263-264)
        B1, d, m = s.B, torch.zeros_like(g), torch.full_like(f0, -1.0)
    else:
        B1, d, m = update_fn(s.B, s.step, g, s.grad_old, fresh=s.fresh if h0_scale else None)
    # m <= 0: reset B = I and take steepest ascent (:272-280); a NaN m does
    # not reset (NaN <= 0 is false): the search then fails in-band
    reset = m <= 0.0
    B2 = torch.where(reset, eye, B1)
    d = torch.where(reset, g, d)
    m = torch.where(reset, torch.dot(g, g), m)
    alpha, ls_failed, ls_fev, ls_gev, reads, _ = _run_linesearch(ls, f, vag, s.x, d, f0, m)
    optimize.host_syncs += reads
    # on failure x stays at the last good iterate; alpha is 0 then, but
    # 0 * d is NaN for a NaN direction, so the mask is explicit
    step = torch.where(ls_failed, torch.zeros_like(d), alpha * d)
    x_new = s.x + step
    f1, g1 = vag(x_new)
    status, stall = _classify_scalar(f1, g1, f0, s.stall, tol, stall_limit)
    # the failure exit keeps the stall count the iteration entered with
    status = torch.where(ls_failed, int(Status.LINESEARCH_FAILURE), status)
    stall = torch.where(ls_failed, s.stall, stall)
    # a failed search re-evaluated the unmoved x and does not count it
    cnt = (~ls_failed).to(torch.int32)
    return BFGSState(
        x=x_new,
        grad=g1,
        grad_old=g,
        step=step,
        B=B2,
        fun=f1,
        k=s.k + 1,
        status=status,
        n_fev=s.n_fev + ls_fev + cnt,
        n_gev=s.n_gev + ls_gev + cnt,
        n_resets=s.n_resets + reset.to(torch.int32),
        fresh=reset,  # a reset leaves a fresh identity behind
        stall=stall,
    )


def _solve_loop(vag, f, state: BFGSState, ls, tol, max_iterations: int, h0_scale: bool = True,
                stall_limit: int = STALL_LIMIT_DEFAULT, fresh_start: bool = False,
                update_method: str = "bfgs") -> BFGSState:
    """The rotated driver loop (JAX `_solve_loop`). ``fresh_start``: the
    state is a fresh one (k == 0 known without a read; JAX's
    ``peel_first``); otherwise the first status read also reads ``k``, and
    only a state that never stepped takes the sentinel first iteration."""
    update_fn = _check_update_method(update_method)
    if max_iterations < 1:
        # no iteration budget: no evaluation at all (the reference's 1:N
        # loop with N = 0)
        return state._replace(status=_cap_status(state.status))
    x = state.x
    tol = torch.full((), tol, dtype=x.dtype, device=x.device)
    eye = initial_inv_hessian(x.shape[0], x.dtype, x.device)
    args = (vag, f, ls, tol, eye, update_fn, h0_scale, stall_limit)

    # peel 0: evaluate at the entry iterate and classify
    f0, g0 = vag(x)
    status0, stall0 = _classify_scalar(f0, g0, state.fun, state.stall, tol, stall_limit)
    s = state._replace(fun=f0, grad=g0, status=status0, stall=stall0,
                       n_fev=state.n_fev + 1, n_gev=state.n_gev + 1)
    if fresh_start:
        (status,), k = _host_read(optimize, s.status), 0
    else:
        status, k = _host_read(optimize, s.status, s.k)
    first = k == 0
    while status == _RUNNING and k < max_iterations:
        s = _advance(s, first, *args)
        first = False
        k += 1
        (status,) = _host_read(optimize, s.status)
    return s._replace(status=_cap_status(s.status))


def _result_from_state(state: BFGSState) -> OptimizeResult:
    return OptimizeResult(
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


def _run(obj, state, ls, tol, max_iterations, value_and_grad_fn, h0_scale, stall_limit,
         fresh_start, update_method) -> OptimizeResult:
    vag = as_value_and_grad(obj, value_and_grad_fn)
    f = as_value_fn(obj, value_and_grad_fn)
    with torch.no_grad():
        return _result_from_state(_solve_loop(vag, f, state, ls, tol, max_iterations, h0_scale,
                                              stall_limit, fresh_start, update_method))


def optimize(
    obj,
    x0,
    ls: Union[BackTracking, Wolfe] = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    h0_scale: bool = True,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    update_method: str = "bfgs",
) -> OptimizeResult:
    """Maximize a log-density with BFGS and a line search: the functional
    analog of ``optimize!(state, obj, x, ls, tol)``
    (src/QuasiNewtonMethods.jl:237).

    ``obj`` is a ``logdensity(theta) -> scalar`` callable or a
    ProbabilityModel on a rank-1 tensor; ``value_and_grad_fn`` supplies an
    analytic value and gradient (the ∂logdensity! analog). ``x0``: a
    tensor's device is where the solve runs; anything else (numpy, lists)
    goes to the CUDA card (`as_device_tensor`). ``ls``: `BackTracking`
    (value-only trials, the reference's) or `Wolfe` (value-and-gradient
    trials, counted in both ``n_fev`` and ``n_gev``).

    ``update_method``: ``"bfgs"`` (default, the reference algorithm),
    ``"dfp"`` or ``"sr1"`` (rank 1, skipped where its denominator
    vanishes; the m <= 0 reset absorbs indefinite curvature).
    ``h0_scale=True`` (default) applies the Barzilai–Borwein H0 scaling to
    fresh identity inverse Hessians (Nocedal & Wright 6.20); False gives the
    reference's exact semantics. ``stall_limit`` non-improving iterations
    in a row exit with LINESEARCH_FAILURE; 0 disables the detector.

    The loop runs on the host over 0-d tensors (module docstring); JAX's
    ``jit=`` is not ported. Host reads are counted in
    ``optimize.host_syncs``.
    """
    x0 = as_device_tensor(x0, "x0")
    return _run(obj, init_bfgs_state(x0), ls, tol, max_iterations, value_and_grad_fn, h0_scale,
                stall_limit, True, update_method)


def optimize_from_state(
    obj,
    state: BFGSState,
    ls: Union[BackTracking, Wolfe] = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    h0_scale: bool = True,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    update_method: str = "bfgs",
) -> OptimizeResult:
    """Resume a solve from a saved `BFGSState` (rank 1; ``x`` is (n,)).

    The state is re-armed to RUNNING with a fresh stall budget, so a
    converged state can be re-solved under a tighter tolerance; its counters
    continue, and ``max_iterations`` bounds the lifetime ``k`` as in the
    JAX driver. Tensor leaves keep their device; numpy leaves
    (`bfgs_state_to_numpy`) go to the CUDA card, as ``optimize``'s ``x0``
    does. The state is not changed."""
    state = as_device_state(state)
    if state.x.ndim != 1:
        raise ValueError(
            f"expected a single solve's BFGSState (x of shape (n,)), got x shape "
            f"{tuple(state.x.shape)}; batched states resume through "
            "optimize_batched_fused_from_state"
        )
    state = state._replace(status=torch.full_like(state.status, _RUNNING),
                           stall=torch.zeros_like(state.stall))
    return _run(obj, state, ls, tol, max_iterations, value_and_grad_fn, h0_scale, stall_limit,
                False, update_method)


# Host reads of the device (statuses, a resume's k, line-search rounds),
# summed over calls of both entry points and the fleet's backend="vmap";
# set it to 0 before a solve to count that solve alone.
optimize.host_syncs = 0
