"""Nonlinear conjugate-gradient fleet engine (memoryless quasi-Newton) — the
PyTorch port of ``quasinewtonmethods_jl_tpu/cg_solve.py`` (`optimize_cg`,
`optimize_cg_from_state`), the headline engine of ``bench.py``.

Where BFGS carries an (n, n) inverse Hessian, nonlinear CG carries one
extra (n,) vector per lane, the previous search direction. β formulas in
maximization form (y = g_old - g, the repo-wide pair convention):

    FR:  β = g·g / g_old·g_old
    PR+: β = max(0, g·(g - g_old) / g_old·g_old)
    DY:  β = g·g / d·y
    HZ:  β = max((2 (d·g)(y·y)/(d·y) - y·g) / (d·y),
                 -1 / (‖d‖ min(0.01, ‖g_old‖)))

The default is 'hz' with the approximate weak-Wolfe search. A non-ascent
direction (d·g <= 0 or NaN), a lane's first iteration and, for 'fr'/'pr',
Powell's test |g·g_old| > ν g·g reset in-band to steepest ascent. The step
along d is pre-scaled by t = α_prev·m_prev/m (Nocedal & Wright eq. 3.60) so
the line searches keep their α = 1 start. An optional diagonal
preconditioner P (fixed, or a per-iteration Hutchinson estimate of
1/|diag H|, ops/hutchinson.py) runs plain CG on x̃ = P^{-1/2}x.

Layout is lane-major: X, G, D are (batch, n) (the JAX carry is lane-minor
(n, batch), so its axis-0 sums are dim-1 sums here) and per-lane scalars
(batch,). The public `CGState` leaves are (batch, n) in both packages.

The host loop is the fleet BFGS engine's (batched_solve.py): a Python
loop on the host that owns ``k`` (the cap is exact), tests termination
every `TERMINATION_CHECK_INTERVAL` bodies (bodies after the last lane
finished are exact no-ops under the ``was_active`` masks) and reads the
line search's ``any(lane)`` once per round. Every read is counted in
``optimize_cg.host_syncs``; ``optimize_cg.loop_bodies`` counts the bodies.
The JAX engine has no Pallas kernel here: its β and direction passes are
XLA fusions, ported as torch ops.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from .api import as_value_and_grad, as_value_fn
from .batched_solve import (
    TERMINATION_CHECK_INTERVAL,
    _batched_linesearch,
    _batched_wolfe,
    _check_ls,
    _classify,
)
from .ops.hutchinson import hutchinson_abs_diag
from .ops.linesearch import BackTracking
from .ops.wolfe import Wolfe
from .solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT
from .state import CGState, Status
from .trust_region import _resolve_precondition
from .utils.device import as_device_state, as_device_tensor
from .utils.placement import coord_local, coord_sum, fleet_amax, fleet_any

__all__ = ["CGResult", "CGState", "optimize_cg", "optimize_cg_from_state"]

_CG_METHODS = ("hz", "pr", "fr", "dy")

_RUNNING = int(Status.RUNNING)
_CONVERGED = int(Status.CONVERGED)
_MAX_ITERATIONS = int(Status.MAX_ITERATIONS)
_LINESEARCH_FAILURE = int(Status.LINESEARCH_FAILURE)


class CGResult(NamedTuple):
    """Nonlinear-CG result: ``fun`` is the maximized logdensity on
    convergence and NaN on any failure; ``last_value`` is the final value
    regardless of status."""

    x: torch.Tensor
    fun: torch.Tensor
    grad: torch.Tensor
    status: torch.Tensor
    iterations: torch.Tensor
    n_fev: torch.Tensor
    n_gev: torch.Tensor
    n_resets: torch.Tensor
    last_value: torch.Tensor
    state: CGState

    @property
    def converged(self) -> torch.Tensor:
        return self.status == Status.CONVERGED


class _CGCarry(NamedTuple):
    X: torch.Tensor  # (batch, n)
    G: torch.Tensor  # (batch, n) gradient at X (the fold invariant)
    G_old: torch.Tensor  # (batch, n)
    D: torch.Tensor  # (batch, n)
    m_prev: torch.Tensor  # (batch,)
    t_prev: torch.Tensor  # (batch,)
    fun: torch.Tensor  # (batch,) objective at X (the fold invariant)
    fprev: torch.Tensor  # (batch,) previous iteration's objective (stall)
    k: int  # iterations of this leg, kept on the host
    status: torch.Tensor  # (batch,) int32
    iterations: torch.Tensor
    n_fev: torch.Tensor
    n_gev: torch.Tensor
    n_resets: torch.Tensor
    stall: torch.Tensor


def _cg_beta(method: str, g, G_old, D, restart_nu: float, P=None):
    """(β, Powell-restart mask, g̃·g̃) for the configured formula; every
    reduction is a (batch,) sum over dim 1. A zero or NaN denominator gives
    a non-finite β, whose direction then fails the ascent test and resets
    in-band. With ``P`` ((batch, n), positive) the formulas take the
    x̃-space products: gradient products gain a P, d·g and d·y are
    invariant, and ‖d̃‖ = √(d·d/P)."""
    if P is None:
        gg = coord_sum(g * g)
        gg_old = coord_sum(G_old * G_old)
        gdotgold = coord_sum(g * G_old)
    else:
        gg = coord_sum(g * P * g)
        gg_old = coord_sum(G_old * P * G_old)
        gdotgold = coord_sum(g * P * G_old)
    if method == "fr":
        beta = gg / gg_old
    elif method == "pr":
        beta = torch.clamp((gg - gdotgold) / gg_old, min=0.0)  # jnp.maximum(0, ·)
    elif method == "dy":
        y = G_old - g
        beta = gg / coord_sum(D * y)
    elif method == "hz":
        y = G_old - g
        dy = coord_sum(D * y)
        dg = coord_sum(D * g)
        if P is None:
            yy = coord_sum(y * y)
            yg = coord_sum(y * g)
            dnorm = torch.sqrt(coord_sum(D * D))
        else:
            yy = coord_sum(y * P * y)
            yg = coord_sum(y * P * g)
            dnorm = torch.sqrt(coord_sum(D * D / P))
        beta = (2.0 * dg * yy / dy - yg) / dy
        eta_k = -1.0 / (dnorm * torch.clamp(torch.sqrt(gg_old), max=0.01))
        beta = torch.maximum(beta, eta_k)
    else:  # pragma: no cover - validated at the public entry
        raise ValueError(f"unknown CG method {method!r}")
    if method in ("fr", "pr"):
        # Powell restart: successive gradients far from orthogonal
        powell = torch.abs(gdotgold) > restart_nu * gg
    else:
        # HZ's lower truncation / DY's self-restart property play that role
        powell = torch.zeros(gg.shape, dtype=torch.bool, device=gg.device)
    return beta, powell, gg


_HUTCHINSON_SEED_CG = 0x7453  # distinct from TR's stream


def _jacobi_precond_cg(hvp_b, X, k, probes):
    """(batch, n) positive preconditioner P ≈ 1/|diag H| at X: the guarded
    Hutchinson estimate (a degenerate lane estimates the identity, P = 1)
    inverted."""
    return 1.0 / hutchinson_abs_diag(hvp_b, X, k, probes, _HUTCHINSON_SEED_CG)


def _cg_body(c: _CGCarry, vag_b, f_b, method, ls, tol, stall_limit, restart_nu, fold,
             precond_mode, precond_P, hvp_b, precond_probes) -> _CGCarry:
    """One lockstep CG iteration over the fleet (JAX :231-378)."""
    dtype = c.X.dtype
    if fold:
        # fold_eval (Wolfe only): the accepted trial's evaluation seeds this
        # iteration; invariant: (c.fun, c.G) are the evaluation at c.X
        f0, g = c.fun, c.G
    else:
        f0, g = vag_b(c.X)
    was_active = c.status == _RUNNING  # the host never runs a body past the cap
    stall, status_pre, active = _classify(c.status, was_active, f0, g, c.fprev, c.stall, tol,
                                          stall_limit)

    probe_gev = 0
    if precond_mode == "none":
        P, Pg = None, g
    elif precond_mode == "fixed":
        P = precond_P
        Pg = P * g
    else:
        # jacobi: re-estimated at the current iterate; the probes are keyed
        # by the fleet's largest lifetime iteration count (not the leg's k),
        # so a chunked resume replays an uninterrupted run's probes
        P = _jacobi_precond_cg(hvp_b, c.X, fleet_amax(c.iterations), precond_probes)
        Pg = P * g
        probe_gev = precond_probes
    beta, powell, gg = _cg_beta(method, g, c.G_old, c.D, restart_nu, P)
    fresh = c.m_prev == 0.0  # never stepped (init, or a resume of one)
    # d = Pg + β d_prev; gg is g̃·g̃ = (Pg)·g, the reset direction's slope
    d = Pg + beta[:, None] * c.D
    m = coord_sum(d * g)
    # in-band steepest reset: non-ascent (NaN compares False, so tested
    # explicitly), first iteration, lost conjugacy
    reset = (~torch.isfinite(m)) | (m <= 0.0) | fresh | powell
    d = torch.where(active[:, None], torch.where(reset[:, None], Pg, d), torch.zeros_like(d))
    m = torch.where(active, torch.where(reset, gg, m), torch.ones_like(m))

    # warm-start scale (first-order match with the previous step); fresh or
    # garbage lanes fall back to 1/max(1, ‖g‖)
    t0 = 1.0 / torch.clamp(torch.sqrt(gg), min=1.0)
    t = c.t_prev * c.m_prev / m
    t_ok = torch.isfinite(t) & (t > 0.0)
    t = torch.where(fresh | ~t_ok, t0, t)
    t = torch.clamp(t, 1e-12, 1e12)
    d_ls = t[:, None] * d
    m_ls = t * m

    if isinstance(ls, Wolfe):

        def phi_vag(alpha):
            fv, gv = vag_b(c.X + alpha[:, None] * d_ls)
            return fv, coord_sum(gv * d_ls), gv

        alpha, ls_fev, _it, ls_failed, f_acc, G_acc, reads = _batched_wolfe(
            phi_vag, f0, m_ls, active, ls, dtype, with_grad=fold
        )
        ls_gev = ls_fev
    else:

        def phi(alpha):
            return f_b(c.X + alpha[:, None] * d_ls)

        alpha, ls_fev, _it, ls_failed, reads = _batched_linesearch(phi, f0, m_ls, active, ls,
                                                                   dtype)
        ls_gev = torch.zeros_like(ls_fev)
    optimize_cg.host_syncs += reads

    take = active & ~ls_failed
    # the step along the scaled direction is bitwise the accepted trial's
    # point (alpha * d_ls, not (alpha*t) * d): the fold invariant needs it
    step = torch.where(take[:, None], alpha[:, None] * d_ls, torch.zeros_like(d_ls))
    fun = torch.where(was_active, f0, c.fun)
    G = torch.where(was_active[:, None], g, c.G)
    if fold:
        fun = torch.where(take, f_acc, fun)
        G = torch.where(take[:, None], G_acc, G)
    # fold: no top-of-iteration evaluation, only the trials count
    top_ev = 0 if fold else was_active.to(torch.int32)
    return _CGCarry(
        X=c.X + step,
        G=G,
        G_old=torch.where(active[:, None], g, c.G_old),
        D=torch.where(active[:, None], d, c.D),
        m_prev=torch.where(take, m, c.m_prev),
        t_prev=torch.where(take, alpha * t, c.t_prev),
        fun=fun,
        fprev=torch.where(was_active, f0, c.fprev),
        k=c.k + 1,
        status=torch.where(active & ls_failed, _LINESEARCH_FAILURE, status_pre),
        iterations=c.iterations + active,
        n_fev=c.n_fev + ls_fev + top_ev,
        n_gev=c.n_gev + ls_gev + top_ev + probe_gev * active.to(torch.int32),
        n_resets=c.n_resets + (reset & active),
        stall=stall,
    )


def _cg_loop_batched(vag_b, f_b, carry0: _CGCarry, method: str, ls, tol,
                     max_iterations: int, stall_limit: int, restart_nu: float,
                     fold_eval: bool = False, precond_mode: str = "none",
                     precond_P=None, hvp_b=None, precond_probes: int = 2) -> _CGCarry:
    """Run bodies until every lane left RUNNING or ``max_iterations``;
    lanes still RUNNING end as MAX_ITERATIONS."""
    tol = torch.full((), tol, dtype=carry0.X.dtype, device=carry0.X.device)
    # fold needs the trial gradients only the Wolfe search evaluates
    fold = isinstance(ls, Wolfe) and fold_eval
    c = carry0
    while c.k < max_iterations:
        # every lane of a fresh or resumed fleet starts RUNNING, so the
        # first test comes after TERMINATION_CHECK_INTERVAL bodies
        if c.k and c.k % TERMINATION_CHECK_INTERVAL == 0:
            optimize_cg.host_syncs += 1  # the termination read
            if not bool(fleet_any(c.status == _RUNNING)):
                break
        c = _cg_body(c, vag_b, f_b, method, ls, tol, stall_limit, restart_nu, fold,
                     precond_mode, precond_P, hvp_b, precond_probes)
        optimize_cg.loop_bodies += 1
    return c._replace(status=torch.where(c.status == _RUNNING, _MAX_ITERATIONS, c.status))


def _result_from_cg_carry(fc: _CGCarry, squeeze: bool) -> CGResult:
    state = CGState(
        x=fc.X,
        grad=fc.G,
        grad_old=fc.G_old,
        d=fc.D,
        m_prev=fc.m_prev,
        t_prev=fc.t_prev,
        fun=fc.fun,
        k=fc.iterations,
        status=fc.status,
        n_fev=fc.n_fev,
        n_gev=fc.n_gev,
        n_resets=fc.n_resets,
        stall=fc.stall,
    )
    res = CGResult(
        x=fc.X,
        fun=torch.where(fc.status == _CONVERGED, fc.fun, torch.full_like(fc.fun, float("nan"))),
        grad=fc.G,
        status=fc.status,
        iterations=fc.iterations,
        n_fev=fc.n_fev,
        n_gev=fc.n_gev,
        n_resets=fc.n_resets,
        last_value=fc.fun,
        state=state,
    )
    if squeeze:
        res = CGResult(*(leaf[0] for leaf in res[:-1]), state=CGState(*(leaf[0] for leaf in state)))
    return res


def _fresh_cg_carry(X: torch.Tensor, status0: torch.Tensor) -> _CGCarry:
    """Fresh CG carry for a (batch, n) fleet; the fold path then seeds
    (fun, G, n_fev, n_gev) with one evaluation."""
    batch, n = X.shape
    dtype, device = X.dtype, X.device

    def zeros_v():
        return torch.zeros((batch, n), dtype=dtype, device=device)

    def zeros_i():
        return torch.zeros(batch, dtype=torch.int32, device=device)

    return _CGCarry(
        X=X,
        G=zeros_v(),
        G_old=zeros_v(),
        D=zeros_v(),
        m_prev=torch.zeros(batch, dtype=dtype, device=device),  # 0 = fresh: steepest first step
        t_prev=torch.zeros(batch, dtype=dtype, device=device),
        fun=torch.full((batch,), float("nan"), dtype=dtype, device=device),
        fprev=torch.full((batch,), float("nan"), dtype=dtype, device=device),
        k=0,
        status=status0,
        iterations=zeros_i(),
        n_fev=zeros_i(),
        n_gev=zeros_i(),
        n_resets=zeros_i(),
        stall=zeros_i(),
    )


def _cg_precond_pieces(vag, precond_mode, precond_diag, X: torch.Tensor):
    """(hvp_b, P) for the preconditioning mode. 'fixed' turns the user's
    Hessian-diagonal estimate into P = 1/diag at the fleet's (batch, n),
    dtype and device; 'jacobi' builds the fleet HVP, one ``torch.func.jvp``
    through the gradient per lane under ``torch.func.vmap`` (so an analytic
    ``value_and_grad_fn`` must be differentiable by torch.func)."""
    hvp_b = P = None
    if precond_mode == "jacobi":

        def grad_one(x):
            return vag(x)[1]

        def hvp_one(x, v):
            return torch.func.jvp(grad_one, (x,), (v,))[1]

        hvp_b = coord_local(torch.func.vmap(hvp_one), n_args=2)
    elif precond_mode == "fixed":
        diag = precond_diag.to(dtype=X.dtype, device=X.device).broadcast_to(X.shape)
        P = 1.0 / diag
    return hvp_b, P


def _run_cg(obj, carry0, method, ls, tol, max_iterations, value_and_grad_fn, stall_limit,
            restart_nu, fold_eval, squeeze, precondition, precond_probes, seed_fold):
    if method not in _CG_METHODS:
        raise ValueError(f"method must be one of {_CG_METHODS}, got {method!r}")
    _check_ls(ls)
    if precond_probes < 1:
        raise ValueError(f"precond_probes must be >= 1, got {precond_probes}")
    precond_mode, precond_diag = _resolve_precondition(precondition, carry0.X.shape[-1])
    vag = as_value_and_grad(obj, value_and_grad_fn)
    # under a model-sharded call each takes this rank's columns and the
    # objective sees the gathered vector
    vag_b = coord_local(torch.func.vmap(vag))
    f_b = coord_local(torch.func.vmap(as_value_fn(obj, value_and_grad_fn)))
    hvp_b, P = _cg_precond_pieces(vag, precond_mode, precond_diag, carry0.X)
    with torch.no_grad():
        if seed_fold and isinstance(ls, Wolfe) and fold_eval:
            # seed the fold invariant: (fun, G) = the evaluation at X
            fun0, G0 = vag_b(carry0.X)
            ones = torch.ones_like(carry0.n_fev)
            carry0 = carry0._replace(fun=fun0, G=G0, n_fev=ones, n_gev=ones)
        fc = _cg_loop_batched(vag_b, f_b, carry0, method, ls, tol, max_iterations, stall_limit,
                              float(restart_nu), bool(fold_eval), precond_mode, P, hvp_b,
                              int(precond_probes))
    return _result_from_cg_carry(fc, squeeze)


def optimize_cg(
    obj,
    x0,
    *,
    method: str = "hz",
    ls: Union[Wolfe, BackTracking] = Wolfe(approx=True),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    restart_nu: float = 0.2,
    fold_eval: bool = False,
    precondition=None,
    precond_probes: int = 2,
) -> CGResult:
    """Maximize a logdensity by nonlinear conjugate gradients.

    A rank-1 ``x0`` runs a single solve; a rank-2 (batch, n) ``x0`` runs
    the masked-lockstep fleet. A tensor's device is where the solve runs;
    anything else (numpy, lists) goes to the CUDA card (`as_device_tensor`).

    ``method``: 'hz' (Hager–Zhang, default), 'pr' (Polak–Ribière+), 'fr'
    (Fletcher–Reeves), 'dy' (Dai–Yuan). ``ls``: a `Wolfe` (default, with
    the approximate conditions) or a `BackTracking` (value-only trials).
    ``restart_nu``: Powell-restart threshold for 'fr'/'pr'. ``fold_eval``
    (Wolfe only): seed each iteration with the accepted trial's value and
    gradient instead of a top-of-iteration evaluation. ``precondition``:
    None (plain CG), 'jacobi' (a per-iteration Hutchinson estimate of
    1/|diag H| from ``precond_probes`` HVPs, counted in ``n_gev``) or a
    positive array broadcastable to (n,) or (batch, n), a fixed Hessian
    diagonal.

    Contracts as every engine: certificate max|∇obj| < ``tol``; ``fun`` NaN
    unless converged; the α = 0 line-search sentinel gives
    LINESEARCH_FAILURE with the iterate at the last good point;
    ``stall_limit`` consecutive non-improving iterations fail in-band;
    resumable with `optimize_cg_from_state` (pass the same options).
    """
    X0 = as_device_tensor(x0, "x0")
    if X0.ndim not in (1, 2):
        raise ValueError(f"x0 must be rank 1 or 2, got shape {tuple(X0.shape)}")
    squeeze = X0.ndim == 1
    if squeeze:
        X0 = X0[None]
    if max_iterations < 1:
        raise ValueError(f"max_iterations must be >= 1, got {max_iterations}")
    if not 0.0 < restart_nu:
        raise ValueError(f"restart_nu must be > 0, got {restart_nu}")
    status0 = torch.full((X0.shape[0],), _RUNNING, dtype=torch.int32, device=X0.device)
    return _run_cg(obj, _fresh_cg_carry(X0, status0), method, ls, tol, max_iterations,
                   value_and_grad_fn, stall_limit, restart_nu, fold_eval, squeeze,
                   precondition, precond_probes, seed_fold=True)


def optimize_cg_from_state(
    obj,
    state: CGState,
    *,
    method: str = "hz",
    ls: Union[Wolfe, BackTracking] = Wolfe(approx=True),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    restart_nu: float = 0.2,
    fold_eval: bool = False,
    precondition=None,
    precond_probes: int = 2,
) -> CGResult:
    """Resume a nonlinear-CG solve or fleet from a (checkpointed) `CGState`
    on its tensors' device.

    All lanes re-arm to RUNNING; counters continue from the saved values and
    ``max_iterations`` bounds this leg. A resumed lane continues its CG
    trajectory: the saved (grad_old, d, m_prev, t_prev) drive the first β
    and warm start as the uninterrupted run would, and lanes that never
    stepped (m_prev == 0) take the steepest first step. Pass the same
    ``method``, ``ls``, ``restart_nu``, ``fold_eval`` and ``precondition``
    as the original run (the fold trusts the saved (fun, grad) to be the
    evaluation at x; the jacobi probes are keyed by the saved lifetime
    iteration count). A rank-1 state (a single solve's) is re-batched.
    Tensor leaves keep their device; numpy leaves (`cg_state_to_numpy`) go
    to the CUDA card, as `optimize_cg`'s ``x0`` does."""
    state = as_device_state(state)
    squeeze = state.x.ndim == 1
    if squeeze:
        state = CGState(*(leaf[None] for leaf in state))
    if state.x.ndim != 2:
        raise ValueError(f"expected a rank-1 or rank-2 CGState, got x shape {tuple(state.x.shape)}")
    carry0 = _CGCarry(
        X=state.x,
        # the fold invariant at resume: a Wolfe-run state carries (fun,
        # grad) at x; the other bodies evaluate at the top regardless
        G=state.grad,
        G_old=state.grad_old,
        D=state.d,
        m_prev=state.m_prev,
        t_prev=state.t_prev,
        fun=state.fun,
        # a fresh stall comparison and budget per leg
        fprev=torch.full_like(state.fun, float("nan")),
        k=0,
        status=torch.full_like(state.status, _RUNNING),
        iterations=state.k,
        n_fev=state.n_fev,
        n_gev=state.n_gev,
        n_resets=state.n_resets,
        stall=torch.zeros_like(state.stall),
    )
    return _run_cg(obj, carry0, method, ls, tol, max_iterations, value_and_grad_fn, stall_limit,
                   restart_nu, fold_eval, squeeze, precondition, precond_probes, seed_fold=False)


# Host reads of the device (control flow) and loop bodies, summed over calls
# of both entry points; set them to 0 before a solve to count that solve.
optimize_cg.host_syncs = 0
optimize_cg.loop_bodies = 0
