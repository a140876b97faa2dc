"""Trust-region Newton–Krylov (Steihaug-CG) fleet engine — the PyTorch port
of ``quasinewtonmethods_jl_tpu/trust_region.py`` (`optimize_tr`,
`optimize_tr_from_state`).

The exact-curvature engine: each iteration solves the trust-region Newton
model  min_p g·p + ½ pᵀHp  s.t. ‖p‖ ≤ Δ  by matrix-free truncated CG, H
touched only through Hessian-vector products (one ``torch.func.jvp``
through ``torch.func.grad`` under ``torch.func.vmap``: no (n, n) matrix).
Steihaug's rules stop CG at the boundary and ride a negative-curvature
direction to it, which makes this the robust engine for stiff or locally
indefinite surfaces. Semantics are lane for lane the JAX engine's:
maximization convention (the minimization runs on −obj), Eisenstat–Walker
forcing η = cg_tol·min(0.5, √‖g‖), radius control, the certificate-accept
of a trial whose own gradient certifies, gated on non-ascent up to
32·eps·max(|f|, 1), Δ-collapse or `TR_STALL_LIMIT` rejected trials as
LINESEARCH_FAILURE, projected steps under ``bounds=`` (the active set of
least_squares.py), and preconditioned Steihaug-CG with a fixed or Jacobi
(Hutchinson, ops/hutchinson.py) diagonal.

Layout is lane-major (batch, n), as the JAX engine's.

The loops. JAX runs an outer and an inner ``lax.while_loop``. Here both are
Python loops on the host. The outer loop reads ``any(lane RUNNING)`` every
`TERMINATION_CHECK_INTERVAL` bodies, starting before the first; extra
bodies are exact no-ops under the ``active`` masks. The inner Steihaug loop
reads ``any(lane in CG)`` before its first body and every
`TERMINATION_CHECK_INTERVAL` bodies after, and stops at ``max_cg``. Its
iteration count ``j`` is fleet-wide in JAX (the bodies run while any lane
was in CG, added to every active lane's ``n_hev``), so the port adds
``any(lane in CG)`` to ``j`` on the device each body: the masked extra
bodies leave it, and every lane's state, unchanged, and ``n_hev`` equals
JAX's with no read per body (an extra body costs one HVP, which no counter
shows). Every read is counted in ``optimize_tr.host_syncs``; bodies in
``optimize_tr.loop_bodies`` (outer) and ``optimize_tr.cg_bodies`` (inner).
The JAX engine has no TPU kernel: its HVPs and CG are XLA operations,
ported as torch ops.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from .api import as_value_and_grad
from .batched_solve import TERMINATION_CHECK_INTERVAL
from .least_squares import _check_bounds, _kkt_criticality
from .ops.hutchinson import hutchinson_abs_diag
from .state import Status, TRState
from .utils.device import as_device_state, as_device_tensor
from .utils.placement import (
    coord_all,
    coord_count,
    coord_local,
    coord_sum,
    fleet_amax,
    fleet_any,
)

__all__ = [
    "TRState",
    "TRResult",
    "optimize_tr",
    "optimize_tr_from_state",
    "TR_MAX_ITERATIONS_DEFAULT",
    "TR_STALL_LIMIT",
]

TR_MAX_ITERATIONS_DEFAULT = 500
TR_STALL_LIMIT = 30  # consecutive rejected trials before Δ-collapse failure

_RUNNING = int(Status.RUNNING)
_CONVERGED = int(Status.CONVERGED)
_MAX_ITERATIONS = int(Status.MAX_ITERATIONS)
_LINESEARCH_FAILURE = int(Status.LINESEARCH_FAILURE)
_NONFINITE_VALUE = int(Status.NONFINITE_VALUE)

_HUTCHINSON_SEED = 0x7452  # the JAX engine's stream constant


class TRResult(NamedTuple):
    """Trust-region result: ``fun`` is the maximized logdensity on
    convergence and NaN on any failure; ``last_value`` is the final value
    regardless of status."""

    x: torch.Tensor
    fun: torch.Tensor
    grad: torch.Tensor  # ∇obj at x (maximization orientation)
    status: torch.Tensor
    iterations: torch.Tensor
    n_fev: torch.Tensor
    n_hev: torch.Tensor  # Hessian-vector products (the engine's unit of work)
    delta: torch.Tensor  # final trust radius (diagnostic)
    last_value: torch.Tensor
    state: TRState  # resumable via optimize_tr_from_state

    @property
    def converged(self) -> torch.Tensor:
        return self.status == Status.CONVERGED


def _make_fleet_fns(obj, value_and_grad_fn):
    """(vag, hvp) of the minimization objective, batched over lanes:
    hvp(x, v) = ∇²(−obj)(x)·v by one jvp through the gradient."""
    vag_max = as_value_and_grad(obj, value_and_grad_fn)

    def vag_min_one(x):
        f, g = vag_max(x)
        return -f, -g

    def grad_min_one(x):
        return vag_min_one(x)[1]

    def hvp_one(x, v):
        return torch.func.jvp(grad_min_one, (x,), (v,))[1]

    # under a model-sharded call each takes this rank's columns and the
    # objective sees the gathered vector
    return (coord_local(torch.func.vmap(vag_min_one)),
            coord_local(torch.func.vmap(hvp_one), n_args=2))


def _norm(v):
    return torch.sqrt(coord_sum(v * v))


def _steihaug_cg(hvp_fleet, x, g, delta, active, max_cg: int, cg_tol: float, free=None,
                 want_hp: bool = True, Mdiag=None):
    """Batched Steihaug-Toint truncated CG, optionally preconditioned by
    ``Mdiag`` (the trust region then lives in the M-norm) and restricted to
    the ``free`` coordinates (bounded path). Returns (p, Hp, iters_used,
    hit_boundary), ``iters_used`` a 0-d int32 device tensor; ``Hp`` is one
    extra HVP at the end (None unless ``want_hp``)."""
    tiny = torch.finfo(x.dtype).tiny

    if free is not None:
        fm = free.to(x.dtype)
        g = g * fm
        hvp_inner = hvp_fleet

        def hvp_fleet(xx, vv):
            return hvp_inner(xx, vv) * fm

    if Mdiag is None:
        def apply_minv(r):
            return r

        def wdot(a, b):
            return coord_sum(a * b)
    else:
        def apply_minv(r):
            return r / Mdiag

        def wdot(a, b):
            return coord_sum(Mdiag * a * b)

    gnorm = _norm(g)
    # Eisenstat–Walker forcing: loose early, sharp near the solution
    eta = cg_tol * torch.clamp_max(torch.sqrt(torch.clamp_min(gnorm, tiny)), 0.5)
    r_stop = eta * gnorm

    p = torch.zeros_like(x)
    r = g
    z = apply_minv(r)
    rz = coord_sum(r * z)
    d = -z
    # lanes already within tolerance at p = 0 never enter CG
    cg_act = active & (_norm(r) > r_stop)
    j = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(max_cg):
        if i % TERMINATION_CHECK_INTERVAL == 0:
            optimize_tr.host_syncs += 1
            if not bool(fleet_any(cg_act)):
                break
        # the inner loop runs while any lane of the whole fleet is in it
        j = j + fleet_any(cg_act)
        Hd = hvp_fleet(x, d)
        dHd = coord_sum(d * Hd)
        pp = wdot(p, p)

        neg_curv = dHd <= 0.0
        alpha = rz / torch.where(neg_curv, 1.0, torch.clamp_min(dHd, tiny))
        p_int = p + alpha[:, None] * d
        leaves = wdot(p_int, p_int) > delta * delta

        # positive root of ‖p + τd‖_M² = Δ² (tiny-guarded for masked lanes)
        pd = wdot(p, d)
        dd = torch.clamp_min(wdot(d, d), tiny)
        disc = pd * pd + dd * (delta * delta - pp)
        tau = (-pd + torch.sqrt(torch.clamp_min(disc, 0.0))) / dd
        p_bnd = p + tau[:, None] * d

        to_boundary = cg_act & (neg_curv | leaves)
        step_in = cg_act & ~to_boundary

        p = torch.where(to_boundary[:, None], p_bnd, torch.where(step_in[:, None], p_int, p))
        r = torch.where(step_in[:, None], r + alpha[:, None] * Hd, r)
        z = apply_minv(r)
        rz_new = torch.where(step_in, coord_sum(r * z), rz)

        small = _norm(r) <= r_stop
        cg_act = cg_act & ~to_boundary & ~small
        beta = rz_new / torch.clamp_min(rz, tiny)
        d = torch.where(cg_act[:, None], -z + beta[:, None] * d, d)
        rz = rz_new
        optimize_tr.cg_bodies += 1

    Hp = hvp_fleet(x, p) if want_hp else None
    hit_boundary = wdot(p, p) >= (1.0 - 1e-6) * delta * delta
    return p, Hp, j, hit_boundary


def _jacobi_diag(hvp_fleet, x, k, probes: int):
    """Hutchinson |diag H| of the minimization objective at x, guarded
    positive (ops/hutchinson.py), keyed by the fleet's largest lifetime
    iteration count so a chunked resume replays the probes."""
    return hutchinson_abs_diag(hvp_fleet, x, fleet_amax(k), probes, _HUTCHINSON_SEED)


def _tr_body(vag_fleet, hvp_fleet, bounds, tol, max_iterations, max_cg, cg_tol, delta_max,
             eta_accept, precond_mode, precond_probes, precond_diag, s: TRState) -> TRState:
    """One lockstep trust-region iteration over the fleet (JAX `_tr_body`)."""
    dtype = s.x.dtype
    tiny = torch.finfo(dtype).tiny
    eps = torch.finfo(dtype).eps
    active = s.status == _RUNNING

    if precond_mode == "none":
        Mdiag, probe_hev = None, 0
    elif precond_mode == "fixed":
        Mdiag, probe_hev = precond_diag.broadcast_to(s.x.shape), 0
    else:  # jacobi: re-estimated at the iterate; the probes count as HVPs
        Mdiag, probe_hev = _jacobi_diag(hvp_fleet, s.x, s.k, precond_probes), precond_probes

    if bounds is None:
        p, Hp, cg_iters, hit_bnd = _steihaug_cg(hvp_fleet, s.x, s.g, s.delta, active, max_cg,
                                                cg_tol, Mdiag=Mdiag)
        x_t = s.x + p
    else:
        lo, hi = bounds
        # blocked = at a face with the (minimization) gradient pushing out
        blocked = ((s.x <= lo) & (s.g > 0)) | ((s.x >= hi) & (s.g < 0))
        p, _, cg_iters, hit_bnd = _steihaug_cg(hvp_fleet, s.x, s.g, s.delta, active, max_cg,
                                               cg_tol, free=~blocked, want_hp=False, Mdiag=Mdiag)
        # clip, then score the model along the step actually taken
        x_t = torch.clamp(s.x + p, lo, hi)
        p = x_t - s.x
        Hp = hvp_fleet(s.x, p)
    # predicted decrease of the quadratic model, >= 0 for every Steihaug exit
    pred = -(coord_sum(s.g * p) + 0.5 * coord_sum(p * Hp))
    extra_hev = 1
    pnorm = _norm(p) if Mdiag is None else torch.sqrt(coord_sum(Mdiag * p * p))

    f_t, g_t = vag_fleet(x_t)
    trial_ok = torch.isfinite(f_t) & coord_all(torch.isfinite(g_t))
    rho = (s.fun - f_t) / torch.clamp_min(pred, tiny)

    accept = active & trial_ok & (pred > 0.0) & (rho > eta_accept)
    # the endgame: accept a finite trial whose own gradient certifies,
    # gated on non-ascent up to rounding slack
    slack = 32.0 * eps * torch.clamp_min(torch.abs(s.fun), 1.0)
    trial_certifies = (trial_ok & (_kkt_criticality(x_t, g_t, bounds) < tol)
                       & (f_t <= s.fun + slack))
    accept = accept | (active & trial_certifies)

    # poor fit shrinks relative to the step; a good fit on the boundary grows
    shrink = ~trial_ok | (rho < 0.25)
    grow = trial_ok & (rho > 0.75) & hit_bnd
    delta_new = torch.where(
        shrink,
        0.25 * torch.clamp_min(pnorm, tiny),
        torch.where(grow, torch.clamp_max(2.0 * s.delta, delta_max), s.delta),
    )

    x_new = torch.where(accept[:, None], x_t, s.x)
    fun_new = torch.where(accept, f_t, s.fun)
    g_new = torch.where(accept[:, None], g_t, s.g)
    stall_new = torch.where(accept, torch.zeros_like(s.stall), s.stall + 1)

    k_new = torch.where(active, s.k + 1, s.k)
    # Δ-collapse: the float eps floor, further shrinks cannot change x_t
    collapsed = (stall_new >= TR_STALL_LIMIT) | (
        delta_new <= eps * torch.clamp_min(_norm(x_new), 1.0))
    # priority, highest last: cap < collapse < converged
    code = torch.where(k_new >= max_iterations, _MAX_ITERATIONS, torch.full_like(s.status, _RUNNING))
    code = torch.where(collapsed, _LINESEARCH_FAILURE, code)
    code = torch.where(_kkt_criticality(x_new, g_new, bounds) < tol, _CONVERGED, code)
    return TRState(
        x=x_new,
        fun=fun_new,
        g=g_new,
        delta=torch.where(active, delta_new, s.delta),
        k=k_new,
        status=torch.where(active, code, s.status),
        n_fev=s.n_fev + active.to(torch.int32),
        n_hev=torch.where(active, s.n_hev + cg_iters + (extra_hev + probe_hev), s.n_hev),
        stall=torch.where(active, stall_new, s.stall),
    )


def _init_tr_state(vag_fleet, X0, delta0: float) -> TRState:
    B = X0.shape[0]
    f0, g0 = vag_fleet(X0)
    bad = ~(torch.isfinite(f0) & coord_all(torch.isfinite(g0)))
    zi = torch.zeros(B, dtype=torch.int32, device=X0.device)
    return TRState(
        x=X0,
        fun=f0,
        g=g0,
        delta=torch.full((B,), float(delta0), dtype=X0.dtype, device=X0.device),
        k=zi,
        status=torch.where(bad, _NONFINITE_VALUE, zi),
        n_fev=torch.ones_like(zi),
        n_hev=torch.zeros_like(zi),
        stall=torch.zeros_like(zi),
    )


def _tr_loop(body, s: TRState, max_iterations: int) -> TRState:
    """The outer host loop (module docstring): a running lane ends within
    ``max_iterations`` bodies."""
    for i in range(max_iterations):
        if i % TERMINATION_CHECK_INTERVAL == 0:
            optimize_tr.host_syncs += 1
            if not bool(fleet_any(s.status == _RUNNING)):
                break
        s = body(s)
        optimize_tr.loop_bodies += 1
    return s


def _result_from_state(s: TRState, squeeze: bool) -> TRResult:
    fun_max = -s.fun  # back to the maximization orientation
    r = TRResult(
        x=s.x,
        fun=torch.where(s.status == _CONVERGED, fun_max, torch.full_like(fun_max, float("nan"))),
        grad=-s.g,
        status=s.status,
        iterations=s.k,
        n_fev=s.n_fev,
        n_hev=s.n_hev,
        delta=s.delta,
        last_value=fun_max,
        state=s,
    )
    if squeeze:
        r = TRResult(*(leaf[0] for leaf in r[:-1]), state=TRState(*(leaf[0] for leaf in s)))
    return r


def _resolve_precondition(precondition, n: int):
    """(mode, diag) from the public ``precondition=`` knob.

    None → plain CG ("none"); 'jacobi' → a per-iteration Hutchinson
    diagonal; an array or tensor → a fixed positive diagonal ("fixed"),
    broadcastable to (n,) or the fleet's (B, n). Validated eagerly (the
    port has no tracers); the diagonal keeps its device."""
    if precondition is None:
        return "none", None
    if isinstance(precondition, str):
        if precondition != "jacobi":
            raise ValueError(
                "precondition must be None, 'jacobi', or a positive "
                f"diagonal array, got {precondition!r}"
            )
        return "jacobi", None
    diag = torch.as_tensor(precondition)
    if diag.ndim == 0 or diag.shape[-1] != n:
        raise ValueError(
            f"precondition diagonal last axis must be n={n}, got shape {tuple(diag.shape)}"
        )
    if not bool(torch.all(torch.isfinite(diag) & (diag > 0))):
        raise ValueError("precondition diagonal must be finite and > 0")
    return "fixed", diag


def _run(obj, state_or_x0, bounds, precondition, value_and_grad_fn, *, tol, max_iterations,
         max_cg, cg_tol, delta0, delta_max, eta_accept, precond_probes, squeeze) -> TRResult:
    """Fresh (``state_or_x0`` a (B, n) tensor) or resumed (a `TRState`)
    solve."""
    resume = isinstance(state_or_x0, TRState)
    X = state_or_x0.x if resume else state_or_x0
    n = X.shape[-1]
    if max_cg is None:
        max_cg = min(coord_count(n), 64)
    if max_cg < 1:
        raise ValueError(f"max_cg must be >= 1, got {max_cg}")
    precond_mode, precond_diag = _resolve_precondition(precondition, n)
    if precond_diag is not None:
        precond_diag = precond_diag.to(dtype=X.dtype, device=X.device)
    vag_fleet, hvp_fleet = _make_fleet_fns(obj, value_and_grad_fn)
    with torch.no_grad():
        if resume:
            # re-arm MAX_ITERATIONS lanes against the new lifetime budget
            s = state_or_x0
            rearm = (s.status == _MAX_ITERATIONS) & (s.k < max_iterations)
            s = s._replace(status=torch.where(rearm, _RUNNING, s.status))
        else:
            if bounds is not None:
                X = torch.clamp(X, bounds[0], bounds[1])
            s = _init_tr_state(vag_fleet, X, delta0)
            # lanes already at a critical (KKT) point converge at once
            conv0 = (s.status == _RUNNING) & (_kkt_criticality(s.x, s.g, bounds) < tol)
            s = s._replace(status=torch.where(conv0, _CONVERGED, s.status))

        def body(c):
            return _tr_body(vag_fleet, hvp_fleet, bounds, tol, max_iterations, int(max_cg),
                            float(cg_tol), float(delta_max), float(eta_accept), precond_mode,
                            int(precond_probes), precond_diag, c)

        s = _tr_loop(body, s, max_iterations)
    return _result_from_state(s, squeeze)


def optimize_tr(
    obj,
    x0,
    *,
    bounds: Optional[Any] = None,
    tol: float = 1e-8,
    max_iterations: int = TR_MAX_ITERATIONS_DEFAULT,
    max_cg: Optional[int] = None,
    cg_tol: float = 1.0,
    delta0: float = 1.0,
    delta_max: float = 1e6,
    eta_accept: float = 1e-4,
    precondition: Optional[Any] = None,
    precond_probes: int = 2,
    value_and_grad_fn: Optional[Callable] = None,
) -> TRResult:
    """Maximize a logdensity by trust-region Newton–Krylov (Steihaug-CG).

    A rank-1 ``x0`` runs one solve; a rank-2 (batch, n) ``x0`` runs the
    masked-lockstep fleet (one objective, many starts). A tensor's device
    is where the solve runs; anything else goes to the CUDA card
    (`as_device_tensor`). Certificate max|∇obj| < ``tol``; ``fun`` NaN
    unless converged; Δ-collapse or `TR_STALL_LIMIT` rejected trials in a
    row are LINESEARCH_FAILURE; a non-finite value at x0 is
    NONFINITE_VALUE.

    ``max_cg`` defaults to min(n, 64); ``cg_tol`` scales the forcing;
    ``value_and_grad_fn`` supplies an analytic gradient, and the HVPs are
    one jvp through it (so ``torch.func`` must be able to differentiate
    it). ``bounds=(lo, hi)`` runs projected TR with an elementwise active
    set, x0 clipped in, the KKT projected-gradient certificate.
    ``precondition='jacobi'`` runs preconditioned Steihaug-CG with a
    per-iteration Hutchinson |diag H| (``precond_probes`` HVPs, counted in
    ``n_hev``); a positive array (broadcastable to (n,) or (B, n)) is a
    fixed diagonal; the radius then lives in the M-norm. Host reads are
    counted in ``optimize_tr.host_syncs``.
    """
    X0 = as_device_tensor(x0, "x0")
    if X0.ndim not in (1, 2):
        raise ValueError(f"x0 must be rank 1 or 2, got shape {tuple(X0.shape)}")
    squeeze = X0.ndim == 1
    if squeeze:
        X0 = X0[None]
    if max_iterations < 1:
        raise ValueError(f"max_iterations must be >= 1, got {max_iterations}")
    if not float(delta0) > 0.0:
        raise ValueError(f"delta0 must be > 0, got {delta0}")
    if precond_probes < 1:
        raise ValueError(f"precond_probes must be >= 1, got {precond_probes}")
    return _run(obj, X0, _check_bounds(bounds, X0, optimize_tr), precondition, value_and_grad_fn,
                tol=float(tol), max_iterations=int(max_iterations), max_cg=max_cg, cg_tol=cg_tol,
                delta0=float(delta0), delta_max=delta_max, eta_accept=eta_accept,
                precond_probes=precond_probes, squeeze=squeeze)


def optimize_tr_from_state(
    obj,
    state: TRState,
    *,
    bounds: Optional[Any] = None,
    tol: float = 1e-8,
    max_iterations: int = TR_MAX_ITERATIONS_DEFAULT,
    max_cg: Optional[int] = None,
    cg_tol: float = 1.0,
    delta_max: float = 1e6,
    eta_accept: float = 1e-4,
    precondition: Optional[Any] = None,
    precond_probes: int = 2,
    value_and_grad_fn: Optional[Callable] = None,
) -> TRResult:
    """Resume a trust-region solve from a saved `TRState`.

    ``max_iterations`` is the lifetime cap (state.k counts across legs); a
    chunked resume reproduces the long run (the Jacobi probes are keyed by
    the carried iteration counts). ``max_cg``, ``cg_tol``, ``bounds`` and
    ``precondition`` must match the original call. Tensor leaves keep
    their device; numpy leaves (`tr_state_to_numpy`, or a JAX state's
    leaves) go to the CUDA card, as ``x0`` does."""
    if max_iterations < 1:
        raise ValueError(f"max_iterations must be >= 1, got {max_iterations}")
    if precond_probes < 1:
        raise ValueError(f"precond_probes must be >= 1, got {precond_probes}")
    state = as_device_state(state)
    squeeze = state.x.ndim == 1
    if squeeze:
        state = TRState(*(leaf[None] for leaf in state))
    return _run(obj, state, _check_bounds(bounds, state.x, optimize_tr), precondition,
                value_and_grad_fn, tol=float(tol), max_iterations=int(max_iterations),
                max_cg=max_cg, cg_tol=cg_tol, delta0=None, delta_max=delta_max,
                eta_accept=eta_accept, precond_probes=precond_probes, squeeze=squeeze)


# Host reads of the device (control flow of both loops, the bounds check),
# outer and inner (Steihaug) bodies, summed over calls of both entry points
# and of the auglag TR inner fleets; set them to 0 before a solve to count
# that solve alone.
optimize_tr.host_syncs = 0
optimize_tr.loop_bodies = 0
optimize_tr.cg_bodies = 0
