"""Constrained optimization: the augmented-Lagrangian outer loop over the
port's engines — the PyTorch port of
``quasinewtonmethods_jl_tpu/constrained.py`` (`optimize_auglag`,
`AugLagResult`).

    maximize f(x)  s.t.  eq(x) = 0,  ineq(x) >= 0

Each outer round maximizes the Powell–Hestenes–Rockafellar augmented
objective

    F(x) = f(x) − λᵀh − (ρ/2)‖h‖²  −  (1/2ρ) Σᵢ [max(0, μᵢ − ρ cᵢ)² − μᵢ²]

with one of the engines (BFGS, L-BFGS, CG, TR), then updates the
multipliers, λ ← λ + ρ h(x*), μ ← max(0, μ − ρ c(x*)), and grows ρ where
the KKT violation max(|h|, |min(c, μ/ρ)|) did not shrink by
``viol_decrease``. Semantics are the JAX module's, lane for lane: success
is the KKT certificate (the last inner solve CONVERGED and violation <=
``ctol``), only a NONFINITE_VALUE inner status is a hard failure, and
``fun`` is NaN unless the certificate holds.

A rank-1 ``x0`` runs one solve through the public single-solve engines
(`optimize`, `optimize_lbfgs`, `optimize_cg`, `optimize_tr`); a rank-2
(batch, n) ``x0`` runs the constrained fleet: per-lane (λ, μ, ρ,
violation) in the outer carry and the fleet engines' own carry constructors and
loops as the inner solve (`batched_solve._fresh_bfgs_carry` /
`_solve_loop_batched` with the update `_auto_kernel` picks, B1 on the card;
`lbfgs_batched_solve._fresh_lbfgs_carry` / `_lbfgs_loop_batched`;
`cg_solve._fresh_cg_carry` / `_cg_loop_batched`; the TR body of
trust_region.py). Lanes the outer loop has finished enter every later inner
fleet as MAX_ITERATIONS, so the inner masks freeze them from step one. The
fleet is lane-major: X (batch, n), λ (batch, me), μ (batch, mi).

``max(0, ·)`` is ``torch.maximum`` against zeros: at a tie its derivative
is ½ in both modes, as ``jnp.maximum``'s is (``torch.clamp_min`` takes 1
there), which the TR engine's HVPs see on a lane exactly on a constraint's
kink.

The outer loop runs on the host. JAX runs it as one ``lax.while_loop``
around the inner engine's; here each round enqueues the inner solve (whose
loop reads the device as that engine does) and, from the second round on,
reads whether any lane (or the single solve) is still unfinished: one
counted read a round. ``optimize_auglag.host_syncs`` counts every read an
auglag solve makes, its inner engines' included (they count theirs in
their own counters too); ``optimize_auglag.loop_bodies`` counts the outer
rounds and ``optimize_auglag.inner_bodies`` the inner engines' loop bodies
(the fleet engines'; the single-solve engines count none). ``kernel`` takes the
port's names ('auto', 'cuda', 'torch'); the JAX ``block_batch`` and its
lane padding exist for the TPU's Pallas blocks and are not ported.

Two faults of the reference are copied, as ROADMAP.md C.3 records: the TR
inner fleet hard-codes ``delta0`` = 1, ``delta_max`` = 1e6, ``eta_accept``
= 1e-4, ``max_cg`` = min(n, 64) and ``cg_tol`` = 1, and ``n_fev`` counts
the inner objective evaluations only, not the TR inner solves' HVPs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from .api import _pin_matmul_precision, as_value_and_grad, as_value_fn
from .batched_solve import (
    _UPDATE_FNS,
    _auto_kernel,
    _fresh_bfgs_carry,
    _solve_loop_batched,
    optimize_batched_fused,
)
from .cg_solve import _cg_loop_batched, _fresh_cg_carry, optimize_cg
from .lbfgs_batched_solve import (
    _RING_CIRCULAR_MIN_N,
    _fresh_lbfgs_carry,
    _lbfgs_loop_batched,
    optimize_lbfgs_batched_fused,
)
from .lbfgs_solve import optimize_lbfgs
from .ops.wolfe import Wolfe
from .solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT, optimize
from .state import Status
from .trust_region import _init_tr_state, _tr_body, _tr_loop, optimize_tr
from .utils.device import as_device_tensor
from .utils.placement import fleet_any

__all__ = ["AugLagResult", "optimize_auglag"]

_ENGINES = ("bfgs", "lbfgs", "cg", "tr")

_RUNNING = int(Status.RUNNING)
_CONVERGED = int(Status.CONVERGED)
_MAX_ITERATIONS = int(Status.MAX_ITERATIONS)
_NONFINITE_VALUE = int(Status.NONFINITE_VALUE)

# Each engine's counters (host reads, loop bodies): the single solve's and
# the fleet's.
_SOLO_COUNTERS = {"bfgs": optimize, "lbfgs": optimize_lbfgs, "cg": optimize_cg, "tr": optimize_tr}
_FLEET_COUNTERS = {"bfgs": optimize_batched_fused, "lbfgs": optimize_lbfgs_batched_fused,
                   "cg": optimize_cg, "tr": optimize_tr}


class AugLagResult(NamedTuple):
    """Constrained solve result: ``fun`` is f(x) when the KKT certificate
    holds (inner convergence and violation <= ctol) and NaN otherwise;
    ``viol`` the final KKT violation; ``eq``/``ineq`` the final constraint
    values ((0,) when absent); ``lam``/``mu`` the multipliers;
    ``inner_status`` the last inner engine status; ``last_value`` f(x) at
    the final iterate regardless of status. A fleet's leaves have the
    leading batch axis."""

    x: torch.Tensor
    fun: torch.Tensor
    grad: torch.Tensor  # ∇f at x (maximization orientation)
    status: torch.Tensor
    viol: torch.Tensor
    eq: torch.Tensor
    ineq: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    rho: torch.Tensor
    n_outer: torch.Tensor
    iterations: torch.Tensor  # total inner iterations across outer rounds
    n_fev: torch.Tensor
    inner_status: torch.Tensor
    last_value: torch.Tensor

    @property
    def converged(self) -> torch.Tensor:
        return self.status == Status.CONVERGED


def _flat1d(fn: Callable) -> Callable:
    """The constraint, at least 1-d, run with TF32 off; extra positional
    arguments (a lane's constraint data) pass through."""
    fn_pinned = _pin_matmul_precision(fn)

    def flat(x, *args):
        return torch.atleast_1d(fn_pinned(x, *args))

    return flat


def _relu(t):
    """max(0, t) with jnp.maximum's derivative at the tie (module docstring)."""
    return torch.maximum(t, torch.zeros_like(t))


def _make_penalty(eq, ineq, dtype):
    """The scalar PHR penalty of one point, ``pen(x, lam, mu, rho, *d)``
    (``d`` the constraint data, when there are any)."""

    def pen(x, lam, mu, rho, *d):
        p = torch.zeros((), dtype=dtype, device=x.device)
        if eq is not None:
            h = eq(x, *d)
            p = p + torch.dot(lam, h) + 0.5 * rho * torch.dot(h, h)
        if ineq is not None:
            t = _relu(mu - rho * ineq(x, *d))
            p = p + (0.5 / rho) * (torch.dot(t, t) - torch.dot(mu, mu))
        return p

    return pen


class _Counted:
    """Adds an engine's host reads and loop bodies over a block to
    ``optimize_auglag``'s counters."""

    def __init__(self, engine):
        self.engine = engine

    def __enter__(self):
        self.syncs = self.engine.host_syncs
        self.bodies = getattr(self.engine, "loop_bodies", 0)

    def __exit__(self, *exc):
        optimize_auglag.host_syncs += self.engine.host_syncs - self.syncs
        optimize_auglag.inner_bodies += getattr(self.engine, "loop_bodies", 0) - self.bodies


def _read_any(mask: torch.Tensor) -> bool:
    """``any(mask)`` over the whole fleet, on the host: one counted read."""
    optimize_auglag.host_syncs += 1
    return bool(fleet_any(mask))


def _run_engine(engine, F, x, F_vag, tol, max_iterations, ls, history, cg_method):
    """One inner maximize of the augmented objective: the engine's (x,
    status, iterations, n_fev)."""
    if engine == "bfgs":
        r = optimize(F, x, ls=ls, tol=tol, max_iterations=max_iterations, value_and_grad_fn=F_vag)
    elif engine == "lbfgs":
        r = optimize_lbfgs(F, x, history=history, ls=ls, tol=tol, max_iterations=max_iterations,
                           value_and_grad_fn=F_vag)
    elif engine == "cg":
        r = optimize_cg(F, x, method=cg_method, ls=ls, tol=tol, max_iterations=max_iterations,
                        value_and_grad_fn=F_vag)
    else:  # tr
        r = optimize_tr(F, x, tol=tol, max_iterations=max_iterations, value_and_grad_fn=F_vag)
    return r.x, r.status, r.iterations, r.n_fev


def _auglag_core(obj, x0, eq, ineq, lam0, mu0, rho0, tol, ctol, rho_growth, viol_decrease,
                 rho_max, engine, value_and_grad_fn, ls, max_outer, max_iterations, history,
                 cg_method, cdata=None) -> AugLagResult:
    """The single solve (JAX `_auglag_core`), outer loop on the host."""
    vag_f = as_value_and_grad(obj, value_and_grad_fn)
    f_val = as_value_fn(obj, value_and_grad_fn)
    dtype, device = x0.dtype, x0.device
    zero1 = torch.zeros((0,), dtype=dtype, device=device)
    ca = () if cdata is None else (cdata,)
    penalty = _make_penalty(eq, ineq, dtype)
    pen_vag = torch.func.grad_and_value(penalty)

    def h_of(x):
        return eq(x, *ca) if eq is not None else zero1

    def c_of(x):
        return ineq(x, *ca) if ineq is not None else zero1

    def violation(h, c, mu, rho):
        v = torch.zeros((), dtype=dtype, device=device)
        if eq is not None:
            v = torch.maximum(v, torch.amax(torch.abs(h)))
        if ineq is not None:
            v = torch.maximum(v, torch.amax(torch.abs(torch.minimum(c, mu / rho))))
        return v

    x, lam, mu, rho = x0, lam0, mu0, rho0
    v = torch.full((), float("inf"), dtype=dtype, device=device)
    tot_it = torch.zeros((), dtype=torch.int32, device=device)
    tot_fev = torch.zeros_like(tot_it)
    success = torch.zeros((), dtype=torch.bool, device=device)
    hard = torch.zeros_like(success)
    inner_st = torch.full((), _RUNNING, dtype=torch.int32, device=device)
    k = 0
    while k < max_outer:
        if k and not _read_any(~success & ~hard):
            break

        def F(xx, lam=lam, mu=mu, rho=rho):
            # value-only trials (line searches) never pay a gradient
            return f_val(xx) - penalty(xx, lam, mu, rho, *ca)

        def F_vag(xx, lam=lam, mu=mu, rho=rho):
            fv, fg = vag_f(xx)
            pg, pv = pen_vag(xx, lam, mu, rho, *ca)
            return fv - pv, fg - pg

        with _Counted(_SOLO_COUNTERS[engine]):
            x1, st, it, fev = _run_engine(engine, F, x, F_vag, tol, max_iterations, ls, history,
                                          cg_method)
        with torch.no_grad():
            h, c = h_of(x1), c_of(x1)
            v_new = violation(h, c, mu, rho)
            lam = lam + rho * h
            mu = _relu(mu - rho * c)
            success = (st == _CONVERGED) & (v_new <= ctol)
            # soft inner outcomes continue: only a non-finite objective is hard
            hard = st == _NONFINITE_VALUE
            rho = torch.where(v_new > viol_decrease * v, torch.clamp_max(rho * rho_growth, rho_max),
                              rho)
        x, v, inner_st = x1, v_new, st
        tot_it = tot_it + it
        tot_fev = tot_fev + fev
        k += 1
        optimize_auglag.loop_bodies += 1

    with torch.no_grad():
        fv, fg = vag_f(x)
        status = torch.where(success, _CONVERGED,
                             torch.where(hard, inner_st, torch.full_like(inner_st, _MAX_ITERATIONS)))
        return AugLagResult(
            x=x,
            fun=torch.where(success, fv, torch.full_like(fv, float("nan"))),
            grad=fg,
            status=status,
            viol=v,
            eq=h_of(x),
            ineq=c_of(x),
            lam=lam,
            mu=mu,
            rho=rho,
            n_outer=torch.full((), k, dtype=torch.int32, device=device),
            iterations=tot_it,
            n_fev=tot_fev,
            inner_status=inner_st,
            last_value=fv,
        )


def _run_fleet_tr(vag_f, pen_one, X, lam, mu, rho, active, tol, max_iterations, cdata=None):
    """The TR inner fleet: the per-lane augmented value, gradient and HVP
    close over this round's multipliers (``in_dims`` over lanes). Its
    settings are hard-coded, as in JAX (module docstring)."""
    n = X.shape[1]
    cd = (cdata,) if cdata is not None else ()
    d_ax = (0,) if cdata is not None else ()
    pen_vag = torch.func.grad_and_value(pen_one)

    def vag_min_one(x, li, mui, ri, *d_i):
        fv, fg = vag_f(x)
        pg, pv = pen_vag(x, li, mui, ri, *d_i)
        return -(fv - pv), -(fg - pg)

    def hvp_one(x, v, li, mui, ri, *d_i):
        return torch.func.jvp(lambda xx: vag_min_one(xx, li, mui, ri, *d_i)[1], (x,), (v,))[1]

    vag_b = torch.func.vmap(vag_min_one, in_dims=(0, 0, 0, 0) + d_ax)
    hvp_b = torch.func.vmap(hvp_one, in_dims=(0, 0, 0, 0, 0) + d_ax)

    def vag_fleet(Xb):
        return vag_b(Xb, lam, mu, rho, *cd)

    def hvp_fleet(Xb, V):
        return hvp_b(Xb, V, lam, mu, rho, *cd)

    s0 = _init_tr_state(vag_fleet, X, 1.0)
    crit0 = torch.amax(torch.abs(s0.g), dim=-1)
    st0 = torch.where((s0.status == _RUNNING) & (crit0 < tol), _CONVERGED, s0.status)
    s0 = s0._replace(status=torch.where(active, st0, _MAX_ITERATIONS))

    def body(c):
        return _tr_body(vag_fleet, hvp_fleet, None, tol, max_iterations, min(n, 64), 1.0, 1e6,
                        1e-4, "none", 2, None, c)

    s = _tr_loop(body, s0, max_iterations)
    return s.x, s.status, s.k, s.n_fev


def _auglag_fleet_core(obj, x0s, eq, ineq, lam0, mu0, rho0, tol, ctol, rho_growth,
                       viol_decrease, rho_max, engine, value_and_grad_fn, ls, max_outer,
                       max_iterations, history, cg_method, kernel, cdata=None) -> AugLagResult:
    """The constrained fleet (JAX `_auglag_fleet_core`), outer loop on the
    host, lane-major."""
    vag_f = as_value_and_grad(obj, value_and_grad_fn)
    f_val = as_value_fn(obj, value_and_grad_fn)
    batch, n = x0s.shape
    dtype, device = x0s.dtype, x0s.device
    has_data = cdata is not None
    cd = (cdata,) if has_data else ()
    d_ax = (0,) if has_data else ()
    pen_one = _make_penalty(eq, ineq, dtype)
    lanes = (0, 0, 0, 0) + d_ax
    pen_vag_b = torch.func.vmap(torch.func.grad_and_value(pen_one), in_dims=lanes)
    pen_b = torch.func.vmap(pen_one, in_dims=lanes)
    vag_b = torch.func.vmap(vag_f)
    f_b = torch.func.vmap(f_val)
    eq_b = torch.func.vmap(eq, in_dims=(0,) + d_ax) if eq is not None else None
    ineq_b = torch.func.vmap(ineq, in_dims=(0,) + d_ax) if ineq is not None else None
    empty = torch.zeros((batch, 0), dtype=dtype, device=device)
    update_fn = _UPDATE_FNS[kernel] if engine == "bfgs" else None

    def constraints(X):
        H = eq_b(X, *cd) if eq is not None else empty
        C = ineq_b(X, *cd) if ineq is not None else empty
        return H, C

    def violation(H, C, mu, rho):
        v = torch.zeros((batch,), dtype=dtype, device=device)
        if eq is not None:
            v = torch.maximum(v, torch.amax(torch.abs(H), dim=1))
        if ineq is not None:
            v = torch.maximum(v, torch.amax(torch.abs(torch.minimum(C, mu / rho[:, None])), dim=1))
        return v

    def frozen_status(active):
        return torch.where(active, _RUNNING, torch.full((batch,), _MAX_ITERATIONS,
                                                        dtype=torch.int32, device=device))

    X, lam, mu = x0s, lam0, mu0
    rho = rho0.expand(batch).clone()
    vprev = torch.full((batch,), float("inf"), dtype=dtype, device=device)
    zi = torch.zeros(batch, dtype=torch.int32, device=device)
    n_outer, tot_it, tot_fev = zi, zi, zi
    succ = torch.zeros(batch, dtype=torch.bool, device=device)
    hard = succ
    inner_st = torch.full_like(zi, _RUNNING)
    for k in range(max_outer if batch else 0):
        if k and not _read_any(~succ & ~hard):
            break
        active = ~succ & ~hard

        def F_b(Xv, lam=lam, mu=mu, rho=rho):
            return f_b(Xv) - pen_b(Xv, lam, mu, rho, *cd)

        def F_vag_b(Xv, lam=lam, mu=mu, rho=rho):
            fv, fg = vag_b(Xv)
            pg, pv = pen_vag_b(Xv, lam, mu, rho, *cd)
            return fv - pv, fg - pg

        with _Counted(_FLEET_COUNTERS[engine]), torch.no_grad():
            if engine == "bfgs":
                fc = _solve_loop_batched(F_vag_b, F_b, _fresh_bfgs_carry(X, frozen_status(active)),
                                         ls, tol, max_iterations, update_fn, h0_scale=True,
                                         stall_limit=STALL_LIMIT_DEFAULT)
                X1, st, it, fev = fc.X, fc.status, fc.iterations, fc.n_fev
            elif engine == "lbfgs":
                circular = n >= _RING_CIRCULAR_MIN_N
                carry0 = _fresh_lbfgs_carry(X, history, frozen_status(active), circular,
                                            incremental_gram=False)
                fc = _lbfgs_loop_batched(F_vag_b, F_b, carry0, ls, tol, max_iterations,
                                         STALL_LIMIT_DEFAULT, circular)
                X1, st, it, fev = fc.X, fc.status, fc.iterations, fc.n_fev
            elif engine == "cg":
                fc = _cg_loop_batched(F_vag_b, F_b, _fresh_cg_carry(X, frozen_status(active)),
                                      cg_method, ls, tol, max_iterations, STALL_LIMIT_DEFAULT, 0.2)
                X1, st, it, fev = fc.X, fc.status, fc.iterations, fc.n_fev
            else:  # tr
                X1, st, it, fev = _run_fleet_tr(vag_f, pen_one, X, lam, mu, rho, active, tol,
                                                max_iterations, cdata)

        with torch.no_grad():
            X1 = torch.where(active[:, None], X1, X)
            H1, C1 = constraints(X1)
            v = violation(H1, C1, mu, rho)
            lam = torch.where(active[:, None], lam + rho[:, None] * H1, lam)
            mu = torch.where(active[:, None], _relu(mu - rho[:, None] * C1), mu)
            succ_round = active & (st == _CONVERGED) & (v <= ctol)
            hard_round = active & (st == _NONFINITE_VALUE)
            rho = torch.where(active & (v > viol_decrease * vprev),
                              torch.clamp_max(rho * rho_growth, rho_max), rho)
            X, vprev = X1, torch.where(active, v, vprev)
            n_outer = n_outer + active.to(torch.int32)
            tot_it = tot_it + torch.where(active, it, 0)
            tot_fev = tot_fev + torch.where(active, fev, 0)
            succ, hard = succ | succ_round, hard | hard_round
            inner_st = torch.where(active, st, inner_st)
        optimize_auglag.loop_bodies += 1

    with torch.no_grad():
        fv, fg = vag_b(X)
        status = torch.where(succ, _CONVERGED,
                             torch.where(hard, inner_st, torch.full_like(inner_st, _MAX_ITERATIONS)))
        Hf, Cf = constraints(X)
        return AugLagResult(
            x=X,
            fun=torch.where(succ, fv, torch.full_like(fv, float("nan"))),
            grad=fg,
            status=status,
            viol=vprev,
            eq=Hf,
            ineq=Cf,
            lam=lam,
            mu=mu,
            rho=rho,
            n_outer=n_outer,
            iterations=tot_it,
            n_fev=tot_fev,
            inner_status=inner_st,
            last_value=fv,
        )


def optimize_auglag(
    obj,
    x0,
    eq: Optional[Callable] = None,
    ineq: Optional[Callable] = None,
    *,
    engine: str = "bfgs",
    tol: float = 1e-8,
    ctol: float = 1e-8,
    rho0: float = 10.0,
    rho_growth: float = 10.0,
    rho_max: float = 1e8,
    viol_decrease: float = 0.25,
    max_outer: int = 20,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    lam0=None,
    mu0=None,
    ls=None,
    history: int = 10,
    cg_method: str = "hz",
    value_and_grad_fn: Optional[Callable] = None,
    kernel: str = "auto",
    constraint_data=None,
) -> AugLagResult:
    """Maximize f(x) subject to eq(x) = 0 and ineq(x) >= 0.

    ``max_outer`` rounds of [maximize the augmented objective with
    ``engine`` → first-order multiplier update → grow ρ if the violation
    stalled]. ``eq``/``ineq``: callables x ↦ (m,) that ``torch.func`` can
    differentiate (scalars are promoted); at least one is required.
    ``engine``: 'bfgs' (default), 'lbfgs', 'cg' or 'tr' (``history`` rides
    'lbfgs', ``cg_method`` rides 'cg'; ``ls`` defaults to
    ``Wolfe(approx=True)`` for every line-search engine). ``lam0``/``mu0``
    warm-start the multipliers (default zeros); continue a truncated run
    with ``optimize_auglag(obj, r.x, ..., lam0=r.lam, mu0=r.mu,
    rho0=float(r.rho))``.

    Success is the KKT certificate: the last inner solve CONVERGED (max|∇ₓL|
    < ``tol``) and the violation <= ``ctol``; then ``fun`` = f(x).
    Otherwise ``fun`` is NaN: a NONFINITE_VALUE inner solve reports that
    status, an exhausted outer budget MAX_ITERATIONS.

    ``constraint_data``: the constraints are called ``fn(x, data)``; for a
    fleet its leaves carry the leading batch axis and each lane sees its
    own slice; for a single solve it passes whole. A rank-2 (batch, n)
    ``x0`` runs the constrained fleet; ``lam0``/``mu0`` then take (m,)
    (broadcast) or (batch, m), and ``kernel`` picks the BFGS inner fleet's
    update as in `optimize_batched_fused` ('auto' = B1 on CUDA tensors).
    A tensor's device is where the solve runs; anything else goes to the
    CUDA card (`as_device_tensor`). Host reads are counted in
    ``optimize_auglag.host_syncs`` (module docstring).
    """
    x0 = as_device_tensor(x0, "x0")
    if x0.ndim not in (1, 2):
        raise ValueError(
            f"x0 must be rank 1 (single solve) or rank 2 (batch, n) "
            f"(constrained fleet); got shape {tuple(x0.shape)}"
        )
    if eq is None and ineq is None:
        raise ValueError(
            "at least one of eq=/ineq= is required — unconstrained "
            "problems: use optimize/optimize_lbfgs/optimize_cg/optimize_tr"
        )
    if engine not in _ENGINES:
        raise ValueError(f"engine must be one of {_ENGINES}, got {engine!r}")
    for name, fn in (("eq", eq), ("ineq", ineq)):
        if fn is not None and not callable(fn):
            raise TypeError(f"{name} must be callable, got {type(fn)!r}")
    if max_outer < 1:
        raise ValueError("max_outer must be >= 1")
    if not (rho0 > 0 and rho_growth >= 1 and rho_max >= rho0):
        raise ValueError("need rho0 > 0, rho_growth >= 1, rho_max >= rho0")
    dtype, device = x0.dtype, x0.device
    eqw = _flat1d(eq) if eq is not None else None
    inw = _flat1d(ineq) if ineq is not None else None
    batched = x0.ndim == 2
    x_probe = x0[0] if batched else x0
    d_probe = ()
    if constraint_data is not None:
        constraint_data = pytree.tree_map(lambda leaf: as_device_tensor(leaf, "constraint_data"),
                                          constraint_data)
        if batched:
            leaves = pytree.tree_leaves(constraint_data)
            if not leaves or any(leaf.ndim < 1 or leaf.shape[0] != x0.shape[0] for leaf in leaves):
                raise ValueError(
                    "constraint_data leaves must carry the fleet's "
                    f"leading batch axis ({x0.shape[0]})"
                )
            d_probe = (pytree.tree_map(lambda leaf: leaf[0], constraint_data),)
        else:
            d_probe = (constraint_data,)

    def _mult_init(given, fn, label):
        """Validated multipliers: (m,) for the single solve; (batch, m) for
        the fleet (an (m,) warm start broadcasts across lanes)."""
        if fn is None:
            if given is not None:
                raise ValueError(f"{label}0 given without {label}=")
            return torch.zeros((x0.shape[0], 0) if batched else (0,), dtype=dtype, device=device)
        with torch.no_grad():
            shape = tuple(fn(x_probe, *d_probe).shape)  # JAX: jax.eval_shape
        if len(shape) != 1:
            raise ValueError(f"{label}(x0) must be rank-0/1, got shape {shape}")
        full = (x0.shape[0],) + shape if batched else shape
        if given is None:
            return torch.zeros(full, dtype=dtype, device=device)
        given = torch.as_tensor(given, dtype=dtype, device=device)
        if batched and tuple(given.shape) == shape:
            given = given.broadcast_to(full)
        if tuple(given.shape) != full:
            raise ValueError(
                f"{label}0 shape {tuple(given.shape)} != expected {full} "
                f"(constraint shape {shape})"
            )
        return given

    lam = _mult_init(lam0, eqw, "lam")
    mu = _mult_init(mu0, inw, "mu")
    if mu0 is not None and _read_any(mu < 0):  # the user's values, broadcast
        raise ValueError("mu0 must be elementwise >= 0")
    if ls is None:
        # the augmented objective has |F*| > 0 once a constraint is active
        # and grows ill-conditioned with rho: the approximate-Wolfe slope
        # test certifies where the Armijo value test meets the fp floor
        ls = Wolfe(approx=True)
    rho0_t = torch.full((), float(rho0), dtype=dtype, device=device)
    args = (float(tol), float(ctol), float(rho_growth), float(viol_decrease), float(rho_max),
            engine, value_and_grad_fn, ls, int(max_outer), int(max_iterations), history,
            cg_method)
    if batched:
        if engine == "bfgs":
            kernel = _auto_kernel(kernel, device, x0.shape[1], dtype)
        return _auglag_fleet_core(obj, x0, eqw, inw, lam, mu, rho0_t, *args, kernel,
                                  cdata=constraint_data)
    return _auglag_core(obj, x0, eqw, inw, lam, mu, rho0_t, *args, cdata=constraint_data)


# Host reads of the device (every read of an auglag solve, its inner
# engines' included), outer rounds and inner loop bodies, summed over
# calls; set them to 0 before a solve to count that solve alone.
optimize_auglag.host_syncs = 0
optimize_auglag.loop_bodies = 0
optimize_auglag.inner_bodies = 0
