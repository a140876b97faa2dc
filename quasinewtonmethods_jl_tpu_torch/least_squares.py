"""Levenberg–Marquardt nonlinear least squares, batched — the PyTorch port
of ``quasinewtonmethods_jl_tpu/least_squares.py`` (`least_squares`,
`least_squares_from_state`).

The sibling of the secant engines for objectives of the form
F(x) = ½‖r(x)‖² (or a robust ½C²Σρ(rᵢ²/C²)): the Gauss–Newton matrix JᵀJ
stands in for the Hessian, and each iteration is Jacobian → damped normal
equations (batched Cholesky) → one trial evaluation → accept or damp by the
Madsen–Nielsen gain ratio. No line search. Semantics are lane for lane the
JAX engine's: the same damping control, robust losses (scipy's
``loss=``/``f_scale=`` convention), projected active-set steps under
``bounds=``, KKT certificate and in-band statuses (damping exhaustion,
lam > lam_max, is LINESEARCH_FAILURE; non-finite residuals at x0 are
NONFINITE_VALUE; ``fun`` is NaN unless converged).

Layout is lane-major, as the JAX engine's: x (batch, n), J (batch, m, n),
JTJ (batch, n, n). The Jacobians come from ``torch.func.jacfwd`` (n <= m)
or ``jacrev`` under ``torch.func.vmap``, with ``in_dims`` over the per-lane
``data`` pytree; JᵀJ and Jᵀr are batched products in full float32 (TF32
off for the whole solve, `api._pin_matmul_precision`, as JAX pins its
precision to HIGHEST).

A non-SPD damped system. JAX's Cholesky returns NaN there, the trial then
evaluates non-finite, the gain ratio rejects it and the damping grows: the
fault heals in band. ``torch.linalg.cholesky`` raises instead, so the port
calls ``cholesky_ex`` and sets L to NaN on the lanes whose ``info`` is not
0, which needs no host read. Like ``jnp.linalg.cholesky``, the system is
symmetrised first ((A + Aᵀ)/2).

The loop. JAX runs ``lax.while_loop``; here a Python loop on the host
enqueues the bodies and reads ``any(lane RUNNING)`` every
`TERMINATION_CHECK_INTERVAL` bodies, starting before the first (bodies
after the last lane finished are exact no-ops under the ``active`` masks;
a running lane ends within ``max_iterations`` bodies). Every read is
counted in ``least_squares.host_syncs`` and every body in
``least_squares.loop_bodies``. LM has no TPU kernel in the JAX package: its
batched Cholesky and products are XLA operations, ported as torch ops.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from .api import _pin_matmul_precision
from .batched_solve import TERMINATION_CHECK_INTERVAL
from .state import LMState, Status
from .utils.device import as_device_state, as_device_tensor
from .utils.placement import coord_amax

__all__ = [
    "LMState",
    "LeastSquaresResult",
    "least_squares",
    "least_squares_from_state",
    "LM_MAX_ITERATIONS_DEFAULT",
    "LM_LOSSES",
]

# LM converges quadratically near the solution and each iteration carries a
# full Jacobian: a far smaller cap than the reference's 10_000 iterations.
LM_MAX_ITERATIONS_DEFAULT = 200

LM_LOSSES = ("linear", "huber", "soft_l1", "cauchy", "arctan")

_RUNNING = int(Status.RUNNING)
_CONVERGED = int(Status.CONVERGED)
_MAX_ITERATIONS = int(Status.MAX_ITERATIONS)
_LINESEARCH_FAILURE = int(Status.LINESEARCH_FAILURE)
_NONFINITE_VALUE = int(Status.NONFINITE_VALUE)


class LeastSquaresResult(NamedTuple):
    """Least-squares result: ``fun`` is the minimized ½‖r‖² on convergence
    and NaN on any failure; ``last_value`` is the final value regardless
    of status; ``JTJ`` the Gauss–Newton curvature at x."""

    x: torch.Tensor
    fun: torch.Tensor
    grad: torch.Tensor  # Jᵀr at x (the gradient of ½‖r‖²)
    JTJ: torch.Tensor
    status: torch.Tensor
    iterations: torch.Tensor
    n_fev: torch.Tensor
    n_jev: torch.Tensor
    lam: torch.Tensor  # final damping (diagnostic)
    last_value: torch.Tensor
    state: LMState  # resumable via least_squares_from_state

    @property
    def converged(self) -> torch.Tensor:
        return self.status == Status.CONVERGED


def _resolve_jac_mode(jac_mode: str, n: int, m: int) -> str:
    if jac_mode == "auto":
        # jacfwd costs n JVP passes, jacrev m VJP passes: the smaller axis
        return "fwd" if n <= m else "rev"
    if jac_mode not in ("fwd", "rev"):
        raise ValueError(f"jac_mode must be 'auto'|'fwd'|'rev', got {jac_mode!r}")
    return jac_mode


def _make_jac_fleet(residual_fn: Callable, has_data: bool, jac_mode: str):
    """``jac_fleet(X, data) -> (B, m), (B, m, n)``: each lane's residual
    and Jacobian in one pass (the residual is the Jacobian transform's
    auxiliary output). ``data`` is a pytree whose leaves carry the batch
    axis (None when ``has_data`` is False)."""
    res1 = _pin_matmul_precision(residual_fn if has_data else (lambda x, _d: residual_fn(x)))

    def with_aux(x, d):
        r = res1(x, d)
        return r, r

    jac = torch.func.jacfwd if jac_mode == "fwd" else torch.func.jacrev
    jac1 = jac(with_aux, argnums=0, has_aux=True)

    def resjac1(x, d):
        J, r = jac1(x, d)
        return r, J

    return torch.func.vmap(resjac1, in_dims=(0, 0 if has_data else None))


def _grad_and_gn(r, J):
    """g = Jᵀr and JTJ = JᵀJ, batched (TF32 is off for the solve)."""
    g = torch.einsum("bmn,bm->bn", J, r)
    JTJ = torch.einsum("bmn,bmk->bnk", J, J)
    return g, JTJ


def _rho_derivs(z, loss: str):
    """ρ(z), ρ'(z), ρ''(z) elementwise, closed forms finite on z >= 0."""
    if loss == "huber":
        big = z > 1.0
        zc = torch.clamp_min(z, 1.0)
        sq = torch.sqrt(zc)  # guarded: used only where big
        rho = torch.where(big, 2.0 * sq - 1.0, z)
        d1 = torch.where(big, 1.0 / sq, torch.ones_like(z))
        d2 = torch.where(big, -0.5 / (sq * zc), torch.zeros_like(z))
        return rho, d1, d2
    if loss == "soft_l1":
        t = 1.0 + z
        sq = torch.sqrt(t)
        return 2.0 * (sq - 1.0), 1.0 / sq, -0.5 / (t * sq)
    if loss == "cauchy":
        t = 1.0 + z
        return torch.log1p(z), 1.0 / t, -1.0 / (t * t)
    if loss == "arctan":
        t = 1.0 + z * z
        return torch.arctan(z), 1.0 / t, -2.0 * z / (t * t)
    raise ValueError(f"loss must be one of {LM_LOSSES}, got {loss!r}")


def _make_fun_grad_gn(loss: str, f_scale: float):
    """(r, J) -> (fun, g, JTJ) under the robust loss: g is the exact
    gradient of F; JTJ takes the Triggs-corrected Gauss–Newton weights
    ρ' + 2ρ''z floored at eps (cauchy/arctan go locally concave in large
    residuals; the floor keeps the damped system SPD)."""
    if loss == "linear":

        def fun_grad_gn(r, J):
            fun = 0.5 * torch.sum(r * r, dim=-1)
            g, JTJ = _grad_and_gn(r, J)
            return fun, g, JTJ

        return fun_grad_gn

    def fun_grad_gn(r, J):
        C2 = f_scale * f_scale
        z = (r * r) / C2
        rho, d1, d2 = _rho_derivs(z, loss)
        fun = 0.5 * C2 * torch.sum(rho, dim=-1)
        g = torch.einsum("bmn,bm->bn", J, d1 * r)
        w = torch.clamp_min(d1 + 2.0 * d2 * z, torch.finfo(r.dtype).eps)
        JTJ = torch.einsum("bmn,bm,bmk->bnk", J, w, J)
        return fun, g, JTJ

    return fun_grad_gn


def _kkt_criticality(x, g, bounds):
    """Per-lane optimality measure: max|g| unbounded; bounded, the
    projected-gradient residual max|x − clip(x − g, lo, hi)|, zero exactly
    at KKT points of the box."""
    if bounds is None:
        return coord_amax(torch.abs(g))
    lo, hi = bounds
    return coord_amax(torch.abs(x - torch.clamp(x - g, lo, hi)))


def _damped_step(JTJ, g, lam, diag_floor: float, free=None):
    """Solve (JTJ + lam·D) δ = −g per lane by batched Cholesky, D =
    diag(JTJ) floored at ``diag_floor`` (Marquardt scaling). ``free``
    (bounded path) restricts the solve to the free subspace: blocked
    coordinates' rows, columns and right-hand side are zeroed and their
    diagonal keeps (1 + lam)·D, so their step is exactly zero. A lane whose
    Cholesky fails gets a NaN factor (module docstring)."""
    d = torch.clamp_min(torch.diagonal(JTJ, dim1=-2, dim2=-1), diag_floor)
    n = d.shape[-1]
    diag_add = lam[:, None] * d
    if free is not None:
        fm = free.to(JTJ.dtype)
        JTJ = JTJ * fm[:, :, None] * fm[:, None, :]
        diag_add = diag_add + (1.0 - fm) * d
        g = g * fm
    # eye[i, j] * v[..., i] embeds v on the diagonal, as in JAX
    A = JTJ + torch.eye(n, dtype=JTJ.dtype, device=JTJ.device) * diag_add[..., None]
    A = (A + A.mT) / 2  # jnp.linalg.cholesky symmetrises its input
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info != 0)[:, None, None], torch.full_like(L, float("nan")), L)
    w = torch.linalg.solve_triangular(L, -g[..., None], upper=False)
    delta = torch.linalg.solve_triangular(L.mT, w, upper=True)
    return delta[..., 0], d


def _lm_body(jac_fleet, fun_grad_gn, data, bounds, tol, max_iterations, lam_max,
             diag_floor, s: LMState) -> LMState:
    """One lockstep LM iteration over the fleet (JAX `_lm_body`)."""
    dtype = s.x.dtype
    active = s.status == _RUNNING

    if bounds is None:
        delta, dvec = _damped_step(s.JTJ, s.g, s.lam, diag_floor)
        x_t = s.x + delta
    else:
        lo, hi = bounds
        # blocked = at a face with the gradient pushing outward (clipping
        # lands iterates exactly on the face, so == comparisons fire)
        blocked = ((s.x <= lo) & (s.g > 0)) | ((s.x >= hi) & (s.g < 0))
        delta, dvec = _damped_step(s.JTJ, s.g, s.lam, diag_floor, free=~blocked)
        x_t = torch.clamp(s.x + delta, lo, hi)
        delta = x_t - s.x  # the step actually taken
    # one Jacobian evaluation per iteration, at the trial point
    r_t, J_t = jac_fleet(x_t, data)
    f_t, g_t, JTJ_t = fun_grad_gn(r_t, J_t)

    if bounds is None:
        # predicted reduction of the damped model: ½ δᵀ(lam·D·δ − g)
        pred = 0.5 * torch.sum(delta * (s.lam[:, None] * dvec * delta - s.g), dim=-1)
    else:
        # the model's decrease along the step actually taken
        JTJd = torch.einsum("bij,bj->bi", s.JTJ, delta)
        pred = -torch.sum(delta * (s.g + 0.5 * JTJd), dim=-1)
    rho = (s.fun - f_t) / torch.clamp_min(pred, torch.finfo(dtype).tiny)

    trial_ok = torch.isfinite(f_t) & torch.isfinite(g_t).all(dim=-1)
    accept = active & trial_ok & (rho > 0.0) & (pred > 0.0)

    t = 2 * rho - 1
    shrink = torch.clamp_min(1.0 - t * t * t, 1.0 / 3)
    lam_new = torch.where(accept, s.lam * shrink, s.lam * s.nu)
    nu_new = torch.where(accept, torch.full_like(s.nu, 2.0), s.nu * 2.0)

    x_new = torch.where(accept[:, None], x_t, s.x)
    fun_new = torch.where(accept, f_t, s.fun)
    g_new = torch.where(accept[:, None], g_t, s.g)
    JTJ_new = torch.where(accept[:, None, None], JTJ_t, s.JTJ)
    stall_new = torch.where(accept, torch.zeros_like(s.stall), s.stall + 1)

    k_new = torch.where(active, s.k + 1, s.k)
    # priority, highest last: cap < damping exhaustion < converged
    code = torch.where(k_new >= max_iterations, _MAX_ITERATIONS, torch.full_like(s.status, _RUNNING))
    code = torch.where(lam_new > lam_max, _LINESEARCH_FAILURE, code)
    code = torch.where(_kkt_criticality(x_new, g_new, bounds) < tol, _CONVERGED, code)
    one = active.to(torch.int32)
    return LMState(
        x=x_new,
        fun=fun_new,
        g=g_new,
        JTJ=JTJ_new,
        lam=torch.where(active, lam_new, s.lam),
        nu=torch.where(active, nu_new, s.nu),
        k=k_new,
        status=torch.where(active, code, s.status),
        n_fev=s.n_fev + one,
        n_jev=s.n_jev + one,
        stall=torch.where(active, stall_new, s.stall),
    )


def _init_lm_state(jac_fleet, fun_grad_gn, data, bounds, X0, tol, damping_init) -> LMState:
    """The peeled first evaluation: (f, g, JTJ) at x0, lam0 = damping_init ·
    max(diag(JTJ)) (the Madsen–Nielsen τ rule), and the immediate
    classification of converged and non-finite lanes."""
    dtype, device = X0.dtype, X0.device
    B = X0.shape[0]
    if bounds is not None:
        X0 = torch.clamp(X0, bounds[0], bounds[1])
    r0, J0 = jac_fleet(X0, data)
    f0, g0, JTJ0 = fun_grad_gn(r0, J0)
    d0 = torch.diagonal(JTJ0, dim1=-2, dim2=-1)
    lam0 = damping_init * torch.clamp_min(torch.amax(d0, dim=-1), torch.finfo(dtype).eps)

    finite0 = torch.isfinite(f0) & torch.isfinite(g0).all(dim=-1)
    conv0 = finite0 & (_kkt_criticality(X0, g0, bounds) < tol)
    zi = torch.zeros(B, dtype=torch.int32, device=device)
    status0 = torch.where(finite0, _RUNNING, torch.full_like(zi, _NONFINITE_VALUE))
    status0 = torch.where(conv0, _CONVERGED, status0)
    return LMState(
        x=X0,
        fun=f0,
        g=g0,
        JTJ=JTJ0,
        lam=lam0,
        nu=torch.full((B,), 2.0, dtype=dtype, device=device),
        k=zi,
        status=status0,
        n_fev=torch.ones_like(zi),
        n_jev=torch.ones_like(zi),
        stall=torch.zeros_like(zi),
    )


def _result_from_state(s: LMState, squeeze: bool) -> LeastSquaresResult:
    res = LeastSquaresResult(
        x=s.x,
        fun=torch.where(s.status == _CONVERGED, s.fun, torch.full_like(s.fun, float("nan"))),
        grad=s.g,
        JTJ=s.JTJ,
        status=s.status,
        iterations=s.k,
        n_fev=s.n_fev,
        n_jev=s.n_jev,
        lam=s.lam,
        last_value=s.fun,
        state=s,
    )
    if squeeze:
        res = LeastSquaresResult(*(leaf[0] for leaf in res[:-1]),
                                 state=LMState(*(leaf[0] for leaf in s)))
    return res


def _lm_loop(body, s: LMState, max_iterations: int) -> LMState:
    """The host loop (module docstring)."""
    for i in range(max_iterations):
        if i % TERMINATION_CHECK_INTERVAL == 0:
            least_squares.host_syncs += 1
            if not bool((s.status == _RUNNING).any()):
                break
        s = body(s)
        least_squares.loop_bodies += 1
    return s


def _lane_data(data, B: int, squeeze: bool):
    """``data`` with every leaf a tensor (`as_device_tensor`) carrying the
    fleet's batch axis (added for a rank-1 solve)."""
    if data is None:
        return None
    data = pytree.tree_map(lambda leaf: as_device_tensor(leaf, "data"), data)
    if squeeze:
        data = pytree.tree_map(lambda leaf: leaf[None], data)
    for leaf in pytree.tree_leaves(data):
        if leaf.ndim < 1 or leaf.shape[0] != B:
            raise ValueError(
                "every data leaf must carry the fleet batch axis "
                f"(expected leading {B}, got shape {tuple(leaf.shape)})"
            )
    return data


def _residual_size(residual_fn, x_lane, data) -> int:
    """m, from one evaluation of the residual on lane 0 (JAX takes it from
    ``jax.eval_shape``)."""
    with torch.no_grad():
        if data is None:
            r = residual_fn(x_lane)
        else:
            r = residual_fn(x_lane, pytree.tree_map(lambda leaf: leaf[0], data))
    if r.ndim != 1:
        raise ValueError(f"residual_fn must return a rank-1 array, got shape {tuple(r.shape)}")
    return r.shape[0]


def _check_bounds(bounds, X0: torch.Tensor, engine):
    """``bounds=(lo, hi)`` broadcast to X0's (B, n) shape, dtype and device
    (entries may be ±inf; per-lane bounds carry the batch axis). The check
    lo < hi reads the device once, counted in ``engine.host_syncs``."""
    if bounds is None:
        return None
    try:
        lo, hi = bounds
    except (TypeError, ValueError):
        raise ValueError(f"bounds must be a (lower, upper) pair, got {bounds!r}") from None

    def side(v):
        if isinstance(v, (int, float)):
            return torch.full(X0.shape, float(v), dtype=X0.dtype, device=X0.device)
        return torch.as_tensor(v, dtype=X0.dtype, device=X0.device).broadcast_to(X0.shape)

    lo, hi = side(lo), side(hi)
    engine.host_syncs += 1
    if not bool((lo < hi).all()):
        raise ValueError("bounds require lower < upper in every coordinate")
    return lo, hi


def _check_loss(loss, f_scale):
    if loss not in LM_LOSSES:
        raise ValueError(f"loss must be one of {LM_LOSSES}, got {loss!r}")
    if not float(f_scale) > 0.0:
        raise ValueError(f"f_scale must be > 0, got {f_scale}")


@_pin_matmul_precision
def _run(residual_fn, state_or_x0, data, bounds, *, tol, max_iterations, damping_init, lam_max,
         jac_mode, loss, f_scale, squeeze) -> LeastSquaresResult:
    """Fresh (``state_or_x0`` a (B, n) tensor) or resumed (an `LMState`)
    solve; TF32 off throughout (`_pin_matmul_precision`)."""
    resume = isinstance(state_or_x0, LMState)
    X = state_or_x0.x if resume else state_or_x0
    m = _residual_size(residual_fn, X[0], data)
    jac_fleet = _make_jac_fleet(residual_fn, data is not None,
                                _resolve_jac_mode(jac_mode, X.shape[-1], m))
    fun_grad_gn = _make_fun_grad_gn(loss, float(f_scale))
    tol_t = torch.full((), float(tol), dtype=X.dtype, device=X.device)
    eps = torch.finfo(X.dtype).eps
    with torch.no_grad():
        if resume:
            # lanes parked at MAX_ITERATIONS resume under the new budget (k
            # keeps counting from where it stopped)
            s = state_or_x0
            rearm = (s.status == _MAX_ITERATIONS) & (s.k < max_iterations)
            s = s._replace(status=torch.where(rearm, _RUNNING, s.status))
        else:
            s = _init_lm_state(jac_fleet, fun_grad_gn, data, bounds, X, tol_t, float(damping_init))

        def body(c):
            return _lm_body(jac_fleet, fun_grad_gn, data, bounds, tol_t, max_iterations,
                            float(lam_max), eps, c)

        s = _lm_loop(body, s, max_iterations)
    return _result_from_state(s, squeeze)


def least_squares(
    residual_fn: Callable,
    x0,
    *,
    data: Optional[Any] = None,
    bounds: Optional[Any] = None,
    tol: float = 1e-8,
    max_iterations: int = LM_MAX_ITERATIONS_DEFAULT,
    damping_init: float = 1e-3,
    lam_max: float = 1e32,
    jac_mode: str = "auto",
    loss: str = "linear",
    f_scale: float = 1.0,
) -> LeastSquaresResult:
    """Minimize ½‖r(x)‖² by Levenberg–Marquardt, batched.

    ``residual_fn(x) -> (m,)`` (or ``residual_fn(x, data_lane)`` when
    ``data`` is given) must be a pure function of torch tensors that
    ``torch.func`` can differentiate; ``jac_mode='auto'`` takes forward
    mode when n <= m. A rank-1 ``x0`` runs one solve; a rank-2 (batch, n)
    ``x0`` runs the masked-lockstep fleet, with ``data`` a pytree whose
    leaves carry the batch axis (per-lane datasets). A tensor's device is
    where the solve runs; anything else (numpy, lists, and numpy data
    leaves) goes to the CUDA card (`as_device_tensor`).

    Certificate: max|Jᵀr| < ``tol`` (bounded: the KKT projected-gradient
    residual). In-band failure: ``fun`` NaN unless converged; damping
    exhaustion (lam > ``lam_max``) is LINESEARCH_FAILURE; non-finite
    residuals at x0 are NONFINITE_VALUE. ``loss`` in ``('linear', 'huber',
    'soft_l1', 'cauchy', 'arctan')`` with ``f_scale`` minimizes
    ½·f_scale²·Σρ(rᵢ²/f_scale²) (scipy's convention). ``bounds=(lo, hi)``
    (broadcastable to x0's shape, ±inf allowed) runs projected LM with an
    elementwise active set; x0 is clipped into the box. Host reads are
    counted in ``least_squares.host_syncs``.
    """
    X0 = as_device_tensor(x0, "x0")
    if X0.ndim not in (1, 2):
        raise ValueError(f"x0 must be rank 1 or 2, got shape {tuple(X0.shape)}")
    squeeze = X0.ndim == 1
    if squeeze:
        X0 = X0[None]
    data = _lane_data(data, X0.shape[0], squeeze)
    if max_iterations < 1:
        raise ValueError(f"max_iterations must be >= 1, got {max_iterations}")
    _check_loss(loss, f_scale)
    return _run(residual_fn, X0, data, _check_bounds(bounds, X0, least_squares), tol=tol,
                max_iterations=int(max_iterations), damping_init=damping_init, lam_max=lam_max,
                jac_mode=jac_mode, loss=loss, f_scale=f_scale, squeeze=squeeze)


def least_squares_from_state(
    residual_fn: Callable,
    state: LMState,
    *,
    data: Optional[Any] = None,
    bounds: Optional[Any] = None,
    tol: float = 1e-8,
    max_iterations: int = LM_MAX_ITERATIONS_DEFAULT,
    lam_max: float = 1e32,
    jac_mode: str = "auto",
    loss: str = "linear",
    f_scale: float = 1.0,
) -> LeastSquaresResult:
    """Resume a least-squares solve from a saved `LMState` (chunked runs
    reproduce one long run: the carried (g, JTJ, lam, nu) are the whole
    algorithm memory). Lanes stopped at MAX_ITERATIONS continue under the
    new lifetime budget; converged and failed lanes stay frozen. ``loss``,
    ``f_scale`` and ``bounds`` must match the original run. Tensor leaves
    keep their device; numpy leaves (`lm_state_to_numpy`, or a JAX state's
    leaves) go to the CUDA card, as ``x0`` does."""
    state = as_device_state(state)
    squeeze = state.x.ndim == 1
    if squeeze:
        state = LMState(*(leaf[None] for leaf in state))
    data = _lane_data(data, state.x.shape[0], squeeze)
    _check_loss(loss, f_scale)
    return _run(residual_fn, state, data, _check_bounds(bounds, state.x, least_squares), tol=tol,
                max_iterations=int(max_iterations), damping_init=None, lam_max=lam_max,
                jac_mode=jac_mode, loss=loss, f_scale=f_scale, squeeze=squeeze)


# Host reads of the device (control flow and the bounds check) and loop
# bodies, summed over calls of both entry points; set them to 0 before a
# solve to count that solve alone.
least_squares.host_syncs = 0
least_squares.loop_bodies = 0
