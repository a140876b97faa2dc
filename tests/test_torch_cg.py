"""The port's nonlinear-CG fleet (cg_solve.py), its Hutchinson estimator
(ops/hutchinson.py) and preconditioner resolution (trust_region.py) against
the JAX package's, on the same numpy inputs in f64, mirroring
tests/test_cg.py.

Where the trajectory is stable (diagonal concave quadratics, solved in a
few iterations) or short (Rosenbrock up to 15 iterations), statuses and
every counter must be equal, x to 1e-10 (1e-9 on Rosenbrock: the packages
sum in different orders). Over long trajectories (a dense quadratic of
condition 100 takes ~150 iterations, Rosenbrock ~200) CG's rounding drift
moves iteration counts by a few, as tests/test_cg.py notes for the JAX
fleet against its own solo runs, so there the two must reach the same
statuses and certificate. The port
draws its own Hutchinson probes (jax.random cannot be reproduced): Jacobi
CG is compared on a diagonal quadratic, where the estimate is exact for any
probe, and the estimator itself is fed JAX's probes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu import cg_solve as jax_cg
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.ops import hutchinson as jax_hutchinson
from quasinewtonmethods_jl_tpu.ops.linesearch import BackTracking as JaxBackTracking
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.models import (
    Rosenbrock,
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)
from quasinewtonmethods_jl_tpu_torch.ops import hutchinson
from quasinewtonmethods_jl_tpu_torch.trust_region import _resolve_precondition

torch.set_num_threads(1)

COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")


def _quadratic(n, cond, seed):
    """Concave quadratic with a dense Hessian of condition ``cond`` (the
    tests/test_cg.py fixture), in both packages."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.geomspace(1.0, cond, n)) @ Q.T
    b = rng.standard_normal(n)
    At, bt, Aj, bj = torch.tensor(A), torch.tensor(b), jnp.asarray(A), jnp.asarray(b)

    def port(x):
        return -0.5 * x @ (At @ x) + bt @ x

    def ref(x):
        return -0.5 * x @ (Aj @ x) + bj @ x

    return port, ref, np.linalg.solve(A, b)


def _quad_fixture(n):
    """The fleet tests' concave quadratic, diag(1..n)."""

    def port(x):
        return -0.5 * torch.sum(torch.arange(1.0, n + 1.0, dtype=x.dtype) * x * x)

    def ref(x):
        return -0.5 * jnp.sum(jnp.arange(1.0, n + 1.0, dtype=x.dtype) * x * x)

    return port, ref


def _diagonal(n, top):
    d = np.logspace(0, top, n)
    dt, dj = torch.tensor(d), jnp.asarray(d)
    return (lambda x: -0.5 * torch.sum(dt * x * x)), (lambda x: -0.5 * jnp.sum(dj * x * x)), d


def _solve_both(port_obj, jax_obj, x0, port_kw=None, jax_kw=None, **kw):
    port = qt.optimize_cg(port_obj, torch.tensor(x0), **(port_kw or {}), **kw)
    ref = jax_cg.optimize_cg(jax_obj, jnp.asarray(x0), **(jax_kw or {}), **kw)
    return port, ref


def assert_same(port, ref, atol):
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=atol, rtol=0)


def test_result_and_state_layout_match_jax():
    assert qt.CGState._fields == jax_cg.CGState._fields
    assert qt.CGResult._fields == jax_cg.CGResult._fields


@pytest.mark.parametrize("method", ["hz", "pr", "fr", "dy"])
def test_every_beta_on_a_quadratic_fleet_matches_jax(method):
    port_f, jax_f = _quad_fixture(8)
    X0 = np.random.default_rng(50).standard_normal((16, 8))
    port, ref = _solve_both(port_f, jax_f, X0, method=method)
    assert_same(port, ref, 1e-10)
    assert port.converged.all()
    np.testing.assert_allclose(port.x.numpy(), 0.0, atol=1e-8)
    np.testing.assert_array_equal(port.state.m_prev.numpy() == 0, np.asarray(ref.state.m_prev) == 0)


@pytest.mark.parametrize("method", ["hz", "fr"])
def test_dense_quadratic_matches_jax_certificate(method):
    port_f, jax_f, x_star = _quadratic(12, 100.0, 0)
    X0 = np.random.default_rng(50).standard_normal((6, 12))
    port, ref = _solve_both(port_f, jax_f, X0, method=method)
    np.testing.assert_array_equal(port.status.numpy(), np.asarray(ref.status))
    assert port.converged.all()
    np.testing.assert_allclose(port.x.numpy(), np.broadcast_to(x_star, X0.shape), atol=1e-6)


@pytest.mark.parametrize("method", ["hz", "pr"])
def test_backtracking_cg_on_a_quadratic_matches_jax(method):
    port_f, jax_f, _ = _quadratic(12, 10.0, 6)
    X0 = np.random.default_rng(56).standard_normal((4, 12))
    port, ref = _solve_both(port_f, jax_f, X0, port_kw=dict(ls=qt.BackTracking()),
                            jax_kw=dict(ls=JaxBackTracking()), method=method, tol=1e-5)
    assert_same(port, ref, 1e-10)
    assert port.converged.all()


@pytest.mark.parametrize("max_iterations", [1, 2, 9, 15])
def test_rosenbrock_short_horizon_matches_jax_exactly(rng, max_iterations):
    """9 = 1 + TERMINATION_CHECK_INTERVAL: the cap stays exact across the
    host's first termination test."""
    X0 = rng.standard_normal((32, 10))
    port, ref = _solve_both(rosenbrock_logdensity, jax_rosenbrock, X0,
                            max_iterations=max_iterations)
    assert_same(port, ref, 1e-9)
    for field in ("d", "m_prev", "t_prev", "grad", "grad_old"):
        np.testing.assert_allclose(getattr(port.state, field).numpy(),
                                   np.asarray(getattr(ref.state, field)), rtol=1e-8, atol=1e-8,
                                   err_msg=field)
    assert (port.iterations == max_iterations).all()


def test_rosenbrock_to_convergence_matches_jax_certificate(rng):
    X0 = rng.standard_normal((16, 10))
    port, ref = _solve_both(rosenbrock_logdensity, jax_rosenbrock, X0)
    np.testing.assert_array_equal(port.status.numpy(), np.asarray(ref.status))
    assert port.converged.all()
    assert float(port.grad.abs().max()) < 1e-8
    np.testing.assert_allclose(port.x.numpy(), 1.0, atol=1e-6)


def test_fold_eval_matches_jax_and_saves_evaluations():
    port_f, jax_f = _quad_fixture(10)
    X0 = np.random.default_rng(61).standard_normal((4, 10))
    on, ref_on = _solve_both(port_f, jax_f, X0, fold_eval=True)
    off, ref_off = _solve_both(port_f, jax_f, X0)
    assert_same(on, ref_on, 1e-10)
    assert_same(off, ref_off, 1e-10)
    assert on.converged.all() and off.converged.all()
    np.testing.assert_allclose(on.x.numpy(), off.x.numpy(), rtol=0, atol=1e-6)
    assert (on.n_fev < off.n_fev).all()
    # fold ignores BackTracking (its trials have no gradient)
    bt = qt.optimize_cg(port_f, torch.tensor(X0), ls=qt.BackTracking(), fold_eval=True, tol=1e-5)
    bt_off = qt.optimize_cg(port_f, torch.tensor(X0), ls=qt.BackTracking(), tol=1e-5)
    for name in COUNTERS:
        assert torch.equal(getattr(bt, name), getattr(bt_off, name)), name


def test_rank1_solve_and_resume_match_jax():
    port_f, jax_f = _quad_fixture(6)
    x0 = np.random.default_rng(59).standard_normal(6)
    port, ref = _solve_both(port_f, jax_f, x0, tol=1e-10, max_iterations=3)
    assert port.x.shape == (6,) and port.state.x.shape == (6,) and port.status.shape == ()
    assert_same(port, ref, 1e-12)
    port2 = qt.optimize_cg_from_state(port_f, port.state, tol=1e-10, max_iterations=400)
    ref2 = jax_cg.optimize_cg_from_state(jax_f, ref.state, tol=1e-10, max_iterations=400)
    assert port2.x.ndim == 1
    assert_same(port2, ref2, 1e-10)
    assert int(port2.status) == qt.Status.CONVERGED


@pytest.mark.parametrize("fold_eval", [False, True])
def test_chunked_resume_equals_one_long_run(rng, fold_eval):
    X0 = torch.tensor(rng.standard_normal((4, 8)))
    kw = dict(tol=1e-8, fold_eval=fold_eval)
    long = qt.optimize_cg(rosenbrock_logdensity, X0, **kw)
    leg = qt.optimize_cg(rosenbrock_logdensity, X0, max_iterations=7, **kw)
    assert (leg.status == qt.Status.MAX_ITERATIONS).all()
    for _ in range(3):
        leg = qt.optimize_cg_from_state(rosenbrock_logdensity, leg.state, max_iterations=11, **kw)
    res = qt.optimize_cg_from_state(rosenbrock_logdensity, leg.state, **kw)
    for name in COUNTERS:
        assert torch.equal(getattr(res, name), getattr(long, name)), name
    assert torch.equal(res.x, long.x)


def test_jax_state_resumes_in_the_port_as_in_jax():
    port_f, jax_f = _quad_fixture(10)
    X0 = np.random.default_rng(53).standard_normal((4, 10))
    leg = jax_cg.optimize_cg(jax_f, jnp.asarray(X0), tol=1e-10, max_iterations=7)
    np_state = jax.tree_util.tree_map(np.asarray, leg.state)
    state = qt.cg_state_from_numpy(np_state, torch.device("cpu"))
    assert isinstance(state, qt.CGState)
    back = qt.cg_state_to_numpy(state)
    for name, a, b in zip(qt.CGState._fields, back, np_state):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    port = qt.optimize_cg_from_state(port_f, state, tol=1e-10, max_iterations=400)
    ref = jax_cg.optimize_cg_from_state(jax_f, leg.state, tol=1e-10, max_iterations=400)
    assert_same(port, ref, 1e-10)


def test_jacobi_cg_on_a_diagonal_quadratic_matches_jax():
    """There diag(H) = d exactly for any ±1 probe, so the port's probes and
    JAX's give the same preconditioner and the same counters."""
    port_f, jax_f, d = _diagonal(24, 4)
    X0 = np.random.default_rng(1).standard_normal((6, 24))
    kw = dict(tol=1e-8, max_iterations=5000, precondition="jacobi")
    port, ref = _solve_both(port_f, jax_f, X0, **kw)
    assert_same(port, ref, 1e-12)
    assert port.converged.all()
    # condition 1e4, where plain CG takes thousands of iterations
    assert int(port.iterations.max()) <= 15
    # probes are counted: precond_probes extra gradient evaluations per iteration
    assert (port.n_gev >= port.n_fev + 2 * port.iterations).all()


def test_jacobi_cg_analytic_gradient_and_chunked_resume(rng):
    """The HVP goes through an analytic value_and_grad_fn as through
    autodiff (the same trajectory over a short horizon; the two gradients
    round differently, so not over a whole solve), and a chunked resume
    replays the probes of one long run bit for bit."""
    X0 = torch.tensor(rng.standard_normal((4, 8)) * 0.5)
    kw = dict(tol=1e-8, max_iterations=10, precondition="jacobi")
    auto = qt.optimize_cg(Rosenbrock(8), X0, **kw)
    analytic = qt.optimize_cg(rosenbrock_logdensity, X0,
                              value_and_grad_fn=rosenbrock_value_and_grad, **kw)
    for name in COUNTERS:
        assert torch.equal(getattr(auto, name), getattr(analytic, name)), name
    torch.testing.assert_close(auto.x, analytic.x, atol=1e-10, rtol=0)
    long = qt.optimize_cg(Rosenbrock(8), X0, **{**kw, "max_iterations": 40})
    leg = qt.optimize_cg(Rosenbrock(8), X0, **{**kw, "max_iterations": 3})
    res = qt.optimize_cg_from_state(Rosenbrock(8), leg.state, **{**kw, "max_iterations": 37})
    for name in COUNTERS:
        assert torch.equal(getattr(res, name), getattr(long, name)), name
    assert torch.equal(res.x, long.x)


@pytest.mark.parametrize("per_lane", [False, True])
def test_fixed_diagonal_matches_jax(per_lane):
    port_f, jax_f, d = _diagonal(16, 2)
    X0 = np.random.default_rng(5).standard_normal((3, 16))
    diag = np.stack([d, np.ones(16), np.sqrt(d)]) if per_lane else d
    port, ref = _solve_both(port_f, jax_f, X0, tol=1e-8, max_iterations=5000,
                            precondition=diag)
    assert port.converged.all()
    np.testing.assert_array_equal(port.status.numpy(), np.asarray(ref.status))
    # lanes with the exact diagonal converge in O(1) iterations, exactly as
    # in JAX; the unscaled lane is plain CG at condition 100 (long: the
    # certificate only)
    exact = [0] if per_lane else [0, 1, 2]
    port_exact = qt.CGResult(*(leaf[exact] for leaf in port[:-1]), state=None)
    ref_exact = jax_cg.CGResult(*(np.asarray(leaf)[exact] for leaf in ref[:-1]), state=None)
    assert_same(port_exact, ref_exact, 1e-10)
    if per_lane:
        assert int(port.iterations[0]) * 10 < int(port.iterations[1])
    # precondition = 1 is plain CG bit for bit
    unit = qt.optimize_cg(port_f, torch.tensor(X0), tol=1e-8, precondition=np.ones(16))
    plain = qt.optimize_cg(port_f, torch.tensor(X0), tol=1e-8)
    assert torch.equal(unit.x, plain.x) and torch.equal(unit.iterations, plain.iterations)


def _jax_probes(seed, k, probes, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), k)
    return [np.asarray(jax.random.rademacher(jax.random.fold_in(key, j), (n,), jnp.float64))
            for j in range(probes)]


@pytest.mark.parametrize("case", ["dense", "zero lane", "nan lane"])
def test_estimator_fed_jax_probes_matches_jax(case):
    rng = np.random.default_rng(7)
    batch, n = 5, 9
    H = rng.standard_normal((batch, n, n))
    H = H + H.transpose(0, 2, 1)
    if case == "zero lane":
        H[1] = 0.0  # a locally affine lane: the identity scaling
    if case == "nan lane":
        H[2, 3, 4] = np.nan
    X = rng.standard_normal((batch, n))
    Ht, Hj = torch.tensor(H), jnp.asarray(H)
    k = 17
    vs = _jax_probes(0x7453, k, 3, n)
    port = hutchinson._abs_diag_from_probes(
        lambda x, v: torch.einsum("bij,bj->bi", Ht, v), torch.tensor(X), [torch.tensor(v) for v in vs]
    ).numpy()
    ref = np.asarray(jax_hutchinson.hutchinson_abs_diag(
        lambda x, v: jnp.einsum("bij,bj->bi", Hj, v), jnp.asarray(X), jnp.int32(k), 3, 0x7453,
        param_axis=-1,
    ))
    np.testing.assert_allclose(port, ref, rtol=1e-14, atol=0)
    assert (port > 0).all()
    if case == "zero lane":
        np.testing.assert_array_equal(port[1], 1.0)
    if case == "nan lane":
        # the reference maps a NaN estimate to P = 1 on the whole lane
        # (ROADMAP.md C1); the port copies it
        np.testing.assert_array_equal(port[2], 1.0)


def test_port_probes_are_rademacher_keyed_and_reproducible():
    n = 4096
    v = hutchinson._rademacher(0x7453, 5, 0, n, torch.float64, torch.device("cpu"))
    assert set(v.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(v.mean())) < 0.05
    same = hutchinson._rademacher(0x7453, torch.tensor(5, dtype=torch.int32), 0, n,
                                  torch.float64, torch.device("cpu"))
    assert torch.equal(v, same)  # an int k and a device scalar k agree
    others = [hutchinson._rademacher(0x7453, 6, 0, n, torch.float64, torch.device("cpu")),
              hutchinson._rademacher(0x7453, 5, 1, n, torch.float64, torch.device("cpu")),
              hutchinson._rademacher(0x4242, 5, 0, n, torch.float64, torch.device("cpu"))]
    for w in others:
        assert 0.4 < float((v != w).double().mean()) < 0.6
    # the hash: no 32-bit product escapes its mask, whatever the key
    big = hutchinson._rademacher(0xFFFFFFFF, 2**31 - 1, 7, 64, torch.float32, torch.device("cpu"))
    assert set(big.unique().tolist()) <= {-1.0, 1.0}


def test_resolve_precondition_matches_jax():
    from quasinewtonmethods_jl_tpu.trust_region import _resolve_precondition as jax_resolve

    for value in (None, "jacobi"):
        assert _resolve_precondition(value, 4) == jax_resolve(value, 4)
    mode, diag = _resolve_precondition(np.arange(1.0, 5.0), 4)
    assert mode == "fixed" and torch.equal(diag, torch.arange(1.0, 5.0, dtype=torch.float64))
    for bad, match in (("ssor", "precondition"), (-np.ones(4), "finite and > 0"),
                       (np.array([1.0, np.nan, 1.0, 1.0]), "finite and > 0"),
                       (np.ones(5), "last axis")):
        with pytest.raises(ValueError, match=match):
            _resolve_precondition(bad, 4)
        with pytest.raises(ValueError, match=match):
            jax_resolve(bad, 4)


def test_failure_contracts_match_jax():
    # a linear objective: the Wolfe curvature test never holds, alpha = 0
    port, ref = _solve_both(lambda x: torch.sum(x), lambda x: jnp.sum(x), np.zeros((1, 4)))
    assert_same(port, ref, 0)
    assert int(port.status[0]) == qt.Status.LINESEARCH_FAILURE
    assert torch.isnan(port.fun).all() and (port.x == 0).all()
    # non-finite at x0: NONFINITE_VALUE, the iterate untouched
    port, ref = _solve_both(lambda x: torch.nan * torch.sum(x), lambda x: jnp.nan * jnp.sum(x),
                            np.ones((2, 4)))
    assert_same(port, ref, 0)
    assert (port.status == qt.Status.NONFINITE_VALUE).all() and (port.x == 1).all()


def test_f32_fleet_stays_f32(rng):
    X0 = torch.tensor(rng.standard_normal((32, 12)), dtype=torch.float32)
    res = qt.optimize_cg(rosenbrock_logdensity, X0, tol=1e-3, max_iterations=3000,
                         value_and_grad_fn=rosenbrock_value_and_grad)
    assert res.x.dtype == res.fun.dtype == res.state.m_prev.dtype == torch.float32
    assert res.converged.all()


def test_validation_errors():
    port_f, _, _ = _quadratic(4, 10.0, 8)
    for kw, match in ((dict(method="nope"), "method"), (dict(max_iterations=0), "max_iterations"),
                      (dict(restart_nu=-1.0), "restart_nu"),
                      (dict(precondition="jacobi", precond_probes=0), "precond_probes")):
        with pytest.raises(ValueError, match=match):
            qt.optimize_cg(port_f, torch.zeros(4, dtype=torch.float64), **kw)
    with pytest.raises(ValueError, match="rank"):
        qt.optimize_cg(port_f, torch.zeros((2, 2, 2), dtype=torch.float64))
    with pytest.raises(TypeError, match="BackTracking or a Wolfe"):
        qt.optimize_cg(port_f, torch.zeros(4, dtype=torch.float64), ls=object())
    state = qt.optimize_cg(port_f, torch.zeros(4, dtype=torch.float64), max_iterations=1).state
    with pytest.raises(ValueError, match="method"):
        qt.optimize_cg_from_state(port_f, state, method="nope")


def test_loop_counts_syncs_and_no_op_tail(rng):
    """Bodies past the last lane's finish are no-ops and every host read
    is counted; the resumed run of the same length changes nothing."""
    port_f, _ = _quad_fixture(6)
    X0 = torch.tensor(rng.standard_normal((8, 6)))
    qt.optimize_cg.host_syncs = qt.optimize_cg.loop_bodies = 0
    res = qt.optimize_cg(port_f, X0)
    bodies, syncs = qt.optimize_cg.loop_bodies, qt.optimize_cg.host_syncs
    last = int(res.iterations.max())
    assert last <= bodies <= last + 8
    assert bodies <= syncs  # at least one line-search read per body
    tail = qt.optimize_cg(port_f, X0, max_iterations=bodies)
    for name in COUNTERS:
        assert torch.equal(getattr(res, name), getattr(tail, name)), name
    assert torch.equal(res.x, tail.x)
