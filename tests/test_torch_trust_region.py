"""The port's trust-region Newton–Krylov engine (trust_region.py) against
the JAX package's, on the same numpy inputs in f64, mirroring
tests/test_trust_region.py.

Statuses and every counter (iterations, n_fev, n_hev) must be equal lane by
lane; floats (x, fun, grad) within rtol 1e-8, and the radius where no
lane has converged (the last step's gain ratio is rounding: a certificate
accepts a trial whatever its ratio, which then sets the final radius).
``n_hev`` holds the
fleet-wide Steihaug count: every active lane adds the bodies run while any
lane was in CG. The port draws its own Hutchinson probes (jax.random cannot
be reproduced), so Jacobi TR is compared where the estimate is exact for
any probe: diagonal Hessians.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.batched_solve import TERMINATION_CHECK_INTERVAL
from quasinewtonmethods_jl_tpu_torch.models import (
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)

jax_tr = importlib.import_module("quasinewtonmethods_jl_tpu.trust_region")
port_tr = importlib.import_module("quasinewtonmethods_jl_tpu_torch.trust_region")

torch.set_num_threads(1)

COUNTERS = ("status", "iterations", "n_fev", "n_hev")
FLOATS = ("x", "fun", "grad", "last_value")


def assert_same(port, ref, rtol=1e-8, atol=1e-12, delta=False):
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in FLOATS + (("delta",) if delta else ()):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def _both(port_obj, jax_obj, x0, port_kw=None, jax_kw=None, **kw):
    port = qt.optimize_tr(port_obj, torch.tensor(x0), **(port_kw or {}), **kw)
    ref = qnm.optimize_tr(jax_obj, jnp.asarray(x0), **(jax_kw or {}), **kw)
    return port, ref


def quartic(n, cond, seed):
    """A dense quadratic of condition ``cond`` minus a quartic: indefinite
    far from the mode, so Steihaug rides negative curvature to the
    boundary there."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.geomspace(1.0, cond, n)) @ Q.T
    b = rng.standard_normal(n)
    At, bt, Aj, bj = torch.tensor(A), torch.tensor(b), jnp.asarray(A), jnp.asarray(b)

    def port(x):
        return -0.5 * x @ (At @ x) + bt @ x - 0.1 * torch.sum(x ** 4) + 0.5 * torch.sum(x ** 2)

    def ref(x):
        return -0.5 * x @ (Aj @ x) + bj @ x - 0.1 * jnp.sum(x ** 4) + 0.5 * jnp.sum(x ** 2)

    return port, ref


def diagonal(n, top):
    """Separable: a diagonal Hessian everywhere (the Hutchinson estimate is
    exact for any probe)."""
    d = np.logspace(0, top, n)
    dt, dj = torch.tensor(d), jnp.asarray(d)
    return ((lambda x: -0.5 * torch.sum(dt * x * x) - 0.05 * torch.sum(x ** 4)),
            (lambda x: -0.5 * jnp.sum(dj * x * x) - 0.05 * jnp.sum(x ** 4)), d)


def test_result_and_state_layout_match_jax():
    assert qt.TRState._fields == jax_tr.TRState._fields
    assert qt.TRResult._fields == jax_tr.TRResult._fields
    assert port_tr.TR_MAX_ITERATIONS_DEFAULT == jax_tr.TR_MAX_ITERATIONS_DEFAULT
    assert port_tr.TR_STALL_LIMIT == jax_tr.TR_STALL_LIMIT


def test_unbounded_fleet_matches_jax():
    port_f, jax_f = quartic(6, 100.0, 0)
    X0 = np.random.default_rng(1).standard_normal((10, 6)) * 2.0
    port, ref = _both(port_f, jax_f, X0, tol=1e-9)
    assert_same(port, ref)
    assert port.converged.all()


def test_rank1_rosenbrock_matches_jax():
    x0 = np.random.default_rng(7).standard_normal(8)
    port, ref = _both(rosenbrock_logdensity, jax_rosenbrock, x0, tol=1e-8)
    assert_same(port, ref)
    assert bool(port.converged) and port.x.shape == (8,) and port.state.x.shape == (8,)


def test_analytic_value_and_grad_gives_the_hvps_of_autodiff():
    """HVPs are one jvp through the user's value_and_grad_fn."""
    X0 = np.random.default_rng(3).standard_normal((4, 6))
    port = qt.optimize_tr(rosenbrock_logdensity, torch.tensor(X0), tol=1e-8,
                          value_and_grad_fn=rosenbrock_value_and_grad)
    ref = qnm.optimize_tr(jax_rosenbrock, jnp.asarray(X0), tol=1e-8)
    assert_same(port, ref)


def test_steihaug_count_is_fleet_wide_as_in_jax():
    """Lanes leave CG at different bodies (starts at different distances
    on a condition-30 quadratic with a quartic, n = 16 = max_cg): every
    active lane's n_hev adds the fleet's count, as JAX's ``j``, though the
    port reads the fleet only every TERMINATION_CHECK_INTERVAL bodies."""
    port_f, jax_f = quartic(16, 30.0, 2)
    scales = np.array([1e-3, 0.1, 1.0, 3.0])[:, None]
    X0 = np.random.default_rng(4).standard_normal((4, 16)) * scales
    qt.optimize_tr.host_syncs = qt.optimize_tr.cg_bodies = qt.optimize_tr.loop_bodies = 0
    port, ref = _both(port_f, jax_f, X0, tol=1e-7, cg_tol=0.1)
    assert_same(port, ref)
    assert port.converged.all() and len(set(port.n_hev.tolist())) > 1
    # some CG loop ran past its first read, so its masked extra bodies ran
    outer_reads = qt.optimize_tr.loop_bodies // TERMINATION_CHECK_INTERVAL + 1
    assert qt.optimize_tr.host_syncs > outer_reads + qt.optimize_tr.loop_bodies
    assert qt.optimize_tr.cg_bodies + qt.optimize_tr.loop_bodies > int(port.n_hev.max())
    part, ref3 = _both(port_f, jax_f, X0, tol=1e-7, cg_tol=0.1, max_iterations=3)
    assert_same(part, ref3, delta=True)  # no lane has converged by then


def test_bounds_match_jax():
    port_f, jax_f = quartic(6, 100.0, 5)
    X0 = np.random.default_rng(6).standard_normal((6, 6)) * 2.0
    lo = np.full(6, -0.4)
    hi = np.array([0.3, 0.5, np.inf, 1.0, 0.2, 0.6])
    port, ref = _both(port_f, jax_f, X0, tol=1e-9, bounds=(lo, hi))
    assert_same(port, ref)
    assert port.converged.all()
    assert (port.x.numpy() >= lo - 1e-15).all() and (port.x.numpy() <= hi + 1e-15).all()


@pytest.mark.parametrize("bounded", [False, True])
def test_jacobi_on_a_diagonal_hessian_matches_jax(bounded):
    port_f, jax_f, _ = diagonal(16, 3)
    X0 = np.random.default_rng(8).standard_normal((5, 16)) * 2.0
    kw = {"bounds": (-1.0, np.where(np.arange(16) % 2 == 0, 0.5, 3.0))} if bounded else {}
    port, ref = _both(port_f, jax_f, X0, tol=1e-9, precondition="jacobi", **kw)
    assert_same(port, ref)
    assert port.converged.all()


def test_fixed_diagonal_matches_jax():
    port_f, jax_f, d = diagonal(10, 4)
    X0 = np.random.default_rng(9).standard_normal((3, 10))
    port, ref = _both(port_f, jax_f, X0, tol=1e-9, port_kw={"precondition": torch.tensor(d)},
                      jax_kw={"precondition": jnp.asarray(d)})
    assert_same(port, ref)


def test_certificate_accept_rejects_an_uphill_plateau_as_jax_does():
    def port_f(x):
        r2 = torch.sum(x * x)
        return torch.where(r2 < 25.0, -r2, -100.0 + 0.0 * r2)

    def jax_f(x):
        r2 = jnp.sum(x * x)
        return jnp.where(r2 < 25.0, -r2, -100.0 + 0.0 * r2)

    port, ref = _both(port_f, jax_f, np.full(3, 0.5), delta0=100.0, tol=1e-6)
    assert_same(port, ref)
    assert bool(port.converged) and float(port.fun) > -1e-6


def test_failures_stay_in_band_as_in_jax():
    """A NaN start, a NaN region (rejected trials keep the iterate), an
    iteration cap."""
    def port_f(x):
        r2 = torch.sum(x * x)
        return torch.where(r2 < 4.0, -(r2 - 1.0) ** 2, torch.nan)

    def jax_f(x):
        r2 = jnp.sum(x * x)
        return jnp.where(r2 < 4.0, -(r2 - 1.0) ** 2, jnp.nan)

    X0 = np.array([[0.4, 0.3], [np.nan, 0.0], [1.5, 1.2]])
    port, ref = _both(port_f, jax_f, X0, delta0=100.0, tol=1e-8)
    assert_same(port, ref)
    assert port.status[1] == qt.Status.NONFINITE_VALUE and torch.isnan(port.fun[1])
    port, ref = _both(rosenbrock_logdensity, jax_rosenbrock,
                      np.random.default_rng(5).standard_normal(10), max_iterations=3)
    assert_same(port, ref)
    assert int(port.status) == qt.Status.MAX_ITERATIONS and torch.isnan(port.fun)


def test_jax_made_state_resumes_in_the_port():
    X0 = np.random.default_rng(10).standard_normal((4, 8))
    part = qnm.optimize_tr(jax_rosenbrock, jnp.asarray(X0), tol=1e-8, max_iterations=5)
    saved = jax_tr.TRState(*(np.asarray(leaf) for leaf in part.state))
    port = qt.optimize_tr_from_state(rosenbrock_logdensity, qt.tr_state_from_numpy(saved, "cpu"),
                                     tol=1e-8)
    ref = qnm.optimize_tr_from_state(jax_rosenbrock, part.state, tol=1e-8)
    assert_same(port, ref)
    assert port.converged.all() and (port.iterations.numpy() > 5).all()


def test_chunked_resume_equals_one_long_run():
    x0 = torch.tensor(np.random.default_rng(9).standard_normal(8))
    for kw in ({}, {"precondition": "jacobi"}):
        long = qt.optimize_tr(rosenbrock_logdensity, x0, **kw)
        leg1 = qt.optimize_tr(rosenbrock_logdensity, x0, max_iterations=6, **kw)
        leg2 = qt.optimize_tr_from_state(rosenbrock_logdensity, leg1.state, **kw)
        assert torch.equal(leg2.x, long.x)
        assert int(leg2.iterations) == int(long.iterations) and int(leg2.n_hev) == int(long.n_hev)


def test_misuse_probes_match_jax():
    x0 = torch.zeros(8, dtype=torch.float64)
    for kw, match in (({"precondition": "nope"}, "precondition"),
                      ({"precondition": -np.ones(8)}, "finite and > 0"),
                      ({"precondition": np.ones(4)}, "last axis"),
                      ({"precondition": "jacobi", "precond_probes": 0}, "precond_probes"),
                      ({"max_iterations": 0}, "max_iterations"),
                      ({"max_cg": 0}, "max_cg"),
                      ({"delta0": 0.0}, "delta0"),
                      ({"bounds": (1.0, 0.0)}, "lower < upper")):
        with pytest.raises(ValueError, match=match):
            qt.optimize_tr(rosenbrock_logdensity, x0, **kw)
        with pytest.raises(ValueError, match=match):
            qnm.optimize_tr(jax_rosenbrock, jnp.zeros(8), **kw)
    with pytest.raises(ValueError, match="rank 1 or 2"):
        qt.optimize_tr(rosenbrock_logdensity, torch.zeros(1, 2, 2))
