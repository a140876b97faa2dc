"""The port's weak-Wolfe search (ops/wolfe.py) and the fleet engine's
lockstep form of it (batched_solve._batched_wolfe) against the JAX
package's, on the same numpy inputs in f64, mirroring tests/test_wolfe.py.

The proposal is the same IEEE expression in both packages and is compared
to 1e-14 relative, NaN positions exactly. The searches' evaluation counts,
rounds and failure flags are compared exactly and alpha to 1e-12 relative;
along a ray the two packages evaluate the same closed-form objective, so
only the last bits of a sum may differ. The fleet engine with a Wolfe
search is held to the JAX engine as the backtracking fleet is
(tests/test_torch_batched_solve.py): statuses and every counter equal where
the trajectory is short or stable, the certificate to convergence.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu.batched_solve import (
    _batched_wolfe as jax_batched_wolfe,
    optimize_batched_fused as jax_optimize_batched_fused,
)
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.ops import linesearch as jax_ls
from quasinewtonmethods_jl_tpu.ops import wolfe as jax_wolfe
from quasinewtonmethods_jl_tpu_torch import Status, optimize_batched, optimize_batched_fused
from quasinewtonmethods_jl_tpu_torch.batched_solve import _batched_wolfe
from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity
from quasinewtonmethods_jl_tpu_torch.ops import linesearch as port_ls
from quasinewtonmethods_jl_tpu_torch.ops import wolfe as port_wolfe

torch.set_num_threads(1)

COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")


def test_wolfe_config_matches_jax():
    assert dataclasses.asdict(port_wolfe.Wolfe()) == dataclasses.asdict(jax_wolfe.Wolfe())
    assert port_wolfe.WolfeResult._fields == jax_wolfe.WolfeResult._fields
    for bad in (dict(c1=0.9, c2=0.1), dict(interp="quintic"), dict(approx_eps=-1.0)):
        with pytest.raises(ValueError):
            port_wolfe.Wolfe(**bad)
        with pytest.raises(ValueError):
            jax_wolfe.Wolfe(**bad)


@pytest.mark.parametrize("interp", ["cubic", "bisection"])
def test_wolfe_propose_matches_jax(interp):
    """Random brackets plus the fallbacks: a negative discriminant, a NaN
    end value, a NaN slope, an infinite slope, a zero-width bracket."""
    rng = np.random.default_rng(3)
    k = 64
    lo = rng.uniform(0.0, 1.0, k)
    hi = lo + rng.uniform(0.0, 2.0, k)
    flo, fhi = rng.standard_normal(k), rng.standard_normal(k)
    slo, shi = rng.standard_normal(k) * 3, rng.standard_normal(k) * 3
    slo[0], shi[0], flo[0], fhi[0] = 2.0, 2.0, 0.0, 4.0 / 3.0 * (hi[0] - lo[0])  # disc = -4
    fhi[1] = np.nan
    shi[2] = np.nan
    slo[3] = np.inf
    hi[4] = lo[4]
    args = (lo, flo, slo, hi, fhi, shi)
    with np.errstate(all="ignore"):
        port = port_wolfe.wolfe_propose(*map(torch.tensor, args), interp).numpy()
    ref = np.asarray(jax_wolfe.wolfe_propose(*map(jnp.asarray, args), interp))
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_allclose(port, ref, rtol=1e-14, atol=0)
    mid = 0.5 * (lo + hi)
    if interp == "cubic":
        # the midpoint fallback survives the port
        np.testing.assert_array_equal(port[[0, 1, 2]], mid[[0, 1, 2]])
        inside = np.isfinite(port) & (hi > lo)
        w = hi - lo
        assert (port[inside] >= lo[inside] + 0.1 * w[inside] - 1e-15).all()
        assert (port[inside] <= hi[inside] - 0.1 * w[inside] + 1e-15).all()
    else:
        np.testing.assert_array_equal(port, mid)


# one-lane rays φ(a) = f(x + a d) with x = 0, d = 1 (tests/test_wolfe.py)
RAYS = {
    "accept": (lambda x: x[0] - 0.5 * x[0] ** 2, 1),  # accepts a = 1
    "expand": (lambda x: x[0] - x[0] ** 2 / 200.0, 1),  # maximum at 100
    "shrink": (lambda x: x[0] - 50.0 * x[0] ** 2, 1),  # maximum at 0.01
    "coupled": (lambda x: x[0] + 0.3 * x[1] - 0.5 * x[0] ** 2 - x[0] * x[1] ** 2 - 2 * x[1] ** 4, 2),
}


def _phi_vag(vag, x, d, dot):
    def phi_vag(a):
        fv, gv = vag(x + a * d)
        return fv, dot(gv, d)

    return phi_vag


def _both(name, ls_kw, nan=False):
    f, n = RAYS[name]

    def port_f(x):
        v = f(x)
        return torch.where(torch.sum(torch.abs(x)) > 0, torch.nan, v) if nan else v

    def jax_f(x):
        v = f(x)
        return jnp.where(jnp.sum(jnp.abs(x)) > 0, jnp.nan, v) if nan else v

    x, d = torch.zeros(n, dtype=torch.float64), torch.ones(n, dtype=torch.float64)
    grad_and_value = torch.func.grad_and_value(f)
    g0, f0 = grad_and_value(x)
    m = torch.dot(g0, d)
    port_vag = torch.func.grad_and_value(port_f)
    port = port_wolfe.wolfe_linesearch(
        _phi_vag(lambda z: port_vag(z)[::-1], x, d, torch.dot), f0, m, port_wolfe.Wolfe(**ls_kw)
    )
    ref = jax_wolfe.wolfe_linesearch(
        _phi_vag(jax.value_and_grad(jax_f), jnp.asarray(x.numpy()), jnp.asarray(d.numpy()),
                 jnp.dot),
        jnp.float64(float(f0)), jnp.float64(float(m)), jax_wolfe.Wolfe(**ls_kw),
    )
    return port, ref


@pytest.mark.parametrize("name", sorted(RAYS))
@pytest.mark.parametrize("ls_kw", [{}, dict(interp="bisection"), dict(approx=True),
                                   dict(c2=0.1, iterations=6)])
def test_one_lane_search_matches_jax(name, ls_kw):
    port, ref = _both(name, ls_kw)
    np.testing.assert_allclose(float(port.alpha), float(ref.alpha), rtol=1e-12, atol=0)
    np.testing.assert_allclose(float(port.f_final), float(ref.f_final), rtol=1e-12, atol=1e-15)
    assert int(port.n_fev) == int(ref.n_fev)
    assert int(port.iterations) == int(ref.iterations)
    assert bool(port.failed) == bool(ref.failed)
    if name == "expand" and not port.failed:
        assert float(port.alpha) > 1.0  # grew past the unit step
    if name == "shrink" and not port.failed:
        assert 0.0 < float(port.alpha) < 1.0


@pytest.mark.parametrize("approx", [False, True])
def test_nan_objective_fails_like_jax(approx):
    port, ref = _both("accept", dict(iterations=20, approx=approx), nan=True)
    assert bool(port.failed) and bool(ref.failed)
    assert float(port.alpha) == 0.0
    assert int(port.n_fev) == int(ref.n_fev) == 21


def test_run_linesearch_wolfe_matches_jax():
    rng = np.random.default_rng(9)
    x, d = rng.standard_normal(6) * 0.3, rng.standard_normal(6)
    xt, dt = torch.tensor(x), torch.tensor(d)
    vag = torch.func.grad_and_value(rosenbrock_logdensity)
    f0, g0 = rosenbrock_logdensity(xt), vag(xt)[0]
    dt = dt * torch.sign(torch.dot(g0, dt))  # an ascent direction
    m = torch.dot(g0, dt)
    port = port_ls.run_linesearch(
        port_wolfe.Wolfe(), rosenbrock_logdensity, lambda z: vag(z)[::-1], xt, dt, f0, m
    )
    ref = jax_ls.run_linesearch(
        jax_wolfe.Wolfe(), jax_rosenbrock, jax.value_and_grad(jax_rosenbrock), jnp.asarray(x),
        jnp.asarray(dt.numpy()), jnp.asarray(float(f0)), jnp.asarray(float(m)),
    )
    np.testing.assert_allclose(float(port[0]), float(ref[0]), rtol=1e-10)
    assert (bool(port[1]), int(port[2]), int(port[3])) == (bool(ref[1]), int(ref[2]), int(ref[3]))


# The fleet search on separable concave quadratics, one kind per lane:
# accept at a = 1, expand, shrink, a NaN cliff, a frozen lane, a NaN slope
# at 0 (doomed), and random curvatures.
def _fleet_rays(rng, batch=12, n=3):
    A = rng.uniform(0.5, 2.0, (batch, n))
    C = rng.uniform(0.5, 2.0, (batch, n))
    C[1] = 0.01  # expand
    C[2] = 80.0  # shrink
    cliff = np.full(batch, np.inf)
    cliff[3] = 0.0  # every trial NaN
    active = np.ones(batch, bool)
    active[4] = False
    return A, C, cliff, active


def _port_fleet(A, C, cliff):
    A, C, cliff = map(torch.tensor, (A, C, cliff))

    def vag_b(X):
        f = (A * X).sum(1) - 0.5 * (C * X * X).sum(1)
        f = torch.where(X.abs().sum(1) > cliff, torch.nan, f)
        return f, A - C * X

    return vag_b


def _jax_fleet(A, C, cliff):
    A, C, cliff = (jnp.asarray(a.T) if a.ndim == 2 else jnp.asarray(a) for a in (A, C, cliff))

    def vag_b(X):  # lane-minor (n, batch)
        f = (A * X).sum(0) - 0.5 * (C * X * X).sum(0)
        f = jnp.where(jnp.abs(X).sum(0) > cliff, jnp.nan, f)
        return f, A - C * X

    return vag_b


@pytest.mark.parametrize("with_grad", [False, True])
@pytest.mark.parametrize("ls_kw", [{}, dict(approx=True), dict(interp="bisection", c2=0.2)])
def test_fleet_search_matches_jax(with_grad, ls_kw):
    rng = np.random.default_rng(4)
    A, C, cliff, active = _fleet_rays(rng)
    X = rng.standard_normal(A.shape) * 0.1
    D = A - C * X  # the gradient: an ascent direction on every lane
    port_vag, jax_vag = _port_fleet(A, C, cliff), _jax_fleet(A, C, cliff)
    f0, g0 = port_vag(torch.tensor(X))
    m = (g0 * torch.tensor(D)).sum(1)
    m[5] = torch.nan  # doomed

    Xt, Dt = torch.tensor(X), torch.tensor(D)

    def port_phi(alpha):
        fv, gv = port_vag(Xt + alpha[:, None] * Dt)
        return fv, (gv * Dt).sum(1), gv

    Xj, Dj = jnp.asarray(X.T), jnp.asarray(D.T)

    def jax_phi(alpha):
        fv, gv = jax_vag(Xj + alpha[None, :] * Dj)
        return fv, jnp.sum(gv * Dj, axis=0), gv

    port = _batched_wolfe(port_phi, f0, m, torch.tensor(active), port_wolfe.Wolfe(**ls_kw),
                          torch.float64, with_grad=with_grad)
    ref = jax_batched_wolfe(jax_phi, jnp.asarray(f0.numpy()), jnp.asarray(m.numpy()),
                            jnp.asarray(active), jax_wolfe.Wolfe(**ls_kw), jnp.float64,
                            with_grad=with_grad)
    alpha, n_ev, it, failed, fa, Ga, reads = port
    assert reads == int(it.max()) + 1  # one host read per round and the final one
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref[0]), rtol=1e-12, atol=0)
    for a, b in zip((n_ev, it, failed), ref[1:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(fa.numpy(), np.asarray(ref[4]), rtol=1e-12, atol=1e-15)
    if with_grad:
        # atol: the shrink lane's trial sits at its 1-D maximum, where the
        # gradient is cancellation noise of order 1e-15
        np.testing.assert_allclose(Ga.numpy(), np.asarray(ref[5]).T, rtol=1e-12, atol=1e-13)
    else:
        assert Ga is None
    assert failed[[3, 5]].all() and not failed[4] and alpha[4] == 0.0 and n_ev[4] == 0
    assert alpha[1] > 1.0 and 0.0 < alpha[2] < 1.0


def quad_logdensity(x):
    diag = torch.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype)
    return -0.5 * torch.sum(diag * x * x)


def jax_quad_logdensity(x):
    diag = jnp.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype)
    return -0.5 * jnp.sum(diag * x * x)


@pytest.mark.parametrize("ls_kw", [{}, dict(approx=True)])
def test_bfgs_fleet_with_wolfe_matches_jax_on_a_quadratic(rng, ls_kw):
    X0 = rng.standard_normal((8, 6))
    port = optimize_batched(quad_logdensity, torch.tensor(X0), ls=port_wolfe.Wolfe(**ls_kw))
    ref = jax_optimize_batched_fused(jax_quad_logdensity, jnp.asarray(X0),
                                     ls=jax_wolfe.Wolfe(**ls_kw), kernel="xla")
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    assert (port.status == Status.CONVERGED).all()
    # every Wolfe trial is a value+gradient evaluation
    assert (port.n_gev == port.n_fev).all()
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-10, rtol=0)


@pytest.mark.parametrize("max_iterations", [1, 5, 15])
def test_bfgs_fleet_with_wolfe_matches_jax_short_horizon(rng, max_iterations):
    X0 = rng.standard_normal((24, 10))
    port = optimize_batched_fused(rosenbrock_logdensity, torch.tensor(X0), ls=port_wolfe.Wolfe(),
                                  max_iterations=max_iterations, kernel="torch")
    ref = jax_optimize_batched_fused(jax_rosenbrock, jnp.asarray(X0), ls=jax_wolfe.Wolfe(),
                                     max_iterations=max_iterations, kernel="xla")
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)
    np.testing.assert_allclose(port.state.B.numpy(), np.asarray(ref.state.B), atol=1e-8, rtol=0)


def test_bfgs_fleet_with_wolfe_to_convergence_matches_jax_certificate(rng):
    X0 = rng.standard_normal((24, 10))
    port = optimize_batched_fused(rosenbrock_logdensity, torch.tensor(X0), ls=port_wolfe.Wolfe())
    ref = jax_optimize_batched_fused(jax_rosenbrock, jnp.asarray(X0), ls=jax_wolfe.Wolfe(),
                                     kernel="xla")
    np.testing.assert_array_equal(port.status.numpy(), np.asarray(ref.status))
    assert (port.status == Status.CONVERGED).all()
    assert float(port.grad.abs().max()) < 1e-8
    np.testing.assert_allclose(port.x.numpy(), 1.0, atol=1e-6)
    # the Wolfe pairs keep sᵀy > 0: no reset past the first iteration's
    assert (port.n_resets <= 1).all()
