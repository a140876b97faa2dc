"""The port's Levenberg–Marquardt engine (least_squares.py) against the JAX
package's, on the same numpy inputs in f64, mirroring
tests/test_least_squares.py.

Statuses and every counter (iterations, n_fev, n_jev) must be equal lane by
lane; floats (x, fun, grad, JTJ, lam) within rtol 1e-8 (the packages sum
J's products in different orders). Tolerances sit above the rounding floor
of the certificate: at max|g| ~ 1e-10 the gain ratio of the last steps is
rounding, and the damping, then the counters, follow it in either package.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qnm
import quasinewtonmethods_jl_tpu_torch as qt

# the packages export a function of the module's name
jax_ls = importlib.import_module("quasinewtonmethods_jl_tpu.least_squares")
port_ls = importlib.import_module("quasinewtonmethods_jl_tpu_torch.least_squares")

torch.set_num_threads(1)

COUNTERS = ("status", "iterations", "n_fev", "n_jev")
FLOATS = ("x", "fun", "grad", "JTJ", "lam")


def assert_same(port, ref, rtol=1e-8, atol=1e-12):
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in FLOATS:
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def exp_fit_data(batch=8, m=24, seed=0, outliers=False):
    """Per-lane exponential fits (bench_full.py config 8's shape): t, y."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, m)
    amp = rng.uniform(0.5, 3.0, batch)
    rate = rng.uniform(-2.5, -0.5, batch)
    y = amp[:, None] * np.exp(rate[:, None] * t[None, :]) + 0.05 * rng.standard_normal((batch, m))
    if outliers:
        y[:, ::7] += 2.0
    return np.tile(t, (batch, 1)), y


def exp_res_jax(p, d):
    tt, yy = d
    return p[..., 0:1] * jnp.exp(p[..., 1:2] * tt) - yy


def exp_res_port(p, d):
    tt, yy = d
    return p[..., 0:1] * torch.exp(p[..., 1:2] * tt) - yy


def rosen_res_jax(x):
    return jnp.concatenate([10.0 * (x[1:] - x[:-1] ** 2), 1.0 - x[:-1]])


def rosen_res_port(x):
    return torch.cat([10.0 * (x[1:] - x[:-1] ** 2), 1.0 - x[:-1]])


def _both(port_fn, jax_fn, x0, data=None, **kw):
    port = qt.least_squares(port_fn, torch.tensor(x0),
                            data=None if data is None else tuple(map(torch.tensor, data)), **kw)
    ref = qnm.least_squares(jax_fn, jnp.asarray(x0),
                            data=None if data is None else tuple(map(jnp.asarray, data)), **kw)
    return port, ref


def test_result_and_state_layout_match_jax():
    assert qt.LMState._fields == jax_ls.LMState._fields
    assert qt.LeastSquaresResult._fields == jax_ls.LeastSquaresResult._fields
    assert port_ls.LM_MAX_ITERATIONS_DEFAULT == jax_ls.LM_MAX_ITERATIONS_DEFAULT
    assert port_ls.LM_LOSSES == jax_ls.LM_LOSSES


@pytest.mark.parametrize("jac_mode", ["fwd", "rev"])
@pytest.mark.parametrize("loss", ["linear", "huber", "soft_l1", "cauchy", "arctan"])
def test_every_loss_on_a_data_fleet_matches_jax(loss, jac_mode):
    """Per-lane data (``data=``) with outliers, every robust loss, both
    Jacobian modes: 16 exponential fits."""
    data = exp_fit_data(batch=16, outliers=True)
    X0 = np.tile([1.0, 0.0], (16, 1))
    port, ref = _both(exp_res_port, exp_res_jax, X0, data, tol=1e-6, loss=loss, jac_mode=jac_mode)
    assert_same(port, ref)
    assert port.converged.all()


def test_rank1_solve_matches_jax():
    port, ref = _both(rosen_res_port, rosen_res_jax, np.full(6, -1.2), tol=1e-8)
    assert_same(port, ref)
    assert port.x.shape == (6,) and port.state.x.shape == (6,)  # JAX squeezes the state too
    assert bool(port.converged)
    np.testing.assert_allclose(port.x.numpy(), 1.0, atol=1e-8)


def test_underdetermined_takes_reverse_mode_and_matches_jax():
    A = np.random.default_rng(3).standard_normal((3, 7))
    Aj, At = jnp.asarray(A), torch.tensor(A)
    assert port_ls._resolve_jac_mode("auto", 7, 3) == "rev"
    port, ref = _both(lambda x: At @ x - 1.0 + 0.1 * x[:3] ** 2,
                      lambda x: Aj @ x - 1.0 + 0.1 * x[:3] ** 2, np.zeros(7), tol=1e-9)
    assert_same(port, ref)


def test_bounds_match_jax():
    """Active faces, a one-sided infinite box and per-lane boxes with a
    start clipped in."""
    t, y = exp_fit_data(batch=4, m=40, seed=19)
    lo = np.array([0.0, -5.0])
    hi = np.array([10.0, -1.2])  # the rate's upper face is active on some lanes
    X0 = np.tile([1.0, -1.5], (4, 1))
    port, ref = _both(exp_res_port, exp_res_jax, X0, (t, y), bounds=(lo, hi), tol=1e-7)
    assert_same(port, ref)
    assert port.converged.all()

    lo1 = np.array([-np.inf, -np.inf, -np.inf])
    hi1 = np.array([1.0, np.inf, np.inf])
    target = np.array([2.0, -3.0, 0.5])
    port, ref = _both(lambda x: x - torch.tensor(target), lambda x: x - jnp.asarray(target),
                      np.zeros(3), bounds=(lo1, hi1), tol=1e-7)
    assert_same(port, ref)
    np.testing.assert_allclose(port.x.numpy(), [1.0, -3.0, 0.5], atol=1e-8)

    X0 = np.stack([np.zeros(3), np.full(3, 9.0)])
    lo2 = np.zeros((2, 3))
    hi2 = np.stack([np.full(3, 5.0), np.full(3, 1.0)])
    port, ref = _both(lambda x: x - 2.0, lambda x: x - 2.0, X0, bounds=(lo2, hi2), tol=1e-10)
    assert_same(port, ref)
    np.testing.assert_allclose(port.x.numpy()[1], 1.0, atol=1e-8)


def _rank_deficient():
    """Three lanes of r = A x - c through ``data``: lanes 0 and 2 have two
    equal columns (J = 1 and J = 2, rank 1), lane 1 is full rank."""
    t = np.linspace(0.0, 1.0, 4)
    A = np.stack([np.ones((4, 2)), np.stack([np.ones(4), t], 1), np.full((4, 2), 2.0)])
    c = np.stack([[1.0, 2, 3, 4], [1.0, 2, 3, 5], [0.5, 1, 2, 3]])
    X0 = np.array([[0.3, -0.2], [0.0, 0.0], [1.0, 1.0]])
    return X0, (A, c)


@pytest.mark.parametrize("cap", [1, 2, 3, 4, 200])
def test_non_spd_cholesky_heals_in_band_as_in_jax(cap):
    """At lam ≈ 0 (damping_init 2^-60) the rank-1 lanes' damped system
    rounds to a singular one: diag 4(1 + lam) == 4 exactly, so the pivot is
    0 and the Cholesky fails. JAX returns a NaN factor, the trial is
    non-finite and rejected, and lam grows by nu until 4 + 4·lam is
    representable (3 rejections); the port must follow the same lam and nu
    trajectory and counters, and not raise."""
    X0, data = _rank_deficient()
    port, ref = _both(lambda x, d: d[0] @ x - d[1], lambda x, d: d[0] @ x - d[1], X0, data,
                      damping_init=2.0 ** -60, tol=1e-10, max_iterations=cap)
    assert_same(port, ref)
    # the rejected trials' damping is exact: powers of 2
    np.testing.assert_array_equal(port.state.nu.numpy(), np.asarray(ref.state.nu))
    if cap < 4:
        np.testing.assert_array_equal(port.lam.numpy()[[0, 2]], np.asarray(ref.lam)[[0, 2]])
    np.testing.assert_array_equal(port.state.stall.numpy(), np.asarray(ref.state.stall))
    if cap >= 4:
        assert port.converged.all() and (port.iterations.numpy() == [4, 1, 4]).all()
    else:
        assert (port.state.stall.numpy() == [cap, 0, cap]).all()


def test_damped_step_is_nan_where_the_factorisation_fails():
    JTJ = torch.tensor([[[4.0, 4.0], [4.0, 4.0]], [[2.0, 0.0], [0.0, 3.0]]], dtype=torch.float64)
    g = torch.ones(2, 2, dtype=torch.float64)
    lam = torch.tensor([2.0 ** -60, 2.0 ** -60], dtype=torch.float64)
    delta, _ = port_ls._damped_step(JTJ, g, lam, 1e-300)
    ref, _ = jax_ls._damped_step(jnp.asarray(JTJ.numpy()), jnp.asarray(g.numpy()),
                                 jnp.asarray(lam.numpy()), 1e-300)
    assert torch.isnan(delta[0]).all() and torch.isfinite(delta[1]).all()
    np.testing.assert_allclose(delta.numpy(), np.asarray(ref), rtol=1e-15)


def test_jax_made_state_resumes_in_the_port():
    """A JAX `LMState` after 3 iterations, through numpy, resumes in the
    port as it resumes in JAX."""
    t, y = exp_fit_data(batch=6, seed=4)
    X0 = np.tile([1.0, 0.0], (6, 1))
    part = qnm.least_squares(exp_res_jax, jnp.asarray(X0), data=(jnp.asarray(t), jnp.asarray(y)),
                             tol=1e-7, max_iterations=3)
    saved = jax_ls.LMState(*(np.asarray(leaf) for leaf in part.state))
    port = qt.least_squares_from_state(exp_res_port, qt.lm_state_from_numpy(saved, "cpu"),
                                       data=(torch.tensor(t), torch.tensor(y)), tol=1e-7)
    ref = qnm.least_squares_from_state(exp_res_jax, part.state,
                                       data=(jnp.asarray(t), jnp.asarray(y)), tol=1e-7)
    assert_same(port, ref)
    assert port.converged.all() and (port.iterations.numpy() > 3).all()
    back = qt.lm_state_to_numpy(port.state)
    assert all(isinstance(leaf, np.ndarray) for leaf in back)


def test_chunked_resume_equals_one_long_run_rank1():
    long = qt.least_squares(rosen_res_port, torch.full((5,), -1.2, dtype=torch.float64))
    part = qt.least_squares(rosen_res_port, torch.full((5,), -1.2, dtype=torch.float64),
                            max_iterations=4)
    cont = qt.least_squares_from_state(rosen_res_port, part.state)
    assert bool(cont.converged)
    for name in ("x", "iterations", "n_fev", "lam"):
        assert torch.equal(getattr(cont, name), getattr(long, name)), name


def test_failure_stays_in_band_like_jax():
    """A NaN lane at x0 (NONFINITE_VALUE, fun NaN, iterate kept) beside a
    lane that meets a NaN wall."""
    def rj(x):
        return jnp.where(x[0] > 2.0, jnp.nan, x - 3.0)

    def rt(x):
        return torch.where(x[0] > 2.0, torch.nan, x - 3.0)

    X0 = np.array([[np.nan, 0.0], [0.0, 0.0], [1.0, 1.0]])
    port, ref = _both(rt, rj, X0, tol=1e-8, max_iterations=60)
    assert_same(port, ref)
    assert port.status[0] == qt.Status.NONFINITE_VALUE and torch.isnan(port.fun).all()
    assert (port.x[1:, 0] <= 2.0).all()


def test_input_validation_matches_jax():
    x0 = torch.zeros(2, dtype=torch.float64)
    for kw, match in (({"loss": "nope"}, "loss must be one of"),
                      ({"f_scale": 0.0}, "f_scale must be > 0"),
                      ({"max_iterations": 0}, "max_iterations must be >= 1"),
                      ({"jac_mode": "sideways"}, "jac_mode must be"),
                      ({"bounds": (1.0, 1.0)}, "lower < upper"),
                      ({"bounds": 3.0}, "bounds must be a")):
        with pytest.raises(ValueError, match=match):
            qt.least_squares(lambda x: x - 1.0, x0, **kw)
        with pytest.raises(ValueError, match=match):
            qnm.least_squares(lambda x: x - 1.0, jnp.zeros(2), **kw)
    with pytest.raises(ValueError, match="rank 1 or 2"):
        qt.least_squares(lambda x: x, torch.zeros(1, 2, 2))
    with pytest.raises(ValueError, match="batch axis"):
        qt.least_squares(lambda x, d: x - d, torch.zeros(3, 2), data=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="rank-1"):
        qt.least_squares(lambda x: x.sum(), x0)


def test_tf32_is_off_for_the_residual_and_the_gram(monkeypatch):
    """TF32 is off while the residual runs and while JᵀJ and Jᵀr are formed
    (JAX pins HIGHEST); the caller's switches come back afterwards."""
    seen = []
    einsum = torch.einsum

    def spy(*args, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return einsum(*args, **kw)

    def res(x):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return rosen_res_port(x)

    monkeypatch.setattr(torch, "einsum", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    qt.least_squares(res, torch.full((4,), -1.2, dtype=torch.float64), max_iterations=3)
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32


def test_counters_count_reads_and_bodies():
    qt.least_squares.host_syncs = qt.least_squares.loop_bodies = 0
    res = qt.least_squares(rosen_res_port, torch.full((2, 4), -1.2, dtype=torch.float64),
                           max_iterations=200)
    bodies = int(res.iterations.max())
    assert qt.least_squares.loop_bodies >= bodies
    # one read before the first body and every TERMINATION_CHECK_INTERVAL
    from quasinewtonmethods_jl_tpu_torch.batched_solve import TERMINATION_CHECK_INTERVAL

    assert qt.least_squares.host_syncs == qt.least_squares.loop_bodies // TERMINATION_CHECK_INTERVAL + 1
