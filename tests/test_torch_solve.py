"""The port's scalar BFGS driver (solve.py: `optimize`,
`optimize_from_state`), its DFP and SR1 updates (ops/bfgs.py), the fleet's
``backend="vmap"`` (parallel/batch.py) and the ill-conditioned quadratic
(models/quadratic.py) against the JAX package's, on the same numpy inputs
in f64 on the CPU, mirroring tests/test_solve_rosenbrock.py and
tests/test_update_methods.py.

The reference sweep's n in {2, 5, 6, 17, 24, 60} (a subset: each JAX solve
compiles for seconds) must reach the same status and certificate in both
packages. Their counters are equal except where the trajectory is long
enough for rounding to part them: torch and XLA sum the dot products and
matvecs in different orders, and on Rosenbrock a 1-ulp difference grows
about tenfold every three iterations, so solves of a few hundred
iterations can end an iteration or two apart (`COUNTERS_PART`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
from quasinewtonmethods_jl_tpu.models import IllConditionedQuadratic as JaxQuadratic
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.ops import bfgs as jax_bfgs
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.models import (
    IllConditionedQuadratic,
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)
from quasinewtonmethods_jl_tpu_torch.ops import bfgs as port_bfgs
from quasinewtonmethods_jl_tpu_torch.utils import device as device_module

torch.set_num_threads(1)

EPS64 = float(np.finfo(np.float64).eps)
COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")
# (n, order) of the sweep whose counters part from JAX's by rounding (the
# module docstring): n = 17 (156 and 181 iterations), n = 24 order 3 (235)
# and n = 60 (425 and 452) end 1-4 iterations apart. The shorter solves,
# n = 2, 5, 6 and n = 24 order 2 (29-211 iterations), match in every
# counter.
COUNTERS_PART = {(17, 2), (17, 3), (24, 3), (60, 2), (60, 3)}


def counters(res):
    return [int(np.asarray(getattr(res, name))) for name in COUNTERS]


def assert_counters_equal(port, ref):
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


def _quad(n):
    def port(x):
        return -0.5 * torch.sum(torch.arange(1.0, n + 1.0, dtype=x.dtype) * x * x)

    def ref(x):
        return -0.5 * jnp.sum(jnp.arange(1.0, n + 1.0, dtype=x.dtype) * x * x)

    return port, ref


def test_result_layout_and_exports_match_jax():
    assert qt.OptimizeResult._fields == qj.OptimizeResult._fields
    assert port_bfgs.SR1_SKIP_TOL == jax_bfgs.SR1_SKIP_TOL
    for name in ("optimize", "optimize_from_state", "dfp_update", "sr1_update"):
        assert name in qt.__all__


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("n", [2, 5, 6, 17, 24, 60])
def test_rosenbrock_sweep_matches_jax(n, order, rng):
    """tests/test_solve_rosenbrock.py:25-40 with h0_scale=False (the
    reference's exact semantics), both packages on one start."""
    x0 = rng.standard_normal(n)
    ls = dict(h0_scale=False)
    port = qt.optimize(rosenbrock_logdensity, torch.tensor(x0), ls=qt.BackTracking(order=order),
                       **ls)
    ref = qj.optimize(jax_rosenbrock, jnp.asarray(x0), ls=qj.BackTracking(order=order), **ls)
    assert int(port.status) == int(ref.status) == qt.Status.CONVERGED
    assert abs(float(port.fun)) < 2 * EPS64
    assert float(port.grad.abs().max()) < 1e-8
    np.testing.assert_allclose(port.x.numpy(), 1.0, rtol=1e-5)
    if (n, order) in COUNTERS_PART:
        assert abs(int(port.iterations) - int(ref.iterations)) <= 5
    else:
        assert counters(port) == counters(ref)
        np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)


@pytest.mark.parametrize("max_iterations", [0, 1, 2, 7, 15])
def test_short_horizon_matches_jax_exactly(rng, max_iterations):
    """Over a few iterations every counter and the state match JAX's, with
    the default H0 scaling and the analytic gradient."""
    x0 = rng.standard_normal(24)
    port = qt.optimize(rosenbrock_logdensity, torch.tensor(x0), max_iterations=max_iterations,
                       value_and_grad_fn=rosenbrock_value_and_grad)
    ref = qj.optimize(jax_rosenbrock, jnp.asarray(x0), max_iterations=max_iterations)
    assert counters(port) == counters(ref)
    for field in ("x", "grad", "grad_old", "step", "B", "fun", "fresh", "stall"):
        np.testing.assert_allclose(getattr(port.state, field).numpy(),
                                   np.asarray(getattr(ref.state, field)), rtol=1e-9, atol=1e-9,
                                   err_msg=field)


def _spd(rng, n):
    A = rng.standard_normal((n, n)) * 0.3
    return A @ A.T + np.eye(n)


@pytest.mark.parametrize("fresh", [None, True, False])
@pytest.mark.parametrize("method", ["bfgs", "dfp", "sr1"])
def test_updates_match_jax(rng, method, fresh):
    """tests/test_update_methods.py's pair, with and without the H0
    scaling; and the secant equation B_new y = s."""
    n = 7
    B = _spd(rng, n)
    s = rng.standard_normal(n) * 0.1
    y = s + 0.02 * rng.standard_normal(n)
    g = rng.standard_normal(n)
    gold = g + y
    port_fn = getattr(port_bfgs, f"{method}_update")
    jax_fn = getattr(jax_bfgs, f"{method}_update")
    kw_t = {} if fresh is None else {"fresh": torch.tensor(fresh)}
    kw_j = {} if fresh is None else {"fresh": jnp.asarray(fresh)}
    port = port_fn(torch.tensor(B), torch.tensor(s), torch.tensor(g), torch.tensor(gold), **kw_t)
    ref = jax_fn(jnp.asarray(B), jnp.asarray(s), jnp.asarray(g), jnp.asarray(gold), **kw_j)
    for name, a, b in zip(("B", "d", "m"), port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12, err_msg=name)
    if fresh is None:
        np.testing.assert_allclose(port[0].numpy() @ y, s, atol=1e-10)


def test_sr1_skip_and_degenerate_pairs_match_jax(rng):
    """The SR1 skip (u ⟂ y: B unchanged and finite) and sᵀy = 0 (NaN m for
    BFGS and DFP, the in-band failure) in both packages."""
    n = 5
    B = _spd(rng, n)
    g = rng.standard_normal(n)
    y = rng.standard_normal(n)
    v = rng.standard_normal(n)
    w = v - (v @ y) / (y @ y) * y
    cases = {"sr1 skip": ("sr1", B @ y + w), "bfgs sty=0": ("bfgs", np.zeros(n)),
             "dfp sty=0": ("dfp", np.zeros(n))}
    for label, (method, s) in cases.items():
        port = getattr(port_bfgs, f"{method}_update")(
            torch.tensor(B), torch.tensor(s), torch.tensor(g), torch.tensor(g + y))
        ref = getattr(jax_bfgs, f"{method}_update")(
            jnp.asarray(B), jnp.asarray(s), jnp.asarray(g), jnp.asarray(g + y))
        for a, b in zip(port, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12,
                                       err_msg=label)
        if method == "sr1":
            assert torch.equal(port[0], torch.tensor(B)) and bool(torch.isfinite(port[2]))
        else:
            assert bool(torch.isnan(port[2]))


@pytest.mark.parametrize("update_method", ["dfp", "sr1"])
def test_driver_update_methods_match_jax(rng, update_method):
    """tests/test_update_methods.py:101-110: the concave quadratic in
    every counter, and Rosenbrock over a short horizon."""
    port_f, jax_f = _quad(10)
    x0 = rng.standard_normal(10)
    port = qt.optimize(port_f, torch.tensor(x0), update_method=update_method)
    ref = qj.optimize(jax_f, jnp.asarray(x0), update_method=update_method)
    assert counters(port) == counters(ref)
    assert int(port.status) == qt.Status.CONVERGED
    np.testing.assert_allclose(port.x.numpy(), 0.0, atol=1e-8)
    x0 = rng.standard_normal(6) * 0.5
    port = qt.optimize(rosenbrock_logdensity, torch.tensor(x0), update_method=update_method,
                       max_iterations=12)
    ref = qj.optimize(jax_rosenbrock, jnp.asarray(x0), update_method=update_method,
                      max_iterations=12)
    assert counters(port) == counters(ref)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)


def test_optimize_from_state_of_a_numpy_jax_state(rng):
    """A JAX state saved as numpy resumes in the port as in JAX: re-armed,
    counters continuing, ``max_iterations`` bounding the lifetime k."""
    x0 = rng.standard_normal(10)
    part = qj.optimize(jax_rosenbrock, jnp.asarray(x0), max_iterations=5)
    saved = jax.tree_util.tree_map(np.asarray, part.state)
    state = qt.bfgs_state_from_numpy(saved, torch.device("cpu"))
    for cap in (7, qt.MAX_ITERATIONS_DEFAULT):
        port = qt.optimize_from_state(rosenbrock_logdensity, state, max_iterations=cap)
        ref = qj.optimize_from_state(jax_rosenbrock, part.state, max_iterations=cap)
        assert counters(port) == counters(ref)
        np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)
    assert int(port.status) == qt.Status.CONVERGED
    # the resume leaves its state unchanged
    assert torch.equal(state.x, torch.tensor(saved.x)) and int(state.status) == 2


def test_resume_of_a_converged_state_re_arms_it(rng):
    res = qt.optimize(rosenbrock_logdensity, torch.tensor(rng.standard_normal(8)), tol=1e-3)
    tight = qt.optimize_from_state(rosenbrock_logdensity, res.state, tol=1e-10)
    assert int(res.status) == int(tight.status) == qt.Status.CONVERGED
    assert int(tight.iterations) > int(res.iterations)
    assert float(tight.grad.abs().max()) < 1e-10


def test_optimize_batched_vmap_matches_jax_vmap(rng):
    """backend='vmap' (the scalar driver lane by lane) against JAX's
    ``jax.vmap`` of its scalar driver: every counter and the state."""
    X0 = rng.standard_normal((6, 5))
    port = qt.optimize_batched(rosenbrock_logdensity, torch.tensor(X0), backend="vmap")
    ref = qj.optimize_batched(jax_rosenbrock, jnp.asarray(X0), backend="vmap")
    assert_counters_equal(port, ref)
    assert (port.status == qt.Status.CONVERGED).all()
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)
    assert port.state.B.shape == (6, 5, 5)
    # and lane by lane the fused engine's statuses and certificate
    fused = qt.optimize_batched(rosenbrock_logdensity, torch.tensor(X0), backend="fused")
    assert torch.equal(fused.status, port.status)


def test_quadratic_model_with_jax_x_star_matches_jax(rng):
    """models/quadratic.py with the JAX model's x_star carried across: the
    same spectrum, and the same solve (bench_full.py config 2 at n = 64)."""
    ref_model = JaxQuadratic(64, condition=1e4)
    model = IllConditionedQuadratic(64, condition=1e4, x_star=np.asarray(ref_model.x_star))
    np.testing.assert_allclose(model.diag.numpy(), np.asarray(ref_model.diag), rtol=1e-14)
    x0 = rng.standard_normal(64)
    theta = torch.tensor(x0)
    np.testing.assert_allclose(float(model.logdensity(theta)),
                               float(ref_model.logdensity(jnp.asarray(x0))), rtol=1e-13)
    port = qt.optimize(model, theta, max_iterations=5000)
    ref = qj.optimize(ref_model, jnp.asarray(x0), max_iterations=5000)
    assert int(port.status) == int(ref.status) == qt.Status.CONVERGED
    assert abs(int(port.iterations) - int(ref.iterations)) <= 3
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref_model.x_star), atol=2e-4)
    # without an x_star the port draws its own, the same for a seed
    a, b = IllConditionedQuadratic(8, seed=3), IllConditionedQuadratic(8, seed=3)
    assert torch.equal(a.x_star, b.x_star) and not torch.equal(a.x_star, model.x_star[:8])


def test_quadratic_model_follows_the_point_it_is_evaluated_at(monkeypatch, rng):
    """A model built with the defaults (CPU, float64) serves a solve whose
    numpy x0 lands on the card in float32: its tensors follow theta's
    device and dtype. The card is pretended (this torch has no CUDA), so
    the "card" tensors stay on the CPU and only the dtype shows."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    real = torch.as_tensor
    seen = []

    def as_tensor(data, *args, device=None, **kw):
        seen.append(str(device))
        return real(data, *args, **kw)

    monkeypatch.setattr(device_module.torch, "as_tensor", as_tensor)
    model = IllConditionedQuadratic(16, condition=1e2)
    res = qt.optimize(model, rng.standard_normal(16), tol=1e-3)
    assert seen == ["cuda"]
    assert res.x.dtype == res.fun.dtype == res.grad.dtype == torch.float32
    assert int(res.status) == qt.Status.CONVERGED
    # the certificate, with the model's gradient at the result
    residual = model.diag.float() * (res.x - model.x_star.float())
    assert float(residual.abs().max()) < 1e-3
    theta = torch.zeros(16, dtype=torch.float32)
    assert model.logdensity(theta).dtype == model.logdensity_and_gradient(theta)[1].dtype \
        == torch.float32


def test_host_syncs_count_statuses_and_line_search_rounds(rng):
    """One read after the first evaluation, one per iteration, and the
    line search's: one per round plus the one that ends it. On the concave
    quadratic with H0 scaling every search accepts its first trial after
    the first iterations."""
    port_f, _ = _quad(6)
    qt.optimize.host_syncs = 0
    res = qt.optimize(port_f, torch.tensor(rng.standard_normal(6)))
    iters, fev = int(res.iterations), int(res.n_fev)
    # each iteration: its status read, and the search's rounds + 1 reads;
    # the search's trials are n_fev minus the counted top evaluations
    trials = fev - (iters + 1)
    assert qt.optimize.host_syncs == 1 + iters + trials
    # a resume also reads k, with the first status
    qt.optimize.host_syncs = 0
    again = qt.optimize_from_state(port_f, res.state, max_iterations=iters)
    assert int(again.iterations) == iters and qt.optimize.host_syncs == 1


def test_arguments_are_validated():
    x = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="update_method"):
        qt.optimize(rosenbrock_logdensity, x, update_method="broyden")
    with pytest.raises(ValueError, match="rank-1"):
        qt.optimize(rosenbrock_logdensity, torch.zeros((2, 3)))
    with pytest.raises(TypeError, match="BackTracking or a Wolfe"):
        qt.optimize(rosenbrock_logdensity, x, ls=object())
    batched = qt.optimize_batched_fused(rosenbrock_logdensity, torch.zeros((2, 3)),
                                        max_iterations=1)
    with pytest.raises(ValueError, match="single solve"):
        qt.optimize_from_state(rosenbrock_logdensity, batched.state)
    # no iteration budget: no evaluation
    res = qt.optimize(rosenbrock_logdensity, x, max_iterations=0)
    assert int(res.status) == qt.Status.MAX_ITERATIONS and int(res.n_fev) == 0


def test_wolfe_and_failure_paths_match_jax():
    """``ls=Wolfe()`` and the in-band exits: a NaN start (NONFINITE_VALUE,
    fun NaN) and a cliff the line search cannot cross (LINESEARCH_FAILURE,
    its re-evaluation of the unmoved x not counted)."""
    x0 = np.random.default_rng(3).standard_normal(8)
    port = qt.optimize(rosenbrock_logdensity, torch.tensor(x0), ls=qt.Wolfe())
    ref = qj.optimize(jax_rosenbrock, jnp.asarray(x0), ls=qj.Wolfe())
    assert int(port.status) == int(ref.status) == qt.Status.CONVERGED
    port = qt.optimize(rosenbrock_logdensity, torch.tensor(x0), ls=qt.Wolfe(), max_iterations=10)
    ref = qj.optimize(jax_rosenbrock, jnp.asarray(x0), ls=qj.Wolfe(), max_iterations=10)
    assert counters(port) == counters(ref)

    def cliff(x):
        return torch.where((x == 0.0).all(), torch.sum(x) + 1.0, torch.nan)

    def jax_cliff(x):
        return jnp.where(jnp.all(x == 0.0), jnp.sum(x) + 1.0, jnp.nan)

    for p_f, j_f, x in ((cliff, jax_cliff, np.zeros(3)),
                        (lambda x: torch.sum(x) * torch.nan, lambda x: jnp.sum(x) * jnp.nan,
                         np.ones(3))):
        port = qt.optimize(p_f, torch.tensor(x), ls=qt.BackTracking(iterations=20))
        ref = qj.optimize(j_f, jnp.asarray(x), ls=qj.BackTracking(iterations=20))
        assert counters(port) == counters(ref)
        assert np.isnan(float(port.fun))
        np.testing.assert_array_equal(port.x.numpy(), x)
