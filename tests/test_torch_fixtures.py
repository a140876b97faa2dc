"""The port's fixture models — Neal's funnel, the Gaussian mixture, the
Poisson GLM and the AR(1) state-space MAP (models/funnel.py, mixture.py,
poisson.py, statespace.py) — against the JAX package's, on the same numpy
data in float64 on the CPU: value and gradient, the mixture's moments and
mode weights, the AR(1)'s closed-form optimum, and the scalar `optimize`
and the fleet engine `optimize_batched` run on each, every counter equal.

The JAX models draw their data with ``jax.random``; each pair builds the
JAX model and then gives it the numpy data that the port's model takes as
arrays. Values and gradients agree to 1e-12 relative (the two sum in
another order); solver counters are equal and points within 1e-8, since a
last-bit difference stays a last-bit difference on these short, strictly
concave trajectories; the funnel's are chaotic in the last bit, and its
fleet is compared over short horizons and by status and optimum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
from quasinewtonmethods_jl_tpu import models as jm
from quasinewtonmethods_jl_tpu.batched_solve import (
    optimize_batched_fused as jax_optimize_batched_fused,
)
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch import models as tm

torch.set_num_threads(1)

COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")
FIXTURES = ("funnel", "mixture", "poisson", "ar1")


def fixture_pair(name, rng, n=None):
    """(port objective, JAX objective, n) on one numpy dataset."""
    if name == "funnel":
        n = n or 4
        return tm.funnel_logdensity, jm.funnel_logdensity, n
    if name == "mixture":
        n = n or 6
        means = 3.0 * rng.standard_normal((5, n))
        weights = rng.random(5) + 0.5
        sigmas = 1.0 + rng.random(5)
        return (tm.GaussianMixture(means, weights, sigmas),
                jm.GaussianMixture(jnp.asarray(means), jnp.asarray(weights), jnp.asarray(sigmas)),
                n)
    if name == "poisson":
        n = n or 7
        X = rng.standard_normal((60, n)) / np.sqrt(n)
        y = rng.poisson(np.exp(X @ (0.5 * rng.standard_normal(n)))).astype(np.float64)
        ref = jm.PoissonRegressionMAP(n, 60, prior_scale=3.0)
        ref.X, ref.y = jnp.asarray(X), jnp.asarray(y)
        return tm.PoissonRegressionMAP(n, 60, prior_scale=3.0, X=X, y=y), ref, n
    n = n or 5
    ref = jm.AR1DriftMAP(n, 12, obs_scale=0.7, prior_scale=4.0)
    port = tm.AR1DriftMAP(n, 12, obs_scale=0.7, prior_scale=4.0, A=np.asarray(ref.A),
                          ys=np.asarray(ref.ys), w_true=np.asarray(ref.w_true))
    return port, ref, n


def _logdensity(obj):
    return obj if callable(obj) and not hasattr(obj, "logdensity") else obj.logdensity


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("scale", [0.0, 1.0, 3.0])
def test_value_and_gradient_match_jax(rng, name, scale):
    port, ref, n = fixture_pair(name, rng)
    for _ in range(3):
        x = rng.standard_normal(n) * scale
        grad, value = torch.func.grad_and_value(_logdensity(port))(torch.tensor(x))
        jvalue, jgrad = jax.value_and_grad(_logdensity(ref))(jnp.asarray(x))
        np.testing.assert_allclose(float(value), float(jvalue), rtol=1e-12)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-12, atol=1e-12)


def test_funnel_at_its_mode():
    """θ* = (-4.5(n-1), 0, …): the gradient vanishes, the value is known."""
    for n in (2, 4, 10):
        v = -0.5 * tm.FUNNEL_V_STD**2 * (n - 1)
        theta = torch.zeros(n, dtype=torch.float64)
        theta[0] = v
        grad, value = torch.func.grad_and_value(tm.funnel_logdensity)(theta)
        assert float(grad.abs().max()) < 1e-12
        np.testing.assert_allclose(float(value), -v * v / 18 - 0.5 * (n - 1) * v, rtol=1e-14)
    assert tm.FUNNEL_V_STD == jm.FUNNEL_V_STD


def test_mixture_moments_and_mode_weights_match_jax(rng):
    port, ref, n = fixture_pair("mixture", rng)
    np.testing.assert_allclose(port.weights.numpy(), np.asarray(ref.weights), rtol=1e-15)
    np.testing.assert_allclose(port.mean().numpy(), np.asarray(ref.mean()), rtol=1e-13)
    np.testing.assert_allclose(port.cov().numpy(), np.asarray(ref.cov()), rtol=1e-13,
                               atol=1e-13)
    draws = 3.0 * rng.standard_normal((4, 25, n))
    np.testing.assert_allclose(port.mode_weights(draws).numpy(),
                               np.asarray(ref.mode_weights(jnp.asarray(draws))), rtol=1e-7)
    assert len(port) == port.dimension == n
    x = torch.tensor(rng.standard_normal(n))
    assert float(port(x)) == float(port.logdensity(x))


def test_mixture_arguments_match_jax():
    """Default uniform weights, a scalar sigma broadcast to every component,
    unnormalised weights normalised; means that are not (K, n) refused."""
    means = np.arange(6.0).reshape(3, 2)
    port = tm.GaussianMixture(means, weights=[1.0, 1.0, 2.0], sigmas=2.0)
    ref = jm.GaussianMixture(jnp.asarray(means), weights=jnp.asarray([1.0, 1.0, 2.0]), sigmas=2.0)
    np.testing.assert_allclose(port.weights.numpy(), np.asarray(ref.weights))
    np.testing.assert_allclose(port.sigmas.numpy(), np.asarray(ref.sigmas))
    uniform = tm.GaussianMixture(means)
    np.testing.assert_allclose(uniform.weights.numpy(), np.full(3, 1 / 3))
    assert uniform.logdensity(torch.zeros(2, dtype=torch.float32)).dtype == torch.float32
    with pytest.raises(ValueError, match=r"\(K, n\)"):
        tm.GaussianMixture(np.zeros(4))


def test_poisson_model_draws_and_placement():
    model = tm.PoissonRegressionMAP(6, 40, seed=3)
    assert model.X.shape == (40, 6) and model.y.shape == (40,) and model.n_obs == 40
    assert bool((model.y >= 0).all()) and bool((model.y == model.y.round()).all())
    again = tm.PoissonRegressionMAP(6, 40, seed=3)
    assert torch.equal(model.X, again.X) and torch.equal(model.y, again.y)
    value = model.logdensity(torch.zeros(6, dtype=torch.float32))  # follows the point's dtype
    assert value.dtype == torch.float32
    np.testing.assert_allclose(float(value), -40.0, rtol=1e-6)  # Σ (y·0 - e⁰)
    with pytest.raises(ValueError, match="both X and y"):
        tm.PoissonRegressionMAP(3, 5, X=np.zeros((5, 3)))
    with pytest.raises(ValueError, match="X must be"):
        tm.PoissonRegressionMAP(3, 5, X=np.zeros((5, 4)), y=np.zeros(5))


def test_ar1_map_solution_matches_jax_and_is_stationary(rng):
    port, ref, n = fixture_pair("ar1", rng)
    w_map = port.map_solution()
    np.testing.assert_allclose(w_map.numpy(), np.asarray(ref.map_solution()), rtol=1e-12,
                               atol=1e-12)
    grad = torch.func.grad(port.logdensity)(w_map)
    assert float(grad.abs().max()) < 1e-8


def test_ar1_model_draws_its_data_by_jax_recipe():
    model = tm.AR1DriftMAP(6, 20, spectral_radius=0.5, seed=4)
    assert model.A.shape == (6, 6) and model.ys.shape == (20, 6) and model.n_steps == 20
    radius = float(np.max(np.abs(np.linalg.eigvals(model.A.numpy()))))
    np.testing.assert_allclose(radius, 0.5, rtol=1e-12)
    again = tm.AR1DriftMAP(6, 20, spectral_radius=0.5, seed=4)
    assert torch.equal(model.A, again.A) and torch.equal(model.ys, again.ys)
    # the data are the recursion from z_0 = 0 plus noise of obs_scale
    z, zs = torch.zeros(6, dtype=torch.float64), []
    for _ in range(20):
        z = model.A @ z + model.w_true
        zs.append(z)
    noise = (model.ys - torch.stack(zs)) / model.obs_scale
    assert 0.5 < float(noise.std()) < 1.5
    with pytest.raises(ValueError, match="both A and ys"):
        tm.AR1DriftMAP(3, 4, A=np.eye(3))
    with pytest.raises(ValueError, match="A must be"):
        tm.AR1DriftMAP(3, 4, A=np.eye(2), ys=np.zeros((4, 3)))


def test_models_export_every_jax_name():
    assert set(tm.__all__) == set(jm.__all__)


# tol 1e-6: at 1e-8 the Poisson and AR(1) posteriors, whose |f*| is a large
# sum, sit on the f64 Armijo value test's floor (tests/test_statespace.py,
# tests/test_baseline_configs.py), where summation order decides the status.
@pytest.mark.parametrize("name", FIXTURES)
def test_scalar_optimize_on_fixtures_matches_jax(rng, name):
    port_obj, ref_obj, n = fixture_pair(name, rng)
    x0 = rng.standard_normal(n)
    port = qt.optimize(port_obj, torch.tensor(x0), tol=1e-6)
    ref = qj.optimize(ref_obj, jnp.asarray(x0), tol=1e-6)
    for name_ in ("status", "iterations", "n_fev", "n_gev"):
        assert int(getattr(port, name_)) == int(getattr(ref, name_)), name_
    assert int(port.status) == qt.Status.CONVERGED
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("name", FIXTURES)
def test_fleet_engine_on_fixtures_matches_jax(rng, name):
    """The fleet engine against JAX's (`optimize_batched_fused`, kernel
    "xla") over whole solves. The funnel's trajectories are chaotic in the
    last bit (its curvature reaches e^{13.5} at n = 4: started 1 ulp away,
    JAX's own fleet ends in other iteration counts on 4 of these 6 lanes),
    so there every counter is equal over 10 iterations and, over whole
    solves, the statuses and the optimum."""
    port_obj, ref_obj, n = fixture_pair(name, rng)
    X0 = rng.standard_normal((6, n))
    caps = (10, 3000) if name == "funnel" else (3000,)
    for cap in caps:
        port = qt.optimize_batched(port_obj, torch.tensor(X0), tol=1e-6, max_iterations=cap)
        ref = jax_optimize_batched_fused(ref_obj, jnp.asarray(X0), tol=1e-6, max_iterations=cap,
                                         kernel="xla")
        exact = COUNTERS if cap < 3000 or name != "funnel" else ("status",)
        for name_ in exact:
            np.testing.assert_array_equal(getattr(port, name_).numpy(),
                                          np.asarray(getattr(ref, name_)), err_msg=name_)
        atol = 1e-6 if name == "funnel" and cap == 3000 else 1e-8
        np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=atol, atol=atol)
    assert (port.status == qt.Status.CONVERGED).all()
