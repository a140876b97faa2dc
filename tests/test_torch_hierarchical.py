"""The port's hierarchical regression (models/hierarchical.py) against the
JAX package's, on the same data in float64 on the CPU, and the solvers on
its transformed model (``transform_objective(m, m.transform)``).

JAX draws the model's data with ``jax.random``, which torch cannot
reproduce: each pair builds JAX's model and hands its arrays (X, Z, group,
y, beta_true, u_true) to the port's. Log-density and gradient agree to
1e-12; the scalar `optimize` on the transformed model (JAX's
tests/test_transforms.py:368-384) and the fleet engine have every counter
equal to JAX's `optimize` and `optimize_batched_fused`; and the resident
engine's plain version (the fleet engine with the plain update on the same
objective, which B3 is held to on the card) matches JAX's resident kernel
run in interpret mode in statuses, iterations and resets, x within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
from quasinewtonmethods_jl_tpu import transforms as jt
from quasinewtonmethods_jl_tpu.batched_solve import (
    optimize_batched_fused as jax_optimize_batched_fused,
)
from quasinewtonmethods_jl_tpu.models import HierarchicalRegression as JaxHierarchical
from quasinewtonmethods_jl_tpu.resident_solve import (
    optimize_batched_resident as jax_optimize_batched_resident,
)
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch import transforms as tt
from quasinewtonmethods_jl_tpu_torch.models import HierarchicalRegression

torch.set_num_threads(1)

COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")
DATA = ("X", "Z", "group", "y", "beta_true", "u_true")


def model_pair(**kw):
    """(port model, JAX model) on JAX's data."""
    ref = JaxHierarchical(**kw)
    sizes = {k: kw[k] for k in ("n_groups", "q", "p", "n_obs", "lkj_eta") if k in kw}
    port = HierarchicalRegression(**sizes, **{k: np.asarray(getattr(ref, k)) for k in DATA})
    return port, ref


def close(port, ref, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("q", [2, 3])
def test_logdensity_gradient_and_parts_match_jax(rng, q):
    port, ref = model_pair(n_groups=5, q=q, p=3, n_obs=60, lkj_eta=2.5, seed=q)
    assert port.dimension == ref.dimension and port.group.dtype == torch.int64
    tport = tt.transform_objective(port, port.transform)
    tref = jt.transform_objective(ref, ref.transform)
    close(port.initial_point(), ref.initial_point())
    jax_grad, jax_vag = jax.jit(jax.grad(ref.logdensity)), jax.jit(tref.logdensity_and_gradient)
    for scale in (0.3, 1.0):
        z = scale * rng.standard_normal(tport.dimension)
        x = tport.constrain(torch.tensor(z))
        jx = tref.constrain(jnp.asarray(z))
        close(x, jx)
        for got, want in zip(port.split(x), ref.split(jx)):
            close(got, want)
        close(port.random_effects(x), ref.random_effects(jx))
        close(port.logdensity(x), ref.logdensity(jx))
        close(torch.func.grad(port.logdensity)(x), jax_grad(jx))
        value, grad = tport.logdensity_and_gradient(torch.tensor(z))
        jvalue, jgrad = jax_vag(jnp.asarray(z))
        close(value, jvalue)
        close(grad, jgrad)


def test_model_draws_its_data_by_jax_recipe():
    m = HierarchicalRegression(n_groups=6, q=3, p=2, n_obs=500, seed=7)
    again = HierarchicalRegression(n_groups=6, q=3, p=2, n_obs=500, seed=7)
    assert m.X.shape == (500, 2) and m.Z.shape == (500, 3) and m.y.shape == (500,)
    assert torch.equal(m.y, again.y) and torch.equal(m.group, again.group)
    assert bool((m.Z[:, 0] == 1).all()) and set(m.group.tolist()) == set(range(6))
    resid = m.y - m.X @ m.beta_true - torch.sum(m.Z * m.u_true[m.group], dim=1)
    assert 0.4 < float(resid.std()) < 0.6  # the noise of sigma_true 0.5
    f32 = HierarchicalRegression(n_groups=6, q=3, p=2, n_obs=500, seed=7, dtype=torch.float32)
    assert f32.X.dtype == f32.initial_point().dtype == torch.float32
    with pytest.raises(ValueError, match="X, Z, group and y"):
        HierarchicalRegression(X=np.zeros((4, 3)))
    with pytest.raises(ValueError, match="Z \\(n_obs, 2\\)"):
        HierarchicalRegression(q=2, p=3, X=np.zeros((4, 3)), Z=np.zeros((4, 3)),
                               group=np.zeros(4, dtype=np.int64), y=np.zeros(4))


def test_scalar_optimize_on_the_transformed_model_matches_jax():
    """JAX's tests/test_transforms.py:368-384 on both packages, at tol 1e-6:
    at JAX's 1e-8 the solve reaches float64's Armijo floor (|f| = 74, the
    two gradients 4e-14 apart there, summed in other orders), where
    rounding decides the last steps: JAX's converges in 72 iterations,
    the port's ends LINESEARCH_FAILURE in 96 with max|g| 2.8e-8."""
    port, ref = model_pair(n_groups=6, q=2, p=3, n_obs=400, seed=3)
    tport = tt.transform_objective(port, port.transform)
    tref = jt.transform_objective(ref, ref.transform)
    z0 = tref.unconstrain(ref.initial_point())
    res = qt.optimize(tport, torch.tensor(np.asarray(z0)), tol=1e-6, max_iterations=2000)
    jres = qj.optimize(tref, z0, tol=1e-6, max_iterations=2000)
    assert int(res.status) == int(qt.Status.CONVERGED)
    for f in COUNTERS:
        assert int(getattr(res, f)) == int(getattr(jres, f)), f
    close(res.x, jres.x, rtol=1e-8, atol=1e-10)
    beta, _, tau, sigma, L = port.split(tport.constrain(res.x))
    close(beta, ref.beta_true, rtol=0, atol=0.15)
    assert 0.3 < float(sigma) < 0.8 and bool((tau > 0).all())
    close(torch.diagonal(L @ L.T), np.ones(2), rtol=1e-10)


def fleet(seed=4):
    """JAX's model of the resident check (4 groups, q = 3, p = 2, 64
    observations), its transformed pair and 8 starts around the initial
    point, from numpy."""
    port, ref = model_pair(n_groups=4, q=3, p=2, n_obs=64, seed=seed)
    tport = tt.transform_objective(port, port.transform)
    tref = jt.transform_objective(ref, ref.transform)
    z0 = np.asarray(tref.unconstrain(ref.initial_point()))
    starts = z0 + 0.5 * np.random.default_rng(seed).standard_normal((8, z0.shape[0]))
    return tport, tref, starts


def test_fleet_engine_matches_jax():
    """tol 1e-5: at 1e-6 one lane's last line search takes one trial more
    in JAX's run (a value test on float64's floor)."""
    tport, tref, starts = fleet()
    res = qt.optimize_batched(tport, torch.tensor(starts), tol=1e-5)
    jres = jax_optimize_batched_fused(tref, jnp.asarray(starts), tol=1e-5, kernel="xla")
    for f in COUNTERS:
        assert np.array_equal(getattr(res, f).numpy(), np.asarray(getattr(jres, f))), f
    close(res.x, jres.x, rtol=1e-6, atol=1e-9)


def test_resident_plain_version_matches_jax_interpret_mode():
    """The port's resident engine on the CPU runs B3's plain version on the
    traced transformed model; JAX's runs its resident kernel in interpret
    mode (block_batch 4)."""
    tport, tref, starts = fleet()
    res = qt.optimize_batched_resident(tport, torch.tensor(starts), tol=1e-6)
    jres = jax_optimize_batched_resident(tref, jnp.asarray(starts), tol=1e-6, block_batch=4,
                                         interpret=True)
    for f in ("status", "iterations", "n_resets"):
        assert np.array_equal(getattr(res, f).numpy(), np.asarray(getattr(jres, f))), f
    close(res.x, jres.x, rtol=1e-6, atol=1e-9)
