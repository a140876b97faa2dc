"""`sample_sharded` on all six samplers and `map_then_sample(mesh=)`, on a
module-scoped pool of 4 gloo ranks (tests/torch_mesh_ranks.py), in f64.

Each rank draws the whole fleet's noise from the key and keeps its chains'
rows, and what a sampler averages over the fleet is taken over the
gathered fleet: so a sharded run equals the unsharded port run chain for
chain (HMC's bar in JAX's tests/test_mesh.py is 1e-6; here it holds
exactly). The JAX package's noise is not the port's, so the samplers with
fleet adaptation are held to JAX's moment bars (tests/test_mesh.py,
test_tempering.py, test_ensemble.py, test_mclmc.py) and to an adapted
state; the refusals carry JAX's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
from quasinewtonmethods_jl_tpu.parallel import make_mesh as jax_make_mesh
import quasinewtonmethods_jl_tpu_torch as qt
from torch_mesh_ranks import RankPool, _plain, gauss_logdensity

torch.set_num_threads(1)

SHARDS = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = RankPool(SHARDS, tmp_path_factory.mktemp("mesh_sampling_ranks"))
    yield ranks
    ranks.close()


def one_answer(answers):
    for other in answers[1:]:
        np.testing.assert_equal(other, answers[0])
    return answers[0]


def assert_same_run(port, un, path="result"):
    """Leaf for leaf: integers and flags equal, floats to rounding (a mean
    over draws of one chain's column sums in another order when the fleet
    is narrower)."""
    if isinstance(un, dict):
        assert port.keys() == un.keys(), path
        for k in un:
            assert_same_run(port[k], un[k], f"{path}.{k}")
    elif isinstance(un, np.ndarray) and np.issubdtype(un.dtype, np.floating):
        np.testing.assert_allclose(port, un, rtol=1e-13, atol=1e-15, err_msg=path)
    else:
        np.testing.assert_equal(port, un, err_msg=path)


def sharded_and_unsharded(pool, sampler, key, x0s, kw):
    """The pool's sharded run and the port's unsharded run of the same
    call, which must be the same run."""
    pool.start("sample", sampler, key, x0s, kw)
    un = _plain(qt.sampling.get_sampler(sampler)(gauss_logdensity, key, torch.tensor(x0s),
                                                 **kw))
    port = one_answer(pool.wait())
    assert_same_run(port, un)
    return port


def test_hmc_sharded_equals_unsharded(pool, rng):
    x0s = rng.standard_normal((16, 3))
    port = sharded_and_unsharded(pool, "hmc", 0, x0s,
                                 dict(n_samples=40, n_warmup=20, n_leapfrog=4))
    assert port["samples"].shape == (40, 16, 3)


def test_chees_sharded_fleet_adaptation(pool):
    """The ChEES gradient's means, the fleet-mean acceptance and the fleet
    mass are taken over all chains (JAX's test's moments, R-hat and an
    adapted step)."""
    chains, n = 32, 2
    port = sharded_and_unsharded(pool, "chees", 1, np.zeros((chains, n)),
                                 dict(n_samples=400, n_warmup=300))
    draws = port["samples"].reshape(-1, n)
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.12)
    np.testing.assert_allclose(draws.var(axis=0), 1.0, atol=0.2)
    assert float(port["step_size"]) > 0.0
    assert np.all(qt.diagnose_chains(port["samples"]).rhat < 1.1)


def test_nuts_sharded_trees_decide_on_the_whole_fleet(pool):
    port = sharded_and_unsharded(pool, "nuts", 2, np.zeros((16, 2)),
                                 dict(n_samples=300, n_warmup=200, max_depth=5))
    np.testing.assert_allclose(port["samples"].reshape(-1, 2).var(axis=0), 1.0, atol=0.25)
    assert np.all(port["step_size"] > 0.0)


def test_pt_sharded_per_temperature_acceptance_over_all_chains(pool):
    n, chains = 4, 32
    port = sharded_and_unsharded(pool, "pt", 0, np.zeros((chains, n)),
                                 dict(n_temps=4, beta_min=0.2, n_samples=300, n_warmup=150,
                                      n_leapfrog=8))
    draws = port["samples"].reshape(-1, n)
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(draws.var(axis=0), 1.0, atol=0.15)
    # per-temperature adaptation worked on every rung
    assert np.all((port["accept_rate"] > 0.4) & (port["accept_rate"] < 0.99))
    assert port["state"]["x"].shape == (4, chains, n)


@pytest.mark.parametrize("partner", ["gather", "shift"])
def test_ensemble_sharded_halves_move_against_the_whole_other_half(pool, partner):
    """Each rank's walkers move against the whole other half; with 4 ranks
    over 32 walkers, ranks 0-1 hold half A and ranks 2-3 half B."""
    x0s = np.random.default_rng(0).standard_normal((32, 3))
    port = sharded_and_unsharded(pool, "ensemble", 0, x0s,
                                 dict(n_samples=1000, n_warmup=200, partner=partner))
    draws = port["samples"].reshape(-1, 3)
    np.testing.assert_allclose(draws.mean(0), 0.0, atol=0.08)
    np.testing.assert_allclose(np.cov(draws.T), np.eye(3), atol=0.12)


def test_mclmc_sharded_warmup_tunes_on_the_fleet(pool):
    n, chains = 4, 32
    x0 = np.random.default_rng(3).standard_normal((chains, n))
    port = sharded_and_unsharded(pool, "mclmc", 0, x0, dict(n_samples=400, n_warmup=200))
    draws = port["samples"].reshape(-1, n)
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.12)
    np.testing.assert_allclose(draws.var(axis=0), 1.0, atol=0.2)
    assert float(port["energy_var"]) < 5e-4 * 4
    assert int(port["divergences"].sum()) == 0


def _jax_message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_sample_sharded_refusals_carry_jax_messages(pool):
    port = one_answer(pool.run("sample_refusals"))
    mesh = jax_make_mesh({"data": SHARDS})
    x = jnp.zeros((16, 2))
    ref = {
        "sampler": _jax_message(lambda: qj.parallel.sample_sharded(
            lambda v: -jnp.sum(v * v), jax.random.PRNGKey(0), x, mesh, sampler="slice")),
        "divide": _jax_message(lambda: qj.parallel.sample_sharded(
            lambda v: -jnp.sum(v * v), jax.random.PRNGKey(0), x[:10], mesh)),
    }
    assert port == ref


@pytest.mark.parametrize("route", [
    dict(map_engine="bfgs", sampler="chees"),
    dict(map_engine="lbfgs", sampler="hmc", polish_steps=1),
    dict(map_engine="tr", sampler="nuts", max_depth=4),
])
def test_map_then_sample_mesh_equals_unsharded(pool, route):
    """The MAP fleet and polish run on each rank's chains and are gathered,
    the handoff runs on the whole fleet, the sampler on each rank's chains:
    the same MAP statuses, the same sampler inputs and the same draws as
    the unsharded run."""
    x0 = np.array([0.3, -0.2, 0.5])
    kw = dict(n_chains=16, n_samples=40, n_warmup=30, **route)
    pool.start("workflow", 5, x0, kw)
    un = qt.map_then_sample(gauss_logdensity, 5, torch.tensor(x0), **kw)
    port = one_answer(pool.wait())
    np.testing.assert_equal(port["map_status"], un.map_result.status.numpy())
    np.testing.assert_equal(port["map_iterations"], un.map_result.iterations.numpy())
    assert_same_run(port, {"map_status": un.map_result.status.numpy(),
                           "map_iterations": un.map_result.iterations.numpy(),
                           "map_x": un.map_result.x.numpy(), "x_map": un.x_map.numpy(),
                           "mass": _plain(un.mass), "chains": un.sampler_result.state.x.numpy(),
                           "samples": un.samples.numpy(), "rhat": un.diagnostics.rhat})


def test_map_then_sample_mesh_refusals_carry_jax_messages(pool):
    port = one_answer(pool.run("workflow_refusals"))
    mesh = jax_make_mesh({"data": SHARDS})
    logd = lambda v: -0.5 * jnp.sum(v * v)  # noqa: E731
    x0 = jnp.zeros(2)
    ref = {
        "depth_sort": _jax_message(lambda: qj.map_then_sample(
            logd, jax.random.PRNGKey(0), x0, n_chains=8, sampler="nuts", n_samples=4,
            n_warmup=4, depth_sort=True, mesh=mesh)),
        "divide": _jax_message(lambda: qj.map_then_sample(
            logd, jax.random.PRNGKey(0), x0, n_chains=6, n_samples=4, n_warmup=4,
            mesh=mesh)),
    }
    assert port == ref
