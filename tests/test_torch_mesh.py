"""The port's device mesh (parallel/mesh.py, parallel/distributed.py) and
its data-parallel fleets, held to the JAX package's on conftest's virtual
CPU devices at the same shard count (4), in f64.

The port runs one process per device: a module-scoped pool of 4 gloo
ranks (tests/torch_mesh_ranks.py, a FileStore under tmp_path) runs each
entry point as every rank of a user's script would, and each rank returns
the whole result. The bars are JAX's own (tests/test_mesh.py): statuses,
iterations and counters equal, x to JAX's atol; and against the unsharded
port engine, lane for lane equality, since the lanes are independent.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.parallel import make_mesh as jax_make_mesh
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity
from quasinewtonmethods_jl_tpu_torch.parallel import distributed, make_mesh
from torch_mesh_ranks import RankPool, diag_quadratic, exp_residual, quad_logdensity

torch.set_num_threads(1)

SHARDS = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = RankPool(SHARDS, tmp_path_factory.mktemp("mesh_ranks"))
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh({"data": SHARDS})


def jax_quad(x):
    diag = jnp.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype)
    return -0.5 * jnp.sum(diag * x * x)


def one_answer(answers):
    """The ranks' answers, which must be the same whole result on every
    rank (global in, global out), as one."""
    for other in answers[1:]:
        np.testing.assert_equal(other, answers[0])
    return answers[0]


def assert_lanes_equal(port, ref, fields):
    for f in fields:
        np.testing.assert_array_equal(port[f], np.asarray(getattr(ref, f)), err_msg=f)


def test_pool_ranks_import_no_jax(pool):
    assert pool.jax_loaded == [False] * SHARDS


def test_mesh_layout_and_process_group(pool):
    answers = pool.run("mesh_layout")
    for rank, a in enumerate(answers):
        assert a["flat_shape"] == {"data": 4} and a["flat_index"] == rank
        assert a["grid_shape"] == {"data": 2, "model": 2}
        assert a["grid_index"] == (rank // 2, rank % 2)
        # ranks 0,1 | 2,3 share a data line's partner along 'model', and so on
        np.testing.assert_array_equal(a["psum_model"], [2 * (rank // 2) * 2 + 3])
        np.testing.assert_array_equal(a["psum_data"], [(rank % 2) * 2 + 4])
        assert a["host_count"] == 4 and a["process_index"] == rank and a["is_distributed"]
        assert a["too_big"].startswith("mesh needs 1024 devices, have 4")
    assert jax_make_mesh({"data": 4, "model": 2}).shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="mesh needs 1024 devices"):
        jax_make_mesh({"data": 1024})


def test_one_process_is_a_one_device_mesh(rng):
    """Without a process group: initialize() is a no-op, the topology is
    one host, a {'data': 1} mesh works and runs the unsharded fleet, and a
    larger mesh raises."""
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert (distributed.host_count(), distributed.process_index()) == (1, 0)
    assert not distributed.is_distributed()
    mesh = make_mesh({"data": 1})
    assert mesh.shape == {"data": 1}
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        make_mesh({"data": 2})
    x0 = torch.tensor(rng.standard_normal((8, 4)))
    sh = qt.parallel.optimize_batched_sharded(rosenbrock_logdensity, x0, mesh)
    un = qt.optimize_batched_fused(rosenbrock_logdensity, x0)
    for a, b in zip(sh, un):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_batched_sharded_matches_jax_and_unsharded(pool, jax_mesh, rng):
    x0 = rng.standard_normal((32, 6))
    pool.start("batched", x0, {})
    ref = qj.parallel.optimize_batched_sharded(jax_rosenbrock, jnp.asarray(x0), jax_mesh,
                                               kernel="xla")
    un = qt.optimize_batched_fused(rosenbrock_logdensity, torch.tensor(x0))
    port = one_answer(pool.wait())
    assert np.all(port["status"] == int(qt.Status.CONVERGED))
    assert_lanes_equal(port, ref, ["status", "iterations", "n_fev", "n_gev", "n_resets"])
    np.testing.assert_allclose(port["x"], np.asarray(ref.x), atol=1e-9)
    for f in ("x", "iterations", "n_fev", "state"):
        np.testing.assert_equal(port[f], qt_plain(getattr(un, f)))


def qt_plain(value):
    from torch_mesh_ranks import _plain

    return _plain(value)


@pytest.mark.parametrize("precondition", [None, "jacobi"])
def test_tr_sharded_matches_jax_and_unsharded(pool, jax_mesh, rng, precondition):
    """The inner Steihaug loop runs while any lane of the whole fleet is in
    it, and its count enters every active lane's n_hev: n_hev equal to
    JAX's partitioned program is the test that the count is fleet-wide."""
    if precondition is None:
        x0 = rng.standard_normal((16, 6))
        obj, arg, jobj = "rosenbrock", None, jax_rosenbrock
    else:
        d = np.geomspace(1.0, 1e3, 8)
        x0 = rng.standard_normal((16, 8))
        obj, arg = "diag", d
        jobj = lambda x: -0.5 * jnp.sum(jnp.asarray(d) * x * x)  # noqa: E731
    kw = {} if precondition is None else {"precondition": precondition}
    pool.start("tr_fleet", obj, arg, x0, kw)
    ref = qj.parallel.optimize_tr_sharded(jobj, jnp.asarray(x0), jax_mesh, **kw)
    tobj = rosenbrock_logdensity if arg is None else diag_quadratic(arg)
    un = qt.optimize_tr(tobj, torch.tensor(x0), **kw)
    port = one_answer(pool.wait())
    assert np.all(port["status"] == int(qt.Status.CONVERGED))
    assert_lanes_equal(port, ref, ["status", "iterations", "n_fev", "n_hev"])
    np.testing.assert_allclose(port["x"], np.asarray(ref.x), atol=1e-9)
    np.testing.assert_equal(port, qt_plain(un))


def test_cg_sharded_matches_jax_and_unsharded(pool, jax_mesh, rng):
    x0 = rng.standard_normal((16, 6))
    pool.start("cg_fleet", "quad", None, x0, {"tol": 1e-8})
    ref = qj.parallel.optimize_cg_sharded(jax_quad, jnp.asarray(x0), jax_mesh, tol=1e-8)
    un = qt.optimize_cg(quad_logdensity, torch.tensor(x0), tol=1e-8)
    port = one_answer(pool.wait())
    assert np.all(port["status"] == int(qt.Status.CONVERGED))
    assert_lanes_equal(port, ref, ["status", "iterations", "n_fev", "n_gev", "n_resets"])
    np.testing.assert_allclose(port["x"], np.asarray(ref.x), rtol=0, atol=1e-12)
    np.testing.assert_equal(port, qt_plain(un))


def test_cg_sharded_jacobi_fleet_equals_unsharded(pool, rng):
    """The Jacobi flavour on a coupled objective, whose probes' estimate
    depends on the probe: the sharded fleet's probes, keyed by the fleet's
    largest iteration count, are the unsharded run's."""
    x0 = rng.standard_normal((16, 6)) * 0.5
    kw = {"tol": 1e-6, "precondition": "jacobi", "max_iterations": 40}
    pool.start("cg_fleet", "rosenbrock", None, x0, kw)
    un = qt.optimize_cg(rosenbrock_logdensity, torch.tensor(x0), **kw)
    port = one_answer(pool.wait())
    np.testing.assert_equal(port, qt_plain(un))


def test_auglag_sharded_per_lane_data_matches_jax(pool, jax_mesh):
    n, B = 4, 16
    r2s = np.linspace(1.0, 30.0, B)
    X0 = np.full((B, n), 0.1)
    pool.start("auglag_disk", X0, r2s)
    ref = qj.parallel.optimize_auglag_sharded(
        lambda z: -jnp.sum((z - 2.0) ** 2), jnp.asarray(X0), jax_mesh,
        ineq=lambda z, r2: r2 - jnp.sum(z * z), constraint_data=jnp.asarray(r2s))
    un = qt.optimize_auglag(lambda z: -torch.sum((z - 2.0) ** 2), torch.tensor(X0),
                            ineq=lambda z, r2: r2 - torch.sum(z * z),
                            constraint_data=torch.tensor(r2s))
    port = one_answer(pool.wait())
    assert np.all(port["status"] == int(qt.Status.CONVERGED))
    np.testing.assert_allclose(port["x"], np.asarray(ref.x), rtol=1e-7, atol=1e-9)
    assert_lanes_equal(port, ref, ["n_outer", "status"])
    np.testing.assert_equal(port, qt_plain(un))


def _lm_fixture(rng, batch=32, m=24):
    ts = np.tile(np.linspace(0.0, 1.0, m), (batch, 1))
    true = np.stack([rng.uniform(0.5, 2.0, batch), rng.uniform(-2.0, -0.5, batch)], axis=1)
    ys = true[:, :1] * np.exp(true[:, 1:] * ts)
    return np.tile([1.0, 0.0], (batch, 1)), ts, ys, true


def jax_exp_residual(p, d):
    t, y = d
    return p[..., 0:1] * jnp.exp(p[..., 1:2] * t) - y


@pytest.mark.parametrize("boxed", [False, True])
def test_least_squares_sharded_matches_jax_and_unsharded(pool, jax_mesh, rng, boxed):
    """Per-lane data is cut with its lanes; a broadcastable box is shared."""
    x0, ts, ys, true = _lm_fixture(rng)
    kw = dict(loss="soft_l1", f_scale=0.5, tol=1e-7) if boxed else {}
    bounds = (np.asarray([0.0, -1.0]), np.asarray([5.0, 5.0])) if boxed else None
    pool.start("lsq_fleet", x0, ts, ys, bounds, kw)
    jb = None if bounds is None else tuple(jnp.asarray(b) for b in bounds)
    ref = qj.parallel.least_squares_sharded(jax_exp_residual, jnp.asarray(x0), jax_mesh,
                                            data=(jnp.asarray(ts), jnp.asarray(ys)), bounds=jb,
                                            **kw)
    tb = None if bounds is None else tuple(torch.tensor(b) for b in bounds)
    un = qt.least_squares(exp_residual, torch.tensor(x0), data=(torch.tensor(ts),
                                                                torch.tensor(ys)),
                          bounds=tb, **kw)
    port = one_answer(pool.wait())
    assert np.all(port["status"] == int(qt.Status.CONVERGED))
    assert_lanes_equal(port, ref, ["status", "iterations", "n_fev", "n_jev"])
    np.testing.assert_allclose(port["x"], np.asarray(ref.x), atol=1e-12)
    np.testing.assert_equal(port, qt_plain(un))
    if boxed:  # the rate bound at -1 binds where the true rate is below it
        np.testing.assert_allclose(port["x"][true[:, 1] < -1.0, 1], -1.0, atol=1e-12)
    else:
        np.testing.assert_allclose(port["x"], true, atol=1e-6)


def _jax_message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_fleet_refusals_carry_jax_messages(pool, jax_mesh):
    port = one_answer(pool.run("fleet_refusals"))
    P, z = qj.parallel, jnp.zeros
    ref = {
        "batched": _jax_message(lambda: P.optimize_batched_sharded(jax_quad, z((6, 4)),
                                                                   jax_mesh)),
        "tr": _jax_message(lambda: P.optimize_tr_sharded(jax_quad, z((6, 4)), jax_mesh)),
        "tr_rank": _jax_message(lambda: P.optimize_tr_sharded(jax_quad, z(4), jax_mesh)),
        "cg": _jax_message(lambda: P.optimize_cg_sharded(jax_quad, z((6, 4)), jax_mesh)),
        "auglag": _jax_message(lambda: P.optimize_auglag_sharded(
            lambda x: -jnp.sum(x * x), z((10, 4)), jax_mesh,
            ineq=lambda x: 1.0 - jnp.sum(x * x))),
        "lsq": _jax_message(lambda: P.least_squares_sharded(lambda p, d: p, z((6, 2)), jax_mesh,
                                                            data=z((6, 3)))),
        "lsq_rank": _jax_message(lambda: P.least_squares_sharded(lambda p, d: p, z(4),
                                                                 jax_mesh)),
    }
    assert port == ref
