"""The port's parameter-sharded solves (`optimize_lbfgs_sharded`,
`optimize_cg_model_sharded`, `optimize_tr_model_sharded`) and the hooks
they run through, held to the JAX package's on conftest's virtual CPU
devices at the same shard count (4), in f64.

A sharded sum reassociates (a local partial plus an all-reduce), so the
trajectories follow the unsharded ones to rounding: the bars are JAX's own
(tests/test_mesh.py), L-BFGS's Wolfe run within 2 iterations, CG within
15 %, TR within 1, each on the same optimum. The ranks are a module-scoped
pool of 4 gloo processes (tests/torch_mesh_ranks.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.parallel import make_mesh as jax_make_mesh
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.lbfgs_solve import _lbfgs_loop
from quasinewtonmethods_jl_tpu_torch.ops.hutchinson import _rademacher
from quasinewtonmethods_jl_tpu_torch.ops.linesearch import run_linesearch
from quasinewtonmethods_jl_tpu_torch.state import init_lbfgs_state
from torch_mesh_ranks import RankPool, diag_quadratic, quad_logdensity

torch.set_num_threads(1)

SHARDS = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = RankPool(SHARDS, tmp_path_factory.mktemp("mesh_model_ranks"))
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh({"model": SHARDS})


def jax_quad(x):
    diag = jnp.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype)
    return -0.5 * jnp.sum(diag * x * x)


def one_answer(answers):
    for other in answers[1:]:
        np.testing.assert_equal(other, answers[0])
    return answers[0]


def test_lbfgs_sharded_quadratic_matches_jax(pool, jax_mesh, rng):
    x0 = rng.standard_normal(64)
    pool.start("lbfgs_model", "quad", x0, {"history": 10})
    ref = qj.parallel.optimize_lbfgs_sharded(jax_quad, jnp.asarray(x0), jax_mesh, history=10)
    port = one_answer(pool.wait())
    assert int(port["status"]) == int(qt.Status.CONVERGED) == int(ref.status)
    np.testing.assert_allclose(port["x"], np.asarray(ref.x), atol=1e-7)
    np.testing.assert_allclose(float(port["fun"]), float(ref.fun), atol=1e-12)
    assert np.abs(port["grad"]).max() < 1e-8
    assert abs(int(port["iterations"]) - int(ref.iterations)) <= 2
    # the state comes back whole: the rings hold n coordinates
    assert port["state"]["S"].shape == (10, 64) and port["state"]["x"].shape == (64,)


def test_lbfgs_sharded_rosenbrock_through_the_gathered_x(pool, jax_mesh, rng):
    """Non-separable: the objective sees the all-gathered x."""
    x0 = rng.standard_normal(16)
    pool.start("lbfgs_model", "rosenbrock", x0, {})
    ref = qj.parallel.optimize_lbfgs_sharded(jax_rosenbrock, jnp.asarray(x0), jax_mesh)
    port = one_answer(pool.wait())
    assert int(port["status"]) == int(qt.Status.CONVERGED) == int(ref.status)
    np.testing.assert_allclose(port["x"], 1.0, rtol=1e-6)
    assert np.abs(port["grad"]).max() < 1e-8


def test_lbfgs_sharded_separable_value_and_grad(pool, rng):
    """A shard-local value_and_grad_fn that sums its value over the axis
    itself: no all-gather of x anywhere."""
    x0 = rng.standard_normal(32)
    port = one_answer(pool.run("lbfgs_separable", x0, np.linspace(0.5, 2.0, 32)))
    assert int(port["status"]) == int(qt.Status.CONVERGED)
    np.testing.assert_allclose(port["x"], 0.0, atol=1e-7)


def test_lbfgs_sharded_wolfe_slope_psum(pool, jax_mesh, rng):
    """The Wolfe trial slope gradᵀd takes the psum dot: a local dot gives
    each rank a different slope, the searches take different turns and the
    collectives deadlock (the pool's timeout would fail the test). Within 2
    iterations of JAX's sharded run and of the port's unsharded two-loop
    run, on the same optimum."""
    x0 = rng.standard_normal(16)
    pool.start("lbfgs_model", "quad", x0, {"wolfe": True, "tol": 1e-8})
    ref = qj.parallel.optimize_lbfgs_sharded(jax_quad, jnp.asarray(x0), jax_mesh,
                                             ls=qj.Wolfe(), tol=1e-8)
    un = qt.optimize_lbfgs(quad_logdensity, torch.tensor(x0), ls=qt.Wolfe(), tol=1e-8,
                           direction_method="two_loop")
    port = one_answer(pool.wait())
    assert int(port["status"]) == int(qt.Status.CONVERGED)
    for other in (int(ref.iterations), int(un.iterations)):
        assert abs(int(port["iterations"]) - other) <= 2
    np.testing.assert_allclose(port["x"], np.asarray(ref.x), atol=1e-6)
    np.testing.assert_allclose(port["x"], un.x.numpy(), atol=1e-6)


def _geometric(n, top):
    return np.geomspace(1.0, top, n)


def test_cg_model_sharded_matches_jax_and_jacobi_probes_are_global(pool, jax_mesh, rng):
    """One large-n CG solve, every β reduction a partial plus an all-reduce:
    within 15 % of JAX's sharded iterations and of the port's unsharded
    run, on the same optimum. The Jacobi flavour hashes each coordinate's
    global index, so its probes are the unsharded run's."""
    n = 1024
    d = _geometric(n, 100.0)
    x0 = rng.standard_normal(n)
    pool.start("cg_model", "diag", d, x0, {})
    jobj = lambda x: -0.5 * jnp.sum(jnp.asarray(d) * x * x)  # noqa: E731
    ref = qj.parallel.optimize_cg_model_sharded(jobj, jnp.asarray(x0), jax_mesh)
    un = qt.optimize_cg(diag_quadratic(d), torch.tensor(x0))
    port = one_answer(pool.wait())
    assert int(port["status"]) == int(qt.Status.CONVERGED)
    for other in (int(ref.iterations), int(un.iterations)):
        assert abs(int(port["iterations"]) - other) <= 0.15 * other
    np.testing.assert_allclose(port["x"], 0.0, atol=1e-8)
    assert np.abs(port["grad"]).max() < 1e-8

    pool.start("cg_model", "diag", d, x0, {"precondition": "jacobi"})
    un_pre = qt.optimize_cg(diag_quadratic(d), torch.tensor(x0), precondition="jacobi")
    pre = one_answer(pool.wait())
    assert int(pre["status"]) == int(qt.Status.CONVERGED)
    assert int(pre["iterations"]) < int(port["iterations"])
    assert abs(int(pre["iterations"]) - int(un_pre.iterations)) <= 0.15 * int(un_pre.iterations)
    assert int(pre["n_gev"]) - int(pre["n_fev"]) == int(un_pre.n_gev) - int(un_pre.n_fev)


def test_cg_model_sharded_nonseparable(pool, jax_mesh, rng):
    x0 = rng.standard_normal(16) * 0.5
    pool.start("cg_model", "rosenbrock", None, x0, {})
    ref = qj.parallel.optimize_cg_model_sharded(jax_rosenbrock, jnp.asarray(x0), jax_mesh)
    port = one_answer(pool.wait())
    assert int(port["status"]) == int(qt.Status.CONVERGED) == int(ref.status)
    np.testing.assert_allclose(port["x"], 1.0, atol=1e-6)


def test_tr_model_sharded_matches_jax(pool, jax_mesh, rng):
    n = 128
    d = _geometric(n, 1e3)
    x0 = rng.standard_normal(n)
    pool.start("tr_model", "diag", d, x0, {"max_cg": 64})
    jobj = lambda x: -0.5 * jnp.sum(jnp.asarray(d) * x * x)  # noqa: E731
    ref = qj.parallel.optimize_tr_model_sharded(jobj, jnp.asarray(x0), jax_mesh, max_cg=64)
    port = one_answer(pool.wait())
    assert int(port["status"]) == int(qt.Status.CONVERGED)
    assert abs(int(port["iterations"]) - int(ref.iterations)) <= 1
    np.testing.assert_allclose(port["x"], 0.0, atol=1e-8)
    assert np.abs(port["grad"]).max() < 1e-8


def test_tr_model_sharded_nonseparable(pool, jax_mesh, rng):
    """Rosenbrock couples coordinates across shards; the default inner cap
    min(n, 64) is taken on the whole n."""
    x0 = rng.standard_normal(16)
    pool.start("tr_model", "rosenbrock", None, x0, {})
    ref = qj.parallel.optimize_tr_model_sharded(jax_rosenbrock, jnp.asarray(x0), jax_mesh)
    un = qt.optimize_tr(qt.models.rosenbrock_logdensity, torch.tensor(x0))
    port = one_answer(pool.wait())
    assert int(port["status"]) == int(qt.Status.CONVERGED) == int(ref.status)
    np.testing.assert_allclose(port["x"], 1.0, atol=1e-7)
    assert np.abs(port["grad"]).max() < 1e-8
    assert abs(int(port["iterations"]) - int(un.iterations)) <= 1


def test_per_coordinate_options_are_cut_like_x(pool, rng):
    """A fixed preconditioner diagonal and per-coordinate bounds take each
    rank's slice: the sharded solves reach the unsharded ones' optima
    (TR's box binds on the coordinates whose optimum it excludes)."""
    n = 64
    d = _geometric(n, 1e3)
    x0 = rng.standard_normal(n)
    lo, hi = np.full(n, -1.0), np.where(np.arange(n) % 3 == 0, -0.5, 1.0)
    port = one_answer(pool.run("per_coordinate_options", x0, d, lo, hi))
    obj = diag_quadratic(d)
    un_cg = qt.optimize_cg(obj, torch.tensor(x0), precondition=torch.tensor(d))
    un_tr = qt.optimize_tr(obj, torch.tensor(x0), bounds=(torch.tensor(lo), torch.tensor(hi)))
    for key, un in (("cg", un_cg), ("tr", un_tr)):
        assert int(port[key]["status"]) == int(un.status) == int(qt.Status.CONVERGED)
        assert abs(int(port[key]["iterations"]) - int(un.iterations)) <= 1
        np.testing.assert_allclose(port[key]["x"], un.x.numpy(), atol=1e-8)
    np.testing.assert_allclose(port["tr"]["x"], np.clip(0.0, lo, hi), atol=1e-8)


def _jax_message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_model_refusals_carry_jax_messages(pool, jax_mesh):
    port = one_answer(pool.run("model_refusals"))
    P, z = qj.parallel, jnp.zeros
    ref = {
        "lbfgs": _jax_message(lambda: P.optimize_lbfgs_sharded(jax_quad, z(10), jax_mesh)),
        "cg_rank": _jax_message(lambda: P.optimize_cg_model_sharded(jax_quad, z((4, 8)),
                                                                    jax_mesh)),
        "cg": _jax_message(lambda: P.optimize_cg_model_sharded(jax_quad, z(10), jax_mesh)),
        "tr_rank": _jax_message(lambda: P.optimize_tr_model_sharded(jax_quad, z((4, 8)),
                                                                    jax_mesh)),
        "tr": _jax_message(lambda: P.optimize_tr_model_sharded(jax_quad, z(10), jax_mesh)),
    }
    assert port == ref


# --- the hooks, in one process -----------------------------------------------


class Counted:
    """A hook that computes what the default does and counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


@pytest.mark.parametrize("ls", [qt.BackTracking(), qt.Wolfe()], ids=["backtracking", "wolfe"])
def test_lbfgs_loop_hooks_take_every_dot_and_the_convergence_max(rng, ls):
    """Through counting hooks that compute the defaults, the two-loop
    loop gives the default run's result bit for bit, and every dot and
    max|g| went through the hooks."""
    x0 = torch.tensor(rng.standard_normal(12))
    vag = qt.as_value_and_grad(quad_logdensity)
    f = qt.as_value_fn(quad_logdensity)
    plain = _lbfgs_loop(vag, f, init_lbfgs_state(x0, 5), ls, 1e-10, 200, "two_loop",
                        fresh_start=True)
    dot = Counted(torch.dot)
    max_abs = Counted(lambda g: g.abs().amax())
    hooked = _lbfgs_loop(vag, f, init_lbfgs_state(x0, 5), ls, 1e-10, 200, "two_loop",
                         fresh_start=True, dot=dot, max_abs=max_abs)
    for a, b in zip(hooked, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    iters = int(plain.k)
    assert max_abs.calls == iters + 1
    # per iteration: the push (2), the recursion (2 m + 1) and, with Wolfe,
    # one slope a trial
    assert dot.calls >= iters * (2 + 2 * 5 + 1)


def test_run_linesearch_wolfe_slope_takes_the_dot_hook():
    x = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    vag = qt.as_value_and_grad(quad_logdensity)
    f0, g = vag(x)
    d = g.clone()
    m = torch.dot(g, d)
    dot = Counted(torch.dot)
    plain = run_linesearch(qt.Wolfe(), qt.as_value_fn(quad_logdensity), vag, x, d, f0, m)
    hooked = run_linesearch(qt.Wolfe(), qt.as_value_fn(quad_logdensity), vag, x, d, f0, m,
                            dot=dot)
    assert dot.calls == int(hooked[2]) >= 1
    for a, b in zip(hooked, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("shards", [2, 4])
def test_hutchinson_probe_of_a_shard_is_a_slice_of_the_whole(shards):
    n = 64
    whole = _rademacher(0x7453, 5, 1, n, torch.float64, "cpu")
    loc = n // shards
    parts = [_rademacher(0x7453, 5, 1, loc, torch.float64, "cpu", offset=r * loc)
             for r in range(shards)]
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)
