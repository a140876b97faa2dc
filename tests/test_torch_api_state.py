"""The port's objective protocol and solver state (api.py, state.py) against
the JAX package's, plus the port's import boundary and misuse errors.

States cross between the packages as numpy arrays; a crossing must be
lossless (exact values and dtypes), and a JAX fleet's state carried into
the port must give the same next update (1e-10 in f64: summation order).
"""

import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
from quasinewtonmethods_jl_tpu.batched_solve import (
    optimize_batched_fused as jax_optimize_batched_fused,
)
from quasinewtonmethods_jl_tpu.models import (
    rosenbrock_logdensity as jax_rosenbrock,
    rosenbrock_value_and_grad as jax_rosenbrock_vag,
)
from quasinewtonmethods_jl_tpu.ops.pallas.bfgs_kernel import (
    fused_bfgs_update_reference as jax_fused_reference,
)
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.api import _pin_matmul_precision
from quasinewtonmethods_jl_tpu_torch.models import (
    Rosenbrock,
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)
from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
    fused_bfgs_update_reference,
)
from test_torch_bfgs_kernel import from_batch_minor, to_batch_minor

torch.set_num_threads(1)


def test_port_imports_no_jax():
    code = (
        "import sys, quasinewtonmethods_jl_tpu_torch, "
        "quasinewtonmethods_jl_tpu_torch.models, "
        "quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel, "
        "quasinewtonmethods_jl_tpu_torch.cg_solve, "
        "quasinewtonmethods_jl_tpu_torch.ops.wolfe, "
        "quasinewtonmethods_jl_tpu_torch.ops.hutchinson, "
        "quasinewtonmethods_jl_tpu_torch.trust_region, "
        "quasinewtonmethods_jl_tpu_torch.utils.device, "
        "quasinewtonmethods_jl_tpu_torch.utils.checkpoint, "
        "quasinewtonmethods_jl_tpu_torch.diagnostics, "
        "quasinewtonmethods_jl_tpu_torch.pytree, "
        "quasinewtonmethods_jl_tpu_torch.sampling, "
        "quasinewtonmethods_jl_tpu_torch.pathfinder, "
        "quasinewtonmethods_jl_tpu_torch.svgd, "
        "quasinewtonmethods_jl_tpu_torch.loo, "
        "quasinewtonmethods_jl_tpu_torch.mclmc, "
        "quasinewtonmethods_jl_tpu_torch.ensemble, "
        "quasinewtonmethods_jl_tpu_torch.tempering, "
        "quasinewtonmethods_jl_tpu_torch.ais, "
        "quasinewtonmethods_jl_tpu_torch.bridge, "
        "quasinewtonmethods_jl_tpu_torch.workflow, "
        "quasinewtonmethods_jl_tpu_torch.utils.profiling, "
        "quasinewtonmethods_jl_tpu_torch.utils.placement, "
        "quasinewtonmethods_jl_tpu_torch.parallel.mesh, "
        "quasinewtonmethods_jl_tpu_torch.parallel.distributed; "
        "assert 'jax' not in sys.modules, 'jax imported'"
    )
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)


# the JAX package's names the port does not have yet (ROADMAP.md A): none
NOT_YET_PORTED = set()


def test_version_and_exported_names_match_jax():
    assert qt.__version__ == qj.__version__
    assert set(qj.__all__) - set(qt.__all__) == NOT_YET_PORTED
    assert all(hasattr(qt, name) for name in qt.__all__)


# each subpackage's names the port does not have yet: none since the device
# mesh (parallel/mesh.py)
SUBPACKAGE_NOT_YET_PORTED = {
    "utils": set(),
    "ops": set(),
    "models": set(),
    "parallel": set(),
}


@pytest.mark.parametrize("sub", sorted(SUBPACKAGE_NOT_YET_PORTED))
def test_subpackage_exported_names_match_jax(sub):
    mine = importlib.import_module(f"quasinewtonmethods_jl_tpu_torch.{sub}")
    theirs = importlib.import_module(f"quasinewtonmethods_jl_tpu.{sub}")
    assert set(theirs.__all__) - set(mine.__all__) == SUBPACKAGE_NOT_YET_PORTED[sub]
    assert all(hasattr(mine, name) for name in mine.__all__)


@pytest.mark.parametrize("sub", ["parallel", "parallel.distributed"])
def test_mesh_names_equal_jax(sub):
    mine = importlib.import_module(f"quasinewtonmethods_jl_tpu_torch.{sub}")
    theirs = importlib.import_module(f"quasinewtonmethods_jl_tpu.{sub}")
    assert mine.__all__ == theirs.__all__


# the samplers ported since get_sampler first named them as not yet ported:
# the port's resolves to its entry point, JAX's to a lazy wrapper of its
# own, so the two are compared by what they run
@pytest.mark.parametrize("name", ["ensemble", "mclmc", "nuts", "pt"])
def test_get_sampler_resolves_what_was_ported(name):
    assert qt.sampling.get_sampler(name) is getattr(qt, f"{name}_sample")
    x0 = np.random.default_rng(1).standard_normal((8, 2))
    kw = {"n_samples": 3, "n_warmup": 2}
    port = qt.sampling.get_sampler(name)(lambda x: -0.5 * torch.sum(x * x), 4,
                                         torch.tensor(x0), **kw)
    ref = qj.sampling.get_sampler(name)(lambda x: -0.5 * jnp.sum(x * x),
                                        jax.random.PRNGKey(4), jnp.asarray(x0), **kw)
    assert type(port).__name__ == type(ref).__name__
    assert tuple(port.samples.shape) == np.shape(ref.samples) == (3, 8, 2)
    assert port.samples.dtype == torch.float64 and ref.samples.dtype == jnp.float64


@pytest.mark.parametrize("n", [6, 7])
def test_autodiff_gradient_matches_analytic_and_jax(rng, n):
    x = rng.standard_normal(n)
    vag = qt.as_value_and_grad(rosenbrock_logdensity)
    value, grad = vag(torch.tensor(x))
    a_value, a_grad = rosenbrock_value_and_grad(torch.tensor(x))
    j_value, j_grad = jax_rosenbrock_vag(jnp.asarray(x))
    np.testing.assert_allclose(grad.numpy(), a_grad.numpy(), rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose(float(value), float(a_value), rtol=1e-15)
    np.testing.assert_allclose(float(value), float(j_value), rtol=1e-13)
    np.testing.assert_allclose(
        float(rosenbrock_logdensity(torch.tensor(x))), float(jax_rosenbrock(jnp.asarray(x))),
        rtol=1e-13,
    )


def test_probability_model_surface():
    model = qt.ProbabilityModel(4)
    assert repr(model) == repr(qj.ProbabilityModel(4)) == "4-dimensional Probability Model"
    assert len(model) == model.dimension == 4
    with pytest.raises(NotImplementedError):
        model.logdensity(torch.zeros(4))
    assert repr(Rosenbrock(60)) == "60-dimensional Probability Model"


def test_value_and_grad_resolution_order():
    x = torch.tensor([0.3, -0.2, 0.5, 1.1])

    def explicit(theta):
        return torch.tensor(1.0), torch.full_like(theta, 2.0)

    assert float(qt.as_value_and_grad(Rosenbrock(4), explicit)(x)[0]) == 1.0
    model_vag = qt.as_value_and_grad(Rosenbrock(4, analytic_gradient=True))(x)
    torch.testing.assert_close(model_vag[1], rosenbrock_value_and_grad(x)[1])
    # a value_and_grad_fn alone still yields a value-only objective
    assert float(qt.as_value_fn(None, explicit)(x)) == 1.0
    assert float(qt.as_value_fn(Rosenbrock(4), explicit)(x)) == float(rosenbrock_logdensity(x))


def test_objective_runs_with_tf32_off_and_flags_restored():
    seen = []

    def probe(theta):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return theta.sum()

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        qt.as_logdensity(probe)(torch.ones(3))
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        with pytest.raises(ZeroDivisionError):
            _pin_matmul_precision(lambda: 1 / 0)()
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_misuse_probes():
    with pytest.raises(ValueError, match="shape"):
        qt.optimize_batched(rosenbrock_logdensity, torch.zeros(5))
    with pytest.raises(TypeError):
        qt.optimize_batched(42, torch.zeros((2, 5)))
    with pytest.raises(ValueError, match="cuda"):
        qt.optimize_batched(rosenbrock_logdensity, torch.zeros((2, 5)), kernel="cuda")
    with pytest.raises(ValueError, match="order"):
        qt.BackTracking(order=5)
    with pytest.raises(ValueError, match="rank-1"):
        qt.init_bfgs_state(torch.zeros((2, 3)))


def test_status_codes_match_jax():
    assert {s.name: int(s) for s in qt.Status} == {s.name: int(s) for s in qj.Status}
    assert qt.BFGSState._fields == qj.BFGSState._fields
    assert qt.OptimizeResult._fields == qj.OptimizeResult._fields
    assert qt.MAX_ITERATIONS_DEFAULT == qj.solve.MAX_ITERATIONS_DEFAULT
    assert qt.STALL_LIMIT_DEFAULT == qj.solve.STALL_LIMIT_DEFAULT


def test_init_state_matches_jax(rng):
    x0 = rng.standard_normal(5)
    port = qt.bfgs_state_to_numpy(qt.init_bfgs_state(torch.tensor(x0)))
    ref = qj.init_bfgs_state(jnp.asarray(x0))
    for name, a, b in zip(ref._fields, port, ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("init", [qt.init_bfgs_state, qt.init_lbfgs_state])
def test_init_states_place_arrays_as_the_entry_points_do(monkeypatch, init):
    """A numpy x0 goes where an entry point puts it (the card; without one,
    the entry points' error); a CPU tensor keeps its device and dtype."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor") as from_init:
        init(np.ones(3))
    with pytest.raises(RuntimeError) as from_entry:
        qt.optimize(rosenbrock_logdensity, np.ones(3))
    assert str(from_init.value) == str(from_entry.value)
    for dtype in (torch.float32, torch.float64):
        state = init(torch.ones(3, dtype=dtype))
        assert all(leaf.device.type == "cpu" for leaf in state)
        assert state.x.dtype == state.grad.dtype == state.fun.dtype == dtype


# the MAP back end's entry points given numpy input (PR 11's modules)
MAP_ENTRY_POINTS = {
    "optimize_multistart": lambda a: qt.optimize_multistart(rosenbrock_logdensity, None, 2, 3,
                                                            x0s=a),
    "optimize_implicit": lambda a: qt.optimize_implicit(lambda x, p: -((x - p) ** 2).sum(),
                                                        a[0], torch.ones(3)),
    "optimize_pytree": lambda a: qt.optimize_pytree(lambda t: rosenbrock_logdensity(t["x"]),
                                                    {"x": a[0]}),
    "split_rhat_device": lambda a: qt.split_rhat_device(np.ones((8, 2, 3))),
    "energy_bfmi_device": lambda a: qt.energy_bfmi_device(np.ones((8, 2))),
}


@pytest.mark.parametrize("entry", sorted(MAP_ENTRY_POINTS))
def test_the_map_back_end_places_numpy_input_on_the_card(monkeypatch, entry):
    """Numpy input goes to the card, as every entry point's: without one it
    raises the entry points' error instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
        MAP_ENTRY_POINTS[entry](np.ones((2, 3)))


# the workflow's initializers given numpy starts (pathfinder.py, svgd.py)
INITIALIZER_ENTRY_POINTS = {
    "pathfinder": lambda a: qt.pathfinder(lambda x: -torch.sum(x * x), 5, a, n_draws=4,
                                          max_iters=2, elbo_draws=2),
    "svgd_sample": lambda a: qt.svgd_sample(lambda x: -torch.sum(x * x), a, n_steps=2),
}


@pytest.mark.parametrize("entry", sorted(INITIALIZER_ENTRY_POINTS))
def test_the_initializers_place_numpy_input_on_the_card(monkeypatch, entry):
    """Numpy starts go to the card in float32 (without one, the entry
    points' error), and Pathfinder's key stays on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
        INITIALIZER_ENTRY_POINTS[entry](np.ones((2, 3)))
    seen, keys = [], []
    real = torch.as_tensor

    def spy(data, *args, **kwargs):
        seen.append(str(kwargs.get("device")))
        kwargs.pop("device", None)
        return real(data, *args, **kwargs)

    pf_module = qt.pathfinder.__globals__
    real_noise = pf_module["_pathfinder_elbo_noise"]

    def noise_spy(key, *args):
        keys.append(key)
        return real_noise(key, *args)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch, "as_tensor", spy)
    monkeypatch.setitem(pf_module, "_pathfinder_elbo_noise", noise_spy)
    res = INITIALIZER_ENTRY_POINTS[entry](np.ones((2, 3)))
    assert seen[0] == "cuda"
    assert res[0].dtype == torch.float32
    if entry == "pathfinder":
        assert keys and all(k.device.type == "cpu" and k.dtype == torch.int64 for k in keys)
        np.testing.assert_array_equal(keys[0].numpy(), [0, 5])


@pytest.fixture(scope="module")
def jax_fleet_result():
    X0 = np.random.default_rng(11).standard_normal((16, 8))
    return jax_optimize_batched_fused(jax_rosenbrock, jnp.asarray(X0), max_iterations=4)


def test_state_round_trip_is_lossless(jax_fleet_result):
    for jax_state in (jax_fleet_result.state, qj.init_bfgs_state(jnp.ones(3))):
        np_state = jax.tree_util.tree_map(np.asarray, jax_state)
        port = qt.bfgs_state_from_numpy(np_state, torch.device("cpu"))
        assert isinstance(port, qt.BFGSState)
        back = qt.bfgs_state_to_numpy(port)
        for name, a, b in zip(qt.BFGSState._fields, back, np_state):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_jax_fleet_state_gives_same_next_update(jax_fleet_result):
    """A JAX fleet's state carried into the port: the next fused update
    (gradient at the state's x, the state's step and previous gradient)
    equals the JAX one."""
    np_state = jax.tree_util.tree_map(np.asarray, jax_fleet_result.state)
    port = qt.bfgs_state_from_numpy(np_state, torch.device("cpu"))
    g = torch.func.vmap(rosenbrock_value_and_grad)(port.x)[1]
    active = torch.ones(port.x.shape[0], dtype=torch.bool)
    mine = fused_bfgs_update_reference(port.B.clone(), port.step, g, port.grad_old, active, port.fresh)
    args = (np_state.B, np_state.step, g.numpy(), np_state.grad_old, active.numpy(), np_state.fresh)
    theirs = from_batch_minor(*jax_fused_reference(*to_batch_minor(*args)))
    for a, b, name in zip(mine[:3], theirs[:3], ["B", "d", "m"]):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-10, rtol=0, err_msg=name)
    np.testing.assert_array_equal(mine[3].numpy(), theirs[3])
