"""The fleet BFGS engine's ``fold_eval``, resume
(`optimize_batched_fused_from_state`) and straggler compaction
(`optimize_batched_compacted`) against the JAX package's, on the same numpy
inputs in f64 with the plain update on the CPU, mirroring
tests/test_fold_compact.py; and the entry points' device rule (numpy input
goes to the CUDA card; without one it raises; a CPU tensor stays on the
CPU).

Against JAX: statuses and every counter equal over short horizons (up to
15 iterations on Rosenbrock), x to 1e-9; over whole Rosenbrock solves the
packages' summation orders part the trajectories, so there the statuses
must be equal. Within
the port, a chunked solve and a compacted one are lane for lane the same
computation as one long solve, so they are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu.batched_solve import (
    optimize_batched_compacted as jax_optimize_batched_compacted,
    optimize_batched_fused as jax_optimize_batched_fused,
    optimize_batched_fused_from_state as jax_optimize_batched_fused_from_state,
)
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.ops.wolfe import Wolfe as JaxWolfe
from quasinewtonmethods_jl_tpu.state import init_bfgs_state as jax_init_bfgs_state
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity
from quasinewtonmethods_jl_tpu_torch.utils import device as device_module

torch.set_num_threads(1)

COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")


def assert_counters_equal(port, ref):
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


def assert_same_run(a, b):
    """Two port results of the same per-lane computation: exactly equal."""
    for name in COUNTERS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in ("x", "grad", "last_value"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.state.B, b.state.B)


@pytest.mark.parametrize("wolfe", [False, True])
@pytest.mark.parametrize("max_iterations", [1, 2, 15])
def test_fold_eval_matches_jax_short_horizon(rng, wolfe, max_iterations):
    X0 = rng.standard_normal((16, 8))
    port = qt.optimize_batched_fused(rosenbrock_logdensity, torch.tensor(X0), fold_eval=True,
                                     max_iterations=max_iterations, kernel="torch",
                                     **({"ls": qt.Wolfe()} if wolfe else {}))
    ref = jax_optimize_batched_fused(jax_rosenbrock, jnp.asarray(X0), fold_eval=True,
                                     max_iterations=max_iterations, kernel="xla",
                                     **({"ls": JaxWolfe()} if wolfe else {}))
    assert_counters_equal(port, ref)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)
    # the fold invariant: (fun, grad) are the evaluation at x
    f, g = torch.func.vmap(torch.func.grad_and_value(rosenbrock_logdensity))(port.x)[::-1]
    moved = port.iterations > 0
    torch.testing.assert_close(port.last_value[moved], f[moved], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(port.grad[moved], g[moved], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("wolfe", [False, True])
def test_fold_eval_same_trajectory_fewer_evaluations(rng, wolfe):
    """The top-of-iteration evaluation is gone: n_fev falls by exactly the
    iteration count (tests/test_fold_compact.py)."""
    X0 = torch.tensor(rng.standard_normal((24, 8)))
    ls = {"ls": qt.Wolfe()} if wolfe else {}
    base = qt.optimize_batched_fused(rosenbrock_logdensity, X0, **ls)
    fold = qt.optimize_batched_fused(rosenbrock_logdensity, X0, fold_eval=True, **ls)
    assert torch.equal(fold.status, base.status)
    assert (fold.status == qt.Status.CONVERGED).all()
    assert torch.equal(fold.iterations, base.iterations)
    torch.testing.assert_close(fold.x, base.x, rtol=1e-9, atol=1e-9)
    assert torch.equal(base.n_fev - fold.n_fev, base.iterations)
    if wolfe:
        # Wolfe trials are value+gradient either way
        assert torch.equal(base.n_gev - fold.n_gev, base.iterations)
    else:
        # every fold trial pays the gradient too
        assert (fold.n_gev >= base.n_gev).all()


@pytest.mark.parametrize("wolfe", [False, True])
def test_resume_matches_jax(rng, wolfe):
    X0 = rng.standard_normal((16, 8))
    ls = ({"ls": qt.Wolfe()}, {"ls": JaxWolfe()}) if wolfe else ({}, {})
    part = qt.optimize_batched_fused(rosenbrock_logdensity, torch.tensor(X0), max_iterations=7,
                                     **ls[0])
    ref_part = jax_optimize_batched_fused(jax_rosenbrock, jnp.asarray(X0), max_iterations=7,
                                          kernel="xla", **ls[1])
    port = qt.optimize_batched_fused_from_state(rosenbrock_logdensity, part.state,
                                                max_iterations=8, **ls[0])
    ref = jax_optimize_batched_fused_from_state(jax_rosenbrock, ref_part.state,
                                                max_iterations=8, kernel="xla", **ls[1])
    assert_counters_equal(port, ref)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)
    np.testing.assert_allclose(port.state.B.numpy(), np.asarray(ref.state.B), atol=1e-8, rtol=0)


@pytest.mark.parametrize("fold_eval", [False, True])
def test_chunked_resume_equals_one_long_run(rng, fold_eval):
    """A resume continues each lane's BFGS trajectory. With fold_eval the
    resumed leg evaluates at its start, where the long run used the
    carried evaluation of the same point: one more value and gradient
    evaluation per lane, nothing else."""
    X0 = torch.tensor(rng.standard_normal((16, 8)))
    long = qt.optimize_batched_fused(rosenbrock_logdensity, X0, fold_eval=fold_eval)
    part = qt.optimize_batched_fused(rosenbrock_logdensity, X0, max_iterations=7,
                                     fold_eval=fold_eval)
    assert (part.status == qt.Status.MAX_ITERATIONS).all()
    res = qt.optimize_batched_fused_from_state(rosenbrock_logdensity, part.state,
                                               fold_eval=fold_eval)
    for name in ("status", "iterations", "n_resets", "x", "grad"):
        assert torch.equal(getattr(res, name), getattr(long, name)), name
    assert torch.equal(res.n_fev, long.n_fev + int(fold_eval))
    assert torch.equal(res.n_gev, long.n_gev + int(fold_eval))


def test_resume_does_not_change_its_state(rng):
    X0 = torch.tensor(rng.standard_normal((8, 6)))
    part = qt.optimize_batched_fused(rosenbrock_logdensity, X0, max_iterations=4)
    saved = [leaf.clone() for leaf in part.state]
    qt.optimize_batched_fused_from_state(rosenbrock_logdensity, part.state, max_iterations=6)
    for name, a, b in zip(qt.BFGSState._fields, part.state, saved):
        assert torch.equal(a, b), name


def test_resume_of_a_fresh_state_takes_the_steepest_first_step(rng):
    X0 = rng.standard_normal((6, 5))
    fresh = qt.BFGSState(*(torch.stack(leaves) for leaves in zip(
        *(qt.init_bfgs_state(torch.tensor(x)) for x in X0))))
    port = qt.optimize_batched_fused_from_state(rosenbrock_logdensity, fresh)
    direct = qt.optimize_batched_fused(rosenbrock_logdensity, torch.tensor(X0))
    ref = jax_optimize_batched_fused_from_state(
        jax_rosenbrock, jax.vmap(jax_init_bfgs_state)(jnp.asarray(X0)), kernel="xla",
        max_iterations=12)
    short = qt.optimize_batched_fused_from_state(rosenbrock_logdensity, fresh, max_iterations=12)
    assert_counters_equal(short, ref)
    assert (port.status == qt.Status.CONVERGED).all()
    assert torch.equal(port.iterations, direct.iterations)
    torch.testing.assert_close(port.x, direct.x, rtol=0, atol=1e-12)


@pytest.mark.parametrize("fold_eval", [False, True])
def test_compacted_matches_fused(rng, fold_eval):
    X0 = rng.standard_normal((64, 8))
    long = qt.optimize_batched_fused(rosenbrock_logdensity, torch.tensor(X0), fold_eval=fold_eval)
    comp = qt.optimize_batched_compacted(rosenbrock_logdensity, torch.tensor(X0),
                                         fold_eval=fold_eval, chunk=9)
    ref = jax_optimize_batched_compacted(jax_rosenbrock, jnp.asarray(X0), kernel="xla",
                                         fold_eval=fold_eval, chunk=9, min_width=8)
    np.testing.assert_array_equal(comp.status.numpy(), np.asarray(ref.status))
    assert torch.equal(comp.status, long.status)
    if fold_eval:
        # each leg re-evaluates once at its start (tests/test_fold_compact.py)
        extra = comp.n_fev - long.n_fev
        assert (extra >= 0).all() and (extra <= long.iterations // 9 + 1).all()
        assert torch.equal(comp.iterations, long.iterations)
        torch.testing.assert_close(comp.x, long.x, rtol=0, atol=1e-12)
    else:
        assert_same_run(comp, long)


def test_compacted_respects_max_iterations_and_counts_one_sync_per_chunk(rng):
    """Chunks of 5 up to 11 iterations: legs of 5, 5 and 1 and two status
    reads. No lane finishes, so each leg resumes the whole fleet and the
    legs' own syncs are those of the same resumes run by hand."""
    X0 = torch.tensor(rng.standard_normal((16, 12)))
    engine = qt.optimize_batched_fused
    engine.host_syncs = 0
    comp = qt.optimize_batched_compacted(rosenbrock_logdensity, X0, chunk=5, max_iterations=11)
    comp_syncs = engine.host_syncs
    engine.host_syncs = 0
    res = engine(rosenbrock_logdensity, X0, max_iterations=5)
    for cap in (5, 1):
        res = qt.optimize_batched_fused_from_state(rosenbrock_logdensity, res.state,
                                                   max_iterations=cap)
    assert comp_syncs == engine.host_syncs + 2
    long = engine(rosenbrock_logdensity, X0, max_iterations=11)
    assert_same_run(comp, long)
    assert_same_run(comp, res)
    assert (comp.status == qt.Status.MAX_ITERATIONS).all()
    ref = jax_optimize_batched_compacted(jax_rosenbrock, jnp.asarray(X0.numpy()), kernel="xla",
                                         chunk=5, min_width=8, max_iterations=11)
    assert_counters_equal(comp, ref)
    np.testing.assert_allclose(comp.x.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)


def test_compacted_terminal_failures_not_resumed(rng):
    """LINESEARCH_FAILURE and NONFINITE lanes are terminal: compaction does
    not re-arm them (their counters would keep growing)."""

    def sometimes_bad(x):
        r = torch.sum(x * x)
        return torch.where(r > 1e4, -torch.inf, -r)

    def jax_sometimes_bad(x):
        r = jnp.sum(x * x)
        return jnp.where(r > 1e4, -jnp.inf, -r)

    X0 = np.concatenate([np.full((4, 4), 200.0), rng.standard_normal((12, 4))])
    comp = qt.optimize_batched_compacted(sometimes_bad, torch.tensor(X0), chunk=4)
    long = qt.optimize_batched_fused(sometimes_bad, torch.tensor(X0))
    ref = jax_optimize_batched_compacted(jax_sometimes_bad, jnp.asarray(X0), kernel="xla",
                                         chunk=4, min_width=8)
    assert_same_run(comp, long)
    assert_counters_equal(comp, ref)
    assert (comp.status[:4] == qt.Status.NONFINITE_VALUE).all()


def test_entry_points_validate_their_arguments():
    X0 = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="chunk"):
        qt.optimize_batched_compacted(rosenbrock_logdensity, X0, chunk=0)
    with pytest.raises(ValueError, match="batched"):
        qt.optimize_batched_fused_from_state(rosenbrock_logdensity, qt.init_bfgs_state(X0[0]))
    with pytest.raises(TypeError, match="BackTracking or a Wolfe"):
        qt.optimize_batched_compacted(rosenbrock_logdensity, X0, ls=object())


def _spy_cuda(monkeypatch):
    """Pretend a card exists and record the devices the entry points ask
    for (this CPU-only torch cannot make a CUDA tensor)."""
    seen = []
    real = torch.as_tensor

    def as_tensor(data, *args, device=None, **kw):
        if device is not None:
            seen.append(str(device))
        return real(data, *args, **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(device_module.torch, "as_tensor", as_tensor)
    return seen


ENTRY_POINTS = ["optimize_batched", "optimize_batched_fused", "optimize_batched_compacted",
                "optimize_batched_resident", "optimize_cg"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_numpy_input_goes_to_the_card(monkeypatch, rng, entry):
    """And in the JAX package's default dtype: float64 input runs in f32."""
    seen = _spy_cuda(monkeypatch)
    res = getattr(qt, entry)(rosenbrock_logdensity, rng.standard_normal((4, 6)),
                             max_iterations=2)
    assert seen == ["cuda"] and res.x.dtype == torch.float32


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_numpy_input_without_a_card_raises(monkeypatch, rng, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for x0 in (rng.standard_normal((4, 6)), [[0.5, 0.5]]):
        with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
            getattr(qt, entry)(rosenbrock_logdensity, x0, max_iterations=2)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_cpu_tensor_stays_on_the_cpu(monkeypatch, rng, entry):
    seen = _spy_cuda(monkeypatch)
    res = getattr(qt, entry)(rosenbrock_logdensity, torch.tensor(rng.standard_normal((4, 6))),
                             max_iterations=2)
    assert seen == [] and res.x.device.type == "cpu"


RESUMES = ["cg rank 1", "cg rank 2", "bfgs"]


def _saved_state(resume, rng):
    """(entry point, state) of a two-iteration f64 solve on the CPU."""
    if resume == "bfgs":
        X0 = torch.tensor(rng.standard_normal((4, 6)))
        res = qt.optimize_batched_fused(rosenbrock_logdensity, X0, max_iterations=2)
        return qt.optimize_batched_fused_from_state, res.state
    X0 = torch.tensor(rng.standard_normal(6 if resume == "cg rank 1" else (4, 6)))
    res = qt.optimize_cg(rosenbrock_logdensity, X0, max_iterations=2)
    return qt.optimize_cg_from_state, res.state


@pytest.mark.parametrize("resume", RESUMES)
def test_numpy_state_goes_to_the_card(monkeypatch, rng, resume):
    """A state saved as numpy (`*_state_to_numpy`) resumes on the card,
    every leaf placed there, f64 leaves in f32."""
    entry, state = _saved_state(resume, rng)
    saved = qt.cg_state_to_numpy(state) if resume != "bfgs" else qt.bfgs_state_to_numpy(state)
    seen = _spy_cuda(monkeypatch)
    res = entry(rosenbrock_logdensity, saved, max_iterations=2)
    assert seen == ["cuda"] * len(state) and res.x.dtype == torch.float32
    assert res.x.shape == state.x.shape and (res.iterations == state.k + 2).all()


@pytest.mark.parametrize("resume", RESUMES)
def test_numpy_state_without_a_card_raises(monkeypatch, rng, resume):
    entry, state = _saved_state(resume, rng)
    saved = qt.cg_state_to_numpy(state) if resume != "bfgs" else qt.bfgs_state_to_numpy(state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="state.x is a ndarray.*pass a CPU torch.Tensor"):
        entry(rosenbrock_logdensity, saved, max_iterations=2)


@pytest.mark.parametrize("resume", RESUMES)
def test_cpu_state_stays_on_the_cpu(monkeypatch, rng, resume):
    entry, state = _saved_state(resume, rng)
    seen = _spy_cuda(monkeypatch)
    res = entry(rosenbrock_logdensity, state, max_iterations=2)
    assert seen == [] and res.x.device.type == "cpu" and res.x.dtype == torch.float64
