"""The port's checkpoints (utils/checkpoint.py) against the JAX package's,
on the CPU in f64: a state JAX saved resumes in the port with the
statuses and counters of JAX's own resume, and a state the port saved
loads in JAX and resumes there with the port's counters, for each of the
five solver states; then the file layout, the ``.npz`` suffix rule and the
refusals (another class, a missing field, a sampler state not yet ported,
PRNG keys outside a sampler state's key).

Counters equal lane by lane; floats within rtol 1e-8.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.batched_solve import optimize_batched_fused_from_state
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.utils import checkpoint as jax_checkpoint
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity
from quasinewtonmethods_jl_tpu_torch.utils import checkpoint
from test_torch_fold_resume import _spy_cuda

torch.set_num_threads(1)

BFGS_COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")


def _resid(x):
    """Rosenbrock residuals (least squares), either package."""
    xp = torch if isinstance(x, torch.Tensor) else jnp
    return xp.concatenate([10.0 * (x[1::2] - x[::2] ** 2), 1.0 - x[::2]])


def _quad(x):
    xp = torch if isinstance(x, torch.Tensor) else jnp
    diag = xp.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype)
    return -0.5 * xp.sum(diag * (x - 0.5) ** 2) - 0.1 * xp.sum(x ** 4)


# name: (class, port run, port resume, JAX run, JAX resume, counters)
CASES = {
    "bfgs": (
        qt.BFGSState,
        lambda x, **k: qt.optimize(rosenbrock_logdensity, x[0], **k),
        lambda s, **k: qt.optimize_from_state(rosenbrock_logdensity, s, **k),
        lambda x, **k: qnm.optimize(jax_rosenbrock, x[0], **k),
        lambda s, **k: qnm.optimize_from_state(jax_rosenbrock, s, **k),
        BFGS_COUNTERS,
    ),
    "bfgs fleet": (
        qt.BFGSState,
        lambda x, **k: qt.optimize_batched_fused(rosenbrock_logdensity, x, **k),
        lambda s, **k: qt.optimize_batched_fused_from_state(rosenbrock_logdensity, s, **k),
        lambda x, **k: qnm.optimize_batched_fused(jax_rosenbrock, x, kernel="xla", **k),
        lambda s, **k: optimize_batched_fused_from_state(jax_rosenbrock, s, kernel="xla", **k),
        BFGS_COUNTERS,
    ),
    "lbfgs": (
        qt.LBFGSState,
        lambda x, **k: qt.optimize_lbfgs(rosenbrock_logdensity, x[0], history=4, **k),
        lambda s, **k: qt.optimize_lbfgs_from_state(rosenbrock_logdensity, s, **k),
        lambda x, **k: qnm.optimize_lbfgs(jax_rosenbrock, x[0], history=4, **k),
        lambda s, **k: qnm.optimize_lbfgs_from_state(jax_rosenbrock, s, **k),
        BFGS_COUNTERS,
    ),
    "cg": (
        qt.CGState,
        lambda x, **k: qt.optimize_cg(_quad, x, **k),
        lambda s, **k: qt.optimize_cg_from_state(_quad, s, **k),
        lambda x, **k: qnm.optimize_cg(_quad, x, **k),
        lambda s, **k: qnm.optimize_cg_from_state(_quad, s, **k),
        BFGS_COUNTERS,
    ),
    "lm": (
        qt.LMState,
        lambda x, **k: qt.least_squares(_resid, x, **k),
        lambda s, **k: qt.least_squares_from_state(_resid, s, **k),
        lambda x, **k: qnm.least_squares(_resid, x, **k),
        lambda s, **k: qnm.least_squares_from_state(_resid, s, **k),
        ("status", "iterations", "n_fev", "n_jev"),
    ),
    "tr": (
        qt.TRState,
        lambda x, **k: qt.optimize_tr(_quad, x, **k),
        lambda s, **k: qt.optimize_tr_from_state(_quad, s, **k),
        lambda x, **k: qnm.optimize_tr(_quad, x, **k),
        lambda s, **k: qnm.optimize_tr_from_state(_quad, s, **k),
        ("status", "iterations", "n_fev", "n_hev"),
    ),
}
CAPS = {"bfgs": 5, "bfgs fleet": 5, "lbfgs": 5, "cg": 4, "lm": 2, "tr": 3}
# the resumes run to this many more lifetime iterations: a short horizon,
# where rounding cannot part the packages' trajectories on the Rosenbrock
MORE = 8


def _starts(n=6, batch=8):
    return np.random.default_rng(20260816).standard_normal((batch, n)) * 0.8


def _assert_same(port, ref, counters):
    for name in counters:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_state_jax_saved_resumes_in_the_port_as_in_jax(tmp_path, case):
    cls, _run, resume, jax_run, jax_resume, counters = CASES[case]
    part = jax_run(jnp.asarray(_starts()), max_iterations=CAPS[case])
    path = tmp_path / "state.npz"
    jax_checkpoint.save_state(path, part.state)
    loaded = checkpoint.load_state(path, cls, device="cpu")
    assert type(loaded) is cls
    for field, leaf in zip(cls._fields, loaded):
        ref = np.asarray(getattr(part.state, field))
        assert leaf.device.type == "cpu" and leaf.numpy().dtype == ref.dtype, field
        np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=field)
    more = {"max_iterations": CAPS[case] + MORE}
    _assert_same(resume(loaded, **more), jax_resume(part.state, **more), counters)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_state_the_port_saved_loads_in_jax(tmp_path, case):
    cls, run, resume, _jax_run, jax_resume, counters = CASES[case]
    part = run(torch.tensor(_starts()), max_iterations=CAPS[case])
    path = tmp_path / "state"
    checkpoint.save_state(path, part.state)
    assert (tmp_path / "state.npz").exists()
    loaded = jax_checkpoint.load_state(path, cls=getattr(qnm, cls.__name__))
    for field, leaf in zip(cls._fields, part.state):
        ref = np.asarray(getattr(loaded, field))
        assert leaf.numpy().dtype == ref.dtype, field
        np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=field)
    more = {"max_iterations": CAPS[case] + MORE}
    _assert_same(resume(part.state, **more), jax_resume(loaded, **more), counters)


def test_the_file_layout_is_jaxs(tmp_path):
    part = qt.optimize_batched_fused(rosenbrock_logdensity, torch.tensor(_starts()),
                                     max_iterations=3)
    ref = qnm.optimize_batched_fused(jax_rosenbrock, jnp.asarray(_starts()), kernel="xla",
                                     max_iterations=3)
    checkpoint.save_state(tmp_path / "port", part.state)
    jax_checkpoint.save_state(tmp_path / "jax", ref.state)
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "jax.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for key in ("__class__", "__key_fields__", "__key_impls__"):
            assert p[key].dtype == j[key].dtype and p[key].shape == j[key].shape, key
            np.testing.assert_array_equal(p[key], j[key])
        for key in qt.BFGSState._fields:
            assert p[key].dtype == j[key].dtype and p[key].shape == j[key].shape, key


def test_the_suffix_rule_and_an_inferred_class(tmp_path):
    part = qt.optimize(rosenbrock_logdensity, torch.tensor(_starts()[0]), max_iterations=2)
    checkpoint.save_state(str(tmp_path / "run"), part.state)
    assert (tmp_path / "run.npz").exists()
    for path in (tmp_path / "run", str(tmp_path / "run.npz")):
        loaded = checkpoint.load_state(path, device="cpu")
        assert type(loaded) is qt.BFGSState
        assert all(torch.equal(a, b) for a, b in zip(loaded, part.state))


def test_a_load_without_device_follows_the_entry_points_rule(tmp_path, monkeypatch):
    """No device: the card, in JAX's x64-off dtypes; without a card the
    load raises."""
    part = qt.optimize(rosenbrock_logdensity, torch.tensor(_starts()[0]), max_iterations=2)
    checkpoint.save_state(tmp_path / "s", part.state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        checkpoint.load_state(tmp_path / "s")
    seen = _spy_cuda(monkeypatch)
    loaded = checkpoint.load_state(tmp_path / "s")
    assert seen == ["cuda"] * len(qt.BFGSState._fields)
    assert loaded.x.dtype == torch.float32 and loaded.k.dtype == torch.int32


def test_refusals_match_jax(tmp_path):
    part = qt.optimize(rosenbrock_logdensity, torch.tensor(_starts()[0]), max_iterations=2)
    checkpoint.save_state(tmp_path / "s", part.state)
    with pytest.raises(TypeError, match="checkpoint holds BFGSState, expected LBFGSState"):
        checkpoint.load_state(tmp_path / "s", qt.LBFGSState, device="cpu")
    with pytest.raises(TypeError, match="checkpoint holds BFGSState, expected LBFGSState"):
        jax_checkpoint.load_state(tmp_path / "s", qnm.LBFGSState)
    with pytest.raises(TypeError, match="expected a solver or sampler state NamedTuple"):
        checkpoint.save_state(tmp_path / "r", part)
    with np.load(tmp_path / "s.npz") as z:
        arrays = {k: z[k] for k in z.files if k != "B"}
    np.savez(tmp_path / "m.npz", **arrays)
    for load in (lambda p: checkpoint.load_state(p, device="cpu"), jax_checkpoint.load_state):
        with pytest.raises(KeyError, match="missing required field 'B' of BFGSState"):
            load(tmp_path / "m.npz")


def test_sampler_states_and_prng_keys_are_not_yet_ported(tmp_path):
    """Every JAX sampler state loads in the port since the tempering,
    ensemble and MCLMC states were ported: a JAX PTState crosses to the
    port and back leaf for leaf (the three states' runs and resumes are
    tests/test_torch_mclmc.py, test_torch_ensemble.py and
    test_torch_tempering.py). A PRNG key anywhere but a sampler state's
    ``key`` field still raises, and so does a tuple that only carries a
    state's name."""
    import jax

    from quasinewtonmethods_jl_tpu.tempering import PTState

    jax_state = PTState(*(jnp.full((), i, jnp.float64) for i, _ in enumerate(PTState._fields)))
    jax_checkpoint.save_state(tmp_path / "pt", jax_state)
    port_state = checkpoint.load_state(tmp_path / "pt", device="cpu")
    assert isinstance(port_state, qt.PTState)
    checkpoint.save_state(tmp_path / "back", port_state)
    back = jax_checkpoint.load_state(tmp_path / "back")
    for field in PTState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, field)),
                                      np.asarray(getattr(jax_state, field)), err_msg=field)
    with np.load(tmp_path / "pt.npz") as z:
        arrays = {k: z[k] for k in z.files}
    arrays["__class__"] = np.asarray("BFGSState")
    arrays["__key_fields__"] = np.asarray(["x"])
    arrays["__key_impls__"] = np.asarray([str(jax.random.key_impl(jax.random.key(0)))])
    np.savez(tmp_path / "keyed.npz", **arrays)
    with pytest.raises(TypeError, match="PRNG keys in \\['x'\\].*only in a sampler state"):
        checkpoint.load_state(tmp_path / "keyed.npz", device="cpu")

    class PTStateLike(tuple):
        pass

    PTStateLike.__name__ = "PTState"
    with pytest.raises(TypeError, match="expected a solver or sampler state NamedTuple"):
        checkpoint.save_state(tmp_path / "x", PTStateLike())