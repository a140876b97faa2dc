"""NUTS checkpoint and resume in the port (sampling.py,
utils/checkpoint.py): chunked runs equal long ones bit for bit with the
port's own noise (tests/test_sampler_resume.py:64-100,
tests/test_sampling.py:735-760 and :840-855), every phase and mass-mode
guard keeps JAX's text (tests/test_sampler_resume.py:169-290), and
`NUTSState` crosses `save_state` / `load_state` in both directions with
the JAX package, with and without ``lr_Q`` and ``warm_dsum``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu.utils import checkpoint as jax_checkpoint
from quasinewtonmethods_jl_tpu_torch.utils import checkpoint
from test_torch_sampling_resume import equal, jax_logd, port_logd, x0

torch.set_num_threads(1)

COUNTERS = ("i_warm", "i_samp", "n_warmup_total", "mass_freeze")


def assert_states_equal(a, b):
    for field, u, v in zip(qt.NUTSState._fields, a, b):
        assert (u is None) == (v is None), field
        if u is not None:
            assert u.dtype == v.dtype and torch.equal(u, v), field


@pytest.mark.parametrize("adapt", ["diag", "dense", "lowrank"])
def test_nuts_chunked_equals_long(adapt):
    """Three chunks, the first boundary before the mass freeze (20 // 2 =
    10), against one long run: samples, energies, divergences, every
    result field and every state leaf, warm_dsum included."""
    X = torch.tensor(x0())
    kw = {"adapt_mass": adapt}
    long = qt.nuts_sample(port_logd, 2, X, n_samples=30, n_warmup=20, mass_rank=2, **kw)
    r1 = qt.nuts_sample(port_logd, 2, X, n_samples=0, n_warmup=7, total_warmup=20, mass_rank=2,
                        **kw)
    r2 = qt.nuts_sample_from_state(port_logd, r1.state, n_samples=10, n_warmup=13, **kw)
    r3 = qt.nuts_sample_from_state(port_logd, r2.state, n_samples=20, **kw)
    equal(long.samples, torch.cat([r2.samples, r3.samples]))
    equal(long.energies, torch.cat([r2.energies, r3.energies]))
    equal(long.divergences, r2.divergences + r3.divergences)
    for field in ("final_x", "mass_diag", "step_size"):
        equal(getattr(long, field), getattr(r3, field))
    assert_states_equal(long.state, r3.state)
    assert (long.state.lr_Q is None) == (adapt != "lowrank")
    assert float(long.state.warm_dsum.sum()) > 0


def test_nuts_energies_chunked_identical():
    """tests/test_sampling.py:840-855: chunked runs concatenate to the long
    run's energies and sum to its divergence counts."""
    logd = lambda x: -0.5 * torch.sum(x * x)  # noqa: E731
    x0s = torch.randn((8, 3), generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    long = qt.nuts_sample(logd, 6, x0s, n_samples=120, n_warmup=80)
    r1 = qt.nuts_sample(logd, 6, x0s, n_samples=50, n_warmup=80)
    r2 = qt.nuts_sample_from_state(logd, r1.state, n_samples=70)
    equal(torch.cat([r1.energies, r2.energies]), long.energies)
    assert int(r1.divergences.sum() + r2.divergences.sum()) == int(long.divergences.sum())


def test_from_state_reads_its_counters_once():
    r1 = qt.nuts_sample(port_logd, 0, torch.tensor(x0()), n_samples=0, n_warmup=3)
    before = qt.nuts_sample.host_syncs
    out = qt.nuts_sample_from_state(port_logd, r1.state)
    assert qt.nuts_sample.host_syncs - before == 1
    assert out.samples.shape == (0, 16, 3)
    assert bool(torch.isnan(out.accept_prob).all() & torch.isnan(out.mean_tree_depth).all())


def jax_state(state):
    """The port's state as the JAX package's (raw key)."""
    return qj.NUTSState(*(None if leaf is None
                          else jnp.asarray(leaf.numpy().astype(np.uint32)) if field == "key"
                          else jnp.asarray(leaf.numpy())
                          for field, leaf in zip(state._fields, state)))


def _errors(fn_port, fn_jax):
    with pytest.raises(ValueError) as port_err:
        fn_port()
    with pytest.raises(ValueError) as jax_err:
        fn_jax()
    assert str(port_err.value) == str(jax_err.value)
    return str(port_err.value)


def test_phase_guards_keep_jax_text():
    """The guards raise before any tree is built; JAX's are called on the
    port's states carried across, so nothing compiles."""
    X, Xj = torch.tensor(x0()), jnp.asarray(x0())
    key = jax.random.PRNGKey(4)
    assert "exceeds total_warmup" in _errors(
        lambda: qt.nuts_sample(port_logd, 4, X, n_samples=0, n_warmup=30, total_warmup=10),
        lambda: qj.nuts_sample(jax_logd, key, Xj, n_samples=0, n_warmup=30, total_warmup=10))
    assert "before the announced" in _errors(
        lambda: qt.nuts_sample(port_logd, 4, X, n_samples=2, n_warmup=3, total_warmup=10),
        lambda: qj.nuts_sample(jax_logd, key, Xj, n_samples=2, n_warmup=3, total_warmup=10))
    r = qt.nuts_sample(port_logd, 4, X, n_samples=2, n_warmup=2)
    rj = jax_state(r.state)
    assert "after sampling" in _errors(
        lambda: qt.nuts_sample_from_state(port_logd, r.state, n_warmup=3),
        lambda: qj.nuts_sample_from_state(jax_logd, rj, n_warmup=3))
    r0 = qt.nuts_sample(port_logd, 4, X, n_samples=0, n_warmup=3, total_warmup=10)
    r0j = jax_state(r0.state)
    assert "plan exceeded" in _errors(
        lambda: qt.nuts_sample_from_state(port_logd, r0.state, n_warmup=20),
        lambda: qj.nuts_sample_from_state(jax_logd, r0j, n_warmup=20))
    assert "before the announced" in _errors(
        lambda: qt.nuts_sample_from_state(port_logd, r0.state, n_samples=2, n_warmup=1),
        lambda: qj.nuts_sample_from_state(jax_logd, r0j, n_samples=2, n_warmup=1))
    _errors(lambda: qt.nuts_sample(port_logd, 0, X, n_samples=0, n_warmup=1, adapt_mass="full"),
            lambda: qj.nuts_sample(jax_logd, key, Xj, n_samples=0, n_warmup=1,
                                   adapt_mass="full"))


@pytest.mark.parametrize("saved,passed", [("diag", "dense"), ("dense", True), ("dense", "diag"),
                                          ("lowrank", True), ("lowrank", "dense"),
                                          ("diag", "lowrank")])
def test_resume_mass_mode_mismatch_keeps_jax_text(saved, passed):
    X = torch.tensor(x0())
    r = qt.nuts_sample(port_logd, 6, X, n_samples=0, n_warmup=4, total_warmup=10,
                       adapt_mass=saved, mass_rank=2)
    rj = jax_state(r.state)
    assert "does not match the saved" in _errors(
        lambda: qt.nuts_sample_from_state(port_logd, r.state, n_warmup=3, adapt_mass=passed),
        lambda: qj.nuts_sample_from_state(jax_logd, rj, n_warmup=3, adapt_mass=passed))
    # the correct re-pass works
    qt.nuts_sample_from_state(port_logd, r.state, n_warmup=3, adapt_mass=saved)


# ---------------------------------------------------------------------------
# Checkpoints, in the port and across the packages
# ---------------------------------------------------------------------------


def _port_runs():
    X = torch.tensor(x0())
    diag = qt.nuts_sample(port_logd, 3, X, n_samples=0, n_warmup=6, total_warmup=10)
    return {
        "diag": diag,
        "lowrank": qt.nuts_sample(port_logd, 3, X, n_samples=0, n_warmup=6, total_warmup=10,
                                  adapt_mass="lowrank", mass_rank=2),
        # a state from before the depth telemetry
        "no_telemetry": diag._replace(state=diag.state._replace(warm_dsum=None)),
    }


def _adapt(name):
    return "lowrank" if name == "lowrank" else True


def test_nuts_state_checkpoint_roundtrip_in_the_port(tmp_path):
    for name, r in _port_runs().items():
        checkpoint.save_state(tmp_path / name, r.state)
        with np.load(tmp_path / f"{name}.npz") as z:
            assert str(z["__class__"]) == "NUTSState"
            assert z["key"].dtype == np.uint32 and z["key"].shape == (2,)
            assert ("lr_Q" in z.files) == ("lr_sig" in z.files) == (name == "lowrank")
            assert ("warm_dsum" in z.files) == (name != "no_telemetry")
        st = checkpoint.load_state(tmp_path / name, qt.NUTSState, device="cpu")
        assert type(st) is qt.NUTSState
        assert_states_equal(st, r.state)
        assert st.key.device.type == "cpu" and st.key.dtype == torch.int64
        kw = {"n_samples": 8, "n_warmup": 4, "adapt_mass": _adapt(name)}
        equal(qt.nuts_sample_from_state(port_logd, st, **kw).samples,
              qt.nuts_sample_from_state(port_logd, r.state, **kw).samples)


def _jax_resume(name, state):
    return qj.nuts_sample_from_state(jax_logd, state, n_samples=8, n_warmup=4,
                                     adapt_mass=_adapt(name))


@pytest.mark.parametrize("typed", [True, False], ids=["typed_key", "raw_key"])
def test_jax_nuts_states_load_in_the_port_and_go_back(tmp_path, typed):
    """JAX's state (typed or raw key; with lr_Q, and without warm_dsum)
    loads in the port leaf for leaf; the port writes it back, and JAX
    resumes from that file exactly as from its own state."""
    key = jax.random.key(7) if typed else jax.random.PRNGKey(7)
    Xj = jnp.asarray(x0())
    diag = qj.nuts_sample(jax_logd, key, Xj, n_samples=0, n_warmup=6, total_warmup=10)
    runs = {
        "diag": diag,
        "lowrank": qj.nuts_sample(jax_logd, key, Xj, n_samples=0, n_warmup=6, total_warmup=10,
                                  adapt_mass="lowrank", mass_rank=2),
        "no_telemetry": diag._replace(state=diag.state._replace(warm_dsum=None)),
    }
    words = np.asarray(jax.random.key_data(key) if typed else key).astype(np.int64)
    for name, r in runs.items():
        jax_checkpoint.save_state(tmp_path / f"j_{name}", r.state)
        st = checkpoint.load_state(tmp_path / f"j_{name}", device="cpu")
        assert type(st) is qt.NUTSState
        np.testing.assert_array_equal(st.key.numpy(), words)
        for field in st._fields:
            a, b = getattr(st, field), getattr(r.state, field)
            if field == "key":
                continue
            assert (a is None) == (b is None), field
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=field)
                assert a.dtype == torch.from_numpy(np.array(b)).dtype, field
        checkpoint.save_state(tmp_path / f"p_{name}", st)
        back = jax_checkpoint.load_state(tmp_path / f"p_{name}")
        assert (back.warm_dsum is None) == (name == "no_telemetry")
        np.testing.assert_array_equal(_jax_resume(name, back).samples,
                                      _jax_resume(name, r.state).samples)


def test_a_port_saved_nuts_state_resumes_in_jax(tmp_path):
    for name, r in _port_runs().items():
        checkpoint.save_state(tmp_path / name, r.state)
        st = jax_checkpoint.load_state(tmp_path / name)
        assert type(st).__name__ == "NUTSState"
        np.testing.assert_array_equal(np.asarray(st.x), r.state.x.numpy())
        np.testing.assert_array_equal(np.asarray(st.key), r.state.key.numpy())
        for field in COUNTERS:
            assert int(getattr(st, field)) == int(getattr(r.state, field)), field
        out = _jax_resume(name, st)
        assert out.samples.shape == (8, 16, 3) and np.all(np.isfinite(np.asarray(out.samples)))
