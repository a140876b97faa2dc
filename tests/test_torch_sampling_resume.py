"""Sampler checkpoint and resume in the port (sampling.py,
utils/checkpoint.py): chunked runs equal long ones bit for bit with the
port's own noise (tests/test_sampler_resume.py:33-63, :109-168), every
phase and mass-mode guard keeps JAX's text (:206-288), and sampler states
cross `save_state` / `load_state` in both directions with the JAX package
(typed ``threefry2x32`` keys, raw keys and the port's keys).
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

torch.set_num_threads(1)

_W = np.asarray([1.0, 4.0, 0.25])


def port_logd(t):
    return -0.5 * torch.sum(t * t * torch.tensor(_W, dtype=t.dtype))


def jax_logd(t):
    return -0.5 * jnp.sum(t * t * jnp.asarray(_W))


def x0():
    return np.random.default_rng(0).standard_normal((16, 3))


def equal(a, b):
    assert torch.equal(a, b)


def test_hmc_chunked_equals_long():
    X = torch.tensor(x0())
    long = qt.hmc_sample(port_logd, 0, X, n_samples=40, n_warmup=30)
    r1 = qt.hmc_sample(port_logd, 0, X, n_samples=0, n_warmup=18)
    r2 = qt.hmc_sample_from_state(port_logd, r1.state, n_samples=15, n_warmup=12)
    r3 = qt.hmc_sample_from_state(port_logd, r2.state, n_samples=25)
    equal(long.samples, torch.cat([r2.samples, r3.samples]))
    equal(long.final_x, r3.final_x)
    equal(long.step_size, r3.step_size)
    for field in qt.HMCState._fields:
        equal(getattr(long.state, field), getattr(r3.state, field))


@pytest.mark.parametrize("adapt", ["diag", "dense", "lowrank"])
def test_chees_chunked_equals_long(adapt):
    X = torch.tensor(x0())
    long = qt.chees_sample(port_logd, 1, X, n_samples=40, n_warmup=30, adapt_mass=adapt,
                           mass_rank=2)
    r1 = qt.chees_sample(port_logd, 1, X, n_samples=0, n_warmup=18, total_warmup=30,
                         adapt_mass=adapt, mass_rank=2)
    r2 = qt.chees_sample_from_state(port_logd, r1.state, n_samples=15, n_warmup=12,
                                    adapt_mass=adapt)
    r3 = qt.chees_sample_from_state(port_logd, r2.state, n_samples=25, adapt_mass=adapt)
    equal(long.samples, torch.cat([r2.samples, r3.samples]))
    for field in ("final_x", "traj_length", "mass_diag", "step_size"):
        equal(getattr(long, field), getattr(r3, field))
    for field in qt.ChEESState._fields:
        a, b = getattr(long.state, field), getattr(r3.state, field)
        assert (a is None) == (adapt != "lowrank" and field in ("lr_Q", "lr_sig"))
        if a is not None:
            equal(a, b)


def test_resume_respects_mass_freeze_schedule():
    X = torch.tensor(x0())
    long = qt.chees_sample(port_logd, 5, X, n_samples=0, n_warmup=20)
    r1 = qt.chees_sample(port_logd, 5, X, n_samples=0, n_warmup=7, total_warmup=20)
    # crosses the freeze step (20 // 2 = 10) mid-chunk
    r2 = qt.chees_sample_from_state(port_logd, r1.state, n_warmup=13)
    equal(long.state.var_ema, r2.state.var_ema)
    equal(long.state.log_T, r2.state.log_T)


def test_from_state_reads_its_counters_once():
    X = torch.tensor(x0())
    r1 = qt.hmc_sample(port_logd, 0, X, n_samples=0, n_warmup=3)
    before = qt.hmc_sample.host_syncs
    qt.hmc_sample_from_state(port_logd, r1.state, n_samples=2)
    assert qt.hmc_sample.host_syncs - before == 1
    c1 = qt.chees_sample(port_logd, 0, X, n_samples=0, n_warmup=3, total_warmup=5)
    before = qt.chees_sample.host_syncs
    qt.chees_sample_from_state(port_logd, c1.state, n_warmup=2, n_samples=2)
    assert qt.chees_sample.host_syncs - before == 1 + 4  # the counters, then a read a round


def _errors(fn_port, fn_jax):
    with pytest.raises(ValueError) as port_err:
        fn_port()
    with pytest.raises(ValueError) as jax_err:
        fn_jax()
    assert str(port_err.value) == str(jax_err.value)
    return str(port_err.value)


def test_phase_guards_keep_jax_text():
    X, Xj = torch.tensor(x0()), jnp.asarray(x0())
    key = jax.random.PRNGKey(4)
    r = qt.chees_sample(port_logd, 4, X, n_samples=5, n_warmup=5)
    rj = qj.chees_sample(jax_logd, key, Xj, n_samples=5, n_warmup=5)
    assert "after sampling" in _errors(
        lambda: qt.chees_sample_from_state(port_logd, r.state, n_warmup=3),
        lambda: qj.chees_sample_from_state(jax_logd, rj.state, n_warmup=3))
    r0 = qt.chees_sample(port_logd, 4, X, n_samples=0, n_warmup=3, total_warmup=10)
    r0j = qj.chees_sample(jax_logd, key, Xj, n_samples=0, n_warmup=3, total_warmup=10)
    assert "plan exceeded" in _errors(
        lambda: qt.chees_sample_from_state(port_logd, r0.state, n_warmup=20),
        lambda: qj.chees_sample_from_state(jax_logd, r0j.state, n_warmup=20))
    assert "before the announced" in _errors(
        lambda: qt.chees_sample_from_state(port_logd, r0.state, n_samples=2, n_warmup=1),
        lambda: qj.chees_sample_from_state(jax_logd, r0j.state, n_samples=2, n_warmup=1))
    assert "before the announced" in _errors(
        lambda: qt.chees_sample(port_logd, 4, X, n_samples=2, n_warmup=3, total_warmup=10),
        lambda: qj.chees_sample(jax_logd, key, Xj, n_samples=2, n_warmup=3, total_warmup=10))
    assert "exceeds total_warmup" in _errors(
        lambda: qt.chees_sample(port_logd, 4, X, n_samples=0, n_warmup=30, total_warmup=10),
        lambda: qj.chees_sample(jax_logd, key, Xj, n_samples=0, n_warmup=30, total_warmup=10))
    h = qt.hmc_sample(port_logd, 4, X, n_samples=3, n_warmup=2)
    hj = qj.hmc_sample(jax_logd, key, Xj, n_samples=3, n_warmup=2)
    assert "after sampling" in _errors(
        lambda: qt.hmc_sample_from_state(port_logd, h.state, n_warmup=1),
        lambda: qj.hmc_sample_from_state(jax_logd, hj.state, n_warmup=1))


@pytest.mark.parametrize("saved,passed", [("dense", True), ("dense", "diag"),
                                          ("lowrank", True), ("lowrank", "dense"),
                                          ("diag", "lowrank")])
def test_resume_mass_mode_mismatch_keeps_jax_text(saved, passed):
    X, Xj = torch.tensor(x0()), jnp.asarray(x0())
    kw = {"n_samples": 0, "n_warmup": 4, "total_warmup": 10, "adapt_mass": saved,
          "mass_rank": 2}
    r = qt.chees_sample(port_logd, 6, X, **kw)
    rj = qj.chees_sample(jax_logd, jax.random.PRNGKey(6), Xj, **kw)
    assert "does not match the saved" in _errors(
        lambda: qt.chees_sample_from_state(port_logd, r.state, n_warmup=3, adapt_mass=passed),
        lambda: qj.chees_sample_from_state(jax_logd, rj.state, n_warmup=3, adapt_mass=passed))
    # the correct re-pass works
    qt.chees_sample_from_state(port_logd, r.state, n_warmup=3, adapt_mass=saved)


def test_adapt_mass_error_keeps_jax_text():
    X, Xj = torch.tensor(x0()), jnp.asarray(x0())
    _errors(lambda: qt.chees_sample(port_logd, 0, X, n_samples=0, n_warmup=1, adapt_mass="full"),
            lambda: qj.chees_sample(jax_logd, jax.random.PRNGKey(0), Xj, n_samples=0,
                                    n_warmup=1, adapt_mass="full"))


# ---------------------------------------------------------------------------
# Checkpoints, in the port and across the packages
# ---------------------------------------------------------------------------


def _port_runs():
    X = torch.tensor(x0())
    return {
        "hmc": qt.hmc_sample(port_logd, 3, X, n_samples=0, n_warmup=10),
        "chees": qt.chees_sample(port_logd, 3, X, n_samples=0, n_warmup=6, total_warmup=10),
        "chees_lowrank": qt.chees_sample(port_logd, 3, X, n_samples=0, n_warmup=6,
                                         total_warmup=10, adapt_mass="lowrank", mass_rank=2),
    }


def _port_resume(name, state):
    if name == "hmc":
        return qt.hmc_sample_from_state(port_logd, state, n_samples=8)
    adapt = "lowrank" if name == "chees_lowrank" else True
    return qt.chees_sample_from_state(port_logd, state, n_samples=8, n_warmup=4,
                                      adapt_mass=adapt)


def _jax_resume(name, state):
    if name == "hmc":
        return qj.hmc_sample_from_state(jax_logd, state, n_samples=8)
    adapt = "lowrank" if name == "chees_lowrank" else True
    return qj.chees_sample_from_state(jax_logd, state, n_samples=8, n_warmup=4,
                                      adapt_mass=adapt)


def test_sampler_state_checkpoint_roundtrip_in_the_port(tmp_path):
    for name, r in _port_runs().items():
        checkpoint.save_state(tmp_path / name, r.state)
        with np.load(tmp_path / f"{name}.npz") as z:
            assert z["key"].dtype == np.uint32 and z["key"].shape == (2,)
            assert z["__key_fields__"].size == 0
            assert ("lr_Q" in z.files) == (name == "chees_lowrank")
        st = checkpoint.load_state(tmp_path / name, type(r.state), device="cpu")
        assert type(st) is type(r.state)
        for field, a, b in zip(st._fields, st, r.state):
            assert (a is None) == (b is None), field
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), field
        assert st.key.device.type == "cpu" and st.key.dtype == torch.int64
        equal(_port_resume(name, st).samples, _port_resume(name, r.state).samples)


@pytest.mark.parametrize("typed", [True, False], ids=["typed_key", "raw_key"])
def test_jax_sampler_states_load_in_the_port_and_go_back(tmp_path, typed):
    """JAX's state (typed or raw key) loads in the port leaf for leaf; the
    port writes it back, and JAX resumes from that file exactly as from
    its own state."""
    key = jax.random.key(7) if typed else jax.random.PRNGKey(7)
    Xj = jnp.asarray(x0())
    runs = {
        "hmc": qj.hmc_sample(jax_logd, key, Xj, n_samples=0, n_warmup=10),
        "chees": qj.chees_sample(jax_logd, key, Xj, n_samples=0, n_warmup=6, total_warmup=10),
        "chees_lowrank": qj.chees_sample(jax_logd, key, Xj, n_samples=0, n_warmup=6,
                                         total_warmup=10, adapt_mass="lowrank", mass_rank=2),
    }
    words = np.asarray(jax.random.key_data(key) if typed else key).astype(np.int64)
    for name, r in runs.items():
        jax_checkpoint.save_state(tmp_path / f"j_{name}", r.state)
        st = checkpoint.load_state(tmp_path / f"j_{name}", device="cpu")
        assert type(st).__name__ == type(r.state).__name__
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
        np.testing.assert_array_equal(_jax_resume(name, back).samples,
                                      _jax_resume(name, r.state).samples)


def test_a_port_saved_state_resumes_in_jax(tmp_path):
    for name, r in _port_runs().items():
        checkpoint.save_state(tmp_path / name, r.state)
        st = jax_checkpoint.load_state(tmp_path / name)
        np.testing.assert_array_equal(np.asarray(st.x), r.state.x.numpy())
        np.testing.assert_array_equal(np.asarray(st.key), r.state.key.numpy())
        out = _jax_resume(name, st)
        assert out.samples.shape == (8, 16, 3) and np.all(np.isfinite(np.asarray(out.samples)))


def test_other_key_impls_and_unported_sampler_states_raise(tmp_path):
    """A key of another impl raises; the tempering, ensemble and MCLMC
    states, refused until they were ported, now cross from JAX to the port
    and back (their runs and resumes: tests/test_torch_mclmc.py,
    test_torch_ensemble.py, test_torch_tempering.py)."""
    r = qt.hmc_sample(port_logd, 3, torch.tensor(x0()), n_samples=0, n_warmup=2)
    checkpoint.save_state(tmp_path / "s", r.state)
    with np.load(tmp_path / "s.npz") as z:
        arrays = {k: z[k] for k in z.files}
    arrays["__key_fields__"] = np.asarray(["key"])
    arrays["__key_impls__"] = np.asarray(["rbg"])
    np.savez(tmp_path / "rbg.npz", **arrays)
    with pytest.raises(TypeError, match="rbg PRNG key.*only threefry2x32"):
        checkpoint.load_state(tmp_path / "rbg.npz", device="cpu")
    Xj = jnp.asarray(x0()[:8])
    key = jax.random.key(3)
    runs = {
        "PTState": qj.pt_sample(jax_logd, key, Xj, n_temps=2, n_samples=0, n_warmup=2,
                                n_leapfrog=2),
        "EnsembleState": qj.ensemble_sample(jax_logd, key, Xj, n_samples=0, n_warmup=2),
        "MCLMCState": qj.mclmc_sample(jax_logd, key, Xj, n_samples=0, n_warmup=2),
    }
    for name, res in runs.items():
        jax_checkpoint.save_state(tmp_path / name, res.state)
        st = checkpoint.load_state(tmp_path / name, device="cpu")
        assert type(st).__name__ == name and type(st) is getattr(qt, name)
        np.testing.assert_array_equal(st.key.numpy(), np.asarray(jax.random.key_data(key)))
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(res.state.x))
        checkpoint.save_state(tmp_path / f"p_{name}", st)
        back = jax_checkpoint.load_state(tmp_path / f"p_{name}")
        for field in st._fields:
            if field != "key":
                np.testing.assert_array_equal(np.asarray(getattr(back, field)),
                                              np.asarray(getattr(res.state, field)), err_msg=field)
