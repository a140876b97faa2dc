"""The port's affine-invariant ensemble sampler (ensemble.py) against the
JAX package's, f64 on the CPU.

Every run is held against JAX with JAX's own draws injected through the
port's seam `_ensemble_half_noise` (JAX: with ``k = fold_in(fold_in(key,
phase), step)`` and ``kA, kB = split(k)``, each half's ``k_part, k_z, k_u
= split(k_half, 3)``: the partner indices or the shift offset, the
stretch uniforms and the accept uniforms). Every accept decision is then
equal to JAX's, and the walkers, their cached logdensities and the
acceptance rates agree to 1e-12. With the port's own noise:
tests/test_ensemble.py's resume, checkpoint, dtype and validation cases
(:71-141); chunked runs equal long ones bit for bit and states cross
`save_state` / `load_state` both ways with JAX. `ensemble_autocorr_time`
equals JAX's on the same arrays to 1e-12. The statistical cases are
tests/test_torch_ensemble_stats.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu.utils import checkpoint as jax_checkpoint
from quasinewtonmethods_jl_tpu_torch import ensemble
from quasinewtonmethods_jl_tpu_torch.utils import checkpoint
from test_torch_sampling_hmc import jax_key, starts

torch.set_num_threads(1)

RTOL = 1e-12
JAX_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def jax_half_noise(key, phase, step, half, w2, partner, dtype, device):
    """JAX `_full_step` / `_half_step`'s draws (ensemble.py:100-112, :145-147)."""
    k = jax.random.fold_in(jax.random.fold_in(jax_key(key), phase), step)
    k_part, k_z, k_u = jax.random.split(jax.random.split(k)[half], 3)
    if partner == "gather":
        pick = torch.tensor(np.asarray(jax.random.randint(k_part, (w2,), 0, w2)),
                            dtype=torch.int64)
    else:
        pick = int(jax.random.randint(k_part, (), 0, w2))
    return (pick,
            torch.tensor(np.asarray(jax.random.uniform(k_z, (w2,), JAX_DTYPE[dtype]))),
            torch.tensor(np.asarray(jax.random.uniform(k_u, (w2,), JAX_DTYPE[dtype]))))


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(ensemble, "_ensemble_half_noise", jax_half_noise)


def corr_gaussian():
    """tests/test_ensemble.py's correlated Gaussian: (jax_f, port_f, mu, cov)."""
    L = np.array([[1.0, 0, 0], [0.6, 0.8, 0], [-0.3, 0.4, 1.2]])
    cov = L @ L.T
    P, mu = np.linalg.inv(cov), np.asarray([1.0, -2.0, 0.5])

    def jax_f(x):
        d = x - jnp.asarray(mu)
        return -0.5 * d @ (jnp.asarray(P) @ d)

    def port_f(x):
        d = x - torch.tensor(mu, dtype=x.dtype)
        return -0.5 * d @ (torch.tensor(P, dtype=x.dtype) @ d)

    return jax_f, port_f, mu, cov


def jax_ball(x):
    r2 = jnp.sum(x * x)
    return jnp.where(r2 < 4.0, -0.5 * r2, -jnp.inf)


def port_ball(x):
    r2 = torch.sum(x * x)
    return torch.where(r2 < 4.0, -0.5 * r2, -torch.inf)


def jax_nan(x):
    """A logdensity that is NaN past x0 = 1.5 (read as -inf)."""
    return jnp.where(x[0] > 1.5, jnp.nan, -0.5 * jnp.sum(x * x))


def port_nan(x):
    return torch.where(x[0] > 1.5, torch.nan, -0.5 * torch.sum(x * x))


def close(a, b):
    """Equal non-finite entries, finite ones within RTOL normwise."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(a[~fin], b[~fin])
    if fin.any():
        scale = max(float(np.max(np.abs(b[fin]))), 1.0)
        assert float(np.max(np.abs(a[fin] - b[fin]))) <= RTOL * scale


def moves(samples):
    """(draws - 1, walkers): whether each walker moved between consecutive
    draws (an accepted stretch moves it)."""
    return np.any(samples[1:] != samples[:-1], axis=-1)


def compare(port, ref):
    """Every accept decision equal (the acceptance counts, and whether each
    walker moved between consecutive draws), floats within RTOL."""
    np.testing.assert_array_equal(port.state.n_accept.numpy(), np.asarray(ref.state.n_accept))
    assert port.state.n_accept.dtype == torch.int32
    np.testing.assert_array_equal(moves(port.samples.numpy()), moves(np.asarray(ref.samples)))
    for a, b in ((port.samples, ref.samples), (port.final_x, ref.final_x),
                 (port.state.f, ref.state.f), (port.accept_rate, ref.accept_rate)):
        assert tuple(a.shape) == tuple(np.shape(b))
        close(a, b)
    assert port.accept_rate.dtype == port.final_x.dtype
    for f in ("phase", "step"):
        assert int(getattr(port.state, f)) == int(getattr(ref.state, f)), f
    np.testing.assert_array_equal(port.state.key.numpy(),
                                  np.asarray(jax.random.key_data(ref.state.key)))


def _cases():
    jf, pf, _mu, _cov = corr_gaussian()
    outside = np.vstack([np.full((8, 2), 2.2), np.zeros((8, 2))])
    return {
        # (jax_f, port_f, x0, partner)
        "gather": (jf, pf, starts(16, 3), "gather"),
        "shift": (jf, pf, starts(16, 3), "shift"),
        "outside_start": (jax_ball, port_ball, outside, "gather"),
        "nan_logdensity": (jax_nan, port_nan, starts(12, 3), "shift"),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_ensemble_equals_jax_with_jax_noise(jax_noise, case):
    jax_f, port_f, x0, partner = CASES[case]
    kw = {"n_samples": 30, "n_warmup": 20, "partner": partner}
    before = qt.ensemble_sample.value_evals
    port = qt.ensemble_sample(port_f, 3, torch.tensor(x0), **kw)
    assert qt.ensemble_sample.value_evals - before == 1 + 2 * 50
    ref = qj.ensemble_sample(jax_f, jax.random.PRNGKey(3), jnp.asarray(x0), **kw)
    compare(port, ref)


def test_a_resume_across_the_phase_transition_equals_jax(jax_noise):
    """20 warmup steps, then 10 more through a resume that crosses into
    sampling, then a sampling-phase resume — each leg against JAX's."""
    jf, pf, _mu, _cov = corr_gaussian()
    x0 = starts(16, 3)
    a = qt.ensemble_sample(pf, 2, torch.tensor(x0), n_samples=0, n_warmup=20)
    ra = qj.ensemble_sample(jf, jax.random.PRNGKey(2), jnp.asarray(x0), n_samples=0,
                            n_warmup=20)
    assert int(a.state.phase) == 0 and a.samples.shape == (0, 16, 3)
    compare(a, ra)  # n_samples = 0: the warmup's accepts are the rate
    syncs = qt.ensemble_sample.host_syncs
    b = qt.ensemble_sample_from_state(pf, a.state, n_samples=15, n_warmup=10)
    rb = qj.ensemble_sample_from_state(jf, ra.state, n_samples=15, n_warmup=10)
    assert qt.ensemble_sample.host_syncs == syncs + 1
    compare(b, rb)
    c = qt.ensemble_sample_from_state(pf, b.state, n_samples=10, n_warmup=5)
    rc = qj.ensemble_sample_from_state(jf, rb.state, n_samples=10, n_warmup=5)
    compare(c, rc)


def test_ensemble_float32_equals_jax_with_jax_noise(jax_noise):
    jf, pf, _mu, _cov = corr_gaussian()
    x0 = starts(16, 3).astype(np.float32)
    port = qt.ensemble_sample(pf, 4, torch.tensor(x0), n_samples=20, n_warmup=10)
    ref = qj.ensemble_sample(lambda x: jf(x.astype(jnp.float32)), jax.random.PRNGKey(4),
                             jnp.asarray(x0), n_samples=20, n_warmup=10)
    assert port.samples.dtype == port.accept_rate.dtype == torch.float32
    np.testing.assert_array_equal(port.state.n_accept.numpy(), np.asarray(ref.state.n_accept))
    np.testing.assert_allclose(port.samples.numpy(), np.asarray(ref.samples), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port.accept_rate.numpy(), np.asarray(ref.accept_rate))


AUTOCORR_ARRAYS = {
    "iid": lambda rng: rng.standard_normal((400, 16, 3)),
    "ar1": lambda rng: np.cumsum(rng.standard_normal((300, 8, 2)), axis=0) * 0.1
    + rng.standard_normal((300, 8, 2)),
    "frozen_walker": lambda rng: np.concatenate(
        [rng.standard_normal((64, 6, 2)), np.ones((64, 2, 2))], axis=1),
    "eight_draws": lambda rng: rng.standard_normal((8, 4, 3)),
}


@pytest.mark.parametrize("name", sorted(AUTOCORR_ARRAYS))
def test_autocorr_time_equals_jax(name):
    from quasinewtonmethods_jl_tpu.ensemble import ensemble_autocorr_time as jax_tau

    x = AUTOCORR_ARRAYS[name](np.random.default_rng(8))
    for c in (5.0, 2.0):
        tau, rel = qt.ensemble_autocorr_time(torch.tensor(x), c=c)
        ref_tau, ref_rel = jax_tau(jnp.asarray(x), c=c)
        np.testing.assert_allclose(tau, np.asarray(ref_tau), rtol=1e-12, atol=0)
        np.testing.assert_array_equal(rel, np.asarray(ref_rel))
    with pytest.raises(ValueError) as mine:
        qt.ensemble_autocorr_time(torch.tensor(x[:7]))
    with pytest.raises(ValueError) as theirs:
        jax_tau(x[:7])
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# Resume, checkpoints, guards and dtypes with the port's own noise
# ---------------------------------------------------------------------------


def test_ensemble_resume_bitwise():
    """tests/test_ensemble.py:71-92."""
    _jf, pf, _mu, _cov = corr_gaussian()
    x0s = torch.tensor(np.random.default_rng(2).standard_normal((16, 3)))
    long = qt.ensemble_sample(pf, 2, x0s, n_samples=100, n_warmup=50)
    a = qt.ensemble_sample(pf, 2, x0s, n_samples=40, n_warmup=50)
    b = qt.ensemble_sample_from_state(pf, a.state, n_samples=60)
    assert torch.equal(long.samples[40:], b.samples)
    assert torch.equal(long.final_x, b.final_x)
    c = qt.ensemble_sample(pf, 2, x0s, n_samples=0, n_warmup=20)
    assert int(c.state.phase) == 0
    d = qt.ensemble_sample_from_state(pf, c.state, n_samples=100, n_warmup=30)
    assert torch.equal(long.samples, d.samples)
    for f in qt.EnsembleState._fields:
        assert torch.equal(getattr(long.state, f), getattr(d.state, f)), f
    assert torch.equal(long.accept_rate, d.accept_rate)
    for partner in ("gather", "shift"):
        e = qt.ensemble_sample(pf, 3, x0s, n_samples=20, n_warmup=10, partner=partner)
        f1 = qt.ensemble_sample(pf, 3, x0s, n_samples=8, n_warmup=10, partner=partner)
        f2 = qt.ensemble_sample_from_state(pf, f1.state, n_samples=12, partner=partner)
        assert torch.equal(e.samples, torch.cat([f1.samples, f2.samples]))


def test_ensemble_checkpoint_roundtrip(tmp_path):
    """tests/test_ensemble.py:95-111 in the port."""
    _jf, pf, _mu, _cov = corr_gaussian()
    x0s = torch.tensor(np.random.default_rng(3).standard_normal((8, 3)))
    a = qt.ensemble_sample(pf, 3, x0s, n_samples=10, n_warmup=10)
    checkpoint.save_state(tmp_path / "ens", a.state)
    loaded = checkpoint.load_state(tmp_path / "ens", device="cpu")
    assert type(loaded).__name__ == "EnsembleState"
    for f, x, y in zip(loaded._fields, loaded, a.state):
        assert x.dtype == y.dtype and torch.equal(x, y), f
    b = qt.ensemble_sample_from_state(pf, loaded, n_samples=20)
    c = qt.ensemble_sample_from_state(pf, a.state, n_samples=20)
    assert torch.equal(b.samples, c.samples)


def test_states_cross_checkpoints_both_ways_with_jax(jax_noise, tmp_path):
    """JAX writes its EnsembleState's typed key; the port loads it and
    resumes as JAX does (JAX's draws injected); the port's state, saved
    with a raw key, resumes in JAX."""
    jf, pf, _mu, _cov = corr_gaussian()
    x0 = starts(16, 3)
    ref = qj.ensemble_sample(jf, jax.random.PRNGKey(9), jnp.asarray(x0), n_samples=5,
                             n_warmup=10)
    jax_checkpoint.save_state(tmp_path / "j", ref.state)
    with np.load(tmp_path / "j.npz") as z:
        assert z["__key_fields__"].tolist() == ["key"]
    st = checkpoint.load_state(tmp_path / "j", device="cpu")
    assert isinstance(st, qt.EnsembleState)
    np.testing.assert_array_equal(st.key.numpy(), [0, 9])
    for f in ("x", "f", "phase", "step", "n_accept"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(ref.state, f)))
    mine = qt.ensemble_sample_from_state(pf, st, n_samples=10)
    theirs = qj.ensemble_sample_from_state(jf, ref.state, n_samples=10)
    compare(mine, theirs)
    checkpoint.save_state(tmp_path / "p", mine.state)
    back = jax_checkpoint.load_state(tmp_path / "p")
    out = qj.ensemble_sample_from_state(jf, back, n_samples=5)
    again = qt.ensemble_sample_from_state(pf, mine.state, n_samples=5)
    np.testing.assert_array_equal(np.asarray(out.state.n_accept), again.state.n_accept.numpy())
    close(again.samples, out.samples)


def test_ensemble_f32_under_x64():
    """tests/test_ensemble.py:114-126."""
    _jf, pf, _mu, _cov = corr_gaussian()
    x0s = torch.tensor(np.random.default_rng(4).standard_normal((16, 3)), dtype=torch.float32)
    r = qt.ensemble_sample(pf, 4, x0s, n_samples=20, n_warmup=10)
    assert r.samples.dtype == r.final_x.dtype == r.accept_rate.dtype == torch.float32
    assert r.n_walkers == 16


def test_ensemble_validation_keeps_jax_text():
    """tests/test_ensemble.py:129-141, with JAX's messages."""
    _jf, pf, _mu, _cov = corr_gaussian()
    cases = [((np.zeros(3),), {}), ((np.zeros((5, 3)),), {}), ((np.zeros((8, 3)),), {"a": 1.0}),
             ((np.zeros((8, 3)),), {"partner": "roulette"}),
             ((np.zeros((8, 3)),), {"mass": np.ones(3)}),
             ((np.zeros((8, 3)),), {"n_samples": -1})]
    for (x,), kw in cases:
        with pytest.raises(ValueError) as mine:
            qt.ensemble_sample(pf, 0, torch.tensor(x), **kw)
        with pytest.raises(ValueError) as theirs:
            qj.ensemble_sample(lambda v: -jnp.sum(v * v), jax.random.PRNGKey(0), jnp.asarray(x),
                               **kw)
        assert str(mine.value) == str(theirs.value), kw
    r = qt.ensemble_sample(pf, 0, torch.zeros((8, 3), dtype=torch.float64), n_samples=1,
                           n_warmup=1)
    with pytest.raises(ValueError, match="partner"):
        qt.ensemble_sample_from_state(pf, r.state, partner="roulette")


def test_registry_resolves_the_ensemble():
    assert qt.sampling.get_sampler("ensemble") is qt.ensemble_sample


def test_no_autograd_graph_is_built():
    """The stretch move evaluates values only: the objective never sees a
    tensor that requires a gradient."""
    seen = []

    def logd(x):
        seen.append(x.requires_grad)
        return -0.5 * torch.sum(x * x)

    r = qt.ensemble_sample(logd, 1, torch.tensor(starts(8, 2)), n_samples=3, n_warmup=2)
    assert seen and not any(seen)
    assert not r.samples.requires_grad and r.samples.grad_fn is None
