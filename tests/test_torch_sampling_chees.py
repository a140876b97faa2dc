"""The port's ChEES-HMC sampler (sampling.py) against the JAX package's,
f64 on the CPU: with JAX's noise injected through `_step_noise` (see
tests/test_torch_sampling_hmc.py), every mass form and adaptation mode
across the mass-freeze split held to JAX's at 1e-10 normwise relative,
with equal accept decisions and divergence counts; then JAX's ChEES moment
tests (tests/test_sampling.py:133-300) with the port's own noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch import sampling
from test_torch_sampling_hmc import (
    RTOL,
    compare_runs,
    corr_gaussian,
    gaussian,
    jax_chees_noise,
    normwise,
    starts,
)

torch.set_num_threads(1)

# (explicit mass, adapt_mass) of each parity case
_COV = corr_gaussian(4)[2]
CHEES_CASES = {
    "dense_mass": (_COV, True),
    "diag_mass": (np.diag(_COV), True),
    "adapt_diag": (None, "diag"),
    "adapt_dense": (None, "dense"),
    "adapt_lowrank": (None, "lowrank"),
}


def lowrank_metric(state):
    """The lowrank mode's sampling metric as a dense matrix (invariant to
    the sign of lr_Q's columns)."""
    Q, sig = np.asarray(state.lr_Q), np.asarray(state.lr_sig)
    n, r = Q.shape
    gamma = max((n - sig.sum()) / max(n - r, 1), 1e-10)
    core = gamma * (np.eye(n) - Q @ Q.T) + Q @ np.diag(sig) @ Q.T
    sd = np.sqrt(np.asarray(state.var_ema))
    return sd[:, None] * core * sd[None, :]


@pytest.mark.parametrize("case", sorted(CHEES_CASES))
def test_chees_equals_jax_with_jax_noise(monkeypatch, case):
    """16 warmup rounds (the mass freezes after 8), then 10 draws."""
    monkeypatch.setattr(sampling, "_step_noise", jax_chees_noise)
    jax_f, port_f = gaussian()
    mass, adapt = CHEES_CASES[case]
    x0 = starts(12, 4)
    kw = {"n_samples": 10, "n_warmup": 16, "adapt_mass": adapt, "mass_rank": 2}
    syncs = qt.chees_sample.host_syncs
    port = qt.chees_sample(port_f, 6, torch.tensor(x0),
                           mass=None if mass is None else torch.tensor(mass), **kw)
    assert qt.chees_sample.host_syncs - syncs == 16 + 10  # one read a round

    def ref_run(start):
        return qj.chees_sample(jax_f, jax.random.PRNGKey(6), jnp.asarray(start),
                               mass=None if mass is None else jnp.asarray(mass), **kw)

    ref = ref_run(x0)

    def witness():
        return max(max(normwise(getattr(w, f), getattr(ref, f))
                       for f in ("samples", "energies", "step_size", "final_x"))
                   for w in (ref_run(np.nextafter(x0, np.inf)), ref_run(np.nextafter(x0, -np.inf))))

    compare_runs(port, ref, x0, qt.ChEESState._fields, witness)
    assert float(port.traj_length) != 1.0  # the adaptation ran
    if adapt == "lowrank":
        assert port.state.lr_Q.shape == (4, 2)
        assert normwise(lowrank_metric(port.state), lowrank_metric(ref.state)) <= RTOL


def test_chees_divergent_run_equals_jax(monkeypatch):
    """tests/test_sampling.py:229-239: step 1e6, no warmup: every round
    diverges and is rejected, x stays put, counts equal JAX's."""
    monkeypatch.setattr(sampling, "_step_noise", jax_chees_noise)

    def jax_f(x):
        return -0.5 * jnp.sum(x * x) - 0.1 * jnp.sum(x ** 4)

    def port_f(x):
        return -0.5 * torch.sum(x * x) - 0.1 * torch.sum(x ** 4)

    x0 = np.ones((8, 3))
    kw = {"n_samples": 12, "n_warmup": 0, "step_size": 1e6}
    port = qt.chees_sample(port_f, 4, torch.tensor(x0), **kw)
    ref = qj.chees_sample(jax_f, jax.random.PRNGKey(4), jnp.asarray(x0), **kw)
    np.testing.assert_array_equal(port.divergences.numpy(), np.asarray(ref.divergences))
    assert int(port.divergences.sum()) == 12 * 8
    assert torch.equal(port.samples, torch.tensor(x0).expand(12, 8, 3))
    assert torch.equal(port.accept_rate, torch.zeros(8, dtype=torch.float64))
    assert normwise(port.energies, ref.energies) <= RTOL


def test_halton_equals_jax_bit_for_bit():
    for count in (0, 1, 7, 1000):
        mine = sampling._halton(count)
        assert mine.dtype == torch.float64
        np.testing.assert_array_equal(mine.numpy(), np.asarray(qj.sampling._halton(count)))


def test_trip_count_rounds_half_to_even_and_clips():
    before = qt.chees_sample.host_syncs
    cases = {2.5: 2, 3.5: 4, 0.2: 1, 5000.0: 1024, float("nan"): 1, float("inf"): 1024,
             -float("inf"): 1}
    for ratio, expect in cases.items():
        assert sampling._trip_count(torch.tensor(ratio, dtype=torch.float64), 1024) == expect
        r = float(jnp.clip(jnp.round(jnp.float64(ratio)).astype(jnp.int32), 1, 1024))
        assert r == expect, ratio
    assert qt.chees_sample.host_syncs - before == len(cases)


# ---------------------------------------------------------------------------
# Statistics with the port's own noise (JAX's moment tests and thresholds)
# ---------------------------------------------------------------------------


def pooled(res, n):
    return res.samples.reshape(-1, n).numpy()


def zeros(chains, n, dtype=torch.float64):
    return torch.zeros((chains, n), dtype=dtype)


def test_chees_standard_normal_moments():
    n = 4
    res = qt.chees_sample(lambda x: -0.5 * torch.sum(x * x), 0, zeros(64, n),
                          n_samples=600, n_warmup=400)
    draws = pooled(res, n)
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(draws.var(axis=0), 1.0, atol=0.15)
    acc = float(res.accept_rate.mean())
    assert 0.55 < acc <= 0.95
    assert float(res.step_size) > 0.0 and np.isfinite(float(res.step_size))
    assert float(qt.split_rhat_device(res.samples).max()) < 1.05


def test_chees_learns_longer_trajectories_for_wide_targets():
    scales = torch.tensor([1.0, 25.0, 100.0], dtype=torch.float64)
    res = qt.chees_sample(lambda x: -0.5 * torch.sum(x * x / scales), 1, zeros(64, 3),
                          n_samples=800, n_warmup=500, traj_length=0.1, adapt_mass=False)
    assert float(res.traj_length) > 0.5
    np.testing.assert_allclose(pooled(res, 3).var(axis=0), scales.numpy(), rtol=0.35)


def test_chees_fleet_mass_adaptation():
    scales = torch.tensor([0.25, 1.0, 64.0], dtype=torch.float64)
    res = qt.chees_sample(lambda x: -0.5 * torch.sum(x * x / scales), 2, zeros(128, 3),
                          n_samples=600, n_warmup=600)
    ratio = res.mass_diag.numpy() / scales.numpy()
    assert np.all(ratio > 1 / 4) and np.all(ratio < 4.0)
    np.testing.assert_allclose(pooled(res, 3).var(axis=0), scales.numpy(), rtol=0.4)


def test_chees_explicit_mass_and_reproducible():
    kw = {"n_samples": 40, "n_warmup": 20, "mass": torch.ones(2, dtype=torch.float64)}
    a = qt.chees_sample(lambda x: -0.5 * torch.sum(x * x), 3, zeros(4, 2), **kw)
    b = qt.chees_sample(lambda x: -0.5 * torch.sum(x * x), 3, zeros(4, 2), **kw)
    assert torch.equal(a.samples, b.samples)
    assert torch.equal(a.mass_diag, torch.ones(2, dtype=torch.float64))


def test_chees_divergence_rejected():
    res = qt.chees_sample(lambda x: -0.5 * torch.sum(x * x) - 0.1 * torch.sum(x ** 4), 4,
                          torch.ones((4, 3), dtype=torch.float64), n_samples=30, n_warmup=0,
                          step_size=1e6)
    assert bool(torch.isfinite(res.samples).all())
    assert torch.equal(res.accept_rate, torch.zeros(4, dtype=torch.float64))


def test_chees_dense_mass_from_map_handoff():
    _, port_f, cov = corr_gaussian(3)
    res = qt.chees_sample(port_f, 9, zeros(48, 3), mass=torch.tensor(cov), n_samples=700,
                          n_warmup=300)
    np.testing.assert_allclose(np.cov(pooled(res, 3).T), cov, atol=0.35 * np.abs(cov).max())
    np.testing.assert_allclose(res.mass_diag.numpy(), np.diagonal(cov), rtol=1e-6)
    assert float(res.accept_rate.mean()) > 0.5


def test_chees_float32_chains_stay_float32():
    """The Halton sequence is built in f64 and cast to the chains' dtype:
    float32 chains stay float32 through the warmup carry."""
    res = qt.chees_sample(lambda x: -0.5 * torch.sum(x * x), 0, zeros(8, 3, torch.float32),
                          n_samples=10, n_warmup=10)
    assert res.samples.dtype == torch.float32
    for leaf in ("log_T", "m1", "m2", "t_adam", "log_eps", "var_ema"):
        assert getattr(res.state, leaf).dtype == torch.float32, leaf
    assert bool(torch.isfinite(res.samples).all())


def test_chees_rejects_bad_mass_shape():
    with pytest.raises(ValueError, match="mass must be"):
        qt.chees_sample(lambda x: -torch.sum(x * x), 0, zeros(2, 3),
                        mass=torch.zeros((3, 3, 3)), n_samples=2, n_warmup=0)
