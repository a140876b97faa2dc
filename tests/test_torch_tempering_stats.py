"""The statistical tests of tests/test_tempering.py (:22-92, :213-249,
:279-304, :325-384 and :426-449; the mesh cases wait for multi-device) on
the port's replica-exchange HMC (tempering.py) with its own noise, at
JAX's thresholds, f64 on the CPU, the workflow's sampler="pt" route among
them. The parity with JAX's draws injected is
tests/test_torch_tempering.py.
"""

import numpy as np
import torch

import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.models import GaussianMixture

torch.set_num_threads(1)


def std_normal(x):
    return -0.5 * torch.sum(x * x)


def test_geometric_ladder():
    b = qt.geometric_ladder(6, 0.05).numpy()
    assert b.shape == (6,)
    assert b[0] == 1.0
    np.testing.assert_allclose(b[-1], 0.05, rtol=1e-6)
    assert np.all(np.diff(b) < 0)
    assert qt.geometric_ladder(1).tolist() == [1.0]


def test_pt_standard_normal_moments():
    n, chains = 4, 32
    res = qt.pt_sample(std_normal, 0, torch.zeros((chains, n), dtype=torch.float64),
                       n_temps=4, beta_min=0.2, n_samples=600, n_warmup=300, n_leapfrog=8)
    assert res.samples.shape == (600, chains, n)
    draws = res.samples.numpy().reshape(-1, n)
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(draws.var(axis=0), 1.0, atol=0.15)
    acc = res.accept_rate.numpy()
    assert acc.shape == (4,) and np.all(acc > 0.5)
    eps = res.step_size.numpy()
    assert eps.shape == (4,) and eps[-1] > eps[0]
    swap = res.swap_rate.numpy()
    assert swap.shape == (3,)
    assert np.all(swap > 0.2) and np.all(swap <= 1.0)
    assert res.round_trips.shape == (chains,)
    assert int(res.round_trips.sum()) > chains


def test_pt_recovers_bimodal_mode_weights():
    """Modes at ±4 (8σ apart), weights 0.75 / 0.25, every chain started in
    the heavy mode: plain HMC stays there, the ladder recovers both."""
    mix = GaussianMixture(means=[[4.0, 4.0], [-4.0, -4.0]], weights=[0.75, 0.25], sigmas=1.0,
                          dtype=torch.float64)
    chains = 64
    x0s = mix.means[0][None, :] + 0.1 * torch.tensor(
        np.random.default_rng(1).standard_normal((chains, 2)))
    hmc = qt.hmc_sample(mix.logdensity, 2, x0s, n_samples=300, n_warmup=200, n_leapfrog=8)
    w_hmc = mix.mode_weights(hmc.samples).numpy()
    assert w_hmc[1] < 0.02
    pt = qt.pt_sample(mix.logdensity, 2, x0s, n_temps=6, beta_min=0.05, n_samples=400,
                      n_warmup=300, n_leapfrog=8)
    w_pt = mix.mode_weights(pt.samples).numpy()
    np.testing.assert_allclose(w_pt, [0.75, 0.25], atol=0.12)
    cold_mean = pt.samples.numpy().reshape(-1, 2).mean(axis=0)
    np.testing.assert_allclose(cold_mean, mix.mean().numpy(), atol=0.8)


def test_pt_adapt_ladder_repairs_a_gapped_ladder():
    bad = torch.tensor([1.0, 0.95, 0.9, 0.85, 0.05], dtype=torch.float64)
    kw = dict(betas=bad, n_samples=150, n_warmup=300, n_leapfrog=4)
    x0s = torch.tensor(np.random.default_rng(20).standard_normal((32, 4)))
    off = qt.pt_sample(std_normal, 21, x0s, adapt_ladder=False, **kw)
    on = qt.pt_sample(std_normal, 21, x0s, adapt_ladder=True, **kw)
    assert float(off.swap_rate.min()) < 0.05
    assert float(on.state.swap_ema.min()) > 0.15
    b = on.betas.numpy()
    assert b[0] == 1.0
    np.testing.assert_allclose(b[-1], 0.05, rtol=1e-4)
    assert np.all(np.diff(b) < 0)
    s0 = np.diff(np.log(bad.numpy()))
    s1 = np.diff(np.log(b))
    assert np.max(-s1) < 0.6 * np.max(-s0)


def test_pt_adapt_mass_scale_heterogeneous():
    scales2 = torch.tensor(np.geomspace(0.01, 100.0, 6))

    def ld(x):
        return -0.5 * torch.sum(x * x / scales2)

    chains = 64
    x0s = torch.zeros((chains, 6), dtype=torch.float64)
    truth = scales2.numpy()
    adapt = qt.pt_sample(ld, 24, x0s, n_temps=4, beta_min=0.2, n_samples=400, n_warmup=400,
                         n_leapfrog=8, adapt_mass=True)
    v_a = adapt.samples.numpy().reshape(-1, 6).var(axis=0)
    np.testing.assert_allclose(v_a, truth, rtol=0.4)
    m = adapt.state.var_ema.numpy()[0]
    assert m[-1] / m[0] > 100.0
    k1 = dict(n_temps=1, n_samples=300, n_warmup=300, n_leapfrog=8)
    ident1 = qt.pt_sample(ld, 26, x0s, **k1)
    adapt1 = qt.pt_sample(ld, 26, x0s, adapt_mass=True, **k1)
    ess_i = np.asarray(qt.ess(ident1.samples))
    ess_a = np.asarray(qt.ess(adapt1.samples))
    assert ess_a[-1] > 10.0 * ess_i[-1]
    assert np.min(ess_a) > 10.0 * np.min(ess_i)


def test_pt_cold_chain_energy_panel():
    x0 = torch.tensor(np.random.default_rng(21).standard_normal((16, 3)))
    r = qt.pt_sample(std_normal, 21, x0, n_temps=4, n_samples=200, n_warmup=150)
    e = r.energies.numpy()
    d = r.divergences.numpy()
    assert e.shape == (200, 16) and np.isfinite(e).all()
    assert d.shape == (16,) and d.sum() == 0
    assert np.all(np.asarray(qt.energy_bfmi(r.energies)) > 0.3)
    r1 = qt.pt_sample(std_normal, 21, x0, n_temps=4, n_samples=80, n_warmup=150)
    r2 = qt.pt_sample_from_state(std_normal, r1.state, n_samples=120)
    assert torch.equal(torch.cat([r1.energies, r2.energies]), r.energies)


def test_gaussian_mixture_fixture():
    """tests/test_tempering.py:213-229 on the port's fixture."""
    mix = GaussianMixture(means=[[2.0, 0.0], [-2.0, 0.0]], weights=[0.5, 0.5], sigmas=0.5,
                          dtype=torch.float64)
    np.testing.assert_allclose(mix.mean().numpy(), 0.0, atol=1e-12)
    cov = mix.cov().numpy()
    np.testing.assert_allclose(cov[0, 0], 0.25 + 4.0, rtol=1e-6)
    np.testing.assert_allclose(cov[1, 1], 0.25, rtol=1e-6)
    ld = float(mix.logdensity(torch.tensor([2.0, 0.0], dtype=torch.float64)))
    np.testing.assert_allclose(ld, np.log(0.5) - 2 * np.log(0.5), atol=1e-6)
    w = mix.mode_weights(torch.tensor([[2.1, 0.0], [-1.9, 0.1], [2.0, 0.2]],
                                      dtype=torch.float64)).numpy()
    np.testing.assert_allclose(w, [2 / 3, 1 / 3], atol=1e-12)


def test_map_then_sample_pt():
    """tests/test_tempering.py:232-249: the MAP fleet's curvature becomes
    the ladder's shared mass."""
    w = torch.tensor([1.0, 4.0, 0.25], dtype=torch.float64)
    out = qt.map_then_sample(lambda x: -0.5 * torch.sum(x * x * w), 11,
                             torch.full((3,), 2.0, dtype=torch.float64), n_chains=16,
                             sampler="pt", n_samples=200, n_warmup=150, n_temps=3, beta_min=0.2,
                             n_leapfrog=8)
    assert tuple(out.samples.shape) == (200, 16, 3)
    assert np.nanmax(out.diagnostics.rhat.numpy()) < 1.1
    np.testing.assert_allclose(out.samples.reshape(-1, 3).numpy().var(axis=0), [1.0, 0.25, 4.0],
                               rtol=0.3)
    assert tuple(out.sampler_result.swap_rate.shape) == (2,)


def test_map_then_sample_pt_with_transform():
    """tests/test_tempering.py:325-345: Gamma(3, 2) on x > 0 sampled by
    replica exchange in z, reported on the constrained scale."""
    out = qt.map_then_sample(lambda x: 2.0 * torch.log(x[0]) - 2.0 * x[0], 30,
                             torch.ones(1, dtype=torch.float64), n_chains=16, sampler="pt",
                             transform=qt.transforms.Positive(1), n_samples=300, n_warmup=200,
                             n_temps=3, beta_min=0.2, n_leapfrog=8)
    draws = out.samples_constrained.reshape(-1).numpy()
    assert np.all(draws > 0)
    np.testing.assert_allclose(draws.mean(), 1.5, atol=0.25)
    np.testing.assert_allclose(draws.var(), 0.75, atol=0.35)
