"""The statistical tests of tests/test_mclmc.py (:50-126, :182-216 and
:292-316; the mesh cases wait for multi-device) run on the port's MCLMC
sampler (mclmc.py) with its own noise, at JAX's thresholds, f64 on the
CPU, the workflow's sampler="mclmc" route among them. The parity with
JAX's draws injected is tests/test_torch_mclmc.py.
"""

import numpy as np
import torch

import quasinewtonmethods_jl_tpu_torch as qt

torch.set_num_threads(1)


def port_ball(x):
    """A hard support boundary: the standard normal inside |x| < 2."""
    r2 = torch.sum(x * x)
    return torch.where(r2 < 4.0, -0.5 * r2, -torch.inf)


def std_normal(x):
    return -0.5 * torch.sum(x * x)


def _normal_starts(seed, shape, scale=1.0):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape) * scale)


def test_standard_gaussian_moments_and_energy_target():
    n, chains = 16, 256
    r = qt.mclmc_sample(std_normal, 0, _normal_starts(0, (chains, n)), n_samples=2000,
                        n_warmup=600)
    s = r.samples.numpy().reshape(-1, n)
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.05)
    assert 0.94 < s.var(0).min() and s.var(0).max() < 1.06
    assert float(r.energy_var) < 5e-4 * 4
    assert int(r.divergences.sum()) == 0
    assert tuple(r.energy_changes.shape) == (2000, chains)
    assert float(r.step_size) > 0 and float(r.L) > 0


def test_bias_shrinks_with_energy_target():
    n, chains = 8, 512
    x0 = _normal_starts(1, (chains, n))
    biases = {}
    for tgt in (5e-3, 5e-6):
        r = qt.mclmc_sample(std_normal, 1, x0, n_samples=1200, n_warmup=500,
                            desired_energy_var=tgt)
        v = r.samples.numpy().reshape(-1, n).var(0).mean()
        biases[tgt] = abs(v - 1.0)
    assert biases[5e-6] < biases[5e-3]
    assert biases[5e-6] < 0.02


def test_adapt_mass_ill_scaled_gaussian():
    scales = np.geomspace(0.1, 10.0, 6)
    sc = torch.tensor(scales)
    r = qt.mclmc_sample(lambda x: -0.5 * torch.sum((x / sc) ** 2), 2,
                        _normal_starts(2, (512, 6)) * sc, n_samples=2500, n_warmup=800,
                        adapt_mass=True)
    ratio = r.samples.numpy().reshape(-1, 6).var(0) / scales ** 2
    assert np.all(ratio > 0.85) and np.all(ratio < 1.15), ratio
    m = r.mass_diag.numpy()
    assert np.all(np.abs(np.log(m / scales ** 2)) < 1.0)


def test_explicit_mass_diag_and_dense():
    scales = np.asarray([0.2, 1.0, 5.0])
    sc = torch.tensor(scales)

    def logd(x):
        return -0.5 * torch.sum((x / sc) ** 2)

    x0 = _normal_starts(3, (256, 3)) * sc
    md = sc ** 2
    r_diag = qt.mclmc_sample(logd, 3, x0, mass=md, n_samples=1500, n_warmup=400)
    r_dense = qt.mclmc_sample(logd, 3, x0, mass=torch.diag(md), n_samples=1500, n_warmup=400)
    # a dense mass contributes exactly its diagonal
    assert torch.equal(r_diag.samples, r_dense.samples)
    ratio = r_diag.samples.numpy().reshape(-1, 3).var(0) / scales ** 2
    assert np.all(ratio > 0.85) and np.all(ratio < 1.15), ratio


def test_bounce_keeps_fleet_finite():
    r = qt.mclmc_sample(port_ball, 6, _normal_starts(6, (128, 4), 0.1), n_samples=500,
                        n_warmup=300)
    s = r.samples.numpy()
    assert np.isfinite(s).all()
    assert np.sqrt((s ** 2).sum(-1)).max() <= 2.0 + 1e-6


def test_out_of_support_start_enters():
    """tests/test_mclmc.py:292-316: chains starting just outside the ball
    enter, and once inside never leave."""
    x0 = torch.full((64, 4), 2.1 / 2.0, dtype=torch.float64)
    r = qt.mclmc_sample(port_ball, 13, x0, n_samples=400, n_warmup=300)
    s = r.samples.numpy()
    assert np.isfinite(s).all()
    final_r = np.sqrt((r.final_x.numpy() ** 2).sum(-1))
    assert (final_r < 2.0).mean() > 0.55
    entered_at = np.sqrt((s ** 2).sum(-1)) < 2.0
    ever_in = np.maximum.accumulate(entered_at, axis=0)
    assert not np.any(ever_in[:-1] & ~entered_at[1:])


def test_pipeline_and_registry():
    """tests/test_mclmc.py:197-216: map_then_sample(sampler='mclmc') hands
    the MAP mass's diagonal to the sampler, and the registry resolves the
    name."""
    assert qt.sampling.get_sampler("mclmc") is qt.mclmc_sample
    out = qt.map_then_sample(lambda x: -0.5 * torch.sum((x - 1.0) ** 2), 7,
                             torch.zeros(4, dtype=torch.float64), n_chains=32, n_samples=400,
                             n_warmup=200, sampler="mclmc")
    assert tuple(out.samples.shape) == (400, 32, 4)
    np.testing.assert_allclose(out.samples.reshape(-1, 4).numpy().mean(0), 1.0, atol=0.1)
    assert int(out.sampler_result.divergences.sum()) == 0
