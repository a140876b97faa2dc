"""JAX's NUTS moment tests on the port, with the port's own noise and JAX's
thresholds, checked through the ported diagnostics:
tests/test_sampling.py:308-440 (moments and adaptation, the dense
handoff, divergences, reproducibility and float32), :553-575 (dense fleet
adaptation against the oracle mass), :691-733 (the low-rank metric), the NUTS cases
of :800-835 (the energies and divergences contract) and of
tests/test_sampler_fuzz.py:35-61 (random Gaussians). The two runs on a
400x scale spread with the mass adaptation off (:345-363, :414-440) are
tests/test_torch_sampling_nuts_scales.py, and Neal's funnel (:382-397)
tests/test_torch_sampling_nuts_funnel.py: their lockstep trees run near
max_depth, and each takes tens of seconds on one CPU worker.

Gaussian targets pass their analytic value and gradient as a
``value_and_grad_fn`` (a user-supplied gradient; autodiff under vmap costs
several times more a call on the CPU, and these runs take tens of
thousands of leaves).
"""

import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu_torch as qt

torch.set_num_threads(1)


def gaussian(prec, mu=None):
    """(logdensity, value_and_grad_fn) of N(mu, inv(prec))."""
    P = torch.tensor(np.asarray(prec, np.float64))
    m = torch.zeros(P.shape[0], dtype=torch.float64) if mu is None else torch.tensor(mu)

    def logd(x):
        d = x - m.to(x.dtype)
        return -0.5 * d @ (P.to(x.dtype) @ d)

    def vag(x):
        d = x - m.to(x.dtype)
        Pd = P.to(x.dtype) @ d
        return -0.5 * d @ Pd, -Pd

    return logd, vag


def diag_gaussian(scales):
    """N(0, diag(scales)): (logdensity, value_and_grad_fn)."""
    return gaussian(np.diag(1.0 / np.asarray(scales, np.float64)))


def corr_gaussian(n):
    """tests/test_sampling.py's `_corr_gaussian`: (logd, vag, cov)."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((n, n)) * 0.4
    cov = A @ A.T + np.eye(n)
    return (*gaussian(np.linalg.inv(cov)), cov)


def zeros(chains, n, dtype=torch.float64):
    return torch.zeros((chains, n), dtype=dtype)


def pooled(res, n):
    return res.samples.reshape(-1, n).numpy()


def test_nuts_standard_normal_moments_and_adaptation():
    """N(0, I): moments within MC error; the step size adapts to ~1; trees
    stop well short of max_depth (the U-turn criterion fires)."""
    logd, vag = diag_gaussian([1.0, 1.0, 1.0])
    res = qt.nuts_sample(logd, 0, zeros(16, 3), n_samples=500, n_warmup=300, max_depth=6,
                         value_and_grad_fn=vag)
    draws = pooled(res, 3)
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(draws.var(axis=0), 1.0, atol=0.15)
    assert 0.6 < float(res.accept_prob.mean()) <= 1.0
    assert 0.4 < float(res.step_size.mean()) < 2.5
    assert float(res.mean_tree_depth.mean()) < 4.0
    d = qt.diagnose_chains(res.samples.numpy())
    assert np.all(d.rhat < 1.05)
    assert float(qt.split_rhat_device(res.samples).max()) < 1.05


def test_nuts_dense_mass_from_map_handoff():
    logd, vag, cov = corr_gaussian(3)
    res = qt.nuts_sample(logd, 2, zeros(32, 3), mass=torch.tensor(cov), n_samples=700,
                         n_warmup=300, value_and_grad_fn=vag)
    np.testing.assert_allclose(np.cov(pooled(res, 3).T), cov, atol=0.3 * np.abs(cov).max())
    # ~isotropic after preconditioning: shallow trees
    assert float(res.mean_tree_depth.mean()) < 4.0


def test_nuts_divergences_reject_in_band():
    """A pathological step size diverges on the first leaf of every tree:
    the chain never moves and everything stays finite."""
    res = qt.nuts_sample(lambda x: -0.5 * torch.sum(x * x) - 0.1 * torch.sum(x ** 4), 4,
                         torch.ones((4, 3), dtype=torch.float64), n_samples=30, n_warmup=0,
                         step_size=1e6)
    s = res.samples.numpy()
    assert np.isfinite(s).all()
    np.testing.assert_array_equal(s, np.ones_like(s))  # all rejected
    assert np.all(res.accept_prob.numpy() == 0.0)


def test_nuts_reproducible_and_f32():
    logd = lambda x: -0.5 * torch.sum(x * x)  # noqa: E731
    kw = {"n_samples": 20, "n_warmup": 10}
    a = qt.nuts_sample(logd, 5, zeros(4, 2), **kw)
    b = qt.nuts_sample(logd, 5, zeros(4, 2), **kw)
    assert torch.equal(a.samples, b.samples)
    r = qt.nuts_sample(logd, 6, zeros(8, 3, torch.float32), n_samples=40, n_warmup=40)
    assert r.samples.dtype == torch.float32
    for leaf in ("x", "f", "g", "log_eps", "var_ema", "warm_dsum"):
        assert getattr(r.state, leaf).dtype == torch.float32, leaf
    assert np.isfinite(r.samples.numpy()).all()


def test_nuts_dense_fleet_adaptation_matches_oracle_depth():
    """On a correlated Gaussian, across-chain dense covariance adaptation
    gets gradient evaluations per draw within 1.3x of an oracle run given
    the true covariance as its mass."""
    n, rho = 8, 0.95
    C = np.full((n, n), rho) + (1 - rho) * np.eye(n)
    scales = np.geomspace(0.5, 5.0, n)
    C = C * np.outer(scales, scales)
    logd, vag = gaussian(np.linalg.inv(C))
    kw = {"n_samples": 200, "n_warmup": 300, "max_depth": 9, "value_and_grad_fn": vag}
    oracle = qt.nuts_sample(logd, 0, zeros(64, n), mass=torch.tensor(C), **kw)
    dense = qt.nuts_sample(logd, 0, zeros(64, n), adapt_mass="dense", **kw)
    do = float(oracle.mean_tree_depth.mean())
    dd = float(dense.mean_tree_depth.mean())
    assert 2.0 ** dd <= 1.3 * 2.0 ** do, (dd, do)
    emp = np.cov(pooled(dense, n).T)
    assert np.max(np.abs(emp - C)) / np.max(np.abs(C)) < 0.2


def test_nuts_lowrank_adaptation_shrinks_depth_and_recovers_subspace():
    """adapt_mass='lowrank': the standardized core lands on the target's
    correlation structure and shrinks tree depth against the diagonal
    adaptation (geomspaced scales x uniform rho = 0.9)."""
    n = 16
    s = np.geomspace(1.0, 10.0, n)
    R = np.full((n, n), 0.9) + 0.1 * np.eye(n)
    logd, vag = gaussian(np.linalg.inv(np.outer(s, s) * R))
    kw = {"n_samples": 60, "n_warmup": 200, "max_depth": 8, "value_and_grad_fn": vag}
    lr = qt.nuts_sample(logd, 2, zeros(64, n), adapt_mass="lowrank", mass_rank=4, **kw)
    st = lr.state
    assert st.var_ema.shape == (n,)
    assert st.lr_Q.shape == (n, 4) and st.lr_sig.shape == (4,)
    w, V = np.linalg.eigh(R)
    top = V[:, -1]
    assert float(np.linalg.norm(st.lr_Q.numpy().T @ top)) > 0.9
    assert float(st.lr_sig.max()) > 0.5 * w[-1]
    diag = qt.nuts_sample(logd, 2, zeros(64, n), adapt_mass=True, **kw)
    assert float(lr.mean_tree_depth.mean()) < float(diag.mean_tree_depth.mean()) - 0.5


def test_nuts_energies_and_divergences_contract():
    """(draws, chains) Hamiltonians and a per-chain int32 divergence count;
    an easy Gaussian mixes with E-BFMI above 0.3 and no divergence, at the
    Hamiltonian's scale E[E] ~ n."""
    chains, n, draws = 16, 4, 250
    x0s = torch.randn((chains, n), generator=torch.Generator().manual_seed(5),
                      dtype=torch.float64)
    res = qt.nuts_sample(lambda x: -0.5 * torch.sum(x * x), 5, x0s, n_samples=draws,
                         n_warmup=200)
    e, d = res.energies.numpy(), res.divergences
    assert e.shape == (draws, chains)
    assert d.shape == (chains,) and d.dtype == torch.int32
    assert np.all(np.isfinite(e)) and int(d.sum()) == 0
    assert np.all(qt.energy_bfmi(e) > 0.3)
    assert np.all(qt.energy_bfmi_device(res.energies).numpy() > 0.3)
    assert abs(e.mean() - n) < 1.5


def _random_gaussian(seed, n, cond=10.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    cov = (q * np.exp(np.linspace(0.0, np.log(cond), n))) @ q.T
    mu = rng.standard_normal(n)
    return (*gaussian(np.linalg.inv(cov), mu), mu, cov)


@pytest.mark.parametrize("seed", [3, 17])
def test_nuts_agrees_with_analytic_moments(seed):
    """tests/test_sampler_fuzz.py's NUTS cases: random SPD Gaussians."""
    n, chains = 3, 64
    logd, vag, mu, cov = _random_gaussian(seed, n)
    res = qt.nuts_sample(logd, seed, torch.tensor(mu).expand(chains, n).clone(),
                         n_samples=600, n_warmup=400, value_and_grad_fn=vag)
    draws = pooled(res, n)
    scale = np.sqrt(np.diagonal(cov))
    np.testing.assert_allclose(draws.mean(axis=0), mu, atol=0.25 * scale.max())
    np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.4 * np.abs(cov).max())
    assert np.all(qt.diagnose_chains(res.samples.numpy()).rhat < 1.15)
