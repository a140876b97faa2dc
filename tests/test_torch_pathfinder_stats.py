"""JAX's own Pathfinder tests (tests/test_pathfinder.py:104-240) case by
case on the port, with the port's own noise and JAX's thresholds: the
Gaussian target's moments, khat and per-path ELBOs, determinism, the
skewed target corrected by PSIS, the invalid path excluded, the mass
handoff to the port's `chees_sample`, float32 and the rank guards; and
the port's counters and integer-start rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from test_torch_pathfinder import gaussian_target, nan_wall, skewed

torch.set_num_threads(1)


def test_pathfinder_gaussian_moments_and_khat():
    n = 8
    _jl, tl, mu, cov = gaussian_target(n)
    res = qt.pathfinder(tl, 0, torch.zeros(n, dtype=torch.float64), n_paths=4, n_draws=2000,
                        max_iters=40, elbo_draws=32)
    assert (res.status.numpy() == int(qt.Status.CONVERGED)).all()
    assert float(res.khat) < 0.7
    d = res.draws.numpy()
    assert d.shape == (2000, n)
    np.testing.assert_allclose(d.mean(0), mu, atol=0.12)
    np.testing.assert_allclose(np.cov(d.T), cov, atol=0.3)
    # the ELBO of an unnormalized Gaussian at the exact fit is the negative
    # log normalizer: 0.5 log det(2 pi cov)
    elbo_exact = 0.5 * np.linalg.slogdet(2 * np.pi * cov)[1]
    np.testing.assert_allclose(res.elbo.numpy(), elbo_exact, atol=0.3)


def test_pathfinder_deterministic():
    _jl, tl, *_ = gaussian_target(5, seed=1)
    r1 = qt.pathfinder(tl, 7, torch.zeros(5, dtype=torch.float64), n_paths=2, n_draws=64,
                       max_iters=20)
    r2 = qt.pathfinder(tl, 7, torch.zeros(5, dtype=torch.float64), n_paths=2, n_draws=64,
                       max_iters=20)
    np.testing.assert_array_equal(r1.draws.numpy(), r2.draws.numpy())
    # a generator key is one seed drawn from it
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    r3 = qt.pathfinder(tl, g1, torch.zeros(5, dtype=torch.float64), n_paths=2, n_draws=64,
                       max_iters=20)
    r4 = qt.pathfinder(tl, g2, torch.zeros(5, dtype=torch.float64), n_paths=2, n_draws=64,
                       max_iters=20)
    np.testing.assert_array_equal(r3.draws.numpy(), r4.draws.numpy())


def test_pathfinder_skewed_target_is_corrected_by_psis():
    _jl, tl, a, b = skewed()
    res = qt.pathfinder(tl, 1, torch.zeros(3, dtype=torch.float64), n_paths=4, n_draws=4000,
                        max_iters=40, elbo_draws=32)
    assert float(res.khat) < 0.7
    t = np.exp(res.draws.numpy())
    np.testing.assert_allclose(t.mean(0), a / b, rtol=0.08)
    np.testing.assert_allclose(t.var(0), a / b**2, rtol=0.25)


def test_pathfinder_invalid_path_excluded():
    _jl, tl = nan_wall()
    x0s = torch.tensor(np.stack([np.zeros(4), np.full(4, 1e3), 0.5 * np.ones(4)]))
    res = qt.pathfinder(tl, 2, x0s, n_draws=500, max_iters=30)
    assert int(res.status[1]) == int(qt.Status.NONFINITE_VALUE)
    assert not np.isfinite(float(res.elbo[1]))
    d = res.draws.numpy()
    assert np.isfinite(d).all() and (np.abs(d) < 50).all()
    np.testing.assert_allclose(d.mean(0), np.zeros(4), atol=0.15)
    # the invalid path's pool rows carry no weight
    R = res.pool.shape[0] // 3
    assert (res.pool_logw[R:2 * R] == -np.inf).all()


def test_pathfinder_mass_handoff_to_chees():
    _jl, tl, *_ = gaussian_target(6, seed=2)
    res = qt.pathfinder(tl, 3, torch.zeros(6, dtype=torch.float64), n_paths=2, n_draws=64,
                        max_iters=30)
    mass = res.mass()
    assert isinstance(mass, qt.LowRankMass)
    best = int(torch.argmax(res.elbo))
    assert torch.equal(mass.Q, res.Q[best]) and torch.equal(mass.sig, res.sig[best])
    assert torch.equal(res.mass(1 - best).gamma, res.gamma[1 - best])
    out = qt.chees_sample(tl, 4, res.draws[:16], n_samples=50, n_warmup=50, mass=mass)
    assert np.isfinite(out.samples.numpy()).all()


def test_pathfinder_f32():
    _jl, tl, *_ = gaussian_target(5, seed=3)
    res = qt.pathfinder(lambda x: tl(x.double()).float(), 5, torch.zeros(5), n_paths=2,
                        n_draws=128, max_iters=20)
    assert res.draws.dtype == torch.float32
    assert np.isfinite(res.draws.numpy()).all()


def test_pathfinder_rank_guards_and_integer_starts():
    _jl, tl, *_ = gaussian_target(4, seed=4)
    with pytest.raises(ValueError) as port_err:
        qt.pathfinder(tl, 6, torch.zeros((2, 3, 4)))
    with pytest.raises(ValueError) as jax_err:
        qj.pathfinder(_jl, jax.random.PRNGKey(6), jnp.zeros((2, 3, 4)))
    assert str(port_err.value) == str(jax_err.value)
    # an integer start becomes JAX's default float with x64 off
    res = qt.pathfinder(lambda x: tl(x.double()).float(), 6, torch.zeros(4, dtype=torch.int64),
                        n_paths=2, n_draws=16, max_iters=5)
    assert res.draws.dtype == torch.float32


def test_pathfinder_counts_its_reads_and_evaluations(monkeypatch):
    """CPU tensors read nothing but the line searches' flags (eigh reads
    its status only from a card): one read a phase of every search, and
    a fleet-wide evaluation per trial; 2 + trials evaluations a body and
    one for the pool."""
    _jl, tl, *_ = gaussian_target(4, seed=5)
    reads, evals = [], []
    real = qt.pathfinder.__globals__["_lockstep_linesearch"]

    def spy(ls, f_b, vag_b, X, d, f0, m, active):
        before = qt.pathfinder.gradient_evals
        out = real(ls, f_b, vag_b, X, d, f0, m, active)
        reads.append(out[-1])
        evals.append(qt.pathfinder.gradient_evals - before)
        return out

    monkeypatch.setitem(qt.pathfinder.__globals__, "_lockstep_linesearch", spy)
    qt.pathfinder.host_syncs = qt.pathfinder.gradient_evals = 0
    qt.pathfinder(tl, 8, torch.zeros(4, dtype=torch.float64), n_paths=3, n_draws=32,
                  max_iters=12)
    assert len(reads) == 12 and all(r >= 2 for r in reads)
    assert qt.pathfinder.host_syncs == sum(reads)
    # each search's trials are its reads less the two that end its phases
    assert evals == [r - 1 for r in reads]
    assert qt.pathfinder.gradient_evals == 12 * 2 + sum(evals) + 1
