"""The statistical tests of tests/test_ensemble.py (:35-68, :144-185 and
:209-231; the mesh cases wait for multi-device) on the port's ensemble
sampler (ensemble.py) with its own noise, at JAX's thresholds, f64 on the
CPU, the workflow's sampler="ensemble" route among them (its refusal of
the low-rank mass is tests/test_torch_workflow_routes.py's, against
JAX's message). The parity with JAX's draws injected is
tests/test_torch_ensemble.py.
"""

import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu_torch as qt
from test_torch_ensemble import corr_gaussian, port_ball

torch.set_num_threads(1)


@pytest.mark.parametrize("partner", ["gather", "shift"])
def test_ensemble_recovers_gaussian_moments(partner):
    _jf, logd, mu, cov = corr_gaussian()
    x0s = torch.tensor(np.random.default_rng(0).standard_normal((64, 3)))
    r = qt.ensemble_sample(logd, 0, x0s, n_samples=3000, n_warmup=500, partner=partner)
    draws = r.samples.numpy().reshape(-1, 3)
    np.testing.assert_allclose(draws.mean(0), mu, atol=0.08)
    np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.12)
    assert 0.2 < float(r.accept_rate.mean()) < 0.9


def test_ensemble_is_gradient_free():
    mu = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)

    def laplace_logd(x):
        return -torch.sum(torch.abs(x - mu))

    x0s = torch.tensor(np.random.default_rng(1).standard_normal((64, 3)))
    r = qt.ensemble_sample(laplace_logd, 1, x0s, n_samples=4000, n_warmup=500)
    draws = r.samples.numpy().reshape(-1, 3)
    np.testing.assert_allclose(draws.mean(0), mu.numpy(), atol=0.1)
    # Laplace(b=1) marginal variance = 2
    np.testing.assert_allclose(draws.var(0), 2.0, atol=0.4)


def test_ensemble_outside_support_recovers():
    x0s = torch.cat([torch.full((8, 2), 2.2, dtype=torch.float64),
                     torch.zeros((8, 2), dtype=torch.float64)])
    r = qt.ensemble_sample(port_ball, 5, x0s, n_samples=500, n_warmup=300)
    draws = r.samples.numpy().reshape(-1, 2)
    assert np.all(np.isfinite(draws[-1000:]))
    assert np.all(np.sum(draws[-1000:] ** 2, axis=1) < 4.0)


def test_ensemble_autocorr_time():
    # iid pseudo-draws: tau == 1, reliable
    iid = np.random.default_rng(8).standard_normal((2000, 32, 3))
    tau, rel = qt.ensemble_autocorr_time(iid)
    np.testing.assert_allclose(tau, 1.0, atol=0.3)
    assert rel.all()
    # a real stretch-move run mixes slower than iid: tau >> 1, reliable
    _jf, logd, _mu, _cov = corr_gaussian()
    x0s = torch.tensor(np.random.default_rng(9).standard_normal((64, 3)))
    r = qt.ensemble_sample(logd, 10, x0s, n_samples=4000, n_warmup=500)
    tau, rel = qt.ensemble_autocorr_time(r.samples)
    assert np.all(tau > 5.0)
    assert rel.all()
    # too-short run: the reliability flag must refuse
    _tau_s, rel_s = qt.ensemble_autocorr_time(r.samples[:100])
    assert not rel_s.all()
    with pytest.raises(ValueError, match="draws"):
        qt.ensemble_autocorr_time(np.zeros((4, 8, 2)))


def test_pipeline_ensemble_sampler():
    """tests/test_ensemble.py:166-178: the MAP-initialized walker ball, no
    mass handoff (affine invariance is the metric)."""
    _jf, logd, mu, cov = corr_gaussian()
    out = qt.map_then_sample(logd, 6, torch.zeros(3, dtype=torch.float64), n_chains=64,
                             sampler="ensemble", n_samples=2500, n_warmup=400, jitter=0.3)
    np.testing.assert_allclose(out.x_map.numpy(), mu, atol=1e-6)
    draws = out.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(draws.mean(0), mu, atol=0.1)
    np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.3 * np.abs(cov).max())
