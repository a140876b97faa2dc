"""The workflow cases of the JAX package's other test files, run on the
port's one-call pipeline with its own noise at JAX's thresholds, f64 on
the CPU: tests/test_pathfinder.py:243-272 (its refusals, :275-284, are
cases of tests/test_torch_workflow.py :: test_refusals_match_jax),
tests/test_transforms.py:386-468, tests/test_trust_region.py:317,
tests/test_diagnostics.py:143, tests/test_pytree.py:91 and
tests/test_bridge.py :: test_map_then_sample_evidence_bridge. Where a plan
was cut for time, its draws are named beside it.
"""

import numpy as np
import torch

import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu.models import HierarchicalRegression as JaxHierarchical
from quasinewtonmethods_jl_tpu_torch.models import HierarchicalRegression
from quasinewtonmethods_jl_tpu_torch.sampling import LowRankMass
from test_torch_workflow_stats import LOGZ3, ld3, pooled, t64

torch.set_num_threads(1)


def _aniso(x):
    return -0.5 * torch.sum(x * x * torch.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype))


def test_map_then_sample_pathfinder_init():
    """tests/test_pathfinder.py:243-257."""
    out = qt.map_then_sample(_aniso, 0, torch.zeros(5, dtype=torch.float64), n_chains=16,
                             n_samples=100, n_warmup=100, init="pathfinder",
                             pathfinder_kwargs=dict(n_paths=4, max_iters=30))
    assert tuple(out.samples.shape) == (100, 16, 5)
    assert float(out.map_result.khat) < 0.7
    assert isinstance(out.mass, LowRankMass)
    np.testing.assert_allclose(pooled(out.samples).var(0), 1.0 / np.arange(1.0, 6.0), rtol=0.35)


def test_map_then_sample_pathfinder_with_transform():
    """tests/test_pathfinder.py:260-272: Gamma(3, 1) product, mean 3."""
    out = qt.map_then_sample(lambda x: torch.sum(2.0 * torch.log(x) - x), 1,
                             torch.ones(3, dtype=torch.float64), n_chains=8, n_samples=100,
                             n_warmup=100, init="pathfinder", transform=qt.transforms.Positive(3),
                             pathfinder_kwargs=dict(n_paths=4, max_iters=30))
    np.testing.assert_allclose(pooled(out.samples_constrained).mean(0), 3.0, rtol=0.2)


def test_hierarchical_fleet_and_pipeline():
    """tests/test_transforms.py:386-409 on JAX's data, 60 warmup rounds and
    40 draws (JAX's 200 + 200: ChEES's trajectories on this posterior cost
    ~7 ms a gradient of 8 chains on one CPU core)."""
    ref = JaxHierarchical(n_groups=4, q=2, p=2, n_obs=200, seed=4)
    m = HierarchicalRegression(n_groups=4, q=2, p=2, n_obs=200, **{
        k: np.asarray(getattr(ref, k)) for k in ("X", "Z", "group", "y", "beta_true", "u_true")})
    res = qt.map_then_sample(m, 30, m.initial_point(), n_chains=8, n_samples=40, n_warmup=60,
                             transform=m.transform, init_scale=0.05)
    xc = res.samples_constrained
    _, _, tau, sigma, _ = m.split(xc[0, 0])
    assert bool((tau > 0).all()) and float(sigma) > 0
    beta_mean = pooled(xc[..., :m.p]).mean(0)
    np.testing.assert_allclose(beta_mean, np.asarray(ref.beta_true), atol=0.25)
    assert bool(torch.isfinite(res.diagnostics.rhat).all())


_GA, _GB = t64([3.0, 5.0, 2.0]), t64([2.0, 1.0, 4.0])


def _gamma_product(x):
    return torch.sum((_GA - 1.0) * torch.log(x) - _GB * x)


def _gamma_product_vag(x):
    return _gamma_product(x), (_GA - 1.0) / x - _GB


def test_map_then_sample_transform():
    """tests/test_transforms.py:428-450."""
    t = qt.transforms.Positive(3)
    res = qt.map_then_sample(_gamma_product, 11, torch.ones(3, dtype=torch.float64), n_chains=16,
                             n_samples=300, n_warmup=300, transform=t)
    assert res.samples_constrained.shape == res.samples.shape
    np.testing.assert_allclose(res.samples_constrained.numpy(),
                               qt.transforms.forward_draws(t, res.samples).numpy(), rtol=1e-12)
    assert bool((res.samples_constrained > 0).all())
    np.testing.assert_allclose(res.x_map_constrained.numpy(), (_GA / _GB).numpy(), rtol=1e-4)
    np.testing.assert_allclose(res.diagnostics.mean.numpy(), (_GA / _GB).numpy(), rtol=0.1,
                               atol=0.05)


def test_map_then_sample_transform_analytic_vag():
    """tests/test_transforms.py:453-468: the x-space gradient pulled back,
    the same draws as autodiff's."""
    kw = dict(n_chains=8, n_samples=32, n_warmup=64, compute_diagnostics=False,
              transform=qt.transforms.Positive(3))
    r_ad = qt.map_then_sample(_gamma_product, 12, torch.ones(3, dtype=torch.float64), **kw)
    r_an = qt.map_then_sample(_gamma_product, 12, torch.ones(3, dtype=torch.float64),
                              value_and_grad_fn=_gamma_product_vag, **kw)
    np.testing.assert_allclose(r_an.samples.numpy(), r_ad.samples.numpy(), rtol=1e-8, atol=1e-10)


def test_pipeline_lm_result_sign_consistency():
    """tests/test_trust_region.py:317-345: fun, last_value and grad in one
    (maximization) convention."""
    def resid(x):
        return torch.stack([x[0] - 1.0, 2.0 * x[1] + 1.0, x[0] + x[1]])

    def obj(x):
        r = resid(x)
        return -0.5 * torch.sum(r * r)

    out = qt.map_then_sample(obj, 8, torch.zeros(2, dtype=torch.float64), n_chains=8,
                             sampler="chees", n_samples=16, n_warmup=8, map_engine="lm",
                             map_kwargs={"residual_fn": resid})
    mr = out.map_result
    ok = (mr.status == qt.Status.CONVERGED).numpy()
    assert ok.any()
    np.testing.assert_allclose(mr.fun.numpy()[ok], mr.last_value.numpy()[ok], atol=1e-12)
    lane = int(np.argmax(ok))
    g_expected = torch.func.grad(obj)(mr.x[lane])
    np.testing.assert_allclose(mr.grad[lane].numpy(), g_expected.numpy(), atol=1e-10)


def test_map_then_sample_default_diagnostics_are_device_tensors():
    """tests/test_diagnostics.py:143-162: the summaries stay tensors on the
    draws' device and agree with the host oracle."""
    out = qt.map_then_sample(lambda x: -0.5 * torch.sum(x * x), 3,
                             torch.zeros(2, dtype=torch.float64), n_chains=8, n_samples=64,
                             n_warmup=64)
    assert isinstance(out.diagnostics.rhat, torch.Tensor)
    host = qt.diagnose_chains(out.samples.numpy())
    np.testing.assert_allclose(out.diagnostics.rhat.numpy(), host.rhat, rtol=1e-8)
    np.testing.assert_allclose(out.diagnostics.ess.numpy(), host.ess, rtol=1e-6)


def test_map_then_sample_pytree():
    """tests/test_pytree.py:91-120."""
    mu = t64([1.0, -2.0])

    def logd(params):
        return (-0.5 * torch.sum((params["beta"] - mu) ** 2)
                - 0.5 * (params["scales"]["sigma"] - 0.5) ** 2)

    tree0 = {"beta": torch.zeros(2, dtype=torch.float64),
             "scales": {"sigma": torch.tensor(0.0, dtype=torch.float64)}}
    out = qt.map_then_sample_pytree(logd, 3, tree0, n_chains=16, n_samples=300, n_warmup=200)
    assert tuple(out.samples["beta"].shape) == (300, 16, 2)
    assert tuple(out.samples["scales"]["sigma"].shape) == (300, 16)
    np.testing.assert_allclose(out.x_map["beta"].numpy(), mu.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(out.x_map["scales"]["sigma"]), 0.5, atol=1e-5)
    np.testing.assert_allclose(pooled(out.samples["beta"]).mean(0), mu.numpy(), atol=0.15)
    assert out.names == ("beta[0]", "beta[1]", "scales.sigma")
    tbl = qt.posterior_summary(out.flat.samples).table(names=list(out.names))
    assert "scales.sigma" in tbl and out.flat.diagnostics is not None


def test_map_then_sample_evidence_bridge():
    """tests/test_bridge.py:162-180: the bridge over the pipeline's own
    draws against the analytic evidence."""
    out = qt.map_then_sample(ld3, 42, torch.ones(3, dtype=torch.float64), n_chains=16,
                             n_samples=96, n_warmup=64, compute_evidence="bridge")
    assert abs(float(out.log_evidence) - LOGZ3) < 0.1
    assert isinstance(out.evidence_extra, qt.BridgeResult)
    assert float(out.evidence_extra.delta) < 1e-8
