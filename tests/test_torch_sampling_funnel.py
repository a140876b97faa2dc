"""JAX's ChEES funnel test (tests/test_sampling.py:282-300) on the port,
with the port's own noise and JAX's thresholds: the canonical pathological
geometry, in a file of its own (about 45 s on one CPU worker)."""

import numpy as np
import torch

import quasinewtonmethods_jl_tpu_torch as qt

torch.set_num_threads(1)


def funnel_value_and_grad(theta):
    """The funnel's value and its analytic gradient (a user-supplied
    value_and_grad_fn: autodiff under vmap costs ~1 ms a call on the CPU,
    and this run takes ~70 000)."""
    from quasinewtonmethods_jl_tpu_torch.models import funnel_logdensity

    v, x = theta[0], theta[1:]
    e = torch.exp(-v)
    sq = torch.sum(x * x)
    dv = -v / 9.0 - 0.5 * x.shape[0] + 0.5 * e * sq
    return funnel_logdensity(theta), torch.cat([dv[None], -e * x])


def test_chees_on_neals_funnel():
    """Adapted fleet HMC explores both the mouth (v > 2) and the neck
    (v < -2) of a 6-dim funnel, var(v) in the right decade (exact 9)."""
    from quasinewtonmethods_jl_tpu_torch.models import funnel_logdensity

    theta = torch.tensor([0.3, -0.2, 0.5, 1.1, 0.7, -0.4], dtype=torch.float64)
    torch.testing.assert_close(funnel_value_and_grad(theta)[1],
                               torch.func.grad(funnel_logdensity)(theta), rtol=1e-13, atol=0)
    gen = torch.Generator().manual_seed(9)
    x0s = 0.5 * torch.randn((128, 6), generator=gen, dtype=torch.float64)
    res = qt.chees_sample(funnel_logdensity, 0, x0s, n_samples=1500, n_warmup=800,
                          target_accept=0.9, value_and_grad_fn=funnel_value_and_grad)
    v = res.samples[:, :, 0].numpy().ravel()
    assert np.isfinite(v).all()
    assert (v > 2.0).mean() > 0.05
    assert (v < -2.0).mean() > 0.02
    assert 3.0 < v.var() < 15.0
