"""JAX's NUTS funnel test (tests/test_sampling.py:382-397) on the port,
with the port's own noise and JAX's thresholds: the geometry NUTS was
built for, in a file of its own.

JAX's run is 600 warmup rounds and 1200 draws over 64 chains. In the neck
the fleet's deepest tree runs most draws to max_depth (255 leaves), one
Python loop body a leaf: at JAX's length the test took 227 s on one CPU
worker. It runs 400 warmup rounds and 400 draws, with JAX's chains,
dimension, target and thresholds."""

import numpy as np
import torch

import quasinewtonmethods_jl_tpu_torch as qt
from test_torch_sampling_funnel import funnel_value_and_grad

torch.set_num_threads(1)


def test_nuts_on_neals_funnel():
    """Both tails of v covered and the v-marginal variance in the right
    decade (exact 9)."""
    from quasinewtonmethods_jl_tpu_torch.models import funnel_logdensity

    gen = torch.Generator().manual_seed(33)
    x0s = 0.5 * torch.randn((64, 6), generator=gen, dtype=torch.float64)
    res = qt.nuts_sample(funnel_logdensity, 3, x0s, n_samples=400, n_warmup=400,
                         target_accept=0.9, value_and_grad_fn=funnel_value_and_grad)
    v = res.samples[:, :, 0].numpy().ravel()
    assert np.isfinite(v).all()
    assert (v > 2.0).mean() > 0.05
    assert (v < -2.0).mean() > 0.02
    assert 4.0 < v.var() < 15.0
