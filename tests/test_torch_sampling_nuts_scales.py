"""JAX's two NUTS runs on a 400x scale spread (tests/test_sampling.py:345-363
and :414-440) on the port, with the port's own noise and JAX's thresholds:
with the mass adaptation off the lockstep trees deepen to cover the wide
coordinate, so these runs take tens of seconds each on one CPU worker and
sit in a file of their own."""

import numpy as np
import torch

import quasinewtonmethods_jl_tpu_torch as qt
from test_torch_sampling_nuts_stats import diag_gaussian, pooled, zeros

torch.set_num_threads(1)


def test_nuts_adapts_depth_to_scale_spread():
    """A 400x variance spread with the mass adaptation off: trees deepen to
    cover the wide coordinate, and every scale comes out right."""
    scales = np.asarray([1.0, 25.0, 400.0])
    logd, vag = diag_gaussian(scales)
    res = qt.nuts_sample(logd, 1, zeros(32, 3), n_samples=800, n_warmup=400, max_depth=8,
                         adapt_mass=False, value_and_grad_fn=vag)
    np.testing.assert_allclose(pooled(res, 3).var(axis=0), scales, rtol=0.3)
    assert float(res.mean_tree_depth.mean()) > 2.0


def test_nuts_fleet_mass_adaptation_shrinks_trees():
    """The fleet-diagonal mass recovers a 400x scale spread and cuts tree
    depth; both runs land every variance."""
    scales = np.asarray([1.0, 25.0, 400.0])
    logd, vag = diag_gaussian(scales)
    kw = {"n_samples": 600, "n_warmup": 400, "max_depth": 8, "value_and_grad_fn": vag}
    off = qt.nuts_sample(logd, 7, zeros(32, 3), adapt_mass=False, **kw)
    on = qt.nuts_sample(logd, 7, zeros(32, 3), **kw)
    for r in (off, on):
        np.testing.assert_allclose(pooled(r, 3).var(axis=0), scales, rtol=0.35)
    depth_on = float(on.mean_tree_depth.mean())
    depth_off = float(off.mean_tree_depth.mean())
    assert depth_on < depth_off - 0.5, (depth_on, depth_off)
    # the adapted metric itself is right to within a factor ~3
    ratio = on.mass_diag.numpy() / scales
    assert np.all(ratio > 1 / 3) and np.all(ratio < 3.0)
