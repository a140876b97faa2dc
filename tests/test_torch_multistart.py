"""The port's multistart (multistart.py) against the JAX package's, on the
CPU in f64 with the same numpy starts (``x0s``: ``jax.random`` cannot be
reproduced): every route (the BFGS, TR and CG fleets and the constrained
auglag fleet) with ``best_index``, ``n_converged``, ``fun`` and the fleet's
counters equal lane by lane, floats within rtol 1e-8; no converged lane
(NaN ``fun``); a bad engine; and the starts drawn from a torch.Generator
(device, dtype, reproducibility).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qnm
import quasinewtonmethods_jl_tpu_torch as qt

torch.set_num_threads(1)

COUNTERS = {
    "bfgs": ("status", "iterations", "n_fev", "n_gev", "n_resets"),
    "cg": ("status", "iterations", "n_fev", "n_gev", "n_resets"),
    "tr": ("status", "iterations", "n_fev", "n_hev"),
    "auglag": ("status", "n_outer", "iterations", "n_fev", "inner_status"),
}


TILT = (0.3, 0.2, 0.1, 0.05)


def wells(x):
    """Tilted double wells: a mode near ±1 per coordinate, each tilted
    by another amount, so that the 16 modes have 16 values (either
    package)."""
    xp = torch if isinstance(x, torch.Tensor) else jnp
    tilt = sum(c * x[i] for i, c in enumerate(TILT))
    return -xp.sum((x * x - 1.0) ** 2) + tilt


def disk(x):
    xp = torch if isinstance(x, torch.Tensor) else jnp
    return xp.stack([1.5 - (x * x).sum()])


def _starts(batch=16):
    """One start in each of the 16 basins (every sign pattern, jittered),
    so that the best mode is one lane's and no tie of rounding picks it."""
    signs = np.array(list(itertools.product((-1.0, 1.0), repeat=4)))[:batch]
    return 0.9 * signs + 0.1 * np.random.default_rng(20260816).standard_normal((batch, 4))


def _assert_same(port, ref, counters, tied=False):
    """With ``tied``, several lanes reach the best mode and rounding picks
    among them: the port's pick must be one of those lanes."""
    assert int(port.n_converged) == int(ref.n_converged)
    if tied:
        fun = np.asarray(ref.fleet.fun)
        assert abs(fun[int(port.best_index)] - float(ref.fun)) <= 1e-8 * abs(float(ref.fun))
    else:
        assert int(port.best_index) == int(ref.best_index)
    np.testing.assert_allclose(float(port.fun), float(ref.fun), rtol=1e-8)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=1e-8, atol=1e-10)
    for name in counters:
        np.testing.assert_array_equal(getattr(port.fleet, name).numpy(),
                                      np.asarray(getattr(ref.fleet, name)), err_msg=name)
    np.testing.assert_allclose(port.fleet.x.numpy(), np.asarray(ref.fleet.x), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("engine,kw", [
    ("bfgs", {}),
    ("bfgs", {"backend": "vmap"}),
    ("cg", {}),
    ("cg", {"method": "pr"}),
    ("tr", {}),
    ("tr", {"bounds": (-1.2, 1.2)}),
])
def test_every_route_matches_jax(engine, kw):
    X = _starts()
    port = qt.optimize_multistart(wells, None, 16, 4, x0s=torch.tensor(X), engine=engine,
                                  tol=1e-6, **kw)
    ref = qnm.optimize_multistart(wells, None, 16, 4, x0s=jnp.asarray(X), engine=engine,
                                  tol=1e-6, **kw)
    _assert_same(port, ref, COUNTERS[engine])
    assert bool(port.converged) and port.best_index.dtype == torch.int32
    assert port.n_converged.dtype == torch.int32 and port.x.shape == (4,)


@pytest.mark.parametrize("engine", ["bfgs", "lbfgs"])
def test_the_constrained_route_matches_jax(engine):
    X = _starts(batch=8)
    port = qt.optimize_multistart(wells, None, 8, 4, x0s=torch.tensor(X), ineq=disk,
                                  engine=engine, tol=1e-6, ctol=1e-6)
    ref = qnm.optimize_multistart(wells, None, 8, 4, x0s=jnp.asarray(X), ineq=disk,
                                  engine=engine, tol=1e-6, ctol=1e-6)
    _assert_same(port, ref, COUNTERS["auglag"])
    assert port.fleet.mu.shape == (8, 1)


def test_the_constrained_route_picks_the_true_maximum():
    """JAX's test: d·z on the unit circle has one maximum and one minimum,
    and only the KKT-certified lanes compete."""
    d = torch.tensor([1.0, 2.0], dtype=torch.float64)
    x_max = np.array([1.0, 2.0]) / np.sqrt(5.0)
    starts = np.concatenate([
        x_max[None] + 0.05 * np.random.default_rng(0).standard_normal((4, 2)),
        -x_max[None] + 0.05 * np.random.default_rng(1).standard_normal((4, 2)),
    ])
    r = qt.optimize_multistart(lambda z: d @ z, None, 8, 2, x0s=torch.tensor(starts),
                               eq=lambda z: torch.stack([(z * z).sum() - 1.0]))
    ref = qnm.optimize_multistart(lambda z: jnp.asarray([1.0, 2.0]) @ z, None, 8, 2,
                                  x0s=jnp.asarray(starts),
                                  eq=lambda z: jnp.asarray([jnp.sum(z * z) - 1.0]))
    _assert_same(r, ref, COUNTERS["auglag"], tied=True)
    np.testing.assert_allclose(r.x.numpy(), x_max, atol=1e-5)
    np.testing.assert_allclose(float(r.fun), np.sqrt(5.0), atol=1e-6)


def test_no_converged_lane_gives_nan_as_in_jax():
    X = _starts()
    port = qt.optimize_multistart(wells, None, 16, 4, x0s=torch.tensor(X), max_iterations=1)
    ref = qnm.optimize_multistart(wells, None, 16, 4, x0s=jnp.asarray(X), max_iterations=1)
    assert int(port.n_converged) == int(ref.n_converged) == 0
    assert not bool(port.converged)
    assert np.isnan(float(port.fun)) and np.isnan(float(ref.fun))
    assert int(port.best_index) == int(ref.best_index) == 0
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=1e-8)


def test_a_bad_engine_raises_as_in_jax():
    X = _starts()
    with pytest.raises(ValueError, match="engine must be 'bfgs', 'tr', or 'cg', got 'nuts'"):
        qt.optimize_multistart(wells, None, 16, 4, x0s=torch.tensor(X), engine="nuts")
    with pytest.raises(ValueError, match="engine must be 'bfgs', 'tr', or 'cg', got 'nuts'"):
        qnm.optimize_multistart(wells, None, 16, 4, x0s=jnp.asarray(X), engine="nuts")


def test_generator_starts_device_dtype_and_reproducibility(monkeypatch):
    gen = torch.Generator().manual_seed(7)
    r = qt.optimize_multistart(wells, gen, 12, 4, init_scale=1.5, tol=1e-6)
    expect = 1.5 * torch.randn((12, 4), generator=torch.Generator().manual_seed(7),
                               dtype=torch.float64)
    # the fleet ran on the generator's device, in the CPU's default float64
    assert r.fleet.x.device.type == "cpu" and r.fleet.x.dtype == torch.float64
    again = qt.optimize_multistart(wells, None, 12, 4, x0s=expect, tol=1e-6)
    for name in ("x", "status", "iterations", "n_fev"):
        assert torch.equal(getattr(r.fleet, name), getattr(again.fleet, name)), name
    f32 = qt.optimize_multistart(wells, torch.Generator().manual_seed(7), 12, 4, tol=1e-3,
                                 dtype=torch.float32)
    assert f32.fleet.x.dtype == torch.float32
    with pytest.raises(ValueError, match="generator"):
        qt.optimize_multistart(wells, None, 12, 4)
    # an int seed draws on the card: without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        qt.optimize_multistart(wells, 7, 12, 4)
