"""The port's Laplace evidence (laplace.py) against the JAX package's, on
the CPU in f64: a Gaussian's closed-form evidence, the exact-Hessian, the
dense-B and the L-BFGS-ring paths on the same JAX solve (scalar and fleet;
the port gets its leaves as tensors, since the solves' own trajectories
part by rounding over whole runs), NaN lanes (a saddle, a failed solve),
and the error for a result that carries no curvature.

Evidence within rtol 1e-8 of JAX's (the Gaussian's closed form 1e-10).
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity

torch.set_num_threads(1)

N = 5
_A = np.random.default_rng(5).standard_normal((N, N))
COV = _A @ _A.T / N + np.eye(N)
CI = np.linalg.inv(COV)
MU = np.random.default_rng(6).standard_normal(N)


def gaussian(x):
    xp = torch if isinstance(x, torch.Tensor) else jnp
    d = x - (torch.tensor(MU) if xp is torch else jnp.asarray(MU))
    return -0.5 * d @ ((torch.tensor(CI) if xp is torch else jnp.asarray(CI)) @ d)


def skewed(x):
    """Not a Gaussian: B and the rings differ from the exact Hessian."""
    xp = torch if isinstance(x, torch.Tensor) else jnp
    return gaussian(x) - 0.05 * xp.sum((x - 0.3) ** 4)


def _starts(batch=6):
    return np.random.default_rng(20260816).standard_normal((batch, N))


def _as_port(ref):
    """A JAX OptimizeResult or LBFGSResult with the port's classes and
    tensors, leaf for leaf."""
    cls, state_cls = ((qt.OptimizeResult, qt.BFGSState) if hasattr(ref.state, "B")
                      else (qt.LBFGSResult, qt.LBFGSState))
    state = state_cls(*(torch.tensor(np.asarray(leaf)) for leaf in ref.state))
    return cls(*(torch.tensor(np.asarray(leaf)) for leaf in ref[:-1]), state=state)


def _close(port, ref, rtol=1e-8):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=1e-12)


def test_a_gaussians_evidence_is_exact():
    truth = 0.5 * np.linalg.slogdet(COV)[1] + 0.5 * N * np.log(2 * np.pi)
    res = qt.optimize_batched(gaussian, torch.tensor(_starts()))
    lz = qt.laplace_evidence(res, obj=gaussian)
    assert lz.shape == (6,) and lz.dtype == torch.float64
    np.testing.assert_allclose(lz.numpy(), truth, rtol=1e-10)
    one = qt.laplace_evidence(qt.optimize(gaussian, torch.tensor(_starts()[0])), obj=gaussian)
    assert one.shape == ()
    np.testing.assert_allclose(float(one), truth, rtol=1e-10)


@pytest.mark.parametrize("obj", ["skewed", "rosenbrock"])
@pytest.mark.parametrize("batched", [False, True])
def test_exact_and_dense_b_paths_match_jax(obj, batched):
    port_obj, jax_obj = {"skewed": (skewed, skewed),
                         "rosenbrock": (rosenbrock_logdensity, jax_rosenbrock)}[obj]
    X = _starts() if batched else _starts()[0]
    ref = (qnm.optimize_batched if batched else qnm.optimize)(jax_obj, jnp.asarray(X))
    res = _as_port(ref)
    _close(qt.laplace_evidence(res, obj=port_obj), qnm.laplace_evidence(ref, obj=jax_obj))
    _close(qt.laplace_evidence(res), qnm.laplace_evidence(ref))


@pytest.mark.parametrize("batched", [False, True])
def test_the_lbfgs_ring_path_matches_jax(batched):
    X = _starts() if batched else _starts()[0]
    solve = qnm.optimize_lbfgs_batched if batched else qnm.optimize_lbfgs
    ref = solve(skewed, jnp.asarray(X), history=4)
    port, jax_lz = qt.laplace_evidence(_as_port(ref)), qnm.laplace_evidence(ref)
    assert port.shape == ((6,) if batched else ())
    _close(port, jax_lz)


class Res(NamedTuple):
    x: object
    fun: object


def test_nan_lanes_match_jax():
    """A saddle (-H not positive definite) and a failed lane (fun NaN)."""

    def saddle(x):
        xp = torch if isinstance(x, torch.Tensor) else jnp
        return -x[0] ** 2 + x[1] ** 2 - xp.sum(x[2:] ** 2)

    x = np.zeros((3, N))
    fun = np.array([0.0, np.nan, 0.0])
    port = qt.laplace_evidence(Res(torch.tensor(x), torch.tensor(fun)), obj=saddle)
    ref = qnm.laplace_evidence(Res(jnp.asarray(x), jnp.asarray(fun)), obj=saddle)
    assert bool(torch.isnan(port).all()) and bool(jnp.isnan(ref).all())
    fleet = qt.optimize_batched(gaussian, torch.tensor(_starts()), max_iterations=2)
    jfleet = qnm.optimize_batched(gaussian, jnp.asarray(_starts()), max_iterations=2)
    for obj in (None, gaussian):
        port, ref = qt.laplace_evidence(fleet, obj=obj), qnm.laplace_evidence(jfleet, obj=obj)
        np.testing.assert_array_equal(port.isnan().numpy(), np.isnan(np.asarray(ref)))
        assert bool(port.isnan().all())


def test_no_curvature_raises_as_in_jax():
    message = "result carries no curvature \\(neither dense B nor L-BFGS rings\\)"
    res = qt.optimize_cg(gaussian, torch.tensor(_starts()))
    ref = qnm.optimize_cg(gaussian, jnp.asarray(_starts()))
    with pytest.raises(ValueError, match=message):
        qt.laplace_evidence(res)
    with pytest.raises(ValueError, match=message):
        qnm.laplace_evidence(ref)
    _close(qt.laplace_evidence(res, obj=gaussian), qnm.laplace_evidence(ref, obj=gaussian))
