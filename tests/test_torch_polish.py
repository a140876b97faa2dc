"""The port's Newton polish (polish.py) against the JAX package's, on the
CPU in f64: both polish the same input (the iterates and statuses of one
loose JAX solve, passed to each as its own tensors), scalar and fleet, the
f32 -> f64 recast, lanes that had failed, an analytic value_and_grad, and
``steps`` below 1.

``improved`` equal lane by lane; x, fun, grad within rtol 1e-8 (atol
1e-10: at the evaluation floor what is left is rounding); the gradient
norms within atol 1e-10.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.models import rosenbrock_value_and_grad as jax_rosenbrock_vag
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.models import (
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)

torch.set_num_threads(1)

N = 6
_C = np.random.default_rng(3).standard_normal((N, N))
CI = np.linalg.inv(_C @ _C.T / N + np.eye(N))
MU = np.random.default_rng(4).standard_normal(N) / 3.0


def quartic(x):
    """A Gaussian with a quartic term, mode off any grid (either package)."""
    xp = torch if isinstance(x, torch.Tensor) else jnp
    d = x - (torch.tensor(MU) if xp is torch else jnp.asarray(MU))
    ci = torch.tensor(CI) if xp is torch else jnp.asarray(CI)
    return -0.5 * d @ (ci @ d) - 0.1 * xp.sum(d ** 4)


class Res(NamedTuple):
    x: object
    status: object


def _inputs(obj, batch=8, tol=1e-3, dtype=np.float64):
    """A loose f64 solve's iterates (in ``dtype``) and statuses."""
    X = np.random.default_rng(20260816).standard_normal((batch, N))
    ref = qnm.optimize_batched(obj, jnp.asarray(X), tol=tol)
    x, status = np.asarray(ref.x).astype(dtype), np.asarray(ref.status)
    return Res(torch.tensor(x), torch.tensor(status)), Res(jnp.asarray(x), jnp.asarray(status))


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.improved.numpy(), np.asarray(ref.improved))
    for name in ("x", "fun", "grad"):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-8, atol=1e-10, err_msg=name)
    for name in ("grad_norm_before", "grad_norm_after"):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-8, atol=1e-10, err_msg=name)
        assert getattr(port, name).dtype == port.x.dtype


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("obj", ["quartic", "rosenbrock"])
def test_a_fleet_matches_jax(obj, steps):
    port_obj, jax_obj = {"quartic": (quartic, quartic),
                         "rosenbrock": (rosenbrock_logdensity, jax_rosenbrock)}[obj]
    res, jres = _inputs(jax_obj)
    port = qt.polish_newton(port_obj, res, steps=steps)
    ref = qnm.polish_newton(jax_obj, jres, steps=steps)
    _assert_same(port, ref)
    assert bool(port.improved.all())
    assert float(port.grad_norm_after.max()) < float(port.grad_norm_before.min())


def test_a_single_solve_and_an_analytic_gradient_match_jax():
    res, jres = _inputs(jax_rosenbrock, batch=1)
    res1, jres1 = Res(res.x[0], res.status[0]), Res(jres.x[0], jres.status[0])
    port = qt.polish_newton(rosenbrock_logdensity, res1, steps=2,
                            value_and_grad_fn=rosenbrock_value_and_grad)
    ref = qnm.polish_newton(jax_rosenbrock, jres1, steps=2, value_and_grad_fn=jax_rosenbrock_vag)
    _assert_same(port, ref)
    assert port.x.shape == (N,) and port.fun.shape == () and port.improved.shape == ()


def test_the_f32_to_f64_recast_matches_jax():
    res, jres = _inputs(quartic, dtype=np.float32)
    assert res.x.dtype == torch.float32
    port = qt.polish_newton(quartic, res, steps=3, dtype=torch.float64)
    ref = qnm.polish_newton(quartic, jres, steps=3, dtype=jnp.float64)
    assert port.x.dtype == port.fun.dtype == torch.float64
    _assert_same(port, ref)
    assert float(port.grad_norm_after.max()) < 1e-8


def test_failed_lanes_pass_through_with_nan_fun():
    res, jres = _inputs(quartic)
    status = res.status.clone()
    status[1], status[4] = int(qt.Status.MAX_ITERATIONS), int(qt.Status.LINESEARCH_FAILURE)
    x = res.x.clone()
    x[4, 0] = float("nan")
    res, jres = Res(x, status), Res(jnp.asarray(x.numpy()), jnp.asarray(status.numpy()))
    port = qt.polish_newton(quartic, res)
    ref = qnm.polish_newton(quartic, jres)
    _assert_same(port, ref)
    failed = torch.tensor([i in (1, 4) for i in range(8)])
    assert bool(torch.isnan(port.fun[failed]).all()) and not bool(port.improved[failed].any())
    assert torch.equal(torch.nan_to_num(port.x[failed]), torch.nan_to_num(x[failed]))


def test_steps_below_one_raise_as_in_jax():
    res, jres = _inputs(quartic, batch=2)
    with pytest.raises(ValueError, match="steps must be >= 1, got 0"):
        qt.polish_newton(quartic, res, steps=0)
    with pytest.raises(ValueError, match="steps must be >= 1, got 0"):
        qnm.polish_newton(quartic, jres, steps=0)
