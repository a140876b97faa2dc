"""The port's fleet engine as a whole (optimize_batched_fused /
optimize_batched, plain PyTorch update on the CPU) against the JAX
package's `optimize_batched_fused`, with both of its update kernels
('xla' and the Pallas kernel in interpret mode), on the same numpy starts.

Where the trajectory is numerically stable (the concave quadratic fleet)
or short (Rosenbrock up to 17 iterations), statuses and every counter must
be equal and x agrees to rounding (1e-10 / 1e-9 in f64: the packages sum in
different orders). Run to convergence, Rosenbrock trajectories drift apart
at rounding level, so there the two must reach the same certificate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu.batched_solve import (
    optimize_batched_fused as jax_optimize_batched_fused,
)
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.ops.linesearch import BackTracking as JaxBackTracking
from quasinewtonmethods_jl_tpu_torch import (
    BackTracking,
    Status,
    Wolfe,
    optimize_batched,
    optimize_batched_fused,
)
from quasinewtonmethods_jl_tpu_torch.batched_solve import TERMINATION_CHECK_INTERVAL
from quasinewtonmethods_jl_tpu_torch.models import (
    Rosenbrock,
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)

torch.set_num_threads(1)

COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")
JAX_KERNELS = ["xla", "pallas_interpret"]


def quad_logdensity(x):
    diag = torch.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype)
    return -0.5 * torch.sum(diag * x * x)


def jax_quad_logdensity(x):
    diag = jnp.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype)
    return -0.5 * jnp.sum(diag * x * x)


def nan_at_x0(x):
    return torch.where(x[0] > 0.5, torch.nan, quad_logdensity(x))


def jax_nan_at_x0(x):
    return jnp.where(x[0] > 0.5, jnp.nan, jax_quad_logdensity(x))


def solve_both(port_obj, jax_obj, X0, kernel, port_ls=None, jax_ls=None, **kw):
    port = optimize_batched_fused(
        port_obj, torch.tensor(X0), ls=port_ls or BackTracking(), kernel="torch", **kw
    )
    ref = jax_optimize_batched_fused(
        jax_obj, jnp.asarray(X0), ls=jax_ls or JaxBackTracking(), kernel=kernel,
        block_batch=16, **kw
    )
    return port, ref


def assert_counters_equal(port, ref):
    for name in COUNTERS:
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )


@pytest.mark.parametrize("kernel", JAX_KERNELS)
def test_quadratic_fleet_matches_jax_exactly(rng, kernel):
    X0 = rng.standard_normal((8, 6))
    port, ref = solve_both(quad_logdensity, jax_quad_logdensity, X0, kernel)
    assert_counters_equal(port, ref)
    assert (port.status == Status.CONVERGED).all()
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-10, rtol=0)
    np.testing.assert_allclose(port.fun.numpy(), np.asarray(ref.fun), atol=1e-12, rtol=0)


@pytest.mark.parametrize("kernel", JAX_KERNELS)
@pytest.mark.parametrize("max_iterations", [0, 1, 2, 5, 17])
def test_rosenbrock_short_horizon_matches_jax_exactly(rng, kernel, max_iterations):
    """17 = 1 + 2 * TERMINATION_CHECK_INTERVAL: the cap stays exact across
    the host's termination tests."""
    assert TERMINATION_CHECK_INTERVAL == 8
    X0 = rng.standard_normal((32, 10))
    port, ref = solve_both(
        rosenbrock_logdensity, jax_rosenbrock, X0, kernel, max_iterations=max_iterations
    )
    assert_counters_equal(port, ref)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)
    np.testing.assert_allclose(
        port.state.B.numpy(), np.asarray(ref.state.B), atol=1e-8, rtol=0
    )
    np.testing.assert_array_equal(port.state.fresh.numpy(), np.asarray(ref.state.fresh))
    if max_iterations:
        assert (port.status == Status.MAX_ITERATIONS).all()
        assert (port.iterations == max_iterations).all()


@pytest.mark.parametrize("kernel", JAX_KERNELS)
def test_rosenbrock_to_convergence_matches_jax_certificate(rng, kernel):
    X0 = rng.standard_normal((32, 10))
    port, ref = solve_both(rosenbrock_logdensity, jax_rosenbrock, X0, kernel)
    assert (port.status == Status.CONVERGED).all()
    assert (np.asarray(ref.status) == Status.CONVERGED).all()
    assert float(port.grad.abs().max()) < 1e-8
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.x.numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("kernel", JAX_KERNELS)
def test_order3_backtracking_matches_jax(rng, kernel):
    X0 = rng.standard_normal((32, 10))
    port, ref = solve_both(
        rosenbrock_logdensity, jax_rosenbrock, X0, kernel,
        port_ls=BackTracking(order=3), jax_ls=JaxBackTracking(order=3), max_iterations=17,
    )
    assert_counters_equal(port, ref)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)
    full = optimize_batched_fused(
        rosenbrock_logdensity, torch.tensor(X0), ls=BackTracking(order=3), kernel="torch"
    )
    assert (full.status == Status.CONVERGED).all()


@pytest.mark.parametrize("kernel", JAX_KERNELS)
def test_nan_at_start_is_nonfinite_and_matches_jax(rng, kernel):
    X0 = rng.standard_normal((16, 5))
    X0[:4, 0] = 1.0  # NaN at x0
    port, ref = solve_both(nan_at_x0, jax_nan_at_x0, X0, kernel)
    assert_counters_equal(port, ref)
    assert (port.status[:4] == Status.NONFINITE_VALUE).all()
    assert torch.isnan(port.fun[:4]).all() and torch.isnan(port.last_value[:4]).all()
    assert (port.iterations[:4] == 0).all()
    np.testing.assert_array_equal(port.x[:4].numpy(), X0[:4])  # never moved
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=1e-10, rtol=0)


def test_f32_rosenbrock_n60_fleet_converges(rng):
    X0 = rng.standard_normal((64, 60)).astype(np.float32)
    port = optimize_batched(
        rosenbrock_logdensity, torch.tensor(X0), tol=1e-3, max_iterations=3000,
        value_and_grad_fn=rosenbrock_value_and_grad,
    )
    ref = jax_optimize_batched_fused(
        jax_rosenbrock, jnp.asarray(X0), tol=1e-3, max_iterations=3000, kernel="xla"
    )
    assert port.x.dtype == torch.float32 and port.state.B.dtype == torch.float32
    assert (port.status == Status.CONVERGED).all()
    assert (np.asarray(ref.status) == Status.CONVERGED).all()
    assert float(port.grad.abs().max()) < 1e-3


def test_model_object_and_autodiff_match_analytic_gradient(rng):
    X0 = torch.tensor(rng.standard_normal((8, 7)))
    runs = [
        optimize_batched_fused(Rosenbrock(7), X0, max_iterations=12),
        optimize_batched_fused(Rosenbrock(7, analytic_gradient=True), X0, max_iterations=12),
        optimize_batched_fused(rosenbrock_logdensity, X0, max_iterations=12,
                               value_and_grad_fn=rosenbrock_value_and_grad),
    ]
    for other in runs[1:]:
        for name in COUNTERS:
            assert torch.equal(getattr(runs[0], name), getattr(other, name)), name
        torch.testing.assert_close(runs[0].x, other.x, atol=1e-12, rtol=0)


def test_loop_counts_syncs_and_no_op_tail(rng):
    """Bodies past the last lane's finish are no-ops, and the host reads
    the device only for control flow."""
    X0 = torch.tensor(rng.standard_normal((8, 6)))
    optimize_batched_fused.host_syncs = optimize_batched_fused.loop_bodies = 0
    res = optimize_batched_fused(quad_logdensity, X0)
    bodies, syncs = optimize_batched_fused.loop_bodies, optimize_batched_fused.host_syncs
    last = int(res.iterations.max())
    assert last <= bodies + 1 <= last + TERMINATION_CHECK_INTERVAL
    assert bodies + 1 <= syncs  # at least one line-search read per body
    tail = optimize_batched_fused(quad_logdensity, X0, max_iterations=bodies + 1)
    for name in COUNTERS:
        assert torch.equal(getattr(res, name), getattr(tail, name)), name
    assert torch.equal(res.x, tail.x)


def test_unported_options_raise():
    X0 = torch.zeros((2, 3))
    # backend="vmap" is ported (the scalar driver lane by lane); fold_eval
    # stays a fused-engine option there, as in JAX
    res = optimize_batched(quad_logdensity, X0, backend="vmap")
    assert (res.status == Status.CONVERGED).all() and res.x.shape == (2, 3)
    with pytest.raises(ValueError, match="fused-engine"):
        optimize_batched(quad_logdensity, X0, backend="vmap", fold_eval=True)
    with pytest.raises(ValueError, match="backend"):
        optimize_batched(quad_logdensity, X0, backend="sharded")
    # fold_eval and the Wolfe search are ported: both run
    for kw in (dict(fold_eval=True), dict(ls=Wolfe()), dict(ls=Wolfe(), fold_eval=True)):
        res = optimize_batched_fused(quad_logdensity, X0, **kw)
        assert (res.status == Status.CONVERGED).all(), kw
    with pytest.raises(TypeError, match="BackTracking or a Wolfe"):
        optimize_batched_fused(quad_logdensity, X0, ls=object())
    with pytest.raises(ValueError, match="kernel"):
        optimize_batched_fused(quad_logdensity, X0, kernel="pallas")
