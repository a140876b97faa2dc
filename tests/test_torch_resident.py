"""The port's resident engine (quasinewtonmethods_jl_tpu_torch/resident_solve.py)
against the JAX package's `optimize_batched_resident` in interpret mode, on
the same numpy starts, in f64, plus its dispatch guards.

On CPU tensors the port runs the resident kernel's plain version, the fleet
engine with the plain update; the CUDA kernel is held to that plain version
on the card in tests/test_torch_kernels_cuda.py. Statuses and every counter
must be equal, as in the JAX package's own contract (tests/test_resident.py).
Float leaves differ only by summation order (torch vs XLA): x, fun, the step
and the gradients at 1e-12 absolute, except where the Hessian amplifies that
noise at the optimum (Rosenbrock's is ~1e3, so ∇ and ∇_old at 1e-9), and
the final B, whose last updates are built from s and y at the level of
rounding (1e-5 relative to max|B|, checked only to convergence). The
guards: objectives that do not trace to B3's table raise on every device;
those that do run (tests/test_torch_resident_traced.py holds them to JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu.models import (
    rosenbrock_logdensity as jax_rosenbrock,
    rosenbrock_value_and_grad as jax_rosenbrock_vag,
)
from quasinewtonmethods_jl_tpu.ops.linesearch import BackTracking as JaxBackTracking
from quasinewtonmethods_jl_tpu.resident_solve import (
    optimize_batched_resident as jax_optimize_batched_resident,
)
from quasinewtonmethods_jl_tpu_torch import (
    BackTracking,
    Status,
    optimize_batched_fused,
    optimize_batched_resident,
    resident_feasible,
)
from quasinewtonmethods_jl_tpu_torch.models import (
    Rosenbrock,
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)
from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_trace import TracedObjective
from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import resident_bfgs_solve
from quasinewtonmethods_jl_tpu_torch.resident_solve import _kernel_objective

torch.set_num_threads(1)

COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")


def solve_both(X0, order=2, **kw):
    port = optimize_batched_resident(
        rosenbrock_logdensity, torch.tensor(X0), ls=BackTracking(order=order), **kw)
    ref = jax_optimize_batched_resident(
        jax_rosenbrock, jnp.asarray(X0), ls=JaxBackTracking(order=order),
        value_and_grad_fn=jax_rosenbrock_vag, block_batch=4, interpret=True, **kw)
    return port, ref


def assert_matches_jax(port, ref, converged):
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("fresh", "stall"):
        np.testing.assert_array_equal(getattr(port.state, name).numpy(),
                                      np.asarray(getattr(ref.state, name)), err_msg=name)
    atol = {"x": 1e-12, "fun": 1e-12, "last_value": 1e-12, "step": 1e-12}
    atol.update(grad=1e-9, grad_old=1e-9) if converged else atol.update(grad=1e-12, grad_old=1e-12)
    for name, tol in atol.items():
        mine = getattr(port, name, None)
        mine = getattr(port.state, name) if mine is None else mine
        theirs = getattr(ref, name, None)
        theirs = getattr(ref.state, name) if theirs is None else theirs
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=tol, rtol=0,
                                   equal_nan=True, err_msg=name)
    B, jB = port.state.B.numpy(), np.asarray(ref.state.B)
    B_tol = 1e-5 * np.abs(jB).max() if converged else 1e-12
    np.testing.assert_allclose(B, jB, atol=B_tol, rtol=0, err_msg="B")


@pytest.mark.parametrize(
    "shape, order, h0_scale",
    [((8, 6), 2, True), ((6, 5), 2, True), ((4, 5), 3, False)],
)
def test_resident_matches_jax_to_convergence(shape, order, h0_scale):
    X0 = np.random.default_rng(20260816).standard_normal(shape)
    port, ref = solve_both(X0, order=order, h0_scale=h0_scale)
    assert (port.status == Status.CONVERGED).all()
    assert float(port.grad.abs().max()) < 1e-8
    assert_matches_jax(port, ref, converged=True)


def test_resident_failure_path_and_zero_cap_match_jax():
    """tol = 1e-14 cannot be met in 5 iterations: every lane ends
    MAX_ITERATIONS with fun NaN; a cap of 0 returns the fresh carry."""
    X0 = np.random.default_rng(20260817).standard_normal((8, 6))
    port, ref = solve_both(X0, tol=1e-14, max_iterations=5)
    assert (port.status == Status.MAX_ITERATIONS).all() and (port.iterations == 5).all()
    assert torch.isnan(port.fun).all()
    assert_matches_jax(port, ref, converged=False)
    port, ref = solve_both(X0, max_iterations=0)
    assert (port.status == Status.MAX_ITERATIONS).all() and (port.iterations == 0).all()
    assert_matches_jax(port, ref, converged=False)


def test_every_form_of_the_rosenbrock_objective_is_accepted():
    X = torch.tensor(np.random.default_rng(1).standard_normal((4, 7)))
    runs = [
        optimize_batched_resident(rosenbrock_logdensity, X, max_iterations=12),
        optimize_batched_resident(rosenbrock_logdensity, X, max_iterations=12,
                                  value_and_grad_fn=rosenbrock_value_and_grad),
        optimize_batched_resident(Rosenbrock(7), X, max_iterations=12, kernel="torch"),
        optimize_batched_resident(Rosenbrock(7, analytic_gradient=True), X, max_iterations=12),
    ]
    for other in runs[1:]:
        for name in COUNTERS:
            assert torch.equal(getattr(runs[0], name), getattr(other, name)), name
        assert torch.equal(runs[0].x, other.x)


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    X = torch.tensor(np.random.default_rng(2).standard_normal((4, 5)))
    before = resident_bfgs_solve.launches
    res = resident_bfgs_solve(X, BackTracking(), 1e-8, 100, True, 50)
    auto = optimize_batched_resident(rosenbrock_logdensity, X, max_iterations=100)
    assert resident_bfgs_solve.launches == before
    for name in COUNTERS:
        assert torch.equal(getattr(res, name), getattr(auto, name)), name


def quad_logdensity(x):
    return -0.5 * torch.sum(x * x)


class SubclassedRosenbrock(Rosenbrock):
    def logdensity(self, theta):
        return 2.0 * super().logdensity(theta)


def i0_logdensity(x):
    return torch.sum(torch.special.i0(x))  # aten.i0 is outside the trace's table


def item_logdensity(x):
    return -0.5 * torch.sum(x * x) * x[0].item()  # a host read


def random_value_and_grad(x):
    return quad_logdensity(x), -x + 0.0 * torch.randn_like(x)


# Until the traced route, B3 refused every objective but its hand-written
# ones; the three it refused here (a plain function, a subclass, a user
# value_and_grad_fn) now run (test_resident_runs_objectives_it_traces), and
# their places hold objectives that do not trace.
@pytest.mark.parametrize(
    "kwargs, match",
    [
        ({"x0s": torch.zeros(6)}, "x0s must be"),
        ({"ls": object()}, "BackTracking"),
        ({"obj": i0_logdensity}, "optimize_batched_fused"),
        ({"obj": item_logdensity}, "optimize_batched_fused"),
        ({"value_and_grad_fn": random_value_and_grad}, "on the card"),
        ({"kernel": "cuda"}, "cuda"),
        ({"kernel": "pallas"}, "kernel"),
    ],
)
def test_resident_guards(kwargs, match):
    args = {"obj": rosenbrock_logdensity, "x0s": torch.zeros((4, 6))}
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        optimize_batched_resident(**args)


@pytest.mark.parametrize(
    "kwargs",
    [{"obj": quad_logdensity}, {"obj": SubclassedRosenbrock(6)},
     {"value_and_grad_fn": lambda x: (quad_logdensity(x), -x)}],
    ids=["function", "subclass", "value_and_grad_fn"],
)
def test_resident_runs_objectives_it_traces(rng, kwargs):
    """The objectives B3 refused until it traced them, as JAX's resident
    engine takes them: the kernel's route is the trace, and on the CPU the
    run is the fleet engine with the plain update on the same functions."""
    args = {"obj": rosenbrock_logdensity, "value_and_grad_fn": None}
    args.update(kwargs)
    X = torch.tensor(rng.standard_normal((4, 6)))
    assert isinstance(_kernel_objective(args["obj"], args["value_and_grad_fn"], X),
                      TracedObjective)
    res = optimize_batched_resident(x0s=X, tol=1e-8, **args)
    plain = optimize_batched_fused(x0s=X, tol=1e-8, kernel="torch", **args)
    for name in COUNTERS:
        assert torch.equal(getattr(res, name), getattr(plain, name)), name
    assert torch.equal(res.x, plain.x)


@pytest.mark.parametrize(
    "n, itemsize, feasible",
    [(60, 4, True), (236, 4, True), (237, 4, False), (512, 4, False),
     (165, 8, True), (166, 8, False)],
)
def test_resident_feasible_is_the_kernels_byte_count(n, itemsize, feasible):
    """csrc/resident_solve.cu :: smem_bytes: (n² + 9n + 4·16)·itemsize
    against the 232,448 bytes a Hopper block may opt into."""
    assert resident_feasible(n, itemsize) is feasible
