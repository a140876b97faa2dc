"""The data-bearing objectives of the port's resident engine — the
logistic-regression MAP (models/logistic.py) and the ill-conditioned
quadratic — against the JAX package, on the same numpy data in f64 on the
CPU, plus the resident engine's dispatch guards for them: the forms its
hand-written instantiations do not take run through the trace, and
objectives that do not trace raise.

The JAX models draw their data with ``jax.random``; each test builds the
JAX model and then gives it the numpy data (``X``, ``y`` or ``x_star``)
that the port's model takes as arrays. On CPU tensors the port's
`optimize_batched_resident` runs the kernel's plain version, the fleet
engine with the plain update on the same objective; JAX's runs its
resident kernel in interpret mode. As JAX's own
``test_resident_matvec_objectives_via_dot_rewrite`` holds its resident
engine to its fleet engine on such objectives, statuses, iterations and
n_resets must be equal, x within 1e-6 relative / 1e-9 absolute and fun
within 1e-9 relative, at tol 1e-6 (at 1e-8 a logistic fixture can sit on
the f64 line search's failure edge, where summation order decides a lane).
The CUDA kernel is held to the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
from quasinewtonmethods_jl_tpu.models import IllConditionedQuadratic as JaxQuadratic
from quasinewtonmethods_jl_tpu.models import LogisticRegressionMAP as JaxLogistic
from quasinewtonmethods_jl_tpu.resident_solve import (
    optimize_batched_resident as jax_optimize_batched_resident,
)
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.models import (
    IllConditionedQuadratic,
    LogisticRegressionMAP,
    rosenbrock_logdensity,
)
from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_trace import TracedObjective
from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import (
    objective_name,
    resident_bfgs_solve,
)
from quasinewtonmethods_jl_tpu_torch.resident_solve import _kernel_objective

torch.set_num_threads(1)


def logistic_pair(rng, n, n_obs, prior_scale=10.0):
    """The same posterior in both packages, from numpy data drawn by the
    models' recipe."""
    X = rng.standard_normal((n_obs, n)) / np.sqrt(n)
    w_true = rng.standard_normal(n)
    y = (rng.random(n_obs) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    ref = JaxLogistic(n, n_obs, prior_scale=prior_scale)
    ref.X, ref.y = jnp.asarray(X), jnp.asarray(y)
    return LogisticRegressionMAP(n, n_obs, prior_scale=prior_scale, X=X, y=y), ref


def quadratic_pair(n, condition=1e3):
    ref = JaxQuadratic(n, condition=condition)
    return IllConditionedQuadratic(n, condition=condition, x_star=ref.x_star), ref


def test_logistic_value_and_gradient_match_jax(rng):
    port, ref = logistic_pair(rng, 12, 80, prior_scale=2.5)
    for scale in (0.0, 1.0, 5.0):
        w = rng.standard_normal(12) * scale
        value, grad = port.logdensity_and_gradient(torch.tensor(w))
        jvalue, jgrad = jax.value_and_grad(ref.logdensity)(jnp.asarray(w))
        np.testing.assert_allclose(float(value), float(jvalue), rtol=1e-12)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-12, atol=1e-14)
        assert float(port.logdensity(torch.tensor(w))) == float(value)


def test_logistic_model_data_and_placement():
    model = LogisticRegressionMAP(7, 40, seed=3)
    assert model.X.shape == (40, 7) and model.y.shape == (40,) and model.n_obs == 40
    assert set(model.y.unique().tolist()) <= {0.0, 1.0}
    again = LogisticRegressionMAP(7, 40, seed=3)
    assert torch.equal(model.X, again.X) and torch.equal(model.y, again.y)
    value = model.logdensity(torch.zeros(7, dtype=torch.float32))  # follows the point's dtype
    assert value.dtype == torch.float32
    np.testing.assert_allclose(float(value), -40 * np.log(2.0), rtol=1e-6)
    with pytest.raises(ValueError, match="both X and y"):
        LogisticRegressionMAP(3, 5, X=np.zeros((5, 3)))
    with pytest.raises(ValueError, match="X must be"):
        LogisticRegressionMAP(3, 5, X=np.zeros((5, 4)), y=np.zeros(5))


def test_scalar_optimize_on_the_logistic_matches_jax(rng):
    port_model, ref_model = logistic_pair(rng, 8, 64)
    x0 = rng.standard_normal(8)
    port = qt.optimize(port_model, torch.tensor(x0), tol=1e-6)
    ref = qj.optimize(ref_model, jnp.asarray(x0), tol=1e-6)
    assert int(port.status) == int(ref.status) == qt.Status.CONVERGED
    assert int(port.iterations) == int(ref.iterations)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=1e-6, atol=1e-9)


def _resident_both(port_model, ref_model, X0):
    port = qt.optimize_batched_resident(port_model, torch.tensor(X0), tol=1e-6)
    ref = jax_optimize_batched_resident(ref_model, jnp.asarray(X0), tol=1e-6, block_batch=4,
                                        interpret=True)
    return port, ref


@pytest.mark.parametrize("objective", ["logistic 16x8", "quadratic 6x6"])
def test_resident_engine_on_data_bearing_objectives_matches_jax(rng, objective):
    if objective.startswith("logistic"):
        port_model, ref_model = logistic_pair(rng, 8, 64)
        X0 = rng.standard_normal((16, 8))
    else:
        port_model, ref_model = quadratic_pair(6)
        X0 = rng.standard_normal((6, 6))
    before = resident_bfgs_solve.launches
    port, ref = _resident_both(port_model, ref_model, X0)
    assert resident_bfgs_solve.launches == before  # CPU tensors: the plain version
    for name in ("status", "iterations", "n_resets"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert (port.status == qt.Status.CONVERGED).all()
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(port.fun.numpy(), np.asarray(ref.fun), rtol=1e-9, atol=1e-12)


def test_resident_engine_on_a_model_whose_data_lie_elsewhere(rng):
    """A model built in float32 serves a float64 solve: its data go to the
    solve's dtype once, for the plain version as for the kernel."""
    X = rng.standard_normal((30, 5))
    y = (rng.random(30) < 0.5).astype(np.float64)
    X0 = torch.tensor(rng.standard_normal((4, 5)))
    f32 = LogisticRegressionMAP(5, 30, dtype=torch.float32, X=X, y=y)
    f64 = LogisticRegressionMAP(5, 30, X=torch.tensor(X, dtype=torch.float32).double(),
                                y=torch.tensor(y))
    a = qt.optimize_batched_resident(f32, X0, tol=1e-6)
    b = qt.optimize_batched_resident(f64, X0, tol=1e-6)
    assert a.x.dtype == torch.float64 and f32.X.dtype == torch.float32
    for name in ("status", "iterations", "n_fev", "n_resets"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.x, b.x)


class SubclassedLogistic(LogisticRegressionMAP):
    def logdensity(self, w):
        return 2.0 * super().logdensity(w)


# The closure, the subclass and the user value_and_grad_fn were refused
# until B3 traced objectives; JAX's resident engine takes them, and the
# port's now runs them through the trace. The device guard stays.
@pytest.mark.parametrize("case", ["closure", "subclass", "value_and_grad_fn", "cuda on the cpu"])
def test_resident_guards_for_data_bearing_objectives(rng, case):
    model = LogisticRegressionMAP(4, 10, seed=1)
    args = {"obj": model, "x0s": torch.tensor(rng.standard_normal((3, 4))),
            "value_and_grad_fn": None}
    if case == "cuda on the cpu":
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            qt.optimize_batched_resident(kernel="cuda", **args)
        return
    if case == "closure":
        args["obj"] = model.logdensity
    elif case == "subclass":
        args["obj"] = SubclassedLogistic(4, 10, seed=1)
    else:
        args["value_and_grad_fn"] = model.logdensity_and_gradient
    assert isinstance(_kernel_objective(args["obj"], args["value_and_grad_fn"], args["x0s"]),
                      TracedObjective)
    res = qt.optimize_batched_resident(tol=1e-6, **args)
    plain = qt.optimize_batched_fused(tol=1e-6, kernel="torch", **args)
    for name in ("status", "iterations", "n_fev", "n_gev", "n_resets"):
        assert torch.equal(getattr(res, name), getattr(plain, name)), name
    assert torch.equal(res.x, plain.x)


@pytest.mark.parametrize("case, match", [
    ("a prior with float32 scales and float64 points", r"float32"),
    ("a quadratic with a data-dependent shape", r"data-dependent shape"),
])
def test_untraceable_data_bearing_objectives_are_refused(case, match):
    scales32 = torch.ones(4, dtype=torch.float32)
    Q = torch.eye(4, dtype=torch.float64)
    obj = {
        "a prior with float32 scales and float64 points": lambda w: -torch.sum(w * w * scales32),
        "a quadratic with a data-dependent shape": lambda x: -0.5 * (x @ (Q @ x))[x > 0].sum(),
    }[case]
    with pytest.raises(ValueError, match=match + ".*optimize_batched_fused"):
        qt.optimize_batched_resident(obj, torch.zeros((3, 4), dtype=torch.float64))


def test_kernel_objective_names():
    assert objective_name(None) == "rosenbrock"
    assert objective_name(IllConditionedQuadratic(3)) == "quadratic"
    assert objective_name(LogisticRegressionMAP(3, 5)) == "logistic"
    with pytest.raises(ValueError, match="no instantiation"):
        objective_name(rosenbrock_logdensity)


@pytest.mark.parametrize(
    "n, itemsize, objective, feasible",
    [
        (236, 4, "quadratic", True), (237, 4, "quadratic", False),
        (165, 8, "quadratic", True), (166, 8, "quadratic", False),
        (100, 4, "logistic", True), (235, 4, "logistic", True), (236, 4, "logistic", False),
        (165, 8, "logistic", True), (166, 8, "logistic", False),
    ],
)
def test_resident_feasible_counts_each_objectives_shared_memory(n, itemsize, objective, feasible):
    """csrc/resident_solve.cu :: smem_bytes with the objective's own
    scratch (csrc/resident_objectives.cuh :: extra_values): none for the
    quadratic, the point and one chunk of residuals (n + 32 per warp) for
    the logistic, against the 232,448 bytes a Hopper block may opt into."""
    model = IllConditionedQuadratic(3) if objective == "quadratic" else LogisticRegressionMAP(3, 5)
    assert qt.resident_feasible(n, itemsize, model) is feasible
    assert qt.resident_feasible(n, itemsize) is (n <= {4: 236, 8: 165}[itemsize])


def test_fleet_engine_runs_the_logistic_with_tf32_off(rng):
    """The first matmul objective on the card: under the fleet engine's
    torch.func.vmap the objective still runs with both TF32 switches off,
    and they are restored afterwards."""
    seen = []

    class Probe(LogisticRegressionMAP):
        def logdensity(self, w):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return super().logdensity(w)

    model = Probe(5, 20, seed=2)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        res = qt.optimize_batched(model, torch.tensor(rng.standard_normal((3, 5))),
                                  max_iterations=3)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    assert seen and set(seen) == {(False, False)}
    assert (res.iterations == 3).all()
