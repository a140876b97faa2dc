"""The port's resident engine on the fixture families — Neal's funnel, the
Gaussian mixture, the Poisson GLM and the AR(1) state-space MAP — against
the JAX package's resident engine on the same numpy data in float64 on
the CPU, plus the dispatch guards and `resident_feasible` for them.

On CPU tensors `optimize_batched_resident` runs the kernel's plain
version, the fleet engine with the plain update on the same objective;
JAX's runs its resident kernel in interpret mode (its scan-bodied AR(1)
through the dot rewrite). As in tests/test_torch_resident_objectives.py,
statuses, iterations and n_resets must be equal, x within 1e-6 relative /
1e-9 absolute and fun within 1e-9 relative, at tol 1e-6; on the funnel,
whose trajectories are chaotic in the last bit (tests/test_torch_fixtures.py),
the statuses and the optimum. The forms of these models that B3's
hand-written instantiations do not take (a subclass, a bound method, a
lambda, a user value_and_grad_fn) run through the trace; objectives that
do not trace raise. The CUDA kernel is held to the plain version on the
card in tests/test_torch_kernels_cuda.py and chip_smoke.py's phases 21-22.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu.resident_solve import (
    optimize_batched_resident as jax_optimize_batched_resident,
)
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch import models as tm
from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import (
    _data_args,
    objective_name,
    objective_on,
    resident_bfgs_solve,
)
from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_trace import TracedObjective
from quasinewtonmethods_jl_tpu_torch.resident_solve import _kernel_objective
from test_torch_fixtures import COUNTERS, FIXTURES, fixture_pair

torch.set_num_threads(1)


@pytest.mark.parametrize("name", FIXTURES)
def test_resident_engine_on_fixtures_matches_jax(rng, name):
    port_obj, ref_obj, n = fixture_pair(name, rng)
    X0 = rng.standard_normal((8, n))
    before = resident_bfgs_solve.launches
    port = qt.optimize_batched_resident(port_obj, torch.tensor(X0), tol=1e-6)
    ref = jax_optimize_batched_resident(ref_obj, jnp.asarray(X0), tol=1e-6, block_batch=4,
                                        interpret=True)
    assert resident_bfgs_solve.launches == before  # CPU tensors: the plain version
    exact = ("status",) if name == "funnel" else ("status", "iterations", "n_resets")
    for name_ in exact:
        np.testing.assert_array_equal(getattr(port, name_).numpy(),
                                      np.asarray(getattr(ref, name_)), err_msg=name_)
    assert (port.status == qt.Status.CONVERGED).all()
    rtol, atol = (1e-6, 1e-6) if name == "funnel" else (1e-6, 1e-9)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=rtol, atol=atol)
    np.testing.assert_allclose(port.fun.numpy(), np.asarray(ref.fun), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", FIXTURES)
def test_resident_plain_version_is_the_fleet_engine_with_the_plain_update(rng, name):
    """kernel="torch" (and "auto" on CPU tensors) is exactly the fleet
    engine with the plain update on the same objective, its data moved to
    the fleet's dtype once."""
    port_obj, _, n = fixture_pair(name, rng)
    X0 = torch.tensor(rng.standard_normal((5, n)))
    fleet = qt.optimize_batched_fused(port_obj, X0, tol=1e-6, kernel="torch")
    for kernel in ("torch", "auto"):
        res = qt.optimize_batched_resident(port_obj, X0, tol=1e-6, kernel=kernel)
        for name_ in COUNTERS:
            assert torch.equal(getattr(res, name_), getattr(fleet, name_)), (kernel, name_)
        assert torch.equal(res.x, fleet.x) and torch.equal(res.state.B, fleet.state.B)


@pytest.mark.parametrize("name", ["mixture", "poisson", "ar1"])
def test_resident_engine_on_a_fixture_whose_data_lie_elsewhere(rng, name):
    """A model built in float32 serves a float64 solve: its data go to the
    solve's dtype once (`objective_on`), and the solve is that of the model
    built from the same float32 values in float64."""
    port_obj, _, n = fixture_pair(name, rng)
    attrs = {"mixture": ("means", "weights", "sigmas"), "poisson": ("X", "y"),
             "ar1": ("A", "ys")}[name]
    f32 = objective_on(port_obj, torch.zeros((1, n), dtype=torch.float32))
    f64 = objective_on(f32, torch.zeros((1, n), dtype=torch.float64))
    for attr in attrs:
        assert getattr(f32, attr).dtype == torch.float32
        assert getattr(f64, attr).dtype == torch.float64
    X0 = torch.tensor(rng.standard_normal((4, n)))
    a = qt.optimize_batched_resident(f32, X0, tol=1e-6)
    b = qt.optimize_batched_resident(f64, X0, tol=1e-6)
    assert a.x.dtype == torch.float64
    for name_ in COUNTERS:
        assert torch.equal(getattr(a, name_), getattr(b, name_)), name_
    assert torch.equal(a.x, b.x)


class SubclassedMixture(tm.GaussianMixture):
    pass


class SubclassedPoisson(tm.PoissonRegressionMAP):
    pass


class SubclassedAR1(tm.AR1DriftMAP):
    pass


def funnel_value_and_grad(theta):
    grad, value = torch.func.grad_and_value(tm.funnel_logdensity)(theta)
    return value, grad


# The seven forms B3 refused until it traced objectives: JAX's resident
# engine takes them, and so does the port's, through the trace (the
# hand-written instantiations keep exact types and identity).
@pytest.mark.parametrize("case", [
    "mixture subclass", "poisson subclass", "ar1 subclass", "mixture's bound logdensity",
    "funnel in a lambda", "funnel with value_and_grad_fn", "ar1 with value_and_grad_fn",
])
def test_resident_guards_for_the_fixtures(rng, case):
    """Each form runs through the traced route and equals the fleet engine
    with the plain update on the same functions."""
    mixture = tm.GaussianMixture(np.ones((2, 4)))
    args = {
        "mixture subclass": {"obj": SubclassedMixture(np.ones((2, 4)))},
        "poisson subclass": {"obj": SubclassedPoisson(4, 10, seed=1)},
        "ar1 subclass": {"obj": SubclassedAR1(4, 5)},
        "mixture's bound logdensity": {"obj": mixture.logdensity},
        "funnel in a lambda": {"obj": lambda th: tm.funnel_logdensity(th)},
        "funnel with value_and_grad_fn": {
            "obj": tm.funnel_logdensity, "value_and_grad_fn": funnel_value_and_grad},
        "ar1 with value_and_grad_fn": {
            "obj": tm.AR1DriftMAP(4, 5),
            "value_and_grad_fn": lambda th: (-(th * th).sum(), -2.0 * th)},
    }[case]
    args.setdefault("value_and_grad_fn", None)
    x0s = torch.tensor(rng.standard_normal((3, 4)))
    assert isinstance(_kernel_objective(args["obj"], args["value_and_grad_fn"], x0s),
                      TracedObjective)
    res = qt.optimize_batched_resident(x0s=x0s, tol=1e-6, **args)
    plain = qt.optimize_batched_fused(x0s=x0s, tol=1e-6, kernel="torch", **args)
    for name in COUNTERS:
        assert torch.equal(getattr(res, name), getattr(plain, name)), name
    assert torch.equal(res.x, plain.x)


class MixtureWithABessel(tm.GaussianMixture):
    def logdensity(self, x):
        return super().logdensity(x) + torch.sum(torch.special.i0(x))


@pytest.mark.parametrize("case, match", [
    ("a subclass with an op outside the table", r"aten\.i0"),
    ("a funnel that branches on its point", r"data-dependent branch"),
    ("an AR(1) that draws noise", r"random.*aten\.randn"),
])
def test_untraceable_fixture_forms_are_refused(case, match):
    ar1 = tm.AR1DriftMAP(4, 5)
    obj = {
        "a subclass with an op outside the table": MixtureWithABessel(np.ones((2, 4))),
        "a funnel that branches on its point": (
            lambda th: tm.funnel_logdensity(th) if th[0] > 0 else -th[0] * th[0]),
        "an AR(1) that draws noise": (
            lambda th: ar1.logdensity(th + 1e-3 * torch.randn(4, dtype=th.dtype))),
    }[case]
    x0s = torch.zeros((3, 4), dtype=torch.float64)
    for kernel in ("auto", "torch"):
        with pytest.raises(ValueError, match=match + ".*optimize_batched_fused"):
            qt.optimize_batched_resident(obj, x0s, kernel=kernel)


def test_kernel_objective_names_for_the_fixtures():
    assert objective_name(tm.funnel_logdensity) == "funnel"
    assert objective_name(tm.GaussianMixture(np.ones((2, 3)))) == "mixture"
    assert objective_name(tm.PoissonRegressionMAP(3, 5)) == "poisson"
    assert objective_name(tm.AR1DriftMAP(3, 4)) == "ar1"
    for other in (SubclassedAR1(3, 4), tm.GaussianMixture(np.ones((2, 3))).logdensity):
        with pytest.raises(ValueError, match="no instantiation"):
            objective_name(other)


def test_mixture_components_beyond_the_kernels_eight_are_refused():
    """The kernel sums the components' distances in one lane sum: a
    mixture of more than 8 components raises before any launch (the
    device check of its data passes here on the CPU)."""
    x0s = torch.zeros((2, 3), dtype=torch.float64)
    eight = objective_on(tm.GaussianMixture(np.ones((8, 3))), x0s)
    assert _data_args("mixture", eight, x0s)[-1] == 8
    nine = objective_on(tm.GaussianMixture(np.ones((9, 3))), x0s)
    with pytest.raises(ValueError, match="at most 8 components"):
        _data_args("mixture", nine, x0s)


def test_ar1_data_arguments_carry_its_constants():
    x0s = torch.zeros((2, 5), dtype=torch.float64)
    model = objective_on(tm.AR1DriftMAP(5, 9, obs_scale=0.25, prior_scale=2.0), x0s)
    args = _data_args("ar1", model, x0s)
    assert args[2:] == [9, 0.5 / 0.25**2, 4.0]


# The edge of fit per objective, against the 232,448 bytes a Hopper block
# may opt into (csrc/resident_solve.cu :: smem_bytes = n² + 9n + 64 + the
# objective's own, csrc/resident_objectives.cuh :: extra_values): none for
# the funnel and the mixture (as the Rosenbrock: n <= 236 f32, 165 f64);
# the GLMs' point and residual chunk (n + 32 per warp: 235 f32, 165 f64);
# the AR(1)'s A, z_0..z_T and two adjoint buffers, n² + (T + 3)·n, which
# with T = 32 gives 2n² + 44n + 64 values: n <= 159 in f32, 109 in f64.
FEASIBLE_EDGES = [
    ("funnel", 4, 236), ("funnel", 8, 165), ("mixture", 4, 236), ("mixture", 8, 165),
    ("poisson", 4, 235), ("poisson", 8, 165), ("ar1", 4, 159), ("ar1", 8, 109),
]


@pytest.mark.parametrize("name, itemsize, largest", FEASIBLE_EDGES)
def test_resident_feasible_at_the_edge_of_fit(name, itemsize, largest):
    objective = {"funnel": tm.funnel_logdensity,
                 "mixture": tm.GaussianMixture(np.ones((8, 3))),
                 "poisson": tm.PoissonRegressionMAP(3, 5),
                 "ar1": tm.AR1DriftMAP(3, 32)}[name]
    assert qt.resident_feasible(largest, itemsize, objective)
    assert not qt.resident_feasible(largest + 1, itemsize, objective)


def test_ar1_fit_depends_on_its_number_of_steps():
    assert qt.resident_feasible(8, 8, tm.AR1DriftMAP(8, 32))
    # at n = 8 in f64, 2·64 + 9·8 + 64 + (T + 3)·8 values of the 29,056 a
    # block may hold: up to T = 3596 steps
    T = (232_448 // 8 - (2 * 64 + 9 * 8 + 64 + 3 * 8)) // 8
    assert T == 3596
    assert qt.resident_feasible(8, 8, tm.AR1DriftMAP(8, 2, ys=np.zeros((T, 8)), A=np.eye(8)))
    assert not qt.resident_feasible(8, 8, tm.AR1DriftMAP(8, 2, ys=np.zeros((T + 1, 8)),
                                                         A=np.eye(8)))
