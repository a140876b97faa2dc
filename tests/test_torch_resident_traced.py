"""The resident engine on objectives written inline: the port of the JAX
package's tests/test_resident.py:147-260, on the CPU.

JAX's resident kernel traces any jnp objective; the port's B3 runs any
objective whose value and gradient trace to its op table, generated as
CUDA (ops/kernels/objective_trace.py, objective_codegen.py). On CPU tensors
the port's `optimize_batched_resident` traces the objective all the same
(so an untraceable one raises here too) and runs the kernel's plain
version, the fleet engine with the plain update on the user's function;
JAX's runs its resident kernel in interpret mode with ``rewrite_dots=False``
on the jnp twin. Both start from the same numpy fleet: statuses and the
counters iterations, n_fev, n_gev and n_resets are equal, with floats at
the tolerances of the JAX tests (1e-12 for the trajectory identities; x
within 1e-6 relative / 1e-9 absolute and fun within 1e-9 relative for the
matvec objectives at tol 1e-6). The CUDA kernel is held to the plain
version on the card in tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.ops.linesearch import BackTracking as JaxBackTracking
from quasinewtonmethods_jl_tpu.resident_solve import (
    optimize_batched_resident as jax_optimize_batched_resident,
)
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity

torch.set_num_threads(1)

COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")


def assert_result_identical(port, ref, rtol=1e-12, atol=1e-12):
    """test_resident.py :: _assert_result_identical across the packages:
    counters, fresh and stall exact, floats to last-ulp reassociation."""
    for f in COUNTERS:
        assert np.array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f))), f
    for f in ("x", "fun", "grad"):
        np.testing.assert_allclose(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=rtol, atol=atol, equal_nan=True, err_msg=f)
    for f in ("fresh", "stall"):
        assert np.array_equal(getattr(port.state, f).numpy(), np.asarray(getattr(ref.state, f))), f
    for f in ("grad_old", "step", "B"):
        np.testing.assert_allclose(getattr(port.state, f).numpy(),
                                   np.asarray(getattr(ref.state, f)), rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=f)


def quadratic_twins(Q, b):
    Qt, bt, Qj, bj = torch.tensor(Q), torch.tensor(b), jnp.asarray(Q), jnp.asarray(b)
    return (lambda x: -0.5 * x @ (Qt @ x) + bt @ x,
            lambda x: -0.5 * x @ (Qj @ x) + bj @ x)


def rounding_decided(fn, X, **kw):
    """The lanes whose status a change of the start by one ulp, up or down,
    changes in the port's own run: there summation order decides the end."""
    base = qt.optimize_batched_resident(fn, torch.tensor(X), **kw).status
    lanes = torch.zeros_like(base, dtype=torch.bool)
    for direction in (np.inf, -np.inf):
        nudged = torch.tensor(np.nextafter(X, direction))
        lanes |= qt.optimize_batched_resident(fn, nudged, **kw).status != base
    return lanes.numpy()


def test_resident_data_closing_objective(rng):
    """test_resident.py:147-171: a quadratic form with a linear term, its Q
    and b closed over (JAX hoists them into kernel inputs, the port's trace
    makes them constants). The trajectories are identical to last-ulp over
    the first 8 iterations (later B, which 1/sᵀy scales up as the steps
    shrink, carries the two orders' last-bit differences above 1e-12, while
    x and the gradient stay within an ulp). At tol 1e-8 the solve ends on float64's floor
    (|f| ~ 1.3, so an increase below 3e-16 cannot be certified): where the
    lanes get there, JAX's and torch's orders of summation decide whether
    the last test finds max|g| below 1e-8 or one more line search fails.
    Over the whole solve every lane is identical but those whose status a
    one-ulp change of start flips in the port's own run (lane 2 of this
    fixture), and those end converged or in a line-search failure."""
    n = 6
    A = rng.standard_normal((n, n))
    port, ref = quadratic_twins(A @ A.T / n + np.eye(n), rng.standard_normal(n))
    X = rng.standard_normal((4, n))
    for cap in (5, 8):
        res = qt.optimize_batched_resident(port, torch.tensor(X), tol=1e-8, max_iterations=cap)
        jres = jax_optimize_batched_resident(ref, jnp.asarray(X), tol=1e-8, block_batch=4,
                                             interpret=True, rewrite_dots=False,
                                             max_iterations=cap)
        assert_result_identical(res, jres)
    res = qt.optimize_batched_resident(port, torch.tensor(X), tol=1e-8)
    jres = jax_optimize_batched_resident(ref, jnp.asarray(X), tol=1e-8, block_batch=4,
                                         interpret=True, rewrite_dots=False)
    decided = rounding_decided(port, X, tol=1e-8)
    same = ~decided
    assert same.sum() >= 3
    for f in COUNTERS:
        assert np.array_equal(getattr(res, f).numpy()[same], np.asarray(getattr(jres, f))[same]), f
    np.testing.assert_allclose(res.x.numpy()[same], np.asarray(jres.x)[same], rtol=1e-12,
                               atol=1e-12)
    ends = (int(qt.Status.CONVERGED), int(qt.Status.LINESEARCH_FAILURE))
    assert np.isin(res.status.numpy(), ends).all() and np.isin(np.asarray(jres.status), ends).all()
    assert bool(res.converged.numpy()[same].all())


def random_config(rng, trial):
    """test_resident.py:174-221's draws, in its order: (port objective, JAX
    objective, starts, options)."""
    n = int(rng.integers(2, 9))
    batch = int(rng.integers(2, 9))
    kind = ["rosen", "quad", "logsumexp", "nasty"][trial]
    if kind == "rosen":
        port, ref = rosenbrock_logdensity, jax_rosenbrock
    elif kind == "quad":
        A = rng.standard_normal((n, n))
        port, ref = quadratic_twins(A @ A.T / n + np.eye(n), rng.standard_normal(n))
    elif kind == "logsumexp":
        c = rng.standard_normal(n)
        ct, cj = torch.tensor(c), jnp.asarray(c)

        def port(x):
            return -torch.logsumexp(x * x + ct, 0) - 0.01 * torch.sum(x * x)

        def ref(x):
            return -jax.nn.logsumexp(x * x + cj) - 0.01 * jnp.sum(x * x)
    else:
        def port(x):
            return torch.where(torch.sum(x * x) > 9.0, torch.nan, -torch.sum(x * x))

        def ref(x):
            return jnp.where(jnp.sum(x * x) > 9.0, jnp.nan, -jnp.sum(x * x))
    order = int(rng.choice([2, 3]))
    h0 = bool(rng.choice([True, False]))
    X = rng.standard_normal((batch, n)) * rng.uniform(0.5, 3.0)
    max_iterations = int(rng.choice([5, 300]))
    return port, ref, X, dict(order=order, h0_scale=h0, max_iterations=max_iterations)


def test_resident_random_configs_trajectory_identity(rng):
    """test_resident.py:174-221: random objectives, widths, orders, h0
    scalings and caps; every counter exact, floats to last-ulp."""
    for trial in range(4):
        port, ref, X, kw = random_config(rng, trial)
        order = kw.pop("order")
        res = qt.optimize_batched_resident(port, torch.tensor(X), ls=qt.BackTracking(order=order),
                                           tol=1e-8, **kw)
        jres = jax_optimize_batched_resident(ref, jnp.asarray(X), ls=JaxBackTracking(order=order),
                                             tol=1e-8, block_batch=4, interpret=True,
                                             rewrite_dots=False, **kw)
        assert_result_identical(res, jres)


@pytest.mark.parametrize("kind", ["quad", "logistic"])
def test_resident_matvec_objectives(rng, kind):
    """test_resident.py:224-260: the quadratic form and the logistic MAP
    (BASELINE configs 2-3 written inline, with ``logaddexp``) at tol 1e-6;
    every lane converges."""
    n, batch = 8, 16
    Q = rng.standard_normal((n, n))
    Q = Q @ Q.T + n * np.eye(n)
    A = rng.standard_normal((64, n))
    y = (rng.random(64) < 0.5).astype(np.float64)
    X0 = rng.standard_normal((batch, n))
    if kind == "quad":
        Qt, Qj = torch.tensor(Q), jnp.asarray(Q)

        def port(x):
            return -0.5 * x @ Qt @ x

        def ref(x):
            return -0.5 * x @ Qj @ x
    else:
        At, yt, Aj, yj = torch.tensor(A), torch.tensor(y), jnp.asarray(A), jnp.asarray(y)
        zero = torch.tensor(0.0, dtype=torch.float64)

        def port(w):
            z = At @ w
            return torch.sum(yt * z - torch.logaddexp(zero, z)) - 0.5 * torch.sum(w * w)

        def ref(w):
            z = Aj @ w
            return jnp.sum(yj * z - jnp.logaddexp(0.0, z)) - 0.5 * jnp.sum(w * w)
    res = qt.optimize_batched_resident(port, torch.tensor(X0), tol=1e-6)
    jres = jax_optimize_batched_resident(ref, jnp.asarray(X0), tol=1e-6, block_batch=4,
                                         interpret=True, rewrite_dots=False)
    for f in COUNTERS:
        assert np.array_equal(getattr(res, f).numpy(), np.asarray(getattr(jres, f))), f
    assert bool(res.converged.all())
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(res.fun.numpy(), np.asarray(jres.fun), rtol=1e-9, atol=1e-12)


def test_untraceable_objective_raises_on_the_cpu_too():
    """JAX's resident engine raises where its objective does not lower;
    the port's raises where the trace does, whatever the device (here the
    plain version would have run it)."""
    with pytest.raises(ValueError, match=r"aten\.i0.*optimize_batched_fused"):
        qt.optimize_batched_resident(lambda x: torch.special.i0(x).sum(),
                                     torch.zeros((3, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match=r"aten\.i0"):
        qt.optimize_batched_resident(lambda x: torch.special.i0(x).sum(),
                                     torch.zeros((3, 4), dtype=torch.float64), kernel="torch")


def test_the_entry_point_keeps_its_traces(monkeypatch):
    """The counterpart of JAX's jit cache: a second call with the same
    function or bound method traces nothing; a new lambda, another n or
    another dtype traces again, and `trace_objective`'s own result is
    never traced."""
    from quasinewtonmethods_jl_tpu_torch import resident_solve

    traces = []

    def counted(*args):
        traces.append(args[0])
        return qt.trace_objective(*args)

    monkeypatch.setattr(resident_solve, "trace_objective", counted)
    monkeypatch.setattr(resident_solve, "_TRACES", type(resident_solve._TRACES)())
    model = qt.models.GaussianMixture(np.eye(3), sigmas=1.0)  # traced as its bound method
    X = torch.zeros((2, 3), dtype=torch.float64)

    def solve(obj, x0s=X):
        return qt.optimize_batched_resident(obj, x0s, tol=1e-6, max_iterations=3)

    def quad(x):
        return -torch.sum(x * x)

    for obj in (quad, model.logdensity, qt.transform_objective(quad, qt.transforms.Positive(3))):
        before = len(traces)
        first = solve(obj)
        again = solve(obj)
        assert len(traces) == before + 1, obj  # one trace, then none
        assert torch.equal(first.x, again.x)
    assert len(traces) == 3
    solve(lambda x: -torch.sum(x * x))
    solve(lambda x: -torch.sum(x * x))
    assert len(traces) == 5  # a new lambda each call
    solve(quad, torch.zeros((2, 4), dtype=torch.float64))
    solve(quad, X.float())
    assert len(traces) == 7  # another n, another dtype
    solve(quad)
    solve(qt.trace_objective(quad, None, X))
    assert len(traces) == 7
    monkeypatch.setattr(resident_solve, "TRACE_CACHE_SIZE", 2)
    solve(lambda x: -torch.sum(x ** 4))
    assert len(resident_solve._TRACES) == 2  # the oldest dropped


@pytest.mark.parametrize("change", ["reassigned", "written_in_place"])
def test_a_kept_trace_follows_its_objectives_data(monkeypatch, change):
    """A model's data changed between two calls, by a new tensor or in
    place, is traced again, so that the kept trace (what B3 evaluates)
    computes what the live objective (what the plain version evaluates)
    does; an unchanged model traces nothing."""
    from quasinewtonmethods_jl_tpu_torch import resident_solve
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_trace import evaluate

    traces = []

    def counted(*args):
        traces.append(args[0])
        return qt.trace_objective(*args)

    monkeypatch.setattr(resident_solve, "trace_objective", counted)
    monkeypatch.setattr(resident_solve, "_TRACES", type(resident_solve._TRACES)())
    model = qt.models.HierarchicalRegression(n_groups=3, q=2, p=2, n_obs=16, seed=1)
    obj = qt.transform_objective(model, model.transform)
    rng = np.random.default_rng(5)
    X = torch.tensor(rng.normal(size=(2, obj.dimension)))

    def solve_and_check():
        qt.optimize_batched_resident(obj, X, tol=1e-6, max_iterations=3)
        ((traced, _),) = resident_solve._TRACES.values()
        for z in X:
            value, grad = evaluate(traced.vag, z, traced.consts, traced.tables)
            want, want_grad = obj.logdensity_and_gradient(z)
            torch.testing.assert_close(value, want, rtol=1e-12, atol=1e-12)
            torch.testing.assert_close(grad, want_grad, rtol=1e-12, atol=1e-12)

    solve_and_check()
    solve_and_check()
    assert len(traces) == 1
    if change == "reassigned":
        model.y = model.y + 1.0
    else:
        model.y.mul_(2.0)
    solve_and_check()
    assert len(traces) == 2
    solve_and_check()
    assert len(traces) == 2
