"""The trace of a torch objective for the resident kernel B3
(ops/kernels/objective_trace.py) and its generated CUDA text
(ops/kernels/objective_codegen.py), on the CPU.

The IR's evaluator, the plain version of the generated evaluation, is held
to ``torch.func.grad_and_value`` of the objective and to JAX's
``jax.value_and_grad`` of its jnp twin, on the same numpy inputs in float64
to 1e-12 (the three sum in other orders), for every objective
chip_smoke.py's phases 22 and 23 run and every model of the port, the
transforms (transforms.py) and the hierarchical model among them: each op
the transforms add to the table (tanh, log1p, sigmoid and their
backwards; the views diagonal, permute and flip; cumsum; diag_embed,
diagonal_backward and new_zeros; the gathers and puts of constant
indices, with and without accumulate) in at least one objective. Each
class of objective that does not trace is refused with a ValueError that
names its op. The generated text depends on the graph, the shapes and the dtype, not
on the constants' values. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu import models as jm
from quasinewtonmethods_jl_tpu import transforms as jt
from quasinewtonmethods_jl_tpu_torch import models as tm
from quasinewtonmethods_jl_tpu_torch import transforms as tt
from quasinewtonmethods_jl_tpu_torch.api import as_value_and_grad
from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_codegen import generate
from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_trace import (
    evaluate,
    graph_ops,
    trace_objective,
)

torch.set_num_threads(1)


def dense_quadratic_data(rng, n):
    """ROADMAP B.1's dense quadratic form: Q = U diag(logspace(-4, 0, n)) Uᵀ
    (config 2's spectrum), U from a QR, b = Q x* for x* ~ N(0, 1)."""
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Q = (U * np.logspace(-4.0, 0.0, n)) @ U.T
    return Q, Q @ rng.standard_normal(n)


def pair(name, rng):
    """(port objective, port value_and_grad_fn, JAX objective, n) on one
    numpy dataset."""
    n = 6
    t = torch.tensor
    if name in ("quadratic with b", "dense quadratic"):
        if name == "dense quadratic":
            Q, b = dense_quadratic_data(rng, n)
        else:
            A = rng.standard_normal((n, n))
            Q, b = A @ A.T / n + np.eye(n), rng.standard_normal(n)
        Qt, bt, Qj, bj = t(Q), t(b), jnp.asarray(Q), jnp.asarray(b)
        return (lambda x: -0.5 * x @ (Qt @ x) + bt @ x, None,
                lambda x: -0.5 * x @ (Qj @ x) + bj @ x, n)
    if name == "logsumexp":
        c = rng.standard_normal(n)
        ct, cj = t(c), jnp.asarray(c)
        return (lambda x: -torch.logsumexp(x * x + ct, 0) - 0.01 * torch.sum(x * x), None,
                lambda x: -jax.nn.logsumexp(x * x + cj) - 0.01 * jnp.sum(x * x), n)
    if name == "nan where":
        return (lambda x: torch.where(torch.sum(x * x) > 9.0, torch.nan, -torch.sum(x * x)), None,
                lambda x: jnp.where(jnp.sum(x * x) > 9.0, jnp.nan, -jnp.sum(x * x)), n)
    if name == "logistic with logaddexp":
        A, y = rng.standard_normal((64, n)), (rng.random(64) < 0.5).astype(np.float64)
        At, yt, Aj, yj = t(A), t(y), jnp.asarray(A), jnp.asarray(y)
        zero = t(0.0, dtype=torch.float64)

        def port(w):
            z = At @ w
            return torch.sum(yt * z - torch.logaddexp(zero, z)) - 0.5 * torch.sum(w * w)

        def ref(w):
            z = Aj @ w
            return jnp.sum(yj * z - jnp.logaddexp(0.0, z)) - 0.5 * jnp.sum(w * w)

        return port, None, ref, n
    if name == "rosenbrock in a lambda":
        return (lambda x: tm.rosenbrock_logdensity(x), None, jm.rosenbrock_logdensity, n)
    if name == "rosenbrock with its value_and_grad_fn":  # torch.cat of the pieces, n odd
        return (lambda x: tm.rosenbrock_logdensity(x), tm.rosenbrock_value_and_grad,
                jm.rosenbrock_logdensity, 7)
    if name == "quadratic form x @ Q @ x":  # matmul: unsqueeze, mm and its own squeeze_
        A = rng.standard_normal((n, n))
        Q = A @ A.T + n * np.eye(n)
        Qt, Qj = t(Q), jnp.asarray(Q)
        return lambda x: -0.5 * x @ Qt @ x, None, lambda x: -0.5 * x @ Qj @ x, n
    if name == "rosenbrock model":
        return tm.Rosenbrock(n), None, jm.rosenbrock_logdensity, n
    if name == "funnel in a lambda":
        return lambda th: tm.funnel_logdensity(th), None, jm.funnel_logdensity, 4
    if name == "funnel with value_and_grad_fn":
        return (tm.funnel_logdensity,
                lambda th: torch.func.grad_and_value(tm.funnel_logdensity)(th)[::-1],
                jm.funnel_logdensity, 4)
    if name.startswith("mixture"):
        means, weights, sigmas = 3.0 * rng.standard_normal((5, n)), rng.random(5) + 0.5, \
            1.0 + rng.random(5)
        port = tm.GaussianMixture(means, weights, sigmas)
        ref = jm.GaussianMixture(jnp.asarray(means), jnp.asarray(weights), jnp.asarray(sigmas))
        return (port.logdensity if "bound" in name else port), None, ref.logdensity, n
    if name.startswith("logistic"):
        X = rng.standard_normal((40, n)) / np.sqrt(n)
        y = (rng.random(40) < 0.5).astype(np.float64)
        port = tm.LogisticRegressionMAP(n, 40, prior_scale=3.0, X=X, y=y)
        ref = jm.LogisticRegressionMAP(n, 40, prior_scale=3.0)
        ref.X, ref.y = jnp.asarray(X), jnp.asarray(y)
        if "value_and_grad_fn" in name:
            return port, port.logdensity_and_gradient, ref.logdensity, n
        return (port.logdensity if "bound" in name else port), None, ref.logdensity, n
    if name == "poisson model":
        X = rng.standard_normal((30, n)) / np.sqrt(n)
        y = rng.poisson(np.exp(X @ (0.5 * rng.standard_normal(n)))).astype(np.float64)
        ref = jm.PoissonRegressionMAP(n, 30, prior_scale=3.0)
        ref.X, ref.y = jnp.asarray(X), jnp.asarray(y)
        return tm.PoissonRegressionMAP(n, 30, prior_scale=3.0, X=X, y=y), None, ref.logdensity, n
    if name.startswith("ar1"):
        ref = jm.AR1DriftMAP(5, 6, obs_scale=0.7, prior_scale=4.0)
        port = tm.AR1DriftMAP(5, 6, obs_scale=0.7, prior_scale=4.0, A=np.asarray(ref.A),
                              ys=np.asarray(ref.ys))
        return (port.logdensity if "bound" in name else port), None, ref.logdensity, 5
    if name == "ill-conditioned quadratic model":
        ref = jm.IllConditionedQuadratic(n, condition=1e3)
        port = tm.IllConditionedQuadratic(n, condition=1e3, x_star=np.asarray(ref.x_star))
        return port, None, ref.logdensity, n
    if name in TRANSFORMED:
        return transformed_pair(name, rng)
    if name == "tanh and log1p":
        c = rng.standard_normal(n)
        ct, cj = t(c), jnp.asarray(c)
        return (lambda x: torch.sum(ct * torch.tanh(x)) - torch.sum(torch.log1p(x * x)), None,
                lambda x: jnp.sum(cj * jnp.tanh(x)) - jnp.sum(jnp.log1p(x * x)), n)
    if name == "gather with repeats":  # its backward a put with accumulate
        idx, c = rng.integers(0, n, 40), rng.standard_normal(40)
        it, ct, ij, cj = torch.tensor(idx), t(c), jnp.asarray(idx), jnp.asarray(c)
        return (lambda x: -torch.sum((x[it] - ct) ** 2), None,
                lambda x: -jnp.sum((x[ij] - cj) ** 2), n)
    if name == "diag, permute and flip":
        A = rng.standard_normal((3, 2))
        At, Aj = t(A), jnp.asarray(A)

        def port(x):
            M = x.reshape(2, 3).permute(1, 0).flip(0)  # (3, 2)
            return -torch.sum((M - At) ** 2) - torch.sum(torch.diag(x[:3]) @ M)

        def ref(x):
            M = jnp.flip(x.reshape(2, 3).T, 0)
            return -jnp.sum((M - Aj) ** 2) - jnp.sum(jnp.diag(x[:3]) @ M)

        return port, None, ref, n
    raise AssertionError(name)


# transformed log-densities: (port transform, JAX transform, constrained log-density in both)
TRANSFORMED = {
    "interval transform": (lambda m: m.Interval(6, lo=-1.0, hi=3.0), "quadratic"),
    "simplex transform": (lambda m: m.Simplex(7), "dirichlet"),
    "ordered transform": (lambda m: m.Ordered(6), "quadratic"),
    "corr cholesky transform": (lambda m: m.CorrCholesky(4), "quadratic"),
    "cov cholesky transform": (lambda m: m.CovCholesky(3), "quadratic"),
    "hierarchical model q=2": None,
    "hierarchical model q=3": None,
}


def transformed_pair(name, rng):
    if name.startswith("hierarchical"):
        q = int(name[-1])
        ref = jm.HierarchicalRegression(n_groups=4, q=q, p=2, n_obs=40, seed=q)
        port = tm.HierarchicalRegression(
            n_groups=4, q=q, p=2, n_obs=40,
            **{k: np.asarray(getattr(ref, k)) for k in ("X", "Z", "group", "y")})
        return (tt.transform_objective(port, port.transform), None,
                jt.transform_objective(ref, ref.transform).logdensity, port.transform
                .unconstrained_size)
    make, kind = TRANSFORMED[name]
    port_t, ref_t = make(tt), make(jt)
    c = rng.standard_normal(port_t.constrained_size)
    if kind == "dirichlet":
        alpha = 1.0 + rng.random(port_t.constrained_size) * 3.0
        at, aj = torch.tensor(alpha), jnp.asarray(alpha)
        port_x, ref_x = (lambda x: torch.sum((at - 1.0) * torch.log(x)),
                         lambda x: jnp.sum((aj - 1.0) * jnp.log(x)))
    else:
        ct, cj = torch.tensor(c), jnp.asarray(c)
        port_x, ref_x = (lambda x: -0.5 * torch.sum((x - ct) ** 2),
                         lambda x: -0.5 * jnp.sum((x - cj) ** 2))
    return (tt.transform_objective(port_x, port_t), None,
            jt.transform_objective(ref_x, ref_t).logdensity, port_t.unconstrained_size)


OBJECTIVES = [
    "quadratic with b", "dense quadratic", "logsumexp", "nan where", "logistic with logaddexp",
    "quadratic form x @ Q @ x", "rosenbrock in a lambda", "rosenbrock with its value_and_grad_fn",
    "rosenbrock model", "funnel in a lambda",
    "funnel with value_and_grad_fn", "mixture's bound logdensity", "mixture model",
    "logistic's bound logdensity", "logistic model", "logistic with value_and_grad_fn",
    "poisson model", "ar1's bound logdensity", "ar1 model", "ill-conditioned quadratic model",
    "tanh and log1p", "gather with repeats", "diag, permute and flip", *TRANSFORMED,
]


@pytest.mark.parametrize("scale", [1.0, 3.0])
@pytest.mark.parametrize("name", OBJECTIVES)
def test_ir_matches_torch_func_and_jax(rng, name, scale):
    port, vgf, ref, n = pair(name, rng)
    x0s = torch.zeros((2, n), dtype=torch.float64)
    traced = trace_objective(port, vgf, x0s)
    for _ in range(2):
        x = rng.standard_normal(n) * scale
        value, grad = evaluate(traced.vag, torch.tensor(x), traced.consts, traced.tables)
        trial, none = evaluate(traced.val, torch.tensor(x), traced.consts, traced.tables)
        tvalue, tgrad = as_value_and_grad(port, vgf)(torch.tensor(x))
        jax_vag = jax.value_and_grad(ref)
        if name in TRANSFORMED:  # compiled once, not op by op
            jax_vag = jax.jit(jax_vag)
        jvalue, jgrad = jax_vag(jnp.asarray(x))
        assert none is None and grad.shape == (n,)
        for other in (float(tvalue), float(jvalue)):
            np.testing.assert_allclose(float(value), other, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(float(trial), other, rtol=1e-12, atol=1e-12)
        for other in (tgrad.numpy(), np.asarray(jgrad)):
            np.testing.assert_allclose(grad.numpy(), other, rtol=1e-12, atol=1e-12)


C32 = torch.ones(4, dtype=torch.float32)
I22 = torch.tensor([[0, 1], [2, 3]])

# one objective per class the table refuses, and the op its message names
UNTRACEABLE = {
    "an op outside the table": (lambda x: torch.special.i0(x).sum(), r"aten\.i0"),
    "a per-lane value of rank 4": (
        lambda x: -(x[:, None, None, None] * x[None, :, None, None] * x[None, None, :, None]).sum(),
        r"rank 4 \(aten\.unsqueeze"),
    "a data-dependent branch": (
        lambda x: -(x * x).sum() if x.sum() > 0 else -(x ** 4).sum(),
        r"data-dependent branch.*_local_scalar_dense"),
    ".item()": (lambda x: -(x * x).sum() * x[0].item(), r"_local_scalar_dense"),
    "a data-dependent shape": (lambda x: -(x[x > 0]).sum(), r"data-dependent shape.*aten\.index"),
    "a random op": (lambda x: -(x * x).sum() + torch.randn_like(x).sum(), r"random.*randn_like"),
    "an in-place write": (lambda x: -(x.mul_(2.0)).sum(), r"in-place.*aten\.mul_"),
    "a constant of another dtype": (lambda x: -(x * C32).sum(), r"float32.*aten\.mul"),
    "an index computed from the point": (
        lambda x: -(x[(x > 0).long()] ** 2).sum(), r"index computed from the point.*_to_copy"),
    "a scatter with non-constant indices": (
        lambda x: -(torch.zeros(4, dtype=x.dtype).index_put(((x > 0).long(),), x) ** 2).sum(),
        r"index computed from the point.*_to_copy"),
    "a boolean-mask index": (
        lambda x: -(torch.zeros(4, dtype=x.dtype).index_put((x > 0,), x) ** 2).sum(),
        r"boolean-mask index.*aten\.index_put"),
    "an index tensor of rank 2": (lambda x: -(x[I22] ** 2).sum(), r"rank 2.*aten\.index\.Tensor"),
}


@pytest.mark.parametrize("case", list(UNTRACEABLE))
def test_untraceable_objectives_are_refused_naming_the_op(case):
    fn, match = UNTRACEABLE[case]
    with pytest.raises(ValueError, match=match) as info:
        trace_objective(fn, None, torch.zeros((2, 4), dtype=torch.float64))
    message = str(info.value)
    assert "optimize_batched_fused" in message
    assert "test_torch_objective_trace.py" in message  # the user's line


def _quadratic(Q, b):
    return lambda x: -0.5 * x @ (Q @ x) + b @ x


def test_generated_text_depends_on_shapes_not_on_constant_values(rng):
    x0s = torch.zeros((3, 6), dtype=torch.float32)
    Q1, Q2 = (torch.tensor(rng.standard_normal((6, 6)), dtype=torch.float32) for _ in range(2))
    b1, b2 = (torch.tensor(rng.standard_normal(6), dtype=torch.float32) for _ in range(2))
    text = generate(trace_objective(_quadratic(Q1, b1), None, x0s))
    assert text == generate(trace_objective(_quadratic(Q1, b1), None, x0s))
    assert text == generate(trace_objective(_quadratic(Q2, b2), None, x0s))
    assert "qnm_traced_solve" in text and "using Real = float;" in text
    f64 = generate(trace_objective(_quadratic(Q1.double(), b1.double()), None, x0s.double()))
    assert f64 != text and "using Real = double;" in f64
    Q7, b7 = torch.ones((7, 7)), torch.ones(7)
    assert generate(trace_objective(_quadratic(Q7, b7), None, torch.zeros((3, 7)))) != text


@pytest.mark.parametrize("family", ["mixture", "hierarchical"])
def test_two_models_of_one_shape_share_their_text(rng, family):
    """Constants and index tables are kernel inputs: two datasets of one
    shape (the hierarchical model's groups included) share one build."""
    if family == "mixture":
        x0s = torch.zeros((3, 6), dtype=torch.float64)
        a, b = (tm.GaussianMixture(rng.standard_normal((4, 6)), sigmas=1.0 + rng.random(4))
                for _ in range(2))
        traced = [trace_objective(m.logdensity, None, x0s) for m in (a, b)]
        assert generate(traced[0]) == generate(traced[1])
        assert not torch.equal(traced[0].consts[0], traced[1].consts[0])
    else:
        a, b = (tm.HierarchicalRegression(n_groups=4, q=2, p=2, n_obs=30, seed=seed)
                for seed in (1, 2))
        x0s = torch.zeros((3, a.dimension - 1), dtype=torch.float64)
        traced = [trace_objective(tt.transform_objective(m, m.transform), None, x0s)
                  for m in (a, b)]
        assert not all(torch.equal(t, u) for t, u in zip(traced[0].tables, traced[1].tables))
        assert generate(traced[0]) == generate(traced[1])
        assert not all(torch.equal(c, d) for c, d in zip(traced[0].consts, traced[1].consts))


def test_constants_become_kernel_inputs_and_the_counts_follow_the_graph():
    n = 5
    Q, b = torch.ones((n, n), dtype=torch.float64), torch.arange(n, dtype=torch.float64)
    traced = trace_objective(_quadratic(Q, b), None, torch.zeros((2, n), dtype=torch.float64))
    assert any(c.data_ptr() == Q.data_ptr() for c in traced.consts)  # Q read in place
    assert traced.const_bytes == sum(c.numel() * 8 for c in traced.consts)
    # the trial value: x·(-0.5), Q x (2n² with its sums), two dots (2n each), the add
    assert graph_ops(traced.val) == n + 2 * n * n + 4 * n + 1
    assert traced.ops_vag > traced.ops_value
    assert traced.extra_values >= n + n  # the point and at least Q x


def test_the_new_ops_count_in_the_graph():
    """A cumsum counts one operation per element, a put with accumulate
    one per source, a gather none; the tables count in const_bytes."""
    n, idx = 5, torch.tensor([0, 1, 1, 4, 4, 4])
    traced = trace_objective(lambda x: -torch.sum(torch.cumsum(x, 0) * x[idx].sum()), None,
                             torch.zeros((2, n), dtype=torch.float64))
    kinds = [op.kind for op in traced.vag.ops]
    assert {"cumsum", "gather", "put"} <= set(kinds)
    # the trial value: the cumsum (n), the gather (0), its sum (6), the product (n), the sum
    # (n) and the negation (1)
    assert graph_ops(traced.val) == n + 6 + n + n + 1
    put = next(op for op in traced.vag.ops if op.kind == "put")
    assert put.params[2] and put.params[3] == len(idx)  # accumulate, over six sources
    assert traced.const_bytes == sum(t.numel() * 4 for t in traced.tables) + sum(
        c.numel() * 8 for c in traced.consts)


def test_generated_sources_are_named_by_text_headers_and_flags(monkeypatch):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels import _build

    a, b = _build._generated_digest("// one"), _build._generated_digest("// two")
    assert a != b and a == _build._generated_digest("// one")
    monkeypatch.setattr(_build, "GENERATED_FLAGS", (*_build.GENERATED_FLAGS, "-lineinfo"))
    assert _build._generated_digest("// one") != a


def test_a_trace_keeps_its_library(monkeypatch):
    """A trace solved again neither generates its text nor looks its
    library up: `traced_libraries` builds and loads it once per trace."""
    from types import SimpleNamespace

    from quasinewtonmethods_jl_tpu_torch.ops.kernels import resident_kernel

    calls = []

    def load_generated(*sources):
        calls.append(len(sources))
        return [SimpleNamespace(cdll=SimpleNamespace(qnm_traced_solve=SimpleNamespace(),
                                                     qnm_traced_occupancy=SimpleNamespace()))
                for _ in sources]

    monkeypatch.setattr(resident_kernel, "load_generated", load_generated)
    traced = trace_objective(lambda x: -torch.sum(x * x), None, torch.zeros((2, 5)))
    assert traced.library is None
    first = resident_kernel.traced_libraries(traced)[0]
    assert resident_kernel.traced_libraries(traced, traced) == [first, first]
    assert calls == [1, 0] and traced.library is first


def test_a_build_without_nvcc_raises(monkeypatch, tmp_path):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_generated("// a source no build has seen")
