"""The ops the trace of B3's objective takes beyond phase 22's and 23's
(ops/kernels/objective_trace.py, objective_codegen.py), on the CPU.

For each group of ops (comparisons and masks; the elementwise functions
abs, sgn, sqrt, sin, cos, softplus, maximum, minimum, clamp and the view
transpose; mean and the 2-norm; per lane the Cholesky factorization, tril,
the triangular solve, and LU's slogdet, logdet and solve) at least one
objective uses each op, and the IR's evaluator is held to
``torch.func.grad_and_value`` of the objective and to JAX's
``jax.value_and_grad`` of its jnp twin, on the same numpy inputs in float64
to 1e-12 (the three sum and factorize in other orders). One stated
exception: torch's softplus returns x itself where x·beta passes its
threshold (20), while ``jax.nn.softplus`` adds log1p(exp(-x)) there; at
those points the value and gradient are held to that term, e^-20 ~ 2.1e-9
per element. The generated text of each group names its device code, the
text of every objective that traced before these ops did is pinned byte
for byte, and the objectives that read a factorization's pivots or info, a
norm of another ord and a matrix too large for one block are refused. The
LU objectives built to pivot (one here, one of chip_smoke.py's parity
cases) swap rows on every column but the last. The kernel itself runs
only on the card (tests/test_torch_kernels_cuda.py).
"""

import hashlib
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu_torch.api import as_value_and_grad, as_value_fn
from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_codegen import generate
from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_trace import (
    Graph,
    _make_graph,
    evaluate,
    graph_ops,
    in_band_linalg,
    lane_fits,
    trace_objective,
)
from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import resident_feasible

torch.set_num_threads(1)


def gp_data(rng, m):
    """m points in the plane, their squared distances, and noisy targets."""
    P = rng.uniform(-2.0, 2.0, (m, 2))
    d2 = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1)
    return d2, np.sin(P[:, 0]) + 0.1 * rng.standard_normal(m)


def gp_twins(d2, y, form):
    """The Gaussian-process marginal likelihood of log amplitude, log
    lengthscale and log noise, with a N(0, 1) prior on each, written with
    a Cholesky factor and triangular solves, or with slogdet and solve."""
    m = len(y)
    d2t, yt, d2j, yj = torch.tensor(d2), torch.tensor(y), jnp.asarray(d2), jnp.asarray(y)

    def kt(th):
        return (torch.exp(th[0]) * torch.exp(-0.5 * d2t * torch.exp(-2.0 * th[1]))
                + (torch.exp(th[2]) + 1e-6) * torch.eye(m, dtype=th.dtype))

    def kj(th):
        return (jnp.exp(th[0]) * jnp.exp(-0.5 * d2j * jnp.exp(-2.0 * th[1]))
                + (jnp.exp(th[2]) + 1e-6) * jnp.eye(m))

    if form == "cholesky":
        def port(th):
            L = torch.linalg.cholesky(kt(th))
            a = torch.linalg.solve_triangular(L, yt[:, None], upper=False)
            return -0.5 * torch.sum(a * a) - torch.sum(torch.log(torch.diagonal(L))) \
                - 0.5 * torch.sum(th * th)

        def ref(th):
            L = jnp.linalg.cholesky(kj(th))
            a = jsl.solve_triangular(L, yj, lower=True)
            return -0.5 * a @ a - jnp.sum(jnp.log(jnp.diagonal(L))) - 0.5 * th @ th
    else:
        def port(th):
            K = kt(th)
            _, logdet = torch.linalg.slogdet(K)
            return -0.5 * yt @ torch.linalg.solve(K, yt) - 0.5 * logdet - 0.5 * torch.sum(th * th)

        def ref(th):
            K = kj(th)
            _, logdet = jnp.linalg.slogdet(K)
            return -0.5 * yj @ jnp.linalg.solve(K, yj) - 0.5 * logdet - 0.5 * th @ th
    return port, ref


def pair(name, rng):
    """(port objective, JAX objective, n, the aten ops its trace must hold)."""
    t = torch.tensor
    n = 6
    if name == "comparisons and masks":
        c = rng.standard_normal(n)
        ct, cj = t(c), jnp.asarray(c)

        def port(x):
            inside = (x * x < 4.0) & (x > -1.5)
            upper = ~(x >= ct) | (x <= 1.2)
            either = torch.logical_and(x != 0.25, torch.logical_or(x == ct, x < ct))
            keep = torch.logical_not(x > ct) | ((x >= -3.0) & (x <= ct + 5.0) & (x != ct))
            v = torch.where(inside, -x * x, -0.5 * x ** 4) + torch.where(upper, 0.3 * x, -0.2 * x)
            v = v + torch.where(either, 0.1 * x * x, 0.0) + torch.where(keep, x * ct, 2.0 * x)
            return torch.sum(v.masked_fill(x > 2.5, -5.0)) - 0.05 * torch.sum(x * x)

        def ref(x):
            inside = (x * x < 4.0) & (x > -1.5)
            upper = ~(x >= cj) | (x <= 1.2)
            either = jnp.logical_and(x != 0.25, jnp.logical_or(x == cj, x < cj))
            keep = jnp.logical_not(x > cj) | ((x >= -3.0) & (x <= cj + 5.0) & (x != cj))
            v = jnp.where(inside, -x * x, -0.5 * x ** 4) + jnp.where(upper, 0.3 * x, -0.2 * x)
            v = v + jnp.where(either, 0.1 * x * x, 0.0) + jnp.where(keep, x * cj, 2.0 * x)
            return jnp.sum(jnp.where(x > 2.5, -5.0, v)) - 0.05 * jnp.sum(x * x)

        ops = {"lt.Scalar", "lt.Tensor", "gt.Scalar", "gt.Tensor", "ge.Scalar", "ge.Tensor",
               "le.Scalar", "le.Tensor", "eq.Tensor", "ne.Scalar", "ne.Tensor",
               "logical_and.default", "logical_or.default", "logical_not.default",
               "bitwise_and.Tensor", "bitwise_or.Tensor", "bitwise_not.default",
               "masked_fill.Scalar", "where.self"}
        return port, ref, n, ops
    if name == "the support boundary r2 < 4":  # the samplers' tests' ball, finite outside
        def port(x):
            r2 = torch.sum(x * x)
            return torch.where(r2 < 4.0, -0.5 * r2, -2.0 - (r2 - 4.0))

        def ref(x):
            r2 = jnp.sum(x * x)
            return jnp.where(r2 < 4.0, -0.5 * r2, -2.0 - (r2 - 4.0))

        return port, ref, n, {"lt.Scalar"}
    if name == "elementwise functions":
        c = rng.standard_normal(n)
        ct, cj = t(c), jnp.asarray(c)

        def port(x):
            M = x.reshape(2, 3).transpose(0, 1)  # (3, 2)
            v = torch.sqrt(1.0 + M * M) + torch.sin(M) - 0.3 * torch.abs(M - 0.1)
            w = torch.maximum(x, 0.5 * ct) + torch.minimum(x, ct - 1.0) \
                - torch.clamp(x, -0.8, 0.9) + 0.2 * torch.clamp(x, min=-0.5) \
                - 0.1 * torch.clamp(x, max=0.4)
            s = torch.nn.functional.softplus(x) + 0.5 * torch.nn.functional.softplus(
                x - ct, beta=2.0, threshold=10.0)
            return -torch.sum(v * v) - torch.sum(w * w) - torch.sum(s)

        def ref(x):
            M = x.reshape(2, 3).T
            v = jnp.sqrt(1.0 + M * M) + jnp.sin(M) - 0.3 * jnp.abs(M - 0.1)
            w = jnp.maximum(x, 0.5 * cj) + jnp.minimum(x, cj - 1.0) - jnp.clip(x, -0.8, 0.9) \
                + 0.2 * jnp.clip(x, -0.5, None) - 0.1 * jnp.clip(x, None, 0.4)
            s = jax.nn.softplus(x) + 0.5 * jax.nn.softplus(2.0 * (x - cj)) / 2.0
            return -jnp.sum(v * v) - jnp.sum(w * w) - jnp.sum(s)

        ops = {"sqrt.default", "sin.default", "cos.default", "abs.default", "sgn.default",
               "maximum.default", "minimum.default", "clamp.default", "softplus.default",
               "softplus_backward.default", "transpose.int"}
        return port, ref, n, ops
    if name == "softplus above its threshold":
        def port(x):
            return -torch.sum(torch.nn.functional.softplus(x + 20.0) * (1.0 + 0.1 * x))

        def ref(x):
            return -jnp.sum(jax.nn.softplus(x + 20.0) * (1.0 + 0.1 * x))

        return port, ref, n, {"softplus.default", "softplus_backward.default"}
    if name == "mean and norms":
        A, y = rng.standard_normal((40, n)) / np.sqrt(n), rng.standard_normal(40)
        At, yt, Aj, yj = t(A), t(y), jnp.asarray(A), jnp.asarray(y)

        def port(w):  # pseudo-Huber regression through mean, norms of a vector and of rows
            r = yt - At @ w
            rows = torch.linalg.vector_norm(w.reshape(2, 3) - 0.5, dim=1)
            return -40.0 * torch.mean(torch.sqrt(1.0 + r * r) - 1.0) \
                - torch.linalg.norm(w - 1.0) - torch.sum(rows) \
                + torch.sum(torch.mean(w.reshape(3, 2), dim=0) ** 2) - 0.5 * torch.mean(w * w)

        def ref(w):
            r = yj - Aj @ w
            rows = jnp.linalg.norm(w.reshape(2, 3) - 0.5, axis=1)
            return -40.0 * jnp.mean(jnp.sqrt(1.0 + r * r) - 1.0) - jnp.linalg.norm(w - 1.0) \
                - jnp.sum(rows) + jnp.sum(jnp.mean(w.reshape(3, 2), axis=0) ** 2) \
                - 0.5 * jnp.mean(w * w)

        ops = {"mean.default", "mean.dim", "linalg_vector_norm.default", "div.Scalar"}
        return port, ref, n, ops
    if name.startswith("gp "):
        d2, y = gp_data(rng, 8)
        port, ref = gp_twins(d2, y, name.split()[1])
        ops = ({"linalg_cholesky_ex.default", "linalg_solve_triangular.default", "tril.default",
                "_linalg_check_errors.default"} if "cholesky" in name else
               {"_linalg_slogdet.default", "_linalg_solve_ex.default", "transpose.int"})
        return port, ref, 3, ops
    if name == "logdet":
        B = rng.standard_normal((5, 5))
        Bt, Bj = t(B), jnp.asarray(B)

        def port(x):
            K = Bt @ Bt.T / 5.0 + torch.diag(torch.exp(x[:5]))
            return -0.5 * torch.logdet(K) - 0.5 * torch.sum(x * x)

        def ref(x):
            K = Bj @ Bj.T / 5.0 + jnp.diag(jnp.exp(x[:5]))
            return -0.5 * jnp.linalg.slogdet(K)[1] - 0.5 * x @ x

        return port, ref, 5, {"_linalg_slogdet.default"}
    if name == "triangular solves":  # upper, right side, unit diagonal, matrix right-hand sides
        B, C = rng.standard_normal((4, 3)), rng.standard_normal((2, 4))
        Bt, Ct, Bj, Cj = t(B), t(C), jnp.asarray(B), jnp.asarray(C)

        def port(x):
            M = x.reshape(4, 4)
            L = torch.tril(M, -1) + torch.diag(2.0 + torch.exp(torch.diagonal(M)))
            a = torch.linalg.solve_triangular(L.mT, Bt, upper=True)
            b = torch.linalg.solve_triangular(L, Ct, upper=False, left=False)
            c = torch.linalg.solve_triangular(L, Bt, upper=False, unitriangular=True)
            U, _ = torch.linalg.cholesky_ex(L @ L.mT + torch.eye(4, dtype=x.dtype), upper=True)
            return -torch.sum(a * a) - torch.sum(b * b) - 0.1 * torch.sum(c * c) \
                - 0.01 * torch.sum(U * U) - 0.5 * torch.sum(x * x)

        def ref(x):
            M = x.reshape(4, 4)
            L = jnp.tril(M, -1) + jnp.diag(2.0 + jnp.exp(jnp.diagonal(M)))
            a = jsl.solve_triangular(L.T, Bj, lower=False)
            b = jsl.solve_triangular(L.T, Cj.T, lower=False).T
            c = jsl.solve_triangular(L, Bj, lower=True, unit_diagonal=True)
            U = jnp.linalg.cholesky(L @ L.T + jnp.eye(4)).T
            return -jnp.sum(a * a) - jnp.sum(b * b) - 0.1 * jnp.sum(c * c) \
                - 0.01 * jnp.sum(U * U) - 0.5 * x @ x

        return port, ref, 16, {"linalg_solve_triangular.default", "linalg_cholesky_ex.default",
                               "tril.default"}
    if name == "solve with a matrix right-hand side":
        B = rng.standard_normal((4, 4))
        R = rng.standard_normal((4, 2))
        Bt, Rt, Bj, Rj = t(B), t(R), jnp.asarray(B), jnp.asarray(R)

        def port(x):
            K = Bt + torch.diag(3.0 + x[:4]) + x[4] * torch.ones(4, 4, dtype=x.dtype)
            X = torch.linalg.solve(K, Rt)
            return -torch.sum(X * X) - 0.5 * torch.sum(x * x)

        def ref(x):
            K = Bj + jnp.diag(3.0 + x[:4]) + x[4] * jnp.ones((4, 4))
            X = jnp.linalg.solve(K, Rj)
            return -jnp.sum(X * X) - 0.5 * x @ x

        return port, ref, 5, {"_linalg_solve_ex.default"}
    if name == "lu pivoting on most columns":  # rows shifted: column j's largest entry below
        m = 8
        M = np.diag(np.linspace(3.0, 5.0, m)) + 0.3 * rng.standard_normal((m, m)) / np.sqrt(m)
        A, y = np.roll(M, 1, axis=0), rng.standard_normal(m)
        At, yt, Aj, yj = t(A), t(y), jnp.asarray(A), jnp.asarray(y)

        def matrix(x):
            return At + torch.diag(x[:m]) + 0.1 * torch.outer(x[m:2 * m], x[2 * m:])

        def port(x):
            K = matrix(x)
            return -0.5 * torch.sum(x * x) - torch.linalg.slogdet(K)[1] \
                + 2.0 * (yt @ torch.linalg.solve(K, yt))
        port.matrix = matrix

        def ref(x):
            K = Aj + jnp.diag(x[:m]) + 0.1 * jnp.outer(x[m:2 * m], x[2 * m:])
            return -0.5 * x @ x - jnp.linalg.slogdet(K)[1] + 2.0 * (yj @ jnp.linalg.solve(K, yj))

        return port, ref, 3 * m, {"_linalg_slogdet.default", "_linalg_solve_ex.default"}
    raise AssertionError(name)


OBJECTIVES = ["comparisons and masks", "the support boundary r2 < 4", "elementwise functions",
              "mean and norms", "gp cholesky", "gp lu", "logdet", "triangular solves",
              "solve with a matrix right-hand side", "lu pivoting on most columns"]


def aten_ops(port, n) -> set:
    """The aten ops of the objective's value and value-and-gradient graphs
    (the trace's input), in-place forms as they are."""
    example = torch.zeros(n, dtype=torch.float64)
    found = set()
    for fn in (as_value_and_grad(port), as_value_fn(port)):
        graph = _make_graph(fn, example).graph
        found |= {str(node.target).replace("aten.", "") for node in graph.nodes
                  if node.op == "call_function"}
    return found


@pytest.mark.parametrize("name", [*OBJECTIVES, "softplus above its threshold"])
def test_ir_matches_torch_func_and_jax(rng, name):
    port, ref, n, ops = pair(name, rng)
    traced = trace_objective(port, None, torch.zeros((2, n), dtype=torch.float64))
    assert ops <= aten_ops(port, n), ops - aten_ops(port, n)
    jax_vag = jax.jit(jax.value_and_grad(ref))
    # softplus above its threshold: torch returns x, jax.nn.softplus adds log1p(exp(-x))
    slack = n * math.log1p(math.exp(-20.0)) * 1.5 if "threshold" in name else 0.0
    scale = 0.3 if name.startswith("gp") else 1.0
    for _ in range(3):
        x = rng.standard_normal(n) * scale
        value, grad = evaluate(traced.vag, torch.tensor(x), traced.consts, traced.tables)
        trial, none = evaluate(traced.val, torch.tensor(x), traced.consts, traced.tables)
        tvalue, tgrad = as_value_and_grad(port)(torch.tensor(x))
        jvalue, jgrad = jax_vag(jnp.asarray(x))
        assert none is None and grad.shape == (n,)
        for other, tol in ((float(tvalue), 1e-12), (float(jvalue), 1e-12 + slack)):
            np.testing.assert_allclose(float(value), other, rtol=1e-12, atol=tol)
            np.testing.assert_allclose(float(trial), other, rtol=1e-12, atol=tol)
        for other, tol in ((tgrad.numpy(), 1e-12), (np.asarray(jgrad), 1e-12 + slack)):
            np.testing.assert_allclose(grad.numpy(), other, rtol=1e-12, atol=tol)


def test_each_listed_op_traces():
    """Every op of the four groups is in some objective's trace above."""
    rng = np.random.default_rng(0)
    seen = set()
    for name in OBJECTIVES:
        port, _, n, _ = pair(name, rng)
        trace_objective(port, None, torch.zeros((2, n), dtype=torch.float64))
        seen |= aten_ops(port, n)
    want = {"lt.Scalar", "lt.Tensor", "le.Scalar", "le.Tensor", "ge.Scalar", "ge.Tensor",
            "eq.Tensor", "ne.Scalar", "ne.Tensor", "gt.Tensor", "logical_and.default",
            "logical_or.default", "logical_not.default", "masked_fill.Scalar", "abs.default",
            "sgn.default", "sqrt.default", "sin.default", "cos.default", "softplus.default",
            "softplus_backward.default", "maximum.default", "minimum.default", "clamp.default",
            "div.Scalar", "mean.default", "mean.dim", "linalg_vector_norm.default",
            "linalg_cholesky_ex.default", "tril.default", "linalg_solve_triangular.default",
            "_linalg_slogdet.default", "_linalg_solve_ex.default", "transpose.int",
            "_linalg_check_errors.default"}
    assert want <= seen, want - seen


def test_eq_scalar_and_masked_fill_backward_trace():
    """eq.Scalar and masked_fill_ (the 2-norm's backward, its in-place
    form through the out-of-place twin) and masked_fill.Tensor."""
    def port(x):
        return -torch.linalg.vector_norm(x) - torch.sum(x.masked_fill(x == 0.5, torch.tensor(1.0,
                                                                        dtype=x.dtype)) ** 2)

    traced = trace_objective(port, None, torch.zeros((2, 4), dtype=torch.float64))
    assert {"eq.Scalar", "masked_fill_.Scalar", "masked_fill.Tensor"} <= aten_ops(port, 4)
    x = torch.tensor([0.3, -0.7, 1.1, 0.2], dtype=torch.float64)
    value, grad = evaluate(traced.vag, x, traced.consts, traced.tables)
    tvalue, tgrad = as_value_and_grad(port)(x)
    torch.testing.assert_close(value, tvalue, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(grad, tgrad, rtol=1e-12, atol=1e-12)


GENERATED = {  # each group's device code in its unit
    "comparisons and masks": ("? Real(1) : Real(0)", " >= ", " <= ", " == ", " != ", " && ",
                              " || ", " == Real(0) ? Real(1) : Real(0)"),
    "elementwise functions": ("sqrt(", "sin(", "cos(", "fabs(", "Real((Real(0) <",
                              "traced_softplus(", "traced_softplus_backward(", "traced_maximum(",
                              "traced_minimum(", "traced_clamp("),
    "mean and norms": ("acc[0] * (Real(1) / Real(40))", "= sqrt(acc[0])", "+ i] = sqrt(acc);"),
    "gp cholesky": ("qnm::lane_cholesky(grp, 8,", "qnm::lane_trsm<false, false>(grp, 8, 1,",
                    "qnm::lane_trsm<true, false>(grp, 8,", "<= -1 ?", "<= 0 ?"),
    "gp lu": ("qnm::lane_slogdet(grp, 8,", "qnm::lane_solve(grp, 8, 1,",
              "qnm::lane_solve(grp, 8, 8,"),
    "triangular solves": ("qnm::lane_trsm<false, true>(grp, 4, 3,",),
}


@pytest.mark.parametrize("name", list(GENERATED))
def test_generated_text_names_the_ops(rng, name):
    port, _, n, _ = pair(name, rng)
    x0s = torch.zeros((3, n), dtype=torch.float64)
    text = generate(trace_objective(port, None, x0s))
    for piece in GENERATED[name]:
        assert piece in text, piece
    assert text == generate(trace_objective(pair(name, rng)[0], None, x0s))  # values aside
    helpers = ("traced_softplus", "traced_maximum", "traced_clamp")
    assert any(h in text for h in helpers) == (name == "elementwise functions")


def test_the_ops_count_in_the_graph(rng):
    """A Cholesky factorization counts m³/3, an LU factorization 2m³/3, a
    triangular solve m² per right-hand side, a solve through LU 2m³/3 + 2m²
    per right-hand side, a mean one per element and one, a 2-norm two per
    element and one."""
    m = 8
    for form, want in (("cholesky", m ** 3 // 3 + m * m),
                       ("lu", 2 * m ** 3 // 3 + 2 * m ** 3 // 3 + 2 * m * m)):
        d2, y = gp_data(rng, m)
        traced = trace_objective(gp_twins(d2, y, form)[0], None,
                                 torch.zeros((2, 3), dtype=torch.float64))
        linalg = [op for op in traced.val.ops if op.kind in ("chol", "trsm", "slogdet", "solve")]
        assert [op.kind for op in linalg] == (["chol", "trsm"] if form == "cholesky"
                                              else ["slogdet", "solve"])
        assert graph_ops(Graph(linalg, traced.val.value, None, 0)) == want
    traced = trace_objective(lambda x: -torch.mean(x) - torch.linalg.vector_norm(x), None,
                             torch.zeros((2, 5), dtype=torch.float64))
    assert graph_ops(traced.val) == (5 + 1) + (2 * 5 + 1) + 1 + 1  # the neg and the sub


def test_factorized_matrices_count_in_the_lanes_scratch(rng):
    """The Cholesky factor and LU's work copy take m² values of the lane's
    scratch each, so `resident_feasible` refuses a lane whose matrices do
    not fit one block before anything is built. At m = 64 one slot per op
    does not fit, and the trace reuses slots (`objective_trace._pack`) until
    it does; at m = 96 even reused slots do not."""
    for form in ("cholesky", "lu"):
        sizes = []
        for m in (8, 16):
            d2, y = gp_data(rng, m)
            traced = trace_objective(gp_twins(d2, y, form)[0], None,
                                     torch.zeros((2, 3), dtype=torch.float64))
            assert traced.factorizes
            sizes.append(traced.extra_values)
        assert sizes[1] - sizes[0] >= 4 * (16 * 16 - 8 * 8)  # several m x m slots
    d2, y = gp_data(rng, 64)
    packed = trace_objective(gp_twins(d2, y, "cholesky")[0], None,
                             torch.zeros((2, 3), dtype=torch.float64))
    assert not lane_fits(3, 8, packed.one_slot_values) and resident_feasible(3, 8, packed)
    d2, y = gp_data(rng, 96)
    big = trace_objective(gp_twins(d2, y, "cholesky")[0], None,
                          torch.zeros((2, 3), dtype=torch.float64))
    assert not resident_feasible(3, 8, big)
    assert resident_feasible(3, 8, trace_objective(gp_twins(*gp_data(rng, 8), "lu")[0], None,
                                                   torch.zeros((2, 3), dtype=torch.float64)))


def test_a_failed_factorization_is_nan_on_its_lane(rng):
    """JAX's cholesky gives NaN where its matrix is not positive definite;
    the evaluator does so too, and the plain version's torch runs do under
    `in_band_linalg`, lane by lane, instead of raising."""
    B = rng.standard_normal((4, 4))
    Bt, Bj = torch.tensor(B @ B.T / 4), jnp.asarray(B @ B.T / 4)

    def port(x):
        L = torch.linalg.cholesky(Bt + x[0] * torch.eye(4, dtype=x.dtype))
        return -torch.sum(torch.log(torch.diagonal(L))) - 0.5 * torch.sum(x * x)

    def ref(x):
        L = jnp.linalg.cholesky(Bj + x[0] * jnp.eye(4))
        return -jnp.sum(jnp.log(jnp.diagonal(L))) - 0.5 * x @ x

    traced = trace_objective(port, None, torch.zeros((2, 2), dtype=torch.float64))
    X = torch.tensor([[1.0, 0.5], [-40.0, 0.5]], dtype=torch.float64)
    for x, bad in zip(X, (False, True)):
        value, grad = evaluate(traced.vag, x, traced.consts, traced.tables)
        jvalue = float(ref(jnp.asarray(x.numpy())))
        assert math.isnan(float(value)) == bad == math.isnan(jvalue)
        assert bool(torch.isnan(grad).any()) == bad
    with pytest.raises(RuntimeError):
        torch.func.vmap(torch.func.grad_and_value(port))(X)
    with in_band_linalg():
        grads, values = torch.func.vmap(torch.func.grad_and_value(port))(X)
    assert math.isfinite(float(values[0])) and math.isnan(float(values[1]))
    np.testing.assert_allclose(float(values[0]), float(ref(jnp.asarray(X[0].numpy()))),
                               rtol=1e-12)


def test_the_pivoting_cases_swap_rows_on_most_columns(rng):
    """The LU objectives built to pivot (this file's, and chip_smoke.py's
    parity case of two warps, which the card holds to the plain version)
    swap rows on every column but the last at their starts, so that the
    kernel's pivot search, row swaps and barriers run on every column."""
    port, _, n, _ = pair("lu pivoting on most columns", rng)
    obj, _, starts = _chip_smoke().ops_case("lu pivoting across two warps", 70, torch.float64,
                                            torch.device("cpu"))
    cases = ([(port.matrix(x), n // 3) for x in torch.tensor(rng.standard_normal((8, n)))]
             + [(obj.matrix(x), 16) for x in torch.tensor(starts)])
    assert len(cases) == 8 + 64
    for K, size in cases:
        pivots = torch.linalg.lu_factor(K).pivots
        swaps = int((pivots != torch.arange(1, size + 1, dtype=pivots.dtype)).sum())
        assert swaps == size - 1, swaps


C3 = torch.eye(3, dtype=torch.float64)

# one objective per class the new ops refuse, and its message
UNTRACEABLE = {
    "a read pivot": (
        lambda x: -torch.sum(torch.ops.aten._linalg_slogdet(C3 + torch.diag(x))[3].to(x.dtype)
                             * x), r"pivots of a slogdet read by the objective"),
    "a read info": (
        lambda x: -torch.sum(torch.linalg.cholesky_ex(C3 + torch.diag(x)).info.to(x.dtype) * x),
        r"info of a Cholesky factorization read by the objective"),
    "a vector norm of ord 1": (lambda x: -torch.linalg.vector_norm(x, ord=1),
                               r"vector norm of ord 1 .*only ord 2"),
    "an over-large matrix": (
        lambda x: -torch.logdet(torch.eye(200, dtype=x.dtype) * torch.exp(x[0])),
        r"matrix of m = 200 per lane .*shared memory"),
}


@pytest.mark.parametrize("case", list(UNTRACEABLE))
def test_new_untraceable_objectives_are_refused_naming_the_op(case):
    fn, match = UNTRACEABLE[case]
    with pytest.raises(ValueError, match=match) as info:
        trace_objective(fn, None, torch.zeros((2, 3), dtype=torch.float64))
    assert "optimize_batched_fused" in str(info.value)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# sha256 of the generated text of phase 22's and 23's objectives, joined
# (24 + 13 units), and of the trace tests' objectives in float64, as the
# generator wrote them before these ops joined the table
PHASE_22_23_TEXT = "a76546b52155b0e8363a971e69a42fdc22b03ee63e9335cf0e144bbb99d7853e"
TRACE_TESTS_TEXT = "8b69be65ee6b2dc1ab6aebb6fd4c8acd9c00c288229379d79df84de86451cee7"


def test_the_text_of_every_earlier_trace_is_unchanged():
    """The objectives that traced before these ops (chip_smoke.py's phases
    22 and 23, tests/test_torch_objective_trace.py's) generate the same
    CUDA byte for byte, so their builds and measured rows still hold."""
    import quasinewtonmethods_jl_tpu_torch as qt
    import test_torch_objective_trace as earlier

    cs = _chip_smoke()
    cpu = torch.device("cpu")
    texts = (cs.traced_objectives(qt, cpu)["sources"]
             + cs.hierarchical_objectives(qt, cpu)["sources"])
    assert hashlib.sha256("".join(texts).encode()).hexdigest() == PHASE_22_23_TEXT
    digest = hashlib.sha256()
    for name in earlier.OBJECTIVES:
        port, vgf, _, n = earlier.pair(name, np.random.default_rng(0))
        x0s = torch.zeros((2, n), dtype=torch.float64)
        digest.update(generate(trace_objective(port, vgf, x0s)).encode())
    assert digest.hexdigest() == TRACE_TESTS_TEXT
