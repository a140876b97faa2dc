"""The ops the trace of B3's objective takes for the log-densities of
torch.distributions (ops/kernels/objective_trace.py, objective_codegen.py),
on the CPU.

For each group of ops (the gamma family: lgamma, its backward digamma and
xlogy's three forms; the normal CDF family: erf, erfc, log_ndtr and ndtr;
expm1, reciprocal, rsqrt, atan2, pow with a tensor exponent or a literal
base, sub.Scalar; max, min, amax, amin, max.dim and min.dim; BCE with logits
and the casts) at least one objective uses each op, and the IR's evaluator
is held to ``torch.func.grad_and_value`` of the objective and to JAX's
``jax.value_and_grad`` of its jnp twin (``gammaln``, ``digamma``,
``xlogy``, ``erf``, ``erfc``, ``log_ndtr``, ``expm1``, ``arctan2``,
``lax.rsqrt``, ``jnp.max``, BCE as jnp.maximum(x, 0) - x·y + log1p(exp(-|x|)))
on the same numpy inputs in float64 to 1e-12. Each torch.distributions
family the port's users write (Student-t, negative binomial, Gamma, Beta,
Dirichlet, Poisson, binomial, Weibull, Uniform, Bernoulli with logits, the
normal CDF, and the families that traced before: normal, Cauchy, Laplace,
log-normal, exponential, half-normal, half-Cauchy) is held the same way to
its `jax.scipy.stats` twin (the Weibull, the log-normal and the half
families, which JAX lacks, to their densities written from JAX's). One op's formulas
differ between the packages: below -20 JAX's log_ndtr takes an asymptotic
series where torch's takes log(erfcx(-x/√2)/2) - x²/2, and the two differ
there by up to 2e-11 relative in the value and 4e-9 in the gradient; the
tail test holds them to 5e-11 and 1e-8, and the other tests keep log_ndtr's
arguments above -20. The generated text of each group names its device
code; the refusals (polygamma, a pos_weight, a cast to float16, the indices
of max.dim read, torch.cond, and torch.distributions' own validation) are
ValueErrors that point to optimize_batched_fused; a static Python loop is
held to JAX's fori_loop and scan; a trace whose one slot per op does not
fit a block reuses slots, and reused slots keep every value bit for bit. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py).
"""

import hashlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributions as D
from jax import lax
from jax.scipy import special as jsp
from jax.scipy import stats

import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.api import as_value_and_grad
from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_codegen import generate
from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_trace import (
    _pack,
    evaluate,
    graph_ops,
    lane_fits,
    trace_objective,
)
from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import resident_feasible
from test_torch_objective_ops import aten_ops

torch.set_num_threads(1)

F = torch.nn.functional


@pytest.fixture(autouse=True)
def no_validation():
    """torch.distributions' validation of its arguments is a data-dependent
    branch (the trace refuses it; see the refusal test), so the families here
    run without it, as they would for B3, and the default comes back after."""
    before = D.Distribution._validate_args
    D.Distribution.set_default_validate_args(False)
    yield
    D.Distribution.set_default_validate_args(before)


def jax_bce(z, y):
    """BCE with logits written in jnp."""
    return jnp.maximum(z, 0.0) - z * y + jnp.log1p(jnp.exp(-jnp.abs(z)))


def pair(name, rng):
    """(port objective, JAX objective, n, the aten ops its trace must hold)."""
    t = torch.tensor
    n = 6
    if name == "gamma family":
        c = np.abs(rng.standard_normal(n)) + 0.5
        ct, cj = t(c), jnp.asarray(c)

        def port(x):
            a = torch.exp(0.5 * x)
            return torch.sum(torch.xlogy(a - 1.0, ct) - ct - torch.lgamma(a)) \
                - 0.3 * torch.sum(torch.special.xlogy(2.0, 1.0 + x * x)) \
                - 0.1 * torch.sum(torch.xlogy(x * x, 3.0)) - 0.5 * torch.sum(x * x)

        def ref(x):
            a = jnp.exp(0.5 * x)
            return jnp.sum(jsp.xlogy(a - 1.0, cj) - cj - jsp.gammaln(a)) \
                - 0.3 * jnp.sum(jsp.xlogy(2.0, 1.0 + x * x)) \
                - 0.1 * jnp.sum(jsp.xlogy(x * x, 3.0)) - 0.5 * jnp.sum(x * x)

        ops = {"lgamma.default", "digamma.default", "xlogy.Tensor", "xlogy.Scalar_Self",
               "xlogy.Scalar_Other"}
        return port, ref, n, ops
    if name == "normal cdf":
        c = rng.standard_normal(n)
        ct, cj = t(c), jnp.asarray(c)

        def port(x):  # log_ndtr on both of its branches (below -1 and above)
            return torch.sum(torch.special.log_ndtr(2.0 * (x - ct))) \
                + 0.2 * torch.sum(torch.erf(0.5 * x)) - 0.1 * torch.sum(torch.erfc(x - ct)) \
                + torch.sum(torch.log(torch.special.ndtr(x + 2.0))) - 0.5 * torch.sum(x * x)

        def ref(x):
            return jnp.sum(jsp.log_ndtr(2.0 * (x - cj))) + 0.2 * jnp.sum(jsp.erf(0.5 * x)) \
                - 0.1 * jnp.sum(jsp.erfc(x - cj)) + jnp.sum(jnp.log(jsp.ndtr(x + 2.0))) \
                - 0.5 * jnp.sum(x * x)

        return port, ref, n, {"special_log_ndtr.default", "erf.default", "erfc.default"}
    if name == "elementwise functions":
        c, base = rng.standard_normal(n), 1.5 + rng.standard_normal(n) ** 2
        ct, cj, bt, bj = t(c), jnp.asarray(c), t(base), jnp.asarray(base)

        def port(x):
            return -0.1 * torch.sum(torch.expm1(0.5 * x)) \
                + 0.3 * torch.sum(torch.rsqrt(1.0 + x * x)) \
                + 0.2 * torch.sum(torch.reciprocal(2.0 + x * x)) \
                + 0.1 * torch.sum(torch.atan2(x, ct + 3.0)) - 0.1 * torch.sum(bt ** (0.2 * x)) \
                - 0.1 * torch.sum(2.0 ** (0.3 * x)) \
                - 0.05 * torch.sum((2.0 + x * x) ** (1.0 + 0.1 * x)) - 0.5 * torch.sum(x * x)

        def ref(x):
            return -0.1 * jnp.sum(jnp.expm1(0.5 * x)) + 0.3 * jnp.sum(lax.rsqrt(1.0 + x * x)) \
                + 0.2 * jnp.sum(jnp.reciprocal(2.0 + x * x)) \
                + 0.1 * jnp.sum(jnp.arctan2(x, cj + 3.0)) - 0.1 * jnp.sum(bj ** (0.2 * x)) \
                - 0.1 * jnp.sum(2.0 ** (0.3 * x)) \
                - 0.05 * jnp.sum((2.0 + x * x) ** (1.0 + 0.1 * x)) - 0.5 * jnp.sum(x * x)

        ops = {"expm1.default", "rsqrt.default", "reciprocal.default", "atan2.default",
               "pow.Tensor_Tensor", "pow.Scalar", "sub.Scalar"}
        return port, ref, n, ops
    if name == "max and min":
        lift = np.zeros(n)
        lift[2] = 3.0

        def port(x):
            M, lt = x.reshape(2, 3), t(lift)
            return 0.3 * torch.max(x) - 0.2 * torch.min(x - lt) + 0.1 * torch.amax(x + lt) \
                - 0.1 * torch.amin(x) + 0.2 * torch.sum(torch.amax(M, dim=1)) \
                + 0.1 * torch.sum(torch.max(M, 1).values) - 0.1 * torch.sum(torch.min(M, 0)[0]) \
                + 0.1 * torch.sum(torch.max(M, 0, keepdim=True).values) - 0.5 * torch.sum(x * x)

        def ref(x):
            M, lj = x.reshape(2, 3), jnp.asarray(lift)
            return 0.3 * jnp.max(x) - 0.2 * jnp.min(x - lj) + 0.1 * jnp.max(x + lj) \
                - 0.1 * jnp.min(x) + 0.2 * jnp.sum(jnp.max(M, axis=1)) \
                + 0.1 * jnp.sum(jnp.max(M, axis=1)) - 0.1 * jnp.sum(jnp.min(M, axis=0)) \
                + 0.1 * jnp.sum(jnp.max(M, axis=0)) - 0.5 * jnp.sum(x * x)

        ops = {"max.default", "min.default", "amax.default", "amin.default", "max.dim",
               "min.dim", "isnan.default", "logical_or_.default", "scatter.src"}
        return port, ref, n, ops
    if name == "losses and casts":
        Z, y = rng.standard_normal((10, n)), rng.integers(0, 2, 10).astype(np.float64)
        w, u = rng.uniform(0.5, 1.5, 10), rng.uniform(-0.5, 0.5, (3, 2))
        Zt, yt, wt, ut = t(Z), t(y), t(w), t(u)
        Zj, yj, wj, uj = (jnp.asarray(a) for a in (Z, y, w, u))

        def port(x):
            z = Zt @ x
            box = D.Uniform(-0.5 - torch.exp(x[:2]), 0.5 + torch.exp(x[2:4]))
            return -F.binary_cross_entropy_with_logits(z, yt, weight=wt, reduction="sum") \
                - 5.0 * F.binary_cross_entropy_with_logits(0.5 * z, yt) \
                - 0.1 * torch.sum(F.binary_cross_entropy_with_logits(z, yt, reduction="none")) \
                + box.log_prob(ut).sum() + 0.1 * torch.sum(x.clone() * Zt[0]) \
                - 0.5 * torch.sum(x * x)

        def ref(x):
            z = Zj @ x
            low, high = -0.5 - jnp.exp(x[:2]), 0.5 + jnp.exp(x[2:4])
            inside = ((uj >= low) & (uj < high)).astype(x.dtype)
            return -jnp.sum(wj * jax_bce(z, yj)) - 5.0 * jnp.mean(jax_bce(0.5 * z, yj)) \
                - 0.1 * jnp.sum(jax_bce(z, yj)) + jnp.sum(jnp.log(inside) - jnp.log(high - low)) \
                + 0.1 * jnp.sum(x * Zj[0]) - 0.5 * jnp.sum(x * x)

        ops = {"binary_cross_entropy_with_logits.default", "_to_copy.default", "clone.default",
               "clamp_min.default", "exp_.default", "log_.default", "add_.Tensor"}
        return port, ref, n, ops
    raise AssertionError(name)


OBJECTIVES = ["gamma family", "normal cdf", "elementwise functions", "max and min",
              "losses and casts"]


def check_twins(port, ref, n, points, rtol=1e-12, atol=1e-12, traced=None):
    """The evaluator's value and gradient, and its trial value, against
    torch.func's and JAX's at each point."""
    traced = traced or trace_objective(port, None, torch.zeros((2, n), dtype=torch.float64))
    jax_vag = jax.jit(jax.value_and_grad(ref))
    for x in points:
        value, grad = evaluate(traced.vag, torch.tensor(x), traced.consts, traced.tables)
        trial, none = evaluate(traced.val, torch.tensor(x), traced.consts, traced.tables)
        tvalue, tgrad = as_value_and_grad(port)(torch.tensor(x))
        jvalue, jgrad = jax_vag(jnp.asarray(x))
        assert none is None and grad.shape == (n,)
        for other in (float(tvalue), float(jvalue)):
            np.testing.assert_allclose(float(value), other, rtol=rtol, atol=atol)
            np.testing.assert_allclose(float(trial), other, rtol=rtol, atol=atol)
        for other in (tgrad.numpy(), np.asarray(jgrad)):
            np.testing.assert_allclose(grad.numpy(), other, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", OBJECTIVES)
def test_ir_matches_torch_func_and_jax(rng, name):
    port, ref, n, ops = pair(name, rng)
    assert ops <= aten_ops(port, n), ops - aten_ops(port, n)
    check_twins(port, ref, n, rng.standard_normal((3, n)))


def test_each_listed_op_traces():
    """Every op of the slice is in some objective's trace above."""
    rng = np.random.default_rng(0)
    seen = set()
    for name in OBJECTIVES:
        port, _, n, _ = pair(name, rng)
        trace_objective(port, None, torch.zeros((2, n), dtype=torch.float64))
        seen |= aten_ops(port, n)
    want = {"lgamma.default", "digamma.default", "xlogy.Tensor", "xlogy.Scalar_Self",
            "xlogy.Scalar_Other", "erf.default", "erfc.default", "special_log_ndtr.default",
            "expm1.default", "reciprocal.default", "rsqrt.default", "atan2.default",
            "pow.Tensor_Tensor", "pow.Scalar", "sub.Scalar", "max.default", "min.default",
            "amax.default", "amin.default", "max.dim", "min.dim", "isnan.default",
            "logical_or_.default", "binary_cross_entropy_with_logits.default",
            "_to_copy.default"}
    assert want <= seen, want - seen


def test_xlogy_and_nan_at_the_edges():
    """xlogy is 0 where x is 0 (y finite or not) and NaN where y is NaN; a
    max or min over a NaN is NaN, and its gradient is NaN, as torch's."""
    def port(x):
        return torch.sum(torch.xlogy(x[:2], x[2:4])) + torch.max(x[2:]) + torch.amin(x)

    traced = trace_objective(port, None, torch.zeros((2, 6), dtype=torch.float64))
    for x in ([0.0, 0.0, 0.0, 2.0, 1.0, 0.5], [0.0, 1.0, float("nan"), 2.0, 1.0, 0.5],
              [0.5, 1.0, 1.5, 2.0, float("nan"), 0.5]):
        value, grad = evaluate(traced.vag, torch.tensor(x), traced.consts, traced.tables)
        tvalue, tgrad = as_value_and_grad(port)(torch.tensor(x))
        torch.testing.assert_close(value, tvalue, equal_nan=True, rtol=1e-12, atol=0)
        torch.testing.assert_close(grad, tgrad, equal_nan=True, rtol=1e-12, atol=0)


def test_ties_share_the_gradient_as_torch_does():
    """max and amax share their gradient evenly among ties, max.dim gives it
    to the first extreme (torch's rules; JAX shares it in both)."""
    def port(x):
        M = x.reshape(2, 3)
        return torch.max(x) + torch.sum(torch.amax(M, dim=1)) + torch.sum(torch.max(M, 1).values)

    traced = trace_objective(port, None, torch.zeros((2, 6), dtype=torch.float64))
    x = torch.tensor([1.0, 2.0, 2.0, 0.5, 0.5, 0.5], dtype=torch.float64)
    value, grad = evaluate(traced.vag, x, traced.consts, traced.tables)
    tvalue, tgrad = as_value_and_grad(port)(x)
    torch.testing.assert_close(value, tvalue, rtol=0, atol=0)
    torch.testing.assert_close(grad, tgrad, rtol=0, atol=0)
    assert grad.tolist() == [0.0, 2.0, 1.0, 1.0 + 1.0 / 3.0, 1.0 / 3.0, 1.0 / 3.0]


def test_log_ndtr_far_in_the_tail():
    """Below -20 the packages' log_ndtr formulas differ (see the module
    docstring): the evaluator is torch's bit for bit, and JAX's within 5e-11
    in the value and 1e-8 in the gradient."""
    def port(x):
        return torch.sum(torch.special.log_ndtr(x - 25.0))

    def ref(x):
        return jnp.sum(jsp.log_ndtr(x - 25.0))

    x = np.array([-4.0, 0.5, 3.0, 4.5, 10.0, 24.0])
    traced = trace_objective(port, None, torch.zeros((2, 6), dtype=torch.float64))
    value, grad = evaluate(traced.vag, torch.tensor(x), traced.consts, traced.tables)
    trial, _ = evaluate(traced.val, torch.tensor(x), traced.consts, traced.tables)
    tvalue, tgrad = as_value_and_grad(port)(torch.tensor(x))
    assert float(value) == float(tvalue) == float(trial) and torch.equal(grad, tgrad)
    jvalue, jgrad = jax.value_and_grad(ref)(jnp.asarray(x))
    np.testing.assert_allclose(float(value), float(jvalue), rtol=5e-11)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-8)


def family(name, rng):
    """(port log-density, JAX's twin from jax.scipy.stats, n) of a
    torch.distributions family, its parameters from the point."""
    t = torch.tensor
    m = 12
    if name == "student t":  # df, loc, scale
        y = 0.5 + rng.standard_t(3, m)
        yt, yj = t(y), jnp.asarray(y)
        return (lambda x: D.StudentT(torch.exp(x[0]), x[1], torch.exp(x[2])).log_prob(yt).sum(),
                lambda x: jnp.sum(stats.t.logpdf(yj, jnp.exp(x[0]), x[1], jnp.exp(x[2]))), 3)
    if name == "negative binomial":  # total count, logits of a regression
        A, k = rng.standard_normal((m, 3)), rng.negative_binomial(4, 0.4, m).astype(float)
        At, kt, Aj, kj = t(A), t(k), jnp.asarray(A), jnp.asarray(k)
        return (lambda x: D.NegativeBinomial(torch.exp(x[0]), logits=At @ x[1:]).log_prob(kt)
                .sum(),
                lambda x: jnp.sum(stats.nbinom.logpmf(kj, jnp.exp(x[0]),
                                                      jax.nn.sigmoid(-(Aj @ x[1:])))), 4)
    if name == "gamma":
        g = rng.gamma(2.0, 0.7, (m, 2))
        gt, gj = t(g), jnp.asarray(g)
        return (lambda x: D.Gamma(torch.exp(x[:2]), torch.exp(x[2:])).log_prob(gt).sum(),
                lambda x: jnp.sum(stats.gamma.logpdf(gj, jnp.exp(x[:2]),
                                                     scale=jnp.exp(-x[2:]))), 4)
    if name == "beta":  # scalar parameters: torch's Beta stacks them into a Dirichlet
        b = rng.beta(2.0, 3.0, m)
        bt, bj = t(b), jnp.asarray(b)
        return (lambda x: D.Beta(torch.exp(x[0]), torch.exp(x[1])).log_prob(bt).sum(),
                lambda x: jnp.sum(stats.beta.logpdf(bj, jnp.exp(x[0]), jnp.exp(x[1]))), 2)
    if name == "dirichlet":
        p = rng.dirichlet(np.full(4, 2.0), m)
        pt, pj = t(p), jnp.asarray(p.T)
        return (lambda x: D.Dirichlet(torch.exp(x)).log_prob(pt).sum(),
                lambda x: jnp.sum(stats.dirichlet.logpdf(pj, jnp.exp(x))), 4)
    if name == "poisson":
        k = rng.poisson(3.0, (m, 3)).astype(float)
        kt, kj = t(k), jnp.asarray(k)
        return (lambda x: D.Poisson(torch.exp(x)).log_prob(kt).sum(),
                lambda x: jnp.sum(stats.poisson.logpmf(kj, jnp.exp(x))), 3)
    if name == "binomial":
        k = rng.binomial(5, 0.4, (m, 3)).astype(float)
        kt, kj = t(k), jnp.asarray(k)
        return (lambda x: D.Binomial(5, logits=x).log_prob(kt).sum(),
                lambda x: jnp.sum(stats.binom.logpmf(kj, 5, jax.nn.sigmoid(x))), 3)
    if name == "weibull":  # JAX has no Weibull: its density written out
        w = 2.0 * rng.weibull(1.5, (m, 2))
        wt, wj = t(w), jnp.asarray(w)

        def ref(x):
            scale, conc = jnp.exp(x[:2]), jnp.exp(x[2:])
            return jnp.sum(jnp.log(conc / scale) + (conc - 1.0) * jnp.log(wj / scale)
                           - (wj / scale) ** conc)
        return (lambda x: D.Weibull(torch.exp(x[:2]), torch.exp(x[2:])).log_prob(wt).sum(),
                ref, 4)
    if name == "uniform":
        u = rng.uniform(-0.5, 0.5, (m, 2))
        ut, uj = t(u), jnp.asarray(u)
        return (lambda x: D.Uniform(-0.5 - torch.exp(x[:2]), 0.5 + torch.exp(x[2:]))
                .log_prob(ut).sum() - 0.5 * torch.sum(x * x),
                lambda x: jnp.sum(stats.uniform.logpdf(uj, -0.5 - jnp.exp(x[:2]),
                                                       1.0 + jnp.exp(x[:2]) + jnp.exp(x[2:])))
                - 0.5 * jnp.sum(x * x), 4)
    if name == "bernoulli":
        A, c = rng.standard_normal((m, 3)), rng.integers(0, 2, m).astype(float)
        At, ct, Aj, cj = t(A), t(c), jnp.asarray(A), jnp.asarray(c)
        return (lambda x: D.Bernoulli(logits=At @ x).log_prob(ct).sum(),
                lambda x: jnp.sum(stats.bernoulli.logpmf(cj, jax.nn.sigmoid(Aj @ x))), 3)
    if name in ("normal", "cauchy", "laplace"):  # loc, log scale: the families that traced
        y = rng.standard_normal(m)                # before the slice
        yt, yj = t(y), jnp.asarray(y)
        port_family = {"normal": D.Normal, "cauchy": D.Cauchy, "laplace": D.Laplace}[name]
        ref_family = {"normal": stats.norm, "cauchy": stats.cauchy, "laplace": stats.laplace}[name]
        return (lambda x: port_family(x[0], torch.exp(x[1])).log_prob(yt).sum(),
                lambda x: jnp.sum(ref_family.logpdf(yj, x[0], jnp.exp(x[1]))), 2)
    if name in ("log normal", "exponential", "half normal", "half cauchy"):
        y = np.abs(rng.standard_normal(m)) + 0.1
        yt, yj = t(y), jnp.asarray(y)
        if name == "log normal":
            return (lambda x: D.LogNormal(x[0], torch.exp(x[1])).log_prob(yt).sum(),
                    lambda x: jnp.sum(stats.norm.logpdf(jnp.log(yj), x[0], jnp.exp(x[1]))
                                      - jnp.log(yj)), 2)
        if name == "exponential":
            return (lambda x: D.Exponential(torch.exp(x[0])).log_prob(yt).sum(),
                    lambda x: jnp.sum(stats.expon.logpdf(yj, scale=jnp.exp(-x[0]))), 1)
        half = {"half normal": (D.HalfNormal, stats.norm), "half cauchy": (D.HalfCauchy,
                                                                           stats.cauchy)}
        port_family, ref_family = half[name]  # JAX's folded: twice the density at y >= 0
        return (lambda x: port_family(torch.exp(x[0])).log_prob(yt).sum(),
                lambda x: jnp.sum(jnp.log(2.0) + ref_family.logpdf(yj, 0.0, jnp.exp(x[0]))), 1)
    if name == "probit":
        A, s = rng.standard_normal((m, 3)), np.where(rng.integers(0, 2, m) > 0, 1.0, -1.0)
        At, st, Aj, sj = t(A), t(s), jnp.asarray(A), jnp.asarray(s)
        return (lambda x: torch.sum(torch.special.log_ndtr(st * (At @ x))),
                lambda x: jnp.sum(stats.norm.logcdf(sj * (Aj @ x))), 3)
    raise AssertionError(name)


FAMILIES = ["student t", "negative binomial", "gamma", "beta", "dirichlet", "poisson",
            "binomial", "weibull", "uniform", "bernoulli", "probit", "normal", "cauchy",
            "laplace", "log normal", "exponential", "half normal", "half cauchy"]


@pytest.mark.parametrize("name", FAMILIES)
def test_distributions_match_jax_scipy_stats(rng, name):
    port, ref, n = family(name, rng)
    check_twins(port, ref, n, 0.5 * rng.standard_normal((3, n)))


GENERATED = {  # each group's device code in its unit
    "gamma family": ("traced_lgamma(", "lgammaf(", "traced_digamma(", "traced_xlogy(",
                     "kPsi10"),
    "normal cdf": ("traced_log_ndtr(", "traced_erfcx(", "erfcxf(", "traced_erf(",
                   "traced_erfc("),
    "elementwise functions": ("traced_expm1(", "traced_rsqrt(", "Real(1) / ", "traced_atan2(",
                              "traced_powt("),
    "max and min": ("traced_pick<true>(", "traced_pick<false>(", "traced_lane_pick<true>(grp,",
                    "= Real(at);", "isnan(", "== int("),
    "losses and casts": ("traced_bce_logits(", "qnm::log_of(qnm::exp_of(-m)"),
}


@pytest.mark.parametrize("name", list(GENERATED))
def test_generated_text_names_the_ops(rng, name):
    port, _, n, _ = pair(name, rng)
    x0s = torch.zeros((3, n), dtype=torch.float64)
    text = generate(trace_objective(port, None, x0s))
    for piece in GENERATED[name]:
        assert piece in text, piece
    assert text == generate(trace_objective(pair(name, rng)[0], None, x0s))  # values aside
    assert ("traced_lane_pick" in text) == (name == "max and min")


def test_the_new_ops_count_in_the_graph():
    """A max or min one operation per element, digamma 20, log_ndtr 5, BCE
    with logits 12 per element (the formulas in objective_trace._EW_COST)."""
    cases = ((lambda x: torch.max(x) + torch.amin(x), 5 + 5 + 1),
             (lambda x: torch.sum(torch.special.log_ndtr(x)), 5 * 5 + 5),
             (lambda x: -F.binary_cross_entropy_with_logits(x, torch.ones(5, dtype=x.dtype),
                                                           reduction="sum"), 12 * 5 + 5 + 1))
    for fn, want in cases:
        traced = trace_objective(fn, None, torch.zeros((2, 5), dtype=torch.float64))
        assert graph_ops(traced.val) == want
    traced = trace_objective(lambda x: torch.sum(torch.lgamma(x)), None,
                             torch.zeros((2, 5), dtype=torch.float64))
    assert graph_ops(traced.vag) - graph_ops(traced.val) >= 20 * 5  # digamma in the gradient


YB = torch.tensor([0.0, 1.0, 1.0], dtype=torch.float64)

# one objective per class the new ops refuse, and its message
UNTRACEABLE = {
    "polygamma": (lambda x: torch.sum(torch.digamma(x * x + 1.0)),
                  r"aten\.polygamma.*no first-order gradient"),
    "a pos_weight": (lambda x: -F.binary_cross_entropy_with_logits(x, YB, pos_weight=YB + 1.0),
                     r"pos_weight"),
    "a cast to float16": (lambda x: -torch.sum(x.half().double() ** 2), r"cast to torch\.float16"),
    "the indices of max.dim read": (
        lambda x: -torch.sum(x * torch.max(x.reshape(3, 1), 0).indices.to(x.dtype)),
        r"indices of a aten\.max\.dim read by the objective"),
    "torch.cond": (
        lambda x: torch.cond(x.sum() > 0, lambda x: -(x * x).sum(), lambda x: -(x ** 4).sum(),
                             (x,)),
        r"data-dependent branch or loop \(torch\.cond / torch\.while_loop"),
}


@pytest.mark.parametrize("case", list(UNTRACEABLE))
def test_new_untraceable_objectives_are_refused_naming_the_op(case):
    fn, match = UNTRACEABLE[case]
    with pytest.raises(ValueError, match=match) as info:
        trace_objective(fn, None, torch.zeros((2, 3), dtype=torch.float64))
    assert "optimize_batched_fused" in str(info.value)


def test_torch_cond_is_refused_by_the_entry_point():
    """The repair: torch.cond's branches reach the lowering as graph
    attributes, which it took for constants (AttributeError); the trace now
    refuses them with its ValueError on the user's line, and so does
    `optimize_batched_resident`, on the CPU and for kernel "torch" alike."""
    fn = UNTRACEABLE["torch.cond"][0]
    for kernel in ("auto", "torch"):
        with pytest.raises(ValueError, match=r"torch\.cond.*test_torch_objective_dists\.py:"
                                             r".*optimize_batched_fused"):
            qt.optimize_batched_resident(fn, torch.zeros((3, 3), dtype=torch.float64),
                                         kernel=kernel)


def test_distribution_validation_is_refused_with_a_hint():
    """With validation on, a family checks its arguments with a host branch
    on the point: the refusal says so and how to turn it off."""
    D.Distribution.set_default_validate_args(True)
    with pytest.raises(ValueError, match=r"data-dependent branch.*validate_args=False"):
        trace_objective(lambda x: D.Poisson(torch.exp(x)).log_prob(torch.ones(3)).sum(), None,
                        torch.zeros((2, 3), dtype=torch.float64))


def test_a_static_loop_matches_fori_loop_and_scan(rng):
    """A Python loop of fixed length, the torch counterpart of JAX's
    fori_loop and of a forward scan, traces by unrolling: an AR(1)-style
    recursion h_t = tanh(a h_{t-1} + x_t) scored against data."""
    T = 6
    y = rng.standard_normal(T)
    yt, yj = torch.tensor(y), jnp.asarray(y)

    def port(x):
        h, total = x[0] * 0.0, x[0] * 0.0
        for step in range(T):
            h = torch.tanh(0.5 * h + x[step])
            total = total - (yt[step] - h) ** 2
        return total - 0.1 * torch.sum(x * x)

    def ref_fori(x):
        def body(step, carry):
            h, total = carry
            h = jnp.tanh(0.5 * h + x[step])
            return h, total - (yj[step] - h) ** 2
        return lax.fori_loop(0, T, body, (0.0, 0.0))[1] - 0.1 * jnp.sum(x * x)

    def ref_scan(x):
        def body(h, inputs):
            xs, ys = inputs
            h = jnp.tanh(0.5 * h + xs)
            return h, -(ys - h) ** 2
        return jnp.sum(lax.scan(body, 0.0, (x, yj))[1]) - 0.1 * jnp.sum(x * x)

    points = rng.standard_normal((3, T))
    traced = trace_objective(port, None, torch.zeros((2, T), dtype=torch.float64))
    for ref in (ref_fori, ref_scan):
        check_twins(port, ref, T, points, traced=traced)


PACKED = [("dists", name) for name in OBJECTIVES] + [
    ("ops", "gp lu"), ("ops", "triangular solves"), ("trace", "gather with repeats"),
    ("trace", "hierarchical model q=2")]


@pytest.mark.parametrize("source, name", PACKED)
def test_packed_slots_keep_every_value_bit_for_bit(source, name):
    """`_pack` (slots reused once nothing reads them, LU work copies and
    the gathers' and puts' address tables moved with their slots) gives
    both graphs the same values bit for bit in fewer slots."""
    import test_torch_objective_ops as ops
    import test_torch_objective_trace as trace

    rng = np.random.default_rng(0)
    if source == "trace":
        port, vgf, _, n = trace.pair(name, rng)
    else:
        port, _, n, _ = (pair if source == "dists" else ops.pair)(name, rng)
        vgf = None
    traced = trace_objective(port, vgf, torch.zeros((2, n), dtype=torch.float64))
    tables = [t.clone() for t in traced.tables]
    x = torch.tensor(rng.standard_normal(n) * 0.3)
    for graph in (traced.vag, traced.val):
        packed = _pack(graph, n, tables)
        assert packed.slots < graph.slots
        want = evaluate(graph, x, traced.consts, traced.tables)
        got = evaluate(packed, x, traced.consts, tables)
        assert torch.equal(want[0], got[0]) and (want[1] is None or torch.equal(want[1], got[1]))


def test_a_trace_too_large_for_a_block_is_packed(rng):
    """One slot per op does not fit a block for a negative binomial
    regression on 1000 observations in float64 (as for chip_smoke.py's
    phase-34 fleet on 500 at n = 101): the trace reuses slots there, fits,
    and evaluates as torch.func does; in float32 it fits as it is and keeps
    one slot per op."""
    A = rng.standard_normal((1000, 20)) / np.sqrt(20)
    k = rng.negative_binomial(5, 0.5, 1000).astype(float)

    def make(dtype):
        At, kt = torch.tensor(A, dtype=dtype), torch.tensor(k, dtype=dtype)

        def port(th):
            nb = D.NegativeBinomial(torch.exp(th[0]), logits=At @ th[1:] - th[0])
            return nb.log_prob(kt).sum() - 0.5 * torch.sum(th * th)
        return port

    n = 21
    loose = trace_objective(make(torch.float32), None, torch.zeros((2, n)))
    assert lane_fits(n, 4, loose.extra_values) and loose.extra_values == loose.one_slot_values
    tight = trace_objective(make(torch.float64), None, torch.zeros((2, n), dtype=torch.float64))
    assert not lane_fits(n, 8, tight.one_slot_values) and lane_fits(n, 8, tight.extra_values)
    assert resident_feasible(n, 8, tight)
    x = torch.tensor(rng.standard_normal(n) * 0.3)
    value, grad = evaluate(tight.vag, x, tight.consts, tight.tables)
    tvalue, tgrad = as_value_and_grad(make(torch.float64))(x)
    torch.testing.assert_close(value, tvalue, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(grad, tgrad, rtol=1e-12, atol=1e-12)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# sha256 of the generated text of chip_smoke.py's phase-33 objectives (its
# parity cases and five fleets, joined) and of tests/test_torch_objective_ops.py's
# objectives in float64, as the generator wrote them before these ops joined
# the table (phases 22 and 23 are pinned in test_torch_objective_ops.py)
PHASE_33_TEXT = "850207ba1198f53c9ed8111f9505105d39b999832d58d225167eeede3855522e"
OPS_TESTS_TEXT = "5e9471fbb784a2086914c6faa165eb08669c2f30c581e07a775a704f8bdf3ea8"


def test_the_text_of_phase_33s_traces_is_unchanged():
    """The objectives that traced before these ops generate the same CUDA
    byte for byte, so their builds and measured rows still hold."""
    import test_torch_objective_ops as earlier

    texts = _chip_smoke().ops_objectives(qt, torch.device("cpu"))["sources"]
    assert hashlib.sha256("".join(texts).encode()).hexdigest() == PHASE_33_TEXT
    digest = hashlib.sha256()
    for name in earlier.OBJECTIVES:
        port, _, n, _ = earlier.pair(name, np.random.default_rng(0))
        x0s = torch.zeros((2, n), dtype=torch.float64)
        digest.update(generate(trace_objective(port, None, x0s)).encode())
    assert digest.hexdigest() == OPS_TESTS_TEXT
