"""The ops the trace of B3's objective takes for softmax models, mixtures
and multivariate normals (ops/kernels/objective_trace.py,
objective_codegen.py), on the CPU.

For each group of ops (softmax, log-softmax and their backwards, ``gather``
and ``scatter_add`` at constant indices, ``D.Categorical``; the factories
that read only a lane value's shape, ``full_like``, ``new_ones``,
``new_full`` and ``full``, with ``D.Gumbel`` and ``D.InverseGamma``;
``prod`` and ``cumprod``; per-lane values of rank 3, ``bmm`` and the
per-lane linear algebra over a leading batch dim; ``D.MultivariateNormal``
and the mixtures) at least one objective uses each op, and the IR's
evaluator is held to ``torch.func.grad_and_value`` of the objective and to
JAX's ``jax.value_and_grad`` of its jnp twin (``jax.nn.log_softmax``,
``jnp.take_along_axis``, ``.at[].add``, ``jnp.full_like``, ``jnp.prod``,
``jnp.cumprod``, ``jnp.einsum``, ``multivariate_normal.logpdf``) on the same
numpy inputs in float64 to 1e-12.

erfinv differs between the packages: over |y| <= 0.99 torch's CPU formula
and JAX's agree to 4e-15 relative in value and gradient (float64), but
toward |y| = 1 they part, to 5e-13 in the value and 2e-11 in the gradient
at |y| = 1 - 1e-6 (float32: 6e-6 and 9e-5), as
`test_erfinv_formulas_part_toward_one` measures; so the erfinv group keeps
its arguments within 0.9 and is held at 1e-12, and torch's CUDA erfinv, the
one B3 calls, is held to torch's CPU one by chip_smoke.py's phase 35.

The generated text of each group names its device code; the text of every
objective that traced before these ops is pinned (phase 34's here, the
earlier phases in tests/test_torch_objective_ops.py and
tests/test_torch_objective_dists.py); an index computed from the point, a
gather index of another rank than its source's, a value of rank 4 and
D.Multinomial's boolean-mask write are refused. The kernel itself runs
only on the card (tests/test_torch_kernels_cuda.py).
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
from jax.scipy import special as jsp
from jax.scipy import stats

import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_codegen import generate
from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_trace import trace_objective
from test_torch_objective_dists import check_twins
from test_torch_objective_ops import aten_ops

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_validation():
    """torch.distributions' validation is a data-dependent branch (see
    tests/test_torch_objective_dists.py)."""
    before = D.Distribution._validate_args
    D.Distribution.set_default_validate_args(False)
    yield
    D.Distribution.set_default_validate_args(before)


def jax_gumbel(x, loc, scale):
    z = (x - loc) / scale
    return -(z + jnp.exp(-z)) - jnp.log(scale)


def jax_inverse_gamma(x, conc, rate):
    return conc * jnp.log(rate) - jsp.gammaln(conc) - (conc + 1.0) * jnp.log(x) - rate / x


def pair(name, rng):
    """(port objective, JAX objective, n, the aten ops its trace must hold)."""
    t = torch.tensor
    if name == "softmax and gathers":  # W 3 x 4 on 10 observations
        A, C = rng.standard_normal((10, 3)), rng.standard_normal((10, 4))
        y, rows = rng.integers(0, 4, 10), rng.integers(0, 10, (2, 4))
        cls = rng.integers(0, 4, 6)
        At, Ct, yt, rt, ct = t(A), t(C), t(y), t(rows), t(cls)
        Aj, Cj = jnp.asarray(A), jnp.asarray(C)

        def port(x):
            Z = At @ x.reshape(3, 4)
            spread = torch.zeros(4, dtype=x.dtype).scatter_add(0, ct, x[:6])
            return torch.log_softmax(Z, 1).gather(1, yt[:, None]).sum() \
                + 0.3 * torch.sum(torch.softmax(Z, 0) * Ct) \
                + 0.2 * torch.sum(torch.gather(Z, 0, rt)) \
                + D.Categorical(logits=Z[:5]).log_prob(yt[:5]).sum() \
                - 0.1 * torch.sum(spread * spread) \
                + 0.1 * torch.sum(torch.softmax(x[:3], 0) * x[3:6]) \
                - 0.5 * torch.sum(x * x)

        def ref(x):
            Z = Aj @ x.reshape(3, 4)
            spread = jnp.zeros(4).at[cls].add(x[:6])
            logp = jax.nn.log_softmax(Z, axis=1)
            return jnp.sum(jnp.take_along_axis(logp, y[:, None], axis=1)) \
                + 0.3 * jnp.sum(jax.nn.softmax(Z, axis=0) * Cj) \
                + 0.2 * jnp.sum(jnp.take_along_axis(Z, rows, axis=0)) \
                + jnp.sum(jnp.take_along_axis(logp[:5], y[:5, None], axis=1)) \
                - 0.1 * jnp.sum(spread * spread) + 0.1 * jnp.sum(jax.nn.softmax(x[:3]) * x[3:6]) \
                - 0.5 * jnp.sum(x * x)

        ops = {"_softmax.default", "_log_softmax.default", "_softmax_backward_data.default",
               "_log_softmax_backward_data.default", "gather.default", "scatter_add.default"}
        return port, ref, 12, ops
    if name == "factories":  # Gumbel and inverse-gamma parameters from the point
        g = rng.gumbel(0.5, 1.5, 8)
        ig = 1.0 / rng.gamma(3.0, 1.0 / 2.0, 8)
        gt, igt, gj, igj = t(g), t(ig), jnp.asarray(g), jnp.asarray(ig)

        def port(x):
            return D.Gumbel(x[0], torch.exp(x[1])).log_prob(gt).sum() \
                + D.InverseGamma(torch.exp(x[2]), torch.exp(x[3])).log_prob(igt).sum() \
                - 0.1 * torch.sum((x - torch.full_like(x, 0.5)) ** 2 * x.new_ones(6)) \
                + 0.1 * torch.sum(x.new_full((6,), 2.0) * torch.tanh(x)) \
                - 0.2 * torch.sum(torch.full((6,), 0.3, dtype=x.dtype) * x) - 0.5 * torch.sum(x * x)

        def ref(x):
            return jnp.sum(jax_gumbel(gj, x[0], jnp.exp(x[1]))) \
                + jnp.sum(jax_inverse_gamma(igj, jnp.exp(x[2]), jnp.exp(x[3]))) \
                - 0.1 * jnp.sum((x - jnp.full_like(x, 0.5)) ** 2 * jnp.ones(6)) \
                + 0.1 * jnp.sum(jnp.full((6,), 2.0) * jnp.tanh(x)) \
                - 0.2 * jnp.sum(jnp.full((6,), 0.3) * x) - 0.5 * jnp.sum(x * x)

        return port, ref, 6, {"full_like.default", "new_ones.default", "new_full.default",
                              "full.default"}
    if name == "products":
        def port(x):
            M = x.reshape(2, 4)
            return 0.2 * torch.log(torch.prod(1.0 + 0.1 * x * x)) \
                + 0.1 * torch.sum(torch.log(torch.prod(1.5 + torch.tanh(M), 1))) \
                + 0.1 * torch.sum(torch.log(torch.prod(1.5 + torch.tanh(M), 0, keepdim=True))) \
                - 0.05 * torch.sum(torch.cumprod(1.0 + 0.1 * torch.tanh(M), 1)) \
                - 0.05 * torch.sum(torch.cumprod(1.0 + 0.1 * torch.tanh(M.T), 1)) \
                - 0.5 * torch.sum(x * x)

        def ref(x):
            M = x.reshape(2, 4)
            return 0.2 * jnp.log(jnp.prod(1.0 + 0.1 * x * x)) \
                + 0.1 * jnp.sum(jnp.log(jnp.prod(1.5 + jnp.tanh(M), 1))) \
                + 0.1 * jnp.sum(jnp.log(jnp.prod(1.5 + jnp.tanh(M), 0))) \
                - 0.05 * jnp.sum(jnp.cumprod(1.0 + 0.1 * jnp.tanh(M), 1)) \
                - 0.05 * jnp.sum(jnp.cumprod(1.0 + 0.1 * jnp.tanh(M.T), 1)) \
                - 0.5 * jnp.sum(x * x)

        return port, ref, 8, {"prod.default", "prod.dim_int", "cumprod.default"}
    if name == "erfinv":  # arguments within 0.9 (see the module docstring)
        c = rng.standard_normal(6)
        ct, cj = t(c), jnp.asarray(c)

        def port(x):
            e = torch.erfinv(0.9 * torch.tanh(x - ct))
            return -0.1 * torch.sum(e * e) + 0.2 * torch.sum(torch.erfinv(0.5 * torch.sin(x))) \
                - 0.5 * torch.sum(x * x)

        def ref(x):
            e = jsp.erfinv(0.9 * jnp.tanh(x - cj))
            return -0.1 * jnp.sum(e * e) + 0.2 * jnp.sum(jsp.erfinv(0.5 * jnp.sin(x))) \
                - 0.5 * jnp.sum(x * x)

        return port, ref, 6, {"erfinv.default"}
    if name == "rank 3":  # a batch of two of each
        B, G, yb = rng.standard_normal((2, 3, 2)), rng.standard_normal((2, 3, 3)), \
            rng.standard_normal((2, 3, 1))
        K0 = G @ G.transpose(0, 2, 1) / 3 + np.eye(3)
        Bt, Kt, ybt = t(B), t(K0), t(yb)
        Bj, Kj, ybj = jnp.asarray(B), jnp.asarray(K0), jnp.asarray(yb)

        def port(x):
            T = x[:12].reshape(2, 2, 3)
            P = torch.bmm(T, Bt)
            K = Kt + 0.1 * torch.diag_embed(torch.exp(x[12:18].reshape(2, 3)))
            L = torch.linalg.cholesky(K)
            a = torch.linalg.solve_triangular(L, ybt * (1.0 + 0.1 * x[18:].reshape(2, 3, 1)),
                                              upper=False)
            return -0.1 * torch.sum(P * P) + 0.1 * torch.sum(torch.logsumexp(T, 1)) \
                - 0.05 * torch.sum(torch.sum(T, 0) ** 2) + 0.1 * torch.sum(torch.amax(T, 2)) \
                - 0.05 * torch.sum(torch.mean(T, (0, 2)) ** 2) \
                - 0.02 * torch.sum(torch.cumsum(T, 2) ** 2) \
                + 0.1 * torch.sum(torch.tril(T[:, :, :2]) * torch.triu(T[:, :, 1:])) \
                - 0.5 * torch.sum(a * a) - torch.sum(torch.log(torch.diagonal(L, 0, 1, 2))) \
                - 0.1 * torch.sum(torch.linalg.slogdet(K)[1]) \
                + 0.05 * torch.sum(torch.linalg.solve(K, ybt[..., 0]) ** 2) \
                - 0.5 * torch.sum(x * x)

        def ref(x):
            T = x[:12].reshape(2, 2, 3)
            P = jnp.einsum("bij,bjk->bik", T, Bj)
            K = Kj + 0.1 * jax.vmap(jnp.diag)(jnp.exp(x[12:18].reshape(2, 3)))
            L = jnp.linalg.cholesky(K)
            a = jax.scipy.linalg.solve_triangular(L, ybj * (1.0 + 0.1 * x[18:].reshape(2, 3, 1)),
                                                  lower=True)
            return -0.1 * jnp.sum(P * P) + 0.1 * jnp.sum(jsp.logsumexp(T, 1)) \
                - 0.05 * jnp.sum(jnp.sum(T, 0) ** 2) + 0.1 * jnp.sum(jnp.max(T, 2)) \
                - 0.05 * jnp.sum(jnp.mean(T, (0, 2)) ** 2) \
                - 0.02 * jnp.sum(jnp.cumsum(T, 2) ** 2) \
                + 0.1 * jnp.sum(jnp.tril(T[:, :, :2]) * jnp.triu(T[:, :, 1:])) \
                - 0.5 * jnp.sum(a * a) - jnp.sum(jnp.log(jnp.diagonal(L, 0, 1, 2))) \
                - 0.1 * jnp.sum(jnp.linalg.slogdet(K)[1]) \
                + 0.05 * jnp.sum(jnp.linalg.solve(K, ybj) ** 2) - 0.5 * jnp.sum(x * x)

        return port, ref, 24, {"bmm.default", "linalg_cholesky_ex.default",
                               "linalg_solve_triangular.default", "_linalg_slogdet.default",
                               "_linalg_solve_ex.default", "cumsum.default", "tril.default"}
    raise AssertionError(name)


OBJECTIVES = ["softmax and gathers", "factories", "products", "erfinv", "rank 3"]


@pytest.mark.parametrize("name", OBJECTIVES)
def test_ir_matches_torch_func_and_jax(rng, name):
    port, ref, n, ops = pair(name, rng)
    assert ops <= aten_ops(port, n), ops - aten_ops(port, n)
    check_twins(port, ref, n, 0.5 * rng.standard_normal((3, n)))


def model(name, rng):
    """(port log-density, JAX's twin, n) of a model the slice's users write."""
    t = torch.tensor
    if name == "softmax regression":  # D.Categorical(logits = X W), W 4 x 3
        X, y = rng.standard_normal((20, 4)), rng.integers(0, 3, 20)
        Xt, yt, Xj = t(X), t(y), jnp.asarray(X)
        return (lambda w: D.Categorical(logits=Xt @ w.reshape(4, 3)).log_prob(yt).sum()
                - 0.5 * torch.sum(w * w),
                lambda w: jnp.sum(jnp.take_along_axis(jax.nn.log_softmax(Xj @ w.reshape(4, 3), 1),
                                                      y[:, None], 1)) - 0.5 * jnp.sum(w * w), 12)
    if name.startswith("multivariate normal"):  # d = 3: mean, log diagonal, lower triangle
        V = rng.standard_normal((15, 3)) if "one value" not in name else rng.standard_normal(3)
        Vt, Vj = t(V), jnp.asarray(V)
        rows, cols = torch.tril_indices(3, 3, -1)

        def factor_t(th):
            return torch.diag_embed(torch.exp(th[3:6])) + torch.zeros(
                (3, 3), dtype=th.dtype).index_put((rows, cols), th[6:])

        def factor_j(th):
            return jnp.diag(jnp.exp(th[3:6])) + jnp.zeros((3, 3)).at[rows.numpy(),
                                                                   cols.numpy()].set(th[6:])

        if "covariance" in name:
            def port(th):
                L = factor_t(th)
                return D.MultivariateNormal(th[:3], covariance_matrix=L @ L.T).log_prob(Vt).sum() \
                    - 0.5 * torch.sum(th * th)
        else:
            def port(th):
                return D.MultivariateNormal(th[:3], scale_tril=factor_t(th)).log_prob(Vt).sum() \
                    - 0.5 * torch.sum(th * th)

        def ref(th):
            L = factor_j(th)
            return jnp.sum(stats.multivariate_normal.logpdf(Vj, th[:3], L @ L.T)) \
                - 0.5 * jnp.sum(th * th)
        return port, ref, 9
    if name == "mixtures":  # MixtureSameFamily and a stick-breaking twin, K = 3
        v = rng.standard_normal(20) * 2.0
        vt, vj = t(v), jnp.asarray(v)

        def port(th):
            a, mu, s, b, nu, r = th[:3], th[3:6], th[6:9], th[9:11], th[11:14], th[14:17]
            lp = D.MixtureSameFamily(D.Categorical(logits=a),
                                     D.Normal(mu, torch.exp(s))).log_prob(vt).sum()
            u = torch.sigmoid(b)
            one = torch.ones_like(u[:1])
            w = torch.cat([u, one]) * torch.cat([one, torch.cumprod(1.0 - u, 0)])
            normal = D.Normal(nu, torch.exp(r)).log_prob(vt[:, None])
            lp = lp + torch.logsumexp(torch.log(w) + normal, 1).sum()
            return lp - 0.5 * torch.sum(th * th)

        def ref(th):
            a, mu, s, b, nu, r = th[:3], th[3:6], th[6:9], th[9:11], th[11:14], th[14:17]
            lp = jnp.sum(jsp.logsumexp(jax.nn.log_softmax(a)
                                       + stats.norm.logpdf(vj[:, None], mu, jnp.exp(s)), 1))
            u = jax.nn.sigmoid(b)
            one = jnp.ones(1)
            w = jnp.concatenate([u, one]) * jnp.concatenate([one, jnp.cumprod(1.0 - u)])
            lp = lp + jnp.sum(jsp.logsumexp(jnp.log(w)
                                            + stats.norm.logpdf(vj[:, None], nu, jnp.exp(r)), 1))
            return lp - 0.5 * jnp.sum(th * th)
        return port, ref, 17
    raise AssertionError(name)


MODELS = ["softmax regression", "multivariate normal", "multivariate normal by covariance",
          "multivariate normal, one value", "mixtures"]


@pytest.mark.parametrize("name", MODELS)
def test_models_match_jax(rng, name):
    port, ref, n = model(name, rng)
    check_twins(port, ref, n, 0.5 * rng.standard_normal((3, n)))


def test_erfinv_formulas_part_toward_one():
    """torch's CPU erfinv and JAX's: within 4e-15 relative over |y| <= 0.99
    in float64 (value and gradient), up to 5e-13 and 2e-11 at |y| = 1 -
    1e-6, and in float32 up to 6e-6 and 9e-5 there (the module
    docstring's tolerances)."""
    for dtype, jtype, near, far in ((torch.float64, jnp.float64, (4e-15, 4e-15),
                                     (5e-13, 2e-11)),
                                    (torch.float32, jnp.float32, None, (6e-6, 9e-5))):
        for edge, bound in ((0.99, near), (1.0 - 1e-6, far)):
            if bound is None:
                continue
            y = np.linspace(-edge, edge, 20001)
            yt, yj = torch.tensor(y, dtype=dtype), jnp.asarray(y, jtype)
            value = torch.erfinv(yt).double().numpy()
            jvalue = np.asarray(jsp.erfinv(yj), np.float64)
            grad = torch.func.grad(lambda z: torch.erfinv(z).sum())(yt).double().numpy()
            jgrad = np.asarray(jax.grad(lambda z: jsp.erfinv(z).sum())(yj), np.float64)
            assert np.max(np.abs(value - jvalue) / np.maximum(np.abs(jvalue), 1e-30)) < bound[0]
            assert np.max(np.abs(grad - jgrad) / np.abs(jgrad)) < bound[1]


GENERATED = {  # each group's device code in its unit
    "softmax and gathers": ("qnm::log_of(acc) + shift", "= s[t12[i]];",
                            "[i + 1]; ++k) acc = acc + s[t"),
    "factories": ("Real(0x1.0000000000000p-1)",),
    "products": ("acc = acc * ", "Real acc = Real(1);"),
    "erfinv": ("traced_erfinv(", "erfinvf(a)", "erfinv(a)"),
    "rank 3": ("% 3; const int i2 = i % 3;", "qnm::lane_cholesky(", "qnm::lane_trsm<",
               "qnm::lane_slogdet(", "qnm::lane_solve("),
}


@pytest.mark.parametrize("name", list(GENERATED))
def test_generated_text_names_the_ops(rng, name):
    port, _, n, _ = pair(name, rng)
    x0s = torch.zeros((3, n), dtype=torch.float64)
    text = generate(trace_objective(port, None, x0s))
    for piece in GENERATED[name]:
        assert piece in text, piece
    # rank-3 address arithmetic only where a value has rank 3
    assert ("const int i2 = " in text) == (name == "rank 3")


def test_a_batch_of_one_is_a_view():
    """A leading batch dim of 1 (D.MultivariateNormal's) adds no op: the
    per-lane matrix and its right-hand sides are views of the batch's one
    entry; a batch of two is one op per entry, stacked."""
    def one(x):
        K = torch.eye(3, dtype=x.dtype) * 2.0 + torch.diag(torch.exp(x))
        return torch.linalg.solve_triangular(torch.linalg.cholesky(K)[None], x[None, :, None],
                                             upper=False).sum()

    def two(x):
        K = torch.eye(3, dtype=x.dtype) * 2.0 + torch.diag(torch.exp(x))
        return torch.linalg.solve_triangular(torch.linalg.cholesky(torch.stack([K, 2.0 * K])),
                                             x[None, :, None], upper=False).sum()

    x0s = torch.zeros((2, 3), dtype=torch.float64)
    kinds = {name: [op.kind for op in trace_objective(fn, None, x0s).val.ops]
             for name, fn in (("one", one), ("two", two))}
    assert kinds["one"].count("trsm") == 1 and "cat" not in kinds["one"]
    assert kinds["two"].count("chol") == 2 and kinds["two"].count("trsm") == 2
    assert kinds["two"].count("cat") >= 2


Y4 = torch.tensor([1, 0, 2, 1])

# one objective per class the new ops refuse, and its message
UNTRACEABLE = {
    "a gather index computed from the point": (
        lambda x: -torch.sum(torch.gather(x, 0, (x > 0).long()) ** 2),
        r"index computed from the point"),
    "a gather index of another rank": (
        lambda x: -torch.gather(x, 0, torch.tensor(1)) ** 2 - torch.sum(x * x),
        r"gather index of rank 0 for a source of rank 1 \(aten\.gather"),
    "a scatter_add index computed from the point": (
        lambda x: -torch.sum(torch.zeros(3, dtype=x.dtype).scatter_add(0, (x > 0).long(), x) ** 2),
        r"index computed from the point"),
    "a per-lane value of rank 4": (
        lambda x: -(x[:, None, None, None] * x[None, :, None, None]).sum(),
        r"rank 4 \(aten\..*ranks up to 3"),
    "a fill computed from the point": (
        lambda x: -torch.sum(torch.full_like(x, x[0].item()) * x), r"_local_scalar_dense"),
    "D.Multinomial's boolean-mask write": (
        lambda x: D.Multinomial(logits=x).log_prob(torch.tensor([1.0, 0.0, 2.0])),
        r"boolean-mask index"),
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


# sha256 of the generated text of chip_smoke.py's phase-34 objectives (its four fleets,
# joined), as the generator wrote them before these ops joined the table (phases 22, 23
# and 33 are pinned in tests/test_torch_objective_ops.py and test_torch_objective_dists.py)
PHASE_34_TEXT = "0f469abb32e5b7978fdebd15680ee6aa4e83354dd0f7e9978d45da56eb8831ff"


def test_the_text_of_phase_34s_traces_is_unchanged():
    """The objectives that traced before these ops generate the same CUDA
    byte for byte, so their builds and measured rows still hold."""
    texts = _chip_smoke().dists_objectives(qt, torch.device("cpu"))["sources"]
    assert hashlib.sha256("".join(texts).encode()).hexdigest() == PHASE_34_TEXT
