"""B3's plain version on log-densities written with torch.distributions,
against JAX's resident engine, on the CPU.

The port's `optimize_batched_resident` on CPU tensors traces the objective
(so each op must trace) and runs the kernel's plain version, the fleet
engine with the plain update on the user's function (``kernel="torch"``);
JAX's runs its resident kernel in interpret mode on the `jax.scipy.stats`
twin, except where far line-search trials part the packages' formulas
beyond rounding and so move the interpolated step: the negative binomial is
written with log-sigmoids as torch's computes it (`nbinom.logpmf` takes
log(p) and log1p(-p) of p = σ(-l), which lose digits at |l| ≳ 20), the
Weibull, which JAX lacks, through torch's transforms (a direct density is
-inf where torch's is NaN), BCE with logits in jnp;
tests/test_torch_objective_dists.py holds each family to jax.scipy.stats
where both are finite. On 8-lane fleets in float64, with argument validation off (a
data-dependent branch; see tests/test_torch_objective_dists.py): a negative
binomial regression with an unknown dispersion, a Student-t regression with
unknown scale and degrees of freedom, a probit regression through log_ndtr,
Gamma + Beta + Dirichlet parameters from draws, and Weibull + Uniform +
Bernoulli-with-logits; at caps 0, 1 and 5 every counter is equal on every
lane and floats agree to rounding; over whole solves the statuses are equal
and every lane ends on the same optimum. The CUDA kernel is held to the
plain version on the card (tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributions as D
from jax.scipy import special as jsp
from jax.scipy import stats

from quasinewtonmethods_jl_tpu.resident_solve import (
    optimize_batched_resident as jax_optimize_batched_resident,
)
import quasinewtonmethods_jl_tpu_torch as qt
from test_torch_objective_dists import jax_bce
from test_torch_resident_traced import COUNTERS

torch.set_num_threads(1)

N_LANES = 8


@pytest.fixture(autouse=True)
def no_validation():
    before = D.Distribution._validate_args
    D.Distribution.set_default_validate_args(False)
    yield
    D.Distribution.set_default_validate_args(before)


def twins(name, rng):
    """(port log-density, JAX's twin, n)."""
    t = torch.tensor
    if name == "negative binomial":  # (log r, w): logits 0.5 + A w - log r
        A = rng.standard_normal((24, 3)) / np.sqrt(3)
        mean = np.exp(0.5 + A @ rng.standard_normal(3))
        k = rng.negative_binomial(4, 4 / (4 + mean)).astype(float)
        At, kt, Aj, kj = t(A), t(k), jnp.asarray(A), jnp.asarray(k)

        def port(th):
            nb = D.NegativeBinomial(torch.exp(th[0]), logits=0.5 + At @ th[1:] - th[0])
            return nb.log_prob(kt).sum() - 0.5 * torch.sum(th * th)

        def ref(th):  # torch's formula (see the module docstring)
            r, logits = jnp.exp(th[0]), 0.5 + Aj @ th[1:] - th[0]
            lp = r * jax.nn.log_sigmoid(-logits) + kj * jax.nn.log_sigmoid(logits) \
                + jsp.gammaln(r + kj) - jsp.gammaln(1.0 + kj) - jsp.gammaln(r)
            return jnp.sum(lp) - 0.5 * jnp.sum(th * th)
        return port, ref, 4
    if name == "student t":  # (log scale, log df, w)
        A = rng.standard_normal((24, 3)) / np.sqrt(3)
        y = A @ rng.standard_normal(3) + 0.5 * rng.standard_t(3, 24)
        At, yt, Aj, yj = t(A), t(y), jnp.asarray(A), jnp.asarray(y)

        def port(th):
            st = D.StudentT(torch.exp(th[1]), At @ th[2:], torch.exp(th[0]))
            return st.log_prob(yt).sum() - 0.5 * torch.sum(th * th)

        def ref(th):
            lp = stats.t.logpdf(yj, jnp.exp(th[1]), Aj @ th[2:], jnp.exp(th[0]))
            return jnp.sum(lp) - 0.5 * jnp.sum(th * th)
        return port, ref, 5
    if name == "probit":
        A = rng.standard_normal((30, 4)) / 2.0
        s = np.where(A @ rng.standard_normal(4) + rng.standard_normal(30) > 0, 1.0, -1.0)
        At, st, Aj, sj = t(A), t(s), jnp.asarray(A), jnp.asarray(s)

        def port(w):
            return torch.sum(torch.special.log_ndtr(st * (At @ w))) - 0.5 * torch.sum(w * w)

        def ref(w):
            return jnp.sum(stats.norm.logcdf(sj * (Aj @ w))) - 0.5 * jnp.sum(w * w)
        return port, ref, 4
    if name == "gamma beta dirichlet":  # log shapes, rates, Beta's pair, concentrations
        g, b = rng.gamma(2.0, 0.7, (12, 2)), rng.beta(2.0, 3.0, 12)
        p = rng.dirichlet(np.full(4, 2.0), 12)
        gt, bt, pt = t(g), t(b), t(p)
        gj, bj, pj = jnp.asarray(g), jnp.asarray(b), jnp.asarray(p.T)

        def port(x):
            e = torch.exp(x)
            return D.Gamma(e[:2], e[2:4]).log_prob(gt).sum() \
                + D.Beta(e[4], e[5]).log_prob(bt).sum() \
                + D.Dirichlet(e[6:]).log_prob(pt).sum() - 0.1 * torch.sum(x * x)

        def ref(x):
            e = jnp.exp(x)
            return jnp.sum(stats.gamma.logpdf(gj, e[:2], scale=1.0 / e[2:4])) \
                + jnp.sum(stats.beta.logpdf(bj, e[4], e[5])) \
                + jnp.sum(stats.dirichlet.logpdf(pj, e[6:])) - 0.1 * jnp.sum(x * x)
        return port, ref, 10
    if name == "weibull uniform bernoulli":  # Weibull 2 + 2, the box's 2 + 2, 3 logits
        w, u = 2.0 * rng.weibull(1.5, (12, 2)), rng.uniform(-0.5, 0.5, (12, 2))
        A, c = rng.standard_normal((16, 3)), rng.integers(0, 2, 16).astype(float)
        wt, ut, At, ct = t(w), t(u), t(A), t(c)
        wj, uj, Aj, cj = (jnp.asarray(a) for a in (w, u, A, c))

        def port(x):
            e = torch.exp(x[:8])
            return D.Weibull(e[:2], e[2:4]).log_prob(wt).sum() \
                + D.Uniform(-0.5 - e[4:6], 0.5 + e[6:8]).log_prob(ut).sum() \
                + D.Bernoulli(logits=At @ x[8:]).log_prob(ct).sum() - 0.5 * torch.sum(x * x)

        def ref(x):
            e = jnp.exp(x[:8])
            scale, conc = e[:2], e[2:4]
            # torch's transforms: Exponential(1) of (w/scale)^conc, less the log-Jacobians
            # of the scaling and of the power
            y = wj / scale
            z = y ** conc
            weibull = -jnp.log(scale) - jnp.log(jnp.abs(y / (conc * z))) - z
            box = stats.uniform.logpdf(uj, -0.5 - e[4:6], 1.0 + e[4:6] + e[6:8])
            return jnp.sum(weibull) + jnp.sum(box) - jnp.sum(jax_bce(Aj @ x[8:], cj)) \
                - 0.5 * jnp.sum(x * x)
        return port, ref, 11
    raise AssertionError(name)


FAMILIES = ["negative binomial", "student t", "probit", "gamma beta dirichlet",
            "weibull uniform bernoulli"]


@pytest.fixture(scope="module", params=FAMILIES)
def fleet(request):
    rng = np.random.default_rng(20260816)
    port, ref, n = twins(request.param, rng)
    X = rng.standard_normal((N_LANES, n)) * 0.5
    return request.param, port, ref, X


def jax_run(ref, X, **kw):
    return jax_optimize_batched_resident(ref, jnp.asarray(X), tol=1e-6, block_batch=N_LANES,
                                         interpret=True, **kw)


def test_the_caps_follow_jax_lane_for_lane(fleet):
    """Caps 0, 1 and 5: every counter equal on every lane, floats to
    rounding (the two sum in other orders)."""
    name, port, ref, X = fleet
    for cap in (0, 1, 5):
        res = qt.optimize_batched_resident(port, torch.tensor(X), tol=1e-6, max_iterations=cap,
                                           kernel="torch")
        jres = jax_run(ref, X, max_iterations=cap)
        for f in COUNTERS:
            assert np.array_equal(getattr(res, f).numpy(), np.asarray(getattr(jres, f))), (cap, f)
        for f in ("x", "fun", "grad"):
            np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(jres, f)),
                                       rtol=1e-10, atol=1e-10, err_msg=f"{name} cap {cap} {f}")
        np.testing.assert_allclose(res.state.B.numpy(), np.asarray(jres.state.B), rtol=1e-8,
                                   atol=1e-8, err_msg=f"{name} cap {cap} B")


def test_whole_solves_end_alike(fleet):
    """Whole solves: the same statuses, every lane converged, on the same
    optimum."""
    name, port, ref, X = fleet
    res = qt.optimize_batched_resident(port, torch.tensor(X), tol=1e-6, kernel="torch")
    jres = jax_run(ref, X)
    assert np.array_equal(res.status.numpy(), np.asarray(jres.status)), name
    assert bool(res.converged.all()), (name, res.status)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-6, atol=1e-6,
                               err_msg=name)
    np.testing.assert_allclose(res.fun.numpy(), np.asarray(jres.fun), rtol=1e-9, atol=1e-12,
                               err_msg=name)
