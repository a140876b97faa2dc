"""B3's plain version on softmax regression, a multivariate normal and the
mixtures, against JAX's resident engine, on the CPU.

The port's `optimize_batched_resident` on CPU tensors traces the objective
(so each op must trace: softmax and log-softmax, gathers and scatter_adds
at constant indices, the shape-only factories of D.Gumbel and
D.InverseGamma, cumprod, per-lane values of rank 3 and the per-lane
triangular solve over D.MultivariateNormal's batch dim of 1) and runs the
kernel's plain version, the fleet engine with the plain update on the
user's function (``kernel="torch"``); JAX's runs its resident kernel in
interpret mode on the jnp twin (``jax.nn.log_softmax`` with
``jnp.take_along_axis``, ``jnp.cumprod``, the Gumbel and inverse-gamma
densities written out; the multivariate normal as torch computes it, a
triangular solve by its factor L and the log of L's diagonal:
``multivariate_normal.logpdf`` factorizes L Lᵀ again, which fails at far
line-search trials where torch's solve does not, and so moves the
interpolated step; tests/test_torch_objective_softmax.py holds the family
to ``multivariate_normal.logpdf`` where both are finite). On 8-lane fleets in
float64, with argument validation off (a data-dependent branch; see
tests/test_torch_objective_dists.py): at caps 0, 1 and 5 every counter is
equal on every lane and floats agree to rounding; over whole solves the
statuses are equal and every lane ends on the same optimum. The CUDA
kernel is held to the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py's phase 35).
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
from test_torch_objective_softmax import jax_gumbel, jax_inverse_gamma
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
    if name == "softmax regression":  # 30 observations, 3 features x 3 classes
        X = rng.standard_normal((30, 3))
        y = np.argmax(X @ rng.standard_normal((3, 3)) + rng.gumbel(size=(30, 3)), axis=1)
        Xt, yt, Xj = t(X), t(y), jnp.asarray(X)

        def port(w):
            return D.Categorical(logits=Xt @ w.reshape(3, 3)).log_prob(yt).sum() \
                - 0.5 * torch.sum(w * w)

        def ref(w):
            logp = jax.nn.log_softmax(Xj @ w.reshape(3, 3), axis=1)
            return jnp.sum(jnp.take_along_axis(logp, y[:, None], axis=1)) - 0.5 * jnp.sum(w * w)
        return port, ref, 9
    if name == "multivariate normal":  # d = 3, 15 observations
        L0 = np.diag(np.exp(0.3 * rng.standard_normal(3))) + np.tril(
            0.5 * rng.standard_normal((3, 3)), -1)
        V = rng.standard_normal(3) + rng.standard_normal((15, 3)) @ L0.T
        Vt, Vj = t(V), jnp.asarray(V)
        rows, cols = torch.tril_indices(3, 3, -1)
        rj, cj = rows.numpy(), cols.numpy()

        def port(th):
            L = torch.diag_embed(torch.exp(th[3:6])) + torch.zeros(
                (3, 3), dtype=th.dtype).index_put((rows, cols), th[6:])
            return D.MultivariateNormal(th[:3], scale_tril=L).log_prob(Vt).sum() \
                - 0.005 * torch.sum(th[:3] ** 2) - 0.5 * torch.sum(th[3:] ** 2)

        def ref(th):  # torch's formula (see the module docstring)
            L = jnp.diag(jnp.exp(th[3:6])) + jnp.zeros((3, 3)).at[rj, cj].set(th[6:])
            z = jax.scipy.linalg.solve_triangular(L, (Vj - th[:3]).T, lower=True)
            lp = -0.5 * jnp.sum(z * z) - 15 * (jnp.sum(jnp.log(jnp.diag(L)))
                                               + 1.5 * jnp.log(2.0 * jnp.pi))
            return lp - 0.005 * jnp.sum(th[:3] ** 2) - 0.5 * jnp.sum(th[3:] ** 2)
        return port, ref, 9
    if name == "mixtures":  # K = 3 on 40 points: softmax weights and stick-breaking
        comp = rng.choice(3, size=40, p=[0.5, 0.3, 0.2])
        v = np.array([-2.0, 0.0, 2.5])[comp] + 0.5 * rng.standard_normal(40)
        vt, vj = t(v), jnp.asarray(v)

        def port(th):
            a, mu, s, b, nu, r = th[:3], th[3:6], th[6:9], th[9:11], th[11:14], th[14:17]
            m, c = th[17], th[18]
            lp = D.MixtureSameFamily(D.Categorical(logits=a),
                                     D.Normal(mu, torch.exp(s))).log_prob(vt).sum()
            u = torch.sigmoid(b)
            one = torch.ones_like(u[:1])
            w = torch.cat([u, one]) * torch.cat([one, torch.cumprod(1.0 - u, 0)])
            normal = D.Normal(nu, torch.exp(r)).log_prob(vt[:, None])
            lp = lp + torch.logsumexp(torch.log(w) + normal, 1).sum()
            for loc, logsd in ((mu, s), (nu, r)):
                lp = lp + D.Gumbel(m.expand(3), 2.0).log_prob(loc).sum()
                lp = lp + (D.InverseGamma(2.0, torch.exp(c)).log_prob(torch.exp(2.0 * logsd))
                           + 2.0 * logsd).sum()
            return lp - 0.5 * (torch.sum(a * a) + torch.sum(b * b) + m * m + c * c)

        def ref(th):
            a, mu, s, b, nu, r = th[:3], th[3:6], th[6:9], th[9:11], th[11:14], th[14:17]
            m, c = th[17], th[18]
            lp = jnp.sum(jsp.logsumexp(jax.nn.log_softmax(a)
                                       + stats.norm.logpdf(vj[:, None], mu, jnp.exp(s)), 1))
            u = jax.nn.sigmoid(b)
            one = jnp.ones(1)
            w = jnp.concatenate([u, one]) * jnp.concatenate([one, jnp.cumprod(1.0 - u)])
            lp = lp + jnp.sum(jsp.logsumexp(jnp.log(w)
                                            + stats.norm.logpdf(vj[:, None], nu, jnp.exp(r)), 1))
            for loc, logsd in ((mu, s), (nu, r)):
                lp = lp + jnp.sum(jax_gumbel(loc, m, 2.0))
                lp = lp + jnp.sum(jax_inverse_gamma(jnp.exp(2.0 * logsd), 2.0, jnp.exp(c))
                                  + 2.0 * logsd)
            return lp - 0.5 * (jnp.sum(a * a) + jnp.sum(b * b) + m * m + c * c)
        return port, ref, 19
    raise AssertionError(name)


MODELS = ["softmax regression", "multivariate normal", "mixtures"]


@pytest.fixture(scope="module", params=MODELS)
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
