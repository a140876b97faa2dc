"""The port's Pathfinder and PSIS (pathfinder.py) against the JAX package's,
f64 on the CPU, with JAX's noise injected.

JAX's ``jax.random`` streams cannot be reproduced in torch, so the test
replaces the port's four Pathfinder seams by the draws JAX derives for the
same key (pathfinder.py of the JAX package, :156, :172, :427-431, :446,
:475): k_init, k_path, k_pool, k_res = split(key, 4); the start jitter
normal(k_init, (K, n)); path p's key split(k_path, K)[p], and at iteration
it the ELBO normals normal(split(c)[0], (E, n)) of c, that key after it
splits (each split keeps the second half); the pool normal(k_pool, (K, R,
n)); the resample argmax(gumbel(k_res, (n_draws, S)) + logw), which is
``jax.random.categorical``. Statuses, iterations, best_iter, n_fev, n_gev
and the resampled indices are then held to JAX's exactly, and every float
(with H rebuilt from gamma, Q and sig: Q's basis is not unique where
eigenvalues repeat) to 1e-10 normwise relative, or where the port passes
that, to twice JAX's own spread between starts one ulp apart. The
spectral ops, the GPD fit and `psis_smooth` are held to JAX's on the same
inputs (the lockstep line search: test_torch_pathfinder_linesearch.py).
"""

import importlib
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu.api import as_value_and_grad as jax_as_value_and_grad
from quasinewtonmethods_jl_tpu.ops.wolfe import Wolfe as JaxWolfe
from test_torch_sampling_hmc import jax_key, normwise

jpf = importlib.import_module("quasinewtonmethods_jl_tpu.pathfinder")
pf = importlib.import_module("quasinewtonmethods_jl_tpu_torch.pathfinder")

torch.set_num_threads(1)

RTOL = 1e-10
WITNESS_FACTOR = 2
_JAX_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
_ELBO_ITERS = 64  # the longest run a test makes


def _torch(a, dtype):
    return torch.tensor(np.asarray(a)).to(dtype)


def _keys(key):
    return jax.random.split(jax_key(key), 4)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _jax_elbo_draws(key, K, iters, E, n, dtype):
    """(K, iters, E, n): every ELBO draw of K paths over ``iters`` steps."""
    path_keys = jax.random.split(jax.random.split(key, 4)[1], K)

    def per_path(k):
        def body(c, _):
            k_draw, k_next = jax.random.split(c)
            return k_next, jax.random.normal(k_draw, (E, n), dtype)

        return jax.lax.scan(body, k, None, length=iters)[1]

    return jax.vmap(per_path)(path_keys)


_ELBO_CACHE = {}


def jax_init_noise(key, K, n, dtype, device):
    return _torch(jax.random.normal(_keys(key)[0], (K, n), _JAX_DTYPE[dtype]), dtype)


def jax_elbo_noise(key, it, K, E, n, dtype, device):
    cache_key = (tuple(key.tolist()), K, E, n, dtype)
    if cache_key not in _ELBO_CACHE:
        _ELBO_CACHE[cache_key] = np.asarray(
            _jax_elbo_draws(jax_key(key), K, _ELBO_ITERS, E, n, _JAX_DTYPE[dtype]))
    return _torch(_ELBO_CACHE[cache_key][:, it], dtype)


def jax_pool_noise(key, K, R, n, dtype, device):
    return _torch(jax.random.normal(_keys(key)[2], (K, R, n), _JAX_DTYPE[dtype]), dtype)


def jax_resample_noise(key, n_draws, S, dtype, device):
    return _torch(jax.random.gumbel(_keys(key)[3], (n_draws, S), _JAX_DTYPE[dtype]), dtype)


def inject_jax_noise(monkeypatch):
    monkeypatch.setattr(pf, "_pathfinder_init_noise", jax_init_noise)
    monkeypatch.setattr(pf, "_pathfinder_elbo_noise", jax_elbo_noise)
    monkeypatch.setattr(pf, "_pathfinder_pool_noise", jax_pool_noise)
    monkeypatch.setattr(pf, "_pathfinder_resample_noise", jax_resample_noise)


def gaussian_target(n, seed=0):
    """JAX's `_gaussian_target` (tests/test_pathfinder.py) in both packages:
    (jax log-density, torch log-density, mu, cov)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    cov = A @ A.T / n + 0.5 * np.eye(n)
    mu = rng.standard_normal(n)
    P = np.linalg.inv(cov)
    P_j, mu_j = jnp.asarray(P), jnp.asarray(mu)
    P_t, mu_t = torch.tensor(P), torch.tensor(mu)

    def jax_logd(x):
        d = x - mu_j.astype(x.dtype)
        return -0.5 * d @ (P_j.astype(x.dtype) @ d)

    def port_logd(x):
        d = x - mu_t.to(x.dtype)
        return -0.5 * d @ (P_t.to(x.dtype) @ d)

    return jax_logd, port_logd, mu, cov


def nan_wall():
    """tests/test_pathfinder.py:184-201: a NaN wall far from the origin."""

    def jax_logd(x):
        good = -0.5 * jnp.sum(x * x)
        return jnp.where(jnp.max(jnp.abs(x)) > 50.0, jnp.nan, good)

    def port_logd(x):
        good = -0.5 * torch.sum(x * x)
        return torch.where(torch.max(torch.abs(x)) > 50.0, torch.full_like(good, math.nan), good)

    return jax_logd, port_logd


def skewed():
    """A product of Gamma(a, b) on the log scale (tests/test_pathfinder.py
    :128-147)."""
    a, b = np.asarray([4.0, 6.0, 8.0]), np.asarray([1.0, 2.0, 0.5])

    def jax_logd(x):
        return jnp.sum(jnp.asarray(a) * x - jnp.asarray(b) * jnp.exp(x))

    def port_logd(x):
        return torch.sum(torch.tensor(a, dtype=x.dtype) * x - torch.tensor(b, dtype=x.dtype)
                         * torch.exp(x))

    return jax_logd, port_logd, a, b


def dense_H(gamma, Q, sig):
    """(K, n, n) H = γ(I − QQᵀ) + Q diag(σ) Qᵀ of every path, in float64."""
    gamma, Q, sig = (np.asarray(a, np.float64) for a in (gamma, Q, sig))
    n = Q.shape[-2]
    return (gamma[:, None, None] * (np.eye(n) - Q @ np.swapaxes(Q, -1, -2))
            + (Q * sig[:, None, :]) @ np.swapaxes(Q, -1, -2))


def resampled_indices(res):
    """The pool row each draw is (exact row equality)."""
    pool, draws = np.asarray(res.pool), np.asarray(res.draws)
    eq = np.all(draws[:, None, :] == pool[None, :, :], axis=-1)
    assert eq.any(axis=1).all()
    return np.argmax(eq, axis=1)


EXACT_FIELDS = ("status", "iterations", "best_iter", "n_fev", "n_gev")
FLOAT_FIELDS = ("draws", "khat", "elbo", "mu", "gamma", "sig", "pool", "pool_logw",
                "logp_draws")


def float_errors(port, ref):
    errors = {}
    for field in FLOAT_FIELDS:
        a, b = np.asarray(getattr(port, field), np.float64), np.asarray(getattr(ref, field),
                                                                          np.float64)
        assert a.shape == b.shape, field
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=field)
        np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=field)  # -inf stays -inf
        errors[field] = normwise(a[fin], b[fin])
    errors["H"] = normwise(dense_H(port.gamma, port.Q, port.sig), dense_H(ref.gamma, ref.Q, ref.sig))
    return errors


TIE_ULPS = 4


def compare_pathfinder(port, ref, witness, traces):
    """Counters, statuses and resampled indices exactly; floats to RTOL or
    twice the witness spread (``witness()`` gives JAX's own one-ulp
    spread). ``best_iter`` exactly too, except on a path whose two
    iterates' ELBOs tie within TIE_ULPS ulps in JAX's own trace
    (``traces()`` gives it): there the running argmax is decided by
    rounding in either package (ROADMAP.md C.7), and the floats of the
    two Gaussians agree all the same."""
    for field in EXACT_FIELDS:
        a, b = getattr(port, field), np.asarray(getattr(ref, field))
        assert a.dtype == torch.int32, field
        if field != "best_iter":
            np.testing.assert_array_equal(a.numpy(), b, err_msg=field)
    mine, theirs = port.best_iter.numpy(), np.asarray(ref.best_iter)
    flipped = np.flatnonzero(mine != theirs)
    if flipped.size:
        trace = traces()
        for p in flipped:
            assert mine[p] >= 0 and theirs[p] >= 0, (p, mine[p], theirs[p])
            a, b = trace[p, mine[p]], trace[p, theirs[p]]
            assert abs(a - b) <= TIE_ULPS * np.spacing(abs(b)), (p, a, b)
    np.testing.assert_array_equal(resampled_indices(port), resampled_indices(ref))
    assert port.draws.dtype == port.pool.dtype == getattr(torch, str(ref.draws.dtype))
    errors = float_errors(port, ref)
    worst = max(errors.values())
    if worst <= RTOL:
        return
    spread = witness()
    bad = {k: v for k, v in errors.items() if v > max(RTOL, WITNESS_FACTOR * spread)}
    assert not bad, f"port against JAX {bad}, JAX's one-ulp witness spread {spread:.3e}"


def jax_traces_of(jl, key, x0, kw, jax_ls):
    """JAX's effective ELBO trace (K, max_iters) of every path: the values
    its running argmax compared (its `_single_path`, started as
    `_pathfinder_jit` starts it)."""

    def traces():
        opts = dict(n_paths=8, history=8, max_iters=64, elbo_draws=16, tol=1e-5,
                    init_scale=2.0)
        opts.update({k: v for k, v in kw.items() if k in opts})
        k_init, k_path, _k_pool, _k_res = jax.random.split(jax.random.PRNGKey(key), 4)
        x = jnp.asarray(x0)
        if x.ndim == 1:
            x = x[None, :] + opts["init_scale"] * jax.random.normal(
                k_init, (opts["n_paths"], x.shape[0]), x.dtype)
        vag = jax_as_value_and_grad(jl)

        def run(x1, k):
            return jpf._single_path(vag, jl, x1, k, opts["history"], opts["max_iters"],
                                    opts["elbo_draws"], jax_ls or qj.BackTracking(), opts["tol"])

        _best, diag = jax.vmap(run)(x, jax.random.split(k_path, x.shape[0]))
        return np.asarray(diag["elbo_trace"])

    return traces


def witness_of(jax_run, x0, ref):
    """JAX's own spread (max normwise over the float fields) between runs
    from x0 one ulp up and one ulp down."""

    def witness():
        spreads = []
        for direction in (np.inf, -np.inf):
            w = jax_run(np.nextafter(x0, direction).astype(x0.dtype))
            spreads.append(max(float_errors(w, ref).values()))
        return max(spreads)

    return witness


# ---------------------------------------------------------------------------
# spectral-form Gaussian ops, the GPD fit and PSIS against JAX's


def _spectral(rng, n, r, batch=()):
    Q = np.linalg.qr(rng.standard_normal(batch + (n, r)))[0]
    return np.exp(rng.standard_normal(batch)), Q, np.exp(rng.standard_normal(batch + (r,)))


def test_spectral_ops_match_jax_one_gaussian_and_batched():
    rng = np.random.default_rng(0)
    n, r, K, m = 12, 6, 3, 5
    gamma, Q, sig = _spectral(rng, n, r, (K,))
    mu = rng.standard_normal((K, n))
    xi = rng.standard_normal((K, m, n))
    z = rng.standard_normal((m, n))
    t = [torch.tensor(a) for a in (gamma, Q, sig, mu, xi, z)]
    tg, tQ, ts, tmu, txi, tz = t
    ld = pf._logdet_H(tg, ts, n)
    sqrt_b = pf._apply_sqrt_H(tg, tQ, ts, txi)
    H_b = pf._apply_H(tg, tQ, ts, txi)
    logq_shared = pf._log_q(tg, tQ, ts, ld, tmu, tz)  # (K, m): z under every Gaussian
    logq_own = pf._log_q(tg, tQ, ts, ld, tmu, txi)  # (K, m): each its own points
    for k in range(K):
        args = (jnp.asarray(gamma[k]), jnp.asarray(Q[k]), jnp.asarray(sig[k]))
        jld = jpf._logdet_H(args[0], args[2], n)
        np.testing.assert_allclose(ld[k].numpy(), np.asarray(jld), rtol=1e-13)
        np.testing.assert_allclose(sqrt_b[k].numpy(), np.asarray(jpf._apply_sqrt_H(*args, xi[k])),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(H_b[k].numpy(), np.asarray(jpf._apply_H(*args, xi[k])),
                                   rtol=1e-12, atol=1e-14)
        # one Gaussian, one vector: the (n,) case is an (1, n) point set
        one = pf._apply_H(tg[k], tQ[k], ts[k], txi[k, :1])[0]
        np.testing.assert_allclose(one.numpy(), np.asarray(jpf._apply_H(*args, xi[k, 0])),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(
            logq_shared[k].numpy(),
            np.asarray(jpf._log_q(args[0], args[1], args[2], jld, jnp.asarray(mu[k]),
                                  jnp.asarray(z))), rtol=1e-12)
        np.testing.assert_allclose(
            logq_own[k].numpy(),
            np.asarray(jpf._log_q(args[0], args[1], args[2], jld, jnp.asarray(mu[k]),
                                  jnp.asarray(xi[k]))), rtol=1e-12)
    # and against dense linear algebra, as JAX's own test holds its ops
    H = dense_H(gamma, Q, sig)
    np.testing.assert_allclose(pf._apply_sqrt_H(tg, tQ, ts, sqrt_b).numpy(),
                               np.einsum("kij,kmj->kmi", H, xi), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ld.numpy(), np.linalg.slogdet(H)[1], rtol=1e-10)


@pytest.mark.parametrize("k_true", [0.2, 0.5, 0.9])
def test_gpd_fit_matches_jax_and_recovers_k(k_true):
    rng = np.random.default_rng(42)
    u = rng.uniform(size=4000)
    sigma = 1.3
    x = np.sort(sigma / k_true * ((1 - u) ** (-k_true) - 1))
    khat, sig_hat = pf.gpd_fit_khat(torch.tensor(x))
    j_khat, j_sig = jpf.gpd_fit_khat(jnp.asarray(x))
    np.testing.assert_allclose(float(khat), float(j_khat), rtol=1e-12)
    np.testing.assert_allclose(float(sig_hat), float(j_sig), rtol=1e-12)
    assert abs(float(khat) - k_true) < 0.08
    assert abs(float(sig_hat) - sigma) / sigma < 0.15
    # a batch of rows is a fit per row
    rows = torch.tensor(np.stack([x, 2.0 * x]))
    kb, sb = pf.gpd_fit_khat(rows)
    np.testing.assert_array_equal(kb[0].numpy(), khat.numpy())
    np.testing.assert_allclose(float(kb[1]), float(jpf.gpd_fit_khat(jnp.asarray(2.0 * x))[0]),
                               rtol=1e-12)


def _psis_inputs():
    rng = np.random.default_rng(0)
    heavy = rng.standard_normal(500) + 3.0 * np.log(rng.pareto(1.2, 500) + 1.0)
    tied = np.zeros(200)
    tied[[3, 77]] = 1.0
    with_inf = rng.standard_normal(300)
    with_inf[::7] = -np.inf
    with_nan = rng.standard_normal(100)
    with_nan[42] = np.nan
    small = rng.standard_normal(6)
    return {"normal": rng.standard_normal(500), "heavy": heavy, "tied": tied,
            "minus_inf": with_inf, "nan": with_nan, "small": small,
            "constant": np.full(64, 2.5)}


@pytest.mark.parametrize("case", sorted(_psis_inputs()))
def test_psis_smooth_matches_jax(case):
    logw = _psis_inputs()[case]
    out, khat = qt.psis_smooth(torch.tensor(logw))
    j_out, j_khat = qj.psis_smooth(jnp.asarray(logw))
    j_out, j_khat = np.asarray(j_out), float(j_khat)
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(j_out))
    np.testing.assert_allclose(out.numpy(), j_out, rtol=1e-12, atol=0.0)
    if np.isfinite(j_khat):
        np.testing.assert_allclose(float(khat), j_khat, rtol=1e-12)
    else:
        assert float(khat) == j_khat
    if case in ("tied", "constant", "nan"):
        assert float(khat) == -math.inf  # a degenerate tail is left as it was
    if case == "heavy":
        assert float(khat) > 0.7


def test_psis_rows_equal_one_row_at_a_time():
    inputs = _psis_inputs()
    rows = torch.tensor(np.stack([inputs["heavy"], inputs["normal"]]))
    out, khat = pf._psis_smooth_rows(rows)
    for i in range(2):
        o, k = qt.psis_smooth(rows[i])
        np.testing.assert_array_equal(out[i].numpy(), o.numpy())
        assert float(khat[i]) == float(k)


def test_psis_smooth_preserves_bulk_and_bounds_tail():
    """tests/test_pathfinder.py:87-103 on the port."""
    rng = np.random.default_rng(0)
    logw = rng.standard_normal(500)
    out, khat = qt.psis_smooth(torch.tensor(logw))
    S = 500
    M = int(math.ceil(min(0.2 * S, 3 * math.sqrt(S))))
    bulk = np.argsort(logw)[: S - M]
    np.testing.assert_allclose(out.numpy()[bulk], logw[bulk])
    assert float(out.max()) <= float(logw.max()) + 1e-12
    assert np.isfinite(out.numpy()).all()
    assert float(khat) < 0.7


# ---------------------------------------------------------------------------
# whole runs against JAX's with JAX's noise


def _case_gaussian():
    jl, tl, _mu, _cov = gaussian_target(6, seed=0)
    return jl, tl, np.full(6, 0.3), dict(n_paths=3, n_draws=200, max_iters=30)


def _case_nan_wall():
    jl, tl = nan_wall()
    x0s = np.stack([np.zeros(4), np.full(4, 1e3), 0.5 * np.ones(4)])
    return jl, tl, x0s, dict(n_draws=500, max_iters=30)


def _case_rank2():
    jl, tl, _mu, _cov = gaussian_target(5, seed=4)
    x0s = np.random.default_rng(5).standard_normal((4, 5))
    return jl, tl, x0s, dict(n_draws=120, max_iters=20, history=3, elbo_draws=8)


def _case_order3():
    jl, tl, _a, _b = skewed()
    return jl, tl, np.full(3, 0.1), dict(n_paths=2, n_draws=150, max_iters=25,
                                          ls=("bt", 3), init_scale=1.0)


def _case_wolfe():
    jl, tl, _mu, _cov = gaussian_target(8, seed=2)
    return jl, tl, np.full(8, -0.2), dict(n_paths=2, n_draws=100, max_iters=40, ls=("wolfe",))


def _case_f32():
    jl, tl, _mu, _cov = gaussian_target(5, seed=3)
    return jl, tl, np.full(5, 0.25, np.float32), dict(n_paths=2, n_draws=128, max_iters=20)


CASES = {"gaussian": _case_gaussian, "nan_wall": _case_nan_wall, "rank2": _case_rank2,
         "order3": _case_order3, "wolfe": _case_wolfe, "f32": _case_f32}


def _line_searches(spec):
    if spec is None:
        return {}
    if spec[0] == "bt":
        return {"port": qt.BackTracking(order=spec[1]), "jax": qj.BackTracking(order=spec[1])}
    return {"port": qt.Wolfe(), "jax": JaxWolfe()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pathfinder_matches_jax_with_jax_noise(monkeypatch, case):
    inject_jax_noise(monkeypatch)
    jl, tl, x0, kw = CASES[case]()
    ls = _line_searches(kw.pop("ls", None))
    key = 7

    def jax_run(x):
        extra = {"ls": ls["jax"]} if ls else {}
        return qj.pathfinder(jl, jax.random.PRNGKey(key), jnp.asarray(x), **kw, **extra)

    ref = jax_run(x0)
    qt.pathfinder.host_syncs = qt.pathfinder.gradient_evals = 0
    extra = {"ls": ls["port"]} if ls else {}
    port = qt.pathfinder(tl, key, torch.tensor(x0), **kw, **extra)
    assert qt.pathfinder.host_syncs > 0 and qt.pathfinder.gradient_evals > 0
    compare_pathfinder(port, ref, witness_of(jax_run, x0, ref),
                       jax_traces_of(jl, key, x0, kw, ls.get("jax")))
    if case == "nan_wall":
        assert int(port.status[1]) == int(qt.Status.NONFINITE_VALUE)
        assert int(port.best_iter[1]) == -1 and float(port.elbo[1]) == -math.inf
