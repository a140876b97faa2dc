"""The port's annealed importance sampling and adaptive tempered SMC (ais.py)
against the JAX package's, f64 on the CPU.

Every parity run injects JAX's own draws through the port's two seams:
`_ais_init_noise` gets JAX's ``k_init`` normals and `_ais_rung_noise` rung
t's ``k1`` normals, ``k2`` uniforms and ``k3`` uniform (``k_init, k_anneal
= split(key)``, ``k1, k2, k3 = split(fold_in(k_anneal, t), 3)``). The
step size is dual-averaged on the fleet-mean acceptance, which amplifies
the packages' one-ulp differences (summation order, exp and log) rung by
rung, so logZ, logw, ess, final_x, the acceptance and the step size agree
to 1e-10 normwise relative or to twice JAX's own spread between runs from
a base covariance moved by one ulp (its rounding witnesses). -inf weights sit
on the same particles. n_rungs, n_resamples and the ladder are equal
exactly, and so are the systematic resampler's picks on the same weights
and uniform. Then JAX's statistical tests (tests/test_ais.py) with the
port's own noise, the error paths with JAX's messages, the device rule
and the counters.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu import ais as jax_ais
from quasinewtonmethods_jl_tpu_torch import ais
from quasinewtonmethods_jl_tpu_torch.models import GaussianMixture
from test_torch_sampling_hmc import RTOL, WITNESS_FACTOR, jax_key, normwise

torch.set_num_threads(1)

_LOG_2PI = math.log(2.0 * math.pi)
JAX_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}


@functools.lru_cache(maxsize=None)
def _jax_draws(N, n, jd):
    def init(raw):
        return jax.random.normal(jax.random.split(raw)[0], (N, n), jd)

    def rung(raw, t):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(jax.random.split(raw)[1], t), 3)
        return (jax.random.normal(k1, (N, n), jd), jax.random.uniform(k2, (N,), jd),
                jax.random.uniform(k3, (), jd))

    return jax.jit(init), jax.jit(rung)


def jax_init_noise(key, N, n, dtype, device):
    """JAX `_ais_core`'s base draw (ais.py:280-281)."""
    return torch.tensor(np.asarray(_jax_draws(N, n, JAX_DTYPE[dtype])[0](jax_key(key))))


def jax_rung_noise(key, t, N, n, dtype, device):
    """JAX's draws of rung t (ais.py:299-300, :467-468)."""
    draws = _jax_draws(N, n, JAX_DTYPE[dtype])[1](jax_key(key), t)
    return tuple(torch.tensor(np.asarray(a)) for a in draws)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(ais, "_ais_init_noise", jax_init_noise)
    monkeypatch.setattr(ais, "_ais_rung_noise", jax_rung_noise)


def pair(w, shift=0.0, barrier=None):
    """(jax_f, port_f): -0.5 Σ w (x − shift)², optionally -inf outside
    |x| < barrier (tests/test_ais.py:126-129)."""
    w = np.asarray(w, np.float64)

    def jax_f(x):
        v = -0.5 * jnp.sum(jnp.asarray(w) * (x - shift) ** 2)
        return v if barrier is None else jnp.where(jnp.all(jnp.abs(x) < barrier), v, -jnp.inf)

    def port_f(x):
        v = -0.5 * torch.sum(torch.tensor(w) * (x - shift) ** 2)
        if barrier is None:
            return v
        return torch.where(torch.all(torch.abs(x) < barrier), v, torch.full_like(v, -math.inf))

    return jax_f, port_f


def dense_cov(n, seed=0):
    A = np.random.default_rng(seed).standard_normal((n, n)) * 0.3
    return A @ A.T + np.eye(n)


OFFSET = pair([1.0, 4.0, 0.25], shift=1.0)
DISPLACED4, DISPLACED2 = pair(np.ones(4), shift=5.0), pair(np.ones(2), shift=5.0)
EXACT = pair([1.0, 4.0, 0.25, 2.0])
EXACT_BASE = (np.zeros(4), np.array([1.0, 0.25, 4.0, 0.5]))
FIXED = {"n_particles": 64, "n_steps": 24, "n_leapfrog": 4}
DISPLACED = {"n_particles": 128, "n_steps": 24, "n_leapfrog": 4}

# name: ((jax_f, port_f), (mu, cov), kwargs)
CASES = {
    "diag_linear": (OFFSET, (np.zeros(3), np.array([1.0, 0.5, 2.0])), FIXED),
    "dense_linear": (OFFSET, (np.zeros(3), dense_cov(3)), FIXED),
    "dense_power2": (OFFSET, (np.zeros(3), dense_cov(3)), {**FIXED, "schedule": 2.0}),
    "explicit_array": (OFFSET, (np.zeros(3), dense_cov(3)),
                       {**FIXED, "n_steps": 8, "schedule": np.linspace(0.0, 1.0, 9) ** 3}),
    "dense_not_positive_definite": (OFFSET, (np.zeros(3), -dense_cov(3)), FIXED),
    "resample": (DISPLACED4, (np.zeros(4), np.ones(4)), {**DISPLACED, "resample": True}),
    "resample_dense": (DISPLACED4, (np.zeros(4), dense_cov(4)), {**DISPLACED, "resample": True}),
    "nonfinite": (pair([1.0, 1.0], barrier=3.0), (np.zeros(2), np.full(2, 4.0)),
                  {"n_particles": 64, "n_steps": 16, "n_leapfrog": 4}),
    "adaptive_resample": (DISPLACED4, (np.zeros(4), np.ones(4)),
                          {**DISPLACED, "n_steps": 32, "schedule": "adaptive",
                           "resample": True}),
    "adaptive_cess": (DISPLACED4, (np.zeros(4), dense_cov(4)),
                      {**DISPLACED, "n_steps": 32, "schedule": "adaptive"}),
    "adaptive_exact_one_jump": (EXACT, EXACT_BASE,
                                {"n_particles": 64, "n_steps": 32, "n_leapfrog": 2,
                                 "schedule": "adaptive"}),
    "adaptive_floor": (DISPLACED2, (np.zeros(2), np.ones(2)),
                       {"n_particles": 64, "n_steps": 8, "n_leapfrog": 2,
                        "schedule": "adaptive", "adapt_target": 0.999}),
}

FLOATS = ("logZ", "logw", "ess", "accept_rate", "step_size", "final_x")


def float_errors(port, ref):
    """Normwise errors of the float fields; non-finite entries (a -inf
    weight) must sit at the same places with the same values."""
    errors = {}
    for f in FLOATS:
        a, b = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=f)
        np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=f)
        errors[f] = normwise(a[fin], b[fin])
    return errors


def compare(port, ref, witness):
    for f in ("n_rungs", "n_resamples"):
        assert getattr(port, f).dtype == torch.int32, f
        assert int(getattr(port, f)) == int(getattr(ref, f)), f
    np.testing.assert_array_equal(port.betas.numpy(), np.asarray(ref.betas))
    errors = float_errors(port, ref)
    if max(errors.values()) <= RTOL:
        return
    spread = witness()
    bad = {k: v for k, v in errors.items() if v > max(RTOL, WITNESS_FACTOR * spread)}
    assert not bad, f"port against JAX {bad}, JAX's one-ulp witness spread {spread:.3e}"


def jax_run(jax_f, base, kw, key=5):
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return qj.ais_evidence(jax_f, jax.random.PRNGKey(key), tuple(jnp.asarray(b) for b in base),
                           **kw)


def witness_of(jax_f, mu, cov, kw, ref):
    """JAX's largest float difference between its run and its runs from the
    base covariance moved one ulp up and down (the means are mostly 0)."""
    def spread():
        runs = [jax_run(jax_f, (mu, np.nextafter(cov, d)), kw) for d in (np.inf, -np.inf)]
        return max(max(float_errors(r_to_torch(w), ref).values()) for w in runs)
    return spread


def r_to_torch(res):
    return type(res)(*(torch.tensor(np.asarray(leaf)) for leaf in res))


@pytest.fixture(scope="module")
def jax_results():
    """JAX's run of each case, computed once for the module."""
    cache = {}

    def get(case):
        if case not in cache:
            (jax_f, _), base, kw = CASES[case]
            cache[case] = jax_run(jax_f, base, kw)
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_ais_equals_jax_with_jax_noise(jax_noise, jax_results, case):
    (jax_f, port_f), (mu, cov), kw = CASES[case]
    syncs, grads = qt.ais_evidence.host_syncs, qt.ais_evidence.gradient_evals
    port = qt.ais_evidence(port_f, 5, (torch.tensor(mu), torch.tensor(cov)),
                           **{k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
                              for k, v in kw.items()})
    ref = jax_results(case)
    compare(port, ref, witness_of(jax_f, mu, cov, kw, ref))
    rungs, cap = int(port.n_rungs), kw["n_steps"]
    assert qt.ais_evidence.gradient_evals - grads == rungs * (kw["n_leapfrog"] + 1)
    if isinstance(kw.get("schedule"), str):
        # b < 1 read before every rung but the first, and once more when
        # the anneal ends before the cap
        assert qt.ais_evidence.host_syncs - syncs == rungs - 1 + (rungs < cap)
    else:
        assert qt.ais_evidence.host_syncs == syncs and rungs == cap
    if case.startswith("resample"):
        assert int(port.n_resamples) > 0
    if case == "adaptive_exact_one_jump":
        assert rungs == 1
    if case == "adaptive_floor":
        assert rungs == cap
    if case in ("adaptive_resample", "adaptive_cess"):
        assert 1 < rungs < cap
    if case == "dense_not_positive_definite":  # NaN Cholesky, no raise
        assert np.isnan(port.final_x.numpy()).all() and np.isneginf(float(port.logZ))
    if case == "nonfinite":
        assert np.isneginf(port.logw.numpy()).any() and np.isfinite(float(port.logZ))


@pytest.mark.parametrize("batched", [False, True], ids=["scalar", "fleet"])
def test_ais_from_solve_results_equals_jax(jax_noise, batched):
    """A scalar BFGS result (its x and B) and a fleet (the best converged
    lane's mode, the converged-lane-averaged B) as the base, each solved
    by its own package on the same starts; the fleet's any-converged test
    is one counted read."""
    jax_f, port_f = pair([1.0, 2.0])
    x0 = np.random.default_rng(2).standard_normal((16, 2) if batched else (2,))
    solve = "optimize_batched" if batched else "optimize"
    port_sol = getattr(qt, solve)(port_f, torch.tensor(x0))
    jax_sol = getattr(qj, solve)(jax_f, jnp.asarray(x0))
    kw = {"n_particles": 64, "n_steps": 8, "n_leapfrog": 4}
    syncs = qt.ais_evidence.host_syncs
    port = qt.ais_evidence(port_f, 3, port_sol, **kw)
    assert qt.ais_evidence.host_syncs - syncs == int(batched)
    ref = qj.ais_evidence(jax_f, jax.random.PRNGKey(3), jax_sol, **kw)
    mu, cov = (np.asarray(a) for a in jax_ais._base_from(jax_sol, jnp.float64))
    mine = ais._base_from(port_sol, torch.float64, torch.device("cpu"), qt.ais_evidence)
    np.testing.assert_allclose(mine[0].numpy(), mu, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(mine[1].numpy(), cov, rtol=1e-10, atol=1e-12)
    compare(port, ref, witness_of(jax_f, mu, cov, kw, ref))


def test_systematic_resample_picks_jax_particles():
    """The resampler's picks on the same weights and uniform (ties, -inf
    weights, one dominant particle): the gathered particles equal JAX's."""
    rng = np.random.default_rng(7)
    N = 64
    x = rng.standard_normal((N, 3))
    q0x, px = rng.standard_normal(N), rng.standard_normal(N)
    for trial in range(6):
        logw = rng.standard_normal(N) * (0.5 + trial)
        if trial >= 2:
            logw[rng.integers(0, N, 8)] = -np.inf
        if trial >= 4:
            logw[:16] = logw[0]
        k = jax.random.PRNGKey(trial)
        u0 = float(jax.random.uniform(k, (), jnp.float64))
        ref = jax_ais._systematic_resample(jnp.asarray(logw), jnp.asarray(x), jnp.asarray(q0x),
                                           jnp.asarray(px), k, N, jnp.float64)
        mine = ais._systematic_resample(torch.tensor(logw), torch.tensor(x), torch.tensor(q0x),
                                        torch.tensor(px), torch.tensor(u0))
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("T", [24, 96])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_linear_ladder_equals_jax_linspace(T, dtype):
    """JAX's ``linspace(0, 1, T+1)`` on the CPU, bit for bit, and so the
    fixed ladders of powers 1 and 2 (float32 as JAX with x64 off)."""
    mine = ais._linear_ladder(T, dtype, "cpu")
    assert mine.dtype == dtype
    with jax.enable_x64(dtype == torch.float64):
        jd = JAX_DTYPE[dtype]
        for p in (1.0, 2.0):
            ref = np.asarray(jnp.linspace(0.0, 1.0, T + 1, dtype=jd) ** p)
            np.testing.assert_array_equal((mine ** p).numpy(), ref)
    # torch's own linspace differs from it on some rungs
    assert not np.array_equal(torch.linspace(0, 1, T + 1, dtype=dtype).numpy(),
                              mine.numpy()) or (T, dtype) == (24, torch.float64)


def _errors(fn):
    with pytest.raises((TypeError, ValueError)) as e:
        fn()
    return type(e.value), str(e.value)


def test_error_paths_keep_jax_text():
    """tests/test_ais.py:100-120, :161 and :229, and the solve results
    without a dense B or a converged lane, raised with JAX's type and
    text."""
    jf, pf = pair([1.0, 1.0])
    jf30, pf30 = pair([1.0, 30.0])  # no lane converges in one iteration
    jbase, pbase = (jnp.zeros(2), jnp.ones(2)), (torch.zeros(2, dtype=torch.float64),
                                                 torch.ones(2, dtype=torch.float64))
    x0 = np.array([0.5, -0.3])
    cases = [
        ({"n_steps": 4, "schedule": np.linspace(0, 1, 4)}, None),
        ({"schedule": -1.0}, None),
        ({"n_steps": 0}, None),
        ({"resample": True, "resample_threshold": 1.5}, None),
        ({"schedule": "adaptive", "adapt_target": 1.5}, None),
        ({"schedule": "geometric"}, None),
        ({}, (3.0, 3.0)),
        ({}, (qj.optimize_lbfgs(jf, jnp.asarray(x0)), qt.optimize_lbfgs(pf, torch.tensor(x0)))),
        ({}, (qj.optimize_cg(jf, jnp.asarray(x0)), qt.optimize_cg(pf, torch.tensor(x0)))),
        ({}, (qj.optimize_batched(jf30, jnp.asarray(np.tile(x0, (4, 1))), max_iterations=1),
              qt.optimize_batched(pf30, torch.tensor(np.tile(x0, (4, 1))), max_iterations=1))),
    ]
    for kw, bases in cases:
        jb, pb = bases if bases is not None else (jbase, pbase)
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        pkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        theirs = _errors(lambda: qj.ais_evidence(jf, jax.random.PRNGKey(0), jb, **jkw))
        mine = _errors(lambda: qt.ais_evidence(pf, 0, pb, **pkw))
        assert mine == theirs, kw


def test_numpy_base_goes_to_the_card_and_tensors_stay(monkeypatch):
    """A numpy (mu, cov) follows the entry points' device rule (the card;
    without one their error); CPU tensors keep their device and dtype."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
        qt.ais_evidence(lambda x: -torch.sum(x * x), 0, (np.zeros(2), np.ones(2)))
    for dtype in (torch.float32, torch.float64):
        res = qt.ais_evidence(lambda x: -torch.sum(x * x), 0,
                              (torch.zeros(2, dtype=dtype), np.ones(2)), n_particles=8,
                              n_steps=2, n_leapfrog=1)
        assert all(leaf.device.type == "cpu" for leaf in res)
        assert res.logw.dtype == res.betas.dtype == res.final_x.dtype == dtype


def _gaussian_target(a):
    a = np.asarray(a)
    logz = 0.5 * len(a) * _LOG_2PI - 0.5 * float(np.sum(np.log(a)))
    return (lambda x: -0.5 * torch.sum(torch.tensor(a) * x * x)), logz


@pytest.mark.parametrize("schedule", [1.0, "adaptive"])
def test_exact_base_is_exact(schedule):
    """tests/test_ais.py:34 and :168 with the port's noise: with the exact
    base every weight is the constant log Z."""
    ld, logz = _gaussian_target([1.0, 4.0, 0.25, 2.0])
    res = qt.ais_evidence(ld, 0, tuple(torch.tensor(b) for b in EXACT_BASE), n_particles=64,
                          n_steps=4 if schedule == 1.0 else 32, n_leapfrog=4, schedule=schedule)
    np.testing.assert_allclose(float(res.logZ), logz, atol=1e-8)
    np.testing.assert_allclose(float(res.ess), 64.0, rtol=1e-6)
    if schedule == "adaptive":
        assert int(res.n_rungs) == 1
        np.testing.assert_allclose(res.betas.numpy()[1:], 1.0)
        assert np.all(res.accept_rate.numpy()[1:] == 0.0)


def test_repairs_laplace_multimodal_bias():
    """tests/test_ais.py:76 with the port's noise: Laplace at the heavy
    mode misses the light basin (bias ≈ log 0.75); AIS from a covering
    base lands on the true log Z."""
    mix = GaussianMixture(means=[[4.0, 4.0], [-4.0, -4.0]], weights=[0.75, 0.25], sigmas=1.0,
                          dtype=torch.float64)
    logz_true = 0.5 * 2 * _LOG_2PI
    sol = qt.optimize(mix.logdensity, torch.tensor([3.5, 4.5], dtype=torch.float64))
    lz_lap = float(qt.laplace_evidence(sol, obj=mix.logdensity))
    assert 0.2 < logz_true - lz_lap < 0.4
    res = qt.ais_evidence(mix.logdensity, 4, (torch.zeros(2, dtype=torch.float64),
                                              torch.full((2,), 25.0, dtype=torch.float64)),
                          n_particles=2048, n_steps=96, n_leapfrog=8, schedule=2.0)
    assert abs(float(res.logZ) - logz_true) < 0.1
    assert abs(float(res.logZ) - logz_true) < abs(lz_lap - logz_true)


def test_resampling_and_adaptive_on_a_displaced_target():
    """tests/test_ais.py:139, :185 and :262 with the port's noise: the mode
    5 sd from the base. Resampling fires and keeps the estimate; the
    adaptive ladders are monotone, end at 1 and, without resampling, are
    not linear. JAX calls the CESS run's accuracy a mechanism check, not a
    bar (weight degeneracy biases it): over keys 0-11 its error reached
    1.70 in JAX and 2.18 in the port (the port's keys 0-11 of this plan),
    more than its 1.0 at key 11, so the bar here is 3.0; the resampling
    runs' errors stayed under 0.2 in the port over the same keys."""
    n = 4
    logz_true = 0.5 * n * _LOG_2PI

    def ld(x):
        return -0.5 * torch.sum((x - 5.0) ** 2)

    base = (torch.zeros(n, dtype=torch.float64), torch.ones(n, dtype=torch.float64))
    kw = {"n_particles": 512, "n_steps": 24, "n_leapfrog": 4}
    plain = qt.ais_evidence(ld, 7, base, **kw)
    smc = qt.ais_evidence(ld, 7, base, resample=True, **kw)
    assert int(smc.n_resamples) > 0 and int(plain.n_resamples) == 0
    assert abs(float(smc.logZ) - logz_true) < 0.3
    assert float(smc.ess) > float(plain.ess)
    for resample, limit in ((True, 0.3), (False, 3.0)):
        res = qt.ais_evidence(ld, 11, base, n_particles=512, n_steps=64, n_leapfrog=4,
                              schedule="adaptive", resample=resample)
        t = int(res.n_rungs)
        betas = res.betas.numpy()
        db = np.diff(betas[: t + 1])
        assert 1 < t < (64 if resample else 32) and betas[0] == 0.0 and np.all(db > 0)
        np.testing.assert_allclose(betas[t:], 1.0)
        assert abs(float(res.logZ) - logz_true) < limit
        if resample:
            assert float(res.ess) > 0.25 * 512
        else:
            assert db.max() > 2.0 * db.min()


def test_float32_runs_in_float32():
    """tests/test_ais.py:240 and :252: float32 bases give float32 results."""
    for kw in ({"n_steps": 16, "schedule": "adaptive", "resample": True}, {"n_steps": 4}):
        res = qt.ais_evidence(lambda x: -0.5 * torch.sum((x - 2.0) ** 2), 1,
                              (torch.zeros(3), torch.ones(3)), n_particles=64, n_leapfrog=2,
                              **kw)
        assert res.logw.dtype == res.betas.dtype == torch.float32
        assert np.isfinite(float(res.logZ))
