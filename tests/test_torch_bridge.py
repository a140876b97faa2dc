"""The port's bridge sampling (bridge.py) against the JAX package's, f64 on
the CPU.

Every parity run injects JAX's proposal normals (``normal(key, (n2, n))``,
bridge.py:82-97) through the port's seam `_bridge_noise`, and both
packages read the same posterior draws (numpy). logZ, delta and re2 agree
to 1e-10 normwise relative or to twice JAX's own spread between runs from
draws moved by one ulp (delta, the last update of a converged fixed
point, is ~1e-11 and carries the ulps of r: its error is taken relative
to |logZ|), and n_iter is equal exactly,
whether the fixed point converges or stops at ``max_iter``. The port reads
its stop test once every 8 bodies, which the counter pins. Then JAX's
statistical tests (tests/test_bridge.py) with the port's own noise and
draws, the validation with JAX's messages and the device rule.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch import bridge
from quasinewtonmethods_jl_tpu_torch.models import GaussianMixture
from test_torch_ais import dense_cov, pair
from test_torch_sampling_hmc import RTOL, WITNESS_FACTOR, jax_key, normwise

torch.set_num_threads(1)

_LOG_2PI = math.log(2.0 * math.pi)


def jax_bridge_noise(key, n2, n, dtype, device):
    """JAX `_bridge_core`'s proposal normals (bridge.py:82-97)."""
    return torch.tensor(np.asarray(jax.random.normal(jax_key(key), (n2, n), jnp.float64)))


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(bridge, "_bridge_noise", jax_bridge_noise)


def gamma_pair():
    """Gamma(3, 2)'s unnormalized log density, -inf off its support
    (tests/test_bridge.py:146-149)."""
    def jax_f(x):
        return jnp.where(x[0] > 0, 2.0 * jnp.log(jnp.abs(x[0])) - 2.0 * x[0], -jnp.inf)

    def port_f(x):
        return torch.where(x[0] > 0, 2.0 * torch.log(torch.abs(x[0])) - 2.0 * x[0],
                           torch.full_like(x[0], -math.inf))

    return jax_f, port_f


def _draws():
    rng = np.random.default_rng(3)
    cov = dense_cov(3, seed=1)
    return {
        "gauss2": rng.standard_normal((256, 2)) * np.array([1.0, 1.0 / np.sqrt(2.0)]),
        "corr3": rng.multivariate_normal(np.zeros(3), cov, 512),
        "gauss2_3d": rng.standard_normal((64, 8, 2)) * np.array([1.0, 1.0 / np.sqrt(2.0)]),
        "gamma": rng.gamma(3.0, 0.5, (1024, 1)),
    }, cov


def corr_pair(cov):
    """(jax_f, port_f): the zero-mean Gaussian of covariance ``cov``."""
    prec = np.linalg.inv(cov)
    prec_j, prec_t = jnp.asarray(prec), torch.tensor(prec)
    return (lambda x: -0.5 * x @ (prec_j @ x)), (lambda x: -0.5 * x @ (prec_t @ x))


DRAWS, COV3 = _draws()
GAUSS2, CORR3 = pair([1.0, 2.0]), corr_pair(COV3)

# name: ((jax_f, port_f), draws, (mu, cov), kwargs)
CASES = {
    "diag": (GAUSS2, "gauss2", (np.zeros(2), np.array([1.2, 0.4])), {}),
    "dense": (CORR3, "corr3", (np.zeros(3), COV3 * 1.3), {}),
    "draws_3d": (GAUSS2, "gauss2_3d", (np.zeros(2), np.ones(2)), {}),
    "n_proposal": (GAUSS2, "gauss2_3d", (np.zeros(2), np.ones(2)), {"n_proposal": 300}),
    "out_of_support": (gamma_pair(), "gamma", (np.array([1.5]), np.array([4.0])), {}),
    # a narrow proposal off the draws' mass: 15 bodies to converge
    "slow": (CORR3, "corr3", (np.full(3, 2.5), COV3 * 0.2), {}),
    "max_iter": (CORR3, "corr3", (np.full(3, 2.5), COV3 * 0.2), {"max_iter": 5}),
    "max_iter_12": (CORR3, "corr3", (np.full(3, 2.5), COV3 * 0.2), {"max_iter": 12}),
    "max_iter_1": (GAUSS2, "gauss2", (np.zeros(2), np.ones(2)), {"max_iter": 1}),
    "not_positive_definite": (CORR3, "corr3", (np.zeros(3), -COV3), {}),
}


def expected_reads(n_iter, max_iter):
    """Reads of the stop test: before bodies 0, 8, 16, ... while a body is
    left under ``max_iter``, up to the first that finds the fixed point
    stopped (after the ``n_iter − 1`` bodies that changed r)."""
    reads = 0
    for body in range(0, max_iter - 1, bridge._READ_INTERVAL):
        reads += 1
        if body >= n_iter - 1:
            break
    return reads


def errors_of(port, ref):
    """Relative errors of logZ and re2, and delta's error relative to logZ:
    delta is a difference of two iterates of r and carries their ulps."""
    out = {}
    for f in ("logZ", "delta", "re2"):
        a, b = port_leaf(port, f), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=f)
        out[f] = normwise(a, b) if np.isfinite(b) else 0.0
    if np.isfinite(np.asarray(ref.logZ)):
        out["delta"] = float(abs(port_leaf(port, "delta") - np.asarray(ref.delta))) / max(
            float(abs(np.asarray(ref.logZ))), 1.0)
    return out


def port_leaf(res, f):
    leaf = getattr(res, f)
    return leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def jax_run(jax_f, draws, base, kw):
    return qj.bridge_evidence(jax_f, jax.random.PRNGKey(9), jnp.asarray(draws),
                              tuple(jnp.asarray(b) for b in base), **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bridge_equals_jax_with_jax_noise(jax_noise, case):
    (jax_f, port_f), name, base, kw = CASES[case]
    draws = DRAWS[name]
    syncs, evals = qt.bridge_evidence.host_syncs, qt.bridge_evidence.value_evals
    port = qt.bridge_evidence(port_f, 9, torch.tensor(draws),
                              tuple(torch.tensor(b) for b in base), **kw)
    ref = jax_run(jax_f, draws, base, kw)
    assert port.n_iter.dtype == torch.int32 and int(port.n_iter) == int(ref.n_iter)
    max_iter = kw.get("max_iter", 200)
    assert qt.bridge_evidence.host_syncs - syncs == expected_reads(int(port.n_iter), max_iter)
    assert qt.bridge_evidence.value_evals - evals == 2
    errors = errors_of(port, ref)
    if max(errors.values()) > RTOL:
        spread = max(max(errors_of(r, ref).values()) for r in (
            jax_run(jax_f, np.nextafter(draws, d), base, kw) for d in (np.inf, -np.inf)))
        bad = {k: v for k, v in errors.items() if v > max(RTOL, WITNESS_FACTOR * spread)}
        assert not bad, f"port against JAX {bad}, JAX's one-ulp witness spread {spread:.3e}"
    if case.startswith("max_iter"):
        assert int(port.n_iter) == max_iter and float(port.delta) > 1e-10
    elif case == "not_positive_definite":
        assert not np.isfinite(float(port.logZ))
    else:
        assert int(port.n_iter) < max_iter and float(port.delta) <= 1e-10


def test_bridge_from_a_fleet_equals_jax(jax_noise):
    """A BFGS fleet as the proposal (the best converged lane's mode, the
    converged lanes' mean B), each package's own fleet on the same starts;
    its any-converged test is one more counted read."""
    jax_f, port_f = CORR3
    x0s = np.random.default_rng(5).standard_normal((8, 3))
    port_fleet = qt.optimize_batched(port_f, torch.tensor(x0s))
    jax_fleet = qj.optimize_batched(jax_f, jnp.asarray(x0s))
    syncs = qt.bridge_evidence.host_syncs
    port = qt.bridge_evidence(port_f, 9, torch.tensor(DRAWS["corr3"]), port_fleet)
    ref = qj.bridge_evidence(jax_f, jax.random.PRNGKey(9), jnp.asarray(DRAWS["corr3"]),
                             jax_fleet)
    assert int(port.n_iter) == int(ref.n_iter)
    assert qt.bridge_evidence.host_syncs - syncs == 1 + expected_reads(int(port.n_iter), 200)
    # the fleets agree to rounding, which the fixed point does not amplify
    for f, err in errors_of(port, ref).items():
        assert err <= 1e-9, f


def _errors(fn):
    with pytest.raises((TypeError, ValueError)) as e:
        fn()
    return type(e.value), str(e.value)


def test_validation_keeps_jax_text():
    """tests/test_bridge.py:106-138 with JAX's types and messages."""
    jf, pf = GAUSS2
    jbase = (jnp.zeros(2), jnp.ones(2))
    pbase = (torch.zeros(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64))
    for draws, kw, bases in (
        (np.ones(4), {}, None),
        (np.ones((8, 3)), {}, None),
        (np.ones((8, 2)), {"max_iter": 0}, None),
        (np.ones((8, 2)), {"n_proposal": 1}, None),
        (np.ones((8, 2)), {}, (3.0, 3.0)),
    ):
        jb, pb = bases if bases is not None else (jbase, pbase)
        theirs = _errors(lambda: qj.bridge_evidence(jf, jax.random.PRNGKey(0),
                                                    jnp.asarray(draws), jb, **kw))
        mine = _errors(lambda: qt.bridge_evidence(pf, 0, torch.tensor(draws), pb, **kw))
        assert mine == theirs, kw


def test_numpy_draws_go_to_the_card(monkeypatch):
    """Numpy draws follow the entry points' device rule (the card; without
    one their error); CPU tensors keep their device and dtype."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _jf, pf = GAUSS2
    with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
        qt.bridge_evidence(pf, 0, DRAWS["gauss2"], (np.zeros(2), np.ones(2)))
    for dtype in (torch.float32, torch.float64):
        res = qt.bridge_evidence(lambda x: -0.5 * torch.sum(x * x), 0,
                                 torch.tensor(DRAWS["gauss2"], dtype=dtype),
                                 (np.zeros(2), np.ones(2)))
        assert all(leaf.device.type == "cpu" for leaf in res)
        assert res.logZ.dtype == res.re2.dtype == dtype


def test_exact_proposal_is_exact():
    """tests/test_bridge.py:37 with the port's noise: q2 proportional to the
    target makes both log ratios the constant log Z."""
    a = np.array([1.0, 4.0, 0.25, 2.0])
    logz = 0.5 * 4 * _LOG_2PI - 0.5 * float(np.sum(np.log(a)))
    draws = np.random.default_rng(0).standard_normal((256, 4)) / np.sqrt(a)
    res = qt.bridge_evidence(lambda x: -0.5 * torch.sum(torch.tensor(a) * x * x), 1,
                             torch.tensor(draws), (torch.zeros(4, dtype=torch.float64),
                                                   torch.tensor(1.0 / a)))
    np.testing.assert_allclose(float(res.logZ), logz, atol=1e-8)
    assert float(res.re2) < 1e-12 and int(res.n_iter) < 10 and float(res.delta) < 1e-10


def test_from_a_solve_result_and_out_of_support():
    """tests/test_bridge.py:55 and :141 with the port's noise: a dense BFGS
    proposal on a correlated Gaussian, and a wide proposal straddling a
    Gamma's support edge, each within the test's error of the truth."""
    cov = np.array([[1.0, 0.6], [0.6, 2.0]])
    prec = torch.tensor(np.linalg.inv(cov))
    logz = 0.5 * 2 * _LOG_2PI + 0.5 * float(np.linalg.slogdet(cov)[1])

    def ld(x):
        return -0.5 * x @ (prec @ x)

    sol = qt.optimize(ld, torch.tensor([1.0, -2.0], dtype=torch.float64))
    assert bool(sol.converged)
    draws = np.random.default_rng(2).multivariate_normal(np.zeros(2), cov, 2048)
    res = qt.bridge_evidence(ld, 3, torch.tensor(draws), sol)
    assert abs(float(res.logZ) - logz) < 0.05 and float(res.re2) < 0.01
    assert int(res.n_iter) < 200
    logz_gamma = math.lgamma(3.0) - 3.0 * math.log(2.0)
    res = qt.bridge_evidence(gamma_pair()[1], 9, torch.tensor(DRAWS["gamma"] * 1.0)[:4096],
                             (torch.tensor([1.5], dtype=torch.float64),
                              torch.tensor([4.0], dtype=torch.float64)))
    assert np.isfinite(float(res.logZ)) and abs(float(res.logZ) - logz_gamma) < 0.05


def test_multimodal_from_pt_draws():
    """tests/test_bridge.py:79 with the port's noise: replica-exchange draws
    from chains all started in one basin, and a wide proposal, recover the
    two-mode mixture's evidence where Laplace carries its one-basin bias
    (~log 0.75). JAX's 64 chains, 6 temperatures and 12 leapfrog steps,
    with 128 warmup rounds and 96 draws (its 256 and 192 halved)."""
    mix = GaussianMixture(means=[[4.0, 4.0], [-4.0, -4.0]], weights=[0.75, 0.25], sigmas=1.0,
                          dtype=torch.float64)
    logz_true = 0.5 * 2 * _LOG_2PI
    pt = qt.pt_sample(mix.logdensity, 4, torch.full((64, 2), 4.0, dtype=torch.float64),
                      n_temps=6, beta_min=0.02, n_samples=96, n_warmup=128, n_leapfrog=12,
                      step_size=0.3)
    res = qt.bridge_evidence(mix.logdensity, 5, pt.samples,
                             (torch.zeros(2, dtype=torch.float64),
                              torch.full((2,), 25.0, dtype=torch.float64)))
    assert abs(float(res.logZ) - logz_true) < 0.1
    sol = qt.optimize(mix.logdensity, torch.tensor([3.5, 4.5], dtype=torch.float64))
    lz_lap = float(qt.laplace_evidence(sol, obj=mix.logdensity))
    assert abs(float(res.logZ) - logz_true) < abs(lz_lap - logz_true)
