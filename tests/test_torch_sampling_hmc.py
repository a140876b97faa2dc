"""The port's HMC sampler and MAP handoff (sampling.py) against the JAX
package's, f64 on the CPU.

JAX's ``jax.random`` streams cannot be reproduced in torch, so every
transition is held against JAX with JAX's own noise injected: the test
replaces the port's `_step_noise` (and `_chain_init_from_map`'s
`_jitter_noise`) by the draws JAX derives for the same key, phase and
step. Samples, energies, step sizes and every state leaf are then held to
JAX's at 1e-10 normwise relative, and the accept decisions and divergence
counts exactly. HMC's per-chain dual averaging feeds each step's
acceptance probability back into its step size, which amplifies
differences of one ulp (JAX's exp and reductions against torch's) by about
ten every two or three warmup steps: where the port's difference passes
1e-10 it is held to twice JAX's own spread between starts one ulp apart
(its rounding witnesses). Then JAX's moment tests
(tests/test_sampling.py) with the port's own noise, checked through the
ported diagnostics, and `chain_init_from_map` on BFGS, LM and L-BFGS fleet
states carried across from JAX.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch import sampling

torch.set_num_threads(1)

RTOL = 1e-10
WITNESS_FACTOR = 2


def jax_key(key):
    """The JAX raw key of the port's (2,) int64 key tensor."""
    return jnp.asarray(key.numpy().astype(np.uint32))


def _step_key(key, phase, step):
    return jax.random.fold_in(jax.random.fold_in(jax_key(key), phase), step)


def _as_torch(z, u, dtype):
    return torch.tensor(np.asarray(z), dtype=dtype), torch.tensor(np.asarray(u), dtype=dtype)


def jax_hmc_noise(key, phase, step, chains, n, dtype, device):
    """JAX `_hmc_core`'s draws (sampling.py:447, :457, :471-477, :497)."""
    k1, k2 = jax.random.split(_step_key(key, phase, step))
    return _as_torch(jax.random.normal(k1, (chains, n), jnp.float64),
                     jax.random.uniform(k2, (chains,), jnp.float64), dtype)


def jax_chees_noise(key, phase, step, chains, n, dtype, device):
    """JAX `_chees_core`'s draws (sampling.py:818, :852-864, :973)."""
    k = _step_key(key, phase, step)
    return _as_torch(jax.random.normal(k, (chains, n), jnp.float64),
                     jax.random.uniform(jax.random.fold_in(k, 7), (chains,), jnp.float64), dtype)


def normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    assert a.shape == b.shape
    scale = float(np.max(np.abs(b)))
    return float(np.max(np.abs(a - b))) / (scale if scale else 1.0)


def moved(samples, x_start):
    """(draws, chains) accept decisions of a run: whether each draw moved
    its chain."""
    s = np.asarray(samples)
    prev = np.concatenate([np.asarray(x_start)[None], s[:-1]], axis=0)
    return np.any(s != prev, axis=-1)


def assert_close_or_witnessed(errors, witness):
    """Every error within RTOL, or within WITNESS_FACTOR times JAX's own
    spread between starts one ulp apart (``witness()`` gives it)."""
    worst = max(errors.values())
    if worst <= RTOL:
        return
    spread = witness()
    bad = {k: v for k, v in errors.items() if v > max(RTOL, WITNESS_FACTOR * spread)}
    assert not bad, f"port against JAX {bad}, JAX's one-ulp witness spread {spread:.3e}"


def compare_runs(port, ref, x0, state_fields, witness, exclude=()):
    """Samples, energies, accept rate, step size, every state leaf and the
    accept decisions and divergence counts of two runs."""
    errors = {}
    for field in ("samples", "energies", "step_size", "accept_rate", "final_x",
                  "traj_length", "mass_diag"):
        if hasattr(ref, field) and field not in exclude:
            errors[field] = normwise(getattr(port, field), getattr(ref, field))
    for field in state_fields:
        a, b = getattr(port.state, field), getattr(ref.state, field)
        if field == "key":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
        elif b is None:
            assert a is None, field
        elif field in ("i_warm", "i_samp", "n_warmup_total", "mass_freeze"):
            assert int(a) == int(b), field
        elif field != "lr_Q":  # compared as a metric, up to column signs
            errors[f"state.{field}"] = normwise(a, b)
    np.testing.assert_array_equal(port.divergences.numpy(), np.asarray(ref.divergences))
    assert port.divergences.dtype == torch.int32
    np.testing.assert_array_equal(moved(port.samples, x0), moved(ref.samples, x0))
    assert_close_or_witnessed(errors, witness)


def gaussian(scales=(1.0, 4.0, 0.25, 2.0)):
    """A diagonal Gaussian log-density of len(scales) precisions, in both
    packages (elementwise ops only)."""
    s_np = np.asarray(scales)

    def jax_f(x):
        return -0.5 * jnp.sum(x * x * jnp.asarray(s_np[: x.shape[-1]]))

    def port_f(x):
        return -0.5 * torch.sum(x * x * torch.tensor(s_np[: x.shape[-1]], dtype=x.dtype))

    return jax_f, port_f


def corr_gaussian(n, seed=11):
    """tests/test_sampling.py's correlated Gaussian: (jax_f, port_f, cov)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) * 0.4
    cov = A @ A.T + np.eye(n)
    prec = np.linalg.inv(cov)
    prec_j, prec_t = jnp.asarray(prec), torch.tensor(prec)
    return (lambda x: -0.5 * x @ (prec_j @ x)), (lambda x: -0.5 * x @ (prec_t @ x)), cov


def starts(chains, n, seed=0):
    return np.random.default_rng(seed).standard_normal((chains, n))


def lowrank_masses(n, r, seed=3):
    """(port LowRankMass, JAX LowRankMass) with and without ``d``."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, r)))
    sig = np.exp(rng.standard_normal(r))
    d = np.exp(0.5 * rng.standard_normal(n))
    out = []
    for dd in (None, d):
        port = qt.LowRankMass(gamma=torch.tensor(0.7, dtype=torch.float64), Q=torch.tensor(Q),
                              sig=torch.tensor(sig), d=None if dd is None else torch.tensor(dd))
        ref = qj.LowRankMass(gamma=jnp.asarray(0.7), Q=jnp.asarray(Q), sig=jnp.asarray(sig),
                             d=None if dd is None else jnp.asarray(dd))
        out.append((port, ref))
    return out


def _hmc_masses():
    n = 4
    cov = corr_gaussian(n)[2]
    (lr_port, lr_ref), (lrd_port, lrd_ref) = lowrank_masses(n, 2)
    return {
        "none": (None, None),
        "diag": (torch.tensor(np.diag(cov)), jnp.asarray(np.diag(cov))),
        "dense": (torch.tensor(cov), jnp.asarray(cov)),
        "lowrank": (lr_port, lr_ref),
        "lowrank_d": (lrd_port, lrd_ref),
    }


HMC_MASSES = _hmc_masses()


@pytest.mark.parametrize("form", sorted(HMC_MASSES))
def test_hmc_equals_jax_with_jax_noise(monkeypatch, form):
    monkeypatch.setattr(sampling, "_step_noise", jax_hmc_noise)
    jax_f, port_f = gaussian()
    mass_port, mass_ref = HMC_MASSES[form]
    x0 = starts(12, 4)
    kw = {"n_samples": 12, "n_warmup": 16, "n_leapfrog": 5}
    port = qt.hmc_sample(port_f, 5, torch.tensor(x0), mass=mass_port, **kw)

    def ref_run(start):
        return qj.hmc_sample(jax_f, jax.random.PRNGKey(5), jnp.asarray(start), mass=mass_ref, **kw)

    ref = ref_run(x0)

    def witness():
        return max(max(normwise(getattr(w, f), getattr(ref, f))
                       for f in ("samples", "energies", "step_size", "final_x"))
                   for w in (ref_run(np.nextafter(x0, np.inf)), ref_run(np.nextafter(x0, -np.inf))))

    assert port.samples.shape == (12, 12, 4) and port.samples.dtype == torch.float64
    compare_runs(port, ref, x0, qt.HMCState._fields, witness)


def test_hmc_divergent_run_equals_jax(monkeypatch):
    """tests/test_sampling.py:109-121: a step of 1e6 diverges every
    trajectory; each is rejected, x stays put, the counts equal JAX's."""
    monkeypatch.setattr(sampling, "_step_noise", jax_hmc_noise)

    def jax_f(x):
        return -0.5 * jnp.sum(x * x) - 0.1 * jnp.sum(x ** 4)

    def port_f(x):
        return -0.5 * torch.sum(x * x) - 0.1 * torch.sum(x ** 4)

    kw = {"n_samples": 12, "n_warmup": 0, "step_size": 1e6, "n_leapfrog": 4}
    x0 = np.ones((8, 3))
    port = qt.hmc_sample(port_f, 6, torch.tensor(x0), **kw)
    ref = qj.hmc_sample(jax_f, jax.random.PRNGKey(6), jnp.asarray(x0), **kw)
    np.testing.assert_array_equal(port.divergences.numpy(), np.asarray(ref.divergences))
    assert int(port.divergences.sum()) == 12 * 8
    assert torch.equal(port.samples, torch.tensor(x0).expand(12, 8, 3))
    assert torch.equal(port.accept_rate, torch.zeros(8, dtype=torch.float64))
    assert normwise(port.energies, ref.energies) <= RTOL


# ---------------------------------------------------------------------------
# Statistics with the port's own noise (JAX's moment tests and thresholds)
# ---------------------------------------------------------------------------


def pooled(res, n):
    return res.samples.reshape(-1, n).numpy()


def test_hmc_standard_normal_moments():
    n, chains = 4, 32
    res = qt.hmc_sample(lambda x: -0.5 * torch.sum(x * x), 0,
                        torch.zeros((chains, n), dtype=torch.float64),
                        n_samples=800, n_warmup=300, n_leapfrog=8)
    draws = pooled(res, n)
    assert draws.shape[0] == 800 * chains
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(draws.var(axis=0), 1.0, atol=0.15)
    acc = float(res.accept_rate.mean())
    assert 0.6 < acc <= 1.0
    # the ported diagnostics agree: mixed chains
    assert float(qt.split_rhat_device(res.samples).max()) < 1.05
    assert float(qt.ess_device(res.samples).min()) > 1000


def test_hmc_preconditioned_correlated_gaussian():
    _, port_f, cov = corr_gaussian(3)
    res = qt.hmc_sample(port_f, 1, torch.zeros((48, 3), dtype=torch.float64),
                        mass=torch.tensor(cov), n_samples=700, n_warmup=300, n_leapfrog=8)
    emp_cov = np.cov(pooled(res, 3).T)
    np.testing.assert_allclose(emp_cov, cov, atol=0.35 * np.abs(cov).max())
    assert float(res.accept_rate.mean()) > 0.6


def test_map_to_hmc_handoff():
    """The full pipeline in the port: the fleet's B as the mass."""
    _, port_f, cov = corr_gaussian(3)
    X0 = torch.tensor(np.random.default_rng(2).standard_normal((16, 3)) * 3.0)
    fleet = qt.optimize_batched(port_f, X0, tol=1e-10)
    assert bool((fleet.status == qt.Status.CONVERGED).all())
    x0s, mass = qt.chain_init_from_map(fleet, jitter=0.1, key=3)
    np.testing.assert_allclose(mass.numpy(), cov, atol=0.2 * np.abs(cov).max())
    res = qt.hmc_sample(port_f, 4, x0s, mass=mass, n_samples=600, n_warmup=250, n_leapfrog=8)
    draws = pooled(res, 3)
    np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.35 * np.abs(cov).max())


def test_hmc_diag_mass_and_no_warmup():
    scales = torch.tensor([1.0, 100.0], dtype=torch.float64)
    res = qt.hmc_sample(lambda x: -0.5 * torch.sum(x * x / scales), 5,
                        torch.zeros((32, 2), dtype=torch.float64), mass=scales,
                        n_samples=600, n_warmup=0, step_size=0.5, n_leapfrog=8)
    v = pooled(res, 2).var(axis=0)
    np.testing.assert_allclose(v[0], 1.0, rtol=0.3)
    np.testing.assert_allclose(v[1], 100.0, rtol=0.3)
    np.testing.assert_allclose(res.step_size.numpy(), 0.5)


def test_hmc_reproducible_and_chains_differ():
    kw = {"n_samples": 50, "n_warmup": 10, "n_leapfrog": 4}
    X = torch.zeros((3, 2), dtype=torch.float64)
    a = qt.hmc_sample(lambda x: -0.5 * torch.sum(x * x), 7, X, **kw)
    b = qt.hmc_sample(lambda x: -0.5 * torch.sum(x * x), 7, X, **kw)
    assert torch.equal(a.samples, b.samples)
    assert not np.allclose(a.samples[:, 0].numpy(), a.samples[:, 1].numpy())
    # a generator is a key: one seed drawn from it, the same run twice
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    c = qt.hmc_sample(lambda x: -0.5 * torch.sum(x * x), g1, X, **kw)
    d = qt.hmc_sample(lambda x: -0.5 * torch.sum(x * x), g2, X, **kw)
    assert torch.equal(c.samples, d.samples) and torch.equal(c.state.key, d.state.key)


def test_hmc_float32_chains_stay_float32():
    res = qt.hmc_sample(lambda x: -0.5 * torch.sum(x * x), 0, torch.zeros((8, 3)),
                        mass=np.eye(3), n_samples=10, n_warmup=10)
    assert res.samples.dtype == res.step_size.dtype == res.energies.dtype == torch.float32
    assert res.state.key.dtype == torch.int64 and res.state.key.device.type == "cpu"
    assert res.state.i_warm.dtype == torch.int32 and bool(torch.isfinite(res.samples).all())


def test_hmc_bad_mass_shape():
    with pytest.raises(ValueError, match="mass must be"):
        qt.hmc_sample(lambda x: -torch.sum(x * x), 0, torch.zeros((2, 3)),
                      mass=torch.zeros((3, 3, 3)), n_samples=2, n_warmup=0)


# ---------------------------------------------------------------------------
# Keys, noise, registry, device rule
# ---------------------------------------------------------------------------


def test_keys_take_jax_positions_and_forms():
    np.testing.assert_array_equal(sampling._as_key(7).numpy(), np.asarray(jax.random.PRNGKey(7)))
    np.testing.assert_array_equal(sampling._as_key(jax.random.PRNGKey(9)).numpy(), [0, 9])
    np.testing.assert_array_equal(sampling._as_key(np.asarray([3, 4], np.uint32)).numpy(), [3, 4])
    np.testing.assert_array_equal(sampling._as_key((1 << 40) + 5).numpy(), [256, 5])
    with pytest.raises(TypeError, match="key must be"):
        sampling._as_key(jax.random.key(0))
    with pytest.raises(TypeError, match="key must be"):
        sampling._as_key(np.zeros(3, np.uint32))


def test_step_noise_is_a_pure_function_of_key_phase_step():
    key = sampling._as_key(11)
    z, u = sampling._step_noise(key, 0, 4, 5, 3, torch.float64, torch.device("cpu"))
    z2, u2 = sampling._step_noise(key, 0, 4, 5, 3, torch.float64, torch.device("cpu"))
    assert torch.equal(z, z2) and torch.equal(u, u2)
    assert z.shape == (5, 3) and u.shape == (5,) and bool(((u >= 0) & (u < 1)).all())
    for other in ((1, 4), (0, 5)):
        z3, _ = sampling._step_noise(key, *other, 5, 3, torch.float64, torch.device("cpu"))
        assert not torch.equal(z, z3)
    z4, _ = sampling._step_noise(sampling._as_key(12), 0, 4, 5, 3, torch.float64,
                                 torch.device("cpu"))
    assert not torch.equal(z, z4)


def test_get_sampler_resolves_and_keeps_jax_error_text():
    assert sampling.get_sampler("hmc") is qt.hmc_sample
    assert sampling.get_sampler("chees") is qt.chees_sample
    assert sampling.get_sampler("nuts") is qt.nuts_sample
    assert sampling.get_sampler("mclmc") is qt.mclmc_sample
    assert sampling.get_sampler("ensemble") is qt.ensemble_sample
    assert sampling.get_sampler("pt") is qt.pt_sample
    with pytest.raises(ValueError) as port_err:
        sampling.get_sampler("gibbs")
    with pytest.raises(ValueError) as jax_err:
        qj.sampling.get_sampler("gibbs")
    assert str(port_err.value) == str(jax_err.value)


SAMPLER_ENTRY_POINTS = {
    "hmc_sample": lambda a: qt.hmc_sample(lambda x: -torch.sum(x * x), 0, a, n_samples=1,
                                          n_warmup=0),
    "chees_sample": lambda a: qt.chees_sample(lambda x: -torch.sum(x * x), 0, a, n_samples=1,
                                              n_warmup=0),
    "nuts_sample": lambda a: qt.nuts_sample(lambda x: -torch.sum(x * x), 0, a, n_samples=1,
                                            n_warmup=0),
    "mclmc_sample": lambda a: qt.mclmc_sample(lambda x: -torch.sum(x * x), 0, a, n_samples=1,
                                              n_warmup=0),
    "ensemble_sample": lambda a: qt.ensemble_sample(lambda x: -torch.sum(x * x), 0,
                                                    np.concatenate([a, a]), n_samples=1,
                                                    n_warmup=0),
    "pt_sample": lambda a: qt.pt_sample(lambda x: -torch.sum(x * x), 0, a, n_temps=2,
                                        n_samples=1, n_warmup=0, n_leapfrog=2),
}


@pytest.mark.parametrize("entry", sorted(SAMPLER_ENTRY_POINTS))
def test_the_samplers_place_numpy_input_on_the_card(monkeypatch, entry):
    """Numpy chain starts go to the card (without one, the entry points'
    error); the key stays on the CPU whatever the chains' device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
        SAMPLER_ENTRY_POINTS[entry](np.ones((2, 3)))
    seen = []
    real = torch.as_tensor

    def spy(data, *args, **kwargs):
        seen.append(str(kwargs.get("device")))
        kwargs.pop("device", None)
        return real(data, *args, **kwargs)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch, "as_tensor", spy)
    res = SAMPLER_ENTRY_POINTS[entry](np.ones((2, 3)))
    assert seen[0] == "cuda"
    assert res.samples.dtype == torch.float32
    assert res.state.key.device.type == "cpu" and res.state.key.dtype == torch.int64


def test_a_state_keeps_its_key_on_the_cpu_through_the_device_rule(monkeypatch):
    from quasinewtonmethods_jl_tpu_torch.utils.device import as_device_state

    res = qt.hmc_sample(lambda x: -torch.sum(x * x), 3, torch.zeros((2, 3)), n_samples=1,
                        n_warmup=1)
    numpy_state = qt.HMCState(*(leaf.numpy() for leaf in res.state))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        as_device_state(numpy_state)
    placed = []
    real = torch.as_tensor

    def spy(data, *args, **kwargs):
        placed.append(str(kwargs.get("device")))
        kwargs.pop("device", None)
        return real(data, *args, **kwargs)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch, "as_tensor", spy)
    moved_state = as_device_state(numpy_state)
    # every leaf but the key was placed on the card; the key stayed
    assert placed.count("cuda") == len(qt.HMCState._fields) - 1
    assert moved_state.key.device.type == "cpu" and moved_state.key.dtype == torch.int64
    np.testing.assert_array_equal(moved_state.key.numpy(), [0, 3])


# ---------------------------------------------------------------------------
# chain_init_from_map against JAX on the same fleet states
# ---------------------------------------------------------------------------


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_result(ref, state):
    """A port result over a JAX result's leaves and the port ``state``."""
    return types.SimpleNamespace(x=torch.tensor(np.asarray(ref.x)),
                                 status=torch.tensor(np.asarray(ref.status)),
                                 fun=torch.tensor(np.asarray(ref.fun)), state=state)


def jax_jitter(monkeypatch):
    def noise(key, shape, dtype, device):
        return torch.tensor(np.asarray(jax.random.normal(jax_key(key), tuple(shape),
                                                         jnp.float64)), dtype=dtype)

    monkeypatch.setattr(sampling, "_jitter_noise", noise)


@pytest.fixture(scope="module")
def bfgs_fleet():
    jax_f, _, _ = corr_gaussian(3)
    X0 = np.random.default_rng(2).standard_normal((16, 3)) * 3.0
    ref = qj.optimize_batched(jax_f, jnp.asarray(X0), tol=1e-10)
    state = qt.bfgs_state_from_numpy(_to_np(ref.state), torch.device("cpu"))
    return ref, _port_result(ref, state)


def _no_lane_converged(result):
    status = torch.full_like(result.status, int(qt.Status.MAX_ITERATIONS))
    return types.SimpleNamespace(**{**vars(result), "status": status})


def test_chain_init_from_a_bfgs_fleet_equals_jax(monkeypatch, bfgs_fleet):
    jax_jitter(monkeypatch)
    ref, port = bfgs_fleet
    x0s, mass = qt.chain_init_from_map(port, jitter=0.1, key=3)
    x0s_j, mass_j = qj.chain_init_from_map(ref, jitter=0.1, key=jax.random.PRNGKey(3))
    assert normwise(mass, mass_j) <= 1e-14 and normwise(x0s, x0s_j) <= 1e-15
    plain_x, _ = qt.chain_init_from_map(port)
    assert torch.equal(plain_x, port.x)
    # no lane converged: the identity, in both packages
    _, eye = qt.chain_init_from_map(_no_lane_converged(port))
    ref_none = ref._replace(status=jnp.full_like(ref.status, int(qj.Status.MAX_ITERATIONS)))
    np.testing.assert_array_equal(eye.numpy(), np.asarray(qj.chain_init_from_map(ref_none)[1]))
    assert torch.equal(eye, torch.eye(3, dtype=torch.float64))


def test_chain_init_from_an_lm_fleet_equals_jax():
    def jax_res(p, d):
        t, y = d
        return p[0] * jnp.exp(-p[1] * t) - y

    def port_res(p, d):
        t, y = d
        return p[0] * torch.exp(-p[1] * t) - y

    t = np.linspace(0.0, 4.0, 12)
    y = 2.0 * np.exp(-0.7 * t) + 0.01 * np.random.default_rng(1).standard_normal(12)
    X0 = 1.0 + 0.2 * np.random.default_rng(4).standard_normal((8, 2))
    data = (jnp.asarray(np.tile(t, (8, 1))), jnp.asarray(np.tile(y, (8, 1))))
    ref = qj.least_squares(jax_res, jnp.asarray(X0), data=data)
    assert int(np.sum(np.asarray(ref.status) == int(qj.Status.CONVERGED))) > 0
    # a failed lane carrying NaN products is masked before weighting
    jtj = np.asarray(ref.state.JTJ).copy()
    status = np.asarray(ref.status).copy()
    jtj[0], status[0] = np.nan, int(qj.Status.NONFINITE_VALUE)
    ref = ref._replace(status=jnp.asarray(status),
                       state=ref.state._replace(JTJ=jnp.asarray(jtj)))
    port = _port_result(ref, qt.lm_state_from_numpy(_to_np(ref.state), torch.device("cpu")))
    _, mass = qt.chain_init_from_map(port)
    _, mass_j = qj.chain_init_from_map(ref)
    assert bool(torch.isfinite(mass).all()) and normwise(mass, mass_j) <= 1e-12
    # no lane converged: the identity in both
    _, eye_none = qt.chain_init_from_map(_no_lane_converged(port))
    ref_none = ref._replace(status=jnp.full_like(ref.status, int(qj.Status.MAX_ITERATIONS)))
    np.testing.assert_array_equal(eye_none.numpy(), np.asarray(qj.chain_init_from_map(ref_none)[1]))
    assert torch.equal(eye_none, torch.eye(2, dtype=torch.float64))
    # a singular JTJ: the identity in both
    ref_sing = ref._replace(state=ref.state._replace(JTJ=jnp.zeros_like(ref.state.JTJ)))
    port_sing = _port_result(ref_sing, qt.lm_state_from_numpy(_to_np(ref_sing.state),
                                                               torch.device("cpu")))
    _, eye = qt.chain_init_from_map(port_sing)
    np.testing.assert_array_equal(eye.numpy(), np.asarray(qj.chain_init_from_map(ref_sing)[1]))
    assert torch.equal(eye, torch.eye(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="an LM fleet hands over the dense"):
        qt.chain_init_from_map(port, mass_form="lowrank")


@pytest.fixture(scope="module")
def lbfgs_fleet():
    jax_f, _, _ = corr_gaussian(6, seed=5)
    X0 = np.random.default_rng(3).standard_normal((8, 6)) * 2.0
    ref = qj.optimize_lbfgs_batched(jax_f, jnp.asarray(X0), history=4, tol=1e-6)
    state = qt.lbfgs_state_from_numpy(_to_np(ref.state), torch.device("cpu"))
    return ref, _port_result(ref, state)


def test_chain_init_from_an_lbfgs_fleet_equals_jax(lbfgs_fleet):
    ref, port = lbfgs_fleet
    _, mass = qt.chain_init_from_map(port)
    _, mass_j = qj.chain_init_from_map(ref)
    assert mass.shape == (6,) and normwise(mass, mass_j) <= 1e-12
    _, ones = qt.chain_init_from_map(_no_lane_converged(port))
    assert torch.equal(ones, torch.ones(6, dtype=torch.float64))


def dense_metric(m):
    Q, sig, gamma = (np.asarray(m.Q), np.asarray(m.sig), float(np.asarray(m.gamma)))
    return gamma * (np.eye(Q.shape[0]) - Q @ Q.T) + Q @ np.diag(sig) @ Q.T


def test_chain_init_lowrank_from_an_lbfgs_fleet_equals_jax(lbfgs_fleet):
    ref, port = lbfgs_fleet
    _, mass = qt.chain_init_from_map(port, mass_form="lowrank")
    _, mass_j = qj.chain_init_from_map(ref, mass_form="lowrank")
    assert isinstance(mass, qt.LowRankMass) and mass.d is None
    np.testing.assert_allclose(mass.sig.numpy(), np.asarray(mass_j.sig), rtol=1e-10)
    assert normwise(dense_metric(mass), dense_metric(mass_j)) <= 1e-10
    # Q equals JAX's up to the sign of each column
    signs = np.sign(np.sum(mass.Q.numpy() * np.asarray(mass_j.Q), axis=0))
    np.testing.assert_allclose(mass.Q.numpy() * signs, np.asarray(mass_j.Q), atol=1e-10)
    np.testing.assert_allclose(mass.diag.numpy(), np.asarray(mass_j.diag), rtol=1e-10)
    # no converged lane: gamma 1 and sig 1, an identity metric
    _, ident = qt.chain_init_from_map(_no_lane_converged(port), mass_form="lowrank")
    np.testing.assert_allclose(dense_metric(ident), np.eye(6), atol=1e-12)


def test_chain_init_errors_keep_jax_text(bfgs_fleet):
    ref, port = bfgs_fleet
    cases = [({"jitter": 0.1}, "needs an explicit `key`"),
             ({"mass_form": "dense"}, "mass_form must be 'auto' or 'lowrank'"),
             ({"mass_form": "lowrank"}, "a BFGS fleet already has the dense B")]
    for kw, text in cases:
        with pytest.raises(ValueError) as port_err:
            qt.chain_init_from_map(port, **kw)
        with pytest.raises(ValueError) as jax_err:
            qj.chain_init_from_map(ref, **kw)
        assert text in str(port_err.value) and str(port_err.value) == str(jax_err.value)
