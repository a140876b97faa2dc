"""The port's NUTS sampler (sampling.py) against the JAX package's, f64 on
the CPU, with JAX's noise injected.

JAX's ``jax.random`` streams cannot be reproduced in torch, so the test
replaces the port's four NUTS noise seams by the draws JAX derives for the
same key (sampling.py:1467-1492 of the JAX package): per draw k =
fold_in(fold_in(key, phase), step) and kp, kd = split(k); the momenta
normal(kp); per doubling kj = fold_in(kd, j), the direction
rademacher(fold_in(kj, 0)) and the between-subtree uniform
uniform(fold_in(kj, 2)); leaf i's uniform uniform(fold_in(fold_in(kj, 1),
i)). Tree depths, divergence counts and the draws' move decisions are then
held to JAX's exactly, and samples, accept probabilities, step sizes,
energies and every state leaf (``warm_dsum`` included) to 1e-10 normwise
relative, or where the per-chain dual averaging amplifies a one-ulp
difference past that, to twice JAX's own spread between starts one ulp
apart (tests/test_torch_sampling_hmc.py). Every mass form, every
adaptation mode across the mass-freeze split, a run that reaches
max_depth, the divergent run and a float32 run.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch import sampling
from test_torch_sampling_chees import lowrank_metric
from test_torch_sampling_hmc import (
    RTOL,
    assert_close_or_witnessed,
    corr_gaussian,
    gaussian,
    jax_key,
    lowrank_masses,
    moved,
    normwise,
    starts,
)

torch.set_num_threads(1)

_JAX_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _draw_keys(key, phase, step):
    return jax.random.split(jax.random.fold_in(jax.random.fold_in(key, phase), step))


@partial(jax.jit, static_argnums=(3, 4, 5))
def _jax_momentum(key, phase, step, chains, n, dtype):
    kp, _kd = _draw_keys(key, phase, step)
    return jax.random.normal(kp, (chains, n), dtype)


@partial(jax.jit, static_argnums=(4, 5))
def _jax_doubling(key, phase, step, j, chains, dtype):
    _kp, kd = _draw_keys(key, phase, step)
    kj = jax.random.fold_in(kd, j)
    d = jax.random.rademacher(jax.random.fold_in(kj, 0), (chains,), jnp.int32)
    return d, jax.random.uniform(jax.random.fold_in(kj, 2), (chains,), dtype)


@partial(jax.jit, static_argnums=(5, 6))
def _jax_leaf(key, phase, step, j, i, chains, dtype):
    _kp, kd = _draw_keys(key, phase, step)
    kj = jax.random.fold_in(kd, j)
    return jax.random.uniform(jax.random.fold_in(jax.random.fold_in(kj, 1), i), (chains,), dtype)


def _torch(a, dtype):
    return torch.tensor(np.asarray(a)).to(dtype)


def jax_momentum_noise(key, phase, step, chains, n, dtype, device):
    return _torch(_jax_momentum(jax_key(key), phase, step, chains, n, _JAX_DTYPE[dtype]), dtype)


def jax_doubling_noise(key, phase, step, j, chains, dtype, device):
    d, u = _jax_doubling(jax_key(key), phase, step, j, chains, _JAX_DTYPE[dtype])
    return _torch(d, dtype), _torch(u, dtype)


def jax_leaf_noise(key, phase, step, j, i, chains, dtype, device):
    return _torch(_jax_leaf(jax_key(key), phase, step, j, i, chains, _JAX_DTYPE[dtype]), dtype)


def jax_subfleet_key(key, group):
    """JAX's sub-fleet key, fold_in(key, 2 + group), as the port's key."""
    return torch.tensor(np.asarray(jax.random.fold_in(jax_key(key), 2 + group)).astype(np.int64))


def inject_jax_noise(monkeypatch):
    monkeypatch.setattr(sampling, "_nuts_momentum_noise", jax_momentum_noise)
    monkeypatch.setattr(sampling, "_nuts_doubling_noise", jax_doubling_noise)
    monkeypatch.setattr(sampling, "_nuts_leaf_noise", jax_leaf_noise)
    monkeypatch.setattr(sampling, "_subfleet_key", jax_subfleet_key)


RESULT_FIELDS = ("samples", "energies", "step_size", "accept_prob", "final_x", "mass_diag")


def compare_nuts(port, ref, x0, witness):
    """Depths, divergences and move decisions exactly; every float of the
    result and the state to RTOL or the witness spread."""
    np.testing.assert_array_equal(port.mean_tree_depth.numpy(), np.asarray(ref.mean_tree_depth))
    np.testing.assert_array_equal(port.divergences.numpy(), np.asarray(ref.divergences))
    assert port.divergences.dtype == torch.int32
    np.testing.assert_array_equal(moved(port.samples, x0), moved(ref.samples, x0))
    errors = {f: normwise(getattr(port, f), getattr(ref, f)) for f in RESULT_FIELDS}
    for field in qt.NUTSState._fields:
        a, b = getattr(port.state, field), getattr(ref.state, field)
        if field == "key":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
        elif b is None:
            assert a is None, field
        elif field in ("i_warm", "i_samp", "n_warmup_total", "mass_freeze"):
            assert int(a) == int(b) and a.dtype == torch.int32, field
        elif field != "lr_Q":  # compared as the metric, up to column signs
            errors[f"state.{field}"] = normwise(a, b)
    if port.state.lr_Q is not None:
        errors["metric"] = normwise(lowrank_metric(port.state), lowrank_metric(ref.state))
    assert_close_or_witnessed(errors, witness)


def witness_of(ref_run, x0, ref):
    """JAX's own spread between starts one ulp up and down."""
    def witness():
        return max(max(normwise(getattr(w, f), getattr(ref, f))
                       for f in ("samples", "energies", "step_size", "final_x"))
                   for w in (ref_run(np.nextafter(x0, np.inf)),
                             ref_run(np.nextafter(x0, -np.inf))))
    return witness


def _nuts_cases():
    n = 4
    cov = corr_gaussian(n)[2]
    (lr_port, lr_ref), (lrd_port, lrd_ref) = lowrank_masses(n, 2)
    return {  # (port mass, JAX mass, adapt_mass)
        "mass_none_no_adapt": (None, None, False),
        "mass_diag": (torch.tensor(np.diag(cov)), jnp.asarray(np.diag(cov)), True),
        "mass_dense": (torch.tensor(cov), jnp.asarray(cov), True),
        "mass_lowrank": (lr_port, lr_ref, True),
        "mass_lowrank_d": (lrd_port, lrd_ref, True),
        "adapt_diag": (None, None, True),
        "adapt_dense": (None, None, "dense"),
        "adapt_lowrank": (None, None, "lowrank"),
    }


NUTS_CASES = _nuts_cases()


@pytest.mark.parametrize("case", sorted(NUTS_CASES))
def test_nuts_equals_jax_with_jax_noise(monkeypatch, case):
    """12 chains, 16 warmup rounds (the mass freezes after 8), 10 draws."""
    inject_jax_noise(monkeypatch)
    jax_f, port_f = gaussian()
    mass_port, mass_ref, adapt = NUTS_CASES[case]
    x0 = starts(12, 4)
    kw = {"n_samples": 10, "n_warmup": 16, "max_depth": 5, "adapt_mass": adapt,
          "mass_rank": 2}
    syncs, grads = qt.nuts_sample.host_syncs, qt.nuts_sample.gradient_evals
    port = qt.nuts_sample(port_f, 7, torch.tensor(x0), mass=mass_port, **kw)
    assert qt.nuts_sample.host_syncs > syncs and qt.nuts_sample.gradient_evals > grads

    def ref_run(start):
        return qj.nuts_sample(jax_f, jax.random.PRNGKey(7), jnp.asarray(start), mass=mass_ref,
                              **kw)

    ref = ref_run(x0)
    assert port.samples.shape == (10, 12, 4) and port.samples.dtype == torch.float64
    compare_nuts(port, ref, x0, witness_of(ref_run, x0, ref))
    if adapt == "lowrank":
        assert port.state.lr_Q.shape == (4, 2)
    assert float(port.state.warm_dsum.sum()) > 0  # the telemetry windows ran


def test_nuts_from_state_equals_jax_on_a_jax_state(monkeypatch):
    """JAX's warm state carried into the port resumes as JAX's does, and a
    chunked port run equals JAX's long run."""
    inject_jax_noise(monkeypatch)
    jax_f, port_f = gaussian()
    x0 = starts(12, 3, seed=4)
    key = jax.random.PRNGKey(11)
    kw = {"max_depth": 5}
    ref = qj.nuts_sample(jax_f, key, jnp.asarray(x0), n_samples=8, n_warmup=14, **kw)
    half = qj.nuts_sample(jax_f, key, jnp.asarray(x0), n_samples=0, n_warmup=9,
                          total_warmup=14, **kw)
    state = qt.NUTSState(*(None if leaf is None else torch.tensor(np.asarray(leaf))
                           for leaf in half.state))
    syncs = qt.nuts_sample.host_syncs
    port = qt.nuts_sample_from_state(port_f, state, n_samples=8, n_warmup=5, **kw)
    assert qt.nuts_sample.host_syncs > syncs
    # the chunk boundary sits after the mass freeze (14 // 2 = 7)
    compare_nuts(port, ref, x0, lambda: 0.0)
    # the port's own chunked run against JAX's long run
    p1 = qt.nuts_sample(port_f, 11, torch.tensor(x0), n_samples=0, n_warmup=5, total_warmup=14,
                        **kw)
    p2 = qt.nuts_sample_from_state(port_f, p1.state, n_samples=8, n_warmup=9, **kw)
    compare_nuts(p2, ref, x0, lambda: 0.0)


def test_nuts_reaching_max_depth_equals_jax(monkeypatch):
    """A 400x scale spread with the mass adaptation off and a small
    max_depth: trees hit the cap."""
    inject_jax_noise(monkeypatch)
    jax_f, port_f = gaussian((1.0, 1.0 / 400.0, 1.0 / 25.0))
    x0 = starts(8, 3, seed=2)
    kw = {"n_samples": 10, "n_warmup": 12, "max_depth": 4, "adapt_mass": False,
          "step_size": 0.05}
    port = qt.nuts_sample(port_f, 3, torch.tensor(x0), **kw)

    def ref_run(start):
        return qj.nuts_sample(jax_f, jax.random.PRNGKey(3), jnp.asarray(start), **kw)

    ref = ref_run(x0)
    # depths are at most 4, so a mean above 3 holds a draw at the cap
    assert float(port.mean_tree_depth.max()) > 3.0
    compare_nuts(port, ref, x0, witness_of(ref_run, x0, ref))


def test_nuts_divergent_run_equals_jax(monkeypatch):
    """tests/test_sampling.py:383-396: step 1e6 diverges on the first leaf
    of every tree; every draw is rejected, accept 0, x unchanged."""
    inject_jax_noise(monkeypatch)

    def jax_f(x):
        return -0.5 * jnp.sum(x * x) - 0.1 * jnp.sum(x ** 4)

    def port_f(x):
        return -0.5 * torch.sum(x * x) - 0.1 * torch.sum(x ** 4)

    x0 = np.ones((4, 3))
    kw = {"n_samples": 30, "n_warmup": 0, "step_size": 1e6}
    syncs = qt.nuts_sample.host_syncs
    port = qt.nuts_sample(port_f, 4, torch.tensor(x0), **kw)
    # one doubling a draw: its first leaf needs no read, then the round ends
    assert qt.nuts_sample.host_syncs - syncs == 30
    ref = qj.nuts_sample(jax_f, jax.random.PRNGKey(4), jnp.asarray(x0), **kw)
    assert torch.equal(port.samples, torch.tensor(x0).expand(30, 4, 3))
    assert torch.equal(port.accept_prob, torch.zeros(4, dtype=torch.float64))
    np.testing.assert_array_equal(port.divergences.numpy(), np.asarray(ref.divergences))
    assert int(port.divergences.sum()) == 30 * 4
    np.testing.assert_array_equal(port.mean_tree_depth.numpy(), np.asarray(ref.mean_tree_depth))
    assert normwise(port.energies, ref.energies) <= RTOL
    assert bool(torch.isfinite(port.samples).all())


def test_nuts_float32_equals_jax(monkeypatch):
    """A float32 run with JAX's float32 draws: the float32 path end to end."""
    inject_jax_noise(monkeypatch)
    scales = np.asarray([1.0, 4.0, 0.25])

    def jax_f(x):  # float32 constants: the run stays float32 under x64
        return -0.5 * jnp.sum(x * x * jnp.asarray(scales, x.dtype))

    def port_f(x):
        return -0.5 * torch.sum(x * x * torch.tensor(scales, dtype=x.dtype))

    x0 = starts(8, 3, seed=6).astype(np.float32)
    kw = {"n_samples": 8, "n_warmup": 12, "max_depth": 5}
    port = qt.nuts_sample(port_f, 6, torch.tensor(x0), **kw)

    def ref_run(start):
        return qj.nuts_sample(jax_f, jax.random.PRNGKey(6), jnp.asarray(start, jnp.float32),
                              **kw)

    ref = ref_run(x0)
    assert port.samples.dtype == port.state.warm_dsum.dtype == torch.float32
    assert ref.samples.dtype == jnp.float32
    compare_nuts(port, ref, x0, witness_of(ref_run, x0, ref))


def test_nuts_noise_seams_are_pure_and_apart():
    """Each seam is a pure function of its arguments, and the streams
    differ by phase, step, doubling and leaf, and from HMC's."""
    key, cpu = sampling._as_key(11), torch.device("cpu")
    f64 = torch.float64
    z = sampling._nuts_momentum_noise(key, 0, 4, 5, 3, f64, cpu)
    assert torch.equal(z, sampling._nuts_momentum_noise(key, 0, 4, 5, 3, f64, cpu))
    assert not torch.equal(z, sampling._nuts_momentum_noise(key, 1, 4, 5, 3, f64, cpu))
    assert not torch.equal(z, sampling._nuts_momentum_noise(key, 0, 5, 5, 3, f64, cpu))
    assert not torch.equal(z, sampling._step_noise(key, 0, 4, 5, 3, f64, cpu)[0])
    d, u = sampling._nuts_doubling_noise(key, 0, 4, 2, 64, f64, cpu)
    assert d.dtype == f64 and set(d.tolist()) == {-1.0, 1.0}
    assert bool(((u >= 0) & (u < 1)).all())
    d2, u2 = sampling._nuts_doubling_noise(key, 0, 4, 2, 64, f64, cpu)
    assert torch.equal(d, d2) and torch.equal(u, u2)
    assert not torch.equal(u, sampling._nuts_doubling_noise(key, 0, 4, 3, 64, f64, cpu)[1])
    leaf = sampling._nuts_leaf_noise(key, 0, 4, 2, 5, 64, f64, cpu)
    assert torch.equal(leaf, sampling._nuts_leaf_noise(key, 0, 4, 2, 5, 64, f64, cpu))
    assert not torch.equal(leaf, sampling._nuts_leaf_noise(key, 0, 4, 2, 6, 64, f64, cpu))
    assert not torch.equal(leaf, sampling._nuts_leaf_noise(key, 0, 4, 3, 5, 64, f64, cpu))
    k2 = sampling._subfleet_key(key, 0)
    assert k2.dtype == torch.int64 and k2.shape == (2,) and not torch.equal(k2, key)
    assert torch.equal(k2, sampling._subfleet_key(key, 0))
    assert not torch.equal(k2, sampling._subfleet_key(key, 1))
    assert int(k2.max()) < 2 ** 32 and int(k2.min()) >= 0


def test_logaddexp_of_two_minus_infinities_is_minus_infinity():
    """The leaf weights start at -inf: torch's logaddexp keeps -inf there,
    as JAX's does, and the progressive take compares u < NaN as False."""
    ninf = torch.tensor([-np.inf], dtype=torch.float64)
    out = torch.logaddexp(ninf, ninf)
    assert float(out) == float(jnp.logaddexp(-jnp.inf, -jnp.inf)) == -np.inf
    assert not bool(torch.tensor([0.5], dtype=torch.float64) < torch.exp(ninf - out))
