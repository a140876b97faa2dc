"""The port's MCLMC sampler (mclmc.py) against the JAX package's, f64 on
the CPU.

JAX's ``jax.random`` streams cannot be reproduced in torch, so every run is
held against JAX with JAX's own draws injected through the port's two
seams, `_mclmc_init_noise` and `_mclmc_step_noise` (JAX: ``normal(fold_in(
key, 2))`` for the first velocities; with ``k = fold_in(fold_in(key,
phase), step)``, ``normal(fold_in(k, 1))`` and ``normal(fold_in(k, 2))``
for the bounce direction and the refresh). Samples, velocities, the
adaptation state and the energy changes are then held to JAX's at 1e-10
normwise relative (or, past that, twice JAX's own one-ulp witness
spread), the bounce counts exactly. A `LowRankMass` raises in both
packages (ROADMAP C.8). With the port's own noise: tests/test_mclmc.py's
algebra, resume, checkpoint, dtype and validation cases (:26-48, :129-179,
:217-245); chunked runs equal long ones bit for bit, and states cross
`save_state` / `load_state` both ways with JAX. Its statistical cases are
tests/test_torch_mclmc_stats.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu import mclmc as jax_mclmc
from quasinewtonmethods_jl_tpu.utils import checkpoint as jax_checkpoint
from quasinewtonmethods_jl_tpu_torch import mclmc
from quasinewtonmethods_jl_tpu_torch.utils import checkpoint
from test_torch_mclmc_stats import _normal_starts, std_normal
from test_torch_sampling_hmc import (
    assert_close_or_witnessed,
    corr_gaussian,
    jax_key,
    lowrank_masses,
    normwise,
    starts,
)

torch.set_num_threads(1)

JAX_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _normal(k, shape, dtype):
    return torch.tensor(np.asarray(jax.random.normal(k, shape, JAX_DTYPE[dtype])))


def jax_init_noise(key, chains, n, dtype, device):
    """JAX `_mclmc_core`'s first velocities (mclmc.py:259-261)."""
    return _normal(jax.random.fold_in(jax_key(key), 2), (chains, n), dtype)


def jax_step_noise(key, phase, step, chains, n, dtype, device):
    """JAX's bounce direction and refresh normals (mclmc.py:171, :244-246)."""
    k = jax.random.fold_in(jax.random.fold_in(jax_key(key), phase), step)
    return tuple(_normal(jax.random.fold_in(k, w), (chains, n), dtype) for w in (1, 2))


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(mclmc, "_mclmc_init_noise", jax_init_noise)
    monkeypatch.setattr(mclmc, "_mclmc_step_noise", jax_step_noise)


RESULT_FIELDS = ("samples", "step_size", "L", "mass_diag", "energy_changes", "energy_var",
                 "final_x")
STATE_FLOATS = ("x", "f", "g", "u", "log_eps", "var_ema", "varE_ema")
STATE_INTS = ("i_warm", "i_samp", "n_warmup_total", "mass_freeze")


def finite_normwise(a, b):
    """`normwise` over the finite entries; the non-finite ones (a chain
    still outside the support has f = -inf) must be equal."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(a[~fin], b[~fin])
    return normwise(a[fin], b[fin])


def compare(port, ref, witness):
    """Every float within 1e-10 normwise (or twice JAX's one-ulp witness
    spread), the bounce counts, counters and key exactly."""
    errors = {f: finite_normwise(getattr(port, f), getattr(ref, f)) for f in RESULT_FIELDS}
    errors.update({f"state.{f}": finite_normwise(getattr(port.state, f), getattr(ref.state, f))
                   for f in STATE_FLOATS})
    np.testing.assert_array_equal(port.divergences.numpy(), np.asarray(ref.divergences))
    assert port.divergences.dtype == torch.int32
    for f in STATE_INTS:
        assert int(getattr(port.state, f)) == int(getattr(ref.state, f)), f
    np.testing.assert_array_equal(port.state.key.numpy(), np.asarray(ref.state.key))
    assert_close_or_witnessed(errors, witness)


def jax_ball(x):
    """A hard support boundary: the standard normal inside |x| < 2."""
    r2 = jnp.sum(x * x)
    return jnp.where(r2 < 4.0, -0.5 * r2, -jnp.inf)


def port_ball(x):
    r2 = torch.sum(x * x)
    return torch.where(r2 < 4.0, -0.5 * r2, -torch.inf)


def _cases():
    s = np.asarray([1.0, 4.0, 0.25, 2.0, 0.5])
    cov = corr_gaussian(5)[2]

    def scaled(lib, w):
        return lambda x: -0.5 * lib.sum(x * x * (torch.tensor(w, dtype=x.dtype)
                                                 if lib is torch else jnp.asarray(w)))

    gauss = (scaled(jnp, s), scaled(torch, s))
    near = starts(32, 5) * 0.3
    return {
        # (jax_f, port_f, x0, mass, kwargs)
        "no_mass": (*gauss, starts(32, 5), None, {}),
        "diag_mass": (*gauss, starts(32, 5), np.diag(cov), {}),
        "dense_mass": (*gauss, starts(32, 5), cov, {}),
        "adapt_mass": (*gauss, starts(32, 5), None, {"adapt_mass": True}),
        "outside_start": (jax_ball, port_ball, np.vstack([near[:28], np.full((4, 5), 1.0)]),
                          None, {}),
        "bounce": (jax_ball, port_ball, near, None, {"step_size": 3.0}),
        "n3_step": (*(scaled(lib, s[:3]) for lib in (jnp, torch)), starts(16, 3), None,
                    {"step_size": 0.4, "desired_energy_var": 1e-3}),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_mclmc_equals_jax_with_jax_noise(jax_noise, case):
    """30 warmup steps (the variance EMA freezes after 15), then 20 draws."""
    jax_f, port_f, x0, mass, extra = CASES[case]
    kw = {"n_samples": 20, "n_warmup": 30, **extra}
    before = qt.mclmc_sample.gradient_evals
    port = qt.mclmc_sample(port_f, 5, torch.tensor(x0),
                           mass=None if mass is None else torch.tensor(mass), **kw)
    assert qt.mclmc_sample.gradient_evals - before == 1 + 2 * 50

    def ref_run(start):
        return qj.mclmc_sample(jax_f, jax.random.PRNGKey(5), jnp.asarray(start),
                               mass=None if mass is None else jnp.asarray(mass), **kw)

    ref = ref_run(x0)

    def witness():
        return max(max(normwise(getattr(w, f), getattr(ref, f)) for f in RESULT_FIELDS)
                   for w in (ref_run(np.nextafter(x0, np.inf)), ref_run(np.nextafter(x0, -np.inf))))

    assert port.samples.shape == (20,) + x0.shape and port.samples.dtype == torch.float64
    compare(port, ref, witness)
    if case == "bounce":
        assert int(port.divergences.sum()) > 0
    if case == "outside_start":
        assert not any(bool(torch.isfinite(port_f(torch.tensor(r)))) for r in x0[28:])


def test_mclmc_float32_equals_jax_with_jax_noise(jax_noise):
    """An f32 fleet under JAX's f32 draws: float32 throughout, within
    float32's rounding of JAX's run."""
    s = np.asarray([1.0, 4.0, 0.25, 2.0], np.float32)
    x0 = starts(24, 4).astype(np.float32)
    kw = {"n_samples": 15, "n_warmup": 20}
    port = qt.mclmc_sample(lambda x: -0.5 * torch.sum(x * x * torch.tensor(s)), 3,
                           torch.tensor(x0), **kw)
    ref = qj.mclmc_sample(lambda x: -0.5 * jnp.sum(x * x * jnp.asarray(s)),
                          jax.random.PRNGKey(3), jnp.asarray(x0), **kw)
    assert port.samples.dtype == port.step_size.dtype == port.state.u.dtype == torch.float32
    for f in RESULT_FIELDS:
        assert normwise(getattr(port, f), getattr(ref, f)) <= 2e-4, f
    np.testing.assert_array_equal(port.divergences.numpy(), np.asarray(ref.divergences))


def test_mom_update_equals_jax_and_guards_a_zero_gradient():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((6, 8))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    g = rng.standard_normal((6, 8))
    g[2] = 0.0  # one chain with a zero gradient
    for dt in (1e-6, 0.1, 2.5):
        mine_u, mine_dk = mclmc._mom_update(torch.tensor(dt, dtype=torch.float64), torch.tensor(u),
                                            torch.tensor(g))
        ref_u, ref_dk = jax_mclmc._mom_update(jnp.asarray(dt), jnp.asarray(u), jnp.asarray(g))
        assert normwise(mine_u, ref_u) <= 1e-14
        # dk is (d-1)(delta - log 2 + log1p(...)): a cancellation of O(1)
        # terms, so it is held absolutely
        np.testing.assert_allclose(mine_dk.numpy(), np.asarray(ref_dk), rtol=0, atol=1e-13)
        np.testing.assert_array_equal(mine_u[2].numpy(), u[2])
        assert float(mine_dk[2]) == 0.0


def test_mom_update_unit_norm_and_ode_limit():
    """tests/test_mclmc.py:26-48: on the sphere exactly, the ODE to first
    order in dt, the identity for a zero gradient."""
    rng = np.random.default_rng(0)
    u = rng.standard_normal((5, 8))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    g = rng.standard_normal((5, 8))
    dt = 1e-6
    u_new, _dk = mclmc._mom_update(torch.tensor(dt, dtype=torch.float64), torch.tensor(u),
                                            torch.tensor(g))
    u_new = u_new.numpy()
    np.testing.assert_allclose(np.linalg.norm(u_new, axis=1), 1.0, rtol=1e-12)
    proj = g - (u * g).sum(1, keepdims=True) * u
    expected = u + dt * proj / (8 - 1)
    expected /= np.linalg.norm(expected, axis=1, keepdims=True)
    np.testing.assert_allclose(u_new, expected, atol=1e-10)
    u2, dk2 = mclmc._mom_update(torch.tensor(0.1, dtype=torch.float64), torch.tensor(u),
                                torch.zeros((5, 8), dtype=torch.float64))
    np.testing.assert_allclose(u2.numpy(), u, atol=1e-12)
    np.testing.assert_allclose(dk2.numpy(), 0.0, atol=1e-12)


def test_a_lowrank_mass_raises_in_both_packages():
    """ROADMAP C.8: JAX's `_precond` tests ``callable(mass.diag)``, but
    ``diag`` is a property, so a LowRankMass falls to ``jnp.asarray`` and
    raises; the port raises a ValueError that names it."""
    (port_mass, jax_mass), (port_d, jax_d) = lowrank_masses(4, 2)
    x0 = starts(8, 4)
    for pm in (port_mass, port_d):
        with pytest.raises(ValueError, match="LowRankMass"):
            qt.mclmc_sample(lambda x: -torch.sum(x * x), 0, torch.tensor(x0), mass=pm,
                            n_samples=2, n_warmup=2)
    for jm in (jax_mass, jax_d):
        with pytest.raises((ValueError, TypeError)):
            qj.mclmc_sample(lambda x: -jnp.sum(x * x), jax.random.PRNGKey(0), jnp.asarray(x0),
                            mass=jm, n_samples=2, n_warmup=2)


def test_host_reads_are_the_resume_counters_only():
    before = qt.mclmc_sample.host_syncs
    r = qt.mclmc_sample(lambda x: -0.5 * torch.sum(x * x), 2, torch.tensor(starts(8, 3)),
                        n_samples=0, n_warmup=4, total_warmup=8)
    assert qt.mclmc_sample.host_syncs == before
    qt.mclmc_sample_from_state(lambda x: -0.5 * torch.sum(x * x), r.state, n_warmup=4,
                               n_samples=3)
    assert qt.mclmc_sample.host_syncs == before + 1


# ---------------------------------------------------------------------------
# Resume, checkpoints, guards and dtypes with the port's own noise
# ---------------------------------------------------------------------------


def test_chunked_resume_identity():
    x0 = _normal_starts(4, (32, 5))
    r_long = qt.mclmc_sample(std_normal, 4, x0, n_samples=300, n_warmup=200)
    r1 = qt.mclmc_sample(std_normal, 4, x0, n_samples=100, n_warmup=200)
    r2 = qt.mclmc_sample_from_state(std_normal, r1.state, n_samples=200)
    assert torch.equal(torch.cat([r1.samples, r2.samples]), r_long.samples)
    for f in qt.MCLMCState._fields:
        assert torch.equal(getattr(r2.state, f), getattr(r_long.state, f)), f
    # warmup split mid-adaptation replays too (the plan is announced)
    ra = qt.mclmc_sample(std_normal, 4, x0, n_samples=0, n_warmup=120, total_warmup=200)
    rb = qt.mclmc_sample_from_state(std_normal, ra.state, n_samples=100, n_warmup=80)
    rw = qt.mclmc_sample(std_normal, 4, x0, n_samples=100, n_warmup=200)
    assert torch.equal(rb.samples, rw.samples)
    assert torch.equal(rb.state.var_ema, rw.state.var_ema)
    with pytest.raises(ValueError, match="warmup after sampling"):
        qt.mclmc_sample_from_state(std_normal, r1.state, n_samples=1, n_warmup=1)
    with pytest.raises(ValueError, match="plan exceeded"):
        qt.mclmc_sample_from_state(std_normal, ra.state, n_warmup=200)
    with pytest.raises(ValueError, match="before the announced"):
        qt.mclmc_sample(std_normal, 4, x0, n_samples=10, n_warmup=10, total_warmup=20)


def test_guards_keep_jax_text():
    x0 = starts(8, 4)
    port = qt.mclmc_sample(std_normal, 0, torch.tensor(x0), n_samples=0, n_warmup=3,
                           total_warmup=6)
    ref = qj.mclmc_sample(lambda x: -0.5 * jnp.sum(x * x), jax.random.PRNGKey(0),
                          jnp.asarray(x0), n_samples=0, n_warmup=3, total_warmup=6)
    resumes = [
        lambda st, m: m.mclmc_sample_from_state(None, st, n_warmup=4),
        lambda st, m: m.mclmc_sample_from_state(None, st, n_samples=2),
        lambda st, m: m.mclmc_sample_from_state(None, st, n_warmup=1, mass=np.ones(4),
                                                adapt_mass=True),
    ]
    for call in resumes:
        with pytest.raises(ValueError) as mine:
            call(port.state, qt)
        with pytest.raises(ValueError) as theirs:
            call(ref.state, qj)
        assert str(mine.value) == str(theirs.value)
    for kw in ({"n_warmup": 5, "total_warmup": 4}, {"n_samples": 2, "n_warmup": 1,
                                                     "total_warmup": 3},
               {"n_warmup": -1}, {"desired_energy_var": 0.0}, {"step_size": -1.0},
               {"mass": np.ones(4), "adapt_mass": True}):
        with pytest.raises(ValueError) as mine:
            qt.mclmc_sample(std_normal, 0, torch.tensor(x0), **kw)
        with pytest.raises(ValueError) as theirs:
            qj.mclmc_sample(lambda x: -jnp.sum(x * x), jax.random.PRNGKey(0), jnp.asarray(x0),
                            **kw)
        assert str(mine.value) == str(theirs.value), kw


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_mclmc.py:160-179 in the port: a state through save_state /
    load_state resumes as the state itself."""
    x0 = _normal_starts(5, (16, 4))
    r1 = qt.mclmc_sample(std_normal, 5, x0, n_samples=50, n_warmup=60)
    checkpoint.save_state(tmp_path / "mclmc_state", r1.state)
    st = checkpoint.load_state(tmp_path / "mclmc_state", qt.MCLMCState, device="cpu")
    for f, a, b in zip(st._fields, st, r1.state):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert torch.equal(qt.mclmc_sample_from_state(std_normal, st, n_samples=50).samples,
                       qt.mclmc_sample_from_state(std_normal, r1.state, n_samples=50).samples)


@pytest.mark.parametrize("typed", [True, False], ids=["typed_key", "raw_key"])
def test_states_cross_checkpoints_both_ways_with_jax(jax_noise, tmp_path, typed):
    """JAX's state (typed or raw key) loads in the port and resumes there
    as JAX resumes it (JAX's draws injected); the port's own state, saved,
    resumes in JAX."""
    x0 = starts(16, 4)
    key = jax.random.key(7) if typed else jax.random.PRNGKey(7)
    jf = lambda x: -0.5 * jnp.sum(x * x)  # noqa: E731
    ref = qj.mclmc_sample(jf, key, jnp.asarray(x0), n_samples=0, n_warmup=12, total_warmup=20)
    jax_checkpoint.save_state(tmp_path / "j", ref.state)
    st = checkpoint.load_state(tmp_path / "j", device="cpu")
    assert isinstance(st, qt.MCLMCState)
    words = np.asarray(jax.random.key_data(key) if typed else key)
    np.testing.assert_array_equal(st.key.numpy(), words)
    for f in STATE_FLOATS:
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(ref.state, f)))
    mine = qt.mclmc_sample_from_state(std_normal, st, n_warmup=8, n_samples=10)
    theirs = qj.mclmc_sample_from_state(jf, ref.state, n_warmup=8, n_samples=10)
    assert normwise(mine.samples, theirs.samples) <= 1e-10
    checkpoint.save_state(tmp_path / "p", mine.state)
    back = jax_checkpoint.load_state(tmp_path / "p")
    np.testing.assert_array_equal(np.asarray(back.x), mine.state.x.numpy())
    out = qj.mclmc_sample_from_state(jf, back, n_samples=5)
    assert normwise(out.samples, qj.mclmc_sample_from_state(jf, theirs.state, n_samples=5)
                    .samples) <= 1e-10


def test_registry_resolves_mclmc():
    assert qt.sampling.get_sampler("mclmc") is qt.mclmc_sample


def test_f32_stays_f32():
    x0 = torch.tensor(np.random.default_rng(0).standard_normal((64, 4)), dtype=torch.float32)
    r = qt.mclmc_sample(std_normal, 8, x0, n_samples=50, n_warmup=50)
    assert r.samples.dtype == torch.float32 and r.step_size.dtype == torch.float32
    assert r.state.key.dtype == torch.int64 and r.state.key.device.type == "cpu"
    assert r.state.i_warm.dtype == torch.int32


def test_input_validation():
    with pytest.raises(ValueError, match="chains, n"):
        qt.mclmc_sample(std_normal, 9, torch.zeros(4))
    with pytest.raises(ValueError, match="n >= 2"):
        qt.mclmc_sample(std_normal, 9, torch.zeros((8, 1)))
    with pytest.raises(ValueError, match="desired_energy_var"):
        qt.mclmc_sample(std_normal, 9, torch.zeros((8, 4)), desired_energy_var=0.0)
    with pytest.raises(ValueError, match="not both"):
        qt.mclmc_sample(std_normal, 9, torch.zeros((8, 4)), mass=torch.ones(4), adapt_mass=True)
    with pytest.raises(ValueError, match="step_size"):
        qt.mclmc_sample(std_normal, 9, torch.zeros((8, 4)), step_size=-1.0)


