"""The port's replica-exchange HMC (tempering.py) against the JAX package's,
f64 on the CPU.

Every run is held against JAX with JAX's own draws injected through the
port's seam `_pt_round_noise` (JAX: with ``k = fold_in(fold_in(key,
phase), round)``, ``k_hmc, k_swap = split(k)`` and ``k1, k2 =
split(k_hmc)``: the momentum normals from ``k1`` as one (K·C, n) stream,
the HMC uniforms from ``k2``, the swap uniforms from ``k_swap``). The
per-temperature dual averaging reads each temperature's fleet-mean
acceptance, whose summation order differs between the packages by an ulp
and is amplified round by round (about tenfold every three rounds), so
the parity runs are 10 rounds long: every float then agrees to 1e-10
normwise relative, or to twice JAX's own one-ulp witness spread. The
flow tags, round trips and divergence counts are equal exactly, and so are
the accept and swap decisions: a swap exchanges whole replica rows, so a
decision taken differently would part the positions by O(1). The
statistical cases of tests/test_tempering.py are
tests/test_torch_tempering_stats.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu.utils import checkpoint as jax_checkpoint
from quasinewtonmethods_jl_tpu_torch import tempering
from quasinewtonmethods_jl_tpu_torch.utils import checkpoint
from test_torch_ensemble import moves
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


def jax_round_noise(key, phase, step, K, C, n, dtype, device):
    """JAX `_pt_core`'s draws (tempering.py:256, :324, :353)."""
    jd = JAX_DTYPE[dtype]
    k = jax.random.fold_in(jax.random.fold_in(jax_key(key), phase), step)
    k_hmc, k_swap = jax.random.split(k)
    k1, k2 = jax.random.split(k_hmc)
    z = jax.random.normal(k1, (K * C, n), jd)
    u = jax.random.uniform(k2, (K, C), jd)
    us = jax.random.uniform(k_swap, (K - 1, C), jd) if K > 1 else jnp.zeros((0, C), jd)
    return tuple(torch.tensor(np.asarray(a)) for a in (z, u, us))


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tempering, "_pt_round_noise", jax_round_noise)


RESULT_FLOATS = ("samples", "accept_rate", "swap_rate", "step_size", "betas", "energies",
                 "final_x")
STATE_FLOATS = ("f", "log_eps", "log_eps_bar", "h_bar", "t_da", "mu", "swap_acc", "swap_att",
                "swap_ema", "var_ema")
STATE_EXACT = ("tag", "round_trips", "i_warm", "i_samp")


def compare(port, ref, witness):
    errors = {f: normwise(getattr(port, f), getattr(ref, f)) for f in RESULT_FLOATS}
    errors.update({f"state.{f}": normwise(getattr(port.state, f), getattr(ref.state, f))
                   for f in STATE_FLOATS})
    for f in STATE_EXACT:
        np.testing.assert_array_equal(getattr(port.state, f).numpy(),
                                      np.asarray(getattr(ref.state, f)), err_msg=f)
    assert port.state.tag.dtype == port.round_trips.dtype == torch.int32
    np.testing.assert_array_equal(port.divergences.numpy(), np.asarray(ref.divergences))
    np.testing.assert_array_equal(moves(port.samples.numpy()), moves(np.asarray(ref.samples)))
    np.testing.assert_array_equal(port.state.key.numpy(), np.asarray(ref.state.key))
    assert_close_or_witnessed(errors, witness)


def _gauss(w):
    w = np.asarray(w)

    def jax_f(x):
        return -0.5 * jnp.sum(x * x * jnp.asarray(w))

    def port_f(x):
        return -0.5 * torch.sum(x * x * torch.tensor(w, dtype=x.dtype))

    return jax_f, port_f


def _cases():
    g3 = _gauss([1.0, 4.0, 0.25])
    cov = corr_gaussian(3)[2]
    (lr, lr_j), _ = lowrank_masses(3, 2)
    per_temp = np.random.default_rng(4).standard_normal((3, 8, 3))
    return {
        # name: ((jax_f, port_f), x0, (port mass, jax mass), kwargs)
        "K1": (g3, starts(8, 3), (None, None), {"n_temps": 1}),
        "K2": (g3, starts(8, 3), (None, None), {"n_temps": 2, "beta_min": 0.3}),
        "K3_swap_every_3": (g3, starts(8, 3), (None, None), {"n_temps": 3, "swap_every": 3}),
        "K6": (g3, starts(8, 3), (None, None), {"n_temps": 6}),
        "adapt_ladder": (g3, starts(8, 3), (None, None), {"n_temps": 4, "adapt_ladder": True}),
        "adapt_ladder_every_3": (g3, starts(8, 3), (None, None),
                                 {"n_temps": 5, "adapt_ladder": True, "swap_every": 3}),
        "adapt_mass": (g3, starts(8, 3), (None, None), {"n_temps": 3, "adapt_mass": True}),
        "adapt_mass_few_chains": (g3, starts(4, 3), (None, None),
                                  {"n_temps": 3, "adapt_mass": True}),
        "dense_mass": (g3, starts(8, 3), (torch.tensor(cov), jnp.asarray(cov)), {"n_temps": 3}),
        "diag_mass": (g3, starts(8, 3), (torch.tensor(np.diag(cov)), jnp.asarray(np.diag(cov))),
                      {"n_temps": 3}),
        "lowrank_mass": (g3, starts(8, 3), (lr, lr_j), {"n_temps": 3}),
        "per_temperature_starts": (g3, per_temp, (None, None), {"n_temps": 3}),
        "explicit_betas": (g3, starts(8, 3), (None, None),
                           {"betas": np.asarray([1.0, 0.6, 0.25, 0.1])}),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_pt_equals_jax_with_jax_noise(jax_noise, case):
    """6 warmup rounds, then 4 draws, 4 leapfrog steps a round."""
    (jax_f, port_f), x0, (mass_p, mass_j), extra = CASES[case]
    kw = {"n_samples": 4, "n_warmup": 6, "n_leapfrog": 4, **extra}
    grads = qt.pt_sample.gradient_evals
    port = qt.pt_sample(port_f, 5, torch.tensor(x0), mass=mass_p, **kw)
    assert qt.pt_sample.gradient_evals - grads == 10 * (4 + 1)

    def ref_run(start):
        return qj.pt_sample(jax_f, jax.random.PRNGKey(5), jnp.asarray(start), mass=mass_j, **kw)

    ref = ref_run(x0)

    def witness():
        return max(max(normwise(getattr(w, f), getattr(ref, f)) for f in RESULT_FLOATS)
                   for w in (ref_run(np.nextafter(x0, np.inf)), ref_run(np.nextafter(x0, -np.inf))))

    K = port.state.x.shape[0]
    assert port.samples.shape == (4,) + x0.shape[-2:] and port.swap_rate.shape == (K - 1,)
    compare(port, ref, witness)


def test_pt_float32_equals_jax_with_jax_noise(jax_noise):
    """An f32 ladder under JAX's f32 draws, with JAX's x64 off as the
    port's float32 runs are: float32 throughout, the ladder bit for bit,
    the tags and round trips equal. XLA's float32 exp, log and pow on the
    CPU are not correctly rounded and differ from torch's by an ulp on a
    large share of inputs — a stronger perturbation each round than a
    one-ulp shift of the starts — so the floats are held over 4 rounds to
    1e-4 normwise."""
    x0 = starts(8, 3).astype(np.float32)
    w = np.asarray([1.0, 4.0, 0.25], np.float32)
    kw = {"n_samples": 2, "n_warmup": 2, "n_leapfrog": 4, "n_temps": 8}  # phase 29's ladder
    port = qt.pt_sample(lambda x: -0.5 * torch.sum(x * x * torch.tensor(w)), 2,
                        torch.tensor(x0), **kw)
    with jax.enable_x64(False):
        ref = qj.pt_sample(lambda x: -0.5 * jnp.sum(x * x * jnp.asarray(w)),
                           jax.random.PRNGKey(2), jnp.asarray(x0), **kw)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    assert port.samples.dtype == port.step_size.dtype == port.betas.dtype == torch.float32
    np.testing.assert_array_equal(port.betas.numpy(), ref.betas)
    for f in ("samples", "step_size", "accept_rate", "swap_rate", "energies"):
        assert normwise(getattr(port, f), getattr(ref, f)) <= 1e-4, f
    np.testing.assert_array_equal(port.state.tag.numpy(), ref.state.tag)
    np.testing.assert_array_equal(port.round_trips.numpy(), ref.round_trips)


LADDERS = ((8, 0.05), (6, 0.05), (4, 0.2), (3, 0.3), (2, 0.5), (1, 0.05))


@pytest.mark.parametrize("n_temps,beta_min", LADDERS)
def test_geometric_ladder_equals_jax_in_both_dtypes(n_temps, beta_min):
    mine64 = qt.geometric_ladder(n_temps, beta_min, dtype=torch.float64)
    ref64 = np.asarray(qj.geometric_ladder(n_temps, beta_min, jnp.float64))
    np.testing.assert_allclose(mine64.numpy(), ref64, rtol=1e-14, atol=0)
    mine32 = qt.geometric_ladder(n_temps, beta_min)
    with jax.enable_x64(False):
        ref32 = np.asarray(qj.geometric_ladder(n_temps, beta_min))
    assert mine32.dtype == torch.float32 and ref32.dtype == np.float32
    # float32 as JAX computes it with x64 off, within an ulp or two of its
    # pow and log (the 8-rung 0.05 ladder, phase 29's, bit for bit)
    np.testing.assert_allclose(mine32.numpy(), ref32, rtol=3e-7, atol=0)
    assert float(mine32[0]) == float(mine64[0]) == 1.0
    if (n_temps, beta_min) == (8, 0.05):
        np.testing.assert_array_equal(mine32.numpy(), ref32)
        assert float(mine32[-1]) == float(np.float32(0.049999993))


def test_ladder_validation_keeps_jax_text():
    for args in ((0,), (4, 1.5), (4, 0.0)):
        with pytest.raises(ValueError) as mine:
            qt.geometric_ladder(*args)
        with pytest.raises(ValueError) as theirs:
            qj.geometric_ladder(*args)
        assert str(mine.value) == str(theirs.value)


def test_ladder_adapt_equals_jax():
    rng = np.random.default_rng(3)
    betas = np.asarray(qj.geometric_ladder(6, 0.05, jnp.float64))
    ema = rng.uniform(0.0, 1.0, 5)
    for sweep in (0, 7, 120):
        mine = tempering._ladder_adapt(torch.tensor(betas), torch.tensor(ema), sweep)
        ref = qj.tempering._ladder_adapt(jnp.asarray(betas), jnp.asarray(ema), jnp.int32(sweep),
                                         jnp.float64)
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-14, atol=0)
        assert float(mine[0]) == 1.0


# ---------------------------------------------------------------------------
# Resume, checkpoints, guards and dtypes with the port's own noise
# ---------------------------------------------------------------------------


def std_normal(x):
    return -0.5 * torch.sum(x * x)


def jax_std_normal(x):
    return -0.5 * jnp.sum(x * x)


def _start(seed, shape):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape))


def equal_states(a, b):
    for f, x, y in zip(qt.PTState._fields, a, b):
        assert torch.equal(x, y), f


def test_pt_resume_identity():
    """tests/test_tempering.py:115-148."""
    kw = dict(n_leapfrog=4, swap_every=2, target_accept=0.8)
    x0s = _start(7, (16, 3))
    long = qt.pt_sample(std_normal, 6, x0s, n_temps=3, beta_min=0.2, n_samples=60,
                        n_warmup=50, **kw)
    a = qt.pt_sample(std_normal, 6, x0s, n_temps=3, beta_min=0.2, n_samples=0, n_warmup=20,
                     **kw)
    b = qt.pt_sample_from_state(std_normal, a.state, n_samples=25, n_warmup=30, **kw)
    c = qt.pt_sample_from_state(std_normal, b.state, n_samples=35, **kw)
    assert torch.equal(torch.cat([b.samples, c.samples]), long.samples)
    assert torch.equal(torch.cat([b.energies, c.energies]), long.energies)
    equal_states(c.state, long.state)
    assert torch.equal(c.round_trips, long.round_trips)


def test_pt_adapt_ladder_and_mass_resume_identity():
    """tests/test_tempering.py:307-322 and :387-410."""
    x0s = _start(23, (16, 3))
    for kw in (dict(n_leapfrog=4, adapt_ladder=True, n_temps=4, beta_min=0.1),
               dict(n_leapfrog=4, adapt_mass=True, n_temps=3, beta_min=0.2)):
        cfg = {k: v for k, v in kw.items() if k not in ("n_temps", "beta_min")}
        long = qt.pt_sample(std_normal, 22, x0s, n_samples=40, n_warmup=60, **kw)
        a = qt.pt_sample(std_normal, 22, x0s, n_samples=0, n_warmup=25, **kw)
        b = qt.pt_sample_from_state(std_normal, a.state, n_samples=40, n_warmup=35, **cfg)
        assert torch.equal(b.samples, long.samples)
        assert torch.equal(b.betas, long.betas)
        equal_states(b.state, long.state)


def test_pt_checkpoint_roundtrip(tmp_path):
    """tests/test_tempering.py:151-171 in the port."""
    x0s = _start(9, (8, 2))
    a = qt.pt_sample(std_normal, 8, x0s, n_temps=3, n_samples=10, n_warmup=20, n_leapfrog=4)
    checkpoint.save_state(tmp_path / "pt_state", a.state)
    restored = checkpoint.load_state(tmp_path / "pt_state", qt.PTState, device="cpu")
    for f, x, y in zip(restored._fields, restored, a.state):
        assert x.dtype == y.dtype and torch.equal(x, y), f
    b_direct = qt.pt_sample_from_state(std_normal, a.state, n_samples=15, n_leapfrog=4)
    b_loaded = qt.pt_sample_from_state(std_normal, restored, n_samples=15, n_leapfrog=4)
    assert torch.equal(b_loaded.samples, b_direct.samples)


@pytest.mark.parametrize("typed", [True, False], ids=["typed_key", "raw_key"])
def test_states_cross_checkpoints_both_ways_with_jax(jax_noise, tmp_path, typed):
    """JAX's PTState (typed or raw key) loads in the port and resumes there
    as JAX resumes it (JAX's draws injected); the port's state, saved,
    resumes in JAX."""
    x0 = starts(8, 2)
    key = jax.random.key(8) if typed else jax.random.PRNGKey(8)
    kw = {"n_leapfrog": 3}
    ref = qj.pt_sample(jax_std_normal, key, jnp.asarray(x0), n_temps=3, n_samples=0,
                       n_warmup=4, **kw)
    jax_checkpoint.save_state(tmp_path / "j", ref.state)
    st = checkpoint.load_state(tmp_path / "j", device="cpu")
    assert isinstance(st, qt.PTState)
    np.testing.assert_array_equal(st.key.numpy(),
                                  np.asarray(jax.random.key_data(key) if typed else key))
    for f in qt.PTState._fields:
        if f != "key":
            np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(ref.state, f)))
    mine = qt.pt_sample_from_state(std_normal, st, n_warmup=2, n_samples=3, **kw)
    theirs = qj.pt_sample_from_state(jax_std_normal, ref.state, n_warmup=2, n_samples=3, **kw)
    assert normwise(mine.samples, theirs.samples) <= 1e-10
    np.testing.assert_array_equal(mine.state.tag.numpy(), np.asarray(theirs.state.tag))
    checkpoint.save_state(tmp_path / "p", mine.state)
    back = jax_checkpoint.load_state(tmp_path / "p")
    out = qj.pt_sample_from_state(jax_std_normal, back, n_samples=3, **kw)
    again = qj.pt_sample_from_state(jax_std_normal, theirs.state, n_samples=3, **kw)
    assert normwise(out.samples, again.samples) <= 1e-10


def test_pt_error_paths_keep_jax_text():
    """tests/test_tempering.py:174-196, with JAX's messages."""
    x0 = np.zeros((4, 2))
    cases = [
        (x0, {"betas": np.asarray([0.9, 0.5])}),
        (x0, {"betas": np.ones((2, 2))}),
        (x0, {"betas": np.asarray([1.0, 0.5, 0.6])}),
        (x0, {"betas": np.asarray([1.0, 0.0])}),
        (np.zeros((3, 4, 2)), {"n_temps": 2}),
        (x0, {"swap_every": 0}),
        (x0, {"adapt_mass": True, "mass": np.ones(2)}),
    ]
    for x, kw in cases:
        with pytest.raises(ValueError) as mine:
            qt.pt_sample(std_normal, 0, torch.tensor(x), n_samples=1, n_warmup=1, **kw)
        with pytest.raises(ValueError) as theirs:
            qj.pt_sample(jax_std_normal, jax.random.PRNGKey(0), jnp.asarray(x), n_samples=1,
                         n_warmup=1, **kw)
        assert str(mine.value) == str(theirs.value), kw
    res = qt.pt_sample(std_normal, 0, torch.tensor(x0), n_temps=2, n_samples=5, n_warmup=5,
                       n_leapfrog=2)
    ref = qj.pt_sample(jax_std_normal, jax.random.PRNGKey(0), jnp.asarray(x0), n_temps=2,
                       n_samples=5, n_warmup=5, n_leapfrog=2)
    for kw in ({"n_warmup": 5}, {"swap_every": 0}, {"adapt_mass": True, "mass": np.ones(2)}):
        with pytest.raises(ValueError) as mine:
            qt.pt_sample_from_state(std_normal, res.state, **kw)
        with pytest.raises(ValueError) as theirs:
            qj.pt_sample_from_state(jax_std_normal, ref.state, **kw)
        assert str(mine.value) == str(theirs.value), kw


def test_pt_single_temperature_and_per_temperature_starts():
    """tests/test_tempering.py:95-112."""
    res = qt.pt_sample(std_normal, 3, torch.zeros((8, 3), dtype=torch.float64), n_temps=1,
                       n_samples=50, n_warmup=50, n_leapfrog=4)
    assert res.samples.shape == (50, 8, 3)
    assert res.swap_rate.shape == (0,) and res.state.swap_ema.shape == (0,)
    assert res.state.x.shape == (1, 8, 3)
    assert torch.equal(res.state.tag, torch.ones((1, 8), dtype=torch.int32))
    res = qt.pt_sample(std_normal, 5, _start(4, (3, 8, 2)), n_temps=3, n_samples=20,
                       n_warmup=20, n_leapfrog=4)
    assert res.samples.shape == (20, 8, 2)


def test_pt_mass_forms():
    """tests/test_tempering.py:199-210, with a LowRankMass besides."""
    n = 3
    (lr, _), _ = lowrank_masses(n, 2)
    for mass in (None, torch.ones(n, dtype=torch.float64) * 2.0,
                 torch.eye(n, dtype=torch.float64) + 0.1, lr):
        res = qt.pt_sample(std_normal, 10, torch.zeros((8, n), dtype=torch.float64), mass=mass,
                           n_temps=2, n_samples=10, n_warmup=10, n_leapfrog=4)
        assert bool(torch.isfinite(res.samples).all())


def test_pt_f32_under_x64():
    """tests/test_tempering.py:413-423."""
    res = qt.pt_sample(std_normal, 0, torch.zeros((8, 3)), n_temps=3, n_samples=5, n_warmup=5,
                       n_leapfrog=2, adapt_mass=True, adapt_ladder=True)
    assert res.samples.dtype == torch.float32
    assert res.state.var_ema.dtype == res.state.betas.dtype == torch.float32
    assert res.state.key.dtype == torch.int64 and res.state.key.device.type == "cpu"


def test_host_reads_and_registry():
    before = qt.pt_sample.host_syncs
    res = qt.pt_sample(std_normal, 0, torch.zeros((4, 2)), betas=torch.tensor([1.0, 0.5]),
                       n_samples=2, n_warmup=2, n_leapfrog=2)
    assert qt.pt_sample.host_syncs == before  # a CPU ladder is no device read
    qt.pt_sample_from_state(std_normal, res.state, n_samples=1, n_leapfrog=2)
    assert qt.pt_sample.host_syncs == before + 1
    assert qt.sampling.get_sampler("pt") is qt.pt_sample
