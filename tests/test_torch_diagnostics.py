"""The port's chain diagnostics (diagnostics.py) against the JAX package's,
on the CPU in f64: each numpy function against JAX's numpy function and
each device twin against JAX's jitted one (and against the port's numpy
version) on the same numpy draws — iid, AR(1), disjoint and drifting
chains, a constant dimension, heavy tails, tied draws (which show the
stable sort the device ranks need), f32 draws — fewer draws than each
statistic needs, the energy BFMI, and the posterior summary with its
table text.

Floats within rtol 1e-8 (f32 draws 1e-5); the table text equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qnm
import quasinewtonmethods_jl_tpu_torch as qt

torch.set_num_threads(1)

DEVICE_TWINS = ("split_rhat", "ess", "rank_normalized_rhat", "tail_ess")


def _ar1(rng, draws, chains, n, phi):
    eps = rng.standard_normal((draws, chains, n))
    x = np.empty_like(eps)
    x[0] = eps[0] / np.sqrt(1.0 - phi * phi)
    for t in range(1, draws):
        x[t] = phi * x[t - 1] + eps[t]
    return x


def _fixture(name):
    rng = np.random.default_rng(20260816)
    if name == "iid":
        return rng.standard_normal((200, 4, 3))
    if name == "ar1":
        return _ar1(rng, 300, 4, 3, 0.9)
    if name == "disjoint":
        x = rng.standard_normal((100, 4, 2))
        x[:, 2:] += 3.0
        return x
    if name == "drift":
        x = rng.standard_normal((120, 3, 2))
        x[60:, 1] += 2.0
        return x
    if name == "constant":
        x = rng.standard_normal((80, 4, 3))
        x[..., 1] = 0.25
        return x
    if name == "heavy":
        return rng.standard_t(1.5, size=(150, 4, 3))
    if name == "tied":
        return np.round(rng.standard_normal((100, 4, 3)), 1)
    if name == "odd":
        return _ar1(rng, 101, 3, 2, 0.5)
    raise KeyError(name)


FIXTURES = ("iid", "ar1", "disjoint", "drift", "constant", "heavy", "tied", "odd")


def _close(port, ref, rtol=1e-8):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("name", DEVICE_TWINS)
def test_each_statistic_and_its_device_twin_match_jax(name, fixture):
    x = _fixture(fixture)
    host = getattr(qt, name)(x)
    _close(host, getattr(qnm, name)(x))
    device = getattr(qt, name + "_device")(torch.tensor(x))
    assert device.dtype == torch.float64 and device.shape == (x.shape[-1],)
    if fixture == "constant":  # see test_a_constant_dimension_takes_the_numpy_value
        _close(device, host)
    else:
        _close(device, getattr(qnm, name + "_device")(jnp.asarray(x)))
    # numpy's ranks of tied draws are not stable (the folded draws tie at
    # the median of an even count), JAX's device ranks and the port's are
    if fixture != "tied" and name != "rank_normalized_rhat":
        _close(device, host)


@pytest.mark.parametrize("name", ["split_rhat", "ess", "tail_ess"])
def test_a_constant_dimension_takes_the_numpy_value(name):
    """A fault of the reference (ROADMAP C): inside JAX's jitted
    split_rhat_device the variance of a constant column is a rounding
    residue (~2e-34), not 0, so the w > 0 guard misses and the statistic is
    noise (R-hat 1.445, ESS 5.35), where its numpy oracle gives 1.0 and
    4.05. The port's device twin computes the variance exactly, as numpy
    does, and keeps the numpy value."""
    x = _fixture("constant")
    device = getattr(qt, name + "_device")(torch.tensor(x))
    _close(device, getattr(qnm, name)(x))
    jax_device = np.asarray(getattr(qnm, name + "_device")(jnp.asarray(x)))
    assert jax_device[1] != pytest.approx(float(device[1]), rel=1e-3)
    if name == "split_rhat":
        assert float(device[1]) == 1.0


@pytest.mark.parametrize("rank", [False, True])
@pytest.mark.parametrize("fixture", ["ar1", "constant", "tied"])
def test_diagnose_chains_and_its_device_twin_match_jax(fixture, rank):
    x = _fixture(fixture)
    host, ref = qt.diagnose_chains(x, rank=rank), qnm.diagnose_chains(x, rank=rank)
    device = qt.diagnose_chains_device(torch.tensor(x), rank=rank)
    jdevice = qnm.diagnose_chains_device(jnp.asarray(x), rank=rank)
    assert type(host) is qt.ChainDiagnostics and host._fields == ref._fields
    for field in host._fields:
        if getattr(ref, field) is None:
            assert getattr(host, field) is None and getattr(device, field) is None
            continue
        _close(getattr(host, field), getattr(ref, field))
        # on the constant dimension, the numpy value (see above)
        _close(getattr(device, field), getattr(host if fixture == "constant" and field in (
            "rhat", "ess", "ess_tail") else jdevice, field))
    assert qt.diagnose_chains_device(torch.tensor(x)).rhat_rank is None  # opt-in, as in JAX


@pytest.mark.parametrize("name", DEVICE_TWINS)
def test_f32_draws_match_jax(name):
    x = _fixture("ar1").astype(np.float32)
    device = getattr(qt, name + "_device")(torch.tensor(x))
    assert device.dtype == torch.float32
    _close(device, getattr(qnm, name + "_device")(jnp.asarray(x)), rtol=1e-5)


def test_too_few_draws_raise_as_in_jax():
    for draws, fns in ((3, ("split_rhat",)), (7, ("ess",))):
        x = np.random.default_rng(0).standard_normal((draws, 2, 2))
        for name in fns:
            for fn, arg in ((getattr(qt, name), x), (getattr(qnm, name), x),
                            (getattr(qt, name + "_device"), torch.tensor(x)),
                            (getattr(qnm, name + "_device"), jnp.asarray(x))):
                with pytest.raises(ValueError, match="need at least"):
                    fn(arg)


def test_energy_bfmi_matches_jax():
    rng = np.random.default_rng(20260816)
    e = np.cumsum(rng.standard_normal((200, 4)), axis=0) * 0.2 + rng.standard_normal((200, 4))
    _close(qt.energy_bfmi(e), qnm.energy_bfmi(e))
    _close(qt.energy_bfmi_device(torch.tensor(e)), qnm.energy_bfmi_device(jnp.asarray(e)))
    _close(qt.energy_bfmi_device(torch.tensor(e)), qt.energy_bfmi(e))
    for bad in (e[:2], e[:, 0]):
        with pytest.raises(ValueError, match="energies must be"):
            qt.energy_bfmi(bad)


@pytest.mark.parametrize("fixture", ["ar1", "heavy"])
def test_posterior_summary_and_its_table_match_jax(fixture):
    x = _fixture(fixture)
    port, ref = qt.posterior_summary(x), qnm.posterior_summary(x)
    assert port._fields == ref._fields
    for field in port._fields:
        _close(getattr(port, field), getattr(ref, field))
    assert port.table() == ref.table()
    names = qt.pytree_names({"beta": torch.zeros(2), "mu": torch.zeros(())})
    assert port.table(names=names, precision=4) == ref.table(names=names, precision=4)
    with pytest.raises(ValueError, match="names has 1 entries for 3 dimensions"):
        port.table(names=["x"])
    with pytest.raises(ValueError, match="samples must be \\(draws, chains, n\\)"):
        qt.posterior_summary(x[0])
