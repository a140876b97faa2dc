"""The port's SVGD (svgd.py) against the JAX package's, f64 on the CPU, and
JAX's own SVGD tests (tests/test_svgd.py) case by case on the port.

SVGD is deterministic given the particles, so the port is held to JAX
directly on the same numpy starts: particles, the AdaGrad accumulator, the
step count, the bandwidth and the final fleet evaluation to 1e-10
normwise relative, at B = 16-64 and at B = 400 (above the median's 65536
element cap: the stride subsample, an even-length median), with a
particle that starts where the objective is NaN. Chunked runs equal long
runs bit for bit, `SVGDState` crosses `save_state` / `load_state` both
ways with JAX and resumes in either package, and the loop makes no host
read.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu.utils import checkpoint as jax_checkpoint
from quasinewtonmethods_jl_tpu_torch.utils import checkpoint
from test_torch_sampling_hmc import normwise

torch.set_num_threads(1)

RTOL = 1e-10


def corr_gaussian(n, seed=0):
    """A correlated Gaussian log-density in both packages."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    prec = np.linalg.inv(A @ A.T / n + 0.5 * np.eye(n))
    pj, pt = jnp.asarray(prec), torch.tensor(prec)
    return (lambda x: -0.5 * x @ (pj @ x)), (lambda x: -0.5 * x @ (pt @ x)), prec


def nan_half(n):
    """NaN where x[0] <= 0 (JAX's tests/test_svgd.py:99-113)."""

    def jl(x):
        return jnp.where(x[0] > 0, -0.5 * jnp.sum((x - 2.0) ** 2), jnp.nan)

    def tl(x):
        good = -0.5 * torch.sum((x - 2.0) ** 2)
        return torch.where(x[0] > 0, good, torch.full_like(good, float("nan")))

    return jl, tl


def _case(name):
    rng = np.random.default_rng({"b16": 1, "b64": 2, "b400": 3, "nan": 4}[name])
    if name == "b16":
        jl, tl, _ = corr_gaussian(3)
        return jl, tl, rng.standard_normal((16, 3)) * 2.0 + 1.0
    if name == "b64":
        jl, tl, _ = corr_gaussian(6, seed=1)
        return jl, tl, rng.standard_normal((64, 6))
    if name == "b400":
        jl, tl, _ = corr_gaussian(4, seed=2)
        return jl, tl, rng.standard_normal((400, 4)) * 3.0
    jl, tl = nan_half(5)
    x0 = rng.standard_normal((32, 5)) + 1.5
    x0[[3, 17], 0] = -1.0  # two particles start where the objective is NaN
    return jl, tl, x0


RESULT_FIELDS = ("particles", "logp", "grad", "bandwidth")


def compare_svgd(port, ref):
    assert int(port.n_steps) == int(ref.n_steps) and port.n_steps.dtype == torch.int32
    for field in RESULT_FIELDS:
        a, b = getattr(port, field).numpy(), np.asarray(getattr(ref, field))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=field)
        fin = ~np.isnan(b)
        assert normwise(a[fin], b[fin]) <= RTOL, (field, normwise(a[fin], b[fin]))
    assert normwise(port.state.acc, ref.state.acc) <= RTOL
    assert torch.equal(port.state.x, port.particles)


@pytest.mark.parametrize("case", ["b16", "b64", "b400", "nan"])
def test_svgd_matches_jax(case):
    jl, tl, x0 = _case(case)
    ref = qj.svgd_sample(jl, jnp.asarray(x0), n_steps=50)
    port = qt.svgd_sample(tl, torch.tensor(x0), n_steps=50)
    compare_svgd(port, ref)
    if case == "nan":
        np.testing.assert_array_equal(port.particles[[3, 17]].numpy(), x0[[3, 17]])


def test_median_bandwidth_matches_jnp_median():
    """The stride subsample and the mean of the two middle values."""
    from quasinewtonmethods_jl_tpu.svgd import _median_bandwidth as jax_median_bandwidth
    from quasinewtonmethods_jl_tpu_torch.svgd import _median_bandwidth

    rng = np.random.default_rng(9)
    for B in (7, 16, 256, 257, 400):
        d2 = rng.exponential(size=(B, B))
        a = float(_median_bandwidth(torch.tensor(d2), B, torch.float64))
        b = float(jax_median_bandwidth(jnp.asarray(d2), B, jnp.float64))
        np.testing.assert_allclose(a, b, rtol=1e-14)
    d2 = np.ones((4, 4))
    d2[1, 2] = np.nan
    assert np.isnan(float(_median_bandwidth(torch.tensor(d2), 4, torch.float64)))


class _HostReads(TorchFunctionMode):
    """Records every tensor-to-host conversion made while it is active."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("item", "__bool__", "tolist", "__int__", "__float__", "__index__", "numpy"):
            self.reads.append(name)
        return func(*args, **(kwargs or {}))


def test_the_loop_reads_nothing_from_the_device():
    _jl, tl, _ = corr_gaussian(3)
    x0 = torch.tensor(np.random.default_rng(5).standard_normal((300, 3)))
    with _HostReads() as mode:
        res = qt.svgd_sample(tl, x0, n_steps=20)
    assert mode.reads == [] and int(res.n_steps) == 20


def test_resume_chunked_equals_long():
    _jl, tl, _ = corr_gaussian(2)
    x0 = torch.tensor(np.random.default_rng(3).standard_normal((64, 2)))
    long = qt.svgd_sample(tl, x0, n_steps=120)
    part = qt.svgd_sample(tl, x0, n_steps=40)
    resumed = qt.svgd_sample_from_state(tl, part.state, n_steps=80)
    assert int(resumed.n_steps) == 120
    for a, b in zip(resumed.state, long.state):
        assert torch.equal(a, b)
    assert torch.equal(resumed.particles, long.particles)
    assert torch.equal(resumed.bandwidth, long.bandwidth)


def test_checkpoint_crosses_to_jax_and_back(tmp_path):
    jl, tl, _ = corr_gaussian(2)
    x0 = np.random.default_rng(4).standard_normal((16, 2))
    part = qt.svgd_sample(tl, torch.tensor(x0), n_steps=10)
    # the port's file: the port resumes from it, and so does JAX
    checkpoint.save_state(tmp_path / "port", part.state)
    loaded = checkpoint.load_state(tmp_path / "port", device="cpu")
    assert type(loaded).__name__ == "SVGDState" and loaded.k.dtype == torch.int32
    a = qt.svgd_sample_from_state(tl, loaded, n_steps=10)
    b = qt.svgd_sample_from_state(tl, part.state, n_steps=10)
    assert torch.equal(a.particles, b.particles)
    jax_state = jax_checkpoint.load_state(str(tmp_path / "port.npz"))
    assert type(jax_state).__name__ == "SVGDState"
    np.testing.assert_array_equal(np.asarray(jax_state.x), part.state.x.numpy())
    j = qj.svgd_sample_from_state(jl, jax_state, n_steps=10)
    compare_svgd(b, j)
    # JAX's file: the port resumes from it as JAX does
    j_part = qj.svgd_sample(jl, jnp.asarray(x0), n_steps=10)
    jax_checkpoint.save_state(str(tmp_path / "jax.npz"), j_part.state)
    from_jax = checkpoint.load_state(tmp_path / "jax", qt.SVGDState, device="cpu")
    for field, leaf in zip(qt.SVGDState._fields, from_jax):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(getattr(j_part.state, field)))
    compare_svgd(qt.svgd_sample_from_state(tl, from_jax, n_steps=10),
                 qj.svgd_sample_from_state(jl, j_part.state, n_steps=10))


# ---------------------------------------------------------------------------
# JAX's own tests (tests/test_svgd.py) on the port


def _corr_gaussian_2d():
    cov = np.array([[1.0, 0.6], [0.6, 0.8]])
    prec = torch.tensor(np.linalg.inv(cov))
    return (lambda x: -0.5 * x @ (prec @ x)), cov


def test_gaussian_moments_recovered():
    logdensity, cov = _corr_gaussian_2d()
    x0 = torch.tensor(np.random.default_rng(0).standard_normal((256, 2)) * 3.0 + 2.0)
    res = qt.svgd_sample(logdensity, x0, n_steps=600)
    P = res.particles.numpy()
    np.testing.assert_allclose(P.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(np.cov(P.T), cov, atol=0.2)
    assert np.all(np.isfinite(res.logp.numpy()))
    assert float(res.bandwidth) > 0.0
    assert int(res.n_steps) == 600


def test_mixture_both_modes_covered():
    def logdensity(x):
        a = -0.5 * torch.sum((x - 2.0) ** 2)
        b = -0.5 * torch.sum((x + 2.0) ** 2)
        return torch.logaddexp(a, b) - np.log(2.0)

    x0 = torch.tensor(np.random.default_rng(1).standard_normal((128, 1)) * 3.0)
    res = qt.svgd_sample(logdensity, x0, n_steps=800)
    P = res.particles.numpy()[:, 0]
    assert 0.3 < float((P > 0).mean()) < 0.7
    assert float(np.abs(np.abs(P) - 2.0).mean()) < 0.8


def test_deterministic():
    logdensity, _ = _corr_gaussian_2d()
    x0 = torch.tensor(np.random.default_rng(2).standard_normal((32, 2)))
    r1 = qt.svgd_sample(logdensity, x0, n_steps=50)
    r2 = qt.svgd_sample(logdensity, x0, n_steps=50)
    assert torch.equal(r1.particles, r2.particles)


def test_nan_particle_freezes_in_band():
    _jl, logdensity = nan_half(2)
    x0 = torch.tensor([[-5.0, 0.0], [1.0, 0.0], [2.0, 1.0], [3.0, -1.0]], dtype=torch.float64)
    res = qt.svgd_sample(logdensity, x0, n_steps=100)
    P, lp = res.particles.numpy(), res.logp.numpy()
    assert np.isnan(lp[0])
    np.testing.assert_allclose(P[0], [-5.0, 0.0], atol=1e-12)  # frozen
    assert np.all(np.isfinite(lp[1:]))
    np.testing.assert_allclose(P[1:, 0].mean(), 2.0, atol=0.6)


def test_validation_matches_jax():
    def port_f(x):
        return -torch.sum(x * x)

    def jax_f(x):
        return -jnp.sum(x * x)

    for x0, kw in ((np.zeros(3), {}), (np.zeros((1, 3)), {}), (np.zeros((4, 3)), {"n_steps": 0}),
                   (np.zeros((4, 3)), {"step_size": -1.0})):
        with pytest.raises(ValueError) as port_err:
            qt.svgd_sample(port_f, torch.tensor(x0), **kw)
        with pytest.raises(ValueError) as jax_err:
            qj.svgd_sample(jax_f, jnp.asarray(x0), **kw)
        assert str(port_err.value) == str(jax_err.value)
    state = qt.SVGDState(torch.zeros((4, 3)), torch.zeros((4, 3)), torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="n_steps must be >= 1, got 0"):
        qt.svgd_sample_from_state(port_f, state, n_steps=0)


def test_transform_composition():
    """Gamma(3, 2) through the Positive bijection: SVGD runs in
    unconstrained z, moments checked on the constrained scale."""
    a, b = 3.0, 2.0

    def gamma_logpdf(x):
        return torch.sum((a - 1.0) * torch.log(x) - b * x)

    tm = qt.transforms.transform_objective(gamma_logpdf, qt.transforms.Positive(1))
    z0 = torch.tensor(np.random.default_rng(5).standard_normal((256, 1)))
    res = qt.svgd_sample(tm, z0, n_steps=800)
    xs = torch.func.vmap(tm.transform.forward)(res.particles).numpy()
    np.testing.assert_allclose(xs.mean(), a / b, atol=0.15)
    np.testing.assert_allclose(xs.var(), a / b**2, atol=0.25)
