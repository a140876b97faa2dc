"""The port's scalar helpers and one-lane line search against the JAX
package's (utils/scalars.py, ops/linesearch.py), on the same numpy inputs
in f64. The helpers are compared exactly (NaN positions included). The
proposals are the same IEEE expressions, but XLA's CPU compiler may
contract or reorder a product, so they agree to a few ulps. The line
search's evaluation counts and failure flag are compared exactly; its
alpha to 1e-6 relative, because the interpolation's cancellation
(fx1 - f0 - m*a) amplifies the 1-ulp difference between the two packages'
Rosenbrock sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.ops import linesearch as jax_ls
from quasinewtonmethods_jl_tpu.utils import scalars as jax_scalars
from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity
from quasinewtonmethods_jl_tpu_torch.ops import linesearch as port_ls
from quasinewtonmethods_jl_tpu_torch.utils import scalars

torch.set_num_threads(1)

_SPECIALS = np.array([np.nan, np.inf, -np.inf, 1.0, -1.0, 0.0, 2.5])


@pytest.mark.parametrize("name", ["nanmin", "nanmax"])
def test_nan_aware_minmax_matches_jax(name):
    a, b = (x.ravel() for x in np.meshgrid(_SPECIALS, _SPECIALS))
    port = getattr(scalars, name)(torch.tensor(a), torch.tensor(b)).numpy()
    ref = np.asarray(getattr(jax_scalars, name)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(port, ref)
    # the non-NaN argument wins whenever there is one
    assert not np.isnan(port[~(np.isnan(a) & np.isnan(b))]).any()


@pytest.mark.parametrize(
    "torch_dtype, np_dtype",
    [
        (torch.float64, np.float64),
        (torch.float32, np.float32),
        (torch.float16, np.float16),
        (torch.bfloat16, ml_dtypes.bfloat16),
    ],
)
def test_precision_constants_match_jax(torch_dtype, np_dtype):
    assert scalars.significand_bits(torch_dtype) == jax_scalars.significand_bits(np_dtype)
    assert scalars.sqrt_tolerance(torch_dtype) == jax_scalars.sqrt_tolerance(np_dtype)
    assert scalars.finite_halving_limit(torch_dtype) == jax_scalars.finite_halving_limit(np_dtype)


def test_backtracking_config_matches_jax():
    assert dataclasses.asdict(port_ls.BackTracking()) == dataclasses.asdict(jax_ls.BackTracking())
    assert port_ls.BackTracking(order=3).order == 3
    for order in (1, 4, 5):
        with pytest.raises(ValueError, match="order"):
            port_ls.BackTracking(order=order)


def _proposal_inputs():
    rng = np.random.default_rng(7)
    k = 64
    m = np.abs(rng.standard_normal(k)) + 0.1
    f0 = rng.standard_normal(k)
    a1 = np.ones(k)
    a2 = rng.uniform(0.05, 0.9, k)
    fx0 = f0 - rng.uniform(0.0, 2.0, k)
    fx1 = f0 - rng.uniform(0.0, 2.0, k)
    # degenerate cubics (cubic coefficient exactly 0), NaN and inf trials
    fx1[:4] = f0[:4] + m[:4] * a2[:4] - 1.0
    fx0[:4] = f0[:4] + m[:4] * a1[:4] - a1[:4] ** 2 / a2[:4] ** 2
    fx1[4], fx0[5], fx1[6] = np.nan, np.nan, -np.inf
    return m, f0, a1, a2, fx0, fx1


def test_proposals_match_jax():
    m, f0, a1, a2, fx0, fx1 = _proposal_inputs()
    t = [torch.tensor(x) for x in (m, f0, a1, a2, fx0, fx1)]
    j = [jnp.asarray(x) for x in (m, f0, a1, a2, fx0, fx1)]
    ulps = 8 * np.finfo(np.float64).eps
    quad = port_ls._quadratic_proposal(t[0], t[3], t[5], t[1]).numpy()
    ref = jax_ls._quadratic_proposal(j[0], j[3], j[5], j[1])
    np.testing.assert_allclose(quad, np.asarray(ref), rtol=ulps, atol=0)
    eps, sqrttol = np.finfo(np.float64).eps, scalars.sqrt_tolerance(torch.float64)
    cubic = port_ls._cubic_proposal(*t[:1], t[2], t[3], t[4], t[5], t[1],
                                    torch.tensor(eps), torch.tensor(sqrttol)).numpy()
    ref = jax_ls._cubic_proposal(*j[:1], j[2], j[3], j[4], j[5], j[1], eps, sqrttol)
    np.testing.assert_allclose(cubic, np.asarray(ref), rtol=ulps, atol=0)


def _ray(n, seed):
    """A Rosenbrock ray: start point, ascent direction (the gradient)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    g = np.asarray(jax.grad(jax_rosenbrock)(jnp.asarray(x)))
    return x, g


_CASES = {
    # plain ascent along the gradient (several backtracking rounds)
    "steep": dict(f="rosen", scale_m=1.0, budget=1000),
    # a NaN region beyond alpha = 0.3: the finite-halving phase runs first
    "nan_region": dict(f="nan_beyond", scale_m=1.0, budget=1000),
    # m claims far more ascent than there is: the budget runs out -> failure
    "exhausted": dict(f="rosen", scale_m=1e6, budget=3),
    # non-finite m: doomed, fails without a round
    "doomed": dict(f="rosen", scale_m=np.nan, budget=1000),
}


def _phis(kind, x, d):
    def port_f(v):
        val = rosenbrock_logdensity(v)
        return val if kind == "rosen" else torch.where(torch.dot(v - xt, dt) > 0.3 * ddt, torch.nan, val)

    def jax_f(v):
        val = jax_rosenbrock(v)
        return val if kind == "rosen" else jnp.where(jnp.dot(v - xj, dj) > 0.3 * ddj, jnp.nan, val)

    xt, dt = torch.tensor(x), torch.tensor(d)
    xj, dj = jnp.asarray(x), jnp.asarray(d)
    ddt, ddj = torch.dot(dt, dt), jnp.dot(dj, dj)
    return (lambda a: port_f(xt + a * dt)), (lambda a: jax_f(xj + a * dj))


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_backtracking_linesearch_matches_jax(case, order):
    spec = _CASES[case]
    x, d = _ray(10, seed=3)
    m = float(d @ d) * spec["scale_m"]
    f0 = float(jax_rosenbrock(jnp.asarray(x)))
    phi_t, phi_j = _phis(spec["f"], x, d)
    port = port_ls.backtracking_linesearch(
        phi_t, torch.tensor(f0), torch.tensor(m),
        port_ls.BackTracking(order=order, iterations=spec["budget"]),
    )
    ref = jax_ls.backtracking_linesearch(
        phi_j, jnp.asarray(f0), jnp.asarray(m),
        jax_ls.BackTracking(order=order, iterations=spec["budget"]),
    )
    np.testing.assert_allclose(float(port.alpha), float(ref.alpha), rtol=1e-6, atol=0)
    assert int(port.n_fev) == int(ref.n_fev)
    assert int(port.iterations) == int(ref.iterations)
    assert bool(port.failed) == bool(ref.failed)
    assert bool(port.failed) == (case in ("exhausted", "doomed"))


def test_run_linesearch_backtracking_and_wolfe_refusal():
    x, d = _ray(6, seed=5)
    xt, dt = torch.tensor(x), torch.tensor(d)
    f0 = rosenbrock_logdensity(xt)
    m = torch.dot(dt, dt)
    alpha, failed, fev, gev = port_ls.run_linesearch(
        port_ls.BackTracking(), rosenbrock_logdensity, None, xt, dt, f0, m
    )
    ref = jax_ls.run_linesearch(
        jax_ls.BackTracking(), jax_rosenbrock, None, jnp.asarray(x), jnp.asarray(d),
        jnp.asarray(float(f0)), jnp.asarray(float(m)),
    )
    np.testing.assert_allclose(float(alpha), float(ref[0]), rtol=1e-6)
    assert (bool(failed), int(fev), int(gev)) == (bool(ref[1]), int(ref[2]), int(ref[3]))
    # the Wolfe search is ported (tests/test_torch_wolfe.py); any other
    # line search is refused
    with pytest.raises(TypeError, match="Wolfe"):
        port_ls.run_linesearch(object(), rosenbrock_logdensity, None, xt, dt, f0, m)
