"""The port's implicit differentiation (implicit.py) against the JAX
package's, on the CPU in f64: the forward (x*, f*) and d/dparams of both
outputs through ``torch.autograd.grad`` against ``jax.grad`` through JAX's
`optimize_implicit`, for both solve methods, with a tensor parameter and a
dict pytree; the gradient through x0 is zero, and a bad method raises.

Forward within rtol 1e-8; gradients within rtol 1e-7 (two CG solves to
cg_tol 1e-10 relative residual, on modes that agree to the solver's
tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qnm
import quasinewtonmethods_jl_tpu_torch as qt

torch.set_num_threads(1)

NOBS, DIM = 60, 6
_rng = np.random.default_rng(20260816)
XD = _rng.standard_normal((NOBS, DIM))
YD = (XD @ _rng.standard_normal(DIM) + 0.5 * _rng.standard_normal(NOBS) > 0).astype(float)


def logistic_map(w, log_scale):
    """Logistic log-likelihood plus a N(0, exp(log_scale)²) prior on w
    (either package)."""
    if isinstance(w, torch.Tensor):
        logits = torch.tensor(XD) @ w
        y = torch.tensor(YD)
        ls = torch.nn.functional.logsigmoid
        prior = -0.5 * torch.sum(w * w) * torch.exp(-2.0 * log_scale) - DIM * log_scale
        return torch.sum(y * ls(logits) + (1 - y) * ls(-logits)) + prior
    logits = jnp.asarray(XD) @ w
    y = jnp.asarray(YD)
    prior = -0.5 * jnp.sum(w * w) * jnp.exp(-2.0 * log_scale) - DIM * log_scale
    return jnp.sum(y * jax.nn.log_sigmoid(logits) + (1 - y) * jax.nn.log_sigmoid(-logits)) + prior


def weighted(x, p):
    """-0.5 Σ d (x - a)² - 0.1 Σ (x - a)⁴ over a dict {'d', 'a'}, given in
    insertion order d, a (JAX sorts its keys)."""
    xp = torch if isinstance(x, torch.Tensor) else jnp
    r = x - p["a"]
    return -0.5 * xp.sum(p["d"] * r * r) - 0.1 * xp.sum(r ** 4) + xp.sum(p["d"] ** 2 * x)


@pytest.mark.parametrize("method", ["bfgs", "lbfgs"])
def test_a_tensor_parameter_matches_jax(method):
    opts = qt.ImplicitOptions(method=method)
    jopts = qnm.ImplicitOptions(method=method)
    p = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    x0 = torch.zeros(DIM, dtype=torch.float64)
    x_star, fun = qt.optimize_implicit(logistic_map, x0, p, opts)
    jx, jfun = qnm.optimize_implicit(logistic_map, jnp.zeros(DIM), jnp.asarray(0.3), jopts)
    np.testing.assert_allclose(x_star.detach().numpy(), np.asarray(jx), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(float(fun), float(jfun), rtol=1e-8)
    g_x, = torch.autograd.grad(torch.sum(x_star ** 2), p, retain_graph=True)
    g_f, = torch.autograd.grad(fun, p)

    def jax_loss(which, q):
        xs, f = qnm.optimize_implicit(logistic_map, jnp.zeros(DIM), q, jopts)
        return jnp.sum(xs ** 2) if which == "x" else f

    np.testing.assert_allclose(float(g_x), float(jax.grad(lambda q: jax_loss("x", q))(0.3)),
                               rtol=1e-7)
    np.testing.assert_allclose(float(g_f), float(jax.grad(lambda q: jax_loss("f", q))(0.3)),
                               rtol=1e-7)


def test_a_dict_pytree_matches_jax():
    n = 4
    d0, a0 = np.random.default_rng(1).uniform(0.5, 2.0, n), np.random.default_rng(2).standard_normal(n)
    p = {"d": torch.tensor(d0, requires_grad=True), "a": torch.tensor(a0, requires_grad=True)}
    w = torch.arange(1.0, n + 1.0, dtype=torch.float64)
    x_star, fun = qt.optimize_implicit(weighted, torch.zeros(n, dtype=torch.float64), p)
    g = torch.autograd.grad(w @ x_star + 2.0 * fun, [p["d"], p["a"]])

    def jax_loss(q):
        xs, f = qnm.optimize_implicit(weighted, jnp.zeros(n), q)
        return jnp.arange(1.0, n + 1.0) @ xs + 2.0 * f

    jg = jax.grad(jax_loss)({"d": jnp.asarray(d0), "a": jnp.asarray(a0)})
    np.testing.assert_allclose(g[0].numpy(), np.asarray(jg["d"]), rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(g[1].numpy(), np.asarray(jg["a"]), rtol=1e-7, atol=1e-10)


def test_the_gradient_through_x0_is_zero():
    p = torch.ones(3, dtype=torch.float64)
    x0 = torch.tensor([0.3, -0.4, 2.0], dtype=torch.float64, requires_grad=True)
    x_star, fun = qt.optimize_implicit(lambda x, q: -0.5 * torch.sum((x - q) ** 2), x0, p)
    g, = torch.autograd.grad(torch.sum(x_star) + fun, x0)
    assert torch.equal(g, torch.zeros(3, dtype=torch.float64))
    np.testing.assert_allclose(x_star.detach().numpy(), 1.0, atol=1e-8)


def test_a_bad_method_raises_as_in_jax():
    f = lambda x, q: -0.5 * (x - q) @ (x - q)  # noqa: E731
    with pytest.raises(ValueError, match="unknown method 'newton'"):
        qt.optimize_implicit(f, torch.zeros(2, dtype=torch.float64),
                             torch.ones(2, dtype=torch.float64), qt.ImplicitOptions(method="newton"))
    with pytest.raises(ValueError, match="unknown method 'newton'"):
        qnm.optimize_implicit(f, jnp.zeros(2), jnp.ones(2), qnm.ImplicitOptions(method="newton"))
