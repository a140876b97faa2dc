"""The port's PSIS-LOO and WAIC (loo.py) against the JAX package's, f64 on
the CPU, and JAX's own tests (tests/test_loo.py) case by case on the port.

Both packages get the same pointwise log-likelihood matrices (JAX's
conjugate normal-normal fixture with JAX's draws, the outlier, a matrix
whose columns are constant, so that every k̂ is -inf), and every field of
`loo_psis`, `waic` and `loo_compare`, per-observation k̂ included, is held
to JAX's at 1e-12; a callable log-likelihood over (S, n) and (n_samples,
chains, n) draws gives what the matrix gives.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt

torch.set_num_threads(1)

_LOG_2PI = math.log(2.0 * math.pi)
RTOL = 1e-12


def _norm_logpdf(y, mu, var):
    return -0.5 * ((y - mu) ** 2 / var + np.log(var) + _LOG_2PI)


def _conjugate_fixture(key, n_obs=25, n_draws=8192, tau2=4.0, shift=0.0):
    """tests/test_loo.py's fixture: data, exact posterior draws (JAX's), the
    (S, N) log-likelihood matrix and the analytic elpd_loo."""
    rng = np.random.default_rng(17)
    y = rng.standard_normal(n_obs)
    v_post = 1.0 / (n_obs + 1.0 / tau2)
    m_post = v_post * y.sum()
    theta = m_post + math.sqrt(v_post) * np.asarray(jax.random.normal(key, (n_draws,),
                                                                      jnp.float64))
    ll = _norm_logpdf(y[None, :], theta[:, None] + shift, 1.0)
    v_i = 1.0 / (n_obs - 1 + 1.0 / tau2)
    m_i = v_i * (y.sum() - y)
    elpd_true = float(_norm_logpdf(y, m_i + shift, 1.0 + v_i).sum())
    return y, theta, ll, elpd_true


def _outlier_matrix():
    rng = np.random.default_rng(18)
    y = rng.standard_normal(30)
    y[11] = 8.0
    v_post = 1.0 / (len(y) + 0.25)
    theta = v_post * y.sum() + math.sqrt(v_post) * np.asarray(
        jax.random.normal(jax.random.PRNGKey(1), (4096,), jnp.float64))
    return _norm_logpdf(y[None, :], theta[:, None], 1.0)


def _matrices():
    constant = np.tile(np.linspace(-2.0, -1.0, 6), (64, 1))  # no tail in any column
    return {"conjugate": _conjugate_fixture(jax.random.PRNGKey(0))[2],
            "shifted": _conjugate_fixture(jax.random.PRNGKey(2), shift=1.5)[2],
            "outlier": _outlier_matrix(), "constant": constant,
            "small": np.random.default_rng(3).standard_normal((9, 4))}


def assert_fields_equal(port, ref):
    assert type(port).__name__ == type(ref).__name__
    for field in ref._fields:
        a, b = getattr(port, field).numpy(), np.asarray(getattr(ref, field))
        assert a.shape == b.shape, field
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=field)
        np.testing.assert_array_equal(a[~np.isfinite(b)], b[~np.isfinite(b)], err_msg=field)
        # atol for the terms that are zero but for rounding (a constant
        # column's variance: 0 in torch, 2e-30 in JAX)
        np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)], rtol=RTOL, atol=1e-14,
                                   err_msg=field)


@pytest.mark.parametrize("case", sorted(_matrices()))
def test_loo_and_waic_match_jax(case):
    ll = _matrices()[case]
    port, ref = qt.loo_psis(torch.tensor(ll)), qj.loo_psis(jnp.asarray(ll))
    assert_fields_equal(port, ref)
    assert_fields_equal(qt.waic(torch.tensor(ll)), qj.waic(jnp.asarray(ll)))
    if case == "constant":
        assert (port.khat.numpy() == -np.inf).all()


def test_loo_compare_matches_jax():
    m = _matrices()
    ra, rb = qt.loo_psis(torch.tensor(m["conjugate"])), qt.loo_psis(torch.tensor(m["shifted"]))
    ja, jb = qj.loo_psis(jnp.asarray(m["conjugate"])), qj.loo_psis(jnp.asarray(m["shifted"]))
    for port, ref in zip(qt.loo_compare(ra, rb), qj.loo_compare(ja, jb)):
        np.testing.assert_allclose(float(port), float(ref), rtol=RTOL)
    w = qt.waic(torch.tensor(m["conjugate"]))
    # LOO against WAIC of one model: a difference of two elpds that agree to
    # 1e-3, held to 1e-12 of the elpds themselves
    for port, ref in zip(qt.loo_compare(ra, w), qj.loo_compare(ja, qj.waic(jnp.asarray(
            m["conjugate"])))):
        np.testing.assert_allclose(float(port), float(ref), rtol=RTOL,
                                   atol=RTOL * abs(float(ra.elpd)))
    one_a = qt.loo_psis(torch.tensor(m["small"][:, :1]))
    assert float(qt.loo_compare(one_a, one_a)[1]) == 0.0 and float(one_a.se) == 0.0


def test_loo_callable_and_draw_shapes():
    """A callable log-likelihood over (S, n) and (draws, chains, n)
    posterior draws matches the matrix path exactly, and JAX's."""
    y = np.asarray([0.3, -1.2, 0.7, 2.0])
    yt = torch.tensor(y)

    def pointwise(theta):
        return -0.5 * ((yt - theta[0]) ** 2 + _LOG_2PI)

    theta = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (512, 1), jnp.float64))
    ll = torch.func.vmap(pointwise)(torch.tensor(theta))
    ref = qt.loo_psis(ll)
    via_2d = qt.loo_psis(pointwise, draws=torch.tensor(theta))
    via_3d = qt.loo_psis(pointwise, draws=torch.tensor(theta).reshape(64, 8, 1))
    for via in (via_2d, via_3d):
        assert torch.equal(via.elpd, ref.elpd) and torch.equal(via.khat, ref.khat)
    jax_ref = qj.loo_psis(jax.vmap(lambda t: -0.5 * ((jnp.asarray(y) - t[0]) ** 2 + _LOG_2PI))(
        jnp.asarray(theta)))
    assert_fields_equal(ref, jax_ref)
    w2, w3 = qt.waic(pointwise, draws=torch.tensor(theta)), qt.waic(
        pointwise, draws=torch.tensor(theta).reshape(64, 8, 1))
    assert torch.equal(w2.elpd, w3.elpd)


def test_validation_matches_jax():
    cases = [
        ("loo_psis", (lambda t: t,), {}),
        ("loo_psis", (np.ones((8,)),), {}),
        ("loo_psis", (np.ones((4, 3)),), {}),
        ("loo_psis", (lambda t: t,), {"draws": np.ones(5)}),
        ("waic", (lambda t: t,), {}),
        ("waic", (np.ones((1, 3)),), {}),
        ("waic", (np.ones((8,)),), {}),
    ]
    for name, args, kw in cases:
        port_args = tuple(torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args)
        port_kw = {k: torch.tensor(v) for k, v in kw.items()}
        with pytest.raises(ValueError) as port_err:
            getattr(qt, name)(*port_args, **port_kw)
        with pytest.raises(ValueError) as jax_err:
            getattr(qj, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                for a in args), **{k: jnp.asarray(v) for k, v in kw.items()})
        assert str(port_err.value) == str(jax_err.value), name
    ra = qt.loo_psis(torch.zeros((16, 3)) - 1.0)
    rb = qt.loo_psis(torch.zeros((16, 5)) - 1.0)
    with pytest.raises(ValueError) as port_err:
        qt.loo_compare(ra, rb)
    with pytest.raises(ValueError) as jax_err:
        qj.loo_compare(qj.loo_psis(jnp.zeros((16, 3)) - 1.0), qj.loo_psis(jnp.zeros((16, 5)) - 1.0))
    assert str(port_err.value) == str(jax_err.value)


def test_numpy_input_goes_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (qt.loo_psis, qt.waic):
        with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
            fn(np.zeros((16, 3)))


# ---------------------------------------------------------------------------
# JAX's own tests (tests/test_loo.py:47-150) on the port


def test_loo_matches_analytic_conjugate_value():
    _, _, ll, elpd_true = _conjugate_fixture(jax.random.PRNGKey(0))
    res = qt.loo_psis(torch.tensor(ll))
    assert abs(float(res.elpd) - elpd_true) < 0.25
    assert 0.5 < float(res.p_loo) < 1.6
    assert float(torch.max(res.khat)) < 0.7
    assert res.elpd_pointwise.shape == (25,)
    assert float(res.se) > 0


def test_loo_flags_influential_outlier():
    res = qt.loo_psis(torch.tensor(_outlier_matrix()))
    assert int(torch.argmax(res.khat)) == 11


def test_loo_compare_prefers_the_true_model():
    key = jax.random.PRNGKey(2)
    ra = qt.loo_psis(torch.tensor(_conjugate_fixture(key)[2]))
    rb = qt.loo_psis(torch.tensor(_conjugate_fixture(key, shift=1.5)[2]))
    diff, se = qt.loo_compare(ra, rb)
    assert float(diff) > 0
    assert float(diff) > 2.0 * float(se)
    assert float(se) < float(ra.se) + float(rb.se)


def test_waic_agrees_with_loo_and_analytic():
    _, _, ll, elpd_true = _conjugate_fixture(jax.random.PRNGKey(5))
    w = qt.waic(torch.tensor(ll))
    lo = qt.loo_psis(torch.tensor(ll))
    assert abs(float(w.elpd) - elpd_true) < 0.3
    assert abs(float(w.elpd) - float(lo.elpd)) < 0.2
    assert 0.5 < float(w.p_waic) < 1.6
    d, se = qt.loo_compare(lo, w)
    assert abs(float(d)) < max(2.0 * float(se), 0.2)
