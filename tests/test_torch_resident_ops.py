"""B3's plain version on objectives of the ops the trace now takes, against
JAX's resident engine, on the CPU.

The port's `optimize_batched_resident` on CPU tensors traces the objective
(so each op must trace) and runs the kernel's plain version, the fleet
engine with the plain update on the user's function (``kernel="torch"``),
under `in_band_linalg` where it factorizes a matrix; JAX's runs its
resident kernel in interpret mode on the jnp twin. On 8-lane fleets in
float64, one objective per group of ops (comparisons and masks,
elementwise functions, mean and norms) and the Gaussian-process marginal
likelihood at m = 8 in its Cholesky form (JAX's default path, which
rewrites its dots) and its slogdet + solve form, and slogdet + solve of
a non-symmetric matrix whose partial pivoting swaps rows on every column
but the last (JAX with ``rewrite_dots=False`` for both: their gradients
hold a ``custom_linear_solve``, which the rewrite does not take,
NotImplementedError): at caps 0, 1 and 5
every counter is equal on every lane and floats agree to rounding; over
whole solves the statuses are equal and every lane ends on the same
optimum. A lane whose matrix is not positive definite at its start gets
JAX's NaN value and NONFINITE_VALUE status. The CUDA kernel is held to the
plain version on the card (tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu.resident_solve import (
    optimize_batched_resident as jax_optimize_batched_resident,
)
import quasinewtonmethods_jl_tpu_torch as qt
from test_torch_objective_ops import gp_data, gp_twins, pair
from test_torch_resident_traced import COUNTERS

torch.set_num_threads(1)

N_LANES = 8


def twins(name, rng):
    """(port objective, JAX objective, n, starts' scale, JAX's rewrite_dots)."""
    t = torch.tensor
    n = 6
    if name == "comparisons and masks":
        c = 0.5 * rng.standard_normal(n)
        ct, cj = t(c), jnp.asarray(c)

        def port(x):
            r = x - ct
            inside = (x * x < 4.0) & torch.logical_not(x >= 3.0) & (x < ct + 3.0) \
                & (x >= ct - 3.0)
            far = torch.logical_or(x <= -5.0, x > 5.0) & (x != 6.0) & (x != ct + 7.0)
            v = torch.where(inside, -r * r, -r * r - (x * x - 4.0))
            r2 = torch.sum(x * x)
            return torch.sum(v.masked_fill(far, -30.0)) + torch.where(r2 < 50.0, 0.0, -r2)

        def ref(x):
            r = x - cj
            inside = (x * x < 4.0) & jnp.logical_not(x >= 3.0) & (x < cj + 3.0) \
                & (x >= cj - 3.0)
            far = jnp.logical_or(x <= -5.0, x > 5.0) & (x != 6.0) & (x != cj + 7.0)
            v = jnp.where(inside, -r * r, -r * r - (x * x - 4.0))
            r2 = jnp.sum(x * x)
            return jnp.sum(jnp.where(far, -30.0, v)) + jnp.where(r2 < 50.0, 0.0, -r2)

        return port, ref, n, 1.5, True
    if name == "elementwise functions":
        c = 0.5 * rng.standard_normal(n)
        ct, cj = t(c), jnp.asarray(c)

        def port(x):
            M = (torch.clamp(x, -4.0, 4.0) - ct).reshape(2, 3).transpose(0, 1)
            s = torch.nn.functional.softplus(x)
            return -torch.sum(torch.sqrt(1.0 + M * M)) + 0.1 * torch.sum(torch.sin(x)) \
                - 0.3 * torch.sum(torch.abs(x - 5.0)) - 0.05 * torch.sum(s) \
                - torch.sum(torch.maximum(x - 3.0, torch.zeros_like(x))) \
                - torch.sum(torch.minimum(x + 3.0, torch.zeros_like(x)) ** 2) \
                - 0.1 * torch.sum(x * x)

        def ref(x):
            M = (jnp.clip(x, -4.0, 4.0) - cj).reshape(2, 3).T
            s = jax.nn.softplus(x)
            return -jnp.sum(jnp.sqrt(1.0 + M * M)) + 0.1 * jnp.sum(jnp.sin(x)) \
                - 0.3 * jnp.sum(jnp.abs(x - 5.0)) - 0.05 * jnp.sum(s) \
                - jnp.sum(jnp.maximum(x - 3.0, 0.0)) - jnp.sum(jnp.minimum(x + 3.0, 0.0) ** 2) \
                - 0.1 * jnp.sum(x * x)

        return port, ref, n, 1.0, True
    if name == "mean and norms":  # pseudo-Huber regression
        A = rng.standard_normal((30, n)) / np.sqrt(n)
        y = A @ rng.standard_normal(n) + 0.3 * rng.standard_t(3, 30)
        At, yt, Aj, yj = t(A), t(y), jnp.asarray(A), jnp.asarray(y)

        def port(w):
            r = yt - At @ w
            return -30.0 * torch.mean(torch.sqrt(1.0 + r * r) - 1.0) \
                - 0.05 * torch.linalg.vector_norm(w - 0.1) ** 2 \
                - torch.sum(torch.mean(w.reshape(2, 3), dim=1) ** 2)

        def ref(w):
            r = yj - Aj @ w
            return -30.0 * jnp.mean(jnp.sqrt(1.0 + r * r) - 1.0) \
                - 0.05 * jnp.linalg.norm(w - 0.1) ** 2 \
                - jnp.sum(jnp.mean(w.reshape(2, 3), axis=1) ** 2)

        return port, ref, n, 1.0, True
    if name.startswith("gp "):
        form = name.split()[1]
        port, ref = gp_twins(*gp_data(rng, 8), form)
        return port, ref, 3, 0.5, form == "cholesky"
    if name == "lu pivoting":  # slogdet and solve swap rows on every column but the last
        port, ref, n, _ = pair("lu pivoting on most columns", rng)
        return port, ref, n, 0.3, False
    raise AssertionError(name)


GROUPS = ["comparisons and masks", "elementwise functions", "mean and norms", "gp cholesky",
          "gp lu", "lu pivoting"]


@pytest.fixture(scope="module", params=GROUPS)
def fleet(request):
    rng = np.random.default_rng(20260816)
    port, ref, n, scale, rewrite_dots = twins(request.param, rng)
    X = rng.standard_normal((N_LANES, n)) * scale
    return request.param, port, ref, X, rewrite_dots


def jax_run(ref, X, rewrite_dots, **kw):
    return jax_optimize_batched_resident(ref, jnp.asarray(X), tol=1e-6, block_batch=N_LANES,
                                         interpret=True, rewrite_dots=rewrite_dots, **kw)


def test_the_caps_follow_jax_lane_for_lane(fleet):
    """Caps 0, 1 and 5: every counter equal on every lane, floats to
    rounding (the two sum and factorize in other orders)."""
    name, port, ref, X, rewrite_dots = fleet
    for cap in (0, 1, 5):
        res = qt.optimize_batched_resident(port, torch.tensor(X), tol=1e-6, max_iterations=cap,
                                           kernel="torch")
        jres = jax_run(ref, X, rewrite_dots, max_iterations=cap)
        for f in COUNTERS:
            assert np.array_equal(getattr(res, f).numpy(), np.asarray(getattr(jres, f))), (cap, f)
        for f in ("x", "fun", "grad"):
            np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(jres, f)),
                                       rtol=1e-10, atol=1e-10, equal_nan=True,
                                       err_msg=f"{name} cap {cap} {f}")
        np.testing.assert_allclose(res.state.B.numpy(), np.asarray(jres.state.B), rtol=1e-8,
                                   atol=1e-8, err_msg=f"{name} cap {cap} B")


def test_whole_solves_end_alike(fleet):
    """Whole solves: the same statuses, every lane converged, on the same
    optimum."""
    name, port, ref, X, rewrite_dots = fleet
    res = qt.optimize_batched_resident(port, torch.tensor(X), tol=1e-6, kernel="torch")
    jres = jax_run(ref, X, rewrite_dots)
    assert np.array_equal(res.status.numpy(), np.asarray(jres.status)), name
    assert bool(res.converged.all()), (name, res.status)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-6, atol=1e-6,
                               err_msg=name)
    np.testing.assert_allclose(res.fun.numpy(), np.asarray(jres.fun), rtol=1e-9, atol=1e-12,
                               err_msg=name)


def test_a_lane_whose_matrix_is_not_positive_definite_fails_in_band(rng):
    """K = B Bᵀ/m + (1 + x0² - x1) I is not positive definite where x1 is
    large (lane 3 starts at x1 = 40): JAX's Cholesky gives NaN there, so
    that lane's value is NaN and it ends NONFINITE_VALUE at its first
    test; the port's plain version does the same (`in_band_linalg`), and
    the other lanes run on."""
    m = 5
    B = rng.standard_normal((m, m))
    K0 = B @ B.T / m
    y = rng.standard_normal(m)
    Kt, yt, Kj, yj = torch.tensor(K0), torch.tensor(y), jnp.asarray(K0), jnp.asarray(y)

    def port(x):
        L = torch.linalg.cholesky(Kt + (1.0 + x[0] * x[0] - x[1]) * torch.eye(m, dtype=x.dtype))
        a = torch.linalg.solve_triangular(L, yt[:, None], upper=False)
        return -0.5 * torch.sum(a * a) - torch.sum(torch.log(torch.diagonal(L))) \
            - 0.5 * torch.sum(x * x)

    def ref(x):
        L = jnp.linalg.cholesky(Kj + (1.0 + x[0] * x[0] - x[1]) * jnp.eye(m))
        a = jsl.solve_triangular(L, yj, lower=True)
        return -0.5 * a @ a - jnp.sum(jnp.log(jnp.diagonal(L))) - 0.5 * x @ x

    X = rng.standard_normal((N_LANES, 2)) * 0.5
    X[3] = [0.0, 40.0]  # K0 - 39 I
    res = qt.optimize_batched_resident(port, torch.tensor(X), tol=1e-6, kernel="torch")
    jres = jax_run(ref, X, True)
    for f in COUNTERS:
        assert np.array_equal(getattr(res, f).numpy(), np.asarray(getattr(jres, f))), f
    assert int(res.status[3]) == int(qt.Status.NONFINITE_VALUE)
    assert np.isnan(float(res.fun[3])) and np.isnan(float(jres.fun[3]))
    others = np.arange(N_LANES) != 3
    assert bool(res.converged.numpy()[others].all())
    np.testing.assert_allclose(res.x.numpy()[others], np.asarray(jres.x)[others], rtol=1e-6,
                               atol=1e-6)
