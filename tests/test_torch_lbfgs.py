"""The port's L-BFGS pieces against the JAX package's, on the same numpy
inputs in f64 on the CPU, mirroring tests/test_lbfgs.py:35-170: the ring
push and the two-loop recursion (ops/lbfgs.py), the compact direction and
the three inverse-Hessian handoffs (ops/lbfgs_compact.py), and the scalar
driver `optimize_lbfgs` / `optimize_lbfgs_from_state` (lbfgs_solve.py).

The ops agree to 1e-12. Whole solves reach the same status and
certificate; their counters are equal on short horizons and on the solves
whose trajectories are stable (the quadratics, Rosenbrock n = 8), while
longer Rosenbrock solves part by rounding (tests/test_torch_solve.py says
why), as JAX's own fleet and scalar drivers do (tests/test_lbfgs.py:376).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
from quasinewtonmethods_jl_tpu.models import IllConditionedQuadratic as JaxQuadratic
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.ops import lbfgs as jax_lbfgs
from quasinewtonmethods_jl_tpu.ops import lbfgs_compact as jax_compact
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.models import IllConditionedQuadratic, rosenbrock_logdensity
from quasinewtonmethods_jl_tpu_torch.ops import lbfgs as port_lbfgs
from quasinewtonmethods_jl_tpu_torch.ops import lbfgs_compact as port_compact

torch.set_num_threads(1)

COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")
HELPERS = ("lbfgs_diag_inv_hessian", "lbfgs_logdet_inv_hessian", "lbfgs_lowrank_inv_hessian")


def counters(res):
    return [int(np.asarray(getattr(res, name))) for name in COUNTERS]


def dense_h_from_history(S, Y, rho, hist, gamma, n):
    """Explicit H from the product form (tests/test_lbfgs.py:23-32)."""
    H = gamma * np.eye(n)
    for i in range(hist):
        V = np.eye(n) - rho[i] * np.outer(S[i], Y[i])
        H = V @ H @ V.T + rho[i] * np.outer(S[i], S[i])
    return H


class Rings:
    """The same ring in both packages, pushed pair by pair."""

    def __init__(self, m, n):
        self.t = [torch.zeros((m, n), dtype=torch.float64), torch.zeros((m, n), dtype=torch.float64),
                  torch.zeros(m, dtype=torch.float64), torch.zeros((), dtype=torch.int32),
                  torch.ones((), dtype=torch.float64)]
        self.j = [jnp.asarray(a.numpy()) for a in self.t]

    def push(self, s, y):
        self.t = list(port_lbfgs.lbfgs_push(*self.t, torch.tensor(s), torch.tensor(y)))
        self.j = list(jax_lbfgs.lbfgs_push(*self.j, jnp.asarray(s), jnp.asarray(y)))

    def assert_equal(self):
        for name, a, b in zip(("S", "Y", "rho", "hist", "gamma"), self.t, self.j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=0, err_msg=name)


def _pair(rng, n, kind="positive"):
    s = rng.standard_normal(n) * 0.1
    if kind == "negative":
        return s, -s
    return s, s * rng.uniform(0.5, 2.0) + 0.01 * rng.standard_normal(n)


def test_state_and_result_layout_match_jax():
    assert qt.LBFGSState._fields == qj.LBFGSState._fields
    assert qt.LBFGSResult._fields == qj.LBFGSResult._fields
    init = qt.init_lbfgs_state(torch.zeros(5, dtype=torch.float64), history=3)
    ref = qj.init_lbfgs_state(jnp.zeros(5), history=3)
    for name, a, b in zip(qt.LBFGSState._fields, init, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        assert a.dtype == torch.from_numpy(np.array(b)).dtype, name
    back = qt.lbfgs_state_to_numpy(qt.lbfgs_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref), torch.device("cpu")))
    for a, b in zip(back, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_push_and_every_direction_match_jax_through_wraparound(rng):
    """Seven pairs into a 4-slot ring (two wraps, a rejected pair among
    them): after each push the ring matches JAX's, and the two-loop and
    compact directions match JAX's and each other (tests/test_lbfgs.py:
    193-209)."""
    n, m = 11, 4
    rings = Rings(m, n)
    for step in range(8):
        g = rng.standard_normal(n)
        S, Y, rho, hist, gamma = rings.t
        d_two, m_two = port_lbfgs.lbfgs_direction(S, Y, rho, hist, gamma, torch.tensor(g))
        d_cmp, m_cmp = port_compact.lbfgs_direction_compact(S, Y, rho, hist, gamma, torch.tensor(g))
        ref_two = jax_lbfgs.lbfgs_direction(*rings.j, jnp.asarray(g))
        ref_cmp = jax_compact.lbfgs_direction_compact(*rings.j, jnp.asarray(g))
        for a, b in ((d_two, ref_two[0]), (m_two, ref_two[1]), (d_cmp, ref_cmp[0]),
                     (m_cmp, ref_cmp[1]), (d_cmp, ref_two[0])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
        rings.push(*_pair(rng, n, "negative" if step == 3 else "positive"))
        rings.assert_equal()
    assert int(rings.t[3]) == m


def test_two_loop_matches_the_dense_product_form(rng):
    n, m = 10, 5
    rings = Rings(m, n)
    for _ in range(3):
        rings.push(*_pair(rng, n))
    g = rng.standard_normal(n)
    S, Y, rho, hist, gamma = (a.numpy() for a in rings.t)
    H = dense_h_from_history(S, Y, rho, int(hist), float(gamma), n)
    d, m_dir = port_lbfgs.lbfgs_direction(*rings.t, torch.tensor(g))
    np.testing.assert_allclose(d.numpy(), H @ g, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(m_dir), g @ H @ g, rtol=1e-9)
    assert float(m_dir) > 0


def test_ring_overwrites_oldest_and_skips_negative_curvature(rng):
    """tests/test_lbfgs.py:58-83: a full ring holds the m newest pairs
    oldest to newest; a pair with sᵀy <= 0 leaves the ring and gamma as
    they were."""
    n, m = 6, 3
    rings = Rings(m, n)
    pairs = [_pair(rng, n) for _ in range(5)]
    for s, y in pairs:
        rings.push(s, y)
    assert int(rings.t[3]) == m
    for slot, (s, y) in enumerate(pairs[-m:]):
        np.testing.assert_array_equal(rings.t[0][slot].numpy(), s)
        np.testing.assert_array_equal(rings.t[1][slot].numpy(), y)
    before = [a.clone() for a in rings.t]
    rings.push(*_pair(rng, n, "negative"))
    for a, b in zip(rings.t, before):
        assert torch.equal(a, b)
    empty = Rings(m, n)
    empty.push(*_pair(rng, n, "negative"))
    assert int(empty.t[3]) == 0 and float(empty.t[4]) == 1.0
    empty.assert_equal()


def test_empty_history_is_steepest_ascent(rng):
    g = torch.tensor(rng.standard_normal(7))
    for fn in (port_lbfgs.lbfgs_direction, port_compact.lbfgs_direction_compact):
        d, m_dir = fn(torch.zeros((4, 7), dtype=torch.float64), torch.zeros((4, 7), dtype=torch.float64),
                      torch.zeros(4, dtype=torch.float64), torch.zeros((), dtype=torch.int32),
                      torch.ones((), dtype=torch.float64), g)
        torch.testing.assert_close(d, g, rtol=1e-15, atol=0)
        assert float(m_dir) == pytest.approx(float(g @ g))


def _lowrank_dense(gamma, Q, sig):
    Q = np.asarray(Q)
    return float(gamma) * (np.eye(Q.shape[0]) - Q @ Q.T) + (Q * np.asarray(sig)) @ Q.T


@pytest.mark.parametrize("helper", HELPERS)
def test_inverse_hessian_helpers_match_jax(rng, helper):
    """At each fill level of a 5-slot ring (and with the slots above hist
    poisoned: the masking must hide them), the diagonal, the log
    determinant and the low-rank form match JAX's to 1e-12 (the low-rank
    form as the matrix it represents and its eigenvalues: the QR and
    eigenvector signs are a LAPACK choice); the diagonal also matches the
    dense product form."""
    n, m = 9, 5
    rings = Rings(m, n)
    port_fn, jax_fn = getattr(port_compact, helper), getattr(jax_compact, helper)
    for k in range(4):
        rings.push(*_pair(rng, n))
        S, Y, _rho, hist, gamma = rings.t
        h = int(hist)
        poisoned = (S.clone(), Y.clone())
        poisoned[0][h:] = 99.0
        poisoned[1][h:] = -99.0
        ref = jax_fn(rings.j[0], rings.j[1], rings.j[3], rings.j[4])
        for S_, Y_ in ((S, Y), poisoned):
            port = port_fn(S_, Y_, hist, gamma)
            if helper == "lbfgs_lowrank_inv_hessian":
                np.testing.assert_allclose(_lowrank_dense(*port), _lowrank_dense(*ref),
                                           rtol=1e-12, atol=1e-12)
                np.testing.assert_allclose(port[2].numpy(), np.asarray(ref[2]), rtol=1e-12)
            else:
                np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
        if helper == "lbfgs_diag_inv_hessian":
            H = dense_h_from_history(*(a.numpy() for a in rings.t[:3]), h, float(gamma), n)
            np.testing.assert_allclose(port.numpy(), np.diagonal(H), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("direction_method", ["compact", "two_loop"])
@pytest.mark.parametrize("n", [8, 24, 61])
def test_optimize_lbfgs_rosenbrock_matches_jax(rng, n, direction_method):
    """tests/test_lbfgs.py:97-103 in both packages: the same status and
    certificate; every counter equal at n = 8 (106 iterations) and over the
    first 12 iterations at every n."""
    x0 = rng.standard_normal(n)
    port = qt.optimize_lbfgs(rosenbrock_logdensity, torch.tensor(x0),
                             direction_method=direction_method)
    ref = qj.optimize_lbfgs(jax_rosenbrock, jnp.asarray(x0), direction_method=direction_method)
    assert int(port.status) == int(ref.status) == qt.Status.CONVERGED
    np.testing.assert_allclose(port.x.numpy(), 1.0, rtol=1e-5)
    assert float(port.grad.abs().max()) < 1e-8
    if n == 8:
        assert counters(port) == counters(ref)
    port = qt.optimize_lbfgs(rosenbrock_logdensity, torch.tensor(x0), max_iterations=12,
                             direction_method=direction_method)
    ref = qj.optimize_lbfgs(jax_rosenbrock, jnp.asarray(x0), max_iterations=12,
                            direction_method=direction_method)
    assert counters(port) == counters(ref)
    for field in ("x", "S", "Y", "rho", "hist", "gamma", "fun"):
        np.testing.assert_allclose(getattr(port.state, field).numpy(),
                                   np.asarray(getattr(ref.state, field)), rtol=1e-9, atol=1e-9,
                                   err_msg=field)


def test_optimize_lbfgs_ill_conditioned_quadratic_matches_jax(rng):
    """tests/test_lbfgs.py:106-113, the JAX model's x_star carried across."""
    ref_model = JaxQuadratic(256, condition=1e4)
    model = IllConditionedQuadratic(256, condition=1e4, x_star=np.asarray(ref_model.x_star))
    x0 = rng.standard_normal(256)
    port = qt.optimize_lbfgs(model, torch.tensor(x0), history=10, max_iterations=5000)
    ref = qj.optimize_lbfgs(ref_model, jnp.asarray(x0), history=10, max_iterations=5000)
    assert int(port.status) == int(ref.status) == qt.Status.CONVERGED
    assert float(port.grad.abs().max()) < 1e-8
    assert abs(int(port.iterations) - int(ref.iterations)) <= 0.05 * int(ref.iterations)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref_model.x_star), atol=2e-4)


def test_optimize_lbfgs_large_n_and_wolfe_match_jax(rng):
    """The bench_full.py config-5 shape at n = 4096 (tests/test_lbfgs.py:
    135-146) and ``ls=Wolfe()``: every counter equal."""
    n = 4096
    diag = np.linspace(0.5, 3.0, n)
    dt, dj = torch.tensor(diag), jnp.asarray(diag)
    x0 = rng.standard_normal(n)
    port = qt.optimize_lbfgs(lambda x: -0.5 * torch.sum(dt * x * x), torch.tensor(x0),
                             max_iterations=500)
    ref = qj.optimize_lbfgs(lambda x: -0.5 * jnp.sum(dj * x * x), jnp.asarray(x0),
                            max_iterations=500)
    assert counters(port) == counters(ref)
    np.testing.assert_allclose(port.x.numpy(), 0.0, atol=1e-7)
    x0 = rng.standard_normal(10)
    port = qt.optimize_lbfgs(rosenbrock_logdensity, torch.tensor(x0), ls=qt.Wolfe(),
                             max_iterations=15)
    ref = qj.optimize_lbfgs(jax_rosenbrock, jnp.asarray(x0), ls=qj.Wolfe(), max_iterations=15)
    assert counters(port) == counters(ref)


def test_resume_from_a_numpy_jax_state(rng):
    """tests/test_lbfgs.py:149-154 across the packages: JAX's five-iteration
    state, saved as numpy, resumes in the port as in JAX."""
    x0 = rng.standard_normal(12)
    part = qj.optimize_lbfgs(jax_rosenbrock, jnp.asarray(x0), max_iterations=5)
    assert int(part.status) == qt.Status.MAX_ITERATIONS
    state = qt.lbfgs_state_from_numpy(jax.tree_util.tree_map(np.asarray, part.state),
                                      torch.device("cpu"))
    short = qt.optimize_lbfgs_from_state(rosenbrock_logdensity, state, max_iterations=9)
    ref = qj.optimize_lbfgs_from_state(jax_rosenbrock, part.state, max_iterations=9)
    assert counters(short) == counters(ref)
    np.testing.assert_allclose(short.state.S.numpy(), np.asarray(ref.state.S), atol=1e-9, rtol=0)
    res = qt.optimize_lbfgs_from_state(rosenbrock_logdensity, state)
    assert int(res.status) == qt.Status.CONVERGED
    # a chunked solve is the same solve as one long one
    mine = qt.optimize_lbfgs(rosenbrock_logdensity, torch.tensor(x0), max_iterations=5)
    long = qt.optimize_lbfgs(rosenbrock_logdensity, torch.tensor(x0))
    again = qt.optimize_lbfgs_from_state(rosenbrock_logdensity, mine.state)
    assert counters(again) == counters(long) and torch.equal(again.x, long.x)
    with pytest.raises(ValueError, match="single solve"):
        qt.optimize_lbfgs_from_state(rosenbrock_logdensity, qt.LBFGSState(*(
            leaf[None] for leaf in state)))


def test_failure_paths_match_jax():
    """tests/test_lbfgs.py:157-169: a line search that cannot leave x0
    (LINESEARCH_FAILURE, fun NaN, x unmoved), the iteration cap, and a
    non-finite start."""

    def cliff(x):
        return torch.where((x == 0.0).all(), torch.sum(x) + 1.0, torch.nan)

    def jax_cliff(x):
        return jnp.where(jnp.all(x == 0.0), jnp.sum(x) + 1.0, jnp.nan)

    cases = [
        (cliff, jax_cliff, np.zeros(3), dict(ls=(qt.BackTracking(iterations=20),
                                                 qj.BackTracking(iterations=20)))),
        (rosenbrock_logdensity, jax_rosenbrock, np.full(6, -1.5), dict(max_iterations=2)),
        (lambda x: torch.sum(x) / 0.0, lambda x: jnp.sum(x) / 0.0, np.ones(4), {}),
    ]
    expect = [qt.Status.LINESEARCH_FAILURE, qt.Status.MAX_ITERATIONS, qt.Status.NONFINITE_VALUE]
    for (p_f, j_f, x0, kw), status in zip(cases, expect):
        ls = kw.pop("ls", None)
        port = qt.optimize_lbfgs(p_f, torch.tensor(x0), **kw, **({"ls": ls[0]} if ls else {}))
        ref = qj.optimize_lbfgs(j_f, jnp.asarray(x0), **kw, **({"ls": ls[1]} if ls else {}))
        assert counters(port) == counters(ref)
        assert int(port.status) == status
        assert status == qt.Status.MAX_ITERATIONS or np.isnan(float(port.fun))
    np.testing.assert_array_equal(qt.optimize_lbfgs(cliff, torch.zeros(3, dtype=torch.float64)).x,
                                  np.zeros(3))


def test_a_failed_line_search_ends_the_loop_before_another_evaluation():
    """A search that cannot increase the objective (the gradient's sign is
    flipped, so the direction descends; three Armijo rounds) ends the solve
    LINESEARCH_FAILURE. JAX's loop condition stops there: the port calls
    the objective exactly as often (counted in JAX at run time by a debug
    callback), with the same counters."""
    diag = np.arange(1.0, 5.0)
    x0 = np.ones(4)
    calls = {"port": [0, 0], "jax": [0, 0]}  # [value calls, value-and-gradient calls]
    d_t, d_j = torch.tensor(diag), jnp.asarray(diag)

    def port_f(x):
        calls["port"][0] += 1
        return -0.5 * torch.sum(d_t * x * x)

    def port_vag(x):
        calls["port"][1] += 1
        return -0.5 * torch.sum(d_t * x * x), d_t * x

    def count(i):
        calls["jax"][i] += 1

    def jax_f(x):
        jax.debug.callback(lambda: count(0))
        return -0.5 * jnp.sum(d_j * x * x)

    def jax_vag(x):
        jax.debug.callback(lambda: count(1))
        return -0.5 * jnp.sum(d_j * x * x), d_j * x

    port = qt.optimize_lbfgs(port_f, torch.tensor(x0), ls=qt.BackTracking(iterations=3),
                             value_and_grad_fn=port_vag)
    ref = qj.optimize_lbfgs(jax_f, jnp.asarray(x0), ls=qj.BackTracking(iterations=3),
                            value_and_grad_fn=jax_vag)
    jax.effects_barrier()
    assert int(port.status) == qt.Status.LINESEARCH_FAILURE
    assert counters(port) == counters(ref)
    assert calls["port"] == calls["jax"] == [4, 1]
    np.testing.assert_array_equal(port.x.numpy(), x0)


def test_host_syncs_and_validation(rng):
    """One read per iteration (this evaluation's status) and the line
    search's; a resume reads k once more."""
    diag = torch.arange(1.0, 7.0, dtype=torch.float64)

    def quad(x):
        return -0.5 * torch.sum(diag * x * x)

    qt.optimize_lbfgs.host_syncs = 0
    res = qt.optimize_lbfgs(quad, torch.tensor(rng.standard_normal(6)))
    iters, fev = int(res.iterations), int(res.n_fev)
    trials = fev - (iters + 1)  # n_fev less the top evaluations (the last one too)
    # each search reads once per trial: its rounds, plus the read that ends it
    assert qt.optimize_lbfgs.host_syncs == (iters + 1) + trials
    with pytest.raises(ValueError, match="direction_method"):
        qt.optimize_lbfgs(quad, torch.zeros(6, dtype=torch.float64), direction_method="dense")
    with pytest.raises(ValueError, match="rank-1"):
        qt.optimize_lbfgs(quad, torch.zeros((2, 6)))
