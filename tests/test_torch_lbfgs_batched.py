"""The port's L-BFGS fleet (lbfgs_batched_solve.py, `optimize_lbfgs_batched`)
against the JAX package's fused fleet, on the same numpy inputs in f64 on
the CPU, mirroring tests/test_lbfgs.py:172-495; and the device rule of
every entry point this slice adds.

Over short horizons (caps 0, 1 and 5) statuses and every counter are equal
and the floats agree to 1e-10, for the shift ring (n = 16) and the
circular ring (n = 256). Run to convergence, Rosenbrock trajectories of
~200 iterations part by rounding (torch and XLA sum in different orders;
tests/test_torch_solve.py says why), so there the statuses and the
certificate must be equal. Within the port, the two rings and the two Gram
strategies are compared directly, as tests/test_lbfgs.py compares JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
from quasinewtonmethods_jl_tpu import lbfgs_batched_solve as jax_lbs
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch import lbfgs_batched_solve as lbs
from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity
from quasinewtonmethods_jl_tpu_torch.utils import device as device_module

torch.set_num_threads(1)

COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")
STATE_FLOATS = ("x", "grad", "grad_old", "step", "S", "Y", "rho", "gamma", "fun")
ENGINE = qt.optimize_lbfgs_batched


def assert_counters_equal(port, ref):
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


def assert_state_close(port, ref, atol=1e-10):
    """Floats within atol, or 1e-10 relative (rho = 1/sᵀy reaches 1e12)."""
    np.testing.assert_array_equal(port.state.hist.numpy(), np.asarray(ref.state.hist))
    for name in STATE_FLOATS:
        np.testing.assert_allclose(getattr(port.state, name).numpy(),
                                   np.asarray(getattr(ref.state, name)), atol=atol, rtol=1e-10,
                                   err_msg=name)


def _quad(x):
    diag = torch.linspace(1.0, 4.0, x.shape[0], dtype=x.dtype)
    return -0.5 * torch.sum(diag * x * x)


def _jax_quad(x):
    diag = jnp.linspace(1.0, 4.0, x.shape[0]).astype(x.dtype)
    return -0.5 * jnp.sum(diag * x * x)


@pytest.mark.parametrize("n", [16, 256])  # shift ring / circular ring
def test_fleet_matches_jax_over_short_caps_and_statuses_to_convergence(rng, monkeypatch, n):
    """Both packages' rings chosen by the JAX package's n >= 192."""
    monkeypatch.setattr(lbs, "_RING_CIRCULAR_MIN_N", jax_lbs._RING_CIRCULAR_MIN_N)
    X0 = rng.standard_normal((8, n))
    kw = dict(history=5, tol=1e-6)
    for cap in (0, 1, 5):
        port = ENGINE(rosenbrock_logdensity, torch.tensor(X0), max_iterations=cap, **kw)
        ref = qj.optimize_lbfgs_batched(jax_rosenbrock, jnp.asarray(X0), max_iterations=cap, **kw)
        assert_counters_equal(port, ref)
        assert_state_close(port, ref)
    port = ENGINE(rosenbrock_logdensity, torch.tensor(X0), **kw)
    ref = qj.optimize_lbfgs_batched(jax_rosenbrock, jnp.asarray(X0), **kw)
    np.testing.assert_array_equal(port.status.numpy(), np.asarray(ref.status))
    assert (port.status == qt.Status.CONVERGED).all()
    assert float(port.grad.abs().max()) < 1e-6
    np.testing.assert_allclose(port.x.numpy(), 1.0, atol=1e-5)


def test_fleet_on_a_quadratic_matches_jax_in_every_counter(rng):
    """A stable trajectory (a diagonal quadratic converges in a few
    iterations): every counter and the state equal to convergence, and a
    lane matches the scalar driver (tests/test_lbfgs.py:172-183)."""
    X0 = rng.standard_normal((12, 24)) * 2.0
    port = ENGINE(_quad, torch.tensor(X0), history=10)
    ref = qj.optimize_lbfgs_batched(_jax_quad, jnp.asarray(X0), history=10)
    assert_counters_equal(port, ref)
    assert_state_close(port, ref)
    single = qt.optimize_lbfgs(_quad, torch.tensor(X0[5]), history=10)
    torch.testing.assert_close(port.x[5], single.x, atol=1e-8, rtol=0)


def test_circular_direction_matches_shift_direction(rng):
    """tests/test_lbfgs.py:212-253: for every (hist, head) — partial
    window, full ring, wrapped head, empty history — the circular form
    (stale slots holding garbage) reproduces the shift form."""
    m, n, batch = 4, 8, 3
    for hist_val, head_val in [(2, 2), (4, 0), (4, 2), (3, 1), (0, 0)]:
        S_can = np.zeros((batch, m, n))
        Y_can = np.zeros((batch, m, n))
        S_circ = rng.standard_normal((batch, m, n))
        Y_circ = rng.standard_normal((batch, m, n))
        for t in range(hist_val):
            s_ = rng.standard_normal((batch, n))
            y_ = rng.standard_normal((batch, n))
            y_ += s_ * (np.abs((s_ * y_).sum(1)) / (s_ * s_).sum(1) + 1.0)[:, None]  # sᵀy > 0
            p = (t + head_val - hist_val) % m
            S_can[:, t], Y_can[:, t] = s_, y_
            S_circ[:, p], Y_circ[:, p] = s_, y_
        g = torch.tensor(rng.standard_normal((batch, n)))
        gamma = torch.tensor(np.abs(rng.standard_normal(batch)) + 0.5)
        hist = torch.full((batch,), hist_val, dtype=torch.int32)
        head = torch.full((batch,), head_val, dtype=torch.int32)
        d_s, m_s = lbs._batched_compact_direction_shift(torch.tensor(S_can), torch.tensor(Y_can),
                                                        hist, gamma, g)
        d_c, m_c = lbs._batched_compact_direction(torch.tensor(S_circ), torch.tensor(Y_circ), hist,
                                                  head, gamma, g)
        torch.testing.assert_close(d_c, d_s, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(m_c, m_s, rtol=1e-12, atol=1e-12)
        # and JAX's circular form on its lane-minor layout
        ref = jax_lbs._batched_compact_direction(
            *(jnp.asarray(np.moveaxis(a, 0, -1)) for a in (S_circ, Y_circ)), jnp.asarray(hist.numpy()),
            jnp.asarray(head.numpy()), jnp.asarray(gamma.numpy()), jnp.asarray(g.numpy().T))
        np.testing.assert_allclose(d_c.numpy(), np.asarray(ref[0]).T, rtol=1e-12, atol=1e-12)


def test_shift_direction_after_a_reset_copies_jax(rng):
    """ROADMAP.md C5: after a reset the shift ring keeps stale pairs above
    ``hist``, and JAX's shift direction lets them in; the port copies that
    (the circular ring and the scalar compact form mask them)."""
    m, n, batch = 4, 7, 3
    S = rng.standard_normal((batch, m, n)) * 0.1
    Y = S * 1.5 + 0.01 * rng.standard_normal((batch, m, n))
    g = rng.standard_normal((batch, n))
    hist = np.array([1, 2, 0], dtype=np.int32)
    gamma = np.array([0.7, 1.0, 1.3])
    port = lbs._batched_compact_direction_shift(*(torch.tensor(a) for a in (S, Y, hist, gamma, g)))
    ref = jax_lbs._batched_compact_direction_shift(
        jnp.asarray(np.moveaxis(S, 0, -1)), jnp.asarray(np.moveaxis(Y, 0, -1)), jnp.asarray(hist),
        jnp.asarray(gamma), jnp.asarray(g.T))
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]).T, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(port[1].numpy(), np.asarray(ref[1]), rtol=1e-12, atol=1e-12)
    masked = qt.ops.lbfgs_compact.lbfgs_direction_compact(
        torch.tensor(S[0]), torch.tensor(Y[0]), None, torch.tensor(hist[0]), torch.tensor(gamma[0]),
        torch.tensor(g[0]))
    assert not torch.allclose(port[0][0], masked[0])  # the stale pairs moved it


def test_incremental_gram_matches_recompute(rng):
    """tests/test_lbfgs.py:256-319: carrying SᵀY and YᵀY and writing only
    the pushed row and column reproduces the recompute, through partial
    windows, wraparound and rejected pushes."""
    m, n, batch = 5, 9, 6

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float64)

    ring = [zeros(batch, m, n), zeros(batch, m, n), zeros(batch, m),
            torch.zeros(batch, dtype=torch.int32), torch.zeros(batch, dtype=torch.int32),
            torch.ones(batch, dtype=torch.float64)]
    SY, YY = zeros(batch, m, m), zeros(batch, m, m)
    ring2 = list(ring)
    for it in range(2 * m + 3):
        step = torch.tensor(rng.standard_normal((batch, n)))
        y = -step if it % 3 == 2 else torch.tensor(rng.standard_normal((batch, n)))
        g = torch.tensor(rng.standard_normal((batch, n)))
        active = torch.tensor(rng.random(batch) > 0.25)
        *ring, SY, YY, Sg, Yg = lbs._batched_push_incr(*ring, SY, YY, step, y, g, active)
        S, Y, _rho, hist, head, gamma = ring
        d_i, m_i = lbs._compact_direction_from_grams(SY, YY, Sg, Yg, S, Y, hist, head, gamma, g)
        ring2 = list(lbs._batched_push_circular(*ring2, step, y, active))
        d_r, m_r = lbs._batched_compact_direction(ring2[0], ring2[1], ring2[3], ring2[4], ring2[5], g)
        for a, b in zip(ring, ring2):
            assert torch.equal(a, b)
        torch.testing.assert_close(SY, S @ Y.mT, atol=1e-13, rtol=0)
        torch.testing.assert_close(YY, Y @ Y.mT, atol=1e-13, rtol=0)
        torch.testing.assert_close(d_i, d_r, rtol=1e-9, atol=1e-9)
        torch.testing.assert_close(m_i, m_r, rtol=1e-9, atol=1e-9)


def test_rings_and_gram_strategies_solve_alike(rng, monkeypatch):
    """tests/test_lbfgs.py:352-416 (history 3: many wraps). JAX finds its
    circular and shift engines equal bit for bit; the port's sum the ring
    in slot and in time order, which rounds differently, so they match in
    every counter over 20 iterations (x within 1e-9; the rounding difference
    grows along the trajectory) and in statuses to convergence. The incremental Grams give the same
    statuses, and a fleet lane's exported state (canonical time order)
    resumes the scalar driver."""
    X0 = torch.tensor(rng.standard_normal((4, 256)))
    kw = dict(history=3, tol=1e-6)
    runs = {}
    for ring, limit in (("circular", 1), ("shift", 10**9)):
        monkeypatch.setattr(lbs, "_RING_CIRCULAR_MIN_N", limit)
        runs[ring] = ENGINE(rosenbrock_logdensity, X0, **kw)
        runs[ring, 20] = ENGINE(rosenbrock_logdensity, X0, max_iterations=20, **kw)
        if ring == "circular":
            runs["incremental"] = lbs.optimize_lbfgs_batched_fused(rosenbrock_logdensity, X0,
                                                                   incremental_gram=True, **kw)
    circ, shift = runs["circular"], runs["shift"]
    for name in COUNTERS:
        assert torch.equal(getattr(runs["circular", 20], name), getattr(runs["shift", 20], name))
    torch.testing.assert_close(runs["circular", 20].x, runs["shift", 20].x, rtol=0, atol=1e-9)
    torch.testing.assert_close(runs["circular", 20].state.S, runs["shift", 20].state.S, rtol=0,
                               atol=1e-9)
    assert torch.equal(circ.status, shift.status) and torch.equal(runs["incremental"].status,
                                                                   circ.status)
    assert (circ.status == qt.Status.CONVERGED).all()
    torch.testing.assert_close(circ.x, shift.x, rtol=0, atol=1e-5)
    lane = qt.LBFGSState(*(leaf[0] for leaf in circ.state))
    res = qt.optimize_lbfgs_from_state(rosenbrock_logdensity, lane, tol=1e-9)
    assert int(res.status) == qt.Status.CONVERGED


@pytest.mark.parametrize("ring, incremental_gram",
                         [("shift", False), ("circular", False), ("circular", True)])
def test_short_caps_match_jax_on_either_ring(rng, monkeypatch, ring, incremental_gram):
    """The ring is chosen by the dispatch constant, whatever n: each ring
    (and the circular ring's incremental Grams) against JAX's engine on the
    same ring."""
    X0 = rng.standard_normal((6, 12))
    monkeypatch.setattr(lbs, "_RING_CIRCULAR_MIN_N", 1 if ring == "circular" else 10**9)
    monkeypatch.setattr(jax_lbs, "_RING_CIRCULAR_MIN_N", 1 if ring == "circular" else 10**9)
    port = lbs.optimize_lbfgs_batched_fused(rosenbrock_logdensity, torch.tensor(X0), history=3,
                                            max_iterations=9, incremental_gram=incremental_gram)
    ref = jax_lbs.optimize_lbfgs_batched_fused(jax_rosenbrock, jnp.asarray(X0), history=3,
                                               max_iterations=9, incremental_gram=incremental_gram)
    jax_lbs._optimize_lbfgs_batched_fused_jit._clear_cache()
    assert_counters_equal(port, ref)
    assert_state_close(port, ref, atol=1e-9)


@pytest.mark.parametrize("n", [16, 200])
def test_resume_from_a_numpy_state(rng, monkeypatch, n):
    """tests/test_lbfgs.py:419-460, n = 200 on the circular ring in both
    packages (the JAX package's dispatch): a four-iteration fleet saved as
    numpy resumes to convergence as in JAX, and a chunked solve is one
    long solve."""
    monkeypatch.setattr(lbs, "_RING_CIRCULAR_MIN_N", jax_lbs._RING_CIRCULAR_MIN_N)
    X0 = rng.standard_normal((6, n))
    part = ENGINE(_quad, torch.tensor(X0), history=5, max_iterations=4)
    assert (part.status == qt.Status.MAX_ITERATIONS).all() and int(part.state.hist.max()) > 0
    saved = qt.lbfgs_state_to_numpy(part.state)
    restored = qt.lbfgs_state_from_numpy(saved, torch.device("cpu"))
    res = qt.optimize_lbfgs_batched_fused_from_state(_quad, restored)
    assert (res.status == qt.Status.CONVERGED).all() and (res.iterations > 4).all()
    np.testing.assert_allclose(res.x.numpy(), 0.0, atol=1e-7)
    full = ENGINE(_quad, torch.tensor(X0), history=5)
    assert torch.equal(res.iterations, full.iterations)
    torch.testing.assert_close(res.x, full.x, atol=1e-10, rtol=0)
    ref_part = qj.optimize_lbfgs_batched(_jax_quad, jnp.asarray(X0), history=5, max_iterations=4)
    ref = qj.optimize_lbfgs_batched_fused_from_state(_jax_quad, ref_part.state)
    assert_counters_equal(res, ref)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-10, rtol=0)
    # the resume left its state unchanged
    for a, b in zip(restored, saved):
        np.testing.assert_array_equal(a.numpy(), b)


def test_resume_of_never_stepped_lanes_and_scalar_state_rejection(rng):
    """tests/test_lbfgs.py:463-495."""
    X0 = torch.tensor(rng.standard_normal((4, 12)))

    def quad(x):
        return -0.5 * torch.sum(x * x)

    part = ENGINE(quad, X0, history=4, max_iterations=0)
    assert (part.state.k == 0).all()
    res = qt.optimize_lbfgs_batched_fused_from_state(quad, part.state)
    assert (res.status == qt.Status.CONVERGED).all()
    torch.testing.assert_close(res.x, torch.zeros_like(res.x), atol=1e-8, rtol=0)
    single = qt.optimize_lbfgs(quad, X0[0])
    with pytest.raises(ValueError, match="batched"):
        qt.optimize_lbfgs_batched_fused_from_state(quad, single.state)
    with pytest.raises(ValueError, match=r"\(batch, n\)"):
        ENGINE(quad, torch.zeros(8))


def test_wolfe_fleet_matches_jax(rng):
    X0 = rng.standard_normal((8, 10))
    for cap in (1, 5):
        port = ENGINE(rosenbrock_logdensity, torch.tensor(X0), ls=qt.Wolfe(), max_iterations=cap)
        ref = qj.optimize_lbfgs_batched(jax_rosenbrock, jnp.asarray(X0), ls=qj.Wolfe(),
                                        max_iterations=cap)
        assert_counters_equal(port, ref)
        assert_state_close(port, ref)
    port = ENGINE(rosenbrock_logdensity, torch.tensor(X0), ls=qt.Wolfe())
    assert (port.status == qt.Status.CONVERGED).all()
    assert torch.equal(port.n_fev, port.n_gev)  # every Wolfe trial is value+gradient


def test_vmap_backend_matches_jax_vmap(rng):
    """backend='vmap': the scalar driver lane by lane, against JAX's vmap of
    its scalar driver, with either direction method."""
    X0 = rng.standard_normal((4, 10))
    for method in ("compact", "two_loop"):
        port = ENGINE(rosenbrock_logdensity, torch.tensor(X0), backend="vmap", max_iterations=5,
                      direction_method=method)
        ref = qj.optimize_lbfgs_batched(jax_rosenbrock, jnp.asarray(X0), backend="vmap",
                                        max_iterations=5, direction_method=method)
        assert_counters_equal(port, ref)
        assert_state_close(port, ref, atol=1e-9)
    with pytest.raises(ValueError, match="backend"):
        ENGINE(rosenbrock_logdensity, torch.tensor(X0), backend="sharded")
    with pytest.raises(TypeError, match="incremental_gram"):  # the fused engine's own option
        ENGINE(rosenbrock_logdensity, torch.tensor(X0), incremental_gram=True)


@pytest.mark.parametrize("entry", ["optimize_batched", "optimize_lbfgs_batched"])
def test_vmap_backend_on_an_empty_fleet_matches_jax(entry):
    """A 0 x 4 fleet gives empty results with JAX's leaf shapes and dtypes."""
    X0 = np.zeros((0, 4))
    port = getattr(qt, entry)(rosenbrock_logdensity, torch.tensor(X0), backend="vmap")
    ref = getattr(qj, entry)(jax_rosenbrock, jnp.asarray(X0), backend="vmap")
    leaves = [(name, getattr(port, name), getattr(ref, name)) for name in port._fields[:-1]]
    leaves += [(f"state.{name}", getattr(port.state, name), getattr(ref.state, name))
               for name in port.state._fields]
    assert port.state._fields == ref.state._fields
    for name, mine, theirs in leaves:
        theirs = np.asarray(theirs)
        assert mine.numpy().shape == theirs.shape and mine.numpy().dtype == theirs.dtype, name


def test_host_syncs_and_loop_bodies(rng):
    """A termination read every TERMINATION_CHECK_INTERVAL bodies and the
    line search's reads (one per round plus the last), counted; the bodies
    after the last lane finished change nothing."""
    fused = lbs.optimize_lbfgs_batched_fused  # its counters serve the resume too
    X0 = torch.tensor(rng.standard_normal((8, 6)))
    fused.host_syncs = fused.loop_bodies = 0
    res = ENGINE(_quad, X0)
    bodies, syncs = fused.loop_bodies, fused.host_syncs
    last = int(res.iterations.max())
    assert last <= bodies - 1 <= last + lbs.TERMINATION_CHECK_INTERVAL
    # each body's search reads at least once; a termination read every 8
    assert syncs >= bodies + bodies // lbs.TERMINATION_CHECK_INTERVAL
    tail = ENGINE(_quad, X0, max_iterations=bodies)
    for name in COUNTERS:
        assert torch.equal(getattr(res, name), getattr(tail, name)), name
    assert torch.equal(res.x, tail.x)


def _spy_cuda(monkeypatch):
    """Pretend a card exists and record the devices asked for (this
    CPU-only torch cannot make a CUDA tensor)."""
    seen = []
    real = torch.as_tensor

    def as_tensor(data, *args, device=None, **kw):
        if device is not None:
            seen.append(str(device))
        return real(data, *args, **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(device_module.torch, "as_tensor", as_tensor)
    return seen


X0_ENTRIES = {
    "optimize": lambda x0, **kw: qt.optimize(rosenbrock_logdensity, x0[0], **kw),
    "optimize_lbfgs": lambda x0, **kw: qt.optimize_lbfgs(rosenbrock_logdensity, x0[0], **kw),
    "optimize_lbfgs_batched": lambda x0, **kw: ENGINE(rosenbrock_logdensity, x0, **kw),
    "optimize_lbfgs_batched vmap": lambda x0, **kw: ENGINE(rosenbrock_logdensity, x0,
                                                           backend="vmap", **kw),
    "optimize_batched vmap": lambda x0, **kw: qt.optimize_batched(rosenbrock_logdensity, x0,
                                                                  backend="vmap", **kw),
}


@pytest.mark.parametrize("entry", sorted(X0_ENTRIES))
def test_numpy_input_goes_to_the_card_in_f32(monkeypatch, rng, entry):
    seen = _spy_cuda(monkeypatch)
    res = X0_ENTRIES[entry](rng.standard_normal((3, 6)), max_iterations=2)
    assert seen == ["cuda"] and res.x.dtype == torch.float32


@pytest.mark.parametrize("entry", sorted(X0_ENTRIES))
def test_numpy_input_without_a_card_raises_and_cpu_tensors_stay(monkeypatch, rng, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
        X0_ENTRIES[entry](rng.standard_normal((3, 6)), max_iterations=2)
    seen = _spy_cuda(monkeypatch)
    res = X0_ENTRIES[entry](torch.tensor(rng.standard_normal((3, 6))), max_iterations=2)
    assert seen == [] and res.x.device.type == "cpu" and res.x.dtype == torch.float64


def _saved(resume, rng):
    """(entry point, numpy state) of a two-iteration f64 solve."""
    if resume == "optimize_from_state":
        res = qt.optimize(rosenbrock_logdensity, torch.tensor(rng.standard_normal(6)),
                          max_iterations=2)
        return qt.optimize_from_state, qt.bfgs_state_to_numpy(res.state)
    if resume == "optimize_lbfgs_from_state":
        res = qt.optimize_lbfgs(rosenbrock_logdensity, torch.tensor(rng.standard_normal(6)),
                                max_iterations=2)
        return qt.optimize_lbfgs_from_state, qt.lbfgs_state_to_numpy(res.state)
    res = ENGINE(rosenbrock_logdensity, torch.tensor(rng.standard_normal((3, 6))), max_iterations=2)
    return qt.optimize_lbfgs_batched_fused_from_state, qt.lbfgs_state_to_numpy(res.state)


RESUMES = ["optimize_from_state", "optimize_lbfgs_from_state",
           "optimize_lbfgs_batched_fused_from_state"]


@pytest.mark.parametrize("resume", RESUMES)
def test_numpy_state_goes_to_the_card_and_raises_without_one(monkeypatch, rng, resume):
    entry, saved = _saved(resume, rng)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="state.x is a ndarray.*pass a CPU torch.Tensor"):
        entry(rosenbrock_logdensity, saved, max_iterations=2)
    seen = _spy_cuda(monkeypatch)
    res = entry(rosenbrock_logdensity, saved, max_iterations=4)
    assert seen == ["cuda"] * len(saved) and res.x.dtype == torch.float32
    assert res.x.shape == saved.x.shape
