"""The port's augmented Lagrangian (constrained.py) against the JAX
package's, on the same numpy inputs in f64, mirroring
tests/test_constrained.py: equality, inequality and both, over all four
inner engines, as a single solve and as a fleet, with and without
``constraint_data``.

Statuses and every counter (n_outer, iterations, n_fev, inner_status) must
be equal lane by lane; floats within rtol 1e-8 of the problem's scale
(x*, λ*, μ* and the constraint values are O(1): atol 1e-8; the residuals
are differences of O(1) numbers), or, for the
line-search engines, where JAX's result moves more than that when its
start moves by one ulp up or down (the rounding witnesses, each used where
its counters equal JAX's), within twice that movement: the repo's rule for
rounding witnesses (chip_smoke.py's ROUNDING_FACTOR).
The multiplier update λ += ρ·h multiplies the rounding of the constraint
residuals by ρ, which reaches 1e3-1e4 in the last rounds, and the inner
line searches end wherever max|∇L| < tol first holds, so λ, μ and the
residuals carry that rounding at 1e-8-1e-7 relative in either package.
The fixtures keep the augmented objective's trajectories stable (an
isotropic quadratic objective, a linear equality and a disk): as ρ grows,
the inner solves' conditioning grows with it, and on a chaotic objective
rounding alone moves inner iteration counts (CG most, as
tests/test_torch_cg.py notes: with weights 1, 2, 3 on the quadratic, the
CG fleet's counts already differ by a few).
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qnm
import quasinewtonmethods_jl_tpu_torch as qt

jax_con = importlib.import_module("quasinewtonmethods_jl_tpu.constrained")
port_con = importlib.import_module("quasinewtonmethods_jl_tpu_torch.constrained")

torch.set_num_threads(1)

COUNTERS = ("status", "n_outer", "iterations", "n_fev", "inner_status")
FLOATS = ("x", "fun", "grad", "lam", "mu", "rho", "viol", "eq", "ineq", "last_value")
ENGINES = ("bfgs", "lbfgs", "cg", "tr")
KINDS = ("eq", "ineq", "both")
N = 3
TARGET = np.array([2.0, 1.0, 0.5])


def _np(res):
    return {name: np.asarray(getattr(res, name)) if not isinstance(getattr(res, name), torch.Tensor)
            else getattr(res, name).numpy() for name in COUNTERS + FLOATS}


def assert_same(port, ref, witnesses=(), rtol=1e-8, atol=1e-8):
    """Counters equal; floats within rtol, or twice a witness's movement
    (``witnesses``: pairs (result, its package's result from the unmoved
    start), each used where its counters equal that result's)."""
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    moved = [(_np(w), _np(base)) for w, base in witnesses]
    moved = [(w, b) for w, b in moved if all(np.array_equal(w[c], b[c]) for c in COUNTERS)]
    for name in FLOATS:
        a, b = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        bound = rtol * np.abs(b) + atol
        for w, base in moved:
            bound = np.maximum(bound, 2 * np.abs(w[name] - base[name]))
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        ok = ~np.isnan(b)
        assert (np.abs(a - b)[ok] <= bound[ok]).all(), (name, np.abs(a - b).max())


def f_port(z):
    return -torch.sum((z - torch.tensor(TARGET, dtype=z.dtype)) ** 2)


def f_jax(z):
    return -jnp.sum((z - jnp.asarray(TARGET)) ** 2)


def constraints(kind, data=False):
    """(port kw, jax kw): eq sum(z) = 1; ineq r² − z·z >= 0 (r² = 1.5, or
    the lane's data) and z₂ >= 0.2."""
    out = []
    for xp in (torch, jnp):
        def eq(z, *_data):
            return z.sum() - 1.0

        if data:
            def ineq(z, r2, xp=xp):
                return xp.stack([r2 - (z * z).sum(), z[2] - 0.2])
        else:
            def ineq(z, xp=xp):
                return xp.stack([1.5 - (z * z).sum(), z[2] - 0.2])

        out.append({"eq": eq if kind != "ineq" else None, "ineq": ineq if kind != "eq" else None})
    return out


def _both(x0, kind, engine, data=None, witness=False, **kw):
    """The port's and JAX's solves; with ``witness`` also the witnesses
    for `assert_same` (each package from x0 one ulp up)."""
    port_kw, jax_kw = constraints(kind, data is not None)

    def port(x):
        return qt.optimize_auglag(f_port, torch.tensor(x), engine=engine, **port_kw,
                                  constraint_data=None if data is None else torch.tensor(data), **kw)

    def ref(x):
        return qnm.optimize_auglag(f_jax, jnp.asarray(x), engine=engine, **jax_kw,
                                   constraint_data=None if data is None else jnp.asarray(data), **kw)

    p, r = port(x0), ref(x0)
    if witness:
        # TR's Newton steps agree to ~1e-14: its floats need no witness
        wits = () if engine == "tr" else tuple(
            (ref(np.nextafter(x0, side)), r) for side in (np.inf, -np.inf))
        return p, r, wits
    return p, r


def test_result_layout_matches_jax():
    assert qt.AugLagResult._fields == jax_con.AugLagResult._fields
    port = set(inspect.signature(qt.optimize_auglag).parameters)
    ref = set(inspect.signature(qnm.optimize_auglag).parameters)
    assert port == ref - {"block_batch"}  # the TPU's Pallas blocks


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("engine", ENGINES)
def test_single_solve_matches_jax(engine, kind):
    x0 = np.array([0.3, -0.2, 0.6])
    port, ref, wit = _both(x0, kind, engine, tol=1e-6, ctol=1e-6, witness=True)
    assert_same(port, ref, wit)
    assert bool(port.converged) and port.x.shape == (N,)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("engine", ENGINES)
def test_fleet_matches_jax(engine, kind):
    X0 = np.random.default_rng(1).standard_normal((5, N)) * 0.5
    port, ref, wit = _both(X0, kind, engine, tol=1e-6, ctol=1e-6, witness=True)
    assert_same(port, ref, wit)
    assert port.converged.all()


@pytest.mark.parametrize("engine", ENGINES)
def test_constraint_data_matches_jax(engine):
    """Per-lane feasible sets (fleet, one radius a lane) and one solve
    given its data whole. On the tightest lane (r² = 0.5) ρ reaches 1e4,
    and the L-BFGS and CG inner solves' rounding then reaches λ at
    1e-7 relative, a few times what one ulp of the start does to JAX's:
    those two engines are held over the first two outer rounds there."""
    X0 = np.random.default_rng(2).standard_normal((4, N)) * 0.5
    r2 = np.array([0.5, 1.5, 3.0, 100.0])
    whole = engine in ("bfgs", "tr")
    kw = {} if whole else {"max_outer": 2}
    port, ref, wit = _both(X0, "both", engine, data=r2, tol=1e-6, ctol=1e-6, witness=True, **kw)
    assert_same(port, ref, wit)
    assert port.converged.all() or not whole
    port, ref, wit = _both(X0[0], "ineq", engine, data=np.float64(0.8), tol=1e-6, ctol=1e-6,
                           witness=True)
    assert_same(port, ref, wit)
    assert bool(port.converged)


def test_warm_start_and_heterogeneous_lanes_match_jax():
    """Warm multipliers per lane (a (batch, m) lam0) and an (m,) mu0
    broadcast: lanes finish in different outer rounds."""
    X0 = np.zeros((3, N))
    lam0 = np.array([[1.0], [0.0], [3.0]])
    port, ref, wit = _both(X0, "both", "bfgs", lam0=lam0, mu0=np.array([0.5, 0.0]), tol=1e-6,
                           ctol=1e-6, witness=True)
    assert_same(port, ref, wit)
    assert len(set(port.n_outer.tolist())) > 1


@pytest.mark.parametrize("max_outer, max_iterations", [(1, 0), (1, 1), (2, 5)])
def test_short_budgets_match_jax(max_outer, max_iterations):
    """Outer and inner caps (the caps chip_smoke.py holds B1 to): unfinished
    lanes end MAX_ITERATIONS with fun NaN and last_value finite."""
    X0 = np.random.default_rng(3).standard_normal((6, N))
    port, ref = _both(X0, "both", "bfgs", max_outer=max_outer, max_iterations=max_iterations)
    assert_same(port, ref)
    assert (port.status == qt.Status.MAX_ITERATIONS).all()
    assert torch.isnan(port.fun).all() and torch.isfinite(port.last_value).all()


def test_hard_inner_failure_and_infeasibility_match_jax():
    def bad_port(z):
        return torch.where(z[0] > 0.5, torch.nan, -torch.sum(z * z))

    def bad_jax(z):
        return jnp.where(z[0] > 0.5, jnp.nan, -jnp.sum(z * z))

    X0 = np.array([[1.0, 0.0], [0.0, 0.0]])
    port = qt.optimize_auglag(bad_port, torch.tensor(X0), eq=lambda z: z[0] + z[1] - 1.0,
                              max_outer=9)
    ref = qnm.optimize_auglag(bad_jax, jnp.asarray(X0), eq=lambda z: z[0] + z[1] - 1.0,
                              max_outer=9)
    assert_same(port, ref)
    assert port.status[0] == qt.Status.NONFINITE_VALUE and port.n_outer[0] == 1

    # infeasible: x = 1 and x = 2. From rho = 1e5 (round 5) on, the
    # Wolfe search's tests on this 1-d quadratic meet rounding (the port
    # takes one more trial there), so the budget stops at round 4
    port = qt.optimize_auglag(lambda z: -torch.sum(z * z), torch.zeros(1, dtype=torch.float64),
                              eq=lambda z: torch.stack([z[0] - 1.0, z[0] - 2.0]), max_outer=4)
    ref = qnm.optimize_auglag(lambda z: -jnp.sum(z * z), jnp.zeros(1),
                              eq=lambda z: jnp.stack([z[0] - 1.0, z[0] - 2.0]), max_outer=4)
    assert_same(port, ref)
    assert int(port.status) == qt.Status.MAX_ITERATIONS and int(port.n_outer) == 4
    assert float(port.viol) > 0.1 and torch.isnan(port.fun)


def test_max_zero_subgradient_at_the_kink_is_jaxs():
    """max(0, μ − ρc) at a tie: JAX's derivative there is ½ in both modes;
    torch.clamp_min's would be 1. The penalty's gradient and Hessian at a
    point exactly on the kink equal JAX's."""
    def ineq_port(z):
        return torch.atleast_1d(1.0 - z[0] + 0.0 * z[1])

    def ineq_jax(z):
        return jnp.atleast_1d(1.0 - z[0] + 0.0 * z[1])

    pen = port_con._make_penalty(None, ineq_port, torch.float64)
    pen_j = jax_con._fleet_penalty_fns(None, ineq_jax, jnp.sum, jnp.sum, jnp.float64)[0]
    x = np.zeros(2)
    args = (np.zeros(0), np.array([10.0]), 10.0)  # μ − ρc(x) = 10 − 10·1 = 0
    targs = [torch.tensor(a, dtype=torch.float64) for a in args]
    H = torch.func.hessian(pen)(torch.tensor(x), *targs)
    H_j = jax.hessian(pen_j)(jnp.asarray(x), *map(jnp.asarray, args))
    np.testing.assert_allclose(H.numpy(), np.asarray(H_j), rtol=1e-15)
    assert float(H[0, 0]) == 0.25 * 10.0  # ρ·(½)², not ρ·1²
    g = torch.func.grad(pen)(torch.tensor(x), *targs)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jax.grad(pen_j)(jnp.asarray(x),
                                                                       *map(jnp.asarray, args))))
    # the TR engine's first HVPs start on the kink
    x0 = np.zeros((2, 2))
    port = qt.optimize_auglag(lambda z: -torch.sum((z - 2.0) ** 2), torch.tensor(x0),
                              ineq=ineq_port, mu0=np.array([10.0]), engine="tr", max_outer=2)
    ref = qnm.optimize_auglag(lambda z: -jnp.sum((z - 2.0) ** 2), jnp.asarray(x0),
                              ineq=ineq_jax, mu0=jnp.asarray([10.0]), engine="tr", max_outer=2)
    assert_same(port, ref)


def test_tr_inner_fleet_hardcodes_its_settings_as_jax_does():
    """ROADMAP.md C.3, the port's choice: copy the reference. The TR inner
    fleet runs with delta0 1, delta_max 1e6, eta_accept 1e-4, max_cg
    min(n, 64) and cg_tol 1 whatever the caller wants (no keyword reaches
    them, in either package): one outer round equals `optimize_tr` with
    those settings on the augmented objective."""
    X0 = np.random.default_rng(4).standard_normal((4, N))
    port_kw, jax_kw = constraints("both")
    for mod, kw in ((qt, port_kw), (qnm, jax_kw)):
        with pytest.raises(TypeError):
            mod.optimize_auglag(f_port if mod is qt else f_jax, X0[0], engine="tr", delta0=5.0, **kw)
    port, ref = _both(X0, "both", "tr", max_outer=1, tol=1e-8)
    assert_same(port, ref)
    inw = port_con._flat1d(port_kw["ineq"])
    eqw = port_con._flat1d(port_kw["eq"])
    pen = port_con._make_penalty(eqw, inw, torch.float64)
    zero_lam, zero_mu, rho = torch.zeros(1, dtype=torch.float64), torch.zeros(2, dtype=torch.float64), 10.0

    def F(z):
        return f_port(z) - pen(z, zero_lam, zero_mu, rho)

    tr = qt.optimize_tr(F, torch.tensor(X0), tol=1e-8, delta0=1.0, delta_max=1e6, eta_accept=1e-4,
                        max_cg=min(N, 64), cg_tol=1.0, max_iterations=qt.MAX_ITERATIONS_DEFAULT)
    np.testing.assert_allclose(port.x.numpy(), tr.x.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(port.iterations.numpy(), tr.iterations.numpy())
    np.testing.assert_array_equal(port.inner_status.numpy(), tr.status.numpy())


def test_auglag_n_fev_leaves_out_tr_hvps_as_jax_does():
    """ROADMAP.md C.3, the port's choice: copy the reference. With the TR
    engine, ``n_fev`` counts the inner solves' objective evaluations only,
    not their Hessian-vector products (which the TR engine reports as
    n_hev)."""
    X0 = np.random.default_rng(5).standard_normal((3, N))
    port, ref = _both(X0, "eq", "tr", max_outer=1, tol=1e-8)
    assert_same(port, ref)
    port_kw, _ = constraints("eq")
    eqw = port_con._flat1d(port_kw["eq"])
    pen = port_con._make_penalty(eqw, None, torch.float64)
    tr = qt.optimize_tr(lambda z: f_port(z) - pen(z, torch.zeros(1, dtype=torch.float64),
                                                  torch.zeros(0, dtype=torch.float64), 10.0),
                        torch.tensor(X0), tol=1e-8, max_iterations=qt.MAX_ITERATIONS_DEFAULT)
    np.testing.assert_array_equal(port.n_fev.numpy(), tr.n_fev.numpy())
    assert (tr.n_hev > 0).all() and (port.n_fev < tr.n_fev + tr.n_hev).all()


def test_host_syncs_count_outer_and_inner_reads():
    engine = qt.optimize_batched_fused
    engine.host_syncs = engine.loop_bodies = 0
    qt.optimize_auglag.host_syncs = qt.optimize_auglag.loop_bodies = 0
    qt.optimize_auglag.inner_bodies = 0
    X0 = torch.tensor(np.random.default_rng(6).standard_normal((4, N)))
    port_kw, _ = constraints("both")
    res = qt.optimize_auglag(f_port, X0, tol=1e-6, ctol=1e-6, **port_kw)
    rounds = qt.optimize_auglag.loop_bodies
    assert rounds == int(res.n_outer.max())
    outer_reads = rounds - 1 + (rounds < 20)
    assert qt.optimize_auglag.host_syncs == engine.host_syncs + outer_reads
    assert qt.optimize_auglag.inner_bodies == engine.loop_bodies > 0


def test_kernel_names_and_validation_match_jax():
    port_kw, jax_kw = constraints("eq")
    X0 = torch.zeros(2, N, dtype=torch.float64)
    a = qt.optimize_auglag(f_port, X0, kernel="torch", **port_kw)
    b = qt.optimize_auglag(f_port, X0, kernel="auto", **port_kw)
    assert torch.equal(a.x, b.x)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        qt.optimize_auglag(f_port, X0, kernel="cuda", **port_kw)
    with pytest.raises(ValueError, match="unknown kernel"):
        qt.optimize_auglag(f_port, X0, kernel="pallas", **port_kw)

    def f(z):
        return -(z * z).sum()

    def h(z):
        return z[0] - 1.0

    cases = ((dict(x0=np.zeros((4, 2, 2)), eq=h), ValueError, "rank 1 .*or rank 2"),
             (dict(x0=np.zeros(2)), ValueError, "at least one of"),
             (dict(x0=np.zeros(2), eq=h, engine="newton"), ValueError, "engine must be"),
             (dict(x0=np.zeros(2), eq=3.0), TypeError, "eq must be callable"),
             (dict(x0=np.zeros(2), ineq=h, lam0=np.ones(1)), ValueError, "lam0 given without"),
             (dict(x0=np.zeros(2), ineq=h, mu0=np.array([-1.0])), ValueError, "mu0 must be"),
             (dict(x0=np.zeros(2), eq=h, lam0=np.ones(3)), ValueError, "shape"),
             (dict(x0=np.zeros(2), eq=h, max_outer=0), ValueError, "max_outer"),
             (dict(x0=np.zeros(2), eq=h, rho0=-1.0), ValueError, "rho0"),
             (dict(x0=np.zeros((3, 2)), ineq=lambda z, r: r - z[0], constraint_data=np.zeros(2)),
              ValueError, "leading batch axis"))
    for kw, err, match in cases:
        x0 = kw.pop("x0")
        with pytest.raises(err, match=match):
            qt.optimize_auglag(f, torch.tensor(x0), **{
                k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
        with pytest.raises(err, match=match):
            qnm.optimize_auglag(f, jnp.asarray(x0), **kw)
    with pytest.raises(ValueError, match="rank-0/1"):
        qt.optimize_auglag(f, torch.zeros(2, dtype=torch.float64), eq=lambda z: torch.outer(z, z))
