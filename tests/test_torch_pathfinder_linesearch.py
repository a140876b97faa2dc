"""Pathfinder's lockstep line search (pathfinder._lockstep_linesearch)
lane by lane against the scalar search it stands for, f64 on the CPU.

JAX's Pathfinder runs the scalar ``run_linesearch`` under ``vmap`` over
paths; the port runs every path's search in lockstep, one host read a
round. Each lane's alpha, failure flag and evaluation counts are held to
the port's scalar `ops.linesearch.run_linesearch` (counts exactly, alpha to
1e-12: the fleet's objective reduces its rows otherwise) and to JAX's
(alpha to 1e-10), for BackTracking orders 2 and 3, a one-round budget,
Wolfe and approximate Wolfe, with a lane whose first trial is NaN (phase
A's halvings), a lane with NaN f0 (the doomed search) and a frozen lane.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu.ops.linesearch import run_linesearch as jax_run_linesearch
from quasinewtonmethods_jl_tpu.ops.wolfe import Wolfe as JaxWolfe
from quasinewtonmethods_jl_tpu_torch.ops.linesearch import run_linesearch
from test_torch_pathfinder import RTOL, pf

torch.set_num_threads(1)


def _ls_lanes():
    """Eight lanes of (objective, x, d): steep lanes a full step overshoots
    (several rounds; with ``iterations=1`` they exhaust the budget), a NaN
    wall the first trial lands behind (phase A halvings, then Armijo), a
    lane with NaN f0 (the doomed search), and easy lanes. The objective
    has a quartic term: on a pure quadratic the cubic's leading
    coefficient is rounding noise, and order 3's proposal with it."""
    rng = np.random.default_rng(3)
    n = 4
    X = rng.standard_normal((8, n))
    D = rng.standard_normal((8, n))
    scales = np.asarray([1.0, 30.0, 300.0, 1.0, 1.0, 0.5, 3000.0, 1.0])
    X[3] = 0.5
    D[3] = -10.0  # the first trial lands past the wall at 5: NaN
    X[4, 0] = 60.0  # NaN f0
    return X, D, scales


def _ls_objective(scales, lib):
    def f(x, s):
        val = -0.5 * s * lib.sum(x * x) - 0.25 * lib.sum(x * x * x * x)
        if lib is torch:
            return torch.where(torch.max(torch.abs(x)) > 5.0, torch.full_like(val, math.nan), val)
        return jnp.where(jnp.max(jnp.abs(x)) > 5.0, jnp.nan, val)

    return f


@pytest.mark.parametrize("ls", ["bt2", "bt3", "wolfe", "wolfe_approx", "bt3_short"])
def test_lockstep_linesearch_equals_scalar_search_lane_by_lane(ls):
    port_ls = {"bt2": qt.BackTracking(order=2), "bt3": qt.BackTracking(order=3),
               "wolfe": qt.Wolfe(), "wolfe_approx": qt.Wolfe(approx=True),
               "bt3_short": qt.BackTracking(order=3, iterations=1)}[ls]
    jax_ls = {"bt2": qj.BackTracking(order=2), "bt3": qj.BackTracking(order=3),
              "wolfe": JaxWolfe(), "wolfe_approx": JaxWolfe(approx=True),
              "bt3_short": qj.BackTracking(order=3, iterations=1)}[ls]
    X, D, scales = _ls_lanes()
    f_t, f_j = _ls_objective(scales, torch), _ls_objective(scales, jnp)
    Xt, Dt, St = torch.tensor(X), torch.tensor(D), torch.tensor(scales)
    # each lane its own objective: the scale rides along as a batched input
    f_b = torch.func.vmap(f_t)

    def f_fleet(x):
        return f_b(x, St)

    def vag_fleet(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = f_fleet(x)
            g, = torch.autograd.grad(v.sum(), x)
        return v.detach(), g

    f0, g0 = vag_fleet(Xt)
    m = (g0 * Dt).sum(1)
    # an ascent direction where the lane's own is not
    flip = m < 0
    Dt = torch.where(flip[:, None], -Dt, Dt)
    m = torch.where(flip, -m, m)
    active = torch.ones(8, dtype=torch.bool)
    active[5] = False  # a frozen lane: alpha 0, no search
    alpha, failed, fev, gev, reads = pf._lockstep_linesearch(port_ls, f_fleet, vag_fleet, Xt, Dt,
                                                             f0, m, active)
    assert reads >= 2
    for lane in range(8):
        if not active[lane]:
            assert float(alpha[lane]) == 0.0
            continue

        def f1(x, s=scales[lane]):
            return f_t(x, torch.tensor(s))

        def vag1(x, s=scales[lane]):
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                v = f1(x)
                g, = torch.autograd.grad(v, x)
            return v.detach(), g

        s_alpha, s_failed, s_fev, s_gev = run_linesearch(port_ls, f1, vag1, Xt[lane], Dt[lane],
                                                         f0[lane], m[lane])
        # the fleet's objective reduces (8, n) rows where the scalar one
        # reduces (n,): the trial values may differ in the last bit
        np.testing.assert_allclose(float(alpha[lane]), float(s_alpha), rtol=1e-12, err_msg=lane)
        assert bool(failed[lane]) == bool(s_failed), lane
        assert int(fev[lane]) == int(s_fev) and int(gev[lane]) == int(s_gev), lane

        def fj(x, s=scales[lane]):
            return f_j(x, s)

        j_alpha, j_failed, j_fev, j_gev = jax_run_linesearch(
            jax_ls, fj, jax.value_and_grad(fj), jnp.asarray(Xt[lane].numpy()),
            jnp.asarray(Dt[lane].numpy()), jnp.asarray(float(f0[lane])), jnp.asarray(float(m[lane])))
        # JAX's compiled arithmetic rounds otherwise than torch's eager ops,
        # and order 3's cubic amplifies that on the steepest lane
        np.testing.assert_allclose(float(alpha[lane]), float(j_alpha), rtol=RTOL, err_msg=lane)
        assert bool(failed[lane]) == bool(j_failed), lane
        assert int(fev[lane]) == int(j_fev) and int(gev[lane]) == int(j_gev), lane
    assert bool(failed[4]) and int(fev[4]) == 1  # NaN f0: doomed after one trial
    if ls.startswith("bt"):
        assert int(fev[3]) > 2  # the wall's halvings are counted
    assert bool(failed[6]) == (ls == "bt3_short")  # the budget, where it is one round
