"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and nvcc (the kernels are built at
first use): it carries the `cuda` marker and skips without a card. The file
imports neither jax nor the conftest's fixtures, so it also runs where
only the port's own dependencies are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

It also holds the kernel-input builder the CPU tests share.
"""

import importlib.util
import os
import warnings

import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu_torch import (
    BackTracking,
    Status,
    optimize_batched_fused,
    optimize_batched_resident,
)
from quasinewtonmethods_jl_tpu_torch.models import (
    AR1DriftMAP,
    GaussianMixture,
    IllConditionedQuadratic,
    LogisticRegressionMAP,
    PoissonRegressionMAP,
    funnel_logdensity,
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)
from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_blocked import (
    blocked_matvec,
    blocked_matvec_reference,
    blocked_update,
    blocked_update_reference,
    fused_bfgs_update_blocked,
)
from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
    fused_bfgs_update_batched,
    fused_bfgs_update_reference,
    fused_update_fits,
    update_algebra,
)
from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import (
    _library as resident_library,
    optimize_batched_resident_reference,
    resident_bfgs_solve,
    resident_feasible,
    resident_occupancy,
)

COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")


def make_inputs(rng, n, batch, kinds=False):
    """The test_batched.py:90-110 fixture in port layout: SPD B per lane,
    small steps with positive curvature, 5 frozen and 4 fresh lanes. With
    ``kinds`` also forced-reset lanes (s = -g, g_old = 2g gives y = g and
    m_pre = -‖g‖² < 0) and NaN lanes."""
    B = np.empty((batch, n, n))
    for b in range(batch):
        A = rng.standard_normal((n, n)) * 0.2
        B[b] = A @ A.T + np.eye(n)
    s = rng.standard_normal((batch, n)) * 0.1
    g = rng.standard_normal((batch, n))
    y = s + 0.01 * rng.standard_normal((batch, n))
    gold = g + y
    active = np.ones(batch, bool)
    active[:5] = False
    fresh = np.zeros(batch, bool)
    fresh[5:9] = True
    if kinds:
        s[9:13] = -g[9:13]
        gold[9:13] = 2.0 * g[9:13]
        fresh[11:13] = True  # fresh AND reset: sᵀy < 0, so no scaling
        g[13:15, 0] = np.nan
        s[15, -1] = np.nan
    return B, s, g, gold, active, fresh


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built with nvcc and runs only there")
    return torch.device("cuda", 0)


# B1 at the edges of its layout: one warp per lane up to n = 64, a thread's
# second column from n = 33, two warps from 65, the largest n that fits
# shared memory (237 f32, 167 f64); n·n·itemsize or the lane offset off 16
# bytes (7, 31, 33, 61, 63, 65, 237) takes the bulk copies' ragged ends.
B1_EDGES = (2, 7, 31, 32, 33, 60, 61, 63, 64, 65, 128)
B1_CASES = ([(n, np.float32, 1e-5) for n in (*B1_EDGES, 237)]
            + [(n, np.float64, 1e-12) for n in (*B1_EDGES, 167)])


@pytest.mark.cuda
@pytest.mark.parametrize("n, dtype, rtol", B1_CASES)
def test_kernel_matches_plain_version(cuda_device, n, dtype, rtol):
    """Tolerance is normwise (max |kernel - plain| / max |plain| per output):
    the kernel sums in another order than cuBLAS and torch's reductions.
    Every lane kind: frozen, fresh, forced reset, NaN, active."""
    rng = np.random.default_rng(20260816 + n)
    args = [a.astype(dtype) if a.dtype != bool else a for a in make_inputs(rng, n, 64, kinds=True)]
    tensors = [torch.tensor(a, device=cuda_device) for a in args]
    before = fused_bfgs_update_batched.launches
    kern = fused_bfgs_update_batched(*(t.clone() for t in tensors))
    plain = fused_bfgs_update_reference(*(t.clone() for t in tensors))
    torch.cuda.synchronize()
    assert fused_bfgs_update_batched.launches == before + 1
    for a, b in zip(kern[:3], plain[:3]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(b)
        assert np.abs(a[ok] - b[ok]).max() <= rtol * np.abs(b[ok]).max()
    assert torch.equal(kern[3], plain[3])
    assert kern[3][9:13].all() and not kern[3][13:16].any()
    assert torch.equal(kern[0][:5], tensors[0][:5])  # frozen lanes bit for bit
    assert (kern[1][:5] == 0).all() and (kern[2][:5] == 1).all()


@pytest.mark.cuda
def test_kernel_refuses_too_large_n_and_bad_layout(cuda_device):
    n, batch = 250, 2
    B = torch.eye(n, device=cuda_device).expand(batch, n, n).contiguous()
    vec = torch.zeros(batch, n, device=cuda_device)
    mask = torch.ones(batch, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="fused_bfgs_update_blocked"):
        fused_bfgs_update_batched(B, vec, vec, vec, mask, mask)
    n = 8
    B = torch.eye(n, device=cuda_device).expand(batch, n, n)  # not contiguous
    vec = torch.zeros(batch, n, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fused_bfgs_update_batched(B, vec, vec, vec, mask, mask)
    with pytest.raises(ValueError, match="one device"):
        fused_bfgs_update_batched(B.contiguous(), vec.cpu(), vec, vec, mask, mask)


@pytest.mark.cuda
def test_engine_kernel_and_plain_update_agree_exactly(cuda_device):
    """On a concave quadratic fleet in f64 the trajectory is stable, so the
    kernel and the plain update give the same statuses and counters."""

    def quad_logdensity(x):
        diag = torch.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype, device=x.device)
        return -0.5 * torch.sum(diag * x * x)

    X = torch.tensor(np.random.default_rng(5).standard_normal((64, 6)), device=cuda_device)
    before = fused_bfgs_update_batched.launches
    a = optimize_batched_fused(quad_logdensity, X, kernel="cuda")
    assert fused_bfgs_update_batched.launches > before
    b = optimize_batched_fused(quad_logdensity, X, kernel="torch")
    for name in ("status", "iterations", "n_fev", "n_gev", "n_resets"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.status == Status.CONVERGED).all()
    torch.testing.assert_close(a.x, b.x, atol=1e-10, rtol=0)


@pytest.mark.cuda
def test_engine_synchronises_only_where_it_counts(cuda_device):
    """Every host-device synchronisation of a solve is one of the engine's
    counted control-flow reads: torch's sync debug mode flags each one."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    X = torch.tensor(
        np.random.default_rng(6).standard_normal((256, 20)), dtype=torch.float32,
        device=cuda_device,
    )
    optimize_batched_fused(rosenbrock_logdensity, X, max_iterations=3)  # warm-up
    optimize_batched_fused.host_syncs = 0
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = optimize_batched_fused(
                rosenbrock_logdensity, X, tol=1e-3, max_iterations=200,
                value_and_grad_fn=rosenbrock_value_and_grad,
            )
    finally:
        torch.cuda.set_sync_debug_mode(0)
    flagged = sum("synchroniz" in str(w.message) for w in caught)
    assert optimize_batched_fused.host_syncs > 0
    assert flagged == optimize_batched_fused.host_syncs
    assert (res.status == Status.CONVERGED).all()


def normwise_diff(a, b):
    """max |a - b| / max |b| over the non-NaN entries of b; max |a - b|
    where b is 0 there (a fresh carry's gradient)."""
    ok = ~torch.isnan(b)
    err, scale = float((a[ok] - b[ok]).abs().max()), float(b[ok].abs().max())
    return err / scale if scale else err


def assert_normwise_close(a, b, rtol):
    """max |a - b| <= rtol * max |b| over the non-NaN entries, with the NaN
    patterns equal."""
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    ok = ~torch.isnan(b)
    assert float((a[ok] - b[ok]).abs().max()) <= rtol * float(b[ok].abs().max())


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_cpu_fixture(cuda_device):
    """B1 in f64 on the fixture the CPU tests hold the plain version to the
    JAX package with (12 x 32, every lane kind): summation order only,
    atol 1e-10."""
    args = make_inputs(np.random.default_rng(20260816), 12, 32, kinds=True)
    kern = fused_bfgs_update_batched(*(torch.tensor(a, device=cuda_device) for a in args))
    plain = fused_bfgs_update_reference(*(torch.tensor(a) for a in args))
    for mine, theirs in zip(kern[:3], plain[:3]):
        torch.testing.assert_close(mine.cpu(), theirs, atol=1e-10, rtol=0, equal_nan=True)
    assert torch.equal(kern[3].cpu(), plain[3])


@pytest.mark.cuda
def test_shared_memory_counts_match_the_kernels(cuda_device):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import SMEM_LIMIT_BYTES, _library

    lib, rlib = _library(), resident_library()
    for n in range(1, 300):
        for itemsize in (4, 8):
            assert fused_update_fits(n, itemsize) == (
                lib.qnm_bfgs_update_smem_bytes(n, itemsize) <= SMEM_LIMIT_BYTES)
            assert resident_feasible(n, itemsize) == (
                rlib.qnm_resident_smem_bytes(n, itemsize) <= SMEM_LIMIT_BYTES)
            for objective, number, size in (
                    (None, 0, 0), (IllConditionedQuadratic(3), 1, 0),
                    (LogisticRegressionMAP(3, 5), 2, 0), (funnel_logdensity, 3, 0),
                    (GaussianMixture(np.ones((2, 3))), 4, 0), (PoissonRegressionMAP(3, 5), 5, 0),
                    (AR1DriftMAP(3, 32), 6, 32), (AR1DriftMAP(3, 200), 6, 200)):
                assert resident_feasible(n, itemsize, objective) == (
                    rlib.qnm_resident_objective_smem_bytes(number, n, size, itemsize)
                    <= SMEM_LIMIT_BYTES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("n", [2, 7, 250])
def test_blocked_kernels_match_plain_versions(cuda_device, n, dtype, rtol):
    """B2a against its plain pass (normwise: B2a sums each column in row
    order, cuBLAS in its own), B2b against its plain pass bit for bit (both
    round every product and sum on their own), and the whole two-pass
    update against the plain fused update, over every lane kind."""
    rng = np.random.default_rng(20260816 + n)
    args = [a.astype(dtype) if a.dtype != bool else a for a in make_inputs(rng, n, 32, kinds=True)]
    B, s, g, g_old, active, fresh = (torch.tensor(a, device=cuda_device) for a in args)
    y = g_old - g
    matvecs, updates = blocked_matvec.launches, blocked_update.launches
    By, Bg = blocked_matvec(B, y, g)
    pBy, pBg = blocked_matvec_reference(B, y, g)
    assert_normwise_close(By, pBy, rtol)
    assert_normwise_close(Bg, pBg, rtol)
    alg = update_algebra(pBy, pBg, s, y, g, active, fresh)
    kern_B = blocked_update(B.clone(), s, alg.u, alg.c1, alg.scale, alg.do_upd, alg.reset)
    plain_B = blocked_update_reference(B.clone(), s, alg.u, alg.c1, alg.scale, alg.do_upd, alg.reset)
    assert torch.equal(torch.isnan(kern_B), torch.isnan(plain_B))
    assert torch.equal(kern_B.nan_to_num(), plain_B.nan_to_num())

    kern = fused_bfgs_update_blocked(B.clone(), s, g, g_old, active, fresh)
    plain = fused_bfgs_update_reference(B.clone(), s, g, g_old, active, fresh)
    torch.cuda.synchronize()
    assert (blocked_matvec.launches, blocked_update.launches) == (matvecs + 2, updates + 2)
    for a, b in zip(kern[:3], plain[:3]):
        assert_normwise_close(a, b, rtol)
    assert torch.equal(kern[3], plain[3])
    assert kern[3][9:13].all() and not kern[3][13:16].any()
    assert torch.equal(kern[0][:5], B[:5])  # frozen lanes bit for bit
    assert torch.equal(kern[0][9:13], torch.eye(n, dtype=B.dtype, device=cuda_device).expand(4, n, n))


@pytest.mark.cuda
def test_engine_solves_large_n_through_the_blocked_kernels(cuda_device):
    """n = 250 in float32 does not fit B1: kernel='cuda' dispatches to B2,
    which launches both passes once per loop body and B1 never."""
    X = torch.tensor(np.random.default_rng(7).standard_normal((64, 250)), dtype=torch.float32,
                     device=cuda_device)
    counts = (fused_bfgs_update_batched.launches, blocked_matvec.launches, blocked_update.launches)
    optimize_batched_fused.loop_bodies = 0
    res = optimize_batched_fused(
        rosenbrock_logdensity, X, tol=1e-3, max_iterations=3000,
        value_and_grad_fn=rosenbrock_value_and_grad, kernel="cuda",
    )
    bodies = optimize_batched_fused.loop_bodies
    assert bodies > 0
    assert fused_bfgs_update_batched.launches == counts[0]
    assert (blocked_matvec.launches, blocked_update.launches) == (counts[1] + bodies, counts[2] + bodies)
    assert (res.status == Status.CONVERGED).all()
    assert float(res.grad.abs().max()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 5, 6, 17, 65, 100])
@pytest.mark.parametrize("order, h0_scale", [(2, True), (3, False)])
def test_resident_kernel_matches_plain_version_exactly(cuda_device, n, order, h0_scale):
    """B3 against the fleet engine with the plain update, f64, 5 iterations:
    statuses and every counter equal, floats to rounding (normwise 1e-10:
    the two sum in different orders, and gradients reach ~1e3). Over a
    whole solve the trajectories separate (chip_smoke.py measures how fast);
    there they must end in the same statuses. One launch per solve."""
    X = torch.tensor(np.random.default_rng(n).standard_normal((64, n)), device=cuda_device)
    ls = BackTracking(order=order)
    before = resident_bfgs_solve.launches
    kern = optimize_batched_resident(rosenbrock_logdensity, X, ls=ls, max_iterations=5,
                                     h0_scale=h0_scale, kernel="cuda")
    assert resident_bfgs_solve.launches == before + 1
    plain = optimize_batched_resident_reference(X, ls, 1e-8, 5, h0_scale, 50)
    for name in COUNTERS:
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    for name in ("fresh", "stall"):
        assert torch.equal(getattr(kern.state, name), getattr(plain.state, name)), name
    for name in ("x", "grad", "grad_old", "step", "B"):
        assert_normwise_close(getattr(kern.state, name), getattr(plain.state, name), 1e-10)
    full = optimize_batched_resident(rosenbrock_logdensity, X, ls=ls, h0_scale=h0_scale)
    assert torch.equal(full.status, optimize_batched_resident_reference(
        X, ls, 1e-8, 10_000, h0_scale, 50).status)
    assert (full.status == Status.CONVERGED).all()


@pytest.mark.cuda
@pytest.mark.parametrize("order, h0_scale", [(2, True), (3, False)])
def test_resident_kernel_matches_plain_version_on_the_bench_fleet(cuda_device, order, h0_scale):
    """B3 in float32 at the main path's shape (4096 x 60, seed 20260816,
    tol 1e-3; one warp per lane): over caps 0, 1 and 5 statuses and
    every counter equal on every lane; x, grad and B normwise within 1e-5
    (the float32 limit of the kernel checks) or, where more, twice what the
    plain version moves when run on the CPU, which sums in another order
    (a last-bit difference grows along the trajectory: 5.6e-5 by five
    iterations on this fleet); to convergence equal statuses."""
    X = torch.tensor(np.random.default_rng(20260816).standard_normal((4096, 60)),
                     dtype=torch.float32, device=cuda_device)
    ls = BackTracking(order=order)
    leaves = ("x", "grad", "B")
    for cap in (0, 1, 5):
        kern = optimize_batched_resident(rosenbrock_logdensity, X, ls=ls, tol=1e-3,
                                         max_iterations=cap, h0_scale=h0_scale, kernel="cuda")
        plain = optimize_batched_resident_reference(X, ls, 1e-3, cap, h0_scale, 50)
        cpu = optimize_batched_resident_reference(X.cpu(), ls, 1e-3, cap, h0_scale, 50)
        for name in COUNTERS:
            assert torch.equal(getattr(kern, name), getattr(plain, name)), (cap, name)
        for name in ("fresh", "stall"):
            assert torch.equal(getattr(kern.state, name), getattr(plain.state, name)), (cap, name)
        witness = max(normwise_diff(getattr(cpu.state, f).to(cuda_device), getattr(plain.state, f))
                      for f in leaves)
        for name in leaves:
            assert_normwise_close(getattr(kern.state, name), getattr(plain.state, name),
                                  max(1e-5, 2 * witness))
    full = optimize_batched_resident(rosenbrock_logdensity, X, ls=ls, tol=1e-3,
                                     max_iterations=3000, h0_scale=h0_scale)
    plain = optimize_batched_resident_reference(X, ls, 1e-3, 3000, h0_scale, 50)
    assert torch.equal(full.status, plain.status)
    assert (full.status == Status.CONVERGED).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 5, 17, 60, 64, 65, 128, 236])
def test_resident_kernel_matches_plain_version_at_the_lane_group_edges(cuda_device, n):
    """B3 in float32 where its layout changes: one warp per lane up to
    n = 64 (a second column per thread from n = 33), two warps from 65, four
    at the largest n that fits (236). Over caps 0, 1 and 5 statuses and
    every per-lane counter equal; x, grad and B normwise within 1e-5 or,
    where more, twice what the plain version moves when run on the CPU."""
    X = torch.tensor(np.random.default_rng(20260816 + n).standard_normal((64, n)),
                     dtype=torch.float32, device=cuda_device)
    ls = BackTracking()
    leaves = ("x", "grad", "B")
    for cap in (0, 1, 5):
        before = resident_bfgs_solve.launches
        kern = optimize_batched_resident(rosenbrock_logdensity, X, ls=ls, tol=1e-3,
                                         max_iterations=cap, kernel="cuda")
        assert resident_bfgs_solve.launches == before + (cap > 0)
        plain = optimize_batched_resident_reference(X, ls, 1e-3, cap, True, 50)
        cpu = optimize_batched_resident_reference(X.cpu(), ls, 1e-3, cap, True, 50)
        for name in COUNTERS:
            assert torch.equal(getattr(kern, name), getattr(plain, name)), (cap, name)
        for name in ("fresh", "stall"):
            assert torch.equal(getattr(kern.state, name), getattr(plain.state, name)), (cap, name)
        witness = max(normwise_diff(getattr(cpu.state, f).to(cuda_device), getattr(plain.state, f))
                      for f in leaves)
        for name in leaves:
            assert_normwise_close(getattr(kern.state, name), getattr(plain.state, name),
                                  max(1e-5, 2 * witness))


@pytest.mark.cuda
def test_lane_groups_launch_as_designed(cuda_device):
    """One warp per lane up to n = 64, then a warp per 64 columns; at the
    bench fleet's n = 60 in float32 shared memory admits 13 lanes per SM."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import fused_update_occupancy

    for query in (fused_update_occupancy, resident_occupancy):
        for n, threads in ((2, 32), (60, 32), (64, 32), (65, 64), (128, 64), (129, 96), (236, 128)):
            got = query(n, 4)
            assert got["threads"] == threads, (query.__name__, n, got)
            assert got["registers"] > 0 and got["blocks_per_sm"] > 0, (query.__name__, n, got)
        assert query(60, 4)["blocks_per_sm"] >= 13, query.__name__


@pytest.mark.cuda
def test_resident_kernel_converges_with_one_launch(cuda_device):
    X = torch.tensor(np.random.default_rng(8).standard_normal((256, 24)), device=cuda_device)
    before = resident_bfgs_solve.launches
    res = optimize_batched_resident(rosenbrock_logdensity, X)
    assert resident_bfgs_solve.launches == before + 1
    assert (res.status == Status.CONVERGED).all()
    assert float(res.grad.abs().max()) < 1e-8
    torch.testing.assert_close(res.x, torch.ones_like(res.x), atol=1e-6, rtol=0)
    none = optimize_batched_resident(rosenbrock_logdensity, X, max_iterations=0)
    assert resident_bfgs_solve.launches == before + 1  # no launch at a cap of 0
    assert (none.status == Status.MAX_ITERATIONS).all()
    with pytest.raises(ValueError, match="infeasible"):
        optimize_batched_resident(rosenbrock_logdensity, torch.zeros((2, 240), device=cuda_device))


def _quadratic_fleet(device, batch=64, n=6, seed=5):
    def quad_logdensity(x):
        diag = torch.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype, device=x.device)
        return -0.5 * torch.sum(diag * x * x)

    X = torch.tensor(np.random.default_rng(seed).standard_normal((batch, n)), device=device)
    return quad_logdensity, X


@pytest.mark.cuda
@pytest.mark.parametrize("fold_eval", [False, True])
@pytest.mark.parametrize("approx", [False, True])
def test_wolfe_fleet_launches_b1_once_per_body(cuda_device, fold_eval, approx):
    """The fleet Wolfe search (and its fold) through B1: one launch per
    loop body (the peel of a fresh fleet runs no update), and on the f64
    quadratic fleet the same statuses and counters as the plain update."""
    from quasinewtonmethods_jl_tpu_torch import Wolfe

    quad, X = _quadratic_fleet(cuda_device)
    ls = Wolfe(approx=approx)
    before = fused_bfgs_update_batched.launches
    optimize_batched_fused.loop_bodies = 0
    a = optimize_batched_fused(quad, X, ls=ls, fold_eval=fold_eval, kernel="cuda")
    assert fused_bfgs_update_batched.launches - before == optimize_batched_fused.loop_bodies > 0
    b = optimize_batched_fused(quad, X, ls=ls, fold_eval=fold_eval, kernel="torch")
    for name in COUNTERS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.status == Status.CONVERGED).all()
    torch.testing.assert_close(a.x, b.x, atol=1e-10, rtol=0)


@pytest.mark.cuda
def test_wolfe_bench_shape_fleet_converges_through_b1(cuda_device):
    """Rosenbrock n = 60 in float32 with the Wolfe search through B1."""
    from quasinewtonmethods_jl_tpu_torch import Wolfe

    X = torch.tensor(np.random.default_rng(9).standard_normal((256, 60)), dtype=torch.float32,
                     device=cuda_device)
    before = fused_bfgs_update_batched.launches
    optimize_batched_fused.loop_bodies = 0
    res = optimize_batched_fused(rosenbrock_logdensity, X, ls=Wolfe(), tol=1e-3,
                                 max_iterations=3000, value_and_grad_fn=rosenbrock_value_and_grad)
    assert fused_bfgs_update_batched.launches - before == optimize_batched_fused.loop_bodies > 0
    assert (res.status == Status.CONVERGED).all()
    assert float(res.grad.abs().max()) < 1e-3


@pytest.mark.cuda
def test_compacted_fleet_runs_b1_at_every_width(cuda_device, monkeypatch):
    """Compaction resumes ever narrower fleets; B1 runs at each width (one
    launch per update, the resumed legs' peels included), and the result
    equals one long solve's on the f64 quadratic fleet lane for lane."""
    from quasinewtonmethods_jl_tpu_torch import batched_solve, optimize_batched_compacted

    widths = []
    real = batched_solve._UPDATE_FNS["cuda"]

    def spy(B, *args):
        widths.append(B.shape[0])
        return real(B, *args)

    monkeypatch.setitem(batched_solve._UPDATE_FNS, "cuda", spy)
    quad, X = _quadratic_fleet(cuda_device, batch=256, n=12, seed=10)
    X = X * torch.logspace(-3, 1, 256, dtype=X.dtype, device=cuda_device)[:, None]
    before = fused_bfgs_update_batched.launches
    comp = optimize_batched_compacted(quad, X, kernel="cuda", chunk=3, tol=1e-10)
    assert fused_bfgs_update_batched.launches - before == len(widths)
    assert len(set(widths)) >= 3 and min(widths) < 256
    long = optimize_batched_fused(quad, X, kernel="torch", tol=1e-10)
    for name in COUNTERS:
        assert torch.equal(getattr(comp, name), getattr(long, name)), name
    assert (comp.status == Status.CONVERGED).all()
    torch.testing.assert_close(comp.x, long.x, atol=1e-12, rtol=0)


def _objective_fleet(kind, n, dtype, device, batch=64, seed=20260816):
    """A model of ``kind`` with its data on the card in ``dtype`` and a
    fleet of N(0, 1) starts: the quadratic with condition 1e3 and x* drawn
    from the seed, or the logistic posterior of 500 observations drawn by
    the model's recipe with numpy."""
    rng = np.random.default_rng(seed + n)
    if kind == "quadratic":
        model = IllConditionedQuadratic(n, condition=1e3, x_star=rng.standard_normal(n),
                                        dtype=dtype, device=device)
    else:
        X = rng.standard_normal((500, n)) / np.sqrt(n)
        y = (rng.random(500) < 1.0 / (1.0 + np.exp(-(X @ rng.standard_normal(n))))).astype(float)
        model = LogisticRegressionMAP(n, 500, X=X, y=y, dtype=dtype, device=device)
    X0 = torch.tensor(rng.standard_normal((batch, n)), dtype=dtype, device=device)
    return model, X0


# (objective, n, dtype, tol): the quadratic where the lane group's layout
# changes and at the largest n that fits; the logistic at BASELINE config
# 3's n = 100 (two warps) and at one warp. In float32 the logistic takes
# bench_full.py's tolerance 3e-3 (the line search cannot certify increases
# below eps·|f| there); float64 runs at 1e-6.
OBJECTIVE_CASES = (
    [("quadratic", n, torch.float32, 1e-3) for n in (7, 60, 100, 236)]
    + [("quadratic", n, torch.float64, 1e-6) for n in (7, 60, 100, 165)]
    + [("logistic", n, torch.float32, 3e-3) for n in (20, 100)]
    + [("logistic", n, torch.float64, 1e-6) for n in (20, 100)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, n, dtype, tol", OBJECTIVE_CASES)
def test_resident_kernel_matches_plain_version_on_data_bearing_objectives(cuda_device, kind, n,
                                                                          dtype, tol):
    """B3's quadratic and logistic instantiations against the fleet engine
    with the plain update on the same model: over caps 0, 1 and 5 statuses
    and every counter equal on every lane; x, grad and B normwise within
    1e-10 in float64, and in float32 within 1e-5 or, where more, twice what
    the plain version moves when run on the CPU (another summation order);
    to convergence equal statuses. One launch of the objective's own
    instantiation per solve."""
    model, X = _objective_fleet(kind, n, dtype, cuda_device)
    ls = BackTracking()
    leaves = ("x", "grad", "B")
    for cap in (0, 1, 5):
        before = dict(resident_bfgs_solve.objective_launches)
        kern = optimize_batched_resident(model, X, ls=ls, tol=tol, max_iterations=cap,
                                         kernel="cuda")
        after = resident_bfgs_solve.objective_launches
        assert after[kind] == before[kind] + (cap > 0)
        assert sum(after.values()) == sum(before.values()) + (cap > 0)
        plain = optimize_batched_resident_reference(X, ls, tol, cap, True, 50, model)
        for name in COUNTERS:
            assert torch.equal(getattr(kern, name), getattr(plain, name)), (cap, name)
        for name in ("fresh", "stall"):
            assert torch.equal(getattr(kern.state, name), getattr(plain.state, name)), (cap, name)
        limit = 1e-10
        if dtype == torch.float32:
            cpu = optimize_batched_resident_reference(X.cpu(), ls, tol, cap, True, 50, model)
            limit = max(1e-5, 2 * max(
                normwise_diff(getattr(cpu.state, f).to(cuda_device), getattr(plain.state, f))
                for f in leaves))
        for name in leaves:
            assert_normwise_close(getattr(kern.state, name), getattr(plain.state, name), limit)
    full = optimize_batched_resident(model, X, ls=ls, tol=tol)
    plain = optimize_batched_resident_reference(X, ls, tol, 10_000, True, 50, model)
    assert torch.equal(full.status, plain.status)
    assert (full.status == Status.CONVERGED).all()
    assert float(full.grad.abs().max()) < tol


@pytest.mark.cuda
def test_logistic_fleet_launches_once_without_a_host_sync(cuda_device):
    """The logistic posterior of BASELINE config 3 (n = 100, 500
    observations) in float32 from a model built on the card: one launch,
    no synchronisation flagged by torch's sync debug mode, every lane
    converged at tol 3e-3; a model built on the CPU in float64 serves the
    same solve (its data go to the card in float32 once)."""
    model, X = _objective_fleet("logistic", 100, torch.float32, cuda_device, batch=512)
    before = resident_bfgs_solve.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = optimize_batched_resident(model, X, tol=3e-3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchroniz" in str(w.message)]
    assert resident_bfgs_solve.launches == before + 1
    assert (res.status == Status.CONVERGED).all()
    on_cpu = LogisticRegressionMAP(100, 500, X=model.X.double().cpu(), y=model.y.double().cpu())
    again = optimize_batched_resident(on_cpu, X, tol=3e-3)
    for name in COUNTERS:
        assert torch.equal(getattr(res, name), getattr(again, name)), name
    assert torch.equal(res.x, again.x)
    occupancy = resident_occupancy(100, 4, model)
    assert occupancy["threads"] == 64 and occupancy["blocks_per_sm"] > 0


def _fixture_fleet(kind, n, dtype, device, batch=64, seed=20260816):
    """A fixture of ``kind`` with its data on the card in ``dtype`` and a
    fleet of starts, drawn with numpy as chip_smoke.py's `fixture_data`
    draws the full-width ones: the funnel from N(0, 1) starts; the mixture
    of 8 components, means 3·N(0, 1), sigma 4, from 3·N(0, 1) starts; the
    Poisson GLM of 400 observations; the AR(1) of 32 steps, spectral
    radius 0.6."""
    rng = np.random.default_rng(seed + n)
    if kind == "funnel":
        model = funnel_logdensity
    elif kind == "mixture":
        model = GaussianMixture(3.0 * rng.standard_normal((8, n)), sigmas=4.0, dtype=dtype,
                                device=device)
    elif kind == "poisson":
        X = rng.standard_normal((400, n)) / np.sqrt(n)
        y = rng.poisson(np.exp(X @ (0.5 * rng.standard_normal(n)))).astype(np.float64)
        model = PoissonRegressionMAP(n, 400, X=X, y=y, dtype=dtype, device=device)
    else:
        A = rng.standard_normal((n, n))
        A = A * (0.6 / np.max(np.abs(np.linalg.eigvals(A))))
        w_true, z, zs = rng.standard_normal(n), np.zeros(n), []
        for _ in range(32):
            z = A @ z + w_true
            zs.append(z)
        ys = np.stack(zs) + 0.5 * rng.standard_normal((32, n))
        model = AR1DriftMAP(n, 32, A=A, ys=ys, dtype=dtype, device=device)
    scale = 3.0 if kind == "mixture" else 1.0
    X0 = torch.tensor(scale * rng.standard_normal((batch, n)), dtype=dtype, device=device)
    return model, X0


# (fixture, n, dtype, tol, whole): the full-width n of chip_smoke.py's
# phase 21, n where the lane group's layout changes (one warp to 64, two
# from 65), each family's float32 case where it converges in float32
# (mixture, Poisson); whole solves where they end within a few hundred
# iterations.
FIXTURE_CASES = (
    [("funnel", n, torch.float64, 1e-6, n <= 10) for n in (4, 10, 70)]
    + [("mixture", n, dt, tol, n == 60) for n in (7, 60, 100)
       for dt, tol in ((torch.float32, 1e-3), (torch.float64, 1e-6))]
    + [("poisson", n, dt, tol, n == 50) for n in (50, 100)
       for dt, tol in ((torch.float32, 1e-2), (torch.float64, 1e-6))]
    + [("ar1", n, torch.float64, 1e-6, n == 8) for n in (8, 70)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, n, dtype, tol, whole", FIXTURE_CASES)
def test_resident_kernel_matches_plain_version_on_the_fixtures(cuda_device, kind, n, dtype, tol,
                                                               whole):
    """B3's funnel, mixture, Poisson and AR(1) instantiations against the
    fleet engine with the plain update on the same objective: over caps 0,
    1 and 5 every counter equal on every lane and x, grad and B normwise
    within 1e-10 in float64 (in float32 within 1e-5 or, where more, twice
    what the plain version moves when run on the CPU); over whole solves
    the lanes whose status differs from the plain run's at most twice as
    many as a change of rounding alone gives the plain version (started 1
    ulp away, or run on the CPU): the funnel's and the AR(1)'s float64
    trajectories end in LINESEARCH_FAILURE or not by rounding."""
    model, X = _fixture_fleet(kind, n, dtype, cuda_device)
    ls = BackTracking()
    leaves = ("x", "grad", "B")
    for cap in (0, 1, 5):
        before = dict(resident_bfgs_solve.objective_launches)
        kern = optimize_batched_resident(model, X, ls=ls, tol=tol, max_iterations=cap,
                                         kernel="cuda")
        assert resident_bfgs_solve.objective_launches[kind] == before[kind] + (cap > 0)
        plain = optimize_batched_resident_reference(X, ls, tol, cap, True, 50, model)
        for name in COUNTERS:
            assert torch.equal(getattr(kern, name), getattr(plain, name)), (cap, name)
        for name in ("fresh", "stall"):
            assert torch.equal(getattr(kern.state, name), getattr(plain.state, name)), (cap, name)
        limit = 1e-10
        if dtype == torch.float32:
            cpu = optimize_batched_resident_reference(X.cpu(), ls, tol, cap, True, 50, model)
            limit = max(1e-5, 2 * max(
                normwise_diff(getattr(cpu.state, f).to(cuda_device), getattr(plain.state, f))
                for f in leaves))
        for name in leaves:
            assert_normwise_close(getattr(kern.state, name), getattr(plain.state, name), limit)
    if not whole:
        return
    full = optimize_batched_resident(model, X, ls=ls, tol=tol)
    plain = optimize_batched_resident_reference(X, ls, tol, 10_000, True, 50, model)
    nudged = optimize_batched_resident_reference(
        torch.nextafter(X, torch.full_like(X, float("inf"))), ls, tol, 10_000, True, 50, model)
    on_cpu = optimize_batched_resident_reference(X.cpu(), ls, tol, 10_000, True, 50, model)
    flips = int((full.status != plain.status).sum())
    witness = max(int((nudged.status != plain.status).sum()),
                  int((on_cpu.status.to(cuda_device) != plain.status).sum()))
    assert flips <= 2 * witness, (flips, witness)
    ok = full.status == Status.CONVERGED
    assert float(full.grad[ok].abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("kind, dtype, tol", [("funnel", torch.float64, 1e-6),
                                              ("mixture", torch.float32, 1e-3),
                                              ("poisson", torch.float32, 1e-2),
                                              ("ar1", torch.float64, 1e-6)])
def test_fixture_fleets_launch_once_without_a_host_sync(cuda_device, kind, dtype, tol):
    """Each fixture at its full width (funnel n = 4, mixture n = 60,
    Poisson n = 50, AR(1) n = 8) over 512 lanes: one launch of its own
    instantiation, no synchronisation flagged by torch's sync debug mode,
    every converged lane certified, every status in band."""
    n = {"funnel": 4, "mixture": 60, "poisson": 50, "ar1": 8}[kind]
    model, X = _fixture_fleet(kind, n, dtype, cuda_device, batch=512)
    before = dict(resident_bfgs_solve.objective_launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = optimize_batched_resident(model, X, tol=tol)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchroniz" in str(w.message)]
    after = resident_bfgs_solve.objective_launches
    assert after[kind] == before[kind] + 1 and sum(after.values()) == sum(before.values()) + 1
    in_band = (res.status == Status.CONVERGED) | (res.status == Status.LINESEARCH_FAILURE)
    assert bool(in_band.all())
    ok = res.status == Status.CONVERGED
    assert int(ok.sum()) >= 0.9 * X.shape[0]
    assert float(res.grad[ok].abs().max()) < tol


# The results of B3's seven hand-written instantiations as they were before
# the kernel moved into csrc/resident_solve.cuh for the generated objectives
# to share (and, for the Rosenbrock, quadratic and logistic ones, before the
# logistic objective became one link of the GLM row loop it shares with the
# Poisson GLM): scripts/torch_resident_digest.py run on those earlier
# commits on one H100 80GB HBM3 with CUDA 12.8 (the SHA-256 of every output
# of each fixed solve, and registers per thread). Neither change moved an
# operation, so every byte and register count stays.
EARLIER_DIGESTS = {
    "rosenbrock f32": ("d00b1bdef48f5863b9b126da85937cb09a97151acc7fb04fd28da0f53460af5f", 80),
    "quadratic f32": ("6c14063c5387fc23e2fd5373b7a70b7acf0f43dbcd06aa1043c49953d761a29f", 64),
    "logistic f32": ("be1f95560eb90c929314cbdf2e1baa577b1b02e93458e4e1dab11f2c0f3f49c3", 96),
    "logistic f64": ("c2f861824cc64625ef32381f8d31c948427c3fd899d011c141d0a7e295e038e7", 128),
    "funnel f64": ("de0b37a3c8d8581598896fcf0f74ba5f6fb111cfcbab6b6e341ff1da481f897c", 118),
    "mixture f32": ("6cbb701c7625e4209c6c47350d551fc199199b472a68ee202acb0f1897a4cf18", 80),
    "poisson f32": ("a66a702b30126f8852b654b5c8926e5d8517475ed5f6f54b81d306b17dbb9ed6", 72),
    "ar1 f64": ("9cea0eb3d42e7df215517f198a1d9a0b4c6c0d2681efc3e19db30efc69fa01fd", 122),
}


@pytest.mark.cuda
def test_resident_instantiations_keep_their_results_bit_for_bit(cuda_device):
    """Every hand-written instantiation gives the same counters and
    floats, byte for byte, and uses the same registers as before the
    kernel moved into its header (and the logistic's, the Rosenbrock's and
    the quadratic's as before the GLM refactor)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "torch_resident_digest.py")
    spec = importlib.util.spec_from_file_location("torch_resident_digest", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.digests(cuda_device) == EARLIER_DIGESTS


# B3 on traced objectives (ops/kernels/objective_trace.py, objective_codegen.py):
# each objective generated as CUDA for its graph and shapes and built at first use.
def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _traced_case(kind, n, dtype, device):
    """(objective, numpy starts) of chip_smoke.py's phase-22 or phase-23
    parity case ``kind`` at width n (an inline objective of the JAX
    package's tests/test_resident.py:147-260, a model's bound log-density,
    a transformed density or the transformed hierarchical model), its data
    drawn with numpy from seed 20260816 + n."""
    obj, _, starts = _chip_smoke().traced_case(kind, n, dtype, device)
    return obj, starts


TRACED_CASES = [
    ("quadratic with b", 60, torch.float64, 1e-6), ("quadratic with b", 100, torch.float32, 1e-3),
    ("logsumexp", 60, torch.float64, 1e-6), ("logistic with logaddexp", 60, torch.float32, 1e-3),
    ("mixture", 60, torch.float32, 1e-3), ("mixture", 70, torch.float64, 1e-6),
    # the transforms' ops, one group each (phase 23)
    ("interval and simplex", 60, torch.float32, 1e-3),
    ("ordered and cov cholesky", 31, torch.float64, 1e-6),
    ("corr cholesky", 28, torch.float32, 1e-3), ("gather with repeats", 60, torch.float64, 1e-6),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind, n, dtype, tol", TRACED_CASES)
def test_traced_objective_matches_plain_version(cuda_device, kind, n, dtype, tol):
    """Over caps 0, 1 and 5 every counter equal on every lane and x, grad
    and B normwise within 1e-10 (f64) or, in f32, within 1e-5 or twice
    what the plain version moves when run on the CPU, on the lanes where
    that run keeps the plain run's counters, where more (the mixture's
    flat directions make a last-bit difference large): the
    generated objective sums in another order than torch, nothing else
    differs. Over a whole solve the statuses: lanes whose status differs
    from the plain run's at most twice as many as a start one ulp up or
    down changes in the plain run itself (at the f32 floor rounding decides
    a few lanes), every status in band, every converged lane certified."""
    from quasinewtonmethods_jl_tpu_torch import trace_objective

    obj, starts = _traced_case(kind, n, dtype, cuda_device)
    X = torch.tensor(starts, dtype=dtype, device=cuda_device)
    traced = trace_objective(obj, None, X)
    on_cpu = trace_objective(_traced_case(kind, n, dtype, torch.device("cpu"))[0], None, X.cpu())
    ls = BackTracking()
    for cap in (0, 1, 5):
        before = resident_bfgs_solve.objective_launches["traced"]
        kern = resident_bfgs_solve(X, ls, tol, cap, True, 50, traced)
        plain = optimize_batched_resident_reference(X, ls, tol, cap, True, 50, traced)
        torch.cuda.synchronize()
        assert resident_bfgs_solve.objective_launches["traced"] == before + (cap > 0)
        for name in COUNTERS:
            assert torch.equal(getattr(kern, name), getattr(plain, name)), (cap, name)
        limit = 1e-10 if dtype == torch.float64 else 1e-5
        if dtype == torch.float32 and cap > 0:
            cpu = optimize_batched_resident_reference(X.cpu(), ls, tol, cap, True, 50, on_cpu)
            followed = torch.ones(X.shape[0], dtype=torch.bool, device=cuda_device)
            for name in COUNTERS:  # the lanes where the CPU's run keeps the plain run's counters
                followed &= getattr(cpu, name).to(cuda_device) == getattr(plain, name)
            moved = max(normwise(getattr(cpu.state, f).to(cuda_device)[followed],
                                 getattr(plain.state, f)[followed])
                        for f in ("x", "grad", "B")) if bool(followed.any()) else 0.0
            limit = max(1e-5, 2 * moved)
        assert_normwise_close(kern.x, plain.x, limit)
        assert_normwise_close(kern.grad, plain.grad, limit)
        assert_normwise_close(kern.state.B, plain.state.B, limit)
    full = optimize_batched_resident(obj, X, ls=ls, tol=tol)
    plain = optimize_batched_resident_reference(X, ls, tol, 10_000, True, 50, traced)
    flips = int((full.status != plain.status).sum())
    witness = max(
        int((optimize_batched_resident_reference(torch.nextafter(X, torch.full_like(X, d)), ls,
                                                 tol, 10_000, True, 50, traced).status
             != plain.status).sum())
        for d in (float("inf"), float("-inf")))
    assert flips <= 2 * witness, (flips, witness)
    ok = full.status == Status.CONVERGED
    assert bool((ok | (full.status == Status.LINESEARCH_FAILURE)).all())
    assert float(full.grad[ok].abs().max()) < tol


def normwise(a, b):
    """max |a - b| / max |b| over the entries where b is not NaN (the
    absolute difference where b is all zero)."""
    keep = ~torch.isnan(b)
    err, scale = float((a[keep] - b[keep]).abs().max()), float(b[keep].abs().max())
    return err / scale if scale else err


@pytest.mark.cuda
def test_traced_fleet_launches_once_without_a_host_sync(cuda_device):
    """A bound log-density the hand-written instantiations do not take, at
    the bench shape over 512 lanes: the trace, one launch of B3 with the
    generated objective, no synchronisation flagged by torch's sync debug
    mode, every lane converged."""
    obj, starts = _traced_case("mixture", 60, torch.float32, cuda_device)
    X = torch.tensor(np.concatenate([starts] * 8), dtype=torch.float32, device=cuda_device)
    optimize_batched_resident(obj, X[:4], tol=1e-3)  # the build, before the counted run
    before = dict(resident_bfgs_solve.objective_launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = optimize_batched_resident(obj, X, tol=1e-3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchroniz" in str(w.message)]
    after = resident_bfgs_solve.objective_launches
    assert after["traced"] == before["traced"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert (res.status == Status.CONVERGED).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind, n, dtype, tol", [("hierarchical q=2", 23, torch.float32, 1e-3),
                                                 ("hierarchical q=3", 34, torch.float64, 1e-6)])
def test_hierarchical_objective_matches_plain_version(cuda_device, kind, n, dtype, tol):
    """The transformed hierarchical model against the plain version by
    chip_smoke.py's phase-23 rule (`traced_parity` with ``chaotic``): on
    this model rounding alone changes lanes' counters within five
    iterations (the plain version on the CPU, or started one ulp up or
    down), so at caps 1 and 5 B3 may have other counters on at most twice
    as many lanes as the witness with the most, and its floats on the
    others are held to twice the witnesses' movement; cap 0 and the whole
    solves as for the other objectives."""
    import quasinewtonmethods_jl_tpu_torch as qt

    cs = _chip_smoke()
    obj, _, starts = cs.traced_case(kind, n, dtype, cuda_device)
    X = torch.tensor(starts, dtype=dtype, device=cuda_device)
    on_cpu = cs.traced_case(kind, n, dtype, torch.device("cpu"))[0]
    _, _, failures = cs.traced_parity(qt, qt.trace_objective(obj, None, X), X, tol, kind,
                                      qt.trace_objective(on_cpu, None, X.cpu()), chaotic=True)
    assert not failures


@pytest.mark.cuda
def test_hierarchical_fleet_launches_once_without_a_host_sync(cuda_device):
    """The transformed hierarchical model at phase 23's full width (n = 23,
    512 observations) over 512 lanes, f32: its first call through the
    entry point traces (index tables built on the card) and makes one
    launch of B3, with no synchronisation flagged by torch's sync debug
    mode; a second call takes the kept trace. Statuses are CONVERGED or
    LINESEARCH_FAILURE (float32's floor)."""
    from quasinewtonmethods_jl_tpu_torch import resident_solve

    cs = _chip_smoke()
    obj, starts = cs.hierarchical_objective(np.random.default_rng(cs.BENCH_SEED), 2,
                                            torch.float32, cuda_device, 512)
    X = torch.tensor(starts, dtype=torch.float32, device=cuda_device)
    optimize_batched_resident(obj, X[:4], tol=1e-3)  # the build, before the counted run
    resident_solve._TRACES.clear()
    before = dict(resident_bfgs_solve.objective_launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = optimize_batched_resident(obj, X, tol=1e-3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchroniz" in str(w.message)]
    after = resident_bfgs_solve.objective_launches
    assert after["traced"] == before["traced"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert len(resident_solve._TRACES) == 1
    ok = res.status == Status.CONVERGED
    assert bool((ok | (res.status == Status.LINESEARCH_FAILURE)).all())
    assert bool(torch.isfinite(res.x).all())
    again = optimize_batched_resident(obj, X, tol=1e-3)
    assert len(resident_solve._TRACES) == 1 and torch.equal(again.x, res.x)


# B3 on the ops the trace takes since the comparisons, the elementwise
# functions, mean and norms and the per-lane linear algebra joined it
# (csrc/resident_linalg.cuh): chip_smoke.py's phase-33 parity objectives.
OPS_CASES = [
    ("comparisons and masks", 60, torch.float64, 1e-6),
    ("comparisons and masks", 60, torch.float32, 1e-3),
    ("elementwise functions", 60, torch.float64, 1e-6),
    ("elementwise functions", 60, torch.float32, 1e-3),
    ("mean and norms", 100, torch.float64, 1e-6),
    ("gp cholesky", 3, torch.float64, 1e-6), ("gp cholesky", 3, torch.float32, 1e-3),
    ("gp lu", 3, torch.float64, 1e-6), ("gp logdet", 3, torch.float64, 1e-6),
    ("linalg across two warps", 70, torch.float64, 1e-6),
    ("lu pivoting across two warps", 70, torch.float64, 1e-6),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind, n, dtype, tol", OPS_CASES)
def test_new_ops_match_plain_version(cuda_device, kind, n, dtype, tol):
    """Each group of the new ops, generated into B3, against the plain
    version by chip_smoke.py's phase-22 rule (`traced_parity`): over caps
    0, 1 and 5 every counter equal on every lane and x, grad and B within
    1e-10 (f64) or, in f32, 1e-5 or twice what the plain version moves on
    the CPU; over whole solves the lanes of another status at most twice
    as many as a start one ulp away changes in the plain run itself."""
    import quasinewtonmethods_jl_tpu_torch as qt

    cs = _chip_smoke()
    obj, _, starts = cs.ops_case(kind, n, dtype, cuda_device)
    X = torch.tensor(starts, dtype=dtype, device=cuda_device)
    on_cpu = cs.ops_case(kind, n, dtype, torch.device("cpu"))[0]
    _, _, failures = cs.traced_parity(qt, qt.trace_objective(obj, None, X), X, tol, kind,
                                      qt.trace_objective(on_cpu, None, X.cpu()))
    assert not failures


# B3 on the log-densities of torch.distributions: chip_smoke.py's phase-34
# parity objectives, one per group of ops (the gamma family: lgamma, digamma,
# xlogy; the normal CDF family: erf, erfc, log_ndtr; expm1, reciprocal, rsqrt,
# atan2 and the pows; max and min over a lane of two warps; BCE with logits
# and the casts; float32 at 3e-3: at 1e-3 float32's floor, about sqrt(2·H·eps·|f|)
# for values |f| of 5-40 at curvature H ~ 1, decides lanes' statuses)
DISTS_CASES = [
    ("gamma family", 60, torch.float64, 1e-6), ("gamma family", 60, torch.float32, 3e-3),
    ("normal cdf", 60, torch.float64, 1e-6), ("normal cdf", 60, torch.float32, 3e-3),
    ("elementwise functions", 60, torch.float64, 1e-6),
    ("elementwise functions", 60, torch.float32, 3e-3),
    ("max and min", 70, torch.float64, 1e-6), ("max and min", 70, torch.float32, 3e-3),
    ("losses and casts", 60, torch.float64, 1e-6),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind, n, dtype, tol", DISTS_CASES)
def test_distribution_ops_match_plain_version(cuda_device, kind, n, dtype, tol):
    """Each group of the distributions' ops, generated into B3, against the
    plain version by the phase-22 rule, as the groups above."""
    import quasinewtonmethods_jl_tpu_torch as qt

    cs = _chip_smoke()
    validating = torch.distributions.Distribution._validate_args
    torch.distributions.Distribution.set_default_validate_args(False)
    try:
        obj, _, starts = cs.dists_case(kind, n, dtype, cuda_device)
        X = torch.tensor(starts, dtype=dtype, device=cuda_device)
        on_cpu = cs.dists_case(kind, n, dtype, torch.device("cpu"))[0]
        _, _, failures = cs.traced_parity(qt, qt.trace_objective(obj, None, X), X, tol, kind,
                                          qt.trace_objective(on_cpu, None, X.cpu()))
    finally:
        torch.distributions.Distribution.set_default_validate_args(validating)
    assert not failures


# B3 on softmax, constant-index gathers and scatter_adds, the shape-only
# factories, prod / cumprod, erfinv and per-lane values of rank 3: chip_smoke.py's
# phase-35 parity objectives, one per group of ops (float32 at 3e-3 as above)
SOFTMAX_CASES = [
    ("softmax and gathers", 60, torch.float64, 1e-6),
    ("softmax and gathers", 60, torch.float32, 3e-3),
    ("products and erfinv", 60, torch.float64, 1e-6),
    ("products and erfinv", 60, torch.float32, 3e-3),
    ("rank 3", 70, torch.float64, 1e-6),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind, n, dtype, tol", SOFTMAX_CASES)
def test_softmax_ops_match_plain_version(cuda_device, kind, n, dtype, tol):
    """Each group of the softmax slice's ops, generated into B3, against the
    plain version by the phase-22 rule, as the groups above."""
    import quasinewtonmethods_jl_tpu_torch as qt

    cs = _chip_smoke()
    validating = torch.distributions.Distribution._validate_args
    torch.distributions.Distribution.set_default_validate_args(False)
    try:
        obj, _, starts = cs.softmax_case(kind, n, dtype, cuda_device)
        X = torch.tensor(starts, dtype=dtype, device=cuda_device)
        on_cpu = cs.softmax_case(kind, n, dtype, torch.device("cpu"))[0]
        _, _, failures = cs.traced_parity(qt, qt.trace_objective(obj, None, X), X, tol, kind,
                                          qt.trace_objective(on_cpu, None, X.cpu()))
    finally:
        torch.distributions.Distribution.set_default_validate_args(validating)
    assert not failures


@pytest.mark.cuda
def test_multivariate_normal_fleet_launches_once_without_a_host_sync(cuda_device):
    """chip_smoke.py's phase-35 multivariate normal (D.MultivariateNormal with
    a Cholesky factor from the point: rank-3 values, a triangular solve over a
    batch dim of 1) on 512 of its lanes: the trace, one launch of B3, no
    synchronisation flagged by torch's sync debug mode, every lane ended in
    band and the converged ones certified."""
    cs = _chip_smoke()
    validating = torch.distributions.Distribution._validate_args
    torch.distributions.Distribution.set_default_validate_args(False)
    try:
        obj, X, tol = cs.softmax_fleets(cuda_device)["mvn"]
        X = X[:512].contiguous()
        optimize_batched_resident(obj, X[:4], tol=tol)  # the trace and build, before the count
        before = dict(resident_bfgs_solve.objective_launches)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = optimize_batched_resident(obj, X, tol=tol)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    finally:
        torch.distributions.Distribution.set_default_validate_args(validating)
    assert not [w for w in caught if "synchroniz" in str(w.message)]
    after = resident_bfgs_solve.objective_launches
    assert after["traced"] == before["traced"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    ok = res.status == Status.CONVERGED
    assert bool((ok | (res.status == Status.LINESEARCH_FAILURE)).all())
    assert float(res.grad[ok].abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_extremes_let_nan_win_on_the_card(cuda_device, dtype):
    """max, amax and min.dim over a lane holding a NaN are NaN in B3 as in
    torch (the lane ends NONFINITE_VALUE at its first test); over one
    iteration the other lanes run as in the plain version (the extremes'
    kinks make whole solves a matter of rounding)."""
    def obj(x):
        M = x.reshape(7, 10)
        return -0.5 * torch.sum(x * x) + 0.1 * torch.max(torch.log(x + 3.0)) \
            + 0.1 * torch.sum(torch.amax(M, dim=1)) - 0.1 * torch.sum(torch.min(M, 0).values)

    X = torch.tensor(np.random.default_rng(3).standard_normal((8, 70)) * 0.3, dtype=dtype,
                     device=cuda_device)
    X[5, 17] = -4.0  # log(x + 3) is NaN there
    tol = 1e-6 if dtype == torch.float64 else 1e-3
    kern = optimize_batched_resident(obj, X, tol=tol, max_iterations=1)
    plain = optimize_batched_resident(obj, X, tol=tol, max_iterations=1, kernel="torch")
    for name in ("status", "iterations", "n_fev", "n_gev"):
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    assert int(kern.status[5]) == int(Status.NONFINITE_VALUE) and bool(torch.isnan(kern.fun[5]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_a_failed_factorization_is_nan_on_its_lane_on_the_card(cuda_device, dtype):
    """A lane whose matrix is not positive definite at its start (here
    K0 - 39 I) evaluates to NaN in B3 as in the plain version and ends
    NONFINITE_VALUE; the other lanes run on as in the plain version."""
    m = 5
    rng = np.random.default_rng(7)
    B = rng.standard_normal((m, m))
    K0 = torch.tensor(B @ B.T / m, dtype=dtype, device=cuda_device)
    y = torch.tensor(rng.standard_normal(m), dtype=dtype, device=cuda_device)

    def obj(x):
        L = torch.linalg.cholesky(K0 + (1.0 + x[0] * x[0] - x[1]) * torch.eye(m, dtype=dtype,
                                                                               device=x.device))
        a = torch.linalg.solve_triangular(L, y[:, None], upper=False)
        return -0.5 * torch.sum(a * a) - torch.sum(torch.log(torch.diagonal(L))) \
            - 0.5 * torch.sum(x * x)

    X = torch.tensor(rng.standard_normal((8, 2)) * 0.5, dtype=dtype, device=cuda_device)
    X[3] = torch.tensor([0.0, 40.0])
    tol = 1e-6 if dtype == torch.float64 else 1e-3
    kern = optimize_batched_resident(obj, X, tol=tol)
    plain = optimize_batched_resident(obj, X, tol=tol, kernel="torch")
    assert torch.equal(kern.status, plain.status)
    assert int(kern.status[3]) == int(Status.NONFINITE_VALUE) and bool(torch.isnan(kern.fun[3]))
    assert bool((kern.status[torch.arange(8, device=cuda_device) != 3] == Status.CONVERGED).all())


@pytest.mark.cuda
def test_a_lane_too_large_for_a_block_raises_before_any_build(cuda_device):
    """A GP of 64 points in float64: its factor and temporaries do not fit
    one block's shared memory, so B3 refuses it before generating or
    building anything (`resident_feasible`)."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels import _build

    cs = _chip_smoke()
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=cuda_device)  # noqa: E731
    d2, y = cs.gp_points(np.random.default_rng(1), 64)
    obj = cs.gp_objective(t(d2), t(y), "cholesky", t)
    built = set(_build.BUILD_DIR.glob("*")) if _build.BUILD_DIR.exists() else set()
    loaded = dict(_build._GENERATED)
    with pytest.raises(ValueError, match="infeasible"):
        optimize_batched_resident(obj, torch.zeros((8, 3), dtype=torch.float64,
                                                   device=cuda_device))
    assert _build._GENERATED == loaded
    assert (set(_build.BUILD_DIR.glob("*")) if _build.BUILD_DIR.exists() else set()) == built


@pytest.mark.cuda
def test_untraceable_objective_raises_before_any_build(cuda_device):
    """An objective outside the table raises ValueError on the card as on
    the CPU, naming its op, before anything is generated or built."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels import _build

    built = set(_build.BUILD_DIR.glob("*")) if _build.BUILD_DIR.exists() else set()
    loaded = dict(_build._GENERATED)
    X = torch.zeros((8, 6), device=cuda_device)
    with pytest.raises(ValueError, match=r"aten\.i0.*optimize_batched_fused"):
        optimize_batched_resident(lambda x: torch.special.i0(x).sum(), X)
    assert _build._GENERATED == loaded
    assert (set(_build.BUILD_DIR.glob("*")) if _build.BUILD_DIR.exists() else set()) == built


AUGLAG_COUNTERS = ("status", "n_outer", "iterations", "n_fev", "inner_status")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-6), (torch.float32, 1e-3)])
@pytest.mark.parametrize("max_outer, cap", [(1, 0), (1, 1), (1, 5), (2, 1), (2, 5)])
def test_auglag_bfgs_fleet_through_b1_matches_the_plain_update(cuda_device, dtype, tol, max_outer,
                                                               cap):
    """The auglag BFGS fleet's inner update on the card (B1) against the
    plain update, over 64 lanes of chip_smoke.py's disk-constrained
    Rosenbrock at caps: every counter equal on every lane, floats to
    rounding (the plain update's own error, 1e-10 / 1e-5 normwise), and
    B1 launched once per inner loop body."""
    from quasinewtonmethods_jl_tpu_torch import optimize_auglag

    cs = _chip_smoke()
    X = cs.bench_fleet(cuda_device)[:64].to(dtype)
    kw = dict(ineq=cs.disk14, engine="bfgs", tol=tol, ctol=tol, max_outer=max_outer,
              max_iterations=cap)
    optimize_batched_fused.loop_bodies = 0
    before = fused_bfgs_update_batched.launches
    kern = optimize_auglag(rosenbrock_logdensity, X, kernel="cuda", **kw)
    launches = fused_bfgs_update_batched.launches - before
    assert launches == optimize_batched_fused.loop_bodies == max_outer * max(cap - 1, 0)
    plain = optimize_auglag(rosenbrock_logdensity, X, kernel="torch", **kw)
    assert fused_bfgs_update_batched.launches - before == launches
    for name in AUGLAG_COUNTERS:
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    rtol = 1e-10 if dtype == torch.float64 else 1e-5
    for name in ("x", "mu", "rho", "viol"):  # no eq: lam is (64, 0)
        a, b = getattr(kern, name), getattr(plain, name)
        assert float((a - b).abs().max()) <= rtol * max(float(b.abs().max()), 1.0), name


@pytest.mark.cuda
def test_multistart_fleet_through_b1_matches_the_plain_update(cuda_device):
    """`optimize_multistart` on 256 lanes of the bench fleet (n = 60, f32,
    tol 1e-3) with kernel="cuda" (B1) against kernel="torch": B1 launched,
    equal statuses on every lane, and the same best mode (every lane ends
    at the Rosenbrock's one mode, so rounding may pick another lane of it:
    the best iterates and values agree to the certificate)."""
    from quasinewtonmethods_jl_tpu_torch import optimize_multistart

    X = _chip_smoke().bench_fleet(cuda_device)[:256]
    kw = dict(x0s=X, tol=1e-3, max_iterations=3000, value_and_grad_fn=rosenbrock_value_and_grad)
    before = fused_bfgs_update_batched.launches
    kern = optimize_multistart(rosenbrock_logdensity, None, 256, 60, kernel="cuda", **kw)
    launches = fused_bfgs_update_batched.launches - before
    assert launches > 0
    plain = optimize_multistart(rosenbrock_logdensity, None, 256, 60, kernel="torch", **kw)
    assert fused_bfgs_update_batched.launches - before == launches
    assert torch.equal(kern.fleet.status, plain.fleet.status)
    assert int(kern.n_converged) == int(plain.n_converged) == 256
    for res in (kern, plain):
        assert float((res.x - 1.0).abs().max()) < 0.05
        assert 0 <= int(res.best_index) < 256 and bool(torch.isfinite(res.fun))
    assert abs(float(kern.fun) - float(plain.fun)) < 1e-4
