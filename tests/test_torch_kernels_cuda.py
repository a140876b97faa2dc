"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and nvcc (the kernels are built at
first use): it carries the `cuda` marker and skips without a card. The file
imports neither jax nor the conftest's fixtures, so it also runs where
only the port's own dependencies are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

It also holds the kernel-input builder the CPU tests share.
"""

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
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import resident_occupancy

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
