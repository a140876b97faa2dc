"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA card and nvcc (the kernel is built at first
use): it carries the `cuda` marker and skips without a card. The file
imports neither jax nor the conftest's fixtures, so it also runs where
only the port's own dependencies are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

It also holds the kernel-input builder the CPU tests share.
"""

import warnings

import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu_torch import Status, optimize_batched_fused
from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
    fused_bfgs_update_batched,
    fused_bfgs_update_reference,
)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("n", [2, 7, 60, 61, 128])
def test_kernel_matches_plain_version(cuda_device, n, dtype, rtol):
    """Tolerance is normwise (max |kernel - plain| / max |plain| per output):
    the kernel sums in another order than cuBLAS and torch's reductions."""
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
    with pytest.raises(ValueError, match="B2"):
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
