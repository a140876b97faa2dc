"""Fused batched inverse-BFGS update — the fleet engine's hot kernel.

Port of ``quasinewtonmethods_jl_tpu/ops/pallas/bfgs_kernel.py``: one pass
computes y, sᵀy, Bᵀy and Bᵀg, the rank-2 inverse-BFGS update, the next
search direction d = B_new·g and m = gᵀB_new·g in closed form (no second
matvec), with the driver's selects folded in: identity reset where
m_pre <= 0 (NaN does not reset) and frozen lanes left as they are.

Layout is lane-major: B is (batch, n, n) contiguous, so one lane's B is one
contiguous block; vectors are (batch, n); per-lane masks and scalars are
(batch,). (The JAX package is batch-minor for the TPU's 128-wide lanes.)

`fused_bfgs_update_batched` launches the hand-written CUDA kernel B1
(``csrc/bfgs_update.cu``) on CUDA tensors and takes the plain PyTorch
version `fused_bfgs_update_reference` on CPU tensors. Both update B in
place. B1 runs each lane in a block of its own (one warp up to n = 64),
which holds the lane's B in shared memory (`fused_update_fits`), brought in
by a bulk copy and written back with 16-byte stores; larger n take the
two-pass kernel B2
(ops/kernels/bfgs_blocked.py). The plain version is B2's plain passes
around `update_algebra`, the O(n·batch) algebra both call between the
matvecs and the update of B.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ...api import _pin_matmul_precision
from ..bfgs import h0_gamma
from ._build import check_launch, load_library

__all__ = [
    "fused_bfgs_update_batched",
    "fused_bfgs_update_reference",
    "fused_update_fits",
    "update_algebra",
    "UpdateAlgebra",
    "blocked_matvec_reference",
    "blocked_update_reference",
    "SMEM_LIMIT_BYTES",
    "fused_update_occupancy",
]

# Shared memory one block may opt into on Hopper (sm_90: 227 KB); the kernel
# library is built for sm_90a only.
SMEM_LIMIT_BYTES = 232_448
# The kernels' reduction scratch: kRedValues = 2 x kMaxSums x kMaxLaneWarps
# values (csrc/bfgs_common.cuh).
SMEM_SCRATCH_VALUES = 2 * 8 * 4


def fused_update_fits(n: int, itemsize: int) -> bool:
    """Whether one lane of B1 fits one block's shared memory: the count of
    ``smem_bytes`` in csrc/bfgs_update.cu, (n² + 6n + the reduction
    scratch)·itemsize (n <= 237 in float32, n <= 167 in float64)."""
    return (n * n + 6 * n + SMEM_SCRATCH_VALUES) * itemsize <= SMEM_LIMIT_BYTES


@_pin_matmul_precision
def blocked_matvec_reference(
    B: torch.Tensor, y: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Bᵀy, Bᵀg) per lane — the plain version of the matvec pass (B2a).
    One batched product, (batch, 2, n) @ (batch, n, n) = [yᵀB; gᵀB], reads
    B's columns as the JAX einsum ``rcb,rkb->kcb`` does."""
    ByBg = torch.bmm(torch.stack([y, g], dim=1), B)
    return ByBg[:, 0], ByBg[:, 1]


class UpdateAlgebra(NamedTuple):
    """What `update_algebra` hands the update of B and the caller."""

    scale: torch.Tensor  # (batch,) H0 scale of B (1 unless fresh)
    u: torch.Tensor  # (batch, n) scale·Bᵀy / sᵀy
    c1: torch.Tensor  # (batch,) (1 + yᵀBy/sᵀy) / sᵀy
    do_upd: torch.Tensor  # (batch,) bool: rank-2 update
    reset: torch.Tensor  # (batch,) bool: identity reset
    d: torch.Tensor  # (batch, n) next search direction
    m: torch.Tensor  # (batch,) directional derivative gᵀd


def update_algebra(By, Bg, s, y, g, active, fresh) -> UpdateAlgebra:
    """The O(n·batch) algebra between B's matvecs and its update, with no B
    traffic: sᵀy, ρ, the `h0_gamma` scale, yᵀBy, u, c₁, w = sᵀg, v = uᵀg,
    gᵀBg, m_pre, d, gᵀg and the reset / frozen selects (the JAX blocked
    wrapper's :265-285). ``By`` and ``Bg`` are the unscaled Bᵀy and Bᵀg;
    ``fresh`` None means no H0 scaling."""
    sty = (s * y).sum(-1)
    rho = 1.0 / sty
    if fresh is None:
        scale = torch.ones_like(sty)
    else:
        yty = (y * y).sum(-1)
        scale = h0_gamma(sty, yty, fresh, s.dtype)
    By = scale[:, None] * By
    Bg = scale[:, None] * Bg
    ytBy = (By * y).sum(-1)
    u = By * rho[:, None]
    c1 = (1.0 + ytBy * rho) * rho

    w = (s * g).sum(-1)  # sᵀg
    v = (u * g).sum(-1)  # gᵀ(By/sᵀy)
    gBg = (Bg * g).sum(-1)
    m_pre = gBg + c1 * w * w - 2.0 * w * v  # gᵀB_new g
    d_upd = Bg + (c1 * w)[:, None] * s - w[:, None] * u - v[:, None] * s  # B_new g

    gg = (g * g).sum(-1)
    reset = (m_pre <= 0.0) & active
    do_upd = ~reset & active
    d = torch.where(active[:, None], torch.where(reset[:, None], g, d_upd), torch.zeros_like(g))
    m = torch.where(active, torch.where(reset, gg, m_pre), torch.ones_like(m_pre))
    return UpdateAlgebra(scale, u, c1, do_upd, reset, d, m)


def blocked_update_reference(B, s, u, c1, scale, do_upd, reset) -> torch.Tensor:
    """The plain version of the update pass (B2b), IN PLACE: per lane
    B = scale·B + c₁ s sᵀ - u sᵀ - s uᵀ where ``do_upd``, B = I where
    ``reset``, B unchanged elsewhere (frozen). Returns B."""
    B_upd = (
        scale[:, None, None] * B
        + c1[:, None, None] * (s[:, :, None] * s[:, None, :])
        - u[:, :, None] * s[:, None, :]
        - s[:, :, None] * u[:, None, :]
    )
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    B.copy_(
        torch.where(do_upd[:, None, None], B_upd, torch.where(reset[:, None, None], eye, B))
    )
    return B


def fused_bfgs_update_reference(
    B: torch.Tensor,
    step: torch.Tensor,
    g: torch.Tensor,
    g_old: torch.Tensor,
    active: torch.Tensor,
    fresh: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch fused update, with the semantics of the JAX
    `fused_bfgs_update_reference`.

    Shapes: B (batch, n, n); step/g/g_old (batch, n); active (batch,) bool
    (lane still running); fresh optional (batch,) bool (B is a fresh
    identity: Barzilai–Borwein H0 scaling, see `h0_gamma`). Updates B IN
    PLACE and returns (B, d, m, reset):
      * normal lanes: the rank-2 inverse-BFGS update with y = g_old - g,
        d = B_new g, m = gᵀ B_new g (reference :36-67);
      * reset lanes (m_pre <= 0; NaN does not reset): B = I, d = g,
        m = ‖g‖² (reference :272-280);
      * frozen lanes (active False): B unchanged, d = 0, m = 1.
    The matvecs read B's columns (Bᵀy, Bᵀg), as the JAX einsum does.
    """
    y = g_old - g
    By, Bg = blocked_matvec_reference(B, y, g)
    alg = update_algebra(By, Bg, step, y, g, active, fresh)
    blocked_update_reference(B, step, alg.u, alg.c1, alg.scale, alg.do_upd, alg.reset)
    return B, alg.d, alg.m, alg.reset


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library().cdll
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.qnm_bfgs_update_f32, lib.qnm_bfgs_update_f64):
        fn.argtypes = [ptr] * 9 + [i32, i32, ptr]
        fn.restype = i32
    lib.qnm_bfgs_update_smem_bytes.argtypes = [i32, i32]
    lib.qnm_bfgs_update_smem_bytes.restype = ctypes.c_size_t
    lib.qnm_bfgs_update_occupancy.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 3
    lib.qnm_bfgs_update_occupancy.restype = i32
    return lib


def launch_occupancy(query, n: int, itemsize: int) -> dict:
    """What a launcher's occupancy query (``qnm_*_occupancy``) reports for
    n: registers per thread, threads per block, blocks per SM."""
    regs, threads, blocks = (ctypes.c_int() for _ in range(3))
    check_launch(query(n, itemsize, ctypes.byref(regs), ctypes.byref(threads),
                       ctypes.byref(blocks)), "occupancy query")
    return {"registers": regs.value, "threads": threads.value, "blocks_per_sm": blocks.value}


def fused_update_occupancy(n: int, itemsize: int) -> dict:
    """B1's launch at n on the current card (see `launch_occupancy`)."""
    return launch_occupancy(_library().qnm_bfgs_update_occupancy, n, itemsize)


def _check_args(B, step, g, g_old, active, fresh):
    if B.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"B must be float32 or float64, got {B.dtype}")
    if B.ndim != 3 or B.shape[1] != B.shape[2]:
        raise ValueError(f"B must be (batch, n, n), got {tuple(B.shape)}")
    batch, n = B.shape[0], B.shape[1]
    for name, t in (("step", step), ("g", g), ("g_old", g_old)):
        if tuple(t.shape) != (batch, n) or t.dtype != B.dtype:
            raise ValueError(
                f"{name} must be ({batch}, {n}) {B.dtype}, got {tuple(t.shape)} {t.dtype}"
            )
    for name, t in (("active", active), ("fresh", fresh)):
        if tuple(t.shape) != (batch,) or t.dtype != torch.bool:
            raise ValueError(
                f"{name} must be ({batch},) bool, got {tuple(t.shape)} {t.dtype}"
            )
    devices = {t.device for t in (B, step, g, g_old, active, fresh)}
    if len(devices) != 1:
        raise ValueError(f"all arguments must be on one device, got {sorted(map(str, devices))}")


def fused_bfgs_update_batched(
    B: torch.Tensor,  # (batch, n, n) inverse Hessians, updated in place
    step: torch.Tensor,  # (batch, n) previous accepted steps
    g: torch.Tensor,  # (batch, n) gradients at the new iterates
    g_old: torch.Tensor,  # (batch, n) gradients at the previous iterates
    active: torch.Tensor,  # (batch,) bool: lane still running
    fresh: torch.Tensor,  # (batch,) bool: B is a fresh identity
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused BFGS update + direction for a whole fleet; returns
    (B, d, m, reset) with the semantics of `fused_bfgs_update_reference`,
    B updated IN PLACE.

    On CUDA tensors this launches the CUDA kernel (one block per lane, one
    warp up to n = 64, the lane's B staged once in shared memory) on the
    current stream, without synchronising, and counts the launch in
    ``fused_bfgs_update_batched.launches``. It raises where the kernel
    cannot run — ValueError when one lane's B does not fit in shared memory
    (`fused_update_fits`; `fused_bfgs_update_blocked` serves such n),
    RuntimeError on a failed build or launch. On CPU tensors it computes
    the plain version.
    """
    _check_args(B, step, g, g_old, active, fresh)
    if B.device.type == "cpu":
        return fused_bfgs_update_reference(B, step, g, g_old, active, fresh)
    if B.device.type != "cuda":
        raise ValueError(f"unsupported device {B.device}; use a CUDA or CPU tensor")
    for name, t in (("B", B), ("step", step), ("g", g), ("g_old", g_old),
                    ("active", active), ("fresh", fresh)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    batch, n = step.shape
    if not fused_update_fits(n, B.element_size()):
        raise ValueError(
            f"n={n} {B.dtype}: one lane's B does not fit the {SMEM_LIMIT_BYTES} bytes of "
            "shared memory a block may use; use fused_bfgs_update_blocked "
            "(ops/kernels/bfgs_blocked.py) for such n"
        )
    lib = _library()
    d = torch.empty_like(g)
    m = torch.empty(batch, dtype=B.dtype, device=B.device)
    reset = torch.empty(batch, dtype=torch.bool, device=B.device)
    launch = lib.qnm_bfgs_update_f32 if B.dtype == torch.float32 else lib.qnm_bfgs_update_f64
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = launch(
            B.data_ptr(), step.data_ptr(), g.data_ptr(), g_old.data_ptr(),
            active.data_ptr(), fresh.data_ptr(), d.data_ptr(), m.data_ptr(),
            reset.data_ptr(), batch, n, stream,
        )
    check_launch(err, "bfgs_update")
    fused_bfgs_update_batched.launches += 1
    return B, d, m, reset


fused_bfgs_update_batched.launches = 0
