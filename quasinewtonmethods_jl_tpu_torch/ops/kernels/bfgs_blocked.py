"""Two-pass batched inverse-BFGS update — the fleet engine's kernel for n
whose B does not fit one block's shared memory.

Port of ``quasinewtonmethods_jl_tpu/ops/pallas/bfgs_blocked.py``. The
update's floor when B cannot stay on chip is three passes over B per call,
and the two hand-written CUDA kernels of ``csrc/bfgs_blocked.cu`` keep it
there:

  pass 1  `blocked_matvec` (B2a): By = Bᵀy and Bg = Bᵀg in one read of B;
  between `update_algebra` (ops/kernels/bfgs_kernel.py): the O(n·batch)
          algebra as plain tensor ops, with no B traffic, as the JAX
          wrapper runs it between its passes;
  pass 2  `blocked_update` (B2b): the rank-2 update of B in place, fused
          with the identity reset and the frozen-lane select.

Each pass launches its kernel on CUDA tensors (or raises) and counts the
launch in ``<pass>.launches``; on CPU tensors it takes its plain version,
`blocked_matvec_reference` / `blocked_update_reference`. Layout is
lane-major, as everywhere in the port. Mosaic's row slabs (``block_r``,
`blocked_feasible_rows`) and the ``matvec="xla"`` variant have no
counterpart: a CUDA block reads any column of B directly.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ._build import check_launch, load_library
from .bfgs_kernel import (
    _check_args,
    blocked_matvec_reference,
    blocked_update_reference,
    update_algebra,
)

__all__ = [
    "fused_bfgs_update_blocked",
    "blocked_matvec",
    "blocked_update",
    "blocked_matvec_reference",
    "blocked_update_reference",
]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library().cdll
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.qnm_blocked_matvec_f32, lib.qnm_blocked_matvec_f64):
        fn.argtypes = [ptr] * 5 + [i32, i32, ptr]
        fn.restype = i32
    for fn in (lib.qnm_blocked_update_f32, lib.qnm_blocked_update_f64):
        fn.argtypes = [ptr] * 7 + [i32, i32, ptr]
        fn.restype = i32
    return lib


def _check_pass(B, vectors, scalars, masks):
    """B (batch, n, n) float32/float64; each (name, tensor) of ``vectors``
    (batch, n) and of ``scalars`` (batch,) in B's dtype, of ``masks``
    (batch,) bool; one device; contiguous where it is CUDA."""
    if B.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"B must be float32 or float64, got {B.dtype}")
    if B.ndim != 3 or B.shape[1] != B.shape[2]:
        raise ValueError(f"B must be (batch, n, n), got {tuple(B.shape)}")
    batch, n = B.shape[0], B.shape[1]
    expected = [(v, (batch, n), B.dtype) for v in vectors]
    expected += [(v, (batch,), B.dtype) for v in scalars]
    expected += [(v, (batch,), torch.bool) for v in masks]
    for (name, t), shape, dtype in expected:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    tensors = [("B", B)] + [v for v, _, _ in expected]
    devices = {t.device for _, t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all arguments must be on one device, got {sorted(map(str, devices))}")
    if B.device.type == "cuda":
        for name, t in tensors:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    elif B.device.type != "cpu":
        raise ValueError(f"unsupported device {B.device}; use a CUDA or CPU tensor")


def blocked_matvec(B: torch.Tensor, y: torch.Tensor, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1: (Bᵀy, Bᵀg) per lane in one read of B. On CUDA tensors it
    launches B2a on the current stream without synchronising (one thread
    per column, rows summed in ascending order) and counts the launch in
    ``blocked_matvec.launches``; on CPU tensors it computes the plain
    version."""
    _check_pass(B, [("y", y), ("g", g)], [], [])
    if B.device.type == "cpu":
        return blocked_matvec_reference(B, y, g)
    lib = _library()
    batch, n = y.shape
    By, Bg = torch.empty_like(y), torch.empty_like(g)
    launch = lib.qnm_blocked_matvec_f32 if B.dtype == torch.float32 else lib.qnm_blocked_matvec_f64
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = launch(B.data_ptr(), y.data_ptr(), g.data_ptr(), By.data_ptr(), Bg.data_ptr(),
                     batch, n, stream)
    check_launch(err, "blocked_matvec")
    blocked_matvec.launches += 1
    return By, Bg


def blocked_update(B, s, u, c1, scale, do_upd, reset) -> torch.Tensor:
    """Pass 2, IN PLACE: B = scale·B + c₁ s sᵀ - u sᵀ - s uᵀ on ``do_upd``
    lanes, B = I on ``reset`` lanes, frozen lanes untouched. On CUDA tensors
    it launches B2b on the current stream without synchronising and counts
    the launch in ``blocked_update.launches``; on CPU tensors it computes
    the plain version. Returns B."""
    _check_pass(B, [("s", s), ("u", u)], [("c1", c1), ("scale", scale)],
                [("do_upd", do_upd), ("reset", reset)])
    if B.device.type == "cpu":
        return blocked_update_reference(B, s, u, c1, scale, do_upd, reset)
    lib = _library()
    batch, n = s.shape
    launch = lib.qnm_blocked_update_f32 if B.dtype == torch.float32 else lib.qnm_blocked_update_f64
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = launch(B.data_ptr(), s.data_ptr(), u.data_ptr(), c1.data_ptr(), scale.data_ptr(),
                     do_upd.data_ptr(), reset.data_ptr(), batch, n, stream)
    check_launch(err, "blocked_update")
    blocked_update.launches += 1
    return B


def fused_bfgs_update_blocked(
    B: torch.Tensor,  # (batch, n, n) inverse Hessians, updated in place
    step: torch.Tensor,  # (batch, n) previous accepted steps
    g: torch.Tensor,  # (batch, n) gradients at the new iterates
    g_old: torch.Tensor,  # (batch, n) gradients at the previous iterates
    active: torch.Tensor,  # (batch,) bool: lane still running
    fresh: torch.Tensor,  # (batch,) bool: B is a fresh identity
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-pass fused BFGS update + direction for a whole fleet, at any n;
    returns (B, d, m, reset) with the semantics of
    `fused_bfgs_update_reference`, B updated IN PLACE, three passes over B,
    no synchronisation. Raises where a kernel cannot run (RuntimeError on a
    failed build or launch); on CPU tensors both passes are plain."""
    _check_args(B, step, g, g_old, active, fresh)
    y = g_old - g
    By, Bg = blocked_matvec(B, y, g)
    alg = update_algebra(By, Bg, step, y, g, active, fresh)
    blocked_update(B, step, alg.u, alg.c1, alg.scale, alg.do_upd, alg.reset)
    return B, alg.d, alg.m, alg.reset


blocked_matvec.launches = 0
blocked_update.launches = 0
