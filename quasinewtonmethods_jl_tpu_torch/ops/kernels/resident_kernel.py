"""Whole-solve resident kernel B3 — its ctypes wrapper and plain version.

`resident_bfgs_solve` runs a Rosenbrock fleet's entire BFGS solve in one
launch of the hand-written CUDA kernel ``csrc/resident_solve.cu`` (one
block per lane, one warp up to n = 64, the lane's B and vectors in shared
memory throughout, the objective evaluated on the card) and returns the
result in the fleet engine's layout. On CPU tensors it takes the plain
version, `optimize_batched_resident_reference`: the fleet engine with the
plain update, which the kernel is held to.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...batched_solve import (
    _MAX_ITERATIONS,
    _Carry,
    _fresh_bfgs_carry,
    _result_from_batched_carry,
    optimize_batched_fused,
)
from ...models.rosenbrock import rosenbrock_logdensity, rosenbrock_value_and_grad
from ...solve import OptimizeResult
from ...utils.scalars import finite_halving_limit, sqrt_tolerance
from ..linesearch import BackTracking
from ._build import check_launch, load_library
from .bfgs_kernel import SMEM_LIMIT_BYTES, SMEM_SCRATCH_VALUES, launch_occupancy

__all__ = [
    "resident_bfgs_solve",
    "optimize_batched_resident_reference",
    "resident_feasible",
    "resident_occupancy",
]


def resident_feasible(n: int, itemsize: int) -> bool:
    """Whether one lane of B3 fits one block's shared memory: the count of
    ``smem_bytes`` in csrc/resident_solve.cu, (n² + 9n + the reduction
    scratch)·itemsize (n <= 236 in float32, n <= 165 in float64). Larger n
    belong to `optimize_batched_fused`."""
    return (n * n + 9 * n + SMEM_SCRATCH_VALUES) * itemsize <= SMEM_LIMIT_BYTES


def optimize_batched_resident_reference(
    x0s: torch.Tensor, ls: BackTracking, tol: float, max_iterations: int,
    h0_scale: bool, stall_limit: int,
) -> OptimizeResult:
    """The plain version of B3: the fleet engine with the plain PyTorch
    update on the Rosenbrock fleet, on ``x0s``'s device.

    The JAX package holds its resident engine lane for lane to its fleet
    engine with ``fold_eval=False`` (the same peel, masks, statuses and
    counters), so that engine, not a second per-lane solver, is the
    reference. The kernel evaluates `rosenbrock_value_and_grad` at the top
    of an iteration and `rosenbrock_logdensity` in line-search trials,
    as this run does."""
    return optimize_batched_fused(
        rosenbrock_logdensity, x0s, ls, tol, max_iterations,
        value_and_grad_fn=rosenbrock_value_and_grad, kernel="torch",
        h0_scale=h0_scale, stall_limit=stall_limit,
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library().cdll
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, real in ((lib.qnm_resident_solve_f32, ctypes.c_float),
                     (lib.qnm_resident_solve_f64, ctypes.c_double)):
        fn.argtypes = [ptr] * 14 + [i32, i32] + [real] * 6 + [i32] * 5 + [ptr]
        fn.restype = i32
    lib.qnm_resident_smem_bytes.argtypes = [i32, i32]
    lib.qnm_resident_smem_bytes.restype = ctypes.c_size_t
    lib.qnm_resident_occupancy.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 3
    lib.qnm_resident_occupancy.restype = i32
    return lib


def resident_occupancy(n: int, itemsize: int) -> dict:
    """B3's launch at n on the current card: registers per thread, threads
    per block, blocks per SM."""
    return launch_occupancy(_library().qnm_resident_occupancy, n, itemsize)


def resident_bfgs_solve(
    x0s: torch.Tensor, ls: BackTracking, tol: float, max_iterations: int,
    h0_scale: bool, stall_limit: int,
) -> OptimizeResult:
    """Maximize the split Rosenbrock from each row of ``x0s`` (batch, n).

    On CUDA tensors this makes one launch of B3 on the current stream (none
    when ``max_iterations`` < 1: the fresh carry is the result), does not
    synchronise, and counts the launch in ``resident_bfgs_solve.launches``.
    It raises where the kernel cannot run: TypeError for a dtype other than
    float32/float64, ValueError when one lane does not fit a block's shared
    memory (`resident_feasible`), RuntimeError on a failed build or launch. On
    CPU tensors it computes the plain version."""
    if x0s.device.type == "cpu":
        return optimize_batched_resident_reference(
            x0s, ls, tol, max_iterations, h0_scale, stall_limit)
    if x0s.device.type != "cuda":
        raise ValueError(f"unsupported device {x0s.device}; use a CUDA or CPU tensor")
    dtype = x0s.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x0s must be float32 or float64, got {dtype}")
    batch, n = x0s.shape
    if not resident_feasible(n, x0s.element_size()):
        raise ValueError(
            f"resident kernel infeasible for n={n} {dtype}: one lane's B and vectors do not "
            "fit a block's shared memory; use optimize_batched_fused"
        )
    if max_iterations < 1:
        status = torch.full((batch,), _MAX_ITERATIONS, dtype=torch.int32, device=x0s.device)
        return _result_from_batched_carry(_fresh_bfgs_carry(x0s, status))

    X0 = x0s.contiguous()
    vec = [torch.empty_like(X0) for _ in range(4)]  # X, G, G_old, STEP
    B = torch.empty((batch, n, n), dtype=dtype, device=X0.device)
    fun = torch.empty(batch, dtype=dtype, device=X0.device)
    ints = [torch.empty(batch, dtype=torch.int32, device=X0.device) for _ in range(6)]
    status, iterations, n_fev, n_gev, n_resets, stall = ints
    fresh = torch.empty(batch, dtype=torch.bool, device=X0.device)
    lib = _library()
    launch = lib.qnm_resident_solve_f32 if dtype == torch.float32 else lib.qnm_resident_solve_f64
    with torch.cuda.device(X0.device):
        stream = torch.cuda.current_stream(X0.device).cuda_stream
        err = launch(
            X0.data_ptr(), *(t.data_ptr() for t in vec), B.data_ptr(), fun.data_ptr(),
            *(t.data_ptr() for t in ints[:5]), fresh.data_ptr(), stall.data_ptr(),
            batch, n, tol, ls.c1, ls.rho_hi, ls.rho_lo, torch.finfo(dtype).eps,
            sqrt_tolerance(dtype), ls.iterations + finite_halving_limit(dtype),
            max_iterations, stall_limit, ls.order, int(bool(h0_scale)), stream,
        )
    check_launch(err, "resident_solve")
    resident_bfgs_solve.launches += 1
    X, G, G_old, STEP = vec
    return _result_from_batched_carry(_Carry(
        X=X, G=G, G_old=G_old, STEP=STEP, B=B, fun=fun, fprev=fun, k=0, status=status,
        iterations=iterations, n_fev=n_fev, n_gev=n_gev, n_resets=n_resets, fresh=fresh,
        stall=stall,
    ))


resident_bfgs_solve.launches = 0
