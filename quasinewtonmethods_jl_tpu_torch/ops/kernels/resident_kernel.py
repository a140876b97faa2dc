"""Whole-solve resident kernel B3 — its ctypes wrapper and plain version.

`resident_bfgs_solve` runs a fleet's entire BFGS solve in one launch of the
hand-written CUDA kernel ``csrc/resident_solve.cu`` (one block per lane,
one warp up to n = 64, the lane's B and vectors in shared memory
throughout, the objective evaluated on the card) and returns the result in
the fleet engine's layout. The kernel has one instantiation per objective
(csrc/resident_objectives.cuh): the split Rosenbrock, the ill-conditioned
quadratic (`models.IllConditionedQuadratic`: diag and x* in device memory)
and the logistic-regression MAP (`models.LogisticRegressionMAP`: X and y in
device memory). On CPU tensors it takes the plain version,
`optimize_batched_resident_reference`: the fleet engine with the plain
update on the same objective, which the kernel is held to.
"""

from __future__ import annotations

import copy
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
from ...models.logistic import LogisticRegressionMAP
from ...models.quadratic import IllConditionedQuadratic
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
    "objective_name",
    "objective_on",
    "KERNEL_MODELS",
]

# The kernel's objectives by the numbers its C entry points take (ObjectiveId).
_OBJECTIVE_IDS = {"rosenbrock": 0, "quadratic": 1, "logistic": 2}
# The data-bearing models the kernel evaluates (exact types: a subclass may
# evaluate something else): their instantiation and their data attributes.
KERNEL_MODELS = {IllConditionedQuadratic: ("quadratic", ("diag", "x_star")),
                 LogisticRegressionMAP: ("logistic", ("X", "y"))}


def objective_name(objective) -> str:
    """The kernel instantiation that evaluates ``objective``: 'rosenbrock'
    for None (the split Rosenbrock), else that of a `KERNEL_MODELS` model.
    Raises ValueError for any other objective."""
    if objective is None:
        return "rosenbrock"
    if type(objective) not in KERNEL_MODELS:
        raise ValueError(
            f"the resident kernel has no instantiation for {type(objective).__name__}")
    return KERNEL_MODELS[type(objective)][0]


def objective_on(objective, x0s: torch.Tensor):
    """A shallow copy of a `KERNEL_MODELS` model with its data on
    ``x0s``'s device and dtype, contiguous, as the kernel reads them."""
    model = copy.copy(objective)
    for attr in KERNEL_MODELS[type(objective)][1]:
        setattr(model, attr, getattr(objective, attr).to(device=x0s.device, dtype=x0s.dtype)
                .contiguous())
    return model


def _lane_warps(n: int) -> int:
    # bfgs_common.cuh :: lane_warps
    return 1 if n <= 64 else (n + 63) // 64


def _extra_values(name: str, n: int) -> int:
    """The objective's own shared memory, in values (the ``extra_values``
    of csrc/resident_objectives.cuh): the logistic's point and one chunk of
    residuals, none for the others."""
    return n + 32 * _lane_warps(n) if name == "logistic" else 0


def resident_feasible(n: int, itemsize: int, objective=None) -> bool:
    """Whether one lane of B3 fits one block's shared memory: the count of
    ``smem_bytes`` in csrc/resident_solve.cu, (n² + 9n + the reduction
    scratch + the objective's own)·itemsize. For the Rosenbrock (the
    default) and the quadratic n <= 236 in float32, n <= 165 in float64;
    the logistic's scratch takes a little more. Larger n belong to
    `optimize_batched_fused`."""
    values = n * n + 9 * n + SMEM_SCRATCH_VALUES + _extra_values(objective_name(objective), n)
    return values * itemsize <= SMEM_LIMIT_BYTES


def optimize_batched_resident_reference(
    x0s: torch.Tensor, ls: BackTracking, tol: float, max_iterations: int,
    h0_scale: bool, stall_limit: int, objective=None,
) -> OptimizeResult:
    """The plain version of B3: the fleet engine with the plain PyTorch
    update on ``objective`` (the split Rosenbrock when None), on ``x0s``'s
    device.

    The JAX package holds its resident engine lane for lane to its fleet
    engine with ``fold_eval=False`` (the same peel, masks, statuses and
    counters), so that engine, not a second per-lane solver, is the
    reference. The kernel evaluates the objective's value and gradient at
    the top of an iteration and its value alone in line-search trials, as
    this run does: `rosenbrock_value_and_grad` and `rosenbrock_logdensity`;
    a model's ``logdensity_and_gradient`` and ``logdensity``."""
    if objective is None:
        return optimize_batched_fused(
            rosenbrock_logdensity, x0s, ls, tol, max_iterations,
            value_and_grad_fn=rosenbrock_value_and_grad, kernel="torch",
            h0_scale=h0_scale, stall_limit=stall_limit,
        )
    return optimize_batched_fused(objective, x0s, ls, tol, max_iterations, kernel="torch",
                                  h0_scale=h0_scale, stall_limit=stall_limit)


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
    # the data-bearing objectives: the same arguments, then the data
    for fn, real, data in ((lib.qnm_resident_solve_quadratic_f32, ctypes.c_float, [ptr, ptr]),
                           (lib.qnm_resident_solve_quadratic_f64, ctypes.c_double, [ptr, ptr]),
                           (lib.qnm_resident_solve_logistic_f32, ctypes.c_float,
                            [ptr, ptr, i32, ctypes.c_float]),
                           (lib.qnm_resident_solve_logistic_f64, ctypes.c_double,
                            [ptr, ptr, i32, ctypes.c_double])):
        fn.argtypes = [ptr] * 14 + [i32, i32] + [real] * 6 + [i32] * 5 + data + [ptr]
        fn.restype = i32
    lib.qnm_resident_objective_smem_bytes.argtypes = [i32, i32, i32]
    lib.qnm_resident_objective_smem_bytes.restype = ctypes.c_size_t
    lib.qnm_resident_objective_occupancy.argtypes = [i32] * 3 + [ctypes.POINTER(i32)] * 3
    lib.qnm_resident_objective_occupancy.restype = i32
    return lib


def resident_occupancy(n: int, itemsize: int, objective=None) -> dict:
    """B3's launch at n on the current card, for ``objective``'s
    instantiation (see `objective_name`): registers per thread, threads per
    block, blocks per SM."""
    query = functools.partial(_library().qnm_resident_objective_occupancy,
                              _OBJECTIVE_IDS[objective_name(objective)])
    return launch_occupancy(query, n, itemsize)


def _data_args(name: str, objective, x0s: torch.Tensor) -> list:
    """The launch's data arguments for ``objective``: its tensors, which
    must lie on x0s's device in its dtype, contiguous (the entry point puts
    them there once per solve, `objective_on`)."""
    if name == "rosenbrock":
        return []
    tensors = [getattr(objective, attr) for attr in KERNEL_MODELS[type(objective)][1]]
    for t in tensors:
        if t.device != x0s.device or t.dtype != x0s.dtype or not t.is_contiguous():
            raise ValueError(
                f"the {name} objective's data must be contiguous {x0s.dtype} tensors on "
                f"{x0s.device}, got {t.dtype} on {t.device}")
    n = x0s.shape[1]
    if name == "quadratic":
        if tensors[0].shape != (n,) or tensors[1].shape != (n,):
            raise ValueError(f"the quadratic's diag and x_star must be ({n},)")
        return [t.data_ptr() for t in tensors]
    X, y = tensors
    if X.ndim != 2 or X.shape[1] != n or y.shape != X.shape[:1]:
        raise ValueError(f"the logistic's X must be (n_obs, {n}) and y (n_obs,)")
    return [X.data_ptr(), y.data_ptr(), X.shape[0], objective.prior_scale ** 2]


def resident_bfgs_solve(
    x0s: torch.Tensor, ls: BackTracking, tol: float, max_iterations: int,
    h0_scale: bool, stall_limit: int, objective=None,
) -> OptimizeResult:
    """Maximize ``objective`` (the split Rosenbrock when None, or an
    `IllConditionedQuadratic` / `LogisticRegressionMAP` whose data lie on
    ``x0s``'s device in its dtype) from each row of ``x0s`` (batch, n).

    On CUDA tensors this makes one launch of B3's instantiation for the
    objective on the current stream (none when ``max_iterations`` < 1: the
    fresh carry is the result), does not synchronise, and counts the launch
    in ``resident_bfgs_solve.launches`` and, by instantiation, in
    ``resident_bfgs_solve.objective_launches``. It raises where the kernel
    cannot run: TypeError for a dtype other than float32/float64,
    ValueError for an objective it has no instantiation for or whose data
    are elsewhere, or when one lane does not fit a block's shared memory
    (`resident_feasible`), RuntimeError on a failed build or launch. On CPU
    tensors it computes the plain version."""
    name = objective_name(objective)
    if x0s.device.type == "cpu":
        return optimize_batched_resident_reference(
            x0s, ls, tol, max_iterations, h0_scale, stall_limit, objective)
    if x0s.device.type != "cuda":
        raise ValueError(f"unsupported device {x0s.device}; use a CUDA or CPU tensor")
    dtype = x0s.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x0s must be float32 or float64, got {dtype}")
    batch, n = x0s.shape
    if not resident_feasible(n, x0s.element_size(), objective):
        raise ValueError(
            f"resident kernel infeasible for n={n} {dtype}: one lane's B and vectors do not "
            "fit a block's shared memory; use optimize_batched_fused"
        )
    data = _data_args(name, objective, x0s)
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
    suffix = "f32" if dtype == torch.float32 else "f64"
    launch = getattr(lib, f"qnm_resident_solve_{suffix}" if name == "rosenbrock"
                     else f"qnm_resident_solve_{name}_{suffix}")
    with torch.cuda.device(X0.device):
        stream = torch.cuda.current_stream(X0.device).cuda_stream
        err = launch(
            X0.data_ptr(), *(t.data_ptr() for t in vec), B.data_ptr(), fun.data_ptr(),
            *(t.data_ptr() for t in ints[:5]), fresh.data_ptr(), stall.data_ptr(),
            batch, n, tol, ls.c1, ls.rho_hi, ls.rho_lo, torch.finfo(dtype).eps,
            sqrt_tolerance(dtype), ls.iterations + finite_halving_limit(dtype),
            max_iterations, stall_limit, ls.order, int(bool(h0_scale)), *data, stream,
        )
    check_launch(err, f"resident_solve[{name}]")
    resident_bfgs_solve.launches += 1
    resident_bfgs_solve.objective_launches[name] += 1
    X, G, G_old, STEP = vec
    return _result_from_batched_carry(_Carry(
        X=X, G=G, G_old=G_old, STEP=STEP, B=B, fun=fun, fprev=fun, k=0, status=status,
        iterations=iterations, n_fev=n_fev, n_gev=n_gev, n_resets=n_resets, fresh=fresh,
        stall=stall,
    ))


resident_bfgs_solve.launches = 0
resident_bfgs_solve.objective_launches = dict.fromkeys(_OBJECTIVE_IDS, 0)
