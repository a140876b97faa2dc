"""Whole-solve resident kernel B3 — its ctypes wrapper and plain version.

`resident_bfgs_solve` runs a fleet's entire BFGS solve in one launch of the
hand-written CUDA kernel ``csrc/resident_solve.cu`` (one block per lane,
one warp up to n = 64, the lane's B and vectors in shared memory
throughout, the objective evaluated on the card) and returns the result in
the fleet engine's layout. The kernel has one instantiation per objective
(csrc/resident_objectives.cuh): the split Rosenbrock and Neal's funnel
(`models.funnel_logdensity`), which carry no data; the ill-conditioned
quadratic (`models.IllConditionedQuadratic`: diag and x* in device memory);
the logistic-regression and Poisson MAPs (`models.LogisticRegressionMAP`,
`models.PoissonRegressionMAP`: X and y in device memory); the Gaussian
mixture (`models.GaussianMixture`: means, weights and sigmas in device
memory, at most 8 components); and the AR(1) state-space MAP
(`models.AR1DriftMAP`: A, copied to shared memory, and ys in device
memory). Any other objective comes traced (`TracedObjective`,
ops/kernels/objective_trace.py): its value and gradient are generated as
CUDA for its graph and shapes (ops/kernels/objective_codegen.py), built at
first use into a library of their own (`load_generated`), and its
constants lie in device memory. On CPU tensors it takes the plain version,
`optimize_batched_resident_reference`: the fleet engine with the plain
update on the same objective, which the kernel is held to.
"""

from __future__ import annotations

import contextlib
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
from ...models.funnel import funnel_logdensity
from ...models.logistic import LogisticRegressionMAP
from ...models.mixture import GaussianMixture
from ...models.poisson import PoissonRegressionMAP
from ...models.quadratic import IllConditionedQuadratic
from ...models.statespace import AR1DriftMAP
from ...models.rosenbrock import rosenbrock_logdensity, rosenbrock_value_and_grad
from ...solve import OptimizeResult
from ...utils.scalars import finite_halving_limit, sqrt_tolerance
from ..linesearch import BackTracking
from ._build import check_launch, load_generated, load_library
from .bfgs_kernel import launch_occupancy
from .objective_codegen import generate, lane_warps
from .objective_trace import TracedObjective, in_band_linalg, lane_fits

__all__ = [
    "resident_bfgs_solve",
    "optimize_batched_resident_reference",
    "resident_feasible",
    "resident_occupancy",
    "objective_name",
    "objective_on",
    "traced_libraries",
    "KERNEL_MODELS",
]

# The kernel's objectives by the numbers its C entry points take (ObjectiveId).
_OBJECTIVE_IDS = {"rosenbrock": 0, "quadratic": 1, "logistic": 2, "funnel": 3, "mixture": 4,
                  "poisson": 5, "ar1": 6}
# The data-bearing models the kernel evaluates (exact types: a subclass may
# evaluate something else): their instantiation and their data attributes.
KERNEL_MODELS = {IllConditionedQuadratic: ("quadratic", ("diag", "x_star")),
                 LogisticRegressionMAP: ("logistic", ("X", "y")),
                 GaussianMixture: ("mixture", ("means", "weights", "sigmas")),
                 PoissonRegressionMAP: ("poisson", ("X", "y")),
                 AR1DriftMAP: ("ar1", ("A", "ys"))}
# The mixture's components are summed in one lane sum (kMaxComponents).
MAX_MIXTURE_COMPONENTS = 8


def objective_name(objective) -> str:
    """The kernel instantiation that evaluates ``objective``: 'rosenbrock'
    for None (the split Rosenbrock), 'funnel' for `funnel_logdensity`,
    'traced' for a `TracedObjective`, else that of a `KERNEL_MODELS` model.
    Raises ValueError for any other objective (a function or a model not
    yet traced)."""
    if isinstance(objective, TracedObjective):
        return "traced"
    if objective is None:
        return "rosenbrock"
    if objective is funnel_logdensity:
        return "funnel"
    if type(objective) not in KERNEL_MODELS:
        raise ValueError(
            f"the resident kernel has no instantiation for {type(objective).__name__}")
    return KERNEL_MODELS[type(objective)][0]


def objective_on(objective, x0s: torch.Tensor):
    """A shallow copy of a `KERNEL_MODELS` model with its data on
    ``x0s``'s device and dtype, contiguous, as the kernel reads them
    (`funnel_logdensity`, which has none, as it is)."""
    if objective is funnel_logdensity:
        return objective
    model = copy.copy(objective)
    for attr in KERNEL_MODELS[type(objective)][1]:
        setattr(model, attr, getattr(objective, attr).to(device=x0s.device, dtype=x0s.dtype)
                .contiguous())
    return model


def _objective_size(objective) -> int:
    """The size the objective's shared memory depends on besides n: the
    AR(1)'s number of steps; 0 for the others."""
    return objective.ys.shape[0] if objective_name(objective) == "ar1" else 0


def _extra_values(objective, n: int) -> int:
    """The objective's own shared memory, in values (the ``extra_values``
    of csrc/resident_objectives.cuh): the GLMs' point and one chunk of
    residuals, the AR(1)'s A, its states z_0..z_T and two adjoint buffers,
    none for the others."""
    name = objective_name(objective)
    if name == "traced":
        return objective.extra_values
    if name in ("logistic", "poisson"):
        return n + 32 * lane_warps(n)
    if name == "ar1":
        return n * n + (_objective_size(objective) + 1) * n + 2 * n
    return 0


def resident_feasible(n: int, itemsize: int, objective=None) -> bool:
    """Whether one lane of B3 fits one block's shared memory: the count of
    ``smem_bytes`` in csrc/resident_solve.cu, (n² + 9n + the reduction
    scratch + the objective's own)·itemsize. For the Rosenbrock (the
    default), the quadratic, the funnel and the mixture n <= 236 in
    float32, n <= 165 in float64; the GLMs' scratch takes a little more,
    the AR(1)'s depends on its number of steps too, a traced objective's
    on its graph (one slot per op's output, a cumsum's, a gather's and a
    put's among them, a Cholesky factor's m² and an LU work copy's m², the
    slots reused where that does not fit; its constants and int32 index
    tables lie in device memory and take none).
    Larger n, and objectives whose matrices do not fit, belong to
    `optimize_batched_fused`."""
    return lane_fits(n, itemsize, _extra_values(objective, n))


def optimize_batched_resident_reference(
    x0s: torch.Tensor, ls: BackTracking, tol: float, max_iterations: int,
    h0_scale: bool, stall_limit: int, objective=None,
) -> OptimizeResult:
    """The plain version of B3: the fleet engine with the plain PyTorch
    update on ``objective`` (the split Rosenbrock when None: a model, or
    `funnel_logdensity`), on ``x0s``'s device.

    The JAX package holds its resident engine lane for lane to its fleet
    engine with ``fold_eval=False`` (the same peel, masks, statuses and
    counters), so that engine, not a second per-lane solver, is the
    reference. The kernel evaluates the objective's value and gradient at
    the top of an iteration and its value alone in line-search trials, as
    this run does: `rosenbrock_value_and_grad` and `rosenbrock_logdensity`;
    a model's ``logdensity_and_gradient`` and ``logdensity``; the funnel's
    gradient by ``torch.func``; a traced objective's user functions, as
    the fleet engine resolves them, where they factorize a matrix under
    `in_band_linalg` (a failed factorization gives NaN on its lane, as in
    the kernel, not an exception)."""
    if isinstance(objective, TracedObjective):
        with in_band_linalg() if objective.factorizes else contextlib.nullcontext():
            return optimize_batched_fused(
                objective.obj, x0s, ls, tol, max_iterations,
                value_and_grad_fn=objective.value_and_grad_fn, kernel="torch",
                h0_scale=h0_scale, stall_limit=stall_limit,
            )
    if objective is None:
        return optimize_batched_fused(
            rosenbrock_logdensity, x0s, ls, tol, max_iterations,
            value_and_grad_fn=rosenbrock_value_and_grad, kernel="torch",
            h0_scale=h0_scale, stall_limit=stall_limit,
        )
    return optimize_batched_fused(objective, x0s, ls, tol, max_iterations, kernel="torch",
                                  h0_scale=h0_scale, stall_limit=stall_limit)


# The data arguments of each objective's C entry point after the common
# ones (_REAL: the entry's float type).
_REAL = object()
_DATA_ARGTYPES = {
    "quadratic": [ctypes.c_void_p] * 2,                            # diag, x*
    "logistic": [ctypes.c_void_p] * 2 + [ctypes.c_int, _REAL],     # X, y, n_obs, prior²
    "poisson": [ctypes.c_void_p] * 2 + [ctypes.c_int, _REAL],      # X, y, n_obs, prior²
    "funnel": [],
    "mixture": [ctypes.c_void_p] * 3 + [ctypes.c_int],             # means, weights, sigmas, K
    "ar1": [ctypes.c_void_p] * 2 + [ctypes.c_int, _REAL, _REAL],   # A, ys, T, 1/(2s²), prior²
}


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
    # the other objectives: the same arguments, then the data
    for name, data in _DATA_ARGTYPES.items():
        for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            fn = getattr(lib, f"qnm_resident_solve_{name}_{suffix}")
            fn.argtypes = ([ptr] * 14 + [i32, i32] + [real] * 6 + [i32] * 5
                           + [real if t is _REAL else t for t in data] + [ptr])
            fn.restype = i32
    lib.qnm_resident_objective_smem_bytes.argtypes = [i32] * 4
    lib.qnm_resident_objective_smem_bytes.restype = ctypes.c_size_t
    lib.qnm_resident_objective_occupancy.argtypes = [i32] * 4 + [ctypes.POINTER(i32)] * 3
    lib.qnm_resident_objective_occupancy.restype = i32
    return lib


def traced_libraries(*traced: TracedObjective) -> list:
    """The libraries of B3 with each traced objective's generated
    evaluation (ctypes), built where needed, in parallel, and loaded. Each
    trace keeps its library (``library``): a trace solved again neither
    generates its text nor looks it up."""
    todo = [t for t in traced if t.library is None]
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for built, t in zip(load_generated(*(generate(t) for t in todo)), todo):
        lib = built.cdll
        real = ctypes.c_float if t.dtype == torch.float32 else ctypes.c_double
        lib.qnm_traced_solve.argtypes = ([ptr] * 14 + [i32, i32] + [real] * 6 + [i32] * 5
                                         + [ptr, ptr])
        lib.qnm_traced_solve.restype = i32
        lib.qnm_traced_occupancy.argtypes = [ctypes.POINTER(i32)] * 3
        lib.qnm_traced_occupancy.restype = i32
        t.library = lib
    return [t.library for t in traced]


def resident_occupancy(n: int, itemsize: int, objective=None) -> dict:
    """B3's launch at n on the current card, for ``objective``'s
    instantiation (see `objective_name`; a traced objective's at its own n
    and dtype): registers per thread, threads per block, blocks per SM."""
    if isinstance(objective, TracedObjective):
        lib = traced_libraries(objective)[0]
        return launch_occupancy(lambda n, itemsize, *out: lib.qnm_traced_occupancy(*out),
                                objective.n, objective.dtype.itemsize)
    number, size = _OBJECTIVE_IDS[objective_name(objective)], _objective_size(objective)

    def query(n, itemsize, *out):
        return _library().qnm_resident_objective_occupancy(number, n, size, itemsize, *out)

    return launch_occupancy(query, n, itemsize)


def _data_args(name: str, objective, x0s: torch.Tensor) -> list:
    """The launch's data arguments for ``objective``: its tensors, which
    must lie on x0s's device in its dtype, contiguous (the entry point puts
    them there once per solve, `objective_on`), then its sizes and
    constants."""
    if name == "traced":
        if objective.n != x0s.shape[1] or objective.dtype != x0s.dtype:
            raise ValueError(f"the objective was traced for ({objective.n},) {objective.dtype} "
                             f"points, got x0s {tuple(x0s.shape)} {x0s.dtype}")
        for t in objective.consts:
            if t.device != x0s.device or t.dtype != x0s.dtype or not t.is_contiguous():
                raise ValueError(f"a traced objective's constants must be contiguous "
                                 f"{x0s.dtype} tensors on {x0s.device}, got {t.dtype} on "
                                 f"{t.device}")
        for t in objective.tables:
            if t.device != x0s.device or t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError(f"a traced objective's index tables must be contiguous int32 "
                                 f"tensors on {x0s.device}, got {t.dtype} on {t.device}")
        pointers = [t.data_ptr() for t in (*objective.consts, *objective.tables)]
        return [(ctypes.c_void_p * max(1, len(pointers)))(*pointers)]
    if type(objective) not in KERNEL_MODELS:
        return []  # the split Rosenbrock and the funnel
    tensors = [getattr(objective, attr) for attr in KERNEL_MODELS[type(objective)][1]]
    for t in tensors:
        if t.device != x0s.device or t.dtype != x0s.dtype or not t.is_contiguous():
            raise ValueError(
                f"the {name} objective's data must be contiguous {x0s.dtype} tensors on "
                f"{x0s.device}, got {t.dtype} on {t.device}")
    n = x0s.shape[1]
    ptrs = [t.data_ptr() for t in tensors]
    if name == "quadratic":
        if tensors[0].shape != (n,) or tensors[1].shape != (n,):
            raise ValueError(f"the quadratic's diag and x_star must be ({n},)")
        return ptrs
    if name == "mixture":
        means, weights, sigmas = tensors
        K = means.shape[0]
        if means.shape != (K, n) or weights.shape != (K,) or sigmas.shape != (K,):
            raise ValueError(f"the mixture's means must be (K, {n}), weights and sigmas (K,)")
        if K > MAX_MIXTURE_COMPONENTS:
            raise ValueError(f"the resident kernel's mixture takes at most "
                             f"{MAX_MIXTURE_COMPONENTS} components, got {K}; use "
                             "optimize_batched_fused")
        return ptrs + [K]
    if name == "ar1":
        A, ys = tensors
        if A.shape != (n, n) or ys.ndim != 2 or ys.shape[1] != n:
            raise ValueError(f"the AR(1)'s A must be ({n}, {n}) and ys (n_steps, {n})")
        return ptrs + [ys.shape[0], 0.5 / objective.obs_scale ** 2, objective.prior_scale ** 2]
    X, y = tensors
    if X.ndim != 2 or X.shape[1] != n or y.shape != X.shape[:1]:
        raise ValueError(f"the {name} model's X must be (n_obs, {n}) and y (n_obs,)")
    return ptrs + [X.shape[0], objective.prior_scale ** 2]


def resident_bfgs_solve(
    x0s: torch.Tensor, ls: BackTracking, tol: float, max_iterations: int,
    h0_scale: bool, stall_limit: int, objective=None,
) -> OptimizeResult:
    """Maximize ``objective`` (the split Rosenbrock when None,
    `funnel_logdensity`, or a `KERNEL_MODELS` model whose data lie on
    ``x0s``'s device in its dtype) from each row of ``x0s`` (batch, n).

    On CUDA tensors this makes one launch of B3's instantiation for the
    objective on the current stream (none when ``max_iterations`` < 1: the
    fresh carry is the result), does not synchronise, and counts the launch
    in ``resident_bfgs_solve.launches`` and, by instantiation, in
    ``resident_bfgs_solve.objective_launches``. It raises where the kernel
    cannot run: TypeError for a dtype other than float32/float64,
    ValueError for an objective it has no instantiation for or whose data
    are elsewhere (a traced objective's constants too, and its n and
    dtype), a mixture of more than 8 components, or when one lane does not
    fit a block's shared memory (`resident_feasible`), RuntimeError on a
    failed build or launch. On CPU tensors it computes the plain version."""
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
            f"resident kernel infeasible for n={n} {dtype}: one lane's B, vectors and "
            "objective scratch do not fit a block's shared memory; use optimize_batched_fused"
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
    suffix = "f32" if dtype == torch.float32 else "f64"
    if name == "traced":
        lib = traced_libraries(objective)[0]
        launch = lib.qnm_traced_solve
    else:
        lib = _library()
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
    check_launch(err, f"resident_solve[{name}]", lib)
    resident_bfgs_solve.launches += 1
    resident_bfgs_solve.objective_launches[name] += 1
    X, G, G_old, STEP = vec
    return _result_from_batched_carry(_Carry(
        X=X, G=G, G_old=G_old, STEP=STEP, B=B, fun=fun, fprev=fun, k=0, status=status,
        iterations=iterations, n_fev=n_fev, n_gev=n_gev, n_resets=n_resets, fresh=fresh,
        stall=stall,
    ))


resident_bfgs_solve.launches = 0
resident_bfgs_solve.objective_launches = dict.fromkeys((*_OBJECTIVE_IDS, "traced"), 0)
