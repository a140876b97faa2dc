"""quasinewtonmethods_jl_tpu_torch — the PyTorch port of
`quasinewtonmethods_jl_tpu` for NVIDIA GPUs (Hopper).

Quasi-Newton maximization of log-densities, run as fleets of independent
solves (the HMC chain-initialisation workload). Names and arguments follow
the JAX package, which stays the reference the port is tested against. The
port holds the fleet BFGS engine (`optimize_batched`,
`optimize_batched_fused`, `optimize_batched_fused_from_state`,
`optimize_batched_compacted`; BackTracking or `Wolfe` line search) with its
hand-written CUDA update kernels (B1, ops/kernels/bfgs_kernel.py; the
two-pass B2 for large n, ops/kernels/bfgs_blocked.py), the whole-solve
resident engine (`optimize_batched_resident`, kernel B3) and the nonlinear
CG fleet (`optimize_cg`, `optimize_cg_from_state`); ROADMAP.md lists what
is still to port. Entry points run on the CUDA card unless given a CPU
tensor (`utils.device.as_device_tensor`).

The package imports torch and numpy, never jax.
"""

from .api import ProbabilityModel, as_logdensity, as_value_and_grad, as_value_fn
from .batched_solve import (
    optimize_batched_compacted,
    optimize_batched_fused,
    optimize_batched_fused_from_state,
)
from .cg_solve import CGResult, optimize_cg, optimize_cg_from_state
from .ops.bfgs import bfgs_update, initial_inv_hessian
from .ops.linesearch import BackTracking, LineSearchResult, backtracking_linesearch
from .ops.wolfe import Wolfe, WolfeResult, wolfe_linesearch
from .parallel.batch import optimize_batched
from .resident_solve import optimize_batched_resident, resident_feasible
from .solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT, OptimizeResult
from .state import (
    BFGSState,
    CGState,
    Status,
    bfgs_state_from_numpy,
    bfgs_state_to_numpy,
    cg_state_from_numpy,
    cg_state_to_numpy,
    init_bfgs_state,
)

__all__ = [
    "ProbabilityModel",
    "as_logdensity",
    "as_value_and_grad",
    "as_value_fn",
    "BackTracking",
    "LineSearchResult",
    "backtracking_linesearch",
    "Wolfe",
    "WolfeResult",
    "wolfe_linesearch",
    "bfgs_update",
    "initial_inv_hessian",
    "optimize_batched",
    "optimize_batched_fused",
    "optimize_batched_fused_from_state",
    "optimize_batched_compacted",
    "optimize_cg",
    "optimize_cg_from_state",
    "CGState",
    "CGResult",
    "optimize_batched_resident",
    "resident_feasible",
    "OptimizeResult",
    "MAX_ITERATIONS_DEFAULT",
    "STALL_LIMIT_DEFAULT",
    "BFGSState",
    "Status",
    "init_bfgs_state",
    "bfgs_state_from_numpy",
    "bfgs_state_to_numpy",
    "cg_state_from_numpy",
    "cg_state_to_numpy",
]
