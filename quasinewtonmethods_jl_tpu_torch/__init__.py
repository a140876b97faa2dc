"""quasinewtonmethods_jl_tpu_torch — the PyTorch port of
`quasinewtonmethods_jl_tpu` for NVIDIA GPUs (Hopper).

BFGS maximization of log-densities, run as fleets of independent solves
(the HMC chain-initialisation workload). Names and arguments follow the
JAX package, which stays the reference the port is tested against. This
slice holds the fleet BFGS engine (`optimize_batched`,
`optimize_batched_fused`) with its hand-written CUDA update kernel
(ops/kernels/bfgs_kernel.py); ROADMAP.md lists what is still to port.

The package imports torch and numpy, never jax.
"""

from .api import ProbabilityModel, as_logdensity, as_value_and_grad, as_value_fn
from .batched_solve import optimize_batched_fused
from .ops.bfgs import bfgs_update, initial_inv_hessian
from .ops.linesearch import BackTracking, LineSearchResult, backtracking_linesearch
from .parallel.batch import optimize_batched
from .solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT, OptimizeResult
from .state import (
    BFGSState,
    Status,
    bfgs_state_from_numpy,
    bfgs_state_to_numpy,
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
    "bfgs_update",
    "initial_inv_hessian",
    "optimize_batched",
    "optimize_batched_fused",
    "OptimizeResult",
    "MAX_ITERATIONS_DEFAULT",
    "STALL_LIMIT_DEFAULT",
    "BFGSState",
    "Status",
    "init_bfgs_state",
    "bfgs_state_from_numpy",
    "bfgs_state_to_numpy",
]
