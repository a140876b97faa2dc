"""quasinewtonmethods_jl_tpu_torch — the PyTorch port of
`quasinewtonmethods_jl_tpu` for NVIDIA GPUs (Hopper).

Quasi-Newton maximization of log-densities, run as fleets of independent
solves (the HMC chain-initialisation workload). Names and arguments follow
the JAX package, which stays the reference the port is tested against. The
port holds the scalar BFGS driver (`optimize`, `optimize_from_state`; BFGS,
DFP or SR1 updates), the fleet BFGS engine (`optimize_batched`,
`optimize_batched_fused`, `optimize_batched_fused_from_state`,
`optimize_batched_compacted`; BackTracking or `Wolfe` line search) with its
hand-written CUDA update kernels (B1, ops/kernels/bfgs_kernel.py; the
two-pass B2 for large n, ops/kernels/bfgs_blocked.py), the whole-solve
resident engine (`optimize_batched_resident`, kernel B3), the nonlinear CG
fleet (`optimize_cg`, `optimize_cg_from_state`) and L-BFGS, scalar
(`optimize_lbfgs`, `optimize_lbfgs_from_state`) and as a fleet
(`optimize_lbfgs_batched`, `optimize_lbfgs_batched_fused_from_state`),
the constrained-parameter transforms (`transforms`,
`transform_objective`), Levenberg–Marquardt least squares
(`least_squares`, `least_squares_from_state`), the trust-region
Newton–Krylov engine (`optimize_tr`, `optimize_tr_from_state`), the
augmented Lagrangian over all four engines (`optimize_auglag`) and the
scipy-convention front door `minimize`; ROADMAP.md lists what is still to
port. Entry points run on the CUDA card unless given a CPU
tensor (`utils.device.as_device_tensor`).

The package imports torch and numpy, never jax.
"""

from . import transforms
from .api import ProbabilityModel, as_logdensity, as_value_and_grad, as_value_fn
from .batched_solve import (
    optimize_batched_compacted,
    optimize_batched_fused,
    optimize_batched_fused_from_state,
)
from .cg_solve import CGResult, optimize_cg, optimize_cg_from_state
from .constrained import AugLagResult, optimize_auglag
from .lbfgs_batched_solve import optimize_lbfgs_batched_fused_from_state
from .lbfgs_solve import LBFGSResult, optimize_lbfgs, optimize_lbfgs_from_state
from .least_squares import LeastSquaresResult, least_squares, least_squares_from_state
from .minimize import minimize
from .models import LogisticRegressionMAP
from .ops.bfgs import bfgs_update, dfp_update, initial_inv_hessian, sr1_update
from .ops.linesearch import BackTracking, LineSearchResult, backtracking_linesearch
from .ops.wolfe import Wolfe, WolfeResult, wolfe_linesearch
from .parallel.batch import optimize_batched, optimize_lbfgs_batched
from .resident_solve import optimize_batched_resident, resident_feasible, trace_objective
from .solve import (
    MAX_ITERATIONS_DEFAULT,
    STALL_LIMIT_DEFAULT,
    OptimizeResult,
    optimize,
    optimize_from_state,
)
from .transforms import TransformedModel, transform_objective
from .trust_region import TRResult, optimize_tr, optimize_tr_from_state
from .state import (
    BFGSState,
    CGState,
    LBFGSState,
    LMState,
    Status,
    TRState,
    bfgs_state_from_numpy,
    bfgs_state_to_numpy,
    cg_state_from_numpy,
    cg_state_to_numpy,
    init_bfgs_state,
    init_lbfgs_state,
    lbfgs_state_from_numpy,
    lbfgs_state_to_numpy,
    lm_state_from_numpy,
    lm_state_to_numpy,
    tr_state_from_numpy,
    tr_state_to_numpy,
)

__all__ = [
    "ProbabilityModel",
    "LogisticRegressionMAP",
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
    "dfp_update",
    "sr1_update",
    "initial_inv_hessian",
    "optimize",
    "optimize_from_state",
    "optimize_lbfgs",
    "optimize_lbfgs_from_state",
    "optimize_lbfgs_batched",
    "optimize_lbfgs_batched_fused_from_state",
    "LBFGSResult",
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
    "trace_objective",
    "OptimizeResult",
    "MAX_ITERATIONS_DEFAULT",
    "STALL_LIMIT_DEFAULT",
    "BFGSState",
    "Status",
    "init_bfgs_state",
    "LBFGSState",
    "init_lbfgs_state",
    "lbfgs_state_from_numpy",
    "lbfgs_state_to_numpy",
    "bfgs_state_from_numpy",
    "bfgs_state_to_numpy",
    "cg_state_from_numpy",
    "cg_state_to_numpy",
    "transforms",
    "TransformedModel",
    "transform_objective",
    "LMState",
    "LeastSquaresResult",
    "least_squares",
    "least_squares_from_state",
    "lm_state_from_numpy",
    "lm_state_to_numpy",
    "TRState",
    "TRResult",
    "optimize_tr",
    "optimize_tr_from_state",
    "tr_state_from_numpy",
    "tr_state_to_numpy",
    "AugLagResult",
    "optimize_auglag",
    "minimize",
]
