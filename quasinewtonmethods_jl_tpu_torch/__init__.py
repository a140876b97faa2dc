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
scipy-convention front door `minimize`, and the MAP back end:
multistart (`optimize_multistart`), Newton polish (`polish_newton`),
Laplace evidence (`laplace_evidence`), implicit gradients through a solve
(`optimize_implicit`), checkpoints (`utils.checkpoint.save_state` /
`load_state`), structured parameters (`optimize_pytree` and its siblings,
`pytree_names`) and chain diagnostics (`diagnostics.py`), and the
samplers the MAP fleet hands over to (`chain_init_from_map`, `hmc_sample`,
`chees_sample`, `nuts_sample` and their `*_from_state`,
`nuts_sample_depth_sorted`, `LowRankMass`), the workflow's other
initializers, Pathfinder (`pathfinder`, `psis_smooth`) and SVGD
(`svgd_sample`, `svgd_sample_from_state`), PSIS-LOO / WAIC model
comparison (`loo_psis`, `waic`, `loo_compare`), evidence by sampling:
annealed importance sampling with adaptive tempered SMC (`ais_evidence`)
and bridge sampling (`bridge_evidence`), and the other three
samplers: MCLMC (`mclmc_sample`, `mclmc_sample_from_state`), the
affine-invariant ensemble (`ensemble_sample`, `ensemble_sample_from_state`,
`ensemble_autocorr_time`) and replica-exchange HMC (`pt_sample`,
`pt_sample_from_state`, `geometric_ladder`), and the one-call pipeline
that composes them (`map_then_sample`, `map_then_sample_pytree`) with the
profiling helpers (`utils.trace`, `utils.summarize_trace`), and the
device mesh over ``torch.distributed`` (`parallel.make_mesh`, the
``*_sharded`` fleets and single solves, `parallel.distributed`). Entry
points run on the CUDA card unless given a CPU tensor
(`utils.device.as_device_tensor`).

The package imports torch and numpy, never jax.
"""

from . import transforms
from .ais import AISResult, ais_evidence
from .api import ProbabilityModel, as_logdensity, as_value_and_grad, as_value_fn
from .bridge import BridgeResult, bridge_evidence
from .batched_solve import (
    optimize_batched_compacted,
    optimize_batched_fused,
    optimize_batched_fused_from_state,
)
from .cg_solve import CGResult, optimize_cg, optimize_cg_from_state
from .constrained import AugLagResult, optimize_auglag
from .ensemble import (
    EnsembleResult,
    EnsembleState,
    ensemble_autocorr_time,
    ensemble_sample,
    ensemble_sample_from_state,
)
from .diagnostics import (
    ChainDiagnostics,
    PosteriorSummary,
    diagnose_chains,
    diagnose_chains_device,
    energy_bfmi,
    energy_bfmi_device,
    ess,
    ess_device,
    posterior_summary,
    rank_normalized_rhat,
    rank_normalized_rhat_device,
    split_rhat,
    split_rhat_device,
    tail_ess,
    tail_ess_device,
)
from .implicit import ImplicitOptions, optimize_implicit
from .laplace import laplace_evidence
from .lbfgs_batched_solve import optimize_lbfgs_batched_fused_from_state
from .lbfgs_solve import LBFGSResult, optimize_lbfgs, optimize_lbfgs_from_state
from .least_squares import LeastSquaresResult, least_squares, least_squares_from_state
from .mclmc import MCLMCResult, MCLMCState, mclmc_sample, mclmc_sample_from_state
from .loo import LOOResult, WAICResult, loo_compare, loo_psis, waic
from .minimize import minimize
from .models import LogisticRegressionMAP
from .multistart import MultistartResult, optimize_multistart
from .ops.bfgs import bfgs_update, dfp_update, initial_inv_hessian, sr1_update
from .ops.linesearch import BackTracking, LineSearchResult, backtracking_linesearch
from .ops.wolfe import Wolfe, WolfeResult, wolfe_linesearch
from .parallel.batch import optimize_batched, optimize_lbfgs_batched
from .pathfinder import PathfinderResult, pathfinder, psis_smooth
from .polish import PolishResult, polish_newton
from .pytree import (
    least_squares_pytree,
    minimize_pytree,
    optimize_auglag_pytree,
    optimize_batched_pytree,
    optimize_cg_pytree,
    optimize_lbfgs_pytree,
    optimize_pytree,
    map_then_sample_pytree,
    optimize_tr_pytree,
    PytreeSampleResult,
    pytree_names,
)
from .resident_solve import optimize_batched_resident, resident_feasible, trace_objective
from .sampling import (
    ChEESResult,
    ChEESState,
    DepthSortInfo,
    HMCResult,
    HMCState,
    LowRankMass,
    NUTSResult,
    NUTSState,
    chain_init_from_map,
    chees_sample,
    chees_sample_from_state,
    hmc_sample,
    hmc_sample_from_state,
    nuts_sample,
    nuts_sample_depth_sorted,
    nuts_sample_from_state,
)
from .solve import (
    MAX_ITERATIONS_DEFAULT,
    STALL_LIMIT_DEFAULT,
    OptimizeResult,
    optimize,
    optimize_from_state,
)
from .svgd import SVGDResult, SVGDState, svgd_sample, svgd_sample_from_state
from .tempering import PTResult, PTState, geometric_ladder, pt_sample, pt_sample_from_state
from .transforms import TransformedModel, transform_objective
from .trust_region import TRResult, optimize_tr, optimize_tr_from_state
from .workflow import MapThenSampleResult, map_then_sample
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


def _resolve_version() -> str:
    """The package's version from its distribution's metadata when
    installed, else from pyproject.toml beside a source checkout (one
    version for the repo, as the JAX package resolves its own)."""
    try:
        from importlib.metadata import version

        return version("quasinewtonmethods-jl-tpu")
    except Exception:
        pass
    import pathlib
    import re

    pyproject = pathlib.Path(__file__).resolve().parent.parent / "pyproject.toml"
    try:
        m = re.search(r'^version\s*=\s*"([^"]+)"', pyproject.read_text(), re.MULTILINE)
        if m:
            return m.group(1)
    except OSError:
        pass
    return "0.0.0"


__version__ = _resolve_version()

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
    "MultistartResult",
    "optimize_multistart",
    "PolishResult",
    "polish_newton",
    "laplace_evidence",
    "AISResult",
    "ais_evidence",
    "BridgeResult",
    "bridge_evidence",
    "ImplicitOptions",
    "optimize_implicit",
    "optimize_pytree",
    "optimize_lbfgs_pytree",
    "optimize_batched_pytree",
    "optimize_cg_pytree",
    "optimize_tr_pytree",
    "least_squares_pytree",
    "optimize_auglag_pytree",
    "minimize_pytree",
    "pytree_names",
    "ChainDiagnostics",
    "split_rhat",
    "ess",
    "rank_normalized_rhat",
    "tail_ess",
    "diagnose_chains",
    "energy_bfmi",
    "PosteriorSummary",
    "posterior_summary",
    "split_rhat_device",
    "ess_device",
    "rank_normalized_rhat_device",
    "tail_ess_device",
    "diagnose_chains_device",
    "energy_bfmi_device",
    "hmc_sample",
    "hmc_sample_from_state",
    "HMCResult",
    "HMCState",
    "LowRankMass",
    "chain_init_from_map",
    "chees_sample",
    "chees_sample_from_state",
    "ChEESResult",
    "ChEESState",
    "nuts_sample",
    "nuts_sample_from_state",
    "nuts_sample_depth_sorted",
    "NUTSState",
    "NUTSResult",
    "DepthSortInfo",
    "pathfinder",
    "PathfinderResult",
    "psis_smooth",
    "svgd_sample",
    "svgd_sample_from_state",
    "SVGDResult",
    "SVGDState",
    "loo_psis",
    "loo_compare",
    "waic",
    "LOOResult",
    "WAICResult",
    "mclmc_sample",
    "mclmc_sample_from_state",
    "MCLMCResult",
    "MCLMCState",
    "ensemble_sample",
    "ensemble_sample_from_state",
    "ensemble_autocorr_time",
    "EnsembleResult",
    "EnsembleState",
    "pt_sample",
    "pt_sample_from_state",
    "geometric_ladder",
    "PTResult",
    "PTState",
    "map_then_sample",
    "MapThenSampleResult",
    "map_then_sample_pytree",
    "PytreeSampleResult",
    "__version__",
]
