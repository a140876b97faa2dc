"""Numerics: line searches, the Broyden-family and L-BFGS updates, and the
hand-written CUDA kernels."""

from .bfgs import bfgs_update, bfgs_update_reference, dfp_update, initial_inv_hessian, sr1_update
from .lbfgs import lbfgs_direction, lbfgs_push
from .lbfgs_compact import lbfgs_direction_compact
from .linesearch import BackTracking, LineSearchResult, backtracking_linesearch
from .wolfe import Wolfe, WolfeResult, wolfe_linesearch

__all__ = [
    "bfgs_update",
    "bfgs_update_reference",
    "dfp_update",
    "sr1_update",
    "initial_inv_hessian",
    "lbfgs_direction",
    "lbfgs_push",
    "lbfgs_direction_compact",
    "BackTracking",
    "LineSearchResult",
    "backtracking_linesearch",
    "Wolfe",
    "WolfeResult",
    "wolfe_linesearch",
]
