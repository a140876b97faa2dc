"""Numerics: line search, BFGS update, and the hand-written CUDA kernels."""

from .bfgs import bfgs_update, initial_inv_hessian
from .linesearch import BackTracking, LineSearchResult, backtracking_linesearch
from .wolfe import Wolfe, WolfeResult, wolfe_linesearch

__all__ = [
    "bfgs_update",
    "initial_inv_hessian",
    "BackTracking",
    "LineSearchResult",
    "backtracking_linesearch",
    "Wolfe",
    "WolfeResult",
    "wolfe_linesearch",
]
