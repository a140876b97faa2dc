"""Utilities: NaN-aware scalars, precision constants, checkpoints and
profiling."""

from .profiling import practically_converged, solve_stats, summarize_trace, trace
from .scalars import (
    finite_halving_limit,
    nanmax,
    nanmin,
    significand_bits,
    sqrt_tolerance,
)

__all__ = [
    "finite_halving_limit",
    "load_state",
    "nanmax",
    "nanmin",
    "practically_converged",
    "save_state",
    "significand_bits",
    "solve_stats",
    "sqrt_tolerance",
    "summarize_trace",
    "trace",
]


def __getattr__(name):
    # checkpoint.py imports every state class, and the solver modules import
    # this package for its scalars: it loads when its names are first asked for
    if name in ("load_state", "save_state"):
        from . import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
