"""Fleet entry points: many independent solves in one call."""

from .batch import optimize_batched, optimize_lbfgs_batched

__all__ = ["optimize_batched", "optimize_lbfgs_batched"]
