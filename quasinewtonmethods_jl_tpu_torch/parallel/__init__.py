"""Fleet entry point: many independent solves in one call."""

from .batch import optimize_batched

__all__ = ["optimize_batched"]
