"""Utilities: NaN-aware scalars and precision constants."""

from .scalars import (
    finite_halving_limit,
    nanmax,
    nanmin,
    significand_bits,
    sqrt_tolerance,
)

__all__ = [
    "finite_halving_limit",
    "nanmax",
    "nanmin",
    "significand_bits",
    "sqrt_tolerance",
]
