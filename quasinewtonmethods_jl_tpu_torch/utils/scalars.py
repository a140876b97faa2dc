"""NaN-aware scalar helpers and precision constants.

PyTorch port of ``quasinewtonmethods_jl_tpu/utils/scalars.py`` (reference:
src/QuasiNewtonMethods.jl:152-155). `nanmin` / `nanmax` prefer the non-NaN
argument so the line search's step clamping always yields a usable step
size; `sqrt_tolerance` is the degenerate-cubic detection threshold
(2**(-significand_bits/2)). Everything is branchless (`torch.where`), so
the helpers work elementwise on per-lane tensors.
"""

from __future__ import annotations

import torch

__all__ = [
    "nanmin",
    "nanmax",
    "significand_bits",
    "sqrt_tolerance",
    "finite_halving_limit",
]


def nanmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min(a, b), preferring the non-NaN argument.

    Semantics match the reference (src/QuasiNewtonMethods.jl:152):
    ``a < b ? a : (isnan(b) ? a : b)``.
    """
    return torch.where(a < b, a, torch.where(torch.isnan(b), a, b))


def nanmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max(a, b), preferring the non-NaN argument.

    Semantics match the reference (src/QuasiNewtonMethods.jl:153):
    ``a < b ? b : (isnan(a) ? b : a)``.
    """
    return torch.where(a < b, b, torch.where(torch.isnan(a), b, a))


_SIGNIFICAND_BITS = {
    torch.float64: 52,
    torch.float32: 23,
    torch.float16: 10,
    torch.bfloat16: 7,
}


def significand_bits(dtype: torch.dtype) -> int:
    """Number of explicit mantissa bits of a torch float dtype (Julia's
    ``Base.Math.significand_bits``, reference :155, :179)."""
    return _SIGNIFICAND_BITS[dtype]


def sqrt_tolerance(dtype: torch.dtype) -> float:
    """``2 ** -(significand_bits // 2)`` — ≈1.49e-8 for f64, ≈4.9e-4 for f32
    (reference :155)."""
    return float(1.0 / (1 << (significand_bits(dtype) >> 1)))


def finite_halving_limit(dtype: torch.dtype) -> int:
    """Max number of step-halvings while searching for a finite objective
    (reference :179-184: ``significand_bits(T)`` — 52 for f64)."""
    return significand_bits(dtype)
