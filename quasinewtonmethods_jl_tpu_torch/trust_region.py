"""Trust-region helpers — the part of ``quasinewtonmethods_jl_tpu/
trust_region.py`` the CG engine needs. The trust-region engine itself is
not ported yet (ROADMAP.md A.7)."""

from __future__ import annotations

import torch

__all__ = ["_resolve_precondition"]


def _resolve_precondition(precondition, n: int):
    """(mode, diag) from the public ``precondition=`` knob.

    None → plain CG ("none"); 'jacobi' → a per-iteration Hutchinson
    diagonal; an array or tensor → a fixed positive diagonal ("fixed"),
    broadcastable to (n,) or the fleet's (B, n). Validated eagerly (the
    port has no tracers); the diagonal keeps its device."""
    if precondition is None:
        return "none", None
    if isinstance(precondition, str):
        if precondition != "jacobi":
            raise ValueError(
                "precondition must be None, 'jacobi', or a positive "
                f"diagonal array, got {precondition!r}"
            )
        return "jacobi", None
    diag = torch.as_tensor(precondition)
    if diag.ndim == 0 or diag.shape[-1] != n:
        raise ValueError(
            f"precondition diagonal last axis must be n={n}, got shape {tuple(diag.shape)}"
        )
    if not bool(torch.all(torch.isfinite(diag) & (diag > 0))):
        raise ValueError("precondition diagonal must be finite and > 0")
    return "fixed", diag
