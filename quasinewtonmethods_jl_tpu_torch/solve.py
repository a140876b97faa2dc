"""Solve result and driver defaults — the part of
``quasinewtonmethods_jl_tpu/solve.py`` the fleet engine needs. The scalar
driver (`optimize`, `optimize_from_state`) comes in a later slice."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .state import BFGSState, Status

__all__ = ["OptimizeResult", "MAX_ITERATIONS_DEFAULT", "STALL_LIMIT_DEFAULT"]

# The reference hardcodes N = 10_000 outer iterations (:250).
MAX_ITERATIONS_DEFAULT = 10_000

# Stall detector: a monotone ascent method that fails to strictly increase
# the objective for this many consecutive iterations is grinding below
# floating-point resolution; exit in-band (LINESEARCH_FAILURE) instead of
# crawling to the iteration cap. stall_limit=0 disables it.
STALL_LIMIT_DEFAULT = 50


class OptimizeResult(NamedTuple):
    """Solve result. ``fun`` keeps the reference's in-band contract: the
    maximized log-density on convergence, NaN otherwise. ``last_value`` is
    the final objective value regardless of status."""

    x: torch.Tensor  # final iterate (reference `optimum`, :149)
    fun: torch.Tensor  # converged value or NaN (reference return, :261/:291)
    grad: torch.Tensor  # last evaluated gradient (reference `gradient`, :150)
    status: torch.Tensor  # int32 Status code
    iterations: torch.Tensor  # int32 outer iterations executed
    n_fev: torch.Tensor  # int32 objective evaluations
    n_gev: torch.Tensor  # int32 gradient evaluations
    n_resets: torch.Tensor  # int32 steepest-ascent restarts
    last_value: torch.Tensor  # final objective value (even on failure)
    state: BFGSState  # full solver state

    @property
    def converged(self) -> torch.Tensor:
        return self.status == Status.CONVERGED
