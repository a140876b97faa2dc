"""Fleet entry point — the PyTorch port of
``quasinewtonmethods_jl_tpu/parallel/batch.py`` (`optimize_batched`).

The reference runs many simultaneous solves as per-thread states carved
from one buffer (src/QuasiNewtonMethods.jl:117-121, the multi-chain HMC
initialisation of README.md:14). Here a fleet is one (batch, n) tensor
solved in lockstep by the fused engine (batched_solve.py). The JAX
package's second engine, ``backend='vmap'`` (vmap of the scalar solver),
comes once the scalar `optimize` is ported.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..batched_solve import optimize_batched_fused
from ..ops.linesearch import BackTracking
from ..ops.wolfe import Wolfe
from ..solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT, OptimizeResult

__all__ = ["optimize_batched"]


def optimize_batched(
    obj,
    x0s: torch.Tensor,
    ls: Union[BackTracking, Wolfe] = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    backend: str = "auto",
    kernel: str = "auto",
    stall_limit: int = STALL_LIMIT_DEFAULT,
    fold_eval: bool = False,
) -> OptimizeResult:
    """Run ``x0s.shape[0]`` independent BFGS solves in one call.

    Args:
      obj: logdensity callable or ProbabilityModel (shared across the batch —
        the HMC-chain-init pattern: one model, many starting points).
      x0s: (batch, n) starting points. A tensor's device is where the solve
        runs; anything else (numpy, lists) goes to the CUDA card
        (`as_device_tensor`). Every result field gains the leading batch
        axis; check ``result.status`` per lane.
      ls: `BackTracking` or `Wolfe`.
      backend: 'fused' (the lockstep fleet engine) or 'auto' (= 'fused').
        'vmap' is not ported yet.
      kernel: the fused update — 'cuda' (B1, or B2 where B1 does not fit),
        'torch' or 'auto' (see `optimize_batched_fused`).

    Returns:
      OptimizeResult with a leading batch axis on every leaf.
    """
    if backend == "auto":
        backend = "fused"
    if backend == "vmap":
        raise NotImplementedError(
            "backend='vmap' (vmap of the scalar solver) is not ported yet: it "
            "comes with solve.optimize; use backend='fused'"
        )
    if backend != "fused":
        raise ValueError(f"unknown backend {backend!r}; use 'auto', 'fused' or 'vmap'")
    return optimize_batched_fused(
        obj, x0s, ls, tol, max_iterations, value_and_grad_fn, kernel=kernel,
        stall_limit=stall_limit, fold_eval=fold_eval,
    )
