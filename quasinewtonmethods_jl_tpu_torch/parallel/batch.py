"""Fleet entry points — the PyTorch port of
``quasinewtonmethods_jl_tpu/parallel/batch.py`` (`optimize_batched`,
`optimize_lbfgs_batched`).

The reference runs many simultaneous solves as per-thread states carved
from one buffer (src/QuasiNewtonMethods.jl:117-121, the multi-chain HMC
initialisation of README.md:14). Here a fleet is one (batch, n) tensor
solved in lockstep by a fused engine (batched_solve.py for BFGS,
lbfgs_batched_solve.py for L-BFGS), the throughput path.

``backend="vmap"`` is the equivalence oracle, not a throughput path. JAX
maps its scalar driver with ``jax.vmap``, where a finished lane stays
frozen while the others run. ``torch.func.vmap`` cannot run a loop whose
trip count depends on the data, so the port runs the scalar driver
(`optimize` / `optimize_lbfgs`) lane by lane and stacks the results, which
gives the same per-lane semantics.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..batched_solve import optimize_batched_fused
from ..lbfgs_batched_solve import optimize_lbfgs_batched_fused
from ..lbfgs_solve import LBFGSResult, optimize_lbfgs
from ..lbfgs_solve import _result_from_state as _lbfgs_result
from ..ops.linesearch import BackTracking
from ..ops.wolfe import Wolfe
from ..solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT, OptimizeResult, optimize
from ..solve import _result_from_state as _bfgs_result
from ..state import init_bfgs_state, init_lbfgs_state
from ..utils.device import as_device_tensor

__all__ = ["optimize_batched", "optimize_lbfgs_batched"]


def _fleet(x0s) -> torch.Tensor:
    x0s = as_device_tensor(x0s)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (batch, n), got shape {tuple(x0s.shape)}")
    return x0s


def _stack(results, empty):
    """``results`` (NamedTuples whose last field is a state NamedTuple)
    stacked leaf by leaf along a new leading axis; with no results, every
    leaf of ``empty()`` (a fresh lane's result) with a leading axis of 0."""
    if not results:
        fresh = empty()
        return type(fresh)(*(leaf.new_empty((0, *leaf.shape)) for leaf in fresh[:-1]),
                           type(fresh.state)(*(leaf.new_empty((0, *leaf.shape))
                                               for leaf in fresh.state)))
    state_cls = type(results[0].state)
    state = state_cls(*(torch.stack(leaves) for leaves in zip(*(r.state for r in results))))
    return type(results[0])(*(torch.stack(leaves) for leaves in zip(*(r[:-1] for r in results))),
                            state=state)


def _lane_by_lane(solve, x0s, fresh_result):
    """``solve`` on each lane of ``x0s``, every leaf stacked along a new
    leading batch axis (the state's too). A fleet of no lanes gives empty
    leaves shaped like ``fresh_result(x0)``'s, as JAX's vmap does."""
    return _stack([solve(x0) for x0 in x0s], lambda: fresh_result(x0s.new_zeros(x0s.shape[1])))


def optimize_batched(
    obj,
    x0s,
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
      backend: 'fused' (the lockstep fleet engine), 'vmap' (the scalar
        `optimize` lane by lane: the equivalence oracle, see the module
        docstring) or 'auto' (= 'fused' on every device).
      kernel: the fused update — 'cuda' (B1, or B2 where B1 does not fit),
        'torch' or 'auto' (see `optimize_batched_fused`); unused by 'vmap'.
      fold_eval: a fused-engine option (see `optimize_batched_fused`).

    Returns:
      OptimizeResult with a leading batch axis on every leaf.
    """
    x0s = _fleet(x0s)
    if backend == "auto":
        backend = "fused"
    if backend == "fused":
        return optimize_batched_fused(
            obj, x0s, ls, tol, max_iterations, value_and_grad_fn, kernel=kernel,
            stall_limit=stall_limit, fold_eval=fold_eval,
        )
    if backend != "vmap":
        raise ValueError(f"unknown backend {backend!r}; use 'auto', 'fused' or 'vmap'")
    if fold_eval:
        raise ValueError("fold_eval is a fused-engine option; use backend='fused'")
    return _lane_by_lane(
        lambda x0: optimize(obj, x0, ls, tol, max_iterations, value_and_grad_fn,
                            stall_limit=stall_limit),
        x0s, lambda x0: _bfgs_result(init_bfgs_state(x0)))


def optimize_lbfgs_batched(
    obj,
    x0s,
    history: int = 10,
    ls: Union[BackTracking, Wolfe] = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    direction_method: str = "compact",
    backend: str = "fused",
    stall_limit: int = STALL_LIMIT_DEFAULT,
) -> LBFGSResult:
    """Batched L-BFGS fleet: many independent large-n solves in one call
    (O(batch·m·n) memory).

    ``backend='fused'`` (default) is the masked-lockstep engine
    (lbfgs_batched_solve.py), whose direction is always the compact form. ``backend='vmap'`` runs the
    scalar `optimize_lbfgs` lane by lane (the equivalence oracle, see the
    module docstring) and honours ``direction_method``. Returns an
    `LBFGSResult` with a leading batch axis on every leaf."""
    x0s = _fleet(x0s)
    if backend == "fused":
        return optimize_lbfgs_batched_fused(obj, x0s, history, ls, tol, max_iterations,
                                            value_and_grad_fn, stall_limit)
    if backend != "vmap":
        raise ValueError(f"unknown backend {backend!r}; use 'fused' or 'vmap'")
    return _lane_by_lane(
        lambda x0: optimize_lbfgs(obj, x0, history, ls, tol, max_iterations, value_and_grad_fn,
                                  direction_method, stall_limit),
        x0s, lambda x0: _lbfgs_result(init_lbfgs_state(x0, history)))
