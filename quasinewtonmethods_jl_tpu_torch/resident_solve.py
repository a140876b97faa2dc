"""Whole-solve resident BFGS engine — one kernel launch per solve.

PyTorch port of ``quasinewtonmethods_jl_tpu/resident_solve.py``. The fleet
engine (batched_solve.py) pays Python dispatch and host reads every
iteration; this engine runs the entire solve of every lane in one launch of
the hand-written CUDA kernel B3 (``csrc/resident_solve.cu``, wrapper in
ops/kernels/resident_kernel.py), with each lane's B resident in one block's
shared memory from the first iteration to the last. The host makes one
launch and reads nothing back.

Semantics are lane for lane those of `optimize_batched_fused` with
BackTracking (the same peel, masks, statuses and counters), and that engine
with the plain update is B3's plain version
(`optimize_batched_resident_reference`), which ``kernel="torch"`` and CPU
tensors run. Floats differ from it only in the order of sums; on Rosenbrock
such a difference grows along a trajectory, so over a whole solve a lane's
counters may differ from the plain run's while the statuses and the
optimum agree (PERF.md).

Objective contract. The JAX kernel traces any jnp objective into its body,
its closed-over data hoisted into kernel inputs; a hand-written kernel
cannot trace a torch function, so B3 evaluates its objective on the card,
one instantiation per objective (csrc/resident_objectives.cuh). The port
has seven, recognised by identity or by exact type:
  * the split Rosenbrock of models/rosenbrock.py: `rosenbrock_logdensity`
    (with ``value_and_grad_fn`` None or `rosenbrock_value_and_grad`) or a
    `models.Rosenbrock` instance;
  * Neal's funnel: `models.funnel_logdensity`, with ``value_and_grad_fn``
    None;
and, with ``value_and_grad_fn`` None, an instance of
  * `models.IllConditionedQuadratic` (its ``diag`` and ``x_star``);
  * `models.LogisticRegressionMAP` (its ``X``, ``y`` and ``prior_scale``);
  * `models.PoissonRegressionMAP` (the same);
  * `models.GaussianMixture` (its ``means``, ``weights`` and ``sigmas``;
    at most 8 components);
  * `models.AR1DriftMAP` (its ``A``, ``ys``, ``obs_scale`` and
    ``prior_scale``; the hand-written counterpart of JAX's scan-bodied
    objective, whose dot rewrite this engine does not need).
A model's data go to ``x0s``'s device and dtype once per solve, for the
kernel and the plain version alike. Every other objective (a subclass of
those models too, which may evaluate something else) raises ValueError on
every device, pointing to `optimize_batched_fused`, which takes any
objective; nothing falls back to the plain version unasked.

The JAX engine's ``block_batch``, ``interpret``, ``rewrite_dots``,
`_hoist_consts` and ``ops/dot_rewrite.py`` exist only for Mosaic and have
no counterpart here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .models.funnel import funnel_logdensity
from .models.rosenbrock import Rosenbrock, rosenbrock_logdensity, rosenbrock_value_and_grad
from .ops.kernels.resident_kernel import (
    KERNEL_MODELS,
    objective_on,
    optimize_batched_resident_reference,
    resident_bfgs_solve,
    resident_feasible,
)
from .ops.linesearch import BackTracking
from .solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT, OptimizeResult
from .utils.device import as_device_tensor

__all__ = [
    "optimize_batched_resident",
    "optimize_batched_resident_reference",
    "resident_feasible",
]


def _is_rosenbrock(obj, value_and_grad_fn) -> bool:
    if value_and_grad_fn not in (None, rosenbrock_value_and_grad):
        return False
    return obj is rosenbrock_logdensity or type(obj) is Rosenbrock


def _kernel_objective(obj, value_and_grad_fn, x0s: torch.Tensor):
    """The objective B3 evaluates: None for the split Rosenbrock,
    `funnel_logdensity`, or a shallow copy of a data-bearing model with its
    data on ``x0s``'s device and dtype. Raises ValueError for any other
    objective."""
    if _is_rosenbrock(obj, value_and_grad_fn):
        return None
    if value_and_grad_fn is None and (obj is funnel_logdensity or type(obj) in KERNEL_MODELS):
        return objective_on(obj, x0s)
    raise ValueError(
        "the resident kernel evaluates its objective on the card and knows only the split "
        "Rosenbrock (rosenbrock_logdensity, with value_and_grad_fn None or "
        "rosenbrock_value_and_grad, or a models.Rosenbrock instance), "
        "models.funnel_logdensity, and instances of models.IllConditionedQuadratic, "
        "LogisticRegressionMAP, PoissonRegressionMAP, GaussianMixture and AR1DriftMAP (each "
        "with value_and_grad_fn None); use optimize_batched_fused for any other objective"
    )


def optimize_batched_resident(
    obj,
    x0s: torch.Tensor,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    h0_scale: bool = True,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    kernel: str = "auto",
) -> OptimizeResult:
    """Fleet BFGS with the entire solve in one kernel launch (see the module
    docstring); result-compatible with `optimize_batched_fused`.

    Args:
      obj: the split Rosenbrock (`rosenbrock_logdensity` or a
        `models.Rosenbrock`), `models.funnel_logdensity`, or a
        `models.IllConditionedQuadratic`, `LogisticRegressionMAP`,
        `PoissonRegressionMAP`, `GaussianMixture` (K <= 8) or
        `AR1DriftMAP`; any other objective raises ValueError.
      x0s: (batch, n) float32/float64 starting points. A tensor's device is
        where the solve runs; anything else goes to the CUDA card
        (`as_device_tensor`).
      kernel: 'cuda' (B3, CUDA tensors only; raises where one lane does not
        fit, see `resident_feasible`), 'torch' (the plain version, any
        device) or 'auto' (= 'cuda' on CUDA tensors, 'torch' on CPU).

    Returns:
      OptimizeResult with a leading batch axis on every leaf.
    """
    x0s = as_device_tensor(x0s)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (batch, n), got shape {tuple(x0s.shape)}")
    if not isinstance(ls, BackTracking):
        raise ValueError("the resident engine supports BackTracking line search only")
    if kernel not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown kernel {kernel!r}; use 'auto', 'cuda' or 'torch'")
    if kernel == "cuda" and x0s.device.type != "cuda":
        raise ValueError(f"kernel='cuda' needs CUDA tensors, got x0s on {x0s.device}")
    objective = _kernel_objective(obj, value_and_grad_fn, x0s)
    if kernel == "torch":
        return optimize_batched_resident_reference(
            x0s, ls, tol, max_iterations, h0_scale, stall_limit, objective)
    # 'auto': the wrapper launches B3 on CUDA tensors, the plain version on CPU ones
    return resident_bfgs_solve(x0s, ls, tol, max_iterations, h0_scale, stall_limit, objective)
