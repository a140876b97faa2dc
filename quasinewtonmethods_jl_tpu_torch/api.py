"""User-facing objective protocol — the PyTorch port of
``quasinewtonmethods_jl_tpu/api.py``.

The user supplies a log-density ``logdensity(theta) -> scalar`` on one
lane's (n,) tensor; the library derives the gradient with
``torch.func.grad_and_value`` (the analog of the reference's
``∂logdensity!``, src/QuasiNewtonMethods.jl:8-9), or takes an analytic
``value_and_grad_fn`` given explicitly. Plain callables and
`ProbabilityModel` objects are accepted everywhere an objective is.
Objectives are log-densities to be *maximized*.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

__all__ = ["ProbabilityModel", "as_value_and_grad", "as_logdensity", "as_value_fn"]


def _pin_matmul_precision(fn):
    """Run the objective with float32 matmuls and convolutions in full
    float32.

    On Hopper a float32 product may go through the tensor cores in TF32,
    which keeps about three decimal digits — the part bf16 plays on the TPU
    (see the JAX package's `_pin_matmul_precision`). That gradient noise
    would make the max|∇| < tol certificate measure rounding, so both TF32
    switches are off while the objective runs and restored afterwards."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        matmul = torch.backends.cuda.matmul.allow_tf32
        cudnn = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn

    return wrapped


def _value_and_grad(f: Callable) -> Callable:
    """``theta -> (f(theta), ∇f(theta))`` through ``torch.func``."""
    grad_and_value = torch.func.grad_and_value(f)

    def vag(theta):
        grad, value = grad_and_value(theta)
        return value, grad

    return vag


class ProbabilityModel:
    """Dimension-tagged log-density model.

    Mirror of ``AbstractProbabilityModel{D}`` (src/QuasiNewtonMethods.jl:14-19):
    ``dimension``/``__len__`` report D and ``repr`` matches the reference's
    show method. Subclasses implement ``logdensity(theta) -> scalar`` and
    may override ``logdensity_and_gradient`` with an analytic gradient; the
    default derives it with ``torch.func.grad_and_value``.
    """

    def __init__(self, dimension: int):
        self._dimension = int(dimension)

    @property
    def dimension(self) -> int:
        return self._dimension

    def __len__(self) -> int:
        return self._dimension

    def __repr__(self) -> str:  # reference :17-18
        return f"{self._dimension}-dimensional Probability Model"

    def logdensity(self, theta: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} must implement logdensity(theta)"
        )

    def logdensity_and_gradient(
        self, theta: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Analog of ∂logdensity!: returns (value, gradient)."""
        return _value_and_grad(self.logdensity)(theta)


def as_logdensity(obj) -> Callable[[torch.Tensor], torch.Tensor]:
    """Normalize a callable or ProbabilityModel into ``f(theta) -> scalar``
    (run with TF32 off — see `_pin_matmul_precision`)."""
    if isinstance(obj, ProbabilityModel) or hasattr(obj, "logdensity"):
        return _pin_matmul_precision(obj.logdensity)
    if callable(obj):
        return _pin_matmul_precision(obj)
    raise TypeError(
        f"objective must be callable or define .logdensity, got {type(obj)!r}"
    )


def as_value_fn(obj, value_and_grad_fn: Optional[Callable] = None):
    """Value-only objective for line-search trials (the reference's `step!`
    path, src/QuasiNewtonMethods.jl:157-162, calls `logdensity`, not
    ∂logdensity!): the plain logdensity when there is one, else the value
    half of an explicit value_and_grad_fn."""
    if isinstance(obj, ProbabilityModel) or hasattr(obj, "logdensity") or callable(obj):
        return as_logdensity(obj)
    if value_and_grad_fn is not None:
        return _pin_matmul_precision(lambda theta: value_and_grad_fn(theta)[0])
    raise TypeError(
        f"objective must be callable or define .logdensity, got {type(obj)!r}"
    )


def as_value_and_grad(
    obj, value_and_grad_fn: Optional[Callable] = None
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Normalize into ``f(theta) -> (value, gradient)``.

    Resolution order: explicit value_and_grad_fn > the object's own
    logdensity_and_gradient (analytic-override hook) >
    ``torch.func.grad_and_value`` of the logdensity.
    """
    if value_and_grad_fn is not None:
        return _pin_matmul_precision(value_and_grad_fn)
    if hasattr(obj, "logdensity_and_gradient"):
        return _pin_matmul_precision(obj.logdensity_and_gradient)
    return _value_and_grad(as_logdensity(obj))
