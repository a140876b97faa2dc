"""Multi-start MAP: a fleet of solves from many starts, the best mode
selected — the PyTorch port of ``quasinewtonmethods_jl_tpu/multistart.py``.

The fleet engine's companion for multimodal or poorly initialised
problems: solve from random (or given) starts in one call and keep the
best converged mode, the workflow callers hand-roll around the reference
(README.md:14: many chains, one mode finder).

JAX draws the starts from a ``jax.random`` key, whose stream torch cannot
reproduce; the port takes a ``torch.Generator`` (or an int seed) in its
place, so a fleet compared with JAX's passes ``x0s``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from .cg_solve import optimize_cg
from .constrained import optimize_auglag
from .ops.linesearch import BackTracking
from .ops.wolfe import Wolfe
from .parallel.batch import optimize_batched
from .solve import MAX_ITERATIONS_DEFAULT, OptimizeResult
from .state import Status
from .trust_region import optimize_tr
from .utils.device import as_device_tensor

__all__ = ["MultistartResult", "optimize_multistart"]


class MultistartResult(NamedTuple):
    x: torch.Tensor  # (n,) best converged iterate
    fun: torch.Tensor  # () its log-density (NaN if no start converged)
    best_index: torch.Tensor  # () int32 index into the fleet
    n_converged: torch.Tensor  # () int32
    fleet: OptimizeResult  # the engine's whole result (leading batch axis)

    @property
    def converged(self) -> torch.Tensor:
        return self.n_converged > 0


def _draw_starts(generator, n_starts, dim, init_scale, dtype) -> torch.Tensor:
    """N(0, init_scale²) starts from ``generator``: a torch.Generator, on
    whose device they are drawn, or an int seed for a new generator on the
    CUDA card (the entry points' rule for input that is not a tensor)."""
    if generator is None:
        raise ValueError("pass generator= (a torch.Generator or an int seed) or x0s=")
    if not isinstance(generator, torch.Generator):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "an int seed draws the starts on the CUDA card, and torch.cuda.is_available() "
                "is False; pass a CPU torch.Generator to draw them on the CPU")
        generator = torch.Generator(device="cuda").manual_seed(int(generator))
    device = generator.device
    if dtype is None:
        # the JAX package's rule with the card in the TPU's place
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    return init_scale * torch.randn((n_starts, dim), generator=generator, device=device,
                                    dtype=dtype)


def _best(fleet, score_field: str) -> MultistartResult:
    ok = fleet.status == int(Status.CONVERGED)
    value = getattr(fleet, score_field)
    # argmax over a -inf-masked copy: the first maximum wins, as in jnp.argmax
    score = torch.where(ok, value, torch.full_like(value, -float("inf")))
    best = torch.argmax(score).reshape(1)
    n_conv = ok.sum().to(torch.int32)
    return MultistartResult(
        x=fleet.x.index_select(0, best)[0],
        fun=torch.where(n_conv > 0, value.index_select(0, best)[0],
                        torch.full((), float("nan"), dtype=value.dtype, device=value.device)),
        best_index=best[0].to(torch.int32),
        n_converged=n_conv,
        fleet=fleet,
    )


def optimize_multistart(
    obj,
    generator: Union[torch.Generator, int, None],
    n_starts: int,
    dim: int,
    init_scale: float = 1.0,
    x0s=None,
    ls: Optional[BackTracking] = None,
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    dtype=None,
    engine: str = "bfgs",
    eq: Optional[Callable] = None,
    ineq: Optional[Callable] = None,
    **batch_kwargs,
) -> MultistartResult:
    """Maximize from ``n_starts`` starting points; return the best mode.

    Starts are ``init_scale * torch.randn((n_starts, dim), generator=...)``
    unless ``x0s`` ((n_starts, dim); a tensor keeps its device, anything
    else goes to the CUDA card) is given. ``generator``: a
    ``torch.Generator`` (the starts are drawn on its device), an int seed
    (a new generator on the CUDA card), or None with ``x0s``. ``dtype``
    defaults to float32 on the card and float64 on the CPU. Only converged
    lanes compete; with none converged the result carries NaN ``fun`` and
    ``converged`` is False (the in-band contract).

    ``engine``: 'bfgs' (the fleet engine, `optimize_batched`), 'tr' (the
    trust-region fleet; ``ls`` does not apply, ``bounds=``/``max_cg=``
    pass through ``batch_kwargs``) or 'cg' (the nonlinear-CG fleet,
    ``Wolfe(approx=True)`` unless ``ls`` is given; ``method=`` etc. pass
    through). ``ls=None`` is ``BackTracking()`` for 'bfgs'. Given ``eq`` /
    ``ineq``, the fleet runs through `optimize_auglag` with ``engine`` as
    its inner solve (auglag knobs pass through ``batch_kwargs``; ``ls=None``
    defers to auglag's default) and only KKT-certified lanes compete. The
    result's ``fleet`` is the engine's own result type.
    """
    if x0s is None:
        x0s = _draw_starts(generator, n_starts, dim, init_scale, dtype)
    else:
        x0s = as_device_tensor(x0s)

    if eq is not None or ineq is not None:
        fleet = optimize_auglag(
            obj, x0s, eq=eq, ineq=ineq, engine=engine, tol=tol,
            max_iterations=max_iterations, value_and_grad_fn=value_and_grad_fn, ls=ls,
            **batch_kwargs,
        )
        return _best(fleet, "fun")

    if engine == "bfgs":
        fleet = optimize_batched(
            obj, x0s, ls=BackTracking() if ls is None else ls, tol=tol,
            max_iterations=max_iterations, value_and_grad_fn=value_and_grad_fn, **batch_kwargs,
        )
    elif engine == "tr":
        fleet = optimize_tr(obj, x0s, tol=tol, max_iterations=max_iterations,
                            value_and_grad_fn=value_and_grad_fn, **batch_kwargs)
    elif engine == "cg":
        fleet = optimize_cg(
            obj, x0s, ls=Wolfe(approx=True) if ls is None else ls, tol=tol,
            max_iterations=max_iterations, value_and_grad_fn=value_and_grad_fn, **batch_kwargs,
        )
    else:
        raise ValueError(f"engine must be 'bfgs', 'tr', or 'cg', got {engine!r}")
    # fleet.fun is NaN off the converged lanes already; last_value scores
    return _best(fleet, "last_value")
