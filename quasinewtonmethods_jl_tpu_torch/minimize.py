"""Minimization-convention adapter — the PyTorch port of
``quasinewtonmethods_jl_tpu/minimize.py`` (`minimize`).

The library maximizes log-densities; users arriving from scipy.optimize
expect ``minimize(fun, x0)``. This shim negates the objective (and an
analytic value_and_grad), runs the engines unchanged, and flips ``fun``,
``last_value`` and ``grad`` back on the way out. It adds no host read of
its own.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from .cg_solve import optimize_cg
from .constrained import optimize_auglag
from .lbfgs_solve import optimize_lbfgs
from .ops.linesearch import BackTracking
from .parallel.batch import optimize_batched, optimize_lbfgs_batched
from .solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT, optimize
from .trust_region import optimize_tr
from .utils.device import as_device_tensor

__all__ = ["minimize"]


class _Negated:
    """x ↦ −fun(x). (JAX's wrapper also hashes by ``fun`` for its jit
    cache; the port compiles nothing, so it does not.)"""

    __slots__ = ("fun",)

    def __init__(self, fun: Callable):
        self.fun = fun

    def __call__(self, x):
        return -self.fun(x)


class _NegatedVag(_Negated):
    """Negation of an analytic value-and-grad callable."""

    def __call__(self, x):
        v, g = self.fun(x)
        return -v, pytree.tree_map(torch.neg, g)


def _flip_signs(res):
    """fun/last_value/grad back to the minimization convention; the state
    keeps the internal (maximization) convention so it resumes through the
    ``*_from_state`` entry points unchanged."""
    return res._replace(fun=-res.fun, last_value=-res.last_value, grad=-res.grad)


def minimize(
    fun: Callable,
    x0,
    *,
    method: str = "bfgs",
    history: int = 10,
    ls: Optional[BackTracking] = None,
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    h0_scale: bool = True,
    stall_limit: int = STALL_LIMIT_DEFAULT,
    eq: Optional[Callable] = None,
    ineq: Optional[Callable] = None,
    ctol: float = 1e-8,
    **kwargs,
):
    """Minimize ``fun``, the scipy-convention entry point.

    ``method``: 'bfgs', 'lbfgs' (``history`` applies), 'tr' (trust-region
    Newton–Krylov; ``bounds=``/``max_cg=``/``cg_tol=`` pass through
    kwargs, ``ls`` does not apply) or 'cg' (the β formula rides
    ``cg_method=``). ``ls=None`` resolves to each engine's default
    (BackTracking() for bfgs/lbfgs, Wolfe(approx=True) for cg and the
    constrained route); an explicit ``ls`` passes through. A rank-1 x0 runs
    one solve, a rank-2 (batch, n) x0 the fleet engine (`optimize_batched`
    / `optimize_lbfgs_batched`; ``kernel=`` and the like pass through
    kwargs). A tensor's device is where the solve runs; anything else goes
    to the CUDA card.

    ``eq``/``ineq`` (feasible set eq(x) = 0, ineq(x) >= 0) route through
    `optimize_auglag` with ``method`` as the inner engine, ``ctol`` the
    feasibility tolerance and the auglag knobs through kwargs; ``lam``/``mu``
    of the result are the multipliers of the minimization Lagrangian
    L = fun + λᵀ·eq − μᵀ·ineq and need no flip.

    Returns the engine's result type with ``fun``, ``last_value`` and
    ``grad`` in the minimization convention; ``res.state`` stays in the
    maximization convention.
    """
    obj = _Negated(fun)
    vag = _NegatedVag(value_and_grad_fn) if value_and_grad_fn else None
    x0 = as_device_tensor(x0, "x0")
    batched = x0.ndim == 2

    if eq is not None or ineq is not None:
        if method not in ("bfgs", "lbfgs", "cg", "tr"):
            raise ValueError(
                f"constrained minimize needs method in 'bfgs'/'lbfgs'/'cg'/'tr', got {method!r}"
            )
        # these knobs have no auglag counterpart: loud, not silent
        if h0_scale is not True:
            raise ValueError(
                "h0_scale does not apply to the constrained route "
                "(optimize_auglag's inner engines keep their defaults)"
            )
        if stall_limit != STALL_LIMIT_DEFAULT:
            raise ValueError(
                "stall_limit does not apply to the constrained route "
                "(optimize_auglag's inner engines keep their defaults)"
            )
        res = optimize_auglag(
            obj, x0, eq=eq, ineq=ineq, engine=method, tol=tol, ctol=ctol,
            max_iterations=max_iterations, lam0=kwargs.pop("lam0", None),
            mu0=kwargs.pop("mu0", None), ls=ls, history=history, value_and_grad_fn=vag, **kwargs,
        )
        # lam/mu/viol/eq/ineq are convention-invariant
        return _flip_signs(res)

    ls_bt = BackTracking() if ls is None else ls
    if method == "bfgs":
        if batched:
            res = optimize_batched(obj, x0, ls=ls_bt, tol=tol, max_iterations=max_iterations,
                                   value_and_grad_fn=vag, stall_limit=stall_limit, **kwargs)
        else:
            res = optimize(obj, x0, ls=ls_bt, tol=tol, max_iterations=max_iterations,
                           value_and_grad_fn=vag, h0_scale=h0_scale, stall_limit=stall_limit,
                           **kwargs)
    elif method == "lbfgs":
        lbfgs = optimize_lbfgs_batched if batched else optimize_lbfgs
        res = lbfgs(obj, x0, history=history, ls=ls_bt, tol=tol, max_iterations=max_iterations,
                    value_and_grad_fn=vag, stall_limit=stall_limit, **kwargs)
    elif method == "tr":
        if ls is not None:
            raise ValueError("ls does not apply to method='tr' (trust region has no line search)")
        res = optimize_tr(obj, x0, tol=tol, max_iterations=max_iterations, value_and_grad_fn=vag,
                          **kwargs)
    elif method == "cg":
        # ls=None → the engine's own Wolfe(approx=True); `method` names the
        # engine here, so the β formula rides `cg_method`
        if ls is not None:
            kwargs = {"ls": ls, **kwargs}
        if "cg_method" in kwargs:
            kwargs["method"] = kwargs.pop("cg_method")
        res = optimize_cg(obj, x0, tol=tol, max_iterations=max_iterations, value_and_grad_fn=vag,
                          stall_limit=stall_limit, **kwargs)
    else:
        raise ValueError(f"method must be 'bfgs', 'lbfgs', 'tr', or 'cg', got {method!r}")
    return _flip_signs(res)
