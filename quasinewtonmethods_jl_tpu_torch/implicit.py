"""Implicit differentiation through the solver (MAP sensitivities) — the
PyTorch port of ``quasinewtonmethods_jl_tpu/implicit.py``.

Gradients of the converged mode x*(params), and of the maximized
log-density, with respect to model hyperparameters, by the implicit
function theorem rather than by differentiating through the solver's
iterations. At the mode ∇ₓ f(x*, p) = 0, so

    dx*/dp = −Hₓₓ⁻¹ Hₓₚ            (IFT)
    df*/dp = ∂f/∂p |_(x*, p)       (envelope theorem)

The backward pass solves −Hₓₓ u = gₓ by matrix-free conjugate gradients
(−Hₓₓ is positive definite at a maximum; Hessian-vector products by
forward-over-reverse ``torch.func``), then takes one VJP of ∇ₓf in p.
JAX's ``jax.custom_vjp`` becomes a ``torch.autograd.Function``; ``params``
may be a tensor or a pytree of tensors, whose leaves are passed to it one
by one. JAX's jit cache has no counterpart: nothing is compiled.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from .api import _pin_matmul_precision
from .lbfgs_solve import optimize_lbfgs
from .ops.linesearch import BackTracking
from .solve import MAX_ITERATIONS_DEFAULT, optimize
from .utils.device import as_device_tensor

__all__ = ["ImplicitOptions", "optimize_implicit"]


@dataclasses.dataclass(frozen=True)
class ImplicitOptions:
    """Solve and backward-pass configuration."""

    method: str = "bfgs"  # 'bfgs' | 'lbfgs'
    ls: BackTracking = BackTracking()
    tol: float = 1e-8
    max_iterations: int = MAX_ITERATIONS_DEFAULT
    history: int = 10  # lbfgs only
    h0_scale: bool = True
    cg_tol: float = 1e-10
    cg_maxiter: Optional[int] = None


def _forward(obj, x0, params, opts: ImplicitOptions):
    f = lambda x: obj(x, params)  # noqa: E731
    if opts.method == "lbfgs":
        res = optimize_lbfgs(f, x0, history=opts.history, ls=opts.ls, tol=opts.tol,
                             max_iterations=opts.max_iterations)
    elif opts.method == "bfgs":
        res = optimize(f, x0, ls=opts.ls, tol=opts.tol, max_iterations=opts.max_iterations,
                       h0_scale=opts.h0_scale)
    else:
        raise ValueError(f"unknown method {opts.method!r}")
    return res.x, res.fun


def _cg(matvec, b, tol: float, maxiter: Optional[int]):
    """Conjugate gradients on ``matvec`` u = b with the rules of
    ``jax.scipy.sparse.linalg.cg``: start at 0, stop once ‖r‖₂² <=
    max(tol²·‖b‖₂², 0) or after ``maxiter`` (default 10·size) iterations.
    The loop reads ‖r‖² on the host once per iteration."""
    if maxiter is None:
        maxiter = 10 * b.numel()
    atol2 = max(tol * tol * float(torch.dot(b, b)), 0.0)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r
    gamma = torch.dot(r, r)
    k = 0
    while float(gamma) > atol2 and k < maxiter:
        Ap = matvec(p)
        alpha = gamma / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = torch.dot(r, r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x


class _SolveImplicit(torch.autograd.Function):
    """(x*, f*) of the solve, with the implicit-function backward."""

    @staticmethod
    def forward(ctx, obj, opts, spec, x0, *leaves):
        params = pytree.tree_unflatten(list(leaves), spec)
        with torch.no_grad():
            x_star, fun = _forward(obj, x0, params, opts)
        ctx.obj, ctx.opts, ctx.spec = obj, opts, spec
        ctx.save_for_backward(x_star, x0, *leaves)
        return x_star, fun

    @staticmethod
    def backward(ctx, gx, gfun):
        x_star, x0, *leaves = ctx.saved_tensors
        obj, opts, spec = _pin_matmul_precision(ctx.obj), ctx.opts, ctx.spec
        params = pytree.tree_unflatten(leaves, spec)
        grad_x = torch.func.grad(obj, argnums=0)

        def neg_hxx_mv(v):
            # forward-over-reverse HVP with the true Hessian at the mode
            return -torch.func.jvp(lambda x: grad_x(x, params), (x_star,), (v,))[1]

        # −Hxx is PD at a maximum: CG applies. u solves −Hxx u = gx, so the
        # x cotangent contributes uᵀ Hxp
        u = _cg(neg_hxx_mv, gx, opts.cg_tol, opts.cg_maxiter)
        _, vjp_p = torch.func.vjp(lambda p: grad_x(x_star, p), params)
        dp_from_x = vjp_p(u)[0]
        # envelope theorem for the value output (∇ₓf(x*) = 0)
        dfdp = torch.func.grad(lambda p: obj(x_star, p))(params)
        dp = pytree.tree_map(lambda a, b: a + gfun.to(x_star.dtype) * b, dp_from_x, dfdp)
        # x* does not depend on the start (to solver tolerance)
        return (None, None, None, torch.zeros_like(x0), *pytree.tree_leaves(dp))


def optimize_implicit(
    obj: Callable,
    x0,
    params,
    opts: ImplicitOptions = ImplicitOptions(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiably maximize ``obj(x, params)`` over x.

    Returns ``(x_star, fun)``; both are differentiable in ``params`` (a
    tensor or a pytree of tensors) by the implicit function theorem.
    ``obj`` must be a pure function of (x, params) that ``torch.func`` can
    differentiate; the gradient with respect to ``x0`` is zero (the mode
    does not depend on the start). ``x0`` and the leaves of ``params``
    follow the entry points' device rule (`as_device_tensor`).

    On failure the forward pass carries the usual in-band NaN ``fun``; the
    backward pass is meaningful only at a converged interior maximum.
    """
    x0 = as_device_tensor(x0, "x0")
    leaves, spec = pytree.tree_flatten(params)
    leaves = [as_device_tensor(leaf, "params") for leaf in leaves]
    return _SolveImplicit.apply(obj, opts, spec, x0, *leaves)
