"""Pytree-parameter adapters: solve over structured parameters — the
PyTorch port of ``quasinewtonmethods_jl_tpu/pytree.py``.

The engines work on flat vectors (the dense-B algebra needs one anyway);
hand-written models carry structured parameters (dicts of coefficient
blocks, scale scalars, ...). Every wrapper here ravels the user's pytree
to a flat vector around a flat engine and unravels the optimum, and the
user's log-density sees its own structure.

The ravel is JAX's (``jax.flatten_util.ravel_pytree``), built on
``torch.utils._pytree``, whose own order differs in two ways: JAX visits a
dict's keys sorted where torch keeps insertion order, and JAX drops
``None`` where torch keeps it as a leaf. `_ravel` orders the leaves as JAX
does and skips ``None``, so that the flat vector, `pytree_names` and every
solve equal JAX's. Leaves of several dtypes are promoted to one for the
flat vector and cast back one by one on the way out, as JAX does.
`map_then_sample_pytree` unravels the workflow's (draws, chains, size)
draws by one reshape a leaf (JAX's ``vmap(vmap(unravel))``): the ravel is
a concatenation in JAX's leaf order.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, List, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .cg_solve import optimize_cg
from .constrained import optimize_auglag
from .lbfgs_solve import optimize_lbfgs
from .least_squares import least_squares
from .minimize import minimize
from .ops.linesearch import BackTracking
from .parallel.batch import optimize_batched
from .solve import MAX_ITERATIONS_DEFAULT, optimize
from .trust_region import optimize_tr
from .utils.device import as_device_tensor
from .workflow import map_then_sample

__all__ = [
    "optimize_pytree",
    "optimize_lbfgs_pytree",
    "optimize_batched_pytree",
    "optimize_cg_pytree",
    "optimize_tr_pytree",
    "least_squares_pytree",
    "optimize_auglag_pytree",
    "minimize_pytree",
    "pytree_names",
    "map_then_sample_pytree",
    "PytreeSampleResult",
]

_FLOATING = (torch.float32, torch.float64, torch.float16, torch.bfloat16)


def _jax_order(spec) -> List[int]:
    """Indices of ``spec``'s leaves (torch's order) in JAX's order: a dict's
    children by sorted key (JAX sorts dict and defaultdict keys; an
    OrderedDict keeps its order in both)."""
    if spec.is_leaf():
        return [0]
    orders, offset = [], 0
    # newer torch deprecates children_specs for children()
    for child in (spec.children() if hasattr(spec, "children") else spec.children_specs):
        orders.append([offset + i for i in _jax_order(child)])
        offset += child.num_leaves
    if spec.type is dict or spec.type is collections.defaultdict:
        keys = spec.context if spec.type is dict else spec.context[1]
        orders = [orders[i] for i in sorted(range(len(keys)), key=lambda i: keys[i])]
    return [i for order in orders for i in order]


def _jax_leaves(tree) -> Tuple[list, list, object]:
    """(torch's leaves, the indices of JAX's leaves among them in JAX's
    order — ``None`` dropped, the spec)."""
    leaves, spec = pytree.tree_flatten(tree)
    return leaves, [i for i in _jax_order(spec) if leaves[i] is not None], spec


def _tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else as_device_tensor(leaf, "parameters")


class _Unravel:
    """flat (…, size) -> the pytree: each leaf's slice reshaped (a leading
    batch axis kept) and, where the leaves had several dtypes, cast back to
    its own (JAX's ``unravel``, which then also refuses another flat
    dtype)."""

    def __init__(self, spec, n_leaves, order, shapes, dtypes, flat_dtype):
        self.spec, self.n_leaves, self.order = spec, n_leaves, order
        self.shapes, self.dtypes, self.flat_dtype = shapes, dtypes, flat_dtype
        self.sizes = [math.prod(s) for s in shapes]
        self.mixed = any(d != flat_dtype for d in dtypes)

    def __call__(self, flat):
        if self.mixed and flat.dtype != self.flat_dtype:
            raise TypeError(f"unravel function given array of dtype "
                            f"{_dtype_name(flat.dtype)}, but expected dtype "
                            f"{_dtype_name(self.flat_dtype)}")
        lead = flat.shape[:-1]
        leaves = [None] * self.n_leaves
        for i, chunk, shape, dtype in zip(self.order, torch.split(flat, self.sizes, dim=-1),
                                          self.shapes, self.dtypes):
            chunk = chunk.reshape(tuple(lead) + tuple(shape))
            leaves[i] = chunk.to(dtype) if self.mixed else chunk
        return pytree.tree_unflatten(leaves, self.spec)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _ravel(tree, batched: bool = False):
    """(flat, unravel) as ``jax.flatten_util.ravel_pytree``: leaves in JAX's
    order, ``None`` skipped, promoted to one dtype. With ``batched`` every
    leaf carries a leading batch axis, kept on the flat (batch, size)
    result, and unravel takes the first lane's shapes."""
    leaves, order, spec = _jax_leaves(tree)
    tensors = [_tensor(leaves[i]) for i in order]
    lead = 1 if batched else 0
    shapes = [tuple(t.shape[lead:]) for t in tensors]
    dtypes = [t.dtype for t in tensors]
    if not tensors:
        flat = torch.zeros((0,), dtype=torch.float32)
        return flat, _Unravel(spec, len(leaves), order, shapes, dtypes, torch.float32)
    flat_dtype = dtypes[0]
    for d in dtypes[1:]:
        flat_dtype = torch.promote_types(flat_dtype, d)
    pieces = [t.reshape(*t.shape[:lead], -1).to(flat_dtype) for t in tensors]
    flat = torch.cat(pieces, dim=-1)
    return flat, _Unravel(spec, len(leaves), order, shapes, dtypes, flat_dtype)


class _PytreeObjective:
    """The flat-vector objective around a log-density of the pytree."""

    def __init__(self, fn: Callable, unravel: _Unravel):
        self._fn = fn
        self._unravel = unravel

    def __call__(self, flat):
        return self._fn(self._unravel(flat))


class _PytreeVag(_PytreeObjective):
    """An analytic value_and_grad over pytrees, its gradient tree raveled."""

    def __call__(self, flat):
        v, g = self._fn(self._unravel(flat))
        return v, _ravel(g)[0]


class _PytreeResidual(_PytreeObjective):
    """residual_fn(x_tree[, data]) (and eq / ineq) on the flat vector."""

    def __call__(self, flat, *args):
        return self._fn(self._unravel(flat), *args)


def _flatten_problem(obj, x0_tree, batched=False):
    flat0, unravel = _ravel(x0_tree, batched)
    if flat0.dtype not in _FLOATING:
        raise TypeError(f"parameters must be floating point, got {_dtype_name(flat0.dtype)}")
    return flat0, unravel, _PytreeObjective(obj if callable(obj) else obj.logdensity, unravel)


def _flatten_with_vag(obj, x0_tree, value_and_grad_fn, batched=False):
    flat0, unravel, flat_obj = _flatten_problem(obj, x0_tree, batched)
    flat_vag = None if value_and_grad_fn is None else _PytreeVag(value_and_grad_fn, unravel)
    return flat0, unravel, flat_obj, flat_vag


def _check_stacked(x0_trees, message):
    leaves, order, _spec = _jax_leaves(x0_trees)
    if not order or np.ndim(leaves[order[0]]) < 1:
        raise ValueError(message)


def _ravel_bounds(bounds, x0_tree):
    """Bounds for TR over pytrees: each side a scalar (broadcast), a flat
    (n,) tensor, or a pytree shaped like x0 (raveled)."""
    if bounds is None:
        return None
    lo, hi = bounds
    structure = pytree.tree_structure(x0_tree)

    def side(b):
        # a side with x0's structure is raveled; a scalar or flat tensor has
        # a leaf's structure and passes through (where x0 is itself one
        # leaf, raveling is a reshape, and a number passes through as is)
        if b is None or pytree.tree_structure(b) != structure:
            return b
        if structure.is_leaf() and not isinstance(b, torch.Tensor):
            return b
        return _ravel(b)[0]

    return (side(lo), side(hi))


def optimize_pytree(
    obj,
    x0_tree,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
):
    """BFGS-maximize ``logdensity(params_pytree)`` over structured params.

    Returns ``(params_opt, result)``: ``params_opt`` has ``x0_tree``'s
    structure, ``result`` is the flat `OptimizeResult` (gradient and state
    in the raveled coordinates)."""
    flat0, unravel, flat_obj = _flatten_problem(obj, x0_tree)
    res = optimize(flat_obj, flat0, ls=ls, tol=tol, max_iterations=max_iterations)
    return unravel(res.x), res


def optimize_lbfgs_pytree(
    obj,
    x0_tree,
    history: int = 10,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
):
    """L-BFGS flavour of `optimize_pytree` (large structured models)."""
    flat0, unravel, flat_obj = _flatten_problem(obj, x0_tree)
    res = optimize_lbfgs(flat_obj, flat0, history=history, ls=ls, tol=tol,
                         max_iterations=max_iterations)
    return unravel(res.x), res


def optimize_batched_pytree(
    obj,
    x0_trees,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    **batch_kwargs,
):
    """Fleet solves over structured parameters.

    ``x0_trees`` is a pytree whose every leaf carries a leading batch axis
    (the "stacked starts" layout). Each lane is raveled, the fleet runs on
    `optimize_batched`, and the optima are unraveled: returns
    ``(params_opt_trees, result)``, the params again stacked, ``result``
    the flat fleet `OptimizeResult`."""
    _check_stacked(x0_trees, "x0_trees leaves must carry a leading batch axis")
    flat_batch, unravel, flat_obj = _flatten_problem(obj, x0_trees, batched=True)
    res = optimize_batched(flat_obj, flat_batch, ls=ls, tol=tol, max_iterations=max_iterations,
                           **batch_kwargs)
    return unravel(res.x), res


def pytree_names(tree):
    """Flat coordinate names in ravel order — 'beta[0]', 'scales.sigma',
    nested paths joined with '.'; multi-element leaves get C-order
    ``[i]`` / ``[i,j]`` suffixes (JAX's ``keystr(path, simple=True,
    separator='.')``). Label a structured model's summary rows with
    ``posterior_summary(...).table(names=pytree_names(x0_tree))``."""
    paths = [path for path, _ in pytree.tree_flatten_with_path(tree)[0]]
    leaves, order, _spec = _jax_leaves(tree)
    names = []
    for i in order:
        base = ".".join(_key_name(k) for k in paths[i])
        shape = tuple(leaves[i].shape) if hasattr(leaves[i], "shape") else ()
        if not shape:
            names.append(base)
        else:
            for idx in np.ndindex(*shape):
                names.append(f"{base}[{','.join(map(str, idx))}]")
    return names


class PytreeSampleResult(tuple):
    """(samples, x_map, names, flat) — see `map_then_sample_pytree`."""

    __slots__ = ()

    def __new__(cls, samples, x_map, names, flat):
        return tuple.__new__(cls, (samples, x_map, names, flat))

    @property
    def samples(self):
        return self[0]

    @property
    def x_map(self):
        return self[1]

    @property
    def names(self):
        return self[2]

    @property
    def flat(self):
        return self[3]


def map_then_sample_pytree(obj, key, x0_tree, **kwargs):
    """The one-call MAP→posterior pipeline over structured parameters:
    ``obj`` is a log-density of the pytree, and the draws come back with
    its structure.

    Runs `map_then_sample` on the raveled coordinates and unravels the
    outputs: ``result.samples`` is a pytree whose leaves are
    (draws, chains, *leaf.shape); ``result.x_map`` has ``x0_tree``'s
    structure; ``result.names`` labels the flat coordinates (hand them to
    `posterior_summary(result.flat.samples).table(names=...)`);
    ``result.flat`` is the whole flat `MapThenSampleResult`. Every
    `map_then_sample` kwarg passes through; a ``transform=`` acts on the
    flat coordinates."""
    flat0, unravel, flat_obj = _flatten_problem(obj, x0_tree)
    out = map_then_sample(flat_obj, key, flat0, **kwargs)
    return PytreeSampleResult(unravel(out.samples), unravel(out.x_map),
                              tuple(pytree_names(x0_tree)), out)


def _key_name(key) -> str:
    if isinstance(key, pytree.MappingKey):
        return str(key.key)
    if isinstance(key, pytree.SequenceKey):
        return str(key.idx)
    if isinstance(key, pytree.GetAttrKey):
        return key.name
    return str(key)


def _stacked(obj, x0_tree, value_and_grad_fn):
    _check_stacked(x0_tree, "stacked=True needs a leading batch axis on every leaf")
    return _flatten_with_vag(obj, x0_tree, value_and_grad_fn, batched=True)


def _lane0(x0_tree):
    return pytree.tree_map(lambda leaf: None if leaf is None else leaf[0], x0_tree)


def optimize_cg_pytree(obj, x0_tree, *, stacked=False, value_and_grad_fn=None, **kwargs):
    """Nonlinear-CG maximize over structured parameters: returns
    ``(params_opt, result)`` with ``params_opt`` in ``x0_tree``'s structure
    and ``result`` the flat `CGResult`. ``stacked=True`` runs the fleet over
    a pytree whose leaves carry a leading batch axis (the params come back
    stacked). An analytic ``value_and_grad_fn`` over the pytree is raveled.
    All `optimize_cg` kwargs pass through."""
    flat, unravel, flat_obj, flat_vag = (_stacked if stacked else _flatten_with_vag)(
        obj, x0_tree, value_and_grad_fn)
    res = optimize_cg(flat_obj, flat, value_and_grad_fn=flat_vag, **kwargs)
    return unravel(res.x), res


def optimize_tr_pytree(obj, x0_tree, *, stacked=False, bounds=None, value_and_grad_fn=None,
                       **kwargs):
    """Trust-region Newton–Krylov over structured parameters (see
    `optimize_cg_pytree` for the conventions). ``bounds`` sides may be
    scalars, flat (n,) tensors, or pytrees shaped like one lane of
    ``x0_tree``."""
    flat, unravel, flat_obj, flat_vag = (_stacked if stacked else _flatten_with_vag)(
        obj, x0_tree, value_and_grad_fn)
    lane = _lane0(x0_tree) if stacked else x0_tree
    res = optimize_tr(flat_obj, flat, bounds=_ravel_bounds(bounds, lane),
                      value_and_grad_fn=flat_vag, **kwargs)
    return unravel(res.x), res


def least_squares_pytree(residual_fn, x0_tree, *, stacked=False, bounds=None, **kwargs):
    """Levenberg–Marquardt over structured parameters: ``residual_fn(
    params_tree[, data_lane]) -> (m,)``; returns ``(params_opt, result)``.
    ``stacked=True`` fits a fleet (a ``data=`` pytree batches per lane as in
    `least_squares`). Minimization convention, as `least_squares`."""
    if stacked:
        _check_stacked(x0_tree, "stacked=True needs a leading batch axis on every leaf")
    flat, unravel = _ravel(x0_tree, batched=stacked)
    lane = _lane0(x0_tree) if stacked else x0_tree
    res = least_squares(_PytreeResidual(residual_fn, unravel), flat,
                        bounds=_ravel_bounds(bounds, lane), **kwargs)
    return unravel(res.x), res


def optimize_auglag_pytree(obj, x0_tree, eq=None, ineq=None, *, stacked=False,
                           value_and_grad_fn=None, **kwargs):
    """Constrained (augmented-Lagrangian) maximize over structured
    parameters: ``eq``/``ineq`` take the same pytree as ``obj``
    (eq(params_tree) = 0, ineq(params_tree) >= 0). Returns ``(params_opt,
    result)`` with the flat `AugLagResult`; ``stacked=True`` runs the
    constrained fleet."""
    flat, unravel, flat_obj, flat_vag = (_stacked if stacked else _flatten_with_vag)(
        obj, x0_tree, value_and_grad_fn)
    res = optimize_auglag(
        flat_obj, flat,
        eq=None if eq is None else _PytreeResidual(eq, unravel),
        ineq=None if ineq is None else _PytreeResidual(ineq, unravel),
        value_and_grad_fn=flat_vag, **kwargs,
    )
    return unravel(res.x), res


def minimize_pytree(fun, x0_tree, *, stacked=False, eq=None, ineq=None, value_and_grad_fn=None,
                    **kwargs):
    """scipy-convention `minimize` over structured parameters. ``eq`` /
    ``ineq`` take the pytree (constrained solves route through the auglag
    fleet as in `minimize`); returns ``(params_opt, result)``, ``result`` in
    the minimization convention."""
    flat, unravel, flat_obj, flat_vag = (_stacked if stacked else _flatten_with_vag)(
        fun, x0_tree, value_and_grad_fn)
    res = minimize(
        flat_obj, flat,
        eq=_PytreeResidual(eq, unravel) if eq else None,
        ineq=_PytreeResidual(ineq, unravel) if ineq else None,
        value_and_grad_fn=flat_vag, **kwargs,
    )
    return unravel(res.x), res
