"""Trace a torch objective into the small IR that B3's generated objective runs.

The JAX resident kernel takes any jnp objective: it traces the objective to
a jaxpr inside the kernel body and hoists the arrays the objective closes
over into kernel inputs (quasinewtonmethods_jl_tpu/resident_solve.py ::
_hoist_consts, _make_kernel). This module is that step for the port.
`trace_objective` resolves the objective as the fleet engine does
(api.py: an explicit ``value_and_grad_fn``, else the object's
``logdensity_and_gradient``, else ``torch.func.grad_and_value`` of its
log-density; line-search trials take `as_value_fn`), traces both functions
for one lane's (n,) point in ``x0s``'s dtype with ``make_fx`` on fake
tensors (no device work, no host read), and lowers the two graphs to a list
of `Op`s over `Ref`s:

  * a per-lane value ("lane") lives in a slot of the lane's shared scratch,
    stored flat and row-major, with a static shape of rank <= 3;
  * a closed-over tensor ("const") is a kernel input on ``x0s``'s device,
    read from device memory; an expression of constants alone (the
    mixture's log-weights, a ``.to()`` of the data) is computed here once
    per solve with torch, on that device, and becomes a constant itself;
  * a Python scalar, and a tensor filled with one (``ones_like``,
    ``zeros``, ``scalar_tensor``, and the factories that read only a lane
    value's shape: ``full_like``, ``new_ones``, ``new_full``, ``full`` with
    a literal fill), is a literal ("lit").

A view (``t``, ``transpose``, ``permute``, ``expand``, ``unsqueeze``,
``squeeze``, ``select``, ``slice``, ``unbind``, ``diagonal``, ``flip``, and
a reshape of a row-major value) only changes a `Ref`'s shape, strides
(negative after a flip) and offset: no code, no copy. The ops that compute
are elementwise (the table `_ELEMENTWISE`: arithmetic, exp, log, log1p,
tanh, sigmoid, log-sigmoid, logaddexp, sqrt, abs, sgn, sin, cos, softplus,
maximum, minimum, clamp with literal bounds, and their backwards; the
comparisons lt, le, gt, ge, eq, ne and logical and, or, not, whose truth
values are 0 / 1, with where, masked_fill and isnan; what the
log-densities of ``torch.distributions`` reach: lgamma and its backward
digamma, xlogy, erf, erfc, log_ndtr, expm1, reciprocal, rsqrt, atan2, pow
with a tensor exponent or a literal base, and ``binary_cross_entropy_with_logits``
with a constant weight and reduction none, mean or sum; a truth value's cast
to the objective's own dtype, which gives its 0 / 1 as numbers, and
``clone``, ``erfinv``), reductions (``sum``, ``mean``, ``logsumexp``,
``linalg_vector_norm`` of ord 2, ``prod``, and ``max`` / ``min`` / ``amax``
/ ``amin``, NaN winning, with ``max.dim`` / ``min.dim`` whose indices only
their own backward reads), softmax and log-softmax and their backwards (a
logsumexp over their dim and elementwise ops), ``cumsum`` and ``cumprod``
along one dim, ``tril`` / ``triu``, ``mv``, ``mm``, ``bmm`` (``mm`` per
leading index) and ``dot``, the per-lane
linear algebra of one m x m matrix, or of a batch of them along a leading
dim (one op per matrix, stacked; a view where the batch is 1, as in
``D.MultivariateNormal``) (``linalg_cholesky_ex``,
``linalg_solve_triangular``, and by LU with partial pivoting
``_linalg_slogdet``, which ``logdet`` and ``slogdet`` reach, and
``_linalg_solve_ex``: their pivots, LU factors and ``info`` stay inside the
op, ``_linalg_check_errors`` emits nothing, and a failed factorization
gives NaN on its lane, as JAX's ``cholesky`` does, not an exception), the
scatters of ``select_backward`` / ``slice_backward``, ``cat`` and
``stack``, and the index maps with constant indices: a gather
(``index.Tensor``, and ``gather`` along a dim, whose index has its
source's rank: each output element reads one element of its source,
through an int32 table of addresses) and a put (``index_put`` with and
without ``accumulate``, ``scatter_add``, ``diag_embed``,
``diagonal_backward``: each output
element starts from the base tensor's and takes, in ascending order, the
values its sources give, through two int32 tables, a row pointer and the
sources' addresses, as in CSR; no atomics). Integer index constants are
folded on the host like other constant expressions (``tril_indices``,
``arange`` and what is computed from them), and the tables go to the
kernel as int32 inputs (``TracedObjective.tables``). An in-place op on an
op's fresh output (not a view) that nothing reads after the write
(``matmul``'s own ``squeeze_``, the ``exp_`` / ``log_`` / ``add_`` of
torch's decomposition of a loss) is its out-of-place twin. Anything else
raises ValueError, on every device, naming the op and, where the trace
can tell, the user's line: an op outside the table (``polygamma``,
``special.i0`` among them), a per-lane value of rank > 3, a
data-dependent shape, branch or loop
(``torch.cond`` and ``torch.while_loop``, and ``torch.distributions``'
validation of its arguments: pass ``validate_args=False``), ``.item()``,
a random op, an in-place write to the point, a constant or a value read
elsewhere, a constant in another floating dtype than ``x0s``, a cast to
another dtype or device, an index computed from the point (a gather's or a
scatter's), a boolean-mask index (``D.Multinomial``'s write among them),
an index tensor of rank > 1 per dim, a ``gather`` index of another rank
than its source's, a fill computed from the point, a
factorization's pivots or ``info`` read by the objective, ``max.dim``'s
indices read by the objective, a vector norm of another ord than 2, a BCE
with a ``pos_weight`` or a weight computed from the point, a matrix whose
work copy alone exceeds one block's shared memory.

Each op's output takes a fresh slot of the lane's scratch; where those
slots do not fit one block beside B (`lane_fits`: a regression on hundreds
of observations in float64), `_pack` places each output where a slot that
nothing reads any more lay, so that every trace that fits keeps its layout
and its generated text.

`evaluate` runs a lowered graph op by op in torch: the plain version of the
generated evaluation (ops/kernels/objective_codegen.py), which the CPU
tests hold to ``torch.func`` and to JAX. `in_band_linalg` gives plain
torch the kernel's rule for a failed factorization, for B3's plain
version on the user's own functions. `TracedObjective.ops_vag` /
``ops_value`` / ``const_bytes`` count the work of one evaluation for the
kernel's bound.
"""

from __future__ import annotations

import bisect
import math
import operator
import os
import sys
import traceback
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import torch

from ...api import as_value_and_grad, as_value_fn
from .bfgs_kernel import SMEM_LIMIT_BYTES, SMEM_SCRATCH_VALUES

__all__ = ["Ref", "Op", "Graph", "TracedObjective", "trace_objective", "evaluate",
           "in_band_linalg"]

aten = torch.ops.aten

_FUSED = "use optimize_batched_fused, which takes any objective"
# the largest rank of a per-lane value or a constant
MAX_RANK = 3
# where torch.cond and torch.while_loop live
_HOPS = os.path.join(os.path.dirname(torch.__file__), "_higher_order_ops")


@dataclass(frozen=True)
class Ref:
    """An operand: its shape and where its values are. Element (i0, i1, ...)
    of a "lane" or "const" Ref is at ``offset + i0·strides[0] +
    i1·strides[1] + ...`` of the lane's scratch or of constant ``index``; a
    "lit" is ``value``
    everywhere. ``boolean``: the values are 0/1 truth values."""

    kind: str
    shape: tuple = ()
    strides: tuple = ()
    offset: int = 0
    index: int = 0
    value: float = 0.0
    boolean: bool = False

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def _contiguous_strides(shape) -> tuple:
    strides, step = [], 1
    for size in reversed(shape):
        strides.append(step)
        step *= size
    return tuple(reversed(strides))


@dataclass(frozen=True)
class Op:
    """One computing op: ``out`` (a fresh contiguous lane slot) from
    ``args``. ``kind``: "ew" (elementwise ``name`` with broadcasting),
    "sum" / "lse" / "prod" (a reduction of args[0] over ``params[0]``, its
    dims),
    "mv" (a matrix times a vector or a matrix: ``mv`` and ``mm``), "dot",
    "scatter" (args[0] written into zeros at positions ``params`` = (dim,
    start, step, count) of its dim), "cat" (args concatenated along
    ``params[0]``: ``cat`` and ``stack``), "cumsum" / "cumprod" (along
    ``params[0]``, in index order), "gather" (output element i is element
    ``table[i]``
    of args[0]'s base, ``params`` = (table,)), "put" (output element i is
    args[0]'s, then each source k in ``src[ptr[i]:ptr[i + 1]]`` in turn
    added to it (``accumulate``) or, the last one, written over it, where
    the value of source k is element ``src[k]`` of args[1]'s base;
    ``params`` = (ptr table, src table, accumulate, number of sources)),
    "mean" and "norm" (a reduction as "sum", then a product by 1/count or
    a sum of squares and its square root), "tril" (args[0] with the
    elements above diagonal ``params[0]`` zeroed, or with ``name`` "triu"
    those below it). On one lane's m x m
    matrix args[0], read through its strides: "chol" (``out`` its lower
    Cholesky factor, upper triangle zero), "trsm" (``out`` = args[0]⁻¹
    args[1], (m, k), ``params`` = (upper, unitriangular)), "slogdet"
    (``out`` (2,): sign and log|det| by LU with partial pivoting), "solve"
    (``out`` = args[0]⁻¹ args[1], (m,) or (m, k), by LU with partial
    pivoting); "slogdet" and "solve" factorize a work copy of the matrix
    at lane offset ``params[0]``. A failed factorization (a Cholesky
    pivot not > 0, an LU pivot of 0) gives NaN in every element of
    ``out``. A table is an index into the objective's ``tables``.
    ``source``: the aten op it lowers."""

    kind: str
    name: str
    out: Ref
    args: tuple
    params: tuple = ()
    source: str = ""


@dataclass
class Graph:
    """A lowered function of the lane's point (scratch slot 0, n values):
    its ops in order, its outputs, and the scratch it uses."""

    ops: list
    value: Ref
    grad: Optional[Ref]
    slots: int


@dataclass
class TracedObjective:
    """An objective traced for B3 (see the module docstring): the
    value-and-gradient graph, the value graph for line-search trials, the
    constants both read, on ``x0s``'s device in its dtype, and their
    gathers' and puts' int32 index tables. ``obj`` and
    ``value_and_grad_fn`` are the user's, for the plain version."""

    obj: object
    value_and_grad_fn: Optional[Callable]
    n: int
    dtype: torch.dtype
    vag: Graph
    val: Graph
    consts: list = field(default_factory=list)
    # int32 index tables of the gathers and puts, on the constants' device
    tables: list = field(default_factory=list)
    # the scratch of one slot per op, the layout of every trace that fits a
    # block (`extra_values` is less where the slots were reused, `_pack`)
    one_slot_values: int = 0
    # B3's library for this trace, once built and loaded (resident_kernel.py
    # :: traced_libraries), so that a trace solved again skips codegen and lookup
    library: object = field(default=None, init=False, repr=False, compare=False)

    @property
    def extra_values(self) -> int:
        """Scratch values one lane needs (the two graphs run in turn)."""
        return max(self.vag.slots, self.val.slots)

    @property
    def ops_vag(self) -> int:
        return graph_ops(self.vag)

    @property
    def ops_value(self) -> int:
        return graph_ops(self.val)

    @property
    def factorizes(self) -> bool:
        """Whether a graph factorizes a matrix (Cholesky or LU): its plain
        version then runs the user's functions under `in_band_linalg`."""
        return any(op.kind in ("chol", "slogdet", "solve") for g in (self.vag, self.val)
                   for op in g.ops)

    @property
    def const_bytes(self) -> int:
        """Bytes of the constants and index tables in device memory."""
        return sum(c.numel() * c.element_size() for c in (*self.consts, *self.tables))


# ---------------------------------------------------------------------------
# the op table

# aten op -> the elementwise function it computes
_ELEMENTWISE = {
    aten.add.Tensor: "add", aten.add.Scalar: "add",
    aten.sub.Tensor: "sub",
    aten.rsub.Scalar: "rsub",
    aten.mul.Tensor: "mul", aten.mul.Scalar: "mul",
    aten.div.Tensor: "div", aten.div.Scalar: "div",
    aten.neg.default: "neg",
    aten.pow.Tensor_Scalar: "pow",
    aten.exp.default: "exp",
    aten.log.default: "log",
    aten.where.self: "where",
    aten.gt.Scalar: "gt",
    aten.logaddexp.default: "logaddexp",
    aten.log_sigmoid_forward.default: "log_sigmoid",
    aten.log_sigmoid_backward.default: "log_sigmoid_backward",
    aten.tanh.default: "tanh",
    aten.tanh_backward.default: "tanh_backward",
    aten.log1p.default: "log1p",
    aten.sigmoid.default: "sigmoid",
    aten.sigmoid_backward.default: "sigmoid_backward",
    # comparisons and masks (truth values, stored as 0 / 1)
    aten.gt.Tensor: "gt",
    aten.lt.Scalar: "lt", aten.lt.Tensor: "lt",
    aten.le.Scalar: "le", aten.le.Tensor: "le",
    aten.ge.Scalar: "ge", aten.ge.Tensor: "ge",
    aten.eq.Scalar: "eq", aten.eq.Tensor: "eq",
    aten.ne.Scalar: "ne", aten.ne.Tensor: "ne",
    aten.logical_and.default: "and", aten.bitwise_and.Tensor: "and",
    aten.logical_or.default: "or", aten.bitwise_or.Tensor: "or",
    aten.logical_not.default: "not", aten.bitwise_not.default: "not",
    aten.masked_fill.Scalar: "masked_fill", aten.masked_fill.Tensor: "masked_fill",
    # more elementwise functions
    aten.abs.default: "abs",
    aten.sgn.default: "sgn", aten.sign.default: "sgn",
    aten.sqrt.default: "sqrt",
    aten.sin.default: "sin",
    aten.cos.default: "cos",
    aten.softplus.default: "softplus",
    aten.softplus_backward.default: "softplus_backward",
    aten.maximum.default: "maximum",
    aten.minimum.default: "minimum",
    aten.clamp.default: "clamp",
    # the log-densities of torch.distributions
    aten.clamp_min.default: "clamp", aten.clamp_max.default: "clamp",
    aten.sub.Scalar: "sub",
    aten.lgamma.default: "lgamma",
    aten.digamma.default: "digamma",
    aten.xlogy.Tensor: "xlogy", aten.xlogy.Scalar_Self: "xlogy", aten.xlogy.Scalar_Other: "xlogy",
    aten.erf.default: "erf",
    aten.erfc.default: "erfc",
    aten.special_log_ndtr.default: "log_ndtr",
    aten.expm1.default: "expm1",
    aten.reciprocal.default: "reciprocal",
    aten.rsqrt.default: "rsqrt",
    aten.atan2.default: "atan2",
    aten.pow.Tensor_Tensor: "powt", aten.pow.Scalar: "powt",
    aten.isnan.default: "isnan",
    aten.erfinv.default: "erfinv",
}
_UNARY = ("neg", "exp", "log", "log_sigmoid", "tanh", "log1p", "sigmoid", "abs", "sgn", "sqrt",
          "sin", "cos", "not", "lgamma", "digamma", "erf", "erfc", "log_ndtr", "expm1",
          "reciprocal", "rsqrt", "isnan", "erfinv")
_COMPARISONS = ("gt", "lt", "le", "ge", "eq", "ne")
# the functions whose values are truth values
_BOOLEAN = (*_COMPARISONS, "and", "or", "not", "isnan")
# operations per element of each elementwise function, for the bound
# (logaddexp: a - b, |.|, exp, log1p, max, +; log_sigmoid: |.|, exp,
# log1p, min, -; its backward: |.|, exp, 1 + z, z / (1 + z), sign·, -, ·g;
# sigmoid: exp, 1 +, 1 / .; the backwards of tanh and sigmoid three products
# and differences; sgn two comparisons; softplus x·beta, the threshold's
# test, exp, log1p, / beta; its backward x·beta, the test, exp, g·z, z + 1,
# the division; clamp its two bounds; lgamma, erf, erfc, expm1, rsqrt, atan2,
# pow, isnan and erfinv one each, reciprocal its division; digamma the asymptotic
# series at x >= 10: the log, 0.5/x, 1/x², the seven-term Horner sum 14 and
# three sums, 20 (each step of the recurrence that brings x below 10 up to
# 10, 1/x, the sum and x + 1, is not counted: it depends on the data); xlogy
# the log and the product; log_ndtr x/√2, erfc, /2, 1 - and log1p (below -1
# erfcx, /2, log, t² and the difference, as many); BCE with logits, m =
# max(-x, 0): 1 - y, ·x, -x, the max, + m, -m, exp, -x - m, exp, +, log, +)
_EW_COST = {"add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "neg": 1, "pow": 1, "exp": 1,
            "log": 1, "where": 1, "gt": 1, "logaddexp": 6, "log_sigmoid": 5,
            "log_sigmoid_backward": 7, "tanh": 1, "log1p": 1, "sigmoid": 3,
            "tanh_backward": 3, "sigmoid_backward": 3, "copy": 0,
            "lt": 1, "le": 1, "ge": 1, "eq": 1, "ne": 1, "and": 1, "or": 1, "not": 1,
            "abs": 1, "sgn": 2, "sqrt": 1, "sin": 1, "cos": 1, "softplus": 5,
            "softplus_backward": 6, "maximum": 1, "minimum": 1, "clamp": 2,
            "lgamma": 1, "digamma": 20, "xlogy": 2, "erf": 1, "erfc": 1, "log_ndtr": 5,
            "expm1": 1, "reciprocal": 1, "rsqrt": 1, "atan2": 1, "powt": 1, "isnan": 1,
            "bce_logits": 12, "erfinv": 1}
_VIEWS = {aten.t.default, aten.permute.default, aten.expand.default, aten.unsqueeze.default,
          aten.squeeze.dim, aten.select.int, aten.slice.Tensor, aten.unbind.int,
          aten.diagonal.default, aten.flip.default, aten.transpose.int}
_FILLS = {aten.ones_like.default: 1.0, aten.zeros_like.default: 0.0, aten.zeros.default: 0.0,
          aten.new_zeros.default: 0.0, aten.new_ones.default: 1.0}
# factories of a given fill (which reads only their tensor argument's shape):
# the position of the fill among the node's args
_FACTORIES = {aten.full_like.default: 1, aten.new_full.default: 2, aten.full.default: 1}
# softmax and log-softmax and their backwards, as compositions of a
# reduction over their dim and elementwise ops
_SOFTMAX = {aten._softmax.default, aten._log_softmax.default,
            aten._softmax_backward_data.default, aten._log_softmax_backward_data.default}
# products: over dims, and along one dim in index order
_PRODUCTS = {aten.prod.default, aten.prod.dim_int, aten.cumprod.default}
# the index maps with constant indices (see the module docstring)
_PUTS = {aten.index_put.default, aten.diag_embed.default, aten.diagonal_backward.default}
# the reductions besides sum and logsumexp
_MEANS = {aten.mean.default, aten.mean.dim}
# the largest and smallest elements: over all dims, over given dims, and
# over one dim with the first index of each extreme (``max.dim``), which only
# the reduction's own backward reads (``scatter.src``)
_EXTREMES = {aten.max.default: "max", aten.min.default: "min", aten.amax.default: "max",
             aten.amin.default: "min", aten.max.dim: "max", aten.min.dim: "min"}
# ops whose output is their input's values: a copy, or a cast to the
# objective's own float dtype
_SAME = {aten.clone.default, aten._to_copy.default}
# reduction codes of the losses (torch's Reduction enum)
_LOSS_REDUCTIONS = {0: "none", 1: "mean", 2: "sum"}
# the per-lane factorizations and solves of a rank-2 matrix (see `Op`)
_LINALG = {aten.linalg_cholesky_ex.default, aten.linalg_solve_triangular.default,
           aten._linalg_slogdet.default, aten._linalg_solve_ex.default}
# ops that stay literals rather than fold into a constant
_KEEP = set(_FILLS) | set(_FACTORIES) | {aten.scalar_tensor.default}
_TABLE = (set(_ELEMENTWISE) | _VIEWS | _KEEP | _MEANS | _LINALG | set(_EXTREMES) | _SAME
          | _SOFTMAX | _PRODUCTS
          | {aten.binary_cross_entropy_with_logits.default, aten.gather.default,
             aten.scatter_add.default, aten.bmm.default}
          | {aten.lift_fresh_copy.default, aten.view.default, aten._unsafe_view.default,
             aten.sum.default,
             aten.sum.dim_IntList, aten.logsumexp.default, aten.mv.default, aten.mm.default,
             aten.dot.default, aten.select_backward.default, aten.slice_backward.default,
             aten.stack.default, aten.cat.default, aten.cumsum.default, aten.index.Tensor,
             aten.linalg_vector_norm.default, aten.tril.default, aten.triu.default,
             operator.getitem} | _PUTS)


@dataclass(frozen=True)
class _Inside:
    """An output of a factorization that stays inside its op (its pivots,
    its LU factors, its ``info``): an objective that reads one does not
    trace; ``_linalg_check_errors`` of an ``info`` emits nothing (a failed
    factorization gives NaN on its lane instead)."""

    what: str
    op: str


@dataclass(frozen=True)
class _ArgIndex:
    """The indices output of ``max.dim`` / ``min.dim``: ``ref`` holds each
    extreme's first index along ``dim`` of its source (as a number in the
    lane's scratch). Views of it are its own; only the reduction's backward
    (``scatter.src`` of the gradient at those indices) may read it."""

    ref: Ref
    dim: int
    op: str


def graph_ops(graph: Graph) -> int:
    """Floating-point operations of one evaluation of ``graph`` (exp, log,
    log1p, tanh, a square root and a division one each): the elementwise
    functions per output element (`_EW_COST`), a sum, a product, a cumsum
    and a cumprod one per input element, a mean one per input and one per
    output element, a 2-norm two per input and one per output element, a
    logsumexp three (the max, exp(a - max),
    the sum) and 2 per output, a max or min (its values or its first
    indices) one comparison per input element, the backward's pick of the
    index one per output element, mv, mm and dot two per product, a put with
    ``accumulate`` one per source, and of an m x m matrix a Cholesky
    factorization m³/3, an LU factorization 2m³/3 and a triangular solve m²
    per right-hand side (a solve through LU two); copies, gathers,
    scatters, stacks and tril move data and count none."""
    ops = 0
    for op in graph.ops:
        if op.kind == "ew":
            ops += _EW_COST[op.name] * op.out.numel
        elif op.kind in ("sum", "max", "min", "arg", "prod"):
            ops += op.args[0].numel
        elif op.kind == "pick":
            ops += op.out.numel
        elif op.kind == "mean":
            ops += op.args[0].numel + op.out.numel
        elif op.kind == "norm":
            ops += 2 * op.args[0].numel + op.out.numel
        elif op.kind == "lse":
            ops += 3 * op.args[0].numel + 2 * op.out.numel
        elif op.kind == "mv":  # M (m, k) times a vector, or a matrix (k, p)
            columns = op.args[1].shape[1] if len(op.args[1].shape) > 1 else 1
            ops += 2 * op.args[0].numel * columns
        elif op.kind == "dot":
            ops += 2 * op.args[0].numel
        elif op.kind in ("cumsum", "cumprod"):
            ops += op.args[0].numel
        elif op.kind == "put" and op.params[2]:
            ops += op.params[3]  # the sources
        elif op.kind in ("chol", "trsm", "slogdet", "solve"):
            m = op.args[0].shape[0]
            columns = _columns(op.out) if op.kind in ("trsm", "solve") else 0
            ops += {"chol": m ** 3 // 3, "trsm": m * m * columns, "slogdet": 2 * m ** 3 // 3,
                    "solve": 2 * m ** 3 // 3 + 2 * m * m * columns}[op.kind]
    return ops


def _columns(ref: Ref) -> int:
    """Right-hand sides of a solve whose output is ``ref``: (m,) or (m, k)."""
    return ref.shape[1] if len(ref.shape) > 1 else 1


# ---------------------------------------------------------------------------
# tracing


def _user_line(tb_frames) -> str:
    """The innermost of ``tb_frames`` (outermost first, all inside the
    objective's call) outside torch and outside this tracing code, as
    'file:line: code', or ''."""
    torch_dir = os.path.dirname(torch.__file__)
    own = {os.path.abspath(__file__),
           os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "api.py"))}
    for frame in reversed(list(tb_frames)):
        path = os.path.abspath(frame.filename)
        if path.startswith(torch_dir) or path in own or frame.filename.startswith("<"):
            continue
        return f"{frame.filename}:{frame.lineno}: {(frame.line or '').strip()}"
    return ""


def _refuse(what: str, line: str = "") -> ValueError:
    where = f" (at {line})" if line else ""
    return ValueError(
        f"the resident kernel runs a traced objective on the card, and this one does not trace "
        f"to its op table: {what}{where}; {_FUSED}")


class _LineOf(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the user's line of the first dispatch of ``target``."""

    def __init__(self, target):
        super().__init__()
        self.target, self.line = target, ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func == self.target and not self.line:
            stack = traceback.extract_stack()
            starts = [i for i, f in enumerate(stack) if f.name == "_line_of"
                      and os.path.abspath(f.filename) == os.path.abspath(__file__)]
            self.line = _user_line(stack[starts[-1] + 1:] if starts else [])
        return func(*args, **(kwargs or {}))


class _Reached(Exception):
    """Stops a run at the call `_line_of` looks for."""


def _line_of(fn, example, target) -> str:
    """The user's line that calls ``target`` in a plain run of ``fn`` on
    fake tensors ('' where the op is not in ``fn``'s own code, e.g. one
    that autograd adds). For a higher-order op (``torch.cond``,
    ``torch.while_loop``) the line that calls into torch/_higher_order_ops,
    found by a profile hook that stops the run there: its branches never
    run, so torch's compiler keeps nothing of them for the next trace."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if isinstance(target, torch._ops.HigherOrderOperator):
        found = []

        def hook(frame, event, arg):
            if event == "call" and frame.f_code.co_filename.startswith(_HOPS):
                stack = traceback.extract_stack(frame.f_back)
                starts = [i for i, f in enumerate(stack) if f.name == "_line_of"
                          and os.path.abspath(f.filename) == os.path.abspath(__file__)]
                found.append(_user_line(stack[starts[-1] + 1:] if starts else []))
                raise _Reached

        previous = sys.getprofile()
        sys.setprofile(hook)
        try:
            with FakeTensorMode(allow_non_fake_inputs=True) as fake:
                fn(fake.from_tensor(example))
        except Exception:  # noqa: BLE001 - the line is a courtesy of the error message
            pass
        finally:
            sys.setprofile(previous)
        return found[0] if found else ""
    mode = _LineOf(target)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as fake:
            x = fake.from_tensor(example)
            with mode:
                fn(x)
    except Exception:  # noqa: BLE001 - the line is a courtesy of the error message
        pass
    return mode.line


def _make_graph(fn, example):
    from torch.fx.experimental.proxy_tensor import make_fx

    try:
        return make_fx(lambda x: fn(x), tracing_mode="fake", _allow_non_fake_inputs=True)(example)
    except Exception as exc:  # the user's code failed on a fake tensor
        line = _user_line(traceback.extract_tb(exc.__traceback__))
        name = type(exc).__name__
        frames = traceback.extract_tb(exc.__traceback__)
        if any(os.path.abspath(f.filename).startswith(_HOPS) for f in frames):
            what = "a data-dependent branch or loop (torch.cond / torch.while_loop)"
        elif "DataDependent" in name or "GuardOn" in name:
            what = ("a data-dependent branch or shape (aten._local_scalar_dense: Python control "
                    "flow or .item() on a traced value)")
            distributions = os.path.join(os.path.dirname(torch.__file__), "distributions")
            if any(os.path.abspath(f.filename).startswith(distributions) for f in frames):
                what += (", here torch.distributions' validation of its arguments: pass "
                         "validate_args=False, or call "
                         "torch.distributions.Distribution.set_default_validate_args(False)")
        else:
            what = f"tracing failed with {name}: {str(exc).splitlines()[0] if str(exc) else ''}"
        raise _refuse(what, line) from exc


class _Lowering:
    """Lowers one fx graph to `Op`s; constants go to ``consts`` (shared by
    the two graphs of one objective)."""

    def __init__(self, n, dtype, device, shared, fn, example):
        self.n, self.dtype, self.device = n, dtype, device
        self.consts, self.const_ids, self.folds, self.tables = shared
        self.fn, self.example = fn, example
        self.ops = []
        self.slots = n  # slot 0: the point

    # refs --------------------------------------------------------------

    def lane(self, shape) -> Ref:
        shape = tuple(int(s) for s in shape)
        ref = Ref("lane", shape, _contiguous_strides(shape), self.slots)
        self.slots += max(1, math.prod(shape))
        return ref

    def const(self, tensor: torch.Tensor) -> Ref:
        key = id(tensor)
        if key not in self.const_ids:
            self.const_ids[key] = (len(self.consts), tensor)  # keep the object alive
            self.consts.append(tensor.to(self.device).contiguous())
        index = self.const_ids[key][0]
        t = self.consts[index]
        return Ref("const", tuple(t.shape), _contiguous_strides(t.shape), 0, index,
                   boolean=t.dtype == torch.bool)

    def table(self, index: torch.Tensor) -> int:
        """A new int32 index table (on the constants' device): its number."""
        self.tables.append(index.reshape(-1).to(torch.int32).contiguous())
        return len(self.tables) - 1

    def refuse(self, node, what):
        line = _line_of(self.fn, self.example, node.target)
        return _refuse(what, line)

    def refuse_control_flow(self, node):
        """The refusal of a higher-order op (``torch.cond``,
        ``torch.while_loop``), at ``node`` or at the user of ``node`` (a
        branch's or a body's graph) that calls it."""
        hops = [u for u in (node, *node.users)
                if isinstance(u.target, torch._ops.HigherOrderOperator)]
        target = hops[0].target if hops else node.target
        return self.refuse(hops[0] if hops else node,
                           f"a data-dependent branch or loop (torch.cond / torch.while_loop: "
                           f"{getattr(target, '__name__', target)})")

    # lowering ------------------------------------------------------------

    def run(self, gm) -> Graph:
        env = {}
        self.order = {node: i for i, node in enumerate(gm.graph.nodes)}
        for node in gm.graph.nodes:
            if node.op == "placeholder":  # the point
                env[node] = Ref("lane", (self.n,), (1,), 0)
            elif node.op == "get_attr":
                value = getattr(gm, node.target)
                if not isinstance(value, torch.Tensor):  # a branch's or a loop body's graph
                    raise self.refuse_control_flow(node)
                env[node] = self.const(value)
            elif node.op == "call_function":
                env[node] = self.call(node, env)
            elif node.op == "output":
                return self.outputs(node, env)
        raise _refuse("the objective returns nothing")

    def outputs(self, node, env) -> Graph:
        out = node.args[0]
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        refs = [self.output(self.arg(o, env), i == 1) for i, o in enumerate(outs)]
        value, grad = refs[0], (refs[1] if len(refs) > 1 else None)
        if value.numel != 1:
            raise _refuse(f"the value has shape {value.shape}, not a scalar")
        if grad is not None and grad.shape != (self.n,):
            raise _refuse(f"the gradient has shape {grad.shape}, not ({self.n},)")
        return Graph(self.ops, value, grad, self.slots)

    def copy(self, ref: Ref) -> Ref:
        out = self.lane(ref.shape)
        self.ops.append(Op("ew", "copy", out, (ref,), source="copy"))
        return out

    def output(self, ref: Ref, grad: bool) -> Ref:
        """``ref`` where the kernel reads an output: in lane scratch clear of
        the point (whose slot the next evaluation writes before its first
        barrier), the gradient contiguous; else copied into a fresh slot."""
        if not isinstance(ref, Ref) or ref.boolean:
            raise _refuse("an output that is not a floating-point tensor")
        if (ref.kind == "lane" and ref.offset >= self.n
                and (not grad or ref.strides == (1,))):
            return ref
        return self.copy(ref)

    def arg(self, a, env):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (int, float)) and not isinstance(a, bool):
            return Ref("lit", value=float(a))
        if isinstance(a, bool):
            return Ref("lit", value=float(a), boolean=True)
        return a  # a size, a dim, a dtype: read from the node's args where needed

    def call(self, node, env):
        target = node.target
        name = str(target)
        if target is operator.getitem:
            seq = env[node.args[0]]
            return seq[node.args[1]]
        if target == aten._linalg_check_errors.default:
            return None  # a failed factorization gives NaN on its lane
        if isinstance(target, torch._ops.HigherOrderOperator):
            raise self.refuse_control_flow(node)
        if not isinstance(target, torch._ops.OpOverload):
            raise self.refuse(node, f"the call {name}")
        if target == aten.polygamma.default:
            raise self.refuse(node, f"an op outside the table ({name}: a derivative of digamma, "
                                    "which no first-order gradient of lgamma needs)")
        inside = [env[a] for a in _flat_nodes(node.args, node.kwargs)
                  if isinstance(env[a], _Inside)]
        if inside:
            raise self.refuse(node, f"the {inside[0].what} of a {inside[0].op} read by the "
                                    f"objective ({name}): they stay inside their op")
        indices = [env[a] for a in _flat_nodes(node.args, node.kwargs)
                   if isinstance(env[a], _ArgIndex)]
        if indices:
            return self.arg_index_use(node, target, indices[0], env)
        if target._schema.is_mutable:
            target = self.out_of_place(node, env)
        if torch.Tag.nondeterministic_seeded in target.tags:
            raise self.refuse(node, f"a random op ({name})")
        if target == aten._local_scalar_dense.default:
            raise self.refuse(node, f"a host read of a traced value ({name}: .item() or Python "
                                    "control flow)")
        val = node.meta.get("val")
        for v in (val if isinstance(val, (tuple, list)) else [val]):
            if isinstance(v, torch.Tensor) and not all(isinstance(s, int) for s in v.shape):
                raise self.refuse(node, f"a data-dependent shape ({name})")
        tensors = [env[a] for a in _flat_nodes(node.args, node.kwargs)]
        flat = [r for t in tensors for r in (t if isinstance(t, (list, tuple)) else [t])]
        lane_in = any(isinstance(r, Ref) and r.kind == "lane" for r in flat)
        const_in = any(isinstance(r, Ref) and r.kind == "const" for r in flat)
        # constants alone, or no tensor at all outside the table (arange,
        # tril_indices): computed now
        foldable = not lane_in and (const_in or target not in _TABLE)
        if target not in _TABLE and not foldable:
            if any(isinstance(v, torch.Tensor) and not v.dtype.is_floating_point
                   and v.dtype != torch.bool for v in (val if isinstance(val, (tuple, list))
                                                       else [val])):
                raise self.refuse(node, f"an index computed from the point ({name}): gathers "
                                        "and scatters take constant indices")
            raise self.refuse(node, f"an op outside the table ({name})")
        if (foldable and target not in _KEEP
                and target != aten.lift_fresh_copy.default):
            if target not in _VIEWS or len(_meta_shape(node)) > 2:
                return self.fold(node, env, target)
        result = self.lower(node, env, target)
        for r in (result if isinstance(result, (list, tuple)) else [result]):
            if isinstance(r, Ref) and r.kind in ("lane", "const") and len(r.shape) > MAX_RANK:
                raise self.refuse(node, f"a per-lane value of rank {len(r.shape)} ({name}): "
                                        f"ranks up to {MAX_RANK} trace")
        return result

    def out_of_place(self, node, env):
        """The out-of-place twin of an in-place op, where the value it writes
        is an op's fresh output (not a view) that nothing reads after the
        write (``matmul``'s own ``squeeze_``; the ``exp_``, ``log_`` and
        ``add_`` of torch's decomposition of a loss, whose ``clone`` of the
        value reads it before); a fresh constant's twin is computed now. An
        in-place write to the point, a constant or a value read elsewhere
        raises."""
        target, base = node.target, node.args[0] if node.args else None
        packet = getattr(aten, target._schema.name.split("::")[1].rstrip("_"), None)
        twin = getattr(packet, target._overloadname, None) if packet is not None else None
        aliases = _VIEWS | {aten.view.default, aten._unsafe_view.default, operator.getitem}
        fresh = (isinstance(base, torch.fx.Node) and base.op == "call_function"
                 and base.target not in aliases and isinstance(env.get(base), Ref)
                 and env[base].kind in ("lane", "const")
                 and all(self.order[u] < self.order[node] and u.target not in aliases
                         for u in base.users if u is not node))
        lane_in = any(isinstance(env.get(a), Ref) and env[a].kind == "lane"
                      for a in _flat_nodes(node.args, node.kwargs))
        if twin is None or (twin not in _TABLE and lane_in) or not fresh:
            raise self.refuse(node, f"an in-place write ({target})")
        return twin

    def fold(self, node, env, target=None):
        """An expression of constants (and literals) alone, computed now
        (once for both graphs); ``target``: an in-place op's twin."""
        key = repr((str(target or node.target), _substitute(node.args, env),
                    _substitute(node.kwargs, env)))
        if key not in self.folds:
            self.folds[key] = self.compute(node, env, target or node.target)
        return self.folds[key]

    def compute(self, node, env, target):

        def real(a):
            if isinstance(a, torch.fx.Node):
                r = env[a]
                if isinstance(r, (list, tuple)):
                    return [real_ref(x) for x in r]
                return real_ref(r)
            if isinstance(a, (list, tuple)):
                return type(a)(real(x) for x in a)
            return a

        def real_ref(r):
            if r.kind == "const":
                return _strided(self.consts[r.index], r)
            dtype = torch.bool if r.boolean else self.dtype
            return torch.full(r.shape, r.value, dtype=dtype, device=self.device)

        args = tuple(real(a) for a in node.args)
        kwargs = {k: real(v) for k, v in node.kwargs.items()}
        out = target(*args, **kwargs)
        if isinstance(out, (list, tuple)):
            return [self.const(t) if isinstance(t, torch.Tensor) else t for t in out]
        if not isinstance(out, torch.Tensor):
            raise self.refuse(node, f"a host value from constants ({node.target})")
        return self.const(out)

    def lower(self, node, env, target):
        a = [self.arg(x, env) if not isinstance(x, (list, tuple)) else x for x in node.args]
        kw = node.kwargs
        out_shape = _meta_shape(node)
        if target in _FILLS or target in _FACTORIES:  # a literal of the node's shape
            at = _FACTORIES.get(target)
            fill = (_FILLS[target] if at is None
                    else node.args[at] if len(node.args) > at else kw.get("fill_value"))
            if not isinstance(fill, (int, float)):
                raise self.refuse(node, f"a fill computed from the point ({target})")
            return Ref("lit", out_shape, (0,) * len(out_shape), value=float(fill),
                       boolean=node.meta["val"].dtype == torch.bool)
        if target == aten.scalar_tensor.default:
            return Ref("lit", (), (), value=float(node.args[0]))
        if target in _SOFTMAX:
            return self.softmax(node, target, a)
        if target == aten.gather.default:
            return self.gather_dim(node, self.floats(node, a[0]), env, out_shape)
        if target == aten.scatter_add.default:
            return self.scatter_add(node, a, env, out_shape)
        if target == aten.bmm.default:
            return self.bmm(node, self.floats(node, a[0]), self.floats(node, a[1]))
        if target in (aten.prod.default, aten.prod.dim_int):
            if kw.get("dtype") not in (None, self.dtype):
                raise self.refuse(node, f"a product in another dtype ({target})")
            dims = [node.args[1]] if target == aten.prod.dim_int else None
            keepdim = bool(node.args[2]) if len(node.args) > 2 else bool(kw.get("keepdim", False))
            return self.reduce(node, "prod", self.floats(node, a[0]), dims, keepdim)
        if target == aten.lift_fresh_copy.default:  # a tensor made in the objective
            return a[0]
        if target in _VIEWS:
            return _view(target, a[0], node.args[1:], out_shape, kw)
        if target in _SAME:
            return self.same(node, target, a[0], kw)
        if target in _ELEMENTWISE:
            return self.elementwise(node, _ELEMENTWISE[target], a, kw, out_shape)
        if target == aten.binary_cross_entropy_with_logits.default:
            return self.bce_with_logits(node, a, kw, env)
        if target in _EXTREMES:
            return self.extreme(node, target, self.floats(node, a[0]), kw)
        if target in (aten.sum.default, aten.sum.dim_IntList, aten.logsumexp.default):
            if kw.get("dtype") not in (None, self.dtype):
                raise self.refuse(node, f"a sum in another dtype ({target})")
            # a sum of truth values counts them (the backward of max and amax)
            src = (self.truth(a[0]) if a[0].boolean and target != aten.logsumexp.default
                   else self.floats(node, a[0]))
            dims = node.args[1] if len(node.args) > 1 else None
            keepdim = bool(node.args[2]) if len(node.args) > 2 else bool(kw.get("keepdim", False))
            return self.reduce(node, "lse" if target == aten.logsumexp.default else "sum", src,
                               dims, keepdim)
        if target in _MEANS or target == aten.linalg_vector_norm.default:
            return self.mean_or_norm(node, target, self.floats(node, a[0]), kw)
        if target in (aten.tril.default, aten.triu.default):
            src = self.floats(node, a[0])
            out = self.lane(out_shape)
            diagonal = node.args[1] if len(node.args) > 1 else kw.get("diagonal", 0)
            name = "tril" if target == aten.tril.default else "triu"
            self.ops.append(Op("tril", name, out, (src,), (int(diagonal),), str(target)))
            return out
        if target in _LINALG:
            return self.linalg(node, target, a, kw)
        if target in (aten.mv.default, aten.mm.default):
            M, v = self.floats(node, a[0]), self.floats(node, a[1])
            out = self.lane(out_shape)
            self.ops.append(Op("mv", "mv", out, (M, v), source=str(target)))
            return out
        if target == aten.dot.default:
            u, v = self.floats(node, a[0]), self.floats(node, a[1])
            out = self.lane(())
            self.ops.append(Op("dot", "dot", out, (u, v), source=str(target)))
            return out
        if target in (aten.select_backward.default, aten.slice_backward.default):
            grad, sizes, dim = self.floats(node, a[0]), tuple(node.args[1]), node.args[2]
            dim = dim % len(sizes)
            if target == aten.select_backward.default:
                start, step, count = node.args[3] % sizes[dim], 1, 1
                grad = _view(aten.unsqueeze.default, grad, (dim,), None)
            else:
                start, end, step = node.args[3], node.args[4], node.args[5]
                start, end, _ = slice(start, end, step).indices(sizes[dim])
                count = len(range(start, end, step))
            out = self.lane(sizes)
            self.ops.append(Op("scatter", "scatter", out, (grad,), (dim, start, step, count),
                               str(target)))
            return out
        if target in (aten.stack.default, aten.cat.default):
            parts = [self.floats(node, env[x]) for x in node.args[0]]
            dim = node.args[1] if len(node.args) > 1 else kw.get("dim", 0)
            dim = dim % len(out_shape)
            if target == aten.stack.default:  # a concatenation of the parts, each unsqueezed
                parts = [_view(aten.unsqueeze.default, r, (dim,), None) for r in parts]
            out = self.lane(out_shape)
            self.ops.append(Op("cat", "cat", out, tuple(parts), (dim,), str(target)))
            return out
        if target in (aten.cumsum.default, aten.cumprod.default):
            kind = "cumsum" if target == aten.cumsum.default else "cumprod"
            if kw.get("dtype") not in (None, self.dtype):
                raise self.refuse(node, f"a {kind} in another dtype ({target})")
            src = self.floats(node, a[0])
            if not src.shape:
                return self.copy(src)
            out = self.lane(out_shape)
            self.ops.append(Op(kind, kind, out, (src,), (node.args[1] % len(out_shape),),
                               str(target)))
            return out
        if target == aten.index.Tensor:
            return self.gather(node, self.floats(node, a[0]), node.args[1], env, out_shape)
        if target in _PUTS:
            return self.put(node, target, a, env, out_shape)
        if target in (aten.view.default, aten._unsafe_view.default):  # a new shape of the same
            # row-major values (``_unsafe_view``: a reshape's, after its copy)
            src = self.floats(node, a[0])
            if src.kind == "lit":
                return Ref("lit", out_shape, (0,) * len(out_shape), value=src.value)
            if not _is_contiguous(src):
                src = self.copy(src)
            return replace(src, shape=out_shape, strides=_contiguous_strides(out_shape))
        raise self.refuse(node, f"an op outside the table ({target})")

    def indices(self, node, entries, env) -> tuple:
        """The index tensors of ``index`` / ``index_put`` (constants, on the
        constants' device) as a Python index (``slice(None)`` for None)."""
        out = []
        for e in entries:
            if e is None:
                out.append(slice(None))
                continue
            ref = env[e]
            if ref.boolean:
                raise self.refuse(node, f"a boolean-mask index ({node.target})")
            if ref.kind != "lane" and len(ref.shape) > 1:
                raise self.refuse(node, f"an index tensor of rank {len(ref.shape)} "
                                        f"({node.target}): one of rank <= 1 per dim")
            out.append(self.constant_index(node, ref))
        return tuple(out)

    def constant_index(self, node, ref: Ref) -> torch.Tensor:
        """An index tensor's values (a constant or a literal, on the
        constants' device) as int64, shaped like ``ref``."""
        if ref.kind == "lane":
            raise self.refuse(node, f"an index computed from the point ({node.target}): "
                                    "gathers and scatters take constant indices")
        if ref.kind == "lit":
            return torch.full(ref.shape, int(ref.value), dtype=torch.int64, device=self.device)
        index = _strided(self.consts[ref.index], ref)
        if index.dtype == torch.bool:
            raise self.refuse(node, f"a boolean-mask index ({node.target})")
        if index.dtype.is_floating_point:
            raise self.refuse(node, f"a floating-point index ({node.target})")
        return index.to(torch.int64)

    def dim_index(self, node, src: Ref, env) -> tuple:
        """``gather``'s and ``scatter_add``'s dim and constant index (of
        ``src``'s rank, as torch's are)."""
        dim, ref = node.args[1], env[node.args[2]]
        if len(ref.shape) != len(src.shape):
            raise self.refuse(node, f"a gather index of rank {len(ref.shape)} for a source of rank "
                                    f"{len(src.shape)} ({node.target}): the index takes its "
                                    "source's rank")
        return dim % max(1, len(src.shape)), self.constant_index(node, ref)

    def gather_dim(self, node, src: Ref, env, out_shape) -> Ref:
        """``gather(src, dim, index)``: output element at coordinates c reads
        src at c with coordinate ``dim`` replaced by ``index[c]``, through
        an address table, as `gather`."""
        dim, index = self.dim_index(node, src, env)
        if src.kind == "lit":
            return Ref("lit", out_shape, (0,) * len(out_shape), value=src.value)
        table = torch.gather(_addresses(src, self.device), dim, index)
        out = self.lane(out_shape)
        self.ops.append(Op("gather", "gather", out, (src,), (self.table(table),),
                           str(node.target)))
        return out

    def scatter_add(self, node, a, env, out_shape) -> Ref:
        """``scatter_add(base, dim, index, src)``: a put with accumulation,
        each element c of ``index`` adding src's element at c to the output
        at c with coordinate ``dim`` replaced by ``index[c]``, in index
        order."""
        base, values = a[0], self.floats(node, a[3])
        dim, index = self.dim_index(node, values, env)
        positions = torch.arange(math.prod(out_shape), device=self.device).reshape(out_shape)
        dest = torch.gather(positions, dim, index)
        if values.kind == "lit":
            where = torch.zeros(dest.shape, dtype=torch.int64, device=self.device)
        else:
            where = _addresses(values, self.device)[tuple(slice(0, s) for s in index.shape)]
        if base.kind != "lit":
            base = self.floats(node, base)
        return self.put_op(node, base, values, dest, where, True, out_shape)

    def softmax(self, node, target, a) -> Ref:
        """softmax as exp(x - logsumexp(x, dim)), log-softmax as x -
        logsumexp(x, dim); their backwards from the output y and the
        gradient g: g - exp(y)·Σ_dim g, and y·(g - Σ_dim g·y)."""
        source = str(target)

        def ew(name, *args):
            shape = torch.broadcast_shapes(*(r.shape for r in args))
            out = self.lane(shape)
            self.ops.append(Op("ew", name, out, args, (1.0,) if name == "sub" else (), source))
            return out

        first = self.floats(node, a[0])
        forward = target in (aten._softmax.default, aten._log_softmax.default)
        dims = [node.args[1 if forward else 2]] if first.shape else None
        if forward:
            shifted = ew("sub", first, self.reduce(node, "lse", first, dims, True))
            return shifted if target == aten._log_softmax.default else ew("exp", shifted)
        y = self.floats(node, a[1])
        if target == aten._log_softmax_backward_data.default:
            return ew("sub", first, ew("mul", ew("exp", y), self.reduce(node, "sum", first, dims,
                                                                        True)))
        return ew("mul", y, ew("sub", first, self.reduce(node, "sum", ew("mul", first, y), dims,
                                                          True)))

    def bmm(self, node, A: Ref, B: Ref) -> Ref:
        """``bmm`` as ``mm`` per leading index, stacked (a view where there
        is one)."""
        parts = []
        for i in range(A.shape[0]):
            Ai, Bi = (_view(aten.select.int, r, (0, i), None) for r in (A, B))
            out = self.lane((A.shape[1], B.shape[2]))
            self.ops.append(Op("mv", "mv", out, (Ai, Bi), source=str(node.target)))
            parts.append(out)
        return self.stacked(node, parts)

    def stacked(self, node, parts) -> Ref:
        """``parts`` (one Ref per leading index) as one value: the one part
        unsqueezed, or their stack (a "cat" of the unsqueezed parts)."""
        parts = [_view(aten.unsqueeze.default, r, (0,), None) for r in parts]
        if len(parts) == 1:
            return parts[0]
        out = self.lane((len(parts), *parts[0].shape[1:]))
        self.ops.append(Op("cat", "cat", out, tuple(parts), (0,), str(node.target)))
        return out

    def gather(self, node, src: Ref, entries, env, out_shape) -> Ref:
        """``src[indices]``: each output element reads the element of
        ``src``'s base whose address the table gives."""
        index = self.indices(node, entries, env)
        if src.kind == "lit":
            return Ref("lit", out_shape, (0,) * len(out_shape), value=src.value)
        table = _addresses(src, self.device)[index]
        out = self.lane(out_shape)
        self.ops.append(Op("gather", "gather", out, (src,), (self.table(table),),
                           str(node.target)))
        return out

    def put(self, node, target, a, env, out_shape) -> Ref:
        """``index_put`` (base args[0], values args[2]), ``diag_embed`` and
        ``diagonal_backward`` (base zeros, values args[0]) as a put: the
        destination of each value, in the output's flat order, from the
        same indexing of the output's positions."""
        positions = torch.arange(math.prod(out_shape), device=self.device).reshape(out_shape)
        accumulate = False
        if target == aten.index_put.default:
            base, values = a[0], self.floats(node, a[2])
            dest = positions[self.indices(node, node.args[1], env)]
            accumulate = bool(node.args[3]) if len(node.args) > 3 else bool(
                node.kwargs.get("accumulate", False))
        else:
            base = Ref("lit", out_shape, (0,) * len(out_shape), value=0.0)
            values = self.floats(node, a[0])
            if target == aten.diag_embed.default:
                offset, dim1, dim2 = (list(node.args[1:]) + [0, -2, -1][len(node.args) - 1:])[:3]
            else:
                offset, dim1, dim2 = node.args[2:5]
            dest = torch.diagonal(positions, offset, dim1, dim2)
        if base.kind != "lit":
            base = self.floats(node, base)
        if values.kind == "lit":
            where = torch.zeros(dest.shape, dtype=torch.int64, device=self.device)
        else:
            where = torch.broadcast_to(_addresses(values, self.device), dest.shape)
        return self.put_op(node, base, values, dest, where, accumulate, out_shape)

    def put_op(self, node, base, values, dest, where, accumulate, out_shape) -> Ref:
        """The put of ``values`` onto ``base``: source k, at address
        ``where[k]`` of the values' base, goes to output element
        ``dest[k]``, each destination's sources in their order."""
        positions = math.prod(out_shape)
        dest, where = dest.reshape(-1), where.reshape(-1)
        order = torch.argsort(dest, stable=True)  # each destination's sources in ascending order
        counts = torch.zeros(positions, dtype=torch.int64, device=self.device)
        counts.index_add_(0, dest, torch.ones_like(dest))
        ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        out = self.lane(out_shape)
        self.ops.append(Op("put", "put", out, (base, values),
                           (self.table(ptr), self.table(where[order]), accumulate, dest.numel()),
                           str(node.target)))
        return out

    def floats(self, node, ref: Ref) -> Ref:
        if ref.boolean:
            raise self.refuse(node, f"truth values as numbers ({node.target})")
        if ref.kind == "const":
            dtype = self.consts[ref.index].dtype
            if dtype != self.dtype:
                raise self.refuse(node, f"a constant of dtype {dtype} where x0s is {self.dtype} "
                                        f"({node.target})")
        return ref

    def truth(self, ref: Ref) -> Ref:
        """A closed-over mask as 0/1 in x0s's dtype (the kernel reads
        constants as Real); other truth values as they are."""
        if ref.kind != "const" or not ref.boolean:
            return ref
        key = ("as floats", ref.index)
        if key not in self.const_ids:
            mask = self.consts[ref.index].to(self.dtype)
            self.const_ids[key] = (len(self.consts), mask)
            self.consts.append(mask)
        return replace(ref, index=self.const_ids[key][0])

    def elementwise(self, node, fn, a, kw, out_shape):
        params = ()
        if fn in ("add", "sub", "rsub"):
            alpha = kw.get("alpha", 1)
            params = (float(alpha),)
            operands = a[:2]
        elif fn == "pow":
            if not isinstance(node.args[1], (int, float)):
                raise self.refuse(node, f"a traced exponent ({node.target})")
            params = (float(node.args[1]),)
            operands = a[:1]
        elif fn in ("where", "masked_fill"):
            # masked_fill(self, mask, value) is where(mask, value, self)
            operands = a[:3] if fn == "where" else [a[1], a[2], a[0]]
            fn = "where"
            if not operands[0].boolean:
                raise self.refuse(node, f"a condition that is not a comparison ({node.target})")
        elif fn in ("softplus", "softplus_backward"):
            given = list(node.args[1 if fn == "softplus" else 2:])
            given += [kw.get(k, v) for k, v in (("beta", 1), ("threshold", 20))][len(given):]
            params = tuple(float(v) for v in given[:2])
            operands = a[:1] if fn == "softplus" else a[:2]
        elif fn == "clamp":
            given = list(node.args[1:]) + [kw.get(k) for k in ("min", "max")][len(node.args) - 1:]
            if node.target == aten.clamp_max.default:
                given = [None, node.args[1]]
            if any(v is not None and not isinstance(v, (int, float)) for v in given):
                raise self.refuse(node, f"a clamp with traced bounds ({node.target})")
            params = (-math.inf if given[0] is None else float(given[0]),
                      math.inf if given[1] is None else float(given[1]))
            operands = a[:1]
        elif fn in _UNARY:
            operands = a[:1]
        elif fn == "log_sigmoid_backward":
            operands = a[:2]  # the CUDA formula needs no buffer
        else:
            operands = a[:2]
        if fn == "where":
            checked = [self.truth(operands[0])]
        elif fn in ("and", "or", "not"):  # truth values, or numbers tested against 0
            checked = [self.truth(r) if r.boolean else self.floats(node, r) for r in operands]
        elif fn == "mul":  # a mask times a number (the backward of max and amax)
            checked = [self.truth(r) if r.boolean else self.floats(node, r) for r in operands]
        else:
            checked = []
        checked += [self.floats(node, r) for r in operands[len(checked):]]
        out = self.lane(out_shape)
        # a product of two truth values is one (torch's bool mul)
        out = replace(out, boolean=fn in _BOOLEAN or (fn == "mul" and all(r.boolean
                                                                          for r in operands)))
        self.ops.append(Op("ew", fn, out, tuple(checked), params, str(node.target)))
        if fn == "log_sigmoid":  # (output, buffer): the buffer is never read
            return (out, Ref("lit"))
        return out

    def same(self, node, target, src: Ref, kw):
        """``clone``, and ``_to_copy`` to the objective's own float dtype and
        device (a truth value's cast gives its 0 / 1 as numbers: the support
        mask of ``D.Uniform``): the same values. A cast to another dtype or
        device raises; one to an integer dtype is an index in the making."""
        if target == aten._to_copy.default:
            dtype, device = kw.get("dtype"), kw.get("device")
            if dtype is not None and not dtype.is_floating_point and dtype != torch.bool:
                raise self.refuse(node, f"an index computed from the point ({target}): gathers "
                                        "and scatters take constant indices")
            if dtype not in (None, self.dtype) and not (dtype == torch.bool and src.boolean):
                raise self.refuse(node, f"a cast to {dtype} ({target}): only to the objective's "
                                        f"own {self.dtype}")
            want, have = torch.device(device or self.device), torch.device(self.device)
            if want.type != have.type or want.index not in (None, have.index):
                raise self.refuse(node, f"a cast to device {device} ({target}): the objective "
                                        f"runs on {self.device}")
            if dtype == self.dtype and src.boolean:
                return replace(self.truth(src), boolean=False)
        return src

    def bce_with_logits(self, node, a, kw, env):
        """``binary_cross_entropy_with_logits(x, y, weight, pos_weight,
        reduction)`` (the value of ``D.Bernoulli(logits=...)``): the
        elementwise loss, times a constant weight, then its reduction (none,
        mean or sum). A weight computed from the point and a ``pos_weight``
        raise."""
        given = list(node.args[2:]) + [kw.get(k, v) for k, v in
                                       (("weight", None), ("pos_weight", None),
                                        ("reduction", 1))][len(node.args) - 2:]
        weight, pos_weight, reduction = given[:3]
        target = node.target
        if pos_weight is not None:
            raise self.refuse(node, f"a pos_weight ({target}): only weight, None or a constant")
        if reduction not in _LOSS_REDUCTIONS:
            raise self.refuse(node, f"a reduction {reduction} ({target})")
        x, y = self.floats(node, a[0]), self.floats(node, a[1])
        full = _meta_shape(node.args[0])
        loss = self.lane(full)
        self.ops.append(Op("ew", "bce_logits", loss, (x, y), source=str(target)))
        if weight is not None:
            w = self.floats(node, self.arg(weight, env))
            if w.kind == "lane":
                raise self.refuse(node, f"a weight computed from the point ({target}): only "
                                        "None or a constant")
            weighted = self.lane(full)
            self.ops.append(Op("ew", "mul", weighted, (loss, w), source=str(target)))
            loss = weighted
        how = _LOSS_REDUCTIONS[reduction]
        return loss if how == "none" else self.reduce(node, how, loss, None, False)

    def extreme(self, node, target, src: Ref, kw):
        """``max`` / ``min`` (all dims), ``amax`` / ``amin`` (the dims
        given, all for none) and ``max.dim`` / ``min.dim`` (one dim: the
        values, and each extreme's first index as `_ArgIndex`). NaN wins,
        as torch's."""
        kind = _EXTREMES[target]
        args = list(node.args[1:])
        if target in (aten.max.default, aten.min.default):
            return self.reduce(node, kind, src, None, False)
        dims = args[0] if args else kw.get("dim", [])
        keepdim = bool(args[1]) if len(args) > 1 else bool(kw.get("keepdim", False))
        if target in (aten.amax.default, aten.amin.default):
            return self.reduce(node, kind, src, [dims] if isinstance(dims, int) else dims,
                               keepdim)
        rank = len(src.shape)
        dim = dims % max(1, rank)
        values = self.reduce(node, kind, src, [dim] if rank else None, keepdim)
        index = self.lane(tuple(s for d, s in enumerate(src.shape) if d != dim))
        self.ops.append(Op("arg", kind, index, (src,), ((dim,) if rank else (),), str(target)))
        if keepdim and rank:
            index = Ref("lane", values.shape, _contiguous_strides(values.shape), index.offset)
        return [values, _ArgIndex(index, dim, str(target))]

    def arg_index_use(self, node, target, index: _ArgIndex, env):
        """A use of ``max.dim``'s / ``min.dim``'s indices: a view (its own),
        or its backward's ``scatter.src`` of the gradient at them into zeros,
        a "pick": output element i is the source's where i's coordinate along
        the dim is the index, else the base's. Any other read raises."""
        if target in _VIEWS or target == aten.view.default:
            if target == aten.view.default:
                shape = _meta_shape(node)
                if not _is_contiguous(index.ref):
                    raise self.refuse(node, f"a reshape of the indices of a {index.op} ({target})")
                return replace(index, ref=replace(index.ref, shape=shape,
                                                  strides=_contiguous_strides(shape)))
            return replace(index, ref=_view(target, index.ref, node.args[1:], _meta_shape(node),
                                            node.kwargs))
        if target == aten.scatter.src and node.args[2] in env and env[node.args[2]] is index:
            base, dim = self.floats(node, self.arg(node.args[0], env)), node.args[1]
            src = self.floats(node, self.arg(node.args[3], env))
            out_shape = _meta_shape(node)
            dim = dim % len(out_shape)
            if index.ref.shape[dim] != 1 or len(src.shape) != len(out_shape) \
                    or src.shape[dim] != 1:
                raise self.refuse(node, f"a scatter at the indices of a {index.op} of another "
                                        f"shape ({target})")
            out = self.lane(out_shape)
            self.ops.append(Op("pick", "pick", out, (base, index.ref, src), (dim,), str(target)))
            return out
        raise self.refuse(node, f"the indices of a {index.op} read by the objective ({target}): "
                                "only its own backward reads them")

    def mean_or_norm(self, node, target, src: Ref, kw):
        """``mean`` (all dims or ``.dim``) and ``linalg_vector_norm`` of
        ord 2, as reductions."""
        if kw.get("dtype") not in (None, self.dtype):
            raise self.refuse(node, f"a reduction in another dtype ({target})")
        args = list(node.args[1:])
        if target == aten.linalg_vector_norm.default:
            order = args.pop(0) if args else kw.get("ord", 2)
            if float(order) != 2.0:
                raise self.refuse(node, f"a vector norm of ord {order} ({target}): only ord 2 "
                                        "traces")
            kind = "norm"
        else:
            kind = "mean"
        dims = args[0] if args else kw.get("dim")
        keepdim = bool(args[1]) if len(args) > 1 else bool(kw.get("keepdim", False))
        return self.reduce(node, kind, src, [dims] if isinstance(dims, int) else dims, keepdim)

    def matrix(self, node, ref: Ref) -> Ref:
        """A linear-algebra op's matrix: one m x m per lane, floating, with
        room for its work copy in one block's shared memory."""
        ref = self.floats(node, ref)
        if len(ref.shape) != 2 or ref.shape[0] != ref.shape[1]:
            raise self.refuse(node, f"a factorization of a {ref.shape} value per lane "
                                    f"({node.target}): one square matrix per lane")
        m = ref.shape[0]
        if m * m * self.dtype.itemsize > SMEM_LIMIT_BYTES:
            raise self.refuse(node, f"a matrix of m = {m} per lane ({node.target}): its work copy "
                                    "alone exceeds one block's shared memory")
        return ref

    def linalg(self, node, target, a, kw):
        """The per-lane factorizations and solves (see `Op`): the outputs
        torch's op returns, its pivots, LU factors and ``info`` as
        `_Inside`. A right-side solve (X A = B) is the left-side one of the
        transposes, its output a transposed view. A leading batch dim (b,
        m, m) is one op per index, their outputs stacked (a view where b is
        1; the right-hand sides indexed with it, or shared where they have
        none)."""
        if len(a[0].shape) == 3:
            return self.batched_linalg(node, target, a, kw)
        A = self.matrix(node, a[0])
        m = A.shape[0]
        source = str(target)

        def t(ref):
            return _view(aten.t.default, ref, (), None)

        if target == aten.linalg_cholesky_ex.default:
            out = self.lane((m, m))
            self.ops.append(Op("chol", "cholesky", out, (A,), (), source))
            upper = node.args[1] if len(node.args) > 1 else kw.get("upper", False)
            return [t(out) if upper else out, _Inside("info", "Cholesky factorization")]
        if target == aten._linalg_slogdet.default:
            out, work = self.lane((2,)), self.lane((m, m))
            self.ops.append(Op("slogdet", "slogdet", out, (A,), (work.offset,), source))
            return [Ref("lane", (), (), out.offset), Ref("lane", (), (), out.offset + 1),
                    _Inside("LU factors", "slogdet"), _Inside("pivots", "slogdet")]
        B = self.floats(node, a[1])
        left = kw.get("left", True)
        if not left and len(B.shape) != 2:
            raise self.refuse(node, f"a right-side solve of a vector ({target})")
        if len(B.shape) not in (1, 2) or (B.shape[0] if left else B.shape[1]) != m:
            raise self.refuse(node, f"a right-hand side of shape {B.shape} for an {m} x {m} "
                                    f"matrix ({target})")
        if not left:  # X A = B: Aᵀ Xᵀ = Bᵀ
            A, B = t(A), t(B)
        if target == aten.linalg_solve_triangular.default:
            if len(B.shape) != 2:
                raise self.refuse(node, f"a triangular solve of a vector ({target})")
            if A.kind == "lit":  # the substitution reads the matrix where it lies
                A = self.copy(A)
            upper = bool(kw["upper"]) != (not left)
            out = self.lane(B.shape)
            self.ops.append(Op("trsm", "solve_triangular", out, (A, B),
                               (upper, bool(kw.get("unitriangular", False))), source))
            return out if left else t(out)
        out, work = self.lane(B.shape), self.lane((m, m))
        self.ops.append(Op("solve", "solve", out, (A, B), (work.offset,), source))
        return [out if left else t(out), _Inside("LU factors", "solve"),
                _Inside("pivots", "solve"), _Inside("info", "solve")]

    def batched_linalg(self, node, target, a, kw):
        """`linalg` of a batch of matrices (b, m, m): each index's op on its
        matrix and right-hand side, the outputs stacked (`stacked`)."""
        A, b = a[0], a[0].shape[0]
        B = a[1] if target in (aten.linalg_solve_triangular.default,
                               aten._linalg_solve_ex.default) else None
        # the right-hand sides: (b or 1, m, k), a batch of vectors (b or 1, m) for solve,
        # or (m, k) for every matrix
        batched = B is not None and (len(B.shape) == 3 or (
            target == aten._linalg_solve_ex.default and len(B.shape) == 2))
        if batched and B.shape[0] not in (1, b):
            raise self.refuse(node, f"a right-hand side of shape {B.shape} for {b} matrices "
                                    f"({target})")
        results = []
        for i in range(b):
            args = [_view(aten.select.int, A, (0, i), None)]
            if B is not None:
                args.append(_view(aten.select.int, B, (0, i if B.shape[0] == b else 0), None)
                            if batched else B)
            results.append(self.linalg(node, target, args + list(a[len(args):]), kw))
        if isinstance(results[0], Ref):
            return self.stacked(node, results)
        return [self.stacked(node, [r[k] for r in results]) if isinstance(part, Ref) else part
                for k, part in enumerate(results[0])]

    def reduce(self, node, kind, src: Ref, dims, keepdim):
        rank = len(src.shape)
        dims = sorted({d % rank for d in dims}) if dims else list(range(rank))
        if rank == 0:
            dims = []
        keep = [d for d in range(rank) if d not in dims]
        out = self.lane(tuple(src.shape[d] for d in keep))
        self.ops.append(Op(kind, kind, out, (src,), (tuple(dims),), str(node.target)))
        if keepdim and dims:
            shape = tuple(1 if d in dims else src.shape[d] for d in range(rank))
            return Ref("lane", shape, _contiguous_strides(shape), out.offset)
        return out


def _addresses(ref: Ref, device) -> torch.Tensor:
    """The address of each element of ``ref`` in its base, int64, shaped
    like ``ref``."""
    index = torch.full(ref.shape, ref.offset, dtype=torch.int64, device=device)
    for d, (size, stride) in enumerate(zip(ref.shape, ref.strides)):
        steps = torch.arange(size, dtype=torch.int64, device=device) * stride
        index = index + steps.reshape([size if e == d else 1 for e in range(len(ref.shape))])
    return index


def _strided(base: torch.Tensor, ref: Ref) -> torch.Tensor:
    """``ref``'s elements of ``base`` (any strides, a flip's negative ones
    too), as a new tensor."""
    return base.reshape(-1)[_addresses(ref, base.device)]


def _is_contiguous(ref: Ref) -> bool:
    return all(st == c for size, st, c in zip(ref.shape, ref.strides,
                                              _contiguous_strides(ref.shape)) if size != 1)


def _meta_shape(node) -> tuple:
    val = node.meta.get("val")
    if isinstance(val, (tuple, list)):
        val = val[0]
    return tuple(int(s) for s in val.shape) if isinstance(val, torch.Tensor) else ()


def _substitute(a, env):
    """``a`` with each node replaced by its lowered value (a fold's key)."""
    if isinstance(a, torch.fx.Node):
        return env[a]
    if isinstance(a, (list, tuple)):
        return tuple(_substitute(x, env) for x in a)
    if isinstance(a, dict):
        return tuple(sorted((k, _substitute(v, env)) for k, v in a.items()))
    return a


def _flat_nodes(args, kwargs):
    out = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.fx.Node))
    return out


def _view(target, ref: Ref, args, out_shape, kwargs=None) -> Ref:
    """The view ``target`` of ``ref``: a new shape, strides and offset over
    the same values (a literal stays a literal of the new shape)."""
    shape, strides, offset = list(ref.shape), list(ref.strides), ref.offset
    kwargs = kwargs or {}
    if target == aten.t.default:
        shape, strides = shape[::-1], strides[::-1]
    elif target == aten.transpose.int:
        d0, d1 = (d % len(shape) for d in args[:2])
        shape[d0], shape[d1] = shape[d1], shape[d0]
        strides[d0], strides[d1] = strides[d1], strides[d0]
    elif target == aten.permute.default:
        dims = [d % len(shape) for d in args[0]]
        shape, strides = [shape[d] for d in dims], [strides[d] for d in dims]
    elif target == aten.flip.default:
        for d in {d % len(shape) for d in args[0]}:
            offset += (shape[d] - 1) * strides[d]
            strides[d] = -strides[d]
    elif target == aten.diagonal.default:
        given = list(args) + [kwargs.get(k, v) for k, v in
                              (("offset", 0), ("dim1", 0), ("dim2", 1))][len(args):]
        diag, dim1, dim2 = given[0], given[1] % len(shape), given[2] % len(shape)
        if diag >= 0:
            offset += diag * strides[dim2]
            size = max(0, min(shape[dim1], shape[dim2] - diag))
        else:
            offset -= diag * strides[dim1]
            size = max(0, min(shape[dim1] + diag, shape[dim2]))
        step = strides[dim1] + strides[dim2]
        keep = [d for d in range(len(shape)) if d not in (dim1, dim2)]
        shape, strides = [shape[d] for d in keep] + [size], [strides[d] for d in keep] + [step]
    elif target == aten.expand.default:
        sizes = list(args[0])
        lead = len(sizes) - len(shape)
        new_strides = []
        for i, size in enumerate(sizes):
            if i < lead:
                new_strides.append(0)
            else:
                old = shape[i - lead]
                new_strides.append(strides[i - lead] if old == size or size == -1 else 0)
        shape = [shape[i - lead] if (s == -1) else s for i, s in enumerate(sizes)]
        strides = new_strides
    elif target == aten.unsqueeze.default:
        dim = args[0] % (len(shape) + 1)
        shape.insert(dim, 1)
        strides.insert(dim, 0)
    elif target == aten.squeeze.dim:
        dim = args[0] % max(1, len(shape))
        if shape and shape[dim] == 1:
            del shape[dim], strides[dim]
    elif target == aten.select.int:
        dim = args[0] % len(shape)
        index = args[1] % shape[dim]
        offset += index * strides[dim]
        del shape[dim], strides[dim]
    elif target == aten.slice.Tensor:
        dim = args[0] % len(shape) if args else 0
        start = args[1] if len(args) > 1 else None
        end = args[2] if len(args) > 2 else None
        step = args[3] if len(args) > 3 else 1
        start, end, step = slice(start, end, step).indices(shape[dim])
        offset += start * strides[dim]
        shape[dim] = len(range(start, end, step))
        strides[dim] *= step
    elif target == aten.unbind.int:
        dim = args[0] % len(shape) if args else 0
        return [_view(aten.select.int, ref, (dim, i), None) for i in range(shape[dim])]
    if ref.kind == "lit":
        return replace(ref, shape=tuple(shape), strides=(0,) * len(shape))
    return replace(ref, shape=tuple(shape), strides=tuple(strides), offset=offset)


def trace_objective(obj, value_and_grad_fn: Optional[Callable], x0s: torch.Tensor
                    ) -> TracedObjective:
    """Trace ``obj`` (with ``value_and_grad_fn`` where given) for B3 on
    ``x0s``'s lanes: (n,) points in its dtype, constants on its device.
    Raises ValueError where the objective does not trace to the op table
    (see the module docstring), on every device alike. The trace keeps its
    B3 library once built: pass it to `optimize_batched_resident` as the
    objective to solve again without tracing, generating or looking up."""
    n, dtype, device = x0s.shape[1], x0s.dtype, x0s.device
    vag_fn = as_value_and_grad(obj, value_and_grad_fn)
    val_fn = as_value_fn(obj, value_and_grad_fn)
    example = torch.empty(n, dtype=dtype, device=device)
    consts, tables = [], []
    shared = (consts, {}, {}, tables)  # constants, their ids, folded expressions, index tables
    graphs = []
    # the value first: an in-place write shows there as itself, not as
    # autograd's complaint about it
    for fn, want_grad in ((val_fn, False), (vag_fn, True)):
        gm = _make_graph(fn, example)
        graph = _Lowering(n, dtype, device, shared, fn, example).run(gm)
        if want_grad and graph.grad is None:
            raise _refuse("the value-and-gradient function returns one output")
        graphs.append(graph)
    val, vag = graphs
    val.grad = None
    one_slot = max(val.slots, vag.slots)
    if not lane_fits(n, dtype.itemsize, one_slot):
        val, vag = _pack(val, n, tables), _pack(vag, n, tables)
    return TracedObjective(obj, value_and_grad_fn, n, dtype, vag, val,
                           _kernel_consts(consts, (val, vag)), tables, one_slot)


def lane_fits(n: int, itemsize: int, extra_values: int) -> bool:
    """Whether one lane of B3 fits one block's shared memory with an
    objective's ``extra_values`` of scratch: the count of ``smem_bytes`` in
    csrc/resident_solve.cu, (n² + 9n + the reduction scratch + the
    objective's own)·itemsize (resident_kernel.resident_feasible)."""
    return (n * n + 9 * n + SMEM_SCRATCH_VALUES + extra_values) * itemsize <= SMEM_LIMIT_BYTES


def _span(ref: Ref) -> tuple:
    """The lowest and highest address ``ref`` reads in its base."""
    lo = hi = ref.offset
    for size, stride in zip(ref.shape, ref.strides):
        step = (size - 1) * stride
        lo, hi = (lo + step, hi) if step < 0 else (lo, hi + step)
    return lo, hi


def _pack(graph: Graph, n: int, tables: list) -> Graph:
    """``graph`` with each op's output slot (and an LU work copy) placed
    where an earlier slot nothing reads any more lay: a linear scan in op
    order, first fit, the point's n values and the outputs the kernel reads
    (the value, the gradient) kept. Used only where a trace's one slot per
    op does not fit a block (`lane_fits`: a regression on hundreds of
    observations in float64), so that every trace that fits keeps its text.
    The gathers' and puts' address tables into a moved slot move with it
    (``tables`` is the objective's list, rewritten in place)."""
    ops = graph.ops
    regions = []  # (old start, size, producing op)
    for i, op in enumerate(ops):
        regions.append((op.out.offset, max(1, op.out.numel), i))
        if op.kind in ("slogdet", "solve"):
            m = op.args[0].shape[0]
            regions.append((op.params[0], m * m, i))
    regions.sort()
    starts = [r[0] for r in regions]

    def region_of(ref):
        if not isinstance(ref, Ref) or ref.kind != "lane" or ref.offset < n:
            return None
        k = bisect.bisect_right(starts, _span(ref)[0]) - 1
        assert k >= 0 and _span(ref)[1] < regions[k][0] + regions[k][1], ref
        return k

    last = [r[2] for r in regions]  # a region lives at least through its op
    for i, op in enumerate(ops):
        for ref in op.args:
            k = region_of(ref)
            if k is not None:
                last[k] = max(last[k], i)
    for ref in (graph.value, graph.grad):
        k = region_of(ref)
        if k is not None:
            last[k] = len(ops)
    placed, free, top = {}, [], n  # free: [start, end) intervals of the new scratch
    by_op = {}
    for k, (_, _, i) in enumerate(regions):
        by_op.setdefault(i, []).append(k)
    for i in range(len(ops)):
        for k, (_, size, _) in enumerate(regions):
            if k in placed and last[k] < i and not placed[k][1]:
                free.append((placed[k][0], placed[k][0] + size))
                placed[k] = (placed[k][0], True)
        free.sort()
        merged = []
        for lo, hi in free:
            if merged and merged[-1][1] == lo:
                merged[-1] = (merged[-1][0], hi)
            else:
                merged.append((lo, hi))
        free = merged
        for k in by_op.get(i, []):
            size = regions[k][1]
            fit = next((j for j, (lo, hi) in enumerate(free) if hi - lo >= size), None)
            if fit is None:
                placed[k], top = (top, False), top + size
            else:
                lo, hi = free[fit]
                placed[k] = (lo, False)
                free[fit:fit + 1] = [(lo + size, hi)] if hi > lo + size else []
    delta = [placed[k][0] - regions[k][0] for k in range(len(regions))]

    def moved(ref):
        k = region_of(ref)
        return ref if k is None else replace(ref, offset=ref.offset + delta[k])

    new_ops = []
    for op in ops:
        params = op.params
        if op.kind in ("slogdet", "solve"):
            params = (op.params[0] + delta[starts.index(op.params[0])],) + tuple(op.params[1:])
        if op.kind == "gather" and region_of(op.args[0]) is not None:
            tables[op.params[0]] = tables[op.params[0]] + delta[region_of(op.args[0])]
        if op.kind == "put" and region_of(op.args[1]) is not None:
            tables[op.params[1]] = tables[op.params[1]] + delta[region_of(op.args[1])]
        new_ops.append(replace(op, out=moved(op.out), args=tuple(moved(r) for r in op.args),
                               params=params))
    return Graph(new_ops, moved(graph.value), moved(graph.grad) if graph.grad else None, top)


def _kernel_consts(consts, graphs) -> list:
    """The constants the graphs' ops read (a constant folded into another
    is not one), renumbered in place of the lowering's list."""
    used = sorted({r.index for g in graphs for op in g.ops for r in op.args if r.kind == "const"})
    number = {old: new for new, old in enumerate(used)}

    def renumber(r):
        return replace(r, index=number[r.index]) if r.kind == "const" else r

    for g in graphs:
        g.ops[:] = [replace(op, args=tuple(renumber(r) for r in op.args)) for op in g.ops]
    return [consts[i] for i in used]


# ---------------------------------------------------------------------------
# the plain version of the generated evaluation


def _base(ref: Ref, scratch: torch.Tensor, consts) -> torch.Tensor:
    return (scratch if ref.kind == "lane" else consts[ref.index]).reshape(-1)


def _load(ref: Ref, scratch: torch.Tensor, consts, dtype) -> torch.Tensor:
    if ref.kind == "lit":
        return torch.full(ref.shape, ref.value, dtype=dtype, device=scratch.device)
    return _strided(_base(ref, scratch, consts), ref)


def _pow(a, e):
    if e == 0:
        return torch.ones_like(a)
    if e == 1:
        return a.clone()
    if e == 2:
        return a * a
    if e == 3:
        return a * a * a
    if e == 0.5:
        return torch.sqrt(a)
    if e == -0.5:
        return torch.rsqrt(a)
    if e == -1:
        return 1.0 / a
    if e == -2:
        return 1.0 / (a * a)
    return torch.pow(a, e)


def _elementwise(op: Op, x, dtype):
    """The kernel's formula for each elementwise function (torch's CUDA
    one: a division by a literal is a product by its reciprocal, the
    log-sigmoid's backward needs no buffer)."""
    name, p = op.name, op.params
    if name == "copy":
        return x[0].clone()
    if name == "add":
        return x[0] + x[1] if p[0] == 1 else x[0] + p[0] * x[1]
    if name == "sub":
        return x[0] - x[1] if p[0] == 1 else x[0] - p[0] * x[1]
    if name == "rsub":
        return x[1] - x[0] if p[0] == 1 else x[1] - p[0] * x[0]
    if name == "mul":
        return x[0] * x[1]
    if name == "div":
        if op.args[1].kind == "lit":
            inv = torch.tensor(1.0, dtype=dtype) / torch.tensor(op.args[1].value, dtype=dtype)
            return x[0] * inv.to(x[0].device)
        return x[0] / x[1]
    if name == "neg":
        return -x[0]
    if name == "pow":
        return _pow(x[0], p[0])
    if name == "exp":
        return torch.exp(x[0])
    if name == "log":
        return torch.log(x[0])
    if name == "where":
        return torch.where(x[0] != 0, x[1], x[2])
    if name == "gt":
        return (x[0] > x[1]).to(dtype)
    if name == "logaddexp":
        a, b = torch.broadcast_tensors(x[0], x[1])
        m = torch.maximum(a, b)
        r = m + torch.log1p(torch.exp(-torch.abs(a - b)))
        return torch.where(torch.isinf(a) & (a == b), a, r)
    if name == "log_sigmoid":
        a = x[0]
        return torch.clamp(a, max=0.0) - torch.log1p(torch.exp(-torch.abs(a)))
    if name == "tanh":
        return torch.tanh(x[0])
    if name == "log1p":
        return torch.log1p(x[0])
    if name == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-x[0]))
    if name == "tanh_backward":
        return x[0] * (1.0 - x[1] * x[1])
    if name == "sigmoid_backward":
        return x[0] * (1.0 - x[1]) * x[1]
    if name in _COMPARISONS:
        op_ = {"gt": torch.gt, "lt": torch.lt, "le": torch.le, "ge": torch.ge, "eq": torch.eq,
               "ne": torch.ne}[name]
        return op_(x[0], x[1]).to(dtype)
    if name in ("and", "or"):
        both = (torch.logical_and if name == "and" else torch.logical_or)(x[0] != 0, x[1] != 0)
        return both.to(dtype)
    if name == "not":
        return (x[0] == 0).to(dtype)
    if name == "abs":
        return torch.abs(x[0])
    if name == "sgn":  # (0 < a) - (a < 0): 0 at 0 and at NaN
        return (0 < x[0]).to(dtype) - (x[0] < 0).to(dtype)
    if name == "sqrt":
        return torch.sqrt(x[0])
    if name == "sin":
        return torch.sin(x[0])
    if name == "cos":
        return torch.cos(x[0])
    if name == "softplus":  # x above the threshold, else log1p(exp(x·beta)) / beta
        beta, threshold = p
        a = x[0]
        return torch.where(a * beta > threshold, a, torch.log1p(torch.exp(a * beta)) / beta)
    if name == "softplus_backward":
        beta, threshold = p
        g, a = x[0], x[1]
        z = torch.exp(a * beta)
        return torch.where(a * beta > threshold, g, g * z / (z + 1.0))
    if name in ("maximum", "minimum"):  # NaN wins, as torch's
        a, b = torch.broadcast_tensors(x[0], x[1])
        pick = (a < b) if name == "maximum" else (b < a)
        return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b,
                                                          torch.where(pick, b, a)))
    if name == "clamp":  # NaN stays NaN; an absent bound is infinite
        a = torch.where(x[0] < p[0], torch.full_like(x[0], p[0]), x[0])
        return torch.where(p[1] < a, torch.full_like(a, p[1]), a)
    if name == "log_sigmoid_backward":
        g, a = x[0], x[1]
        neg = a < 0
        z = torch.exp(-torch.abs(a))
        max_deriv = neg.to(dtype)
        sign = torch.where(neg, 1.0, -1.0).to(dtype)
        return g * (max_deriv - sign * (z / (1.0 + z)))
    if name in _TORCH_FUNCTIONS:
        return _TORCH_FUNCTIONS[name](*x)
    if name == "isnan":
        return torch.isnan(x[0]).to(dtype)
    if name == "bce_logits":  # torch's decomposition (autograd's and vmap's), m = max(-x, 0)
        a, y = x
        m = torch.clamp_min(-a, 0)
        return (1 - y) * a + m + torch.log(torch.exp(-m) + torch.exp(-a - m))
    raise AssertionError(name)


# the elementwise functions that are one torch function
_TORCH_FUNCTIONS = {"lgamma": torch.lgamma, "digamma": torch.digamma, "xlogy": torch.xlogy,
                    "erf": torch.erf, "erfc": torch.erfc, "log_ndtr": torch.special.log_ndtr,
                    "expm1": torch.expm1, "reciprocal": torch.reciprocal, "rsqrt": torch.rsqrt,
                    "atan2": torch.atan2, "powt": torch.pow, "erfinv": torch.erfinv}


def _put(op: Op, base, scratch, consts, tables, dtype):
    """A put as the kernel runs it: each output element from the base's,
    its sources in ascending order, one round of sources at a time."""
    ptr, src = (tables[t].long() for t in op.params[:2])
    values = op.args[1]
    acc = base.reshape(-1).clone()
    counts = ptr[1:] - ptr[:-1]
    flat = None if values.kind == "lit" else _base(values, scratch, consts)

    def value(k):
        if flat is None:
            return torch.full(k.shape, values.value, dtype=dtype, device=acc.device)
        return flat[src[k]]

    if op.params[2]:  # accumulate
        for r in range(int(counts.max()) if counts.numel() else 0):
            has = counts > r
            acc[has] = acc[has] + value(ptr[:-1][has] + r)
    else:  # the last source wins
        has = counts > 0
        acc[has] = value(ptr[1:][has] - 1)
    return acc.reshape(op.out.shape)


def _linalg(op: Op, ins):
    """A factorization or solve in torch under `in_band_linalg`, whose
    rule for a failed factorization the kernel shares."""
    A = ins[0]
    with in_band_linalg():
        if op.kind == "chol":
            return torch.linalg.cholesky_ex(A).L
        if op.kind == "trsm":
            upper, unit = op.params
            return torch.linalg.solve_triangular(A, ins[1], upper=upper, unitriangular=unit)
        if op.kind == "slogdet":
            return torch.stack(torch.linalg.slogdet(A))
        return torch.linalg.solve_ex(A, ins[1]).result


class in_band_linalg(torch.utils._python_dispatch.TorchDispatchMode):
    """The kernel's rule for a failed factorization in plain torch: under
    this mode ``_linalg_check_errors`` raises nothing, and a Cholesky
    factor whose ``info`` is not 0, an LU ``slogdet`` with a pivot of 0 (sign
    0) and a ``solve`` whose ``info`` is not 0 are NaN on their lane, as
    JAX's are (its ``cholesky`` gives NaN, so ``fun`` is NaN in band). The
    plain version of B3 runs a factorizing objective under it
    (resident_kernel.py :: optimize_batched_resident_reference)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func == aten._linalg_check_errors.default:
            return None
        out = func(*args, **(kwargs or {}))
        if func == aten.linalg_cholesky_ex.default:
            L, info = out
            return torch.where((info != 0)[..., None, None], math.nan, L), info
        if func == aten._linalg_slogdet.default:
            sign, logabs, LU, pivots = out
            bad = sign == 0
            return (torch.where(bad, math.nan, sign), torch.where(bad, math.nan, logabs), LU,
                    pivots)
        if func == aten._linalg_solve_ex.default:
            X, LU, pivots, info = out
            bad = info != 0
            bad = bad[..., None] if X.ndim == info.ndim + 1 else bad[..., None, None]
            return torch.where(bad, math.nan, X), LU, pivots, info
        return out


def evaluate(graph: Graph, x: torch.Tensor, consts, tables=()) -> tuple:
    """Run ``graph`` op by op on one point ``x`` (n,) with torch: (value,
    gradient or None), as the generated objective computes them (the order
    of sums and products aside; a cumsum, a cumprod and a put in the
    kernel's order).
    ``tables``: the objective's index tables."""
    dtype = x.dtype
    scratch = torch.zeros(graph.slots, dtype=dtype, device=x.device)
    scratch[: x.shape[0]] = x
    for op in graph.ops:
        ins = [_load(r, scratch, consts, dtype) for r in op.args]
        if op.kind == "ew":
            y = _elementwise(op, ins, dtype)
        elif op.kind == "sum":
            dims = op.params[0]
            y = ins[0].sum(dim=dims) if dims else ins[0].clone()
        elif op.kind == "lse":
            dims = op.params[0]
            a = ins[0]
            if not dims:
                y = a.clone()
            else:
                m = torch.amax(a, dim=dims, keepdim=True)
                m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
                y = torch.log(torch.exp(a - m).sum(dim=dims)) + m.squeeze(dims)
        elif op.kind == "mv":
            y = ins[0] @ ins[1]
        elif op.kind == "dot":
            y = torch.dot(ins[0], ins[1])
        elif op.kind == "scatter":
            dim, start, step, count = op.params
            y = torch.zeros(op.out.shape, dtype=dtype, device=x.device)
            index = [slice(None)] * len(op.out.shape)
            index[dim] = slice(start, start + step * count, step)
            y[tuple(index)] = ins[0]
        elif op.kind == "cat":
            y = torch.cat(ins, dim=op.params[0])
        elif op.kind == "cumsum":
            y = torch.cumsum(ins[0], dim=op.params[0])
        elif op.kind == "cumprod":
            y = torch.cumprod(ins[0], dim=op.params[0])
        elif op.kind == "prod":
            y = ins[0].clone()
            for d in sorted(op.params[0], reverse=True):
                y = y.prod(dim=d)
        elif op.kind == "gather":
            y = _base(op.args[0], scratch, consts)[tables[op.params[0]].long()]
            y = y.reshape(op.out.shape)
        elif op.kind == "put":
            y = _put(op, ins[0], scratch, consts, tables, dtype)
        elif op.kind in ("mean", "norm"):
            dims = op.params[0]
            if op.kind == "norm":
                y = torch.sqrt((ins[0] * ins[0]).sum(dim=dims)) if dims else ins[0].abs()
            else:
                count = math.prod(op.args[0].shape[d] for d in dims)
                inv = torch.tensor(1.0, dtype=dtype) / torch.tensor(float(count), dtype=dtype)
                y = ins[0].sum(dim=dims) * inv.to(x.device) if dims else ins[0].clone()
        elif op.kind in ("max", "min"):  # NaN wins, as in torch.amax / amin
            dims = op.params[0]
            y = ((torch.amax if op.kind == "max" else torch.amin)(ins[0], dim=dims) if dims
                 else ins[0].clone())
        elif op.kind == "arg":  # each extreme's first index (the first NaN, where one is)
            dims = op.params[0]
            y = ((torch.max if op.name == "max" else torch.min)(ins[0], dim=dims[0]).indices
                 .to(dtype) if dims else torch.zeros((), dtype=dtype, device=x.device))
        elif op.kind == "pick":
            base, index, src = ins
            dim = op.params[0]
            shape = [1] * len(op.out.shape)
            shape[dim] = op.out.shape[dim]
            at = torch.arange(op.out.shape[dim], dtype=dtype, device=x.device).reshape(shape)
            y = torch.where(at == index, src, base)
        elif op.kind == "tril":
            y = (torch.tril if op.name == "tril" else torch.triu)(ins[0], op.params[0])
        elif op.kind in ("chol", "trsm", "slogdet", "solve"):
            y = _linalg(op, ins)
        else:
            raise AssertionError(op.kind)
        y = torch.broadcast_to(y, op.out.shape)
        scratch[op.out.offset: op.out.offset + op.out.numel] = y.reshape(-1)
    value = _load(graph.value, scratch, consts, dtype).reshape(())
    grad = None if graph.grad is None else _load(graph.grad, scratch, consts, dtype).clone()
    return value, grad
