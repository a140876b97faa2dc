"""Generate B3's objective as CUDA C++ from a traced objective.

The JAX resident kernel evaluates its objective by lowering the traced
jaxpr inside the kernel body (Mosaic does it for
quasinewtonmethods_jl_tpu/resident_solve.py :: _make_kernel). The port's
kernel B3 takes its objective as a template argument
(csrc/resident_objectives.cuh states the contract); `generate` writes one
such objective for a `TracedObjective` (ops/kernels/objective_trace.py),
and one translation unit around it that instantiates B3 from
csrc/resident_solve.cuh and exports plain C entry points:

  qnm_traced_solve(<the solve's arguments>, consts, stream)
      the launch; ``consts`` is a host array of the device pointers of the
      constants and then of the int32 index tables, copied into the
      objective, which goes to the kernel by value;
  qnm_traced_occupancy(regs, threads, blocks_per_sm)
  qnm_cuda_error_string(code)

Simple and right first. A lane runs the graph op by op: each op's output is
a slot of the lane's shared scratch (the objective's ``extra_values``; a
slot is reused only where one per op would not fit, objective_trace._pack),
stored flat, row-major; an elementwise op or a broadcast is a loop over its
output elements strided by the lane group's threads, with its operands read
through their index maps (a view is only an index map); a reduction to one
value is a strided partial per thread and one lane sum (bfgs_common.cuh); a
reduction over some dims, ``mv``, ``mm`` and a logsumexp's max take one
output element per thread, summed in a fixed order; a product to one
value runs on one thread, in index order; a cumsum and a cumprod take one
row per thread, in index order; a value of rank 3 is read through the
coordinates of its flat index, written into a unit only where a value has
rank 3; a gather is an index map through its
int32 table; a put takes one output element per thread, which walks its
sources (CSR tables) in ascending order, with no atomics; a constant and
an index table are read from device memory. A barrier follows every op
(``__syncwarp`` for one warp, ``__syncthreads`` above). Each graph is one
device function that the kernel calls, not inlined (a trial's evaluation
has two call sites). The
unit is built with -fmad=false and without fast math, so every op rounds
on its own as torch's does, and only the order of sums differs from the
plain version (`objective_trace.evaluate` and, on the card, the fleet
engine with the plain update). Elementwise functions take torch's CUDA
formulas: a division by a literal is a product by its reciprocal, the
log-sigmoid's backward needs no buffer, sigmoid is 1/(1 + exp(-x)), the
backwards of tanh and sigmoid g·(1 - y·y) and g·(1 - y)·y, sgn (0 < x) -
(x < 0) (0 at 0 and at NaN), softplus x where x·beta passes its threshold
and else log1p(exp(x·beta)) / beta, maximum, minimum and clamp let a NaN
through (CUDA's fmax does not), a comparison or a logical op 1 or 0; a
mean is the sum times 1/count (torch's MeanOps) and a 2-norm the square
root of the sum of squares. lgamma, erf, erfc, expm1, rsqrt, atan2, pow
with a tensor exponent and erfinv are CUDA's device functions (as torch's
kernels call them), reciprocal is 1/x, digamma torch's calc_digamma, xlogy 0 where
x is 0 (NaN where y is), log_ndtr torch's calc_log_ndtr (with CUDA's
erfcx below -1), BCE with logits the form torch's autograd and vmap
decompose it to; a max or min lets a NaN win, over the lane through the
lane group's butterfly, and ``max.dim``'s index is each extreme's first,
which its backward's pick reads. A factorization or solve of one lane's m x m
matrix copies its input into the lane's scratch (the factor's slot, or a
work copy, and the right-hand sides into the output) and calls the lane
group's device functions of csrc/resident_linalg.cuh: right-looking
Cholesky, substitution one right-hand side per thread, LU with partial
pivoting (the pivot a warp argmax, ties to the first row); a failed
factorization gives NaN. The functions that need more than an expression
are written into a unit only where its graphs use them, so that the text
of a graph of the earlier ops stays what it was.

The text depends only on the graph, the shapes and the dtype: constant
values and index tables are inputs, so two models of the same shape share
one build.
"""

from __future__ import annotations

import math

import torch

from .objective_trace import Graph, Op, Ref, TracedObjective, _columns, _contiguous_strides

__all__ = ["generate", "lane_warps"]


def lane_warps(n: int) -> int:
    """Warps of one lane's block (bfgs_common.cuh :: lane_warps)."""
    return 1 if n <= 64 else (n + 63) // 64


def _lit(value: float) -> str:
    if math.isnan(value):
        return "Real(NAN)"
    if math.isinf(value):
        return "Real(INFINITY)" if value > 0 else "(-Real(INFINITY))"
    return f"Real({float(value).hex()})"


def _coords(shape, var: str = "i") -> tuple:
    """(declarations, coordinate expressions) of flat index ``var`` in a
    row-major ``shape`` of rank <= 3."""
    if len(shape) == 0:
        return "", []
    if len(shape) == 1:
        return "", [var]
    if len(shape) == 2:
        return (f"const int {var}0 = {var} / {shape[1]}; const int {var}1 = {var} % {shape[1]}; ",
                [f"{var}0", f"{var}1"])
    return (f"const int {var}0 = {var} / {shape[1] * shape[2]}; const int {var}1 = {var} / "
            f"{shape[2]} % {shape[1]}; const int {var}2 = {var} % {shape[2]}; ",
            [f"{var}0", f"{var}1", f"{var}2"])


def _reduced(shape, dims) -> tuple:
    """A reduction of a row-major ``shape`` over some of its ``dims``, one
    output element i per thread and the reduced elements r in order: (the
    declarations of i's coordinates, those of r's, the count of r, the
    source's coordinate expressions)."""
    keep = [d for d in range(len(shape)) if d not in dims]
    decl_i, ci = _coords([shape[d] for d in keep], "i")
    decl_r, cr = _coords([shape[d] for d in dims], "r")
    coords = [ci[keep.index(d)] if d in keep else cr[list(dims).index(d)]
              for d in range(len(shape))]
    return decl_i, decl_r, math.prod(shape[d] for d in dims), coords


def _scoped(decl: str, statement: str) -> str:
    """A loop body: ``statement``, in braces after ``decl`` where there is one."""
    return f"{{ {decl}{statement} }}" if decl else statement


def _load(ref: Ref, coords) -> str:
    """The C++ expression of ``ref``'s element at ``coords`` (one per dim of
    ref, C++ int expressions)."""
    if ref.kind == "lit":
        return _lit(ref.value)
    terms = [str(ref.offset)] if ref.offset else []
    for c, size, stride in zip(coords, ref.shape, ref.strides):
        if size != 1 and stride != 0:
            terms.append(c if stride == 1 else f"{c} * {stride}")
    index = " + ".join(terms) or "0"
    base = "s" if ref.kind == "lane" else f"c{ref.index}"
    return f"{base}[{index}]"


def _broadcast(ref: Ref, out_coords) -> str:
    """``ref`` read at the output element whose coordinates are
    ``out_coords``, broadcast from the right as torch does."""
    lead = len(out_coords) - len(ref.shape)
    return _load(ref, [out_coords[lead + d] if ref.shape[d] != 1 else "0"
                       for d in range(len(ref.shape))])


def _pow(v: str, e: float) -> str:
    # torch's pow_tensor_scalar: the special exponents it dispatches
    if e == 0:
        return "Real(1)"
    if e == 1:
        return v
    if e == 2:
        return f"{v} * {v}"
    if e == 3:
        return f"{v} * {v} * {v}"
    if e == 0.5:
        return f"sqrt({v})"
    if e == -0.5:
        return f"rsqrt({v})"
    if e == -1:
        return f"Real(1) / {v}"
    if e == -2:
        return f"Real(1) / ({v} * {v})"
    return f"pow({v}, {_lit(e)})"


def _ew_expr(op: Op, x: list) -> str:
    name, p = op.name, op.params
    if name == "copy":
        return x[0]
    if name in ("add", "sub"):
        sign = "+" if name == "add" else "-"
        return (f"{x[0]} {sign} {x[1]}" if p[0] == 1
                else f"{x[0]} {sign} {_lit(p[0])} * {x[1]}")
    if name == "rsub":
        return f"{x[1]} - {x[0]}" if p[0] == 1 else f"{x[1]} - {_lit(p[0])} * {x[0]}"
    if name == "mul":
        return f"{x[0]} * {x[1]}"
    if name == "div":
        if op.args[1].kind == "lit":
            return f"{x[0]} * (Real(1) / {x[1]})"
        return f"{x[0]} / {x[1]}"
    if name == "neg":
        return f"-{x[0]}"
    if name == "pow":
        return _pow("a", p[0])
    if name == "exp":
        return f"qnm::exp_of({x[0]})"
    if name == "log":
        return f"qnm::log_of({x[0]})"
    if name == "where":
        return f"{x[0]} != Real(0) ? {x[1]} : {x[2]}"
    if name == "gt":
        return f"{x[0]} > {x[1]} ? Real(1) : Real(0)"
    if name == "logaddexp":
        return f"traced_logaddexp({x[0]}, {x[1]})"
    if name == "log_sigmoid":
        return f"traced_log_sigmoid({x[0]})"
    if name == "log_sigmoid_backward":
        return f"traced_log_sigmoid_backward({x[0]}, {x[1]})"
    if name == "tanh":
        return f"traced_tanh({x[0]})"
    if name == "log1p":
        return f"qnm::log1p_of({x[0]})"
    if name == "sigmoid":
        return f"Real(1) / (Real(1) + qnm::exp_of(-{x[0]}))"
    if name == "tanh_backward":
        return f"{x[0]} * (Real(1) - {x[1]} * {x[1]})"
    if name == "sigmoid_backward":
        return f"{x[0]} * (Real(1) - {x[1]}) * {x[1]}"
    if name in _COMPARE:
        return f"{x[0]} {_COMPARE[name]} {x[1]} ? Real(1) : Real(0)"
    if name in ("and", "or"):
        both = "&&" if name == "and" else "||"
        return f"({x[0]} != Real(0) {both} {x[1]} != Real(0)) ? Real(1) : Real(0)"
    if name == "not":
        return f"{x[0]} == Real(0) ? Real(1) : Real(0)"
    if name == "abs":
        return f"fabs({x[0]})"
    if name == "sgn":
        return f"Real((Real(0) < {x[0]}) - ({x[0]} < Real(0)))"
    if name in ("sqrt", "sin", "cos"):
        return f"{name}({x[0]})"
    if name == "softplus":
        return f"traced_softplus({x[0]}, {_lit(p[0])}, {_lit(p[1])})"
    if name == "softplus_backward":
        return f"traced_softplus_backward({x[0]}, {x[1]}, {_lit(p[0])}, {_lit(p[1])})"
    if name in ("maximum", "minimum"):
        return f"traced_{name}({x[0]}, {x[1]})"
    if name == "clamp":
        return f"traced_clamp({x[0]}, {_lit(p[0])}, {_lit(p[1])})"
    if name in _MATH or name in ("digamma", "xlogy", "log_ndtr", "bce_logits"):  # helpers
        return f"traced_{name}({', '.join(x)})"
    if name == "reciprocal":
        return f"Real(1) / {x[0]}"
    if name == "isnan":
        return f"isnan({x[0]}) ? Real(1) : Real(0)"
    raise AssertionError(name)


# the functions that are one CUDA device function: (name, float's, double's,
# arguments), each written into a unit as an overload pair only where used
_MATH = {"lgamma": ("lgammaf", "lgamma", 1), "erf": ("erff", "erf", 1),
         "erfc": ("erfcf", "erfc", 1), "expm1": ("expm1f", "expm1", 1),
         "rsqrt": ("rsqrtf", "rsqrt", 1), "atan2": ("atan2f", "atan2", 2),
         "powt": ("powf", "pow", 2), "erfcx": ("erfcxf", "erfcx", 1),
         "erfinv": ("erfinvf", "erfinv", 1)}


def _math_helper(name: str) -> str:
    single, double, arity = _MATH[name]
    params = ", ".join(f"{{t}} {v}" for v in "ab"[:arity])
    args = ", ".join("ab"[:arity])
    return "".join(f"__device__ __forceinline__ {t} traced_{name}({params.format(t=t)}) "
                   f"{{ return {fn}({args}); }}\n"
                   for t, fn in (("float", single), ("double", double)))


_COMPARE = {"gt": ">", "lt": "<", "le": "<=", "ge": ">=", "eq": "==", "ne": "!="}


class _Emitter:
    def __init__(self, threads: int):
        self.threads = threads
        self.lines = []

    def emit(self, line: str):
        self.lines.append("    " + line)

    def loop(self, count: int, body: str, var: str = "i"):
        if count == 0:
            return
        self.emit(f"for (int {var} = threadIdx.x; {var} < {count}; {var} += {self.threads}) "
                  f"{{ {body}}}")

    def lane_sum(self, out: Ref, count: int, decl: str, term: str, finish: str = "{}"):
        """out[0] = finish(Σ_i term(i)) over i < count: strided partials, a
        lane sum."""
        self.emit("{")
        self.emit("  Real acc[1] = {Real(0)};")
        self.loop(count, f"{decl}acc[0] += {term}; ")
        self.emit("  grp.sum(acc);")
        self.emit(f"  if (threadIdx.x == 0) s[{out.offset}] = {finish.format('acc[0]')};")
        self.emit("}")

    def op(self, op: Op):
        out = op.out
        self.emit(f"// {op.source}: {op.kind} {op.name} -> {out.shape} at {out.offset}")
        if op.kind == "ew":
            decl, oc = _coords(out.shape)
            x = [_broadcast(r, oc) for r in op.args]
            if op.name == "pow":
                body = f"{decl}const Real a = {x[0]}; s[{out.offset} + i] = {_ew_expr(op, x)}; "
            else:
                body = f"{decl}s[{out.offset} + i] = {_ew_expr(op, x)}; "
            self.loop(out.numel, body)
        elif op.kind in ("sum", "lse", "mean", "norm", "max", "min", "prod"):
            self.reduce(op)
        elif op.kind == "arg":  # one output element per thread: the first extreme's index
            (src,), (dims,) = op.args, op.params
            if not dims:
                self.loop(1, f"s[{out.offset}] = Real(0); ")
            else:
                (red,) = dims
                decl, _, _, coords = _reduced(src.shape, dims)
                beats = "v > top" if op.name == "max" else "v < top"
                first = _load(src, ["0" if c == "r" else c for c in coords])
                self.loop(out.numel,
                          f"{decl}int at = 0; Real top = {first}; "
                          f"for (int r = 1; r < {src.shape[red]}; "
                          f"++r) {{ const Real v = {_load(src, coords)}; if (!isnan(top) && "
                          f"(isnan(v) || {beats})) {{ top = v; at = r; }} }} "
                          f"s[{out.offset} + i] = Real(at); ")
        elif op.kind == "pick":  # the source where the coordinate is the index, else the base
            base, index, src = op.args
            (dim,) = op.params
            decl, oc = _coords(out.shape)
            self.loop(out.numel, f"{decl}s[{out.offset} + i] = {oc[dim]} == "
                                 f"int({_broadcast(index, oc)}) ? {_broadcast(src, oc)} : "
                                 f"{_broadcast(base, oc)}; ")
        elif op.kind == "tril":
            decl, oc = _coords(out.shape)
            keep = "<=" if op.name == "tril" else ">="
            self.loop(out.numel, f"{decl}s[{out.offset} + i] = {oc[-1]} - {oc[-2]} {keep} "
                                 f"{op.params[0]} ? {_load(op.args[0], oc)} : Real(0); ")
        elif op.kind in ("chol", "trsm", "slogdet", "solve"):
            self.linalg(op)
        elif op.kind == "mv":  # M v, or M V: one output element per thread
            M, v = op.args
            k = M.shape[1]
            decl, oc = _coords(out.shape)
            rhs = _load(v, ["j"] if len(v.shape) == 1 else ["j", oc[1]])
            self.loop(out.numel, f"{decl}Real acc = Real(0); for (int j = 0; j < {k}; ++j) "
                                 f"acc = acc + {_load(M, [oc[0], 'j'])} * {rhs}; "
                                 f"s[{out.offset} + i] = acc; ")
        elif op.kind == "dot":
            u, v = op.args
            self.lane_sum(out, u.numel, "", f"{_load(u, ['i'])} * {_load(v, ['i'])}")
        elif op.kind == "scatter":
            dim, start, step, count = op.params
            decl, oc = _coords(out.shape)
            inner = list(oc)
            inner[dim] = "kk"
            body = (f"{decl}const int k = {oc[dim]} - {start}; "
                    f"const bool in = k >= 0 && k % {step} == 0 && k / {step} < {count}; "
                    f"const int kk = in ? k / {step} : 0; "
                    f"s[{out.offset} + i] = in ? {_load(op.args[0], inner)} : Real(0); ")
            self.loop(out.numel, body)
        elif op.kind in ("cumsum", "cumprod"):  # one row per thread, in index order
            (src,), (dim,) = op.args, op.params
            rows = out.numel // out.shape[dim]
            count = out.shape[dim]
            decl = ""
            if len(out.shape) == 1:
                at, where = ["k"], "k"
            elif len(out.shape) == 2:
                at = ["i", "k"] if dim == 1 else ["k", "i"]
                where = f"i * {out.shape[1]} + k" if dim == 1 else f"k * {out.shape[1]} + i"
            else:  # the row's coordinates from i, the other dims' in order
                other = [d for d in range(3) if d != dim]
                decl, ci = _coords([out.shape[d] for d in other], "i")
                at = [ci[other.index(d)] if d != dim else "k" for d in range(3)]
                where = " + ".join(f"{c} * {st}" for c, st in
                                   zip(at, _contiguous_strides(out.shape)))
            if op.kind == "cumsum":
                start, step = "Real(0)", f"acc += {_load(src, at)};"
            else:
                start, step = "Real(1)", f"acc = acc * {_load(src, at)};"
            self.loop(rows, f"{decl}Real acc = {start}; for (int k = 0; k < {count}; ++k) "
                            f"{{ {step} s[{out.offset} + {where}] = acc; }} ")
        elif op.kind == "gather":
            (src,), (table,) = op.args, op.params
            base = "s" if src.kind == "lane" else f"c{src.index}"
            self.loop(out.numel, f"s[{out.offset} + i] = {base}[t{table}[i]]; ")
        elif op.kind == "put":
            (start, values), (ptr, src, accumulate, _) = op.args, op.params
            decl, oc = _coords(out.shape)
            value = (_lit(values.value) if values.kind == "lit"
                     else f"{'s' if values.kind == 'lane' else f'c{values.index}'}[t{src}[k]]")
            if accumulate:
                walk = (f"for (int k = t{ptr}[i]; k < t{ptr}[i + 1]; ++k) "
                        f"acc = acc + {value}; ")
            else:  # the last source wins
                walk = f"{{ const int k = t{ptr}[i + 1] - 1; if (k >= t{ptr}[i]) acc = {value}; }} "
            decl = "" if start.kind == "lit" else decl
            self.loop(out.numel, f"{decl}Real acc = {_load(start, oc)}; {walk}"
                                 f"s[{out.offset} + i] = acc; ")
        elif op.kind == "cat":
            (dim,) = op.params
            strides, start = _contiguous_strides(out.shape), 0
            for ref in op.args:
                decl, ic = _coords(ref.shape)
                full = [c if d != dim else f"({c} + {start})" for d, c in enumerate(ic)]
                target = " + ".join(f"{c} * {st}" for c, st in zip(full, strides))
                self.loop(ref.numel, f"{decl}s[{out.offset} + {target}] = {_load(ref, ic)}; ")
                start += ref.shape[dim]
        else:
            raise AssertionError(op.kind)
        self.emit("grp.sync();")

    def linalg(self, op: Op):
        """A factorization or solve of one m x m matrix per lane: its input
        copied into its slots (the factor's or the work copy's, and the
        right-hand sides into the output), a barrier, then the lane group's
        device function (csrc/resident_linalg.cuh), which ends on one."""
        out, A = op.out, op.args[0]
        m = A.shape[0]
        if op.kind == "chol":  # the lower triangle, factorized in place
            self.loop(m * m, f"const int i0 = i / {m}; const int i1 = i % {m}; "
                             f"s[{out.offset} + i] = i1 <= i0 ? {_load(A, ['i0', 'i1'])} : "
                             "Real(0); ")
            self.emit("grp.sync();")
            self.emit(f"qnm::lane_cholesky(grp, {m}, s + {out.offset});")
            return
        if op.kind in ("slogdet", "solve"):
            work = op.params[0]
            self.loop(m * m, f"const int i0 = i / {m}; const int i1 = i % {m}; "
                             f"s[{work} + i] = {_load(A, ['i0', 'i1'])}; ")
        B = op.args[1] if op.kind != "slogdet" else None
        if B is not None:  # the right-hand sides, solved in place
            decl, oc = _coords(B.shape)
            self.loop(B.numel, f"{decl}s[{out.offset} + i] = {_load(B, oc)}; ")
        self.emit("grp.sync();")
        if op.kind == "slogdet":
            self.emit(f"qnm::lane_slogdet(grp, {m}, s + {work}, s + {out.offset});")
        elif op.kind == "solve":
            self.emit(f"qnm::lane_solve(grp, {m}, {_columns(out)}, s + {work}, s + {out.offset});")
        else:
            upper, unit = op.params
            base = "s" if A.kind == "lane" else f"c{A.index}"
            self.emit(f"qnm::lane_trsm<{str(upper).lower()}, {str(unit).lower()}>(grp, {m}, "
                      f"{_columns(out)}, {base} + {A.offset}, {A.strides[0]}, {A.strides[1]}, "
                      f"s + {out.offset});")

    def reduce(self, op: Op):
        out, (src,), (dims,) = op.out, op.args, op.params
        lse = op.kind == "lse"
        if not dims:  # a reduction of a scalar over no dim is the scalar (a norm its |.|)
            value = _load(src, [])
            self.loop(1, f"s[{out.offset}] = {f'fabs({value})' if op.kind == 'norm' else value}; ")
            return
        if op.kind in ("max", "min"):
            self.extreme(op, dims)
            return
        if op.kind == "prod":
            self.product(op, dims)
            return
        # the mean's 1 / count and the 2-norm's square root (torch's MeanOps and
        # NormTwoOps), on the sum of the terms or of their squares
        count = math.prod(src.shape[d] for d in dims)
        finish = {"mean": f"{{}} * (Real(1) / Real({count}))", "norm": "sqrt({})"}.get(
            op.kind, "{}")
        if len(dims) == len(src.shape):  # to one value
            decl, ic = _coords(src.shape)
            term = _square(op, _load(src, ic))
            if not lse:
                self.lane_sum(out, src.numel, decl, term, finish)
                return
            # torch.logsumexp: the max (NaN wins), an infinite max shifts by 0
            self.emit("{")
            self.emit("  Real top = -Real(INFINITY);")
            self.emit(f"  for (int i = 0; i < {src.numel}; ++i) {{ {decl}const Real v = {term}; "
                      "top = isnan(top) || top >= v ? top : v; }")
            self.emit("  const Real shift = isinf(top) ? Real(0) : top;")
            self.emit("  Real acc[1] = {Real(0)};")
            self.loop(src.numel, f"{decl}acc[0] += qnm::exp_of({term} - shift); ")
            self.emit("  grp.sum(acc);")
            self.emit(f"  if (threadIdx.x == 0) s[{out.offset}] = qnm::log_of(acc[0]) + shift;")
            self.emit("}")
            return
        # over some dims: one output element per thread, in order
        decl_i, decl_r, count, coords = _reduced(src.shape, dims)
        term = _square(op, _load(src, coords))
        if not lse:
            self.loop(out.numel, f"{decl_i}Real acc = Real(0); for (int r = 0; r < {count}; ++r) "
                                 f"{_scoped(decl_r, f'acc += {term};')} "
                                 f"s[{out.offset} + i] = {finish.format('acc')}; ")
            return
        self.loop(out.numel,
                  f"{decl_i}Real top = -Real(INFINITY); for (int r = 0; r < {count}; ++r) "
                  f"{{ {decl_r}const Real v = {term}; top = isnan(top) || top >= v ? top : v; }} "
                  f"const Real shift = isinf(top) ? Real(0) : top; Real acc = Real(0); "
                  f"for (int r = 0; r < {count}; ++r) "
                  f"{_scoped(decl_r, f'acc += qnm::exp_of({term} - shift);')} "
                  f"s[{out.offset} + i] = qnm::log_of(acc) + shift; ")


    def extreme(self, op: Op, dims):
        """A max or min over ``dims`` (NaN wins, as torch's): to one value,
        strided partials per thread and the lane group's butterfly
        (`traced_lane_pick`); over one of two dims, one output element per
        thread, in order."""
        out, (src,) = op.out, op.args
        wins = "true" if op.kind == "max" else "false"
        start = "-Real(INFINITY)" if op.kind == "max" else "Real(INFINITY)"
        if len(dims) == len(src.shape):
            decl, ic = _coords(src.shape)
            self.emit("{")
            self.emit(f"  Real acc = {start};")
            self.loop(src.numel, f"{decl}acc = traced_pick<{wins}>(acc, {_load(src, ic)}); ")
            self.emit(f"  acc = traced_lane_pick<{wins}>(grp, acc);")
            self.emit(f"  if (threadIdx.x == 0) s[{out.offset}] = acc;")
            self.emit("}")
            return
        decl_i, decl_r, count, coords = _reduced(src.shape, dims)
        pick = f"acc = traced_pick<{wins}>(acc, {_load(src, coords)});"
        self.loop(out.numel, f"{decl_i}Real acc = {start}; for (int r = 0; r < {count}; ++r) "
                             f"{_scoped(decl_r, pick)} s[{out.offset} + i] = acc; ")

    def product(self, op: Op, dims):
        """A product over ``dims``: to one value on one thread, over some
        dims one output element per thread, each in index order."""
        out, (src,) = op.out, op.args
        if len(dims) == len(src.shape):
            decl, kc = _coords(src.shape, "k")
            self.loop(1, f"Real acc = Real(1); for (int k = 0; k < {src.numel}; ++k) "
                         f"{_scoped(decl, f'acc = acc * {_load(src, kc)};')} "
                         f"s[{out.offset}] = acc; ")
            return
        decl_i, decl_r, count, coords = _reduced(src.shape, dims)
        self.loop(out.numel, f"{decl_i}Real acc = Real(1); for (int r = 0; r < {count}; ++r) "
                             f"{_scoped(decl_r, f'acc = acc * {_load(src, coords)};')} "
                             f"s[{out.offset} + i] = acc; ")


def _square(op: Op, term: str) -> str:
    """A reduction's term: a 2-norm sums the squares of its elements."""
    return f"{term} * {term}" if op.kind == "norm" else term


def _graph_body(graph: Graph, threads: int) -> str:
    em = _Emitter(threads)
    for op in graph.ops:
        em.op(op)
    return "\n".join(em.lines)


_PRELUDE = r"""
// torch's CUDA formulas (BinaryMiscOpsKernels.cu, LogSigmoid.cu)
__device__ __forceinline__ Real traced_logaddexp(Real a, Real b) {
  if (isinf(a) && a == b) return a;
  const Real m = a > b ? a : b;
  return m + qnm::log1p_of(qnm::exp_of(-fabs(a - b)));
}
__device__ __forceinline__ Real traced_log_sigmoid(Real a) {
  const Real lo = a < Real(0) ? a : Real(0);
  return lo - qnm::log1p_of(qnm::exp_of(-fabs(a)));
}
__device__ __forceinline__ Real traced_log_sigmoid_backward(Real g, Real a) {
  const bool neg = a < Real(0);
  const Real max_deriv = neg ? Real(1) : Real(0);
  const Real sign = neg ? Real(1) : -Real(1);
  const Real z = qnm::exp_of(-fabs(a));
  return g * (max_deriv - sign * (z / (Real(1) + z)));
}
__device__ __forceinline__ float traced_tanh(float a) { return tanhf(a); }
__device__ __forceinline__ double traced_tanh(double a) { return tanh(a); }
"""


# torch's CUDA formulas of the functions that take more than an expression
# (ActivationSoftplusKernel.cu, MaxMinElementwiseKernel.cu, the clamp of
# UnaryOpsKernel.cu), written into a unit only where its graphs use them
_HELPERS = {
    "softplus": r"""__device__ __forceinline__ Real traced_softplus(Real a, Real beta,
                                               Real threshold) {
  return a * beta > threshold ? a : qnm::log1p_of(qnm::exp_of(a * beta)) / beta;
}
""",
    "softplus_backward": r"""__device__ __forceinline__ Real traced_softplus_backward(
    Real g, Real a, Real beta, Real threshold) {
  const Real z = qnm::exp_of(a * beta);
  return a * beta > threshold ? g : g * z / (z + Real(1));
}
""",
    "maximum": r"""__device__ __forceinline__ Real traced_maximum(Real a, Real b) {  // NaN wins
  return isnan(a) ? a : (isnan(b) ? b : (a < b ? b : a));
}
""",
    "minimum": r"""__device__ __forceinline__ Real traced_minimum(Real a, Real b) {  // NaN wins
  return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a));
}
""",
    "clamp": r"""// NaN stays NaN
__device__ __forceinline__ Real traced_clamp(Real a, Real lo, Real hi) {
  const Real up = a < lo ? lo : a;
  return hi < up ? hi : up;
}
""",
    # torch's calc_digamma (native/cuda/Math.cuh): the reflection below 0, the
    # recurrence up to 10, the asymptotic series; ±inf at ∓0, NaN at the poles
    "digamma": r"""__device__ __forceinline__ Real traced_digamma(Real in) {
  const double kPi = 3.14159265358979323846;
  const Real kPsi10 = Real(2.25175258906672110764);
  Real x = in;
  if (x == Real(0)) return signbit(x) ? Real(INFINITY) : -Real(INFINITY);
  const bool x_is_integer = x == trunc(x);
  Real result = Real(0);
  if (x < Real(0)) {
    if (x_is_integer) return Real(NAN);
    double q;
    const double r = modf(double(x), &q);
    result = Real(-kPi / tan(kPi * r));
    x = Real(1) - x;
  }
  while (x < Real(10)) {
    result -= Real(1) / x;
    x += Real(1);
  }
  if (x == Real(10)) return result + kPsi10;
  Real y = Real(0);
  if (x < Real(1.0e17)) {
    const Real z = Real(1) / (x * x);
    Real p = Real(0);
    p = p * z + Real(8.33333333333333333333E-2);
    p = p * z + Real(-2.10927960927960927961E-2);
    p = p * z + Real(7.57575757575757575758E-3);
    p = p * z + Real(-4.16666666666666666667E-3);
    p = p * z + Real(3.96825396825396825397E-3);
    p = p * z + Real(-8.33333333333333333333E-3);
    p = p * z + Real(8.33333333333333333333E-2);
    y = z * p;
  }
  return qnm::log_of(x) - Real(0.5) / x - y + result;
}
""",
    # torch's xlogy (BinaryMiscOpsKernels.cu): NaN where y is, 0 where x is 0
    "xlogy": r"""__device__ __forceinline__ Real traced_xlogy(Real x, Real y) {
  if (isnan(y)) return Real(NAN);
  if (x == Real(0)) return Real(0);
  return x * qnm::log_of(y);
}
""",
    # torch's calc_log_ndtr (native/Math.h), with CUDA's erfcx
    "log_ndtr": r"""__device__ __forceinline__ Real traced_log_ndtr(Real x) {
  const Real t = x * Real(0.707106781186547524400844362104849039);
  if (x < Real(-1)) return qnm::log_of(traced_erfcx(-t) / Real(2)) - t * t;
  return qnm::log1p_of(-traced_erfc(t) / Real(2));
}
""",
    # binary_cross_entropy_with_logits as torch's autograd and vmap decompose
    # it, m = max(-x, 0) (NaN kept): (1 - y)·x + m + log(exp(-m) + exp(-x - m))
    "bce_logits": r"""__device__ __forceinline__ Real traced_bce_logits(Real x, Real y) {
  const Real m = -x < Real(0) ? Real(0) : -x;
  return (Real(1) - y) * x + m + qnm::log_of(qnm::exp_of(-m) + qnm::exp_of(-x - m));
}
""",
    # max / min, NaN winning (torch's MaxNanFunctor), and over the lane: the
    # lane group's butterfly, its partials exchanged as LaneGroup::sum's are
    "extreme": r"""template <bool kMax>
__device__ __forceinline__ Real traced_pick(Real a, Real b) {
  return isnan(a) ? a : (isnan(b) ? b : ((kMax ? a < b : b < a) ? b : a));
}
template <bool kMax, bool kOneWarp>
__device__ __forceinline__ Real traced_lane_pick(qnm::LaneGroup<Real, kOneWarp>& grp, Real v) {
  if constexpr (kOneWarp) __syncwarp();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = traced_pick<kMax>(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if constexpr (!kOneWarp) {
    const int nw = blockDim.x >> 5;
    Real* buf = grp.red + grp.parity * (qnm::kMaxSums * qnm::kMaxLaneWarps);
    if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
    __syncthreads();
    v = buf[0];
    for (int w = 1; w < nw; ++w) v = traced_pick<kMax>(v, buf[w]);
    grp.parity ^= 1;
  }
  return v;
}
""",
}


def _helpers(traced: TracedObjective) -> str:
    """The helpers the graphs use: CUDA's functions as overload pairs, then
    torch's formulas (a graph of the earlier ops uses neither new kind, so its
    text is what it was)."""
    ops = [op for g in (traced.vag, traced.val) for op in g.ops]
    used = {op.name for op in ops if op.kind == "ew"}
    used |= {"extreme" for op in ops if op.kind in ("max", "min")}
    if "log_ndtr" in used:
        used |= {"erfc", "erfcx"}
    return ("".join(_math_helper(name) for name in _MATH if name in used)
            + "".join(text for name, text in _HELPERS.items() if name in used))


def generate(traced: TracedObjective) -> str:
    """The CUDA translation unit of ``traced``'s objective and B3 around it
    (see the module docstring)."""
    n = traced.n
    real = {torch.float32: "float", torch.float64: "double"}[traced.dtype]
    threads = 32 * lane_warps(n)
    one_warp = "true" if threads == 32 else "false"
    slots = traced.extra_values
    consts = max(1, len(traced.consts))
    n_consts, n_tables = len(traced.consts), len(traced.tables)
    vag, val = traced.vag, traced.val
    const_params = "".join(f", const Real* __restrict__ c{i}" for i in range(n_consts))
    const_params += "".join(f", const int* __restrict__ t{i}" for i in range(n_tables))
    const_args = "".join(f", c[{i}]" for i in range(n_consts))
    const_args += "".join(f", t[{i}]" for i in range(n_tables))
    tables = (f"  const int* __restrict__ t[{n_tables}];\n" if n_tables else "")
    take_tables = (f"  for (int i = 0; i < {n_tables}; ++i) "
                   f"obj.t[i] = static_cast<const int*>(consts[{n_consts} + i]);\n"
                   if n_tables else "")
    table_count = f", {n_tables} int32 index tables" if n_tables else ""
    table_note = ", t<i> the\n// index tables" if n_tables else ""
    table_ptrs = (f",\n// then consts[{n_consts}..{n_consts + n_tables}) the index tables', int32"
                  if n_tables else "")
    return f"""// Generated by quasinewtonmethods_jl_tpu_torch/ops/kernels/objective_codegen.py
// from a traced objective: n = {n}, {real}, {len(traced.consts)} constants,
// {len(vag.ops)} ops for the value and gradient, {len(val.ops)} for a trial value,
// {slots} values of scratch per lane{table_count}. B3 (resident_solve.cuh) around it.

#include "resident_solve.cuh"

namespace {{

using Real = {real};
constexpr int kN = {n};
constexpr int kSlots = {slots};
{_PRELUDE}{_helpers(traced)}
// The two graphs, each one function that the kernel calls (not inlined:
// a trial's evaluation has two call sites, and the kernel's size and its
// build time stay those of one copy). The lane's scratch s holds the point
// at 0..n-1 and one slot per op's output; c<i> are the constants{table_note}.
template <bool kOneWarp>
__device__ __noinline__ void traced_value_and_grad(qnm::LaneGroup<Real, kOneWarp>& grp,
                                                   Real* __restrict__ s{const_params}) {{
{_graph_body(vag, threads)}
}}

template <bool kOneWarp>
__device__ __noinline__ void traced_value(qnm::LaneGroup<Real, kOneWarp>& grp,
                                          Real* __restrict__ s{const_params}) {{
{_graph_body(val, threads)}
}}

// The objective (the contract of resident_objectives.cuh), the update's
// column ownership.
struct TracedObjective {{
  const Real* __restrict__ c[{consts}];
{tables}
  static constexpr int kOwned = 2;
  size_t extra_values(int) const {{ return kSlots; }}
  template <bool kOneWarp>
  __device__ __forceinline__ void prepare(qnm::LaneGroup<Real, kOneWarp>&, int, Real*) const {{}}

  __device__ __forceinline__ qnm::Owned<2> owned(int n) const {{ return qnm::owned_columns(n); }}

  // terms: the value, on thread 0 only
  template <bool kOneWarp>
  __device__ __forceinline__ void value_and_grad(qnm::LaneGroup<Real, kOneWarp>& grp,
                                                 const qnm::Owned<2>& own, int, Real* s,
                                                 const Real (&x)[2], Real (&g)[2], Real& terms,
                                                 Real&) const {{
#pragma unroll
    for (int e = 0; e < 2; ++e) {{
      if (own.has[e]) s[own.idx[e]] = x[e];
    }}
    grp.sync();
    traced_value_and_grad(grp, s{const_args});
#pragma unroll
    for (int e = 0; e < 2; ++e) g[e] = s[{vag.grad.offset} + own.idx[e]];
    if (threadIdx.x == 0) terms = s[{vag.value.offset}];
  }}

  __device__ __forceinline__ Real value(Real terms, Real, int) const {{ return terms; }}

  template <bool kOneWarp>
  __device__ __forceinline__ Real value_along(qnm::LaneGroup<Real, kOneWarp>& grp,
                                              const qnm::Owned<2>& own, int, Real* s,
                                              const Real (&x)[2], const Real (&d)[2],
                                              Real alpha) const {{
#pragma unroll
    for (int e = 0; e < 2; ++e) {{
      if (own.has[e]) s[own.idx[e]] = x[e] + alpha * d[e];
    }}
    grp.sync();
    traced_value(grp, s{const_args});
    return s[{val.value.offset}];
  }}
}};

// The one lane-group variant n needs.
auto traced_launch() {{
  const auto kernel = &resident_solve_kernel<Real, {one_warp}, TracedObjective>;
  return qnm::lane_launch(kN, kernel, kernel, smem_bytes(kN, sizeof(Real), kSlots));
}}

}}  // namespace

extern "C" {{

// The solve (cudaGetLastError() after the launch; 0 = launched), with
// consts[0..{len(traced.consts)}) the constants' device pointers, contiguous, in Real{table_ptrs}.
int qnm_traced_solve(QNM_SOLVE_ARGS(Real), const void* const* consts, void* stream) {{
  if (n != kN) return int(cudaErrorInvalidValue);
  TracedObjective obj{{}};
  for (int i = 0; i < {len(traced.consts)}; ++i) obj.c[i] = static_cast<const Real*>(consts[i]);
{take_tables}  return launch_with<Real>(traced_launch(), X0, X, G, G_old, step, B, fun, status, iterations,
                           n_fev, n_gev, n_resets, fresh, stall, batch, n,
                           Params<Real>{{tol, c1, rho_hi, rho_lo, eps, sqrttol, budget,
                                        max_iterations, stall_limit, order, h0_scale}},
                           obj, stream);
}}

int qnm_traced_occupancy(int* regs, int* threads, int* blocks_per_sm) {{
  return qnm::lane_occupancy(traced_launch(), regs, threads, blocks_per_sm);
}}

const char* qnm_cuda_error_string(int code) {{ return cudaGetErrorString(cudaError_t(code)); }}

}}  // extern "C"
"""
