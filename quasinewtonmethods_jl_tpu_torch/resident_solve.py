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

Objective contract: any objective whose value and gradient trace to B3's
op table, as in the JAX engine, which traces any jnp objective into its
kernel body with its closed-over arrays hoisted into kernel inputs. The
port's kernel takes its objective as a template argument, so it has two
routes:
  * seven objectives written by hand (csrc/resident_objectives.cuh), taken
    first, by identity or by exact type: the split Rosenbrock of
    models/rosenbrock.py (`rosenbrock_logdensity`, with
    ``value_and_grad_fn`` None or `rosenbrock_value_and_grad`, or a
    `models.Rosenbrock` instance), Neal's funnel `models.funnel_logdensity`
    (``value_and_grad_fn`` None), and instances of
    `models.IllConditionedQuadratic`, `LogisticRegressionMAP`,
    `PoissonRegressionMAP`, `GaussianMixture` (at most 8 components) and
    `AR1DriftMAP` (``value_and_grad_fn`` None); their data go to ``x0s``'s
    device and dtype once per solve;
  * every other objective is traced (ops/kernels/objective_trace.py): its
    value and gradient, resolved as the fleet engine resolves them
    (``value_and_grad_fn``, else ``logdensity_and_gradient``, else
    ``torch.func``; trials take the log-density), are traced for one lane
    on fake tensors, lowered to a graph of static shapes whose closed-over
    tensors become constants on ``x0s``'s device, and generated as CUDA
    (ops/kernels/objective_codegen.py), built with nvcc at first use. A
    bound method, a lambda around a model, a subclass, a user
    ``value_and_grad_fn`` and any inline function of the table's ops run
    there, and so do `transforms.py`'s maps and the models built on them
    (`models.HierarchicalRegression` through `transform_objective`).
    The table holds arithmetic and the usual elementwise functions (exp,
    log, log1p, sqrt, abs, sin, cos, tanh, sigmoid, softplus, maximum,
    minimum, clamp), comparisons, logical ops, ``where`` and
    ``masked_fill``, sums, means, logsumexp, max / min and 2-norms, matrix
    products, index maps with constant indices, and per lane the Cholesky
    factorization, triangular solves, ``logdet`` / ``slogdet`` and
    ``solve`` of an m x m matrix (a Gaussian-process likelihood from many
    starts runs in one launch); a failed factorization gives NaN on its
    lane, as in JAX, and the plain version runs such an objective under
    ops/kernels/objective_trace.py :: `in_band_linalg` to do the same. It
    also holds what the log-densities of ``torch.distributions`` reach
    (lgamma and digamma, xlogy, erf / erfc / log_ndtr, expm1, reciprocal,
    rsqrt, atan2, pow with a tensor exponent, BCE with logits, a support
    mask's cast), so the Normal, Cauchy, Laplace, LogNormal, Exponential,
    HalfNormal, HalfCauchy, Student-t, negative binomial, Gamma, Beta (of
    scalar parameters), Dirichlet, Poisson, binomial, Weibull, Uniform and
    Bernoulli-with-logits families trace, built with ``validate_args=False``
    (their validation is a data-dependent branch, which neither the trace nor
    the fleet engine's ``torch.func`` takes; or call
    ``torch.distributions.Distribution.set_default_validate_args(False)``).
    Since then softmax and log-softmax, ``gather`` and ``scatter_add`` at
    constant indices, the factories that read only a shape (``full_like``,
    ``new_ones``, ``new_full``, ``full``), ``prod``, ``cumprod``, ``erfinv``
    and per-lane values of rank 3 (``bmm``, and the per-lane linear algebra
    over a leading batch dim) trace too, so softmax regression
    (``D.Categorical(logits=)``), ``D.MixtureSameFamily``, stick-breaking
    weights, ``D.MultivariateNormal``, ``D.Gumbel`` and ``D.InverseGamma``
    run there. Data-dependent control flow (``torch.cond``,
    ``torch.while_loop``) is refused; a static Python loop traces by
    unrolling (JAX's ``fori_loop`` and forward ``scan``). Outside the table
    still: ``polygamma``, a boolean-mask write (``D.Multinomial``).
    The entry point keeps its traces, the counterpart of the jit cache of
    JAX's ``_optimize_batched_resident_jit``, whose objective is a static
    argument: keyed by the objective and ``value_and_grad_fn`` (by their
    own ``==`` and hash, as JAX's static arguments are) and by n, dtype and
    device, the last `TRACE_CACHE_SIZE` of them, each with its built
    library. So a second call with the same function or bound method
    traces nothing, while a new lambda, another n or another dtype traces
    again. Unlike JAX's jit, a kept trace does not go stale where the
    plain version would see new data: it also keeps every tensor reachable
    from the objective (a bound method's object, a function's closure and
    defaults, a partial's arguments, attributes, the items of lists, tuples
    and dicts) with its version counter, and the objective is traced again
    when one of them was replaced or written in place, so B3 and the plain
    version read the same data. A tensor reached only through a module's
    globals is read at the first solve (pass it through the objective, or
    pass `trace_objective`'s result as ``obj``, which is never traced
    again).
An objective that does not trace to the table (an op outside it, a
per-lane value of rank > 3, data-dependent control flow or shapes,
``.item()``, random ops, in-place writes, a constant in another floating
dtype than ``x0s``, a factorization's pivots or info read) raises
ValueError on every device, naming the op and
the user's line, and points to `optimize_batched_fused`, which takes any
objective; nothing falls back to the plain version or to the fleet engine
unasked.

The JAX engine's ``block_batch``, ``interpret``, ``rewrite_dots`` and
``ops/dot_rewrite.py`` exist only for Mosaic and have no counterpart here
(``mv`` stays ``mv``); `_hoist_consts` is the trace's constants.
"""

from __future__ import annotations

import functools
import types
from collections import OrderedDict
from typing import Callable, Optional

import torch

from .models.funnel import funnel_logdensity
from .models.rosenbrock import Rosenbrock, rosenbrock_logdensity, rosenbrock_value_and_grad
from .ops.kernels.objective_trace import TracedObjective, trace_objective
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
    "trace_objective",
]


def _is_rosenbrock(obj, value_and_grad_fn) -> bool:
    if value_and_grad_fn not in (None, rosenbrock_value_and_grad):
        return False
    return obj is rosenbrock_logdensity or type(obj) is Rosenbrock


# The traces the entry point keeps (see the module docstring), oldest first:
# key -> (TracedObjective, the data it was traced from).
TRACE_CACHE_SIZE = 32
_TRACES: OrderedDict = OrderedDict()
# objects walked at most for one objective's data; beyond, it is traced every call
_DATA_WALK_LIMIT = 4096
_LEAVES = (type, types.ModuleType, str, bytes, int, float, complex, bool,
           torch.dtype, torch.device)


def _objective_data(*roots) -> Optional[tuple]:
    """Every tensor reachable from ``roots`` through a bound method's
    object, a function's closure and defaults, a partial's arguments, an
    object's attributes and slots and the items of lists, tuples, sets and
    dicts (not a module's globals), each with its version counter; None
    where the walk passes `_DATA_WALK_LIMIT` objects."""
    found, seen, stack = [], set(), list(roots)
    while stack:
        x = stack.pop()
        if x is None or isinstance(x, _LEAVES) or id(x) in seen:
            continue
        seen.add(id(x))
        if len(seen) > _DATA_WALK_LIMIT:
            return None
        if isinstance(x, torch.Tensor):
            found.append((x, x._version))
        elif isinstance(x, types.MethodType):
            stack += [x.__self__, x.__func__]
        elif isinstance(x, types.FunctionType):
            for cell in x.__closure__ or ():
                try:
                    stack.append(cell.cell_contents)
                except ValueError:  # an empty cell
                    pass
            stack += [*(x.__defaults__ or ()), *(x.__kwdefaults__ or {}).values()]
        elif isinstance(x, functools.partial):
            stack += [x.func, *x.args, *x.keywords.values()]
        elif isinstance(x, (list, tuple, set, frozenset)):
            stack += list(x)
        elif isinstance(x, dict):
            stack += list(x.values())
        else:
            stack += list(getattr(x, "__dict__", {}).values())
            for cls in type(x).__mro__:
                slots = getattr(cls, "__slots__", ())
                for name in (slots,) if isinstance(slots, str) else slots:
                    stack.append(getattr(x, name, None))
    return tuple(found)


def _same_data(kept: tuple, now: Optional[tuple]) -> bool:
    return now is not None and len(kept) == len(now) and all(
        a is b and va == vb for (a, va), (b, vb) in zip(kept, now))


def _kept_trace(obj, value_and_grad_fn, x0s: torch.Tensor) -> TracedObjective:
    """``obj`` traced for ``x0s``'s lanes, from the kept traces where one
    matches and its objective's data are the same tensors at the same
    versions (an unhashable objective, or one whose data walk is too long,
    is traced on every call)."""
    key = (obj, value_and_grad_fn, x0s.shape[1], x0s.dtype, x0s.device)
    try:
        kept = _TRACES.get(key)
    except TypeError:
        return trace_objective(obj, value_and_grad_fn, x0s)
    data = _objective_data(obj, value_and_grad_fn)
    if kept is not None and _same_data(kept[1], data):
        _TRACES.move_to_end(key)
        return kept[0]
    traced = trace_objective(obj, value_and_grad_fn, x0s)
    if data is None:
        _TRACES.pop(key, None)
        return traced
    _TRACES[key] = (traced, data)
    _TRACES.move_to_end(key)
    while len(_TRACES) > TRACE_CACHE_SIZE:
        _TRACES.popitem(last=False)
    return traced


def _kernel_objective(obj, value_and_grad_fn, x0s: torch.Tensor):
    """The objective B3 evaluates: None for the split Rosenbrock,
    `funnel_logdensity`, a shallow copy of a hand-written instantiation's
    model with its data on ``x0s``'s device and dtype, or else the
    objective traced for ``x0s`` (`trace_objective`, which raises
    ValueError for an objective that does not trace to the op table), kept
    for the next call (`_kept_trace`)."""
    if _is_rosenbrock(obj, value_and_grad_fn):
        return None
    if value_and_grad_fn is None and (obj is funnel_logdensity or type(obj) in KERNEL_MODELS):
        return objective_on(obj, x0s)
    if isinstance(obj, TracedObjective) and value_and_grad_fn is None:
        return obj  # traced once by the caller, for solves of one shape
    return _kept_trace(obj, value_and_grad_fn, x0s)


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
      obj: a log-density (a callable or a model with ``logdensity``)
        whose value and gradient trace to B3's op table (see the module
        docstring); the seven hand-written instantiations are taken first.
        An objective that does not trace raises ValueError.
      x0s: (batch, n) float32/float64 starting points. A tensor's device is
        where the solve runs; anything else goes to the CUDA card
        (`as_device_tensor`).
      kernel: 'cuda' (B3, CUDA tensors only; raises where one lane does not
        fit, see `resident_feasible`), 'torch' (the plain version, any
        device: the fleet engine with the plain update on the objective)
        or 'auto' (= 'cuda' on CUDA tensors, 'torch' on CPU). The trace runs
        on every device, so an objective that does not trace raises on
        the CPU too. A trace is kept for the next call with the same
        objective, n, dtype and device (see the module docstring).

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
