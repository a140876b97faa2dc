"""Multi-device layer — the PyTorch port of
``quasinewtonmethods_jl_tpu/parallel/mesh.py``, on ``torch.distributed``.

JAX runs one program over a mesh of devices and lets GSPMD place the
collectives. PyTorch runs one process per device (``torchrun``, or ranks
spawned by the caller; `distributed.initialize` joins them). The port keeps
JAX's contract, global in and global out: every rank calls an entry point
with the same global input, takes its shard of the sharded axis, runs the
unmodified engine on it under `utils.placement.placed` (the counterpart of
``with mesh:``), and returns the whole result, the same on every rank.

Two strategies, as in JAX:

  * **Data parallelism** (`optimize_batched_sharded`, `optimize_tr_sharded`,
    `optimize_cg_sharded`, `optimize_auglag_sharded`,
    `least_squares_sharded`, `sample_sharded`): the lanes (chains) are cut
    over a 'data' axis. Lanes never talk, so each rank runs its lanes and
    the per-lane results are all-gathered; what the engines reduce over the
    whole fleet (TR's inner-CG count, the Jacobi probes' key, the samplers'
    fleet adaptation) goes through the placement helpers, so a sharded run
    equals the unsharded run lane for lane.
  * **Parameter sharding** (`optimize_lbfgs_sharded`,
    `optimize_cg_model_sharded`, `optimize_tr_model_sharded`): ONE solve
    whose vector is cut over a 'model' axis. The solver's own O(n) state
    stays sharded; every reduction over n is a local partial plus an
    all-reduce (L-BFGS through its ``dot=`` / ``max_abs=`` hooks, CG and TR
    through the placement helpers), and the objective sees the all-gathered
    x and keeps its slice of the gradient.

Each rank computes on ``cuda:{local rank}`` (`distributed.local_device_index`)
under the entry points' device rule: a CPU tensor asks for the CPU, a CUDA
tensor moves to the rank's card, other input goes to it. A process with no
process group gets a one-device mesh.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from ..api import as_value_and_grad, as_value_fn
from ..lbfgs_solve import LBFGSResult, _lbfgs_loop, _result_from_state
from ..ops.linesearch import BackTracking
from ..solve import MAX_ITERATIONS_DEFAULT, STALL_LIMIT_DEFAULT, OptimizeResult
from ..state import init_lbfgs_state
from ..utils.device import as_device_tensor
from ..utils.placement import Axis, all_gather, all_reduce, placed
from .distributed import local_device_index

__all__ = [
    "Mesh",
    "make_mesh",
    "psum_dot",
    "optimize_batched_sharded",
    "optimize_lbfgs_sharded",
    "optimize_auglag_sharded",
    "optimize_cg_model_sharded",
    "optimize_cg_sharded",
    "optimize_tr_model_sharded",
    "optimize_tr_sharded",
    "least_squares_sharded",
    "sample_sharded",
]

_CURRENT = contextvars.ContextVar("quasinewtonmethods_mesh", default=None)


class Mesh:
    """Named axes over the ranks of the default process group, one process
    group per axis line. ``shape`` is ``{axis: size}`` as JAX's;
    ``devices`` the grid of ranks; ``device`` this rank's torch device.
    As a context manager it is the mesh `psum_dot` reduces over."""

    def __init__(self, names, sizes, ranks: np.ndarray, axes: dict, device):
        self.axis_names = tuple(names)
        self._sizes = tuple(sizes)
        self.devices = ranks
        self._axes = axes
        self.device = device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self._sizes))

    def axis(self, name: str) -> Axis:
        """This rank's view of axis ``name``."""
        if name not in self.axis_names:
            raise ValueError(f"mesh has no axis {name!r}; its axes are {self.axis_names}")
        if name not in self._axes:
            raise ValueError(f"rank {dist.get_rank()} is not on this mesh "
                             f"(ranks {self.devices.ravel().tolist()})")
        return self._axes[name]

    def index(self, name: str) -> int:
        """This rank's coordinate along axis ``name`` (``lax.axis_index``)."""
        return self.axis(name).index

    def psum(self, value: torch.Tensor, name: str) -> torch.Tensor:
        """``value`` summed over axis ``name`` (``lax.psum``)."""
        return all_reduce(value, self.axis(name), "sum")

    def __enter__(self):
        self._tokens = getattr(self, "_tokens", []) + [_CURRENT.set(self)]
        return self

    def __exit__(self, *exc):
        _CURRENT.reset(self._tokens.pop())

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """Build a Mesh from ``{'axis': size}`` over the default group's ranks
    (``devices``: the ranks to lay it over, in order; all of them by
    default). Every rank of the default group must call it, with the same
    arguments: each axis line is a new process group. Without a process
    group the one process is a one-device mesh."""
    names = tuple(axis_sizes)
    sizes = tuple(int(s) for s in axis_sizes.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    total = int(np.prod(sizes))
    if total > len(ranks):
        raise ValueError(
            f"mesh needs {total} devices, have {len(ranks)} "
            "(one process per device: start the ranks with torchrun, or join them with "
            "torch.distributed.init_process_group / parallel.distributed.initialize)"
        )
    grid = np.asarray(ranks[:total]).reshape(sizes)
    me = dist.get_rank() if dist.is_initialized() else 0
    axes = {}
    for a, name in enumerate(names):
        for line in np.moveaxis(grid, a, -1).reshape(-1, sizes[a]).tolist():
            # new_group is collective over the default group: every rank
            # creates every line's group, in the same order
            group = dist.new_group(line) if dist.is_initialized() else None
            if me in line:
                staged = group is not None and dist.get_backend(group) == "gloo"
                axes[name] = Axis(name, group, sizes[a], line.index(me), staged)
    device = (torch.device("cuda", local_device_index(me)) if torch.cuda.is_available()
              else torch.device("cpu"))
    return Mesh(names, sizes, grid, axes, device)


def psum_dot(axis_name: str, mesh: Optional[Mesh] = None) -> Callable:
    """dot(a, b) over a vector sharded along ``axis_name``: a local partial
    dot plus an all-reduce. The mesh is ``mesh``, else the one whose
    ``with`` block the call runs in."""

    def dot(a, b):
        m = mesh if mesh is not None else _CURRENT.get()
        if m is None:
            raise ValueError(f"psum_dot({axis_name!r}) needs a mesh: pass mesh= or call it "
                             "inside `with mesh:`")
        return all_reduce(torch.dot(a, b), m.axis(axis_name), "sum")

    return dot


# --- shards ----------------------------------------------------------------


def _place(x, mesh: Mesh, name: str):
    """``x`` as a global tensor on this rank's device: a CPU tensor stays,
    a CUDA tensor moves to the rank's card, other input goes to the card."""
    if isinstance(x, torch.Tensor):
        return x.to(mesh.device) if x.is_cuda else x
    return as_device_tensor(x, name).to(mesh.device)


def _split(t: torch.Tensor, ax: Axis, dim: int = 0) -> torch.Tensor:
    b = t.shape[dim] // ax.size
    return t.narrow(dim, ax.index * b, b)


def _divides(count: int, mesh: Mesh, axis: str, what: str) -> Axis:
    ax = mesh.axis(axis)
    if count % ax.size != 0:
        raise ValueError(
            f"{what} ({count}) must divide evenly over mesh axis {axis!r} ({ax.size} shards)"
        )
    return ax


def _check_fleet(x0s: torch.Tensor, mesh: Mesh, axis: str) -> Axis:
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (batch, n), got shape {tuple(x0s.shape)}")
    return _divides(x0s.shape[0], mesh, axis, "batch")


def _check_vector(x0: torch.Tensor, mesh: Mesh, axis: str, fleet_fn: str) -> Axis:
    if x0.ndim != 1:
        raise ValueError(
            f"x0 must be rank 1 (one large-n solve), got shape {tuple(x0.shape)};"
            f" fleets shard over lanes via {fleet_fn}"
        )
    return _divides(x0.shape[0], mesh, axis, "n")


@contextlib.contextmanager
def _running(mesh: Mesh, lanes: Optional[Axis] = None, coords: Optional[Axis] = None):
    """The engines' context on this rank: the mesh, the placement and the
    rank's card as the current device (kernels launch on its stream)."""
    card = (torch.cuda.device(mesh.device) if mesh.device.type == "cuda"
            else contextlib.nullcontext())
    with card, mesh, placed(lanes=lanes, coords=coords):
        yield


def _gather_lanes(result, ax: Axis):
    """Every per-lane leaf (rank >= 1) of a fleet result, all-gathered."""
    return tree_map(lambda t: all_gather(t, ax, 0)
                    if isinstance(t, torch.Tensor) and t.ndim >= 1 else t, result)


def _fleet_call(fn, lanes, mesh: Mesh, ax: Axis):
    """fn(this rank's lanes of ``lanes``) on the rank's lanes, gathered.
    ``lanes``: the (batch, ...) starts, or a fleet result whose every leaf
    of rank >= 1 holds the lanes in front."""
    mine = tree_map(lambda t: _split(t, ax)
                    if isinstance(t, torch.Tensor) and t.ndim >= 1 else t, lanes)
    with _running(mesh, lanes=ax):
        return _gather_lanes(fn(mine), ax)


# --- data-parallel fleets --------------------------------------------------


def optimize_batched_sharded(obj, x0s, mesh: Mesh, axis: str = "data",
                             **kwargs) -> OptimizeResult:
    """Data-parallel solve fleet: the batch axis cut over ``axis``. Each
    rank runs `optimize_batched_fused` on its lanes (the fused update B1 on
    a card); the lanes are independent, so nothing crosses ranks until the
    result is gathered. kwargs pass through."""
    from ..batched_solve import optimize_batched_fused

    x0s = _place(x0s, mesh, "x0s")
    ax = _divides(x0s.shape[0], mesh, axis, "batch")
    return _fleet_call(lambda x: optimize_batched_fused(obj, x, **kwargs), x0s, mesh, ax)


def optimize_tr_sharded(obj, x0s, mesh: Mesh, axis: str = "data", **kwargs):
    """Data-parallel trust-region Newton–Krylov fleet over ``axis``. The
    inner Steihaug loop runs while any lane of the whole fleet is in it, and
    its count is added to every active lane's ``n_hev``, as JAX's
    partitioned program does. kwargs pass through to `optimize_tr`."""
    from ..trust_region import optimize_tr

    x0s = _place(x0s, mesh, "x0s")
    ax = _check_fleet(x0s, mesh, axis)
    return _fleet_call(lambda x: optimize_tr(obj, x, **kwargs), x0s, mesh, ax)


def optimize_cg_sharded(obj, x0s, mesh: Mesh, axis: str = "data", **kwargs):
    """Data-parallel nonlinear-CG fleet over ``axis``: per-lane O(n) state,
    no ring, no matrix. kwargs pass through to `optimize_cg`."""
    from ..cg_solve import optimize_cg

    x0s = _place(x0s, mesh, "x0s")
    ax = _check_fleet(x0s, mesh, axis)
    return _fleet_call(lambda x: optimize_cg(obj, x, **kwargs), x0s, mesh, ax)


def optimize_auglag_sharded(obj, x0s, mesh: Mesh, axis: str = "data", *, eq=None, ineq=None,
                            constraint_data=None, **kwargs):
    """Data-parallel constrained fleet: the batched augmented Lagrangian
    with its lanes cut over ``axis``, a per-lane ``constraint_data``
    pytree (every leaf with the batch axis in front) cut alongside. Per-lane
    (λ, μ, ρ) ride each rank's carry. kwargs pass through to
    `optimize_auglag` (engine, tol, ctol, ...)."""
    from ..constrained import optimize_auglag

    x0s = _place(x0s, mesh, "x0s")
    ax = _check_fleet(x0s, mesh, axis)
    if constraint_data is not None:
        constraint_data = tree_map(lambda l: _split(_place(l, mesh, "constraint_data"), ax),
                                   constraint_data)

    def run(x):
        return optimize_auglag(obj, x, eq=eq, ineq=ineq, constraint_data=constraint_data,
                               **kwargs)

    return _fleet_call(run, x0s, mesh, ax)


def least_squares_sharded(residual_fn, x0s, mesh: Mesh, axis: str = "data", *, data=None,
                          bounds=None, **kwargs):
    """Data-parallel Levenberg–Marquardt fleet: lanes cut over ``axis``.
    ``data`` leaves carry the batch axis in front and are cut with their
    lanes; ``bounds=(lo, hi)`` entries are cut where they carry the batch
    axis and shared where they broadcast. Other kwargs (tol, loss, f_scale,
    ...) pass through to `least_squares`."""
    from ..least_squares import least_squares

    x0s = _place(x0s, mesh, "x0s")
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (batch, n), got shape {tuple(x0s.shape)}")
    batch = x0s.shape[0]
    ax = _divides(batch, mesh, axis, "batch")

    def shard_leaf(leaf):
        leaf = _place(leaf, mesh, "data")
        return _split(leaf, ax) if leaf.ndim >= 1 and leaf.shape[0] == batch else leaf

    if data is not None:
        data = tree_map(shard_leaf, data)
    if bounds is not None:
        bounds = tuple(shard_leaf(b) for b in bounds)
    return _fleet_call(lambda x: least_squares(residual_fn, x, data=data, bounds=bounds,
                                               **kwargs), x0s, mesh, ax)


# --- chain fleets ----------------------------------------------------------

# where each result's and state's leaves hold the chains (the leaves not
# named are the fleet's own: step sizes, masses, ladders, counters, keys)
_CHAIN_AXES = {
    "HMCResult": {"samples": 1, "accept_rate": 0, "step_size": 0, "energies": 1,
                  "divergences": 0, "final_x": 0},
    "HMCState": {"x": 0, "f": 0, "log_eps": 0, "log_eps_bar": 0, "h_bar": 0},
    "ChEESResult": {"samples": 1, "accept_rate": 0, "energies": 1, "divergences": 0,
                    "final_x": 0},
    "ChEESState": {"x": 0, "f": 0},
    "NUTSResult": {"samples": 1, "accept_prob": 0, "step_size": 0, "mean_tree_depth": 0,
                   "energies": 1, "divergences": 0, "final_x": 0},
    "NUTSState": {"x": 0, "f": 0, "g": 0, "log_eps": 0, "log_eps_bar": 0, "h_bar": 0,
                  "warm_dsum": 1},
    "MCLMCResult": {"samples": 1, "energy_changes": 1, "divergences": 0, "final_x": 0},
    "MCLMCState": {"x": 0, "f": 0, "g": 0, "u": 0},
    "PTResult": {"samples": 1, "round_trips": 0, "energies": 1, "divergences": 0,
                 "final_x": 1},
    "PTState": {"x": 1, "f": 1, "tag": 1, "round_trips": 0},
    "EnsembleResult": {"samples": 1, "accept_rate": 0, "final_x": 0},
    "EnsembleState": {"x": 0, "f": 0, "n_accept": 0},
}


def _gather_chains(result, ax: Axis):
    axes = _CHAIN_AXES[type(result).__name__]
    fields = {}
    for name, leaf in zip(result._fields, result):
        if name == "state":
            leaf = _gather_chains(leaf, ax)
        elif name in axes and leaf is not None:
            leaf = all_gather(leaf, ax, axes[name])
        fields[name] = leaf
    return type(result)(**fields)


def sample_sharded(obj, key, x0s, mesh: Mesh, axis: str = "data", sampler: str = "chees",
                   **kwargs):
    """Multi-device chain fleets: the chains cut over ``axis``.

    Every rank draws the whole fleet's noise from ``key`` and keeps its
    chains' rows, so the sharded run equals the unsharded one chain for
    chain. 'hmc' chains are independent; 'chees' gathers what its fleet
    adaptation averages (the ChEES gradient, the fleet-mean acceptance, the
    fleet mass); 'nuts' decides each tree loop on the whole fleet; 'pt'
    keeps the temperature axis whole on every rank (its exchange sweep
    stays local) and reduces its per-temperature acceptance over all
    chains; 'ensemble' updates each half against the whole other half;
    'mclmc' reduces its warmup's energy-error and variance over the fleet.
    ``x0s``: (chains, n), or (n_temps, chains, n) for 'pt'. kwargs pass
    through to the sampler."""
    from ..sampling import get_sampler

    sample_fn = get_sampler(sampler)
    x0s = _place(x0s, mesh, "x0s")
    dim = 1 if sampler == "pt" and x0s.ndim == 3 else 0
    ax = _divides(x0s.shape[dim], mesh, axis, "chains")
    with _running(mesh, lanes=ax):
        return _gather_chains(sample_fn(obj, key, _split(x0s, ax, dim), **kwargs), ax)


# --- one solve, the parameter axis sharded ----------------------------------

# the leaves of a solve's result and state that hold coordinates (last axis)
_COORD_FIELDS = {"x", "grad", "grad_old", "g", "d", "step", "S", "Y"}


def _gather_coords(result, ax: Axis):
    fields = {}
    for name, leaf in zip(result._fields, result):
        if name == "state":
            leaf = _gather_coords(leaf, ax)
        elif name in _COORD_FIELDS and isinstance(leaf, torch.Tensor):
            leaf = all_gather(leaf, ax, -1)
        fields[name] = leaf
    return type(result)(**fields)


def _split_per_coordinate(value, n: int, ax: Axis, mesh: Mesh, name: str):
    """An array option that holds one entry per coordinate (a fixed
    preconditioner, a bound) cut like x; scalars and strings unchanged."""
    if value is None or isinstance(value, (str, int, float)):
        return value
    t = _place(value if isinstance(value, torch.Tensor) else torch.as_tensor(value), mesh, name)
    return _split(t, ax, -1) if t.ndim >= 1 and t.shape[-1] == n else t


def _model_call(fn, x0: torch.Tensor, mesh: Mesh, ax: Axis):
    with _running(mesh, coords=ax):
        return _gather_coords(fn(_split(x0, ax)), ax)


def optimize_tr_model_sharded(obj, x0, mesh: Mesh, axis: str = "model", **kwargs):
    """ONE large-n trust-region solve with the parameter vector cut over
    ``axis``: every Steihaug-CG reduction (rᵀr, dᵀHd, the boundary τ) and
    every norm is a local partial plus an all-reduce, and the objective and
    its HVPs see the gathered x. Parity with the unsharded engine holds to
    the rounding of the reassociated sums. kwargs pass through to
    `optimize_tr` (a per-coordinate ``bounds`` or ``precondition`` is cut
    like x)."""
    from ..trust_region import optimize_tr

    x0 = _place(x0, mesh, "x0")
    ax = _check_vector(x0, mesh, axis, "optimize_tr_sharded")
    n = x0.shape[0]
    if kwargs.get("bounds") is not None:
        kwargs["bounds"] = tuple(_split_per_coordinate(b, n, ax, mesh, "bounds")
                                 for b in kwargs["bounds"])
    kwargs["precondition"] = _split_per_coordinate(kwargs.get("precondition"), n, ax, mesh,
                                                   "precondition")
    return _model_call(lambda x: optimize_tr(obj, x, **kwargs), x0, mesh, ax)


def optimize_cg_model_sharded(obj, x0, mesh: Mesh, axis: str = "model", **kwargs):
    """ONE very-large-n nonlinear-CG solve with the parameter vector cut
    over ``axis``: O(n) state, and every (batch,)-shaped reduction (g·g,
    d·y, the Hager–Zhang products, the Wolfe slope, max|g|) is a local
    partial plus an all-reduce. The Jacobi probes hash each coordinate's
    global index, so they are the unsharded run's. kwargs pass through to
    `optimize_cg` (method, ls, precondition, ...)."""
    from ..cg_solve import optimize_cg

    x0 = _place(x0, mesh, "x0")
    ax = _check_vector(x0, mesh, axis, "optimize_cg_sharded")
    kwargs["precondition"] = _split_per_coordinate(kwargs.get("precondition"), x0.shape[0], ax,
                                                   mesh, "precondition")
    return _model_call(lambda x: optimize_cg(obj, x, **kwargs), x0, mesh, ax)


def optimize_lbfgs_sharded(
    obj,
    x0,
    mesh: Mesh,
    axis: str = "model",
    history: int = 10,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-8,
    max_iterations: int = MAX_ITERATIONS_DEFAULT,
    value_and_grad_fn: Optional[Callable] = None,
    value_fn: Optional[Callable] = None,
    stall_limit: int = STALL_LIMIT_DEFAULT,
) -> LBFGSResult:
    """One large-n L-BFGS solve with the parameter axis cut over ``axis``:
    JAX's ``shard_map`` body. The unmodified L-BFGS loop runs on each rank's
    shard with the two-loop recursion; every dot is `psum_dot` and the
    convergence test a max over ranks. The objective sees the all-gathered
    x and each rank keeps its slice of the gradient. n must divide evenly
    over the axis.

    For separable objectives pass a ``value_and_grad_fn`` on local shards
    that sums its value over the axis itself (``mesh.psum``, with
    ``mesh.index(axis)`` for the shard's place); the loop only consumes
    its (scalar, local-gradient) outputs. Also pass ``value_fn`` (local
    shard -> summed scalar) when the gradient is expensive: backtracking
    trials are value-only."""
    x0 = _place(x0, mesh, "x0")
    n = x0.shape[0]
    ax = mesh.axis(axis)
    if n % ax.size != 0:
        raise ValueError(f"n ({n}) must divide evenly over mesh axis {axis!r}")
    dot = psum_dot(axis, mesh)

    def max_abs(g):
        return all_reduce(torch.amax(torch.abs(g)), ax, "max")

    if value_and_grad_fn is not None:
        vag_local = value_and_grad_fn
        f_local = value_fn if value_fn is not None else (lambda xl: value_and_grad_fn(xl)[0])
    else:
        vag_full = as_value_and_grad(obj, None)
        f_full = as_value_fn(obj, None)

        def f_local(xl):
            return f_full(all_gather(xl, ax, 0))

        def vag_local(xl):
            # the gradient's cotangent through JAX's all_gather is this
            # shard's slice of the whole gradient
            f, g = vag_full(all_gather(xl, ax, 0))
            return f, _split(g, ax)

    with _running(mesh, coords=ax), torch.no_grad():
        # two_loop: its dots take the psum hook (the compact form's matmuls
        # would need collectives of their own)
        final = _lbfgs_loop(vag_local, f_local, init_lbfgs_state(_split(x0, ax), history), ls,
                            tol, max_iterations, "two_loop", stall_limit, fresh_start=True,
                            dot=dot, max_abs=max_abs)
        return _gather_coords(_result_from_state(final), ax)
