"""Where a sharded call's lanes and coordinates live: the port's
counterpart of running a JAX program under ``with mesh:``.

The mesh entry points (parallel/mesh.py) run the unmodified engines on
one rank's shard inside `placed`, which names the process group the
fleet's lanes (or chains) are cut over (``lanes``, a data axis) or the one
the parameter vector is cut over (``coords``, a model axis). The engines
take every quantity that crosses a shard through the helpers below;
outside `placed` each helper is the plain local operation, so an unsharded
call computes exactly what it computed before.

- Sums and means over lanes gather the whole fleet first and reduce it as
  the unsharded engine does, so a sharded run equals the unsharded run
  lane for lane (bit for bit on one device type). Exact reductions over
  lanes (any, max) are all-reduces. A host read that decides whether a
  body holding a collective runs (`fleet_any`) is fleet-wide, so every
  rank runs the same bodies.
- Sums over coordinates are a local partial plus an all-reduce, as GSPMD
  lowers them; they reassociate the sum, so a model-sharded solve follows
  the unsharded one to rounding.
- Noise: each rank draws the whole fleet's noise from the same key and
  takes its own rows (`own_rows`).

A group on gloo cannot take CUDA tensors in every collective, and stages
through the host anyway: its tensors are copied to the CPU and back.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch

__all__ = [
    "Axis", "placed", "all_gather", "all_reduce",
    "fleet", "fleet_count", "own_rows", "own_span", "fleet_any", "fleet_amax",
    "coord_sum", "coord_amax", "coord_all", "coord_count", "coord_offset", "coord_local",
]


class Axis(NamedTuple):
    """One mesh axis as this rank sees it."""

    name: str
    group: object  # the axis's torch.distributed process group; None on a one-device mesh
    size: int  # ranks along the axis
    index: int  # this rank's coordinate along it
    host_staged: bool  # the group runs on gloo: CUDA tensors go through the host


class _Placement(NamedTuple):
    lanes: Optional[Axis]
    coords: Optional[Axis]


_ACTIVE = contextvars.ContextVar("quasinewtonmethods_placement", default=_Placement(None, None))


@contextlib.contextmanager
def placed(lanes: Optional[Axis] = None, coords: Optional[Axis] = None):
    """Run the block's engines on this rank's shard: ``lanes`` the axis the
    fleet's leading dimension is cut over, ``coords`` the one the last
    (parameter) dimension is cut over."""
    token = _ACTIVE.set(_Placement(lanes, coords))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


# --- collectives ------------------------------------------------------------


def _staged(t: torch.Tensor, axis: Axis):
    """(the tensor the collective takes, how to bring the result back):
    contiguous, bool as uint8, through the host on gloo."""
    src = t.contiguous()
    dtype, device = src.dtype, src.device
    if dtype == torch.bool:
        src = src.to(torch.uint8)
    if axis.host_staged and src.is_cuda:
        src = src.cpu()
    return src, lambda out: out.to(device=device, dtype=dtype)


def all_gather(t: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """The axis's shards of ``t`` concatenated along ``dim``, in rank order."""
    if axis.group is None:
        return t
    import torch.distributed as dist

    src, back = _staged(t, axis)
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return back(torch.cat(parts, dim))


def all_reduce(t: torch.Tensor, axis: Axis, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the axis ('sum', 'max' or 'min'), a new tensor."""
    if axis.group is None:
        return t
    import torch.distributed as dist

    src, back = _staged(t, axis)
    if src is t:
        src = src.clone()
    dist.all_reduce(src, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                             "min": dist.ReduceOp.MIN}[op], group=axis.group)
    return back(src)


# --- lanes (the fleet's leading axis) ---------------------------------------


def fleet(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The whole fleet of ``t``, whose lanes lie along ``dim``."""
    lanes = _ACTIVE.get().lanes
    return t if lanes is None else all_gather(t, lanes, dim)


def fleet_count(local: int) -> int:
    """The fleet's lane count, from this rank's ``local`` count."""
    lanes = _ACTIVE.get().lanes
    return local if lanes is None else local * lanes.size


def own_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's lanes of the whole-fleet tensor ``t`` (lanes along
    ``dim``), e.g. its rows of a noise draw made for the whole fleet."""
    lanes = _ACTIVE.get().lanes
    if lanes is None:
        return t
    b = t.shape[dim] // lanes.size
    return t.narrow(dim, lanes.index * b, b)


def own_span(local: int):
    """(first, end) of this rank's lanes in the whole fleet."""
    lanes = _ACTIVE.get().lanes
    lo = 0 if lanes is None else lanes.index * local
    return lo, lo + local


def fleet_any(mask: torch.Tensor) -> torch.Tensor:
    """0-d: whether any lane of the whole fleet has ``mask`` set."""
    lanes = _ACTIVE.get().lanes
    hit = mask.any()
    return hit if lanes is None else all_reduce(hit, lanes, "max")


def fleet_amax(t: torch.Tensor) -> torch.Tensor:
    """0-d: the largest entry of ``t`` over the whole fleet."""
    lanes = _ACTIVE.get().lanes
    top = t.amax()
    return top if lanes is None else all_reduce(top, lanes, "max")


# --- coordinates (the parameter vector's last axis) -------------------------


def coord_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over its last (parameter) axis, across shards."""
    coords = _ACTIVE.get().coords
    s = torch.sum(t, dim=-1)
    return s if coords is None else all_reduce(s, coords, "sum")


def coord_amax(t: torch.Tensor) -> torch.Tensor:
    """The largest entry of ``t`` over its last axis, across shards."""
    coords = _ACTIVE.get().coords
    m = torch.amax(t, dim=-1)
    return m if coords is None else all_reduce(m, coords, "max")


def coord_all(mask: torch.Tensor) -> torch.Tensor:
    """Whether ``mask`` holds at every entry of its last axis, across
    shards."""
    coords = _ACTIVE.get().coords
    every = mask.all(dim=-1)
    return every if coords is None else all_reduce(every, coords, "min")


def coord_count(local: int) -> int:
    """The parameter vector's length, from this rank's ``local`` length."""
    coords = _ACTIVE.get().coords
    return local if coords is None else local * coords.size


def coord_offset(local: int) -> int:
    """The global index of this rank's first coordinate."""
    coords = _ACTIVE.get().coords
    return 0 if coords is None else coords.index * local


def coord_local(batched_fn, n_args: int = 1):
    """``batched_fn`` on (batch, n) tensors made to take this rank's
    (batch, n/k) shards: its first ``n_args`` arguments are gathered along
    the last axis, and every output of rank >= 2 gives back this rank's
    columns (a (batch,) value passes as it is). The objective thus sees
    the whole vector, as JAX's sharded L-BFGS all-gathers x for the
    callback. Unchanged outside a model-sharded call."""
    coords = _ACTIVE.get().coords
    if coords is None:
        return batched_fn

    def local_fn(*args):
        full = [all_gather(a, coords, -1) for a in args[:n_args]]
        out = batched_fn(*full, *args[n_args:])

        def cut(t):
            if t.ndim < 2:
                return t
            b = t.shape[-1] // coords.size
            return t.narrow(-1, coords.index * b, b)

        return tuple(cut(t) for t in out) if isinstance(out, tuple) else cut(out)

    return local_fn
