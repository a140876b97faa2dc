"""Hutchinson |diag(H)| estimator for the Jacobi preconditioners — the
PyTorch port of ``quasinewtonmethods_jl_tpu/ops/hutchinson.py``.

diag(H) ≈ mean_j v_j ⊙ (H v_j) over Rademacher probes: exact for any probe
when H is diagonal, with variance from the off-diagonal row mass otherwise
(Bekas–Kokiopoulou–Saad 2007). Fleets are lane-major (batch, n); each probe
is drawn along the parameter axis and broadcast across lanes, so a fleet
lane sees the probes of a solo solve.

The probes. ``jax.random`` cannot be reproduced in torch, so the port draws
its own: the sign of coordinate i of probe j at iteration k is one bit of a
counter-based hash of (seed, k, j, i) (`_rademacher`), in torch integer ops
with every product kept below 2**63 and masked to 32 bits. The same
arguments give the same probe on the CPU and on the card, with no generator
state and no host read (k may be a device scalar), and a chunked resume
replays the probes of an uninterrupted run, which is what the JAX
``fold_in`` key was for. A rank of a model-sharded solve hashes its
coordinates' global indices, so its probe is its slice of the unsharded
one, and the guard's floor is the largest estimate over all shards. `_abs_diag_from_probes` is the estimate from given
probes, so a test can feed it JAX's.

The guard, as in JAX: a coordinate below the lane's relative floor
(1e-6 x its largest) takes the floor, and a lane whose estimates are all
zero takes 1.0 (the identity scaling). A NaN estimate makes the lane's
floor NaN, so every coordinate of that lane takes 1.0 too: the port copies
this reference behaviour (ROADMAP.md C1).
"""

from __future__ import annotations

import torch

from ..utils.placement import coord_amax, coord_offset

__all__ = ["hutchinson_abs_diag"]

_MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x * c mod 2**32 for 0 <= x < 2**32, with no product past 2**48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def _mix32(x):
    """A 32-bit integer hash (lowbias32: xor-shift and multiply rounds);
    works on Python ints and int64 tensors alike."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _rademacher(seed: int, k, probe: int, n: int, dtype, device, offset: int = 0) -> torch.Tensor:
    """(n,) probe of ±1: coordinate i is the top bit of the hash of
    (seed, k, probe, offset + i), ``offset`` the global index of the first
    coordinate (a model-sharded rank's shard). ``k`` is an int or a 0-d
    integer tensor."""
    if isinstance(k, torch.Tensor):
        k = k.to(device=device, dtype=torch.int64)
    key = _mix32(_mix32(_mix32(seed & _MASK32) ^ (k & _MASK32)) ^ probe)
    h = _mix32(key ^ torch.arange(offset, offset + n, dtype=torch.int64, device=device))
    return (1 - 2 * ((h >> 31) & 1)).to(dtype)


def _abs_diag_from_probes(hvp_fleet, x: torch.Tensor, probes) -> torch.Tensor:
    """Guarded |diag(H)| at the (batch, n) ``x`` from the given (n,) probe
    vectors (see the module docstring for the guard)."""
    est = torch.zeros_like(x)
    for v in probes:
        v = v.to(dtype=x.dtype, device=x.device).expand_as(x)
        est = est + v * hvp_fleet(x, v)
    d_abs = torch.abs(est) / len(probes)
    rel = 1e-6 * coord_amax(d_abs)[..., None]
    return torch.where(d_abs > rel, d_abs, torch.where(rel > 0, rel, torch.ones_like(d_abs)))


def hutchinson_abs_diag(hvp_fleet, x: torch.Tensor, k, probes: int, seed: int) -> torch.Tensor:
    """Positive |diag(H)| estimate at the (batch, n) fleet ``x``.

    ``hvp_fleet(x, v) -> Hv`` with ``v`` shaped like ``x``; ``k`` the
    lifetime iteration count (an int or a device scalar) keying the probes
    with ``seed``; ``probes`` the number of probes."""
    n = x.shape[-1]
    vs = [_rademacher(seed, k, j, n, x.dtype, x.device, coord_offset(n))
          for j in range(probes)]
    return _abs_diag_from_probes(hvp_fleet, x, vs)
