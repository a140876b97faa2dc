"""Where a solve runs: the card, unless the caller passes a CPU tensor.

The JAX package puts a numpy array or a list on its default device, the
accelerator, with its default (x64 off) dtypes: float64 becomes float32 and
int64 int32. The port's entry points do the same through `as_device_tensor`:
a ``torch.Tensor`` keeps its device and dtype (a CPU tensor is how a caller
asks for the CPU, an f64 tensor how it asks for f64), anything else becomes
a tensor on ``cuda`` with those dtypes. Without a card such input raises
instead of running on the CPU unasked. `as_device_state` applies the rule
to every leaf of a saved state, except a sampler state's ``key``, which
stays on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_device_state", "as_device_tensor"]

# the JAX package's dtypes for non-tensor input (jax_enable_x64 off)
_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
              np.dtype(np.complex128): np.complex64}


def as_device_tensor(x, name: str = "x0s") -> torch.Tensor:
    """``x`` as a tensor on the device the solve runs on, in the dtype it
    runs in (see the module docstring)."""
    if isinstance(x, torch.Tensor):
        return x
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{name} is a {type(x).__name__}, which the port places on the CUDA card, and "
            "torch.cuda.is_available() is False; pass a CPU torch.Tensor to solve on the CPU"
        )
    a = np.asarray(x)
    return torch.as_tensor(a.astype(_CANONICAL.get(a.dtype, a.dtype), copy=False), device="cuda")


def as_device_state(state, name: str = "state"):
    """``state`` (a NamedTuple of leaves) with every leaf through
    `as_device_tensor`: tensors keep their device, numpy leaves go to the
    card, and None leaves (a sampler state's optional fields) stay None.
    The one exception is a sampler state's ``key``: it is the (2,) int64
    tensor of the key's two uint32 words and stays on the CPU, so that no
    seed derivation reads the card."""

    def place(field, leaf):
        if leaf is None:
            return None
        if field == "key":
            if isinstance(leaf, torch.Tensor):
                return leaf.detach().to(device="cpu", dtype=torch.int64)
            return torch.as_tensor(np.asarray(leaf).astype(np.int64))
        return as_device_tensor(leaf, f"{name}.{field}")

    return type(state)(*(place(field, leaf) for field, leaf in zip(state._fields, state)))
