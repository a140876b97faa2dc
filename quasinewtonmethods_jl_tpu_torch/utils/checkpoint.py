"""Checkpoint and resume of solver states — the PyTorch port of
``quasinewtonmethods_jl_tpu/utils/checkpoint.py``.

A solver state is one NamedTuple of tensors; `save_state` writes it to a
single ``.npz`` file in the JAX package's layout (one array per field under
its name, the bare class name under ``__class__``, and the PRNG-key
bookkeeping ``__key_fields__`` / ``__key_impls__``, empty here), so a file
crosses between the packages in both directions. `load_state` restores the
matching class, and the ``*_from_state`` entry points resume from it.

The port covers the five solver states it has (`BFGSState`, `LBFGSState`,
`CGState`, `LMState`, `TRState`) and every sampler state of the JAX
package: `HMCState`, `ChEESState`, `NUTSState`, `SVGDState`, `MCLMCState`,
`EnsembleState` and `PTState`. A sampler state's ``key`` is written as the
uint32 (2,) array of its two words with empty ``__key_fields__``, which
JAX's `load_state` reads as a raw key; a JAX file's typed ``threefry2x32``
key (named in ``__key_fields__``) or raw key loads as those two words. A
key of another impl, or a key in any other field, raises a TypeError.
"""

from __future__ import annotations

import os
from typing import Optional, Type, Union

import numpy as np
import torch

from ..state import (
    BFGSState,
    CGState,
    LBFGSState,
    LMState,
    TRState,
    bfgs_state_from_numpy,
    cg_state_from_numpy,
    lbfgs_state_from_numpy,
    lm_state_from_numpy,
    tr_state_from_numpy,
)
from ..ensemble import EnsembleState
from ..mclmc import MCLMCState
from ..sampling import ChEESState, HMCState, NUTSState
from ..svgd import SVGDState
from ..tempering import PTState
from .device import as_device_state

__all__ = ["save_state", "load_state"]


def _sampler_state_from_numpy(state, device):
    """A sampler state's numpy leaves as tensors on ``device``, dtypes
    kept; the key as its (2,) int64 CPU tensor, None leaves None."""
    return type(state)(*(
        None if leaf is None
        else torch.as_tensor(np.asarray(leaf).astype(np.int64)) if field == "key"
        else torch.as_tensor(np.asarray(leaf), device=device)
        for field, leaf in zip(state._fields, state)))


_SOLVER_FROM_NUMPY = {BFGSState: bfgs_state_from_numpy, LBFGSState: lbfgs_state_from_numpy,
                      CGState: cg_state_from_numpy, LMState: lm_state_from_numpy,
                      TRState: tr_state_from_numpy}
_SAMPLER_STATES = (HMCState, ChEESState, NUTSState, SVGDState, MCLMCState, EnsembleState,
                   PTState)
_FROM_NUMPY = {**_SOLVER_FROM_NUMPY, **{cls: _sampler_state_from_numpy for cls in _SAMPLER_STATES}}
_STATE_CLASSES = {cls.__name__: cls for cls in _FROM_NUMPY}
# the key impl the port reads from a JAX file's typed keys
_KEY_IMPL = "threefry2x32"


def _npz_path(path) -> str:
    # np.savez appends ".npz" to a path without it and np.load does not:
    # normalize so that save and load take the same string
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: Union[str, os.PathLike], state) -> None:
    """Write a solver or sampler state NamedTuple to ``path`` (.npz,
    appended if missing), every leaf copied to the host, the class name
    beside the fields so that `load_state` can check (or infer) the
    type."""
    cls = type(state).__name__
    if _STATE_CLASSES.get(cls) is not type(state):
        raise TypeError(f"expected a solver or sampler state NamedTuple, got {cls}")
    # a None field is omitted; load_state restores it from the default. A
    # sampler's key is its two words, a raw JAX key
    arrays = {k: (np.asarray(v.tolist(), np.uint32) if k == "key"
                  else v.detach().cpu().numpy())
              for k, v in state._asdict().items() if v is not None}
    arrays["__class__"] = np.asarray(cls)
    arrays["__key_fields__"] = np.asarray([])
    arrays["__key_impls__"] = np.asarray([])
    np.savez(_npz_path(path), **arrays)


def load_state(
    path: Union[str, os.PathLike],
    cls: Optional[Type] = None,
    device=None,
):
    """Restore a state written by `save_state` (or by the JAX package's).

    Args:
      path: the .npz file (".npz" appended if missing).
      cls: optional expected class; a file holding another raises
        TypeError instead of reinterpreting its fields.
      device: where the leaves go, dtypes kept (``*_state_from_numpy``).
        None applies the entry points' rule (`as_device_state`): the CUDA
        card, in the JAX package's x64-off dtypes, as JAX's own load puts
        a state on its default device.
    """
    with np.load(_npz_path(path), allow_pickle=False) as z:
        saved_cls = str(z["__class__"])
        if cls is not None and cls.__name__ != saved_cls:
            raise TypeError(f"checkpoint holds {saved_cls}, expected {cls.__name__}")
        key_fields = z["__key_fields__"].tolist() if "__key_fields__" in z else []
        key_impls = z["__key_impls__"].tolist() if "__key_impls__" in z else []
        klass = _STATE_CLASSES[saved_cls]
        if key_fields and ("key" not in klass._fields or key_fields != ["key"]):
            raise TypeError(f"checkpoint {path!r} holds PRNG keys in {key_fields}; the "
                            "PyTorch port restores a key only in a sampler state's 'key' field")
        # files from before the impl was recorded hold the default impl
        impl = key_impls[0] if key_impls else _KEY_IMPL
        if key_fields and impl != _KEY_IMPL:
            raise TypeError(f"checkpoint {path!r} holds a {impl} PRNG key; the PyTorch port "
                            f"reads only {_KEY_IMPL} keys")
        defaults = klass._field_defaults
        fields = {}
        for k in klass._fields:
            if k in z:
                fields[k] = np.asarray(z[k])
            elif k in defaults:
                fields[k] = defaults[k]
            else:
                raise KeyError(f"checkpoint {path!r} is missing required field {k!r} of "
                               f"{saved_cls}")
    state = klass(**fields)
    if device is None:
        return as_device_state(state)
    return _FROM_NUMPY[klass](state, device)
