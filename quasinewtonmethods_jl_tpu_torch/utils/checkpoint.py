"""Checkpoint and resume of solver states — the PyTorch port of
``quasinewtonmethods_jl_tpu/utils/checkpoint.py``.

A solver state is one NamedTuple of tensors; `save_state` writes it to a
single ``.npz`` file in the JAX package's layout (one array per field under
its name, the bare class name under ``__class__``, and the PRNG-key
bookkeeping ``__key_fields__`` / ``__key_impls__``, empty here), so a file
crosses between the packages in both directions. `load_state` restores the
matching class, and the ``*_from_state`` entry points resume from it.

The port covers the five solver states it has (`BFGSState`, `LBFGSState`,
`CGState`, `LMState`, `TRState`). The sampler states the JAX package also
saves (HMC, ChEES, NUTS, tempering, SVGD, ensemble, MCLMC) and files that
hold PRNG keys raise a TypeError until sampling is ported.
"""

from __future__ import annotations

import os
from typing import Optional, Type, Union

import numpy as np

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
from .device import as_device_state

__all__ = ["save_state", "load_state"]

_STATE_CLASSES = {"BFGSState": BFGSState, "LBFGSState": LBFGSState, "CGState": CGState,
                  "LMState": LMState, "TRState": TRState}
_FROM_NUMPY = {BFGSState: bfgs_state_from_numpy, LBFGSState: lbfgs_state_from_numpy,
               CGState: cg_state_from_numpy, LMState: lm_state_from_numpy,
               TRState: tr_state_from_numpy}
# the JAX package's sampler states (its checkpoint.py:28-43), not ported yet
_SAMPLER_STATES = ("HMCState", "ChEESState", "NUTSState", "PTState", "SVGDState",
                   "EnsembleState", "MCLMCState")


def _npz_path(path) -> str:
    # np.savez appends ".npz" to a path without it and np.load does not:
    # normalize so that save and load take the same string
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _not_ported(cls_name: str) -> TypeError:
    return TypeError(f"{cls_name} is a sampler state, which the PyTorch port does not hold "
                     "yet (sampling is not yet ported)")


def save_state(path: Union[str, os.PathLike], state) -> None:
    """Write a solver state NamedTuple to ``path`` (.npz, appended if
    missing), every leaf copied to the host, the class name beside the
    fields so that `load_state` can check (or infer) the type."""
    cls = type(state).__name__
    if cls in _SAMPLER_STATES:
        raise _not_ported(cls)
    if cls not in _STATE_CLASSES:
        raise TypeError(f"expected a solver or sampler state NamedTuple, got {cls}")
    # a None field is omitted; load_state restores it from the default
    arrays = {k: v.detach().cpu().numpy() for k, v in state._asdict().items() if v is not None}
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
        if saved_cls in _SAMPLER_STATES:
            raise _not_ported(saved_cls)
        key_fields = z["__key_fields__"].tolist() if "__key_fields__" in z else []
        if key_fields:
            raise TypeError(f"checkpoint {path!r} holds PRNG keys in {key_fields}, which the "
                            "PyTorch port does not restore yet (sampling is not yet ported)")
        klass = _STATE_CLASSES[saved_cls]
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
