"""Solver state — the PyTorch port of ``quasinewtonmethods_jl_tpu/state.py``.

`Status` keeps the JAX package's integers: they are a serialisation
contract (saved states and results from either package read the same).
`BFGSState`, `LBFGSState`, `CGState`, `LMState` and `TRState` are
NamedTuples of tensors with the JAX field order (the JAX package keeps
`CGState` in cg_solve.py, `LMState` in least_squares.py and `TRState` in
trust_region.py; the port keeps its states here), so a state converts leaf
by leaf between the two packages through numpy (`bfgs_state_from_numpy` /
`bfgs_state_to_numpy`, `lbfgs_state_from_numpy` / `lbfgs_state_to_numpy`,
`cg_state_from_numpy` / `cg_state_to_numpy`, `lm_state_from_numpy` /
`lm_state_to_numpy`, `tr_state_from_numpy` / `tr_state_to_numpy`).
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

from .utils.device import as_device_tensor

__all__ = [
    "Status",
    "BFGSState",
    "init_bfgs_state",
    "bfgs_state_from_numpy",
    "bfgs_state_to_numpy",
    "LBFGSState",
    "init_lbfgs_state",
    "lbfgs_state_from_numpy",
    "lbfgs_state_to_numpy",
    "CGState",
    "cg_state_from_numpy",
    "cg_state_to_numpy",
    "LMState",
    "lm_state_from_numpy",
    "lm_state_to_numpy",
    "TRState",
    "tr_state_from_numpy",
    "tr_state_to_numpy",
]


class Status(enum.IntEnum):
    """In-band solver status (replaces the reference's NaN / 0.0 sentinels,
    src/QuasiNewtonMethods.jl:193, :291)."""

    RUNNING = 0
    CONVERGED = 1  # max|grad| < tol                      (:257-262)
    MAX_ITERATIONS = 2  # outer-iteration cap hit         (:250, N=10_000)
    LINESEARCH_FAILURE = 3  # line search returned alpha==0 (:284)
    NONFINITE_VALUE = 4  # logdensity became non-finite    (:255)


class BFGSState(NamedTuple):
    """Full-matrix BFGS solver state; leaves gain a leading batch axis in
    fleet results (``x`` is (batch, n), ``B`` is (batch, n, n))."""

    x: torch.Tensor  # (n,) current iterate
    grad: torch.Tensor  # (n,) last evaluated gradient
    grad_old: torch.Tensor  # (n,)
    step: torch.Tensor  # (n,) last accepted step (alpha * d)
    B: torch.Tensor  # (n, n) inverse-Hessian approximation
    fun: torch.Tensor  # () latest objective value (NaN until first eval)
    k: torch.Tensor  # () int32 outer-iteration counter
    status: torch.Tensor  # () int32 Status code
    n_fev: torch.Tensor  # () int32 objective evaluations
    n_gev: torch.Tensor  # () int32 gradient evaluations
    n_resets: torch.Tensor  # () int32 steepest-ascent restarts
    fresh: torch.Tensor  # () bool: B is an unscaled fresh identity
    stall: torch.Tensor  # () int32 consecutive no-improvement iterations


def init_bfgs_state(x0) -> BFGSState:
    """Fresh solver state at the starting point, on ``x0``'s device (an
    array that is not a tensor goes where an entry point puts it,
    `as_device_tensor`)."""
    x0 = as_device_tensor(x0, "x0")
    if x0.ndim != 1:
        raise ValueError(f"x0 must be a rank-1 tensor, got shape {tuple(x0.shape)}")
    n = x0.shape[0]
    dtype, device = x0.dtype, x0.device

    def zero_i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    return BFGSState(
        x=x0,
        grad=torch.zeros(n, dtype=dtype, device=device),
        grad_old=torch.zeros(n, dtype=dtype, device=device),
        step=torch.zeros(n, dtype=dtype, device=device),
        B=torch.eye(n, dtype=dtype, device=device),
        fun=torch.full((), float("nan"), dtype=dtype, device=device),
        k=zero_i32(),
        status=torch.full((), int(Status.RUNNING), dtype=torch.int32, device=device),
        n_fev=zero_i32(),
        n_gev=zero_i32(),
        n_resets=zero_i32(),
        fresh=torch.ones((), dtype=torch.bool, device=device),
        stall=zero_i32(),
    )


class LBFGSState(NamedTuple):
    """Limited-memory BFGS state: (m, n) history rings instead of an (n, n)
    B. Slots 0..hist-1 hold the pairs oldest to newest (the canonical time
    order every engine exports); fleet results add a leading batch axis
    (``S`` is (batch, m, n))."""

    x: torch.Tensor  # (n,)
    grad: torch.Tensor  # (n,)
    grad_old: torch.Tensor  # (n,)
    step: torch.Tensor  # (n,) last accepted step
    S: torch.Tensor  # (m, n) step history ring
    Y: torch.Tensor  # (m, n) gradient-difference history ring
    rho: torch.Tensor  # (m,) 1 / sᵀy per ring slot
    hist: torch.Tensor  # () int32 number of valid history pairs (<= m)
    gamma: torch.Tensor  # () H0 scaling sᵀy / yᵀy
    fun: torch.Tensor
    k: torch.Tensor
    status: torch.Tensor
    n_fev: torch.Tensor
    n_gev: torch.Tensor
    n_resets: torch.Tensor
    stall: torch.Tensor  # () int32 consecutive no-improvement iterations


def init_lbfgs_state(x0, history: int = 10) -> LBFGSState:
    """Fresh L-BFGS state with an m-slot history ring, on ``x0``'s device
    (an array that is not a tensor goes where an entry point puts it,
    `as_device_tensor`)."""
    x0 = as_device_tensor(x0, "x0")
    if x0.ndim != 1:
        raise ValueError(f"x0 must be a rank-1 tensor, got shape {tuple(x0.shape)}")
    n = x0.shape[0]
    dtype, device = x0.dtype, x0.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def zero_i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    return LBFGSState(
        x=x0,
        grad=zeros(n),
        grad_old=zeros(n),
        step=zeros(n),
        S=zeros(history, n),
        Y=zeros(history, n),
        rho=zeros(history),
        hist=zero_i32(),
        gamma=torch.ones((), dtype=dtype, device=device),
        fun=torch.full((), float("nan"), dtype=dtype, device=device),
        k=zero_i32(),
        status=torch.full((), int(Status.RUNNING), dtype=torch.int32, device=device),
        n_fev=zero_i32(),
        n_gev=zero_i32(),
        n_resets=zero_i32(),
        stall=zero_i32(),
    )


class CGState(NamedTuple):
    """Nonlinear-CG solver state (resumable, checkpointable). Every leaf has
    a leading (batch,) axis (a rank-1 solve's result squeezes it). (fun,
    grad) are the evaluation at ``x``; ``d`` is the last search direction
    used; (m_prev, t_prev) are the directional derivative and effective
    step of the last accepted step, the warm-start pair, with m_prev == 0
    marking a lane that never stepped."""

    x: torch.Tensor  # (B, n) iterate
    grad: torch.Tensor  # (B, n) gradient at x
    grad_old: torch.Tensor  # (B, n) gradient at the previous iterate
    d: torch.Tensor  # (B, n) previous search direction
    m_prev: torch.Tensor  # (B,) previous d·g (0 = never stepped)
    t_prev: torch.Tensor  # (B,) previous accepted effective step alpha·t
    fun: torch.Tensor  # (B,) objective at x
    k: torch.Tensor  # (B,) int32 lifetime iterations
    status: torch.Tensor  # (B,) int32 Status
    n_fev: torch.Tensor  # (B,) int32
    n_gev: torch.Tensor  # (B,) int32
    n_resets: torch.Tensor  # (B,) int32 steepest restarts (incl. Powell)
    stall: torch.Tensor  # (B,) int32 consecutive non-improving iterations


class LMState(NamedTuple):
    """Levenberg–Marquardt fleet state. Every leaf has a leading (batch,)
    axis (a rank-1 solve's result squeezes it); (g, JTJ) always hold the
    Jacobian products at ``x``."""

    x: torch.Tensor  # (B, n) iterate
    fun: torch.Tensor  # (B,) ½‖r(x)‖² (or the robust loss)
    g: torch.Tensor  # (B, n) gradient Jᵀr at x
    JTJ: torch.Tensor  # (B, n, n) Gauss–Newton matrix at x
    lam: torch.Tensor  # (B,) Marquardt damping
    nu: torch.Tensor  # (B,) damping growth factor (Madsen–Nielsen)
    k: torch.Tensor  # (B,) int32 iterations executed
    status: torch.Tensor  # (B,) int32 Status
    n_fev: torch.Tensor  # (B,) int32 residual evaluations
    n_jev: torch.Tensor  # (B,) int32 Jacobian evaluations
    stall: torch.Tensor  # (B,) int32 consecutive rejected trials


class TRState(NamedTuple):
    """Trust-region fleet state. Every leaf has a leading (batch,) axis (a
    rank-1 solve's result squeezes it); (fun, g) are the minimization
    objective's (−obj's) evaluation at ``x``."""

    x: torch.Tensor  # (B, n) iterate
    fun: torch.Tensor  # (B,) −obj(x), the minimized value
    g: torch.Tensor  # (B, n) ∇(−obj) at x
    delta: torch.Tensor  # (B,) trust radius
    k: torch.Tensor  # (B,) int32 iterations executed
    status: torch.Tensor  # (B,) int32 Status
    n_fev: torch.Tensor  # (B,) int32 objective evaluations
    n_hev: torch.Tensor  # (B,) int32 Hessian-vector products
    stall: torch.Tensor  # (B,) int32 consecutive rejected trials


def _from_numpy(cls, state, device):
    return cls(*(torch.tensor(np.asarray(leaf), device=device) for leaf in state))


def _to_numpy(state):
    return type(state)(*(leaf.detach().cpu().numpy() for leaf in state))


def bfgs_state_from_numpy(state, device) -> BFGSState:
    """Port state from any state with the `BFGSState` fields whose leaves
    are numpy arrays (e.g. a JAX ``BFGSState`` after ``np.asarray`` of each
    leaf), scalar or batched. Dtypes are kept; leaves are copied."""
    return _from_numpy(BFGSState, state, device)


def bfgs_state_to_numpy(state: BFGSState) -> BFGSState:
    """The inverse of `bfgs_state_from_numpy`: a `BFGSState` of numpy
    arrays, field for field in the JAX package's order."""
    return _to_numpy(state)


def lbfgs_state_from_numpy(state, device) -> LBFGSState:
    """`LBFGSState` from any state with its fields whose leaves are numpy
    arrays (e.g. a JAX ``LBFGSState`` after ``np.asarray`` of each leaf),
    scalar or batched. Dtypes are kept; leaves are copied."""
    return _from_numpy(LBFGSState, state, device)


def lbfgs_state_to_numpy(state: LBFGSState) -> LBFGSState:
    """The inverse of `lbfgs_state_from_numpy`: an `LBFGSState` of numpy
    arrays, field for field in the JAX package's order."""
    return _to_numpy(state)


def cg_state_from_numpy(state, device) -> CGState:
    """`CGState` from any state with its fields whose leaves are numpy
    arrays (e.g. a JAX ``CGState`` after ``np.asarray`` of each leaf).
    Dtypes are kept; leaves are copied."""
    return _from_numpy(CGState, state, device)


def cg_state_to_numpy(state: CGState) -> CGState:
    """The inverse of `cg_state_from_numpy`: a `CGState` of numpy arrays."""
    return _to_numpy(state)


def lm_state_from_numpy(state, device) -> LMState:
    """`LMState` from any state with its fields whose leaves are numpy
    arrays (e.g. a JAX ``LMState`` after ``np.asarray`` of each leaf),
    scalar or batched. Dtypes are kept; leaves are copied."""
    return _from_numpy(LMState, state, device)


def lm_state_to_numpy(state: LMState) -> LMState:
    """The inverse of `lm_state_from_numpy`: an `LMState` of numpy arrays."""
    return _to_numpy(state)


def tr_state_from_numpy(state, device) -> TRState:
    """`TRState` from any state with its fields whose leaves are numpy
    arrays (e.g. a JAX ``TRState`` after ``np.asarray`` of each leaf),
    scalar or batched. Dtypes are kept; leaves are copied."""
    return _from_numpy(TRState, state, device)


def tr_state_to_numpy(state: TRState) -> TRState:
    """The inverse of `tr_state_from_numpy`: a `TRState` of numpy arrays."""
    return _to_numpy(state)
