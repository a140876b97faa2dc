"""Affine-invariant ensemble sampler (Goodman–Weare stretch move) — the
PyTorch port of ``quasinewtonmethods_jl_tpu/ensemble.py``.

The gradient-free member of the sampler family: the stretch move (Goodman
& Weare 2010; the "emcee" algorithm, Foreman-Mackey et al. 2013) needs only
logdensity values, so it covers black-box, non-differentiable or branchy
targets, and its affine invariance makes it insensitive to linear
correlation and scaling without any mass matrix.

The walker ensemble is the batch axis. The red-black half-ensemble scheme
(Foreman-Mackey et al. §3) updates each half as one batched step, so a
W-walker step is two value sweeps under ``torch.func.vmap`` (`api.as_value_fn`;
no autograd anywhere), counted in ``ensemble_sample.value_evals`` (one
sweep over half the walkers counts one). The partner pick is a row gather
(``partner='gather'``, independent uniform partners) or one shared random
offset (``partner='shift'``, a roll). The step loop reads nothing from the
device; `ensemble_sample_from_state` reads the state's phase and step
once, counted in ``ensemble_sample.host_syncs``.

Walkers are not independent chains: `ensemble_autocorr_time` gives the
ensemble's integrated autocorrelation time (host numpy, as in JAX).
Non-finite logdensities are treated as -inf (a proposal outside the
support is rejected; a walker starting outside can still move in).

Randomness: each half-step's partner pick, stretch uniforms and accept
uniforms come from `_ensemble_half_noise`, seeded on the host from (key,
the ensemble's stream word, phase, step, half) as in
`sampling._step_noise`, so a chunked run equals a long one bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .api import as_value_fn
from .sampling import _ENSEMBLE_STREAM, _as_key, _counter, _full, _generator, _read_counters
from .utils.device import as_device_state, as_device_tensor
from .utils.placement import fleet, fleet_count, own_span

# the word that parts the host's shift-offset draw from the device's draws
_SHIFT_OFFSET = 1

__all__ = ["EnsembleResult", "EnsembleState", "ensemble_autocorr_time", "ensemble_sample",
           "ensemble_sample_from_state"]


class EnsembleState(NamedTuple):
    """Resumable stretch-move state. Per-step noise derives from (key,
    phase, step), so resumption needs only the counters. ``key`` is the
    (2,) int64 CPU tensor of `sampling`'s module docstring; every other
    leaf lives on the walkers' device."""

    x: torch.Tensor  # (walkers, n) current positions
    f: torch.Tensor  # (walkers,) logdensity at x (-inf outside support)
    key: torch.Tensor  # (2,) int64 on the CPU: the run's base key
    phase: torch.Tensor  # () int32: 0 = warmup, 1 = sampling
    step: torch.Tensor  # () int32 steps taken within the phase
    n_accept: torch.Tensor  # (walkers,) int32 accepted moves


class EnsembleResult(NamedTuple):
    """samples: (n_samples, walkers, n) post-warmup draws (one per full
    red-black step); accept_rate: (walkers,) sampling-phase acceptance;
    final_x: (walkers, n); state: resume via `ensemble_sample_from_state`.
    """

    samples: torch.Tensor
    accept_rate: torch.Tensor
    final_x: torch.Tensor
    state: EnsembleState

    @property
    def n_walkers(self) -> int:
        return self.final_x.shape[0]


def _ensemble_half_noise(key, phase, step, half, w2, partner, dtype, device):
    """(pick, u_z, u_acc) of half ``half`` (0 = A, 1 = B) of the full step
    at global ``step`` of ``phase``: the partners — a (w2,) index tensor
    for ``'gather'``, one offset (a Python int, drawn on the host) for
    ``'shift'`` — and the (w2,) uniforms of the stretch and of the accept
    test."""
    words = (_ENSEMBLE_STREAM, phase, step, half)
    gen = _generator(key, device, *words)
    if partner == "gather":
        pick = torch.randint(0, w2, (w2,), generator=gen, device=device)
    else:
        # the roll takes a Python int: the offset comes from a generator
        # of its own on the host
        host = _generator(key, "cpu", *words, _SHIFT_OFFSET)
        pick = int(torch.randint(0, w2, (), generator=host))
    u_z = torch.rand((w2,), generator=gen, dtype=dtype, device=device)
    u_acc = torch.rand((w2,), generator=gen, dtype=dtype, device=device)
    return pick, u_z, u_acc


def _finite_or_neg_inf(f):
    return torch.where(torch.isfinite(f), f, torch.full_like(f, -math.inf))


def _half_step(f_b, x_upd, f_upd, x_other, noise, a, partner, rows):
    """Stretch-move update of walkers ``rows`` (a slice of the half) of one
    half-ensemble against the whole other half ``x_other``; ``noise`` is
    the half's draw.

    y = x_j + z (x_i - x_j), z ~ g(z) ∝ 1/√z on [1/a, a] (inverse-CDF:
    z = ((a-1)u + 1)²/a), accepted with log-prob (n-1)·log z + f(y) - f(x).
    """
    _w2, n = x_upd.shape
    if _w2 == 0:  # a rank whose walkers all lie in the other half
        return x_upd, f_upd, torch.zeros((0,), dtype=torch.bool, device=x_upd.device)
    pick, u, u_acc = noise
    u, u_acc = u[rows], u_acc[rows]
    if partner == "gather":
        xj = torch.index_select(x_other, 0, pick[rows])
    else:  # 'shift'
        xj = torch.roll(x_other, pick, dims=0)[rows]
    a_ = _full(a, x_upd.dtype, x_upd.device)
    z = ((a_ - 1.0) * u + 1.0) ** 2 / a_
    y = xj + z[:, None] * (x_upd - xj)
    fy = _finite_or_neg_inf(f_b(y))
    log_acc = (n - 1) * torch.log(z) + fy - f_upd
    # -inf - -inf = NaN: a walker outside the support proposing outside
    # the support must reject, and NaN < anything is False
    accept = torch.log(u_acc) < log_acc
    x_new = torch.where(accept[:, None], y, x_upd)
    f_new = torch.where(accept, fy, f_upd)
    return x_new, f_new, accept


def _full_step(f_b, x, f, key, phase, step, a, partner):
    """One red-black sweep: update half A against B, then B against the
    updated A (the sequential scheme that keeps detailed balance with
    whole-half vectorization). ``x``, ``f`` are this rank's walkers, a
    contiguous span of the whole ensemble (all of it unsharded); each half
    is updated against the whole other half."""
    xs, fs = fleet(x), fleet(f)
    w2 = xs.shape[0] // 2
    lo, hi = own_span(x.shape[0])
    rows_a = slice(min(lo, w2), min(hi, w2))  # this rank's walkers in half A
    rows_b = slice(max(lo, w2) - w2, max(hi, w2) - w2)  # and in half B
    dtype, device = x.dtype, x.device
    xA, fA = xs[:w2][rows_a], fs[:w2][rows_a]
    noise = _ensemble_half_noise(key, phase, step, 0, w2, partner, dtype, device)
    xA, fA, accA = _half_step(f_b, xA, fA, xs[w2:], noise, a, partner, rows_a)
    # half B moves against the updated half A, the whole of it
    xs_A = fleet(torch.cat([xA, xs[w2:][rows_b]]))[:w2] if x.shape[0] < xs.shape[0] else xA
    xB, fB = xs[w2:][rows_b], fs[w2:][rows_b]
    noise = _ensemble_half_noise(key, phase, step, 1, w2, partner, dtype, device)
    xB, fB, accB = _half_step(f_b, xB, fB, xs_A, noise, a, partner, rows_b)
    ensemble_sample.value_evals += 2
    return torch.cat([xA, xB]), torch.cat([fA, fB]), torch.cat([accA, accB])


def _ensemble_run(obj, state: EnsembleState, n_samples, n_warmup, a, partner,
                  value_and_grad_fn, phase0, step0) -> EnsembleResult:
    """Remaining warmup (phase 0), then sampling (phase 1), from a state
    whose counters are ``phase0`` and ``step0``."""
    f_b = torch.func.vmap(as_value_fn(obj, value_and_grad_fn))
    x = state.x
    dtype, device = x.dtype, x.device
    # the cached logdensities, evaluated afresh only where unset
    ensemble_sample.value_evals += 1
    f = torch.where(torch.isnan(state.f), _finite_or_neg_inf(f_b(x)), state.f)
    n_acc, phase, step = state.n_accept, phase0, step0

    def run(x, f, n_acc, phase, step, n_steps, out=None):
        for i in range(n_steps):
            x, f, acc = _full_step(f_b, x, f, state.key, phase, step + i, a, partner)
            n_acc = n_acc + acc.to(torch.int32)
            if out is not None:
                out[i] = x
        return x, f, n_acc, step + n_steps

    # a resumed sampling-phase state skips warmup
    if n_warmup > 0 and phase == 0:
        x, f, n_acc, step = run(x, f, n_acc, 0, step, n_warmup)
    draws = torch.empty((n_samples,) + tuple(x.shape), dtype=dtype, device=device)
    if n_samples > 0:
        # the warmup -> sampling transition happens here: a run that ends
        # with n_samples == 0 stays in the warmup phase, so chunked warmup
        # resumes bit for bit; acceptance is a sampling-phase statistic
        if phase == 0:
            phase, step, n_acc = 1, 0, torch.zeros_like(n_acc)
        x, f, n_acc, step = run(x, f, n_acc, 1, step, n_samples, draws)
    # int32 / int32 divides in float32 in JAX, in either x64 mode
    accept_rate = n_acc.to(torch.float32) / max(step, 1)
    return EnsembleResult(
        samples=draws,
        accept_rate=accept_rate.to(dtype),
        final_x=x,
        state=EnsembleState(x=x, f=f, key=state.key, phase=_counter(phase, device),
                            step=_counter(step, device), n_accept=n_acc),
    )


def _validate(x0s, a, partner, n_samples, n_warmup, mass):
    if mass is not None:
        raise ValueError(
            "ensemble_sample takes no mass matrix — affine invariance IS "
            "the preconditioning (linear correlation/scaling cancels in "
            "the stretch move); drop mass= (mass_form/init handoffs do "
            "not apply to sampler='ensemble')"
        )
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (walkers, n), got shape {tuple(x0s.shape)}")
    w = fleet_count(x0s.shape[0])
    if w < 4 or w % 2 != 0:
        raise ValueError(
            f"need an even walker count >= 4 (red-black halves), got {w}; "
            "Goodman & Weare recommend >= 2n+2 walkers"
        )
    if not a > 1.0:
        raise ValueError(f"stretch scale a must be > 1, got {a}")
    if partner not in ("gather", "shift"):
        raise ValueError(
            f"partner must be 'gather' or 'shift', got {partner!r}"
        )
    if n_samples < 0 or n_warmup < 0:
        raise ValueError("n_samples and n_warmup must be >= 0")


def ensemble_sample(
    obj,
    key,
    x0s,
    n_samples: int = 1000,
    n_warmup: int = 500,
    a: float = 2.0,
    partner: str = "gather",
    value_and_grad_fn: Optional[Callable] = None,
    mass=None,
) -> EnsembleResult:
    """Sample with the affine-invariant stretch move — no gradients.

    ``x0s`` is the (walkers, n) initial ensemble (walkers even, >= 4;
    >= 2n+2 recommended — e.g. a jittered MAP fleet). ``a`` is the stretch
    scale (2.0 is the universal default). One draw is recorded per full
    red-black step. ``value_and_grad_fn`` is accepted for API uniformity
    (its value half is used only if ``obj`` provides no value-only form).

    ``key``: see `sampling`'s module docstring (a JAX key's two raw words
    or its typed form's words alike). ``x0s`` follows the entry points'
    device rule (`utils.device.as_device_tensor`).
    """
    x0s = as_device_tensor(x0s)
    _validate(x0s, a, partner, n_samples, n_warmup, mass)
    key = _as_key(key, ensemble_sample)
    walkers = x0s.shape[0]
    device = x0s.device
    state = EnsembleState(
        x=x0s,
        f=_full(math.nan, x0s.dtype, device, (walkers,)),
        key=key,
        phase=_counter(0, device),
        step=_counter(0, device),
        n_accept=torch.zeros((walkers,), dtype=torch.int32, device=device),
    )
    return _ensemble_run(obj, state, int(n_samples), int(n_warmup), float(a), partner,
                         value_and_grad_fn, 0, 0)


def ensemble_sample_from_state(
    obj,
    state: EnsembleState,
    n_samples: int = 0,
    n_warmup: int = 0,
    a: float = 2.0,
    partner: str = "gather",
    value_and_grad_fn: Optional[Callable] = None,
) -> EnsembleResult:
    """Continue (or checkpoint-chunk) a stretch-move run; chunked equals
    one long run bit for bit. Pass the same ``a``/``partner`` as the
    original run. ``n_warmup`` only applies while the state is still in
    the warmup phase. The phase and step are read once, counted in
    ``ensemble_sample.host_syncs``."""
    state = as_device_state(state)
    _validate(state.x, a, partner, n_samples, n_warmup, mass=None)
    phase0, step0 = _read_counters(ensemble_sample, state.phase, state.step)
    return _ensemble_run(obj, state, int(n_samples), int(n_warmup), float(a), partner,
                         value_and_grad_fn, phase0, step0)


ensemble_sample.host_syncs = 0
ensemble_sample.value_evals = 0


def ensemble_autocorr_time(samples, c: float = 5.0):
    """Integrated autocorrelation time per dimension (the emcee diagnostic,
    with Sokal's adaptive window as implemented in emcee).

    Walkers are not independent chains, so `diagnose_chains`' split
    R-hat/ESS overstate the information in a stretch-move run. The
    ensemble convention averages each walker's normalized autocorrelation
    function and reports τ(M) = 1 + 2 Σ_{t=1..M} ρ_t with M the least
    window with M >= c·τ(M). Effective samples ≈ draws·walkers / τ.
    Returns ``(tau, reliable)``, both (n,) numpy arrays: ``reliable`` is
    emcee's rule of thumb draws > 50·τ.

    Host-side numpy; accepts the (draws, walkers, n) samples as a tensor
    (copied to the host) or an array.
    """
    if isinstance(samples, torch.Tensor):
        samples = samples.detach().cpu().numpy()
    x = np.asarray(samples, np.float64)
    if x.ndim != 3 or x.shape[0] < 8:
        raise ValueError(
            "samples must be (draws >= 8, walkers, n), got shape "
            f"{x.shape}"
        )
    n_draw = x.shape[0]
    xc = x - x.mean(axis=0, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n_draw)))
    f = np.fft.rfft(xc, n=size, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=size, axis=0)[:n_draw].real
    # average the per-walker autocorrelation functions (emcee), guarding
    # frozen walkers (zero variance -> zero autocov contributions)
    acov = acov.mean(axis=1)  # (draws, n)
    denom = np.where(acov[0] > 0.0, acov[0], 1.0)
    rho = acov / denom[None, :]
    taus = 2.0 * np.cumsum(rho, axis=0) - 1.0  # τ(M) for every window M
    ts = np.arange(n_draw)[:, None]
    crossed = ts >= c * taus
    # first window satisfying Sokal's condition; none -> the full length
    has = crossed.any(axis=0)
    M = np.where(has, crossed.argmax(axis=0), n_draw - 1)
    tau = np.maximum(taus[M, np.arange(x.shape[-1])], 1.0)
    reliable = has & (n_draw > 50.0 * tau)
    return tau, reliable
