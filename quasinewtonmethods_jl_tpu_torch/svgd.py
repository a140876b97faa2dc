"""Stein variational gradient descent: deterministic particle inference —
the PyTorch port of ``quasinewtonmethods_jl_tpu/svgd.py``.

A fleet of particles descends the KL divergence to the posterior along the
kernel Stein direction

    φ(x_i) = (1/B) Σ_j [ k(x_j, x_i) ∇log p(x_j) + ∇_{x_j} k(x_j, x_i) ]

— the first term transports particles toward probability mass, the second
repulses them apart so that the fleet approximates the posterior instead
of collapsing onto the mode (Liu & Wang 2016).

The interaction is dense (B, B) linear algebra: the pairwise squared
distances (one ``X @ Xᵀ``) and both φ terms (``K @ G``, ``K @ X``) are
matrix products, the gradient fleet is one vmapped sweep, and the step
loop is a Python loop of ``n_steps`` bodies over the fleet with no
data-dependent control flow and no read from the device (SVGD is
deterministic given the particles; there is no accept/reject). The
median-heuristic bandwidth is recomputed on the device each step, and the
steps follow the paper's AdaGrad rule. `SVGDState` resumes a run: a
chunked run equals a long one bit for bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .api import _pin_matmul_precision
from .diagnostics import _quantile_t
from .sampling import _batched_objective
from .utils.device import as_device_state, as_device_tensor

__all__ = ["SVGDResult", "SVGDState", "svgd_sample", "svgd_sample_from_state"]

SVGD_STEPS_DEFAULT = 500


class SVGDState(NamedTuple):
    """Resumable SVGD carry: particles + AdaGrad accumulator + step count."""

    x: torch.Tensor  # (B, n) particles
    acc: torch.Tensor  # (B, n) AdaGrad squared-gradient accumulator
    k: torch.Tensor  # () int32 steps executed


class SVGDResult(NamedTuple):
    """particles ~ posterior; logp/grad are the final fleet evaluations
    (diagnostics — NaN lanes mean the objective failed at that particle)."""

    particles: torch.Tensor  # (B, n)
    logp: torch.Tensor  # (B,)
    grad: torch.Tensor  # (B, n) ∇log p at the particles
    bandwidth: torch.Tensor  # () final median-heuristic h
    n_steps: torch.Tensor  # () int32 total steps
    state: SVGDState  # resumable via svgd_sample_from_state


def _pairwise_sq(X):
    """(B, B) squared distances by the xxᵀ expansion — one matrix product."""
    sq = torch.sum(X * X, dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)
    return torch.clamp(d2, min=0.0)


def _phi(X, G, d2, h):
    """The kernel Stein direction of the whole fleet:

    K_ij = exp(−‖x_i − x_j‖² / h);
    φ_i = (1/B)[ (KᵀG)_i + (2/h)(x_i·Σ_j K_ij − (KᵀX)_i ) ]  (K symmetric).
    """
    B = X.shape[0]
    K = torch.exp(-d2 / h)
    ksum = torch.sum(K, dim=-1)
    drive = K @ G
    repulse = (2.0 / h) * (X * ksum[:, None] - K @ X)
    return (drive + repulse) / B


_MEDIAN_CAP = 65536  # elements fed to the per-step median sort


def _median_bandwidth(d2, B, dtype):
    """med(‖xi−xj‖²)/log(B+1), floored away from zero (a collapsed fleet
    must not divide by 0 — the floor re-inflates it via the repulsion).

    Above _MEDIAN_CAP elements the median runs on a fixed-stride subsample
    of the (B, B) matrix (deterministic, so a resume equals a long run);
    an even count takes the mean of the two middle values, as
    ``jnp.median`` does, and a NaN gives NaN."""
    flat = d2.reshape(-1)
    m = flat.shape[0]
    if m > _MEDIAN_CAP:
        flat = flat[:: m // _MEDIAN_CAP][:_MEDIAN_CAP]
    med = _quantile_t(flat, 0.5, midpoint=True)
    h = med / torch.log(torch.full((), B + 1.0, dtype=dtype, device=d2.device))
    return torch.clamp(h, min=1e-10)


def _svgd_loop(vag_fleet, X, acc, k, n_steps, step_size, alpha, fudge):
    B = X.shape[0]
    dtype = X.dtype
    for _ in range(n_steps):
        f, G = vag_fleet(X)
        # failed particles (NaN objective or gradient) freeze in place and
        # stop influencing the fleet: their kernel row stays, their
        # gradient contribution is zeroed
        bad = ~(torch.isfinite(f) & torch.all(torch.isfinite(G), dim=-1))
        G = torch.where(bad[:, None], torch.zeros_like(G), G)
        d2 = _pairwise_sq(X)
        h = _median_bandwidth(d2, B, dtype)
        phi = _phi(X, G, d2, h)
        # AdaGrad (Liu & Wang 2016, alg. 1): a per-coordinate step with a
        # momentum-smoothed accumulator
        acc = torch.where(k == 0, phi * phi, alpha * acc + (1.0 - alpha) * phi * phi)
        step = step_size * phi / (fudge + torch.sqrt(acc))
        step = torch.where(bad[:, None], torch.zeros_like(step), step)
        X, k = X + step, k + 1
    return X, acc, k


@_pin_matmul_precision
def _svgd_run(obj, X0, acc0, k0, value_and_grad_fn, n_steps, step_size, alpha, fudge):
    vag_fleet = _batched_objective(obj, value_and_grad_fn)[0]
    X, acc, k = _svgd_loop(vag_fleet, X0, acc0, k0, n_steps, step_size, alpha, fudge)
    f, G = vag_fleet(X)
    h = _median_bandwidth(_pairwise_sq(X), X.shape[0], X.dtype)
    return SVGDResult(particles=X, logp=f, grad=G, bandwidth=h, n_steps=k,
                      state=SVGDState(x=X, acc=acc, k=k))


def _check_steps(n_steps, step_size=None):
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if step_size is not None and not float(step_size) > 0.0:
        raise ValueError(f"step_size must be > 0, got {step_size}")


def svgd_sample(
    obj,
    x0s,
    *,
    n_steps: int = SVGD_STEPS_DEFAULT,
    step_size: float = 0.1,
    alpha: float = 0.9,
    fudge: float = 1e-6,
    value_and_grad_fn: Optional[Callable] = None,
) -> SVGDResult:
    """Transport a particle fleet toward the posterior of ``obj`` by SVGD.

    ``x0s``: (B, n) initial particles (spread them — e.g. MAP-jittered or
    prior draws; SVGD is DETERMINISTIC, all the randomness there is lies
    in the starts); a tensor keeps its device and dtype, other input goes
    to the card (`utils.device.as_device_tensor`). Runs exactly
    ``n_steps`` kernel-Stein steps (no convergence test: there is no
    accept/reject — monitor moments across a resume if needed) and reads
    nothing from the device while it runs.

    Bandwidth: the median heuristic med‖xi−xj‖²/log(B+1), recomputed every
    step. Steps: the SVGD paper's AdaGrad rule (per coordinate;
    ``step_size``/``alpha``/``fudge`` are its knobs).

    Particles whose objective evaluates non-finite freeze in place and
    stop contributing gradient drive (in-band — inspect ``result.logp``
    for NaN lanes). Composes with `transforms.transform_objective` for
    constrained posteriors as every sampler here does.

    SVGD places particles well but underestimates the covariance in
    higher dimensions (the known variance collapse, which shrinks slowly
    with more particles): use it for representative points, chain
    initialization and visualisation, and the HMC family for calibrated
    posterior moments.
    """
    X0 = as_device_tensor(x0s, "x0s")
    if X0.ndim != 2:
        raise ValueError(f"x0s must be (particles, n), got {tuple(X0.shape)}")
    if X0.shape[0] < 2:
        raise ValueError("SVGD needs >= 2 particles (the repulsion term is pairwise)")
    _check_steps(n_steps, step_size)
    k0 = torch.zeros((), dtype=torch.int32, device=X0.device)
    return _svgd_run(obj, X0, torch.zeros_like(X0), k0, value_and_grad_fn, int(n_steps),
                     float(step_size), float(alpha), float(fudge))


def svgd_sample_from_state(
    obj,
    state: SVGDState,
    *,
    n_steps: int = SVGD_STEPS_DEFAULT,
    step_size: float = 0.1,
    alpha: float = 0.9,
    fudge: float = 1e-6,
    value_and_grad_fn: Optional[Callable] = None,
) -> SVGDResult:
    """Continue an SVGD run for ``n_steps`` MORE steps.

    Chunked == long run EXACTLY: the carry (particles, AdaGrad
    accumulator, step count) is the whole memory of the algorithm and
    every step is deterministic. The step knobs must match the original
    run's (the accumulator is a quantity of that schedule). Numpy leaves
    go to the card, as `svgd_sample`'s input does."""
    _check_steps(n_steps)
    state = as_device_state(state)
    return _svgd_run(obj, state.x, state.acc, state.k, value_and_grad_fn, int(n_steps),
                     float(step_size), float(alpha), float(fudge))
