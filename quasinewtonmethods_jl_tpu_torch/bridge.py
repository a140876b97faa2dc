"""Bridge sampling: model evidence from the posterior draws already in hand —
the PyTorch port of ``quasinewtonmethods_jl_tpu/bridge.py``.

`laplace_evidence` is free but biased off the Gaussian; `ais_evidence` is
asymptotically exact but needs an annealing run of its own. Bridge
sampling (Meng & Wong 1996; the estimator behind the `bridgesampling` R
package, Gronau et al. 2017) turns N1 posterior draws, which the samplers
have already made, and N2 draws from a normalized proposal q2 (the Laplace
Gaussian at the MAP) into evidence through the optimal-bridge identity

    Z = E_q2[ p̃ h ] / E_p[ q2 h ],   h ∝ 1 / (s1 p̃ + s2 Z q2),

a fixed-point iteration for Ẑ. Cost beyond the draws: N1 + N2
logdensity evaluations (two vmapped sweeps, ``bridge_evidence.value_evals``)
and a few logsumexp sweeps an iteration — no gradients. It sees every
basin the chains visited (pair it with `pt_sample` on multimodal
targets), where Laplace integrates one.

JAX's ``while_loop`` over the fixed point is a Python loop of masked
bodies that reads its stop test from the device once every
`_READ_INTERVAL` bodies (as the fleet engines read theirs); a body after
the stop (``|r − r_prev| <= tol`` or ``it == max_iter``) freezes ``r``,
``r_prev`` and ``it``, so ``n_iter`` and ``delta`` equal JAX's whatever
the interval. The reads, and a fleet base's any-lane-converged test, are
counted in ``bridge_evidence.host_syncs``. All arithmetic is in log space.

Randomness: the proposal's standard normals come from `_bridge_noise`,
seeded on the host from (key, the bridge's stream word) as
`sampling._step_noise` is; ``key`` is what the samplers take.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .ais import _base_from
from .api import as_logdensity
from .sampling import _BRIDGE_STREAM, _as_key, _full, _generator
from .utils.device import as_device_tensor

__all__ = ["BridgeResult", "bridge_evidence"]

_LOG_2PI = math.log(2.0 * math.pi)
# fixed-point bodies between two reads of the stop test
_READ_INTERVAL = 8


class BridgeResult(NamedTuple):
    """logZ: the bridge-sampling evidence estimate (log marginal
    likelihood).
    n_iter: int32 fixed-point iterations used (== max_iter means the
    tolerance was not reached — inspect delta).
    delta: |last update| of log Ẑ (convergence certificate).
    re2: approximate relative mean-squared error of Ẑ (Frühwirth-
    Schnatter 2004 / Gronau et al. 2017, eq. 4.1) treating the draws as
    independent — a lower bound under autocorrelation; scale the
    posterior term by n_draws/ESS from `diagnose_chains` for a corrected
    value. sqrt(re2) ≈ the coefficient of variation of Ẑ.
    """

    logZ: torch.Tensor
    n_iter: torch.Tensor
    delta: torch.Tensor
    re2: torch.Tensor


def _bridge_noise(key, n2, n, dtype, device):
    """The standard-normal (n2, n) draw of the proposal (JAX's ``key``)."""
    gen = _generator(key, device, _BRIDGE_STREAM)
    return torch.randn((n2, n), generator=gen, dtype=dtype, device=device)


def _gauss_logpdf_and_draw(mu, cov, z):
    """The normalized proposal Gaussian's logpdf and its draws from the
    standard normal ``z``, dense or diagonal covariance."""
    n = mu.shape[0]
    if cov.ndim == 1:
        sd = torch.sqrt(cov)
        logdet = torch.sum(torch.log(cov))

        def logq2(x):
            d = (x - mu[None, :]) / sd[None, :]
            return -0.5 * torch.sum(d * d, dim=1) - 0.5 * (logdet + n * _LOG_2PI)

        return logq2, mu[None, :] + sd[None, :] * z
    L, info = torch.linalg.cholesky_ex(cov)
    chol = torch.where(info != 0, torch.full_like(L, math.nan), L)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))

    def logq2(x):
        d = torch.linalg.solve_triangular(chol, (x - mu[None, :]).T, upper=False)
        return -0.5 * torch.sum(d * d, dim=0) - 0.5 * (logdet + n * _LOG_2PI)

    return logq2, mu[None, :] + z @ chol.T


def _rel_var(logf, n_draws):
    """Var[f] / (n_draws · E[f]²) from log f, shifted by its max (the
    scale cancels)."""
    f = torch.exp(logf - torch.max(logf))
    mean = torch.mean(f)
    var = torch.mean((f - mean) ** 2) * n_draws / max(n_draws - 1.0, 1.0)
    return var / (mean * mean * n_draws)


def _bridge_core(obj, x1, mu, cov, key, max_iter, tol, n_proposal):
    ld = torch.func.vmap(as_logdensity(obj))
    dtype, device = x1.dtype, x1.device
    n1 = x1.shape[0]
    logq2_fn, x2 = _gauss_logpdf_and_draw(mu, cov, _bridge_noise(key, n_proposal, mu.shape[0],
                                                                 dtype, device))
    n2 = x2.shape[0]

    # log ratios l = log p̃(x) − log q2(x); a draw where the target is
    # -inf (outside support) contributes zero mass, never NaN
    l1 = ld(x1) - logq2_fn(x1)  # posterior draws
    l2 = ld(x2) - logq2_fn(x2)  # proposal draws
    bridge_evidence.value_evals += 2
    l1 = torch.where(torch.isnan(l1), torch.full_like(l1, -math.inf), l1)
    l2 = torch.where(torch.isnan(l2), torch.full_like(l2, -math.inf), l2)

    ls1 = torch.log(_full(n1 / (n1 + n2), dtype, device))
    ls2 = torch.log(_full(n2 / (n1 + n2), dtype, device))
    log_n1 = torch.log(_full(n1, dtype, device))
    log_n2 = torch.log(_full(n2, dtype, device))

    def step(r):
        # numerator: (1/N2) Σ_j p̃/(s1 p̃ + s2 Ẑ q2) at proposal draws
        num = torch.logsumexp(l2 - torch.logaddexp(ls1 + l2, ls2 + r), 0) - log_n2
        # denominator: (1/N1) Σ_i q2/(s1 p̃ + s2 Ẑ q2) at posterior draws
        den = torch.logsumexp(-torch.logaddexp(ls1 + l1, ls2 + r), 0) - log_n1
        return num - den

    tol = _full(tol, dtype, device)

    def running(r, r_prev, it):
        return (torch.abs(r - r_prev) > tol) & (it < max_iter)

    # init: simple importance sampling from the proposal (the r0 the
    # bridgesampling package uses); the fixed point is a contraction
    r0 = torch.logsumexp(l2, 0) - log_n2
    r, r_prev, it = step(r0), r0, torch.ones((), dtype=torch.int32, device=device)
    # it counts steps from 1, so at most max_iter - 1 bodies can change it
    for body in range(max_iter - 1):
        active = running(r, r_prev, it)
        if body % _READ_INTERVAL == 0:
            bridge_evidence.host_syncs += 1
            if not bool(active):
                break
        r, r_prev, it = (torch.where(active, step(r), r), torch.where(active, r, r_prev),
                         it + active.to(torch.int32))

    # relative MSE (iid draws): RE² = Var_q2[f1]/(N2 E[f1]²)
    #                               + Var_p[f2]/(N1 E[f2]²)
    # with f1 = p̃/(s1 p̃ + s2 Ẑ q2) on proposal draws and
    #      f2 = q2/(s1 p̃ + s2 Ẑ q2) on posterior draws
    logf1 = l2 - torch.logaddexp(ls1 + l2, ls2 + r)
    logf2 = -torch.logaddexp(ls1 + l1, ls2 + r)
    re2 = _rel_var(logf1, float(n2)) + _rel_var(logf2, float(n1))
    return BridgeResult(logZ=r, n_iter=it, delta=torch.abs(r - r_prev), re2=re2)


def bridge_evidence(
    obj,
    key,
    draws,
    base,
    n_proposal: Optional[int] = None,
    max_iter: int = 200,
    tol: float = 1e-10,
) -> BridgeResult:
    """Bridge-sampling log evidence from posterior draws + a Gaussian
    proposal.

    ``draws``: posterior samples — (N, n), or (n_samples, chains, n) as
    every sampler here returns them (flattened internally). They must
    target ``obj``.

    ``base``: the proposal Gaussian — a BFGS solve result (scalar or
    fleet; mode and curvature become N(x*, B)) or an explicit
    ``(mu, cov)`` with cov dense (n, n) or diagonal (n,), cast to the
    draws' dtype and device. ``n_proposal`` samples are drawn from it
    (default: as many as there are posterior draws). The proposal must
    overlap the posterior mass the draws occupy; ``result.re2`` blowing
    up (or n_iter == max_iter) is the symptom of a too-narrow proposal.

    ``key``: see `sampling`'s module docstring. Numpy draws follow the
    entry points' device rule (`utils.device.as_device_tensor`).
    """
    x1 = as_device_tensor(draws, "draws")
    if x1.ndim == 3:
        x1 = x1.reshape(-1, x1.shape[-1])
    if x1.ndim != 2:
        raise ValueError(
            f"draws must be (N, n) or (n_samples, chains, n), got "
            f"{tuple(x1.shape)}"
        )
    if max_iter < 1:
        raise ValueError("max_iter must be >= 1")
    if n_proposal is None:
        n_proposal = x1.shape[0]
    if n_proposal < 2:
        raise ValueError("n_proposal must be >= 2")
    mu, cov = _base_from(base, x1.dtype, x1.device, bridge_evidence)
    if mu.ndim != 1 or mu.shape[0] != x1.shape[1]:
        raise ValueError(
            f"base mean shape {tuple(mu.shape)} does not match draw dimension "
            f"{x1.shape[1]}"
        )
    if cov.ndim not in (1, 2):
        raise ValueError("base cov must be (n, n) dense or (n,) diagonal")
    return _bridge_core(obj, x1, mu, cov, _as_key(key, bridge_evidence), int(max_iter),
                        tol, int(n_proposal))


bridge_evidence.host_syncs = 0
bridge_evidence.value_evals = 0
