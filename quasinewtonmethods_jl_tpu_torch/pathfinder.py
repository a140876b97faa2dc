"""Multi-path Pathfinder: L-BFGS-trajectory variational inference — the
PyTorch port of ``quasinewtonmethods_jl_tpu/pathfinder.py``.

Pathfinder (Zhang, Carpenter, Gelman, Vehtari 2022) runs L-BFGS toward the
mode and, at every iterate, builds the local Gaussian that the quadratic
model implies there,

    q_j = N( x_j + H_j g_j,  H_j ),

with H_j the L-BFGS inverse-Hessian estimate. It estimates each q_j's ELBO
by Monte Carlo, keeps the best one per path, pools draws from K paths and
Pareto-smoothed-importance-resamples the pool into posterior draws. The
selected metric is also exposed as the samplers' `LowRankMass`
(`PathfinderResult.mass`), so ``pathfinder → chees/nuts`` hands over both
the starting draws and a correlation-aware preconditioner.

The port runs the K paths as one fleet: JAX's ``vmap`` over paths of a
``lax.scan`` of ``max_iters`` steps is a Python loop of ``max_iters``
masked bodies over (K, ...) tensors, with no early exit (the scan has
none). The curvature pairs, the direction and the spectral factorization
H = γ(I − QQᵀ) + Q diag(σ) Qᵀ are the port's scalar L-BFGS ops
(`ops.lbfgs.lbfgs_push`, `ops.lbfgs_compact`) under ``torch.func.vmap``
over paths, as in JAX. JAX's scalar line search under ``vmap`` is a masked
lockstep search with the scalar search's rules lane by lane
(`_lockstep_linesearch`); each of its rounds reads one flag from the
device, the only reads of the loop besides the one ``torch.linalg.eigh``
makes on a CUDA tensor to check its result, all counted in
``pathfinder.host_syncs``. ``pathfinder.gradient_evals`` counts the
fleet-wide objective evaluations (one evaluation over every path, or over
the pool, counts one).

Randomness. ``jax.random`` streams cannot be reproduced, so every draw goes
through a module-level seam, a pure function of its arguments seeded on the
host (`sampling._generator`) under Pathfinder's own stream word: the start
jitter, the ELBO normals of each iteration, the pool normals and the Gumbel
noise of the resample (JAX's ``categorical`` is the argmax of Gumbel noise
plus the log weights, and so is the port's). The tests inject JAX's draws
through them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .api import _pin_matmul_precision
from .batched_solve import _armijo_propose, _batched_wolfe, _ls_consts
from .ops.lbfgs import lbfgs_push
from .ops.lbfgs_compact import lbfgs_direction_compact, lbfgs_lowrank_inv_hessian
from .ops.linesearch import BackTracking
from .ops.wolfe import Wolfe
from .sampling import _PATHFINDER_STREAM, LowRankMass, _as_key, _batched_objective, _generator
from .state import Status
from .utils.device import as_device_tensor
from .utils.scalars import finite_halving_limit

__all__ = ["PathfinderResult", "pathfinder", "psis_smooth", "gpd_fit_khat"]

_RUNNING = int(Status.RUNNING)
_CONVERGED = int(Status.CONVERGED)
_MAX_ITERATIONS = int(Status.MAX_ITERATIONS)
_LINESEARCH_FAILURE = int(Status.LINESEARCH_FAILURE)
_NONFINITE_VALUE = int(Status.NONFINITE_VALUE)

# ---------------------------------------------------------------------------
# closed-form Gaussian ops in the spectral low-rank basis
#   H = gamma * (I - Q Q^T) + Q diag(sig) Q^T,  Q (n, r) orthonormal
# over leading batch axes: gamma (...), Q (..., n, r), sig (..., r), and
# points (..., m, n), m points per Gaussian


def _apply_sqrt_H(gamma, Q, sig, xi):
    """H^(1/2) xi for xi (..., m, n) — the exact symmetric square root."""
    xiQ = xi @ Q  # (..., m, r)
    return (torch.sqrt(gamma)[..., None, None] * (xi - xiQ @ Q.mT)
            + (torch.sqrt(sig)[..., None, :] * xiQ) @ Q.mT)


def _apply_H(gamma, Q, sig, v):
    """H v for v (..., m, n)."""
    vQ = v @ Q
    return gamma[..., None, None] * (v - vQ @ Q.mT) + (sig[..., None, :] * vQ) @ Q.mT


def _logdet_H(gamma, sig, n):
    r = sig.shape[-1]
    return (n - r) * torch.log(gamma) + torch.sum(torch.log(sig), dim=-1)


def _log_q(gamma, Q, sig, logdet, mu, z):
    """log N(z | mu, H) for z (..., m, n) (or (m, n), shared by every
    Gaussian of the batch) in the spectral form."""
    n = mu.shape[-1]
    d = z - mu[..., None, :]
    dQ = d @ Q  # (..., m, r)
    quad = ((torch.sum(d * d, -1) - torch.sum(dQ * dQ, -1)) / gamma[..., None]
            + torch.sum(dQ * dQ / sig[..., None, :], -1))
    return -0.5 * (n * math.log(2.0 * math.pi) + logdet[..., None] + quad)


# ---------------------------------------------------------------------------
# randomness: the seams (module docstring)

_INIT, _ELBO, _POOL, _RESAMPLE = 0, 1, 2, 3


def _pathfinder_init_noise(key, K, n, dtype, device):
    """The (K, n) standard-normal start jitter (JAX: ``k_init``)."""
    gen = _generator(key, device, _PATHFINDER_STREAM, _INIT)
    return torch.randn((K, n), generator=gen, dtype=dtype, device=device)


def _pathfinder_elbo_noise(key, it, K, E, n, dtype, device):
    """The (K, E, n) standard-normal ELBO draws of iteration ``it`` (JAX:
    path p's key after ``it`` splits, its first half)."""
    gen = _generator(key, device, _PATHFINDER_STREAM, _ELBO, it)
    return torch.randn((K, E, n), generator=gen, dtype=dtype, device=device)


def _pathfinder_pool_noise(key, K, R, n, dtype, device):
    """The (K, R, n) standard-normal pool draws (JAX: ``k_pool``)."""
    gen = _generator(key, device, _PATHFINDER_STREAM, _POOL)
    return torch.randn((K, R, n), generator=gen, dtype=dtype, device=device)


def _pathfinder_resample_noise(key, n_draws, S, dtype, device):
    """The (n_draws, S) standard Gumbel noise of the resample (JAX:
    ``gumbel(k_res)``, -log(-log u) with u uniform on [tiny, 1))."""
    gen = _generator(key, device, _PATHFINDER_STREAM, _RESAMPLE)
    u = torch.rand((n_draws, S), generator=gen, dtype=dtype, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))


# ---------------------------------------------------------------------------
# the line search of every path in lockstep


def _lockstep_backtracking(phi, f0, m, active, ls: BackTracking):
    """JAX's scalar backtracking search (ops/linesearch.py) lane by lane:
    phase A halves alpha while the trial is non-finite, phase B is the
    Armijo loop with its own budget. Lanes not ``active`` are frozen.
    Returns (alpha, failed, n_fev, reads)."""
    dtype, device = f0.dtype, f0.device
    c1, rho_hi, rho_lo, eps, sqrttol = _ls_consts(ls, dtype, device)
    one = torch.ones_like(f0)
    a1 = a2 = one
    fx1 = phi(one)
    n_fev = torch.ones(f0.shape, dtype=torch.int32, device=device)
    doomed = ~(torch.isfinite(m) & torch.isfinite(f0))
    live = active & ~doomed
    reads = 0
    halvings = torch.zeros_like(n_fev)
    limit = finite_halving_limit(dtype)
    while True:
        lane = live & ~torch.isfinite(fx1) & (halvings < limit)
        reads += 1
        if not bool(lane.any()):
            break
        a1 = torch.where(lane, a2, a1)
        a2 = torch.where(lane, 0.5 * a2, a2)
        fx1 = torch.where(lane, phi(a2), fx1)
        halvings = halvings + lane
        n_fev = n_fev + lane

    fx0 = f0
    it = torch.zeros_like(n_fev)

    def sufficient():
        return fx1 >= f0 + a2 * c1 * m

    while True:
        lane = live & ~sufficient() & (it < ls.iterations)
        reads += 1
        if not bool(lane.any()):
            break
        it = it + lane
        a1, a2 = _armijo_propose(m, f0, a1, a2, fx0, fx1, it, lane, ls, eps, sqrttol, rho_hi,
                                 rho_lo)
        fx0 = torch.where(lane, fx1, fx0)
        fx1 = torch.where(lane, phi(a2), fx1)
        n_fev = n_fev + lane
    alpha = torch.where(active & sufficient(), a2, torch.zeros_like(a2))
    return alpha, alpha == 0.0, n_fev, reads


def _lockstep_linesearch(ls, f_b, vag_b, X, d, f0, m, active):
    """JAX's ``run_linesearch`` under ``vmap`` over the rows of X: (alpha,
    failed, extra_fev, extra_gev, reads), lanes not ``active`` frozen.
    BackTracking trials are value-only; Wolfe trials are value and gradient
    and count toward both counters."""
    if isinstance(ls, Wolfe):

        def phi_vag(alpha):
            fv, gv = vag_b(X + alpha[:, None] * d)
            return fv, (gv * d).sum(1), gv

        alpha, n_ev, _it, _failed, _fa, _ga, reads = _batched_wolfe(
            phi_vag, f0, m, active, ls, f0.dtype)
        return alpha, alpha == 0.0, n_ev, n_ev, reads
    if not isinstance(ls, BackTracking):
        raise TypeError(f"ls must be a BackTracking or a Wolfe, got {type(ls).__name__}")

    def phi(alpha):
        return f_b(X + alpha[:, None] * d)

    alpha, failed, n_fev, reads = _lockstep_backtracking(phi, f0, m, active, ls)
    return alpha, failed, n_fev, torch.zeros_like(n_fev), reads


# ---------------------------------------------------------------------------
# the fleet of paths


class _Best(NamedTuple):
    elbo: torch.Tensor  # (K,)
    mu: torch.Tensor  # (K, n)
    gamma: torch.Tensor  # (K,)
    Q: torch.Tensor  # (K, n, r)
    sig: torch.Tensor  # (K, r)
    logdet: torch.Tensor  # (K,)


def _paths(vag_b, f_b, x0s, key, history, max_iters, elbo_draws, ls, tol):
    """Run K Pathfinder paths from x0s (K, n) in lockstep; returns (_Best,
    best_iter, status, iterations, n_fev, n_gev), each with a leading K."""
    K, n = x0s.shape
    dtype, device = x0s.dtype, x0s.device
    E = elbo_draws
    r = min(2 * history, n)  # the factorization's rank (reduced QR)
    tol = torch.full((), tol, dtype=dtype, device=device)
    push = torch.func.vmap(lbfgs_push)
    lowrank = torch.func.vmap(lbfgs_lowrank_inv_hessian)
    direction = torch.func.vmap(lbfgs_direction_compact)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    best = _Best(elbo=torch.full((K,), -math.inf, dtype=dtype, device=device),
                 mu=zeros(K, n), gamma=torch.ones(K, dtype=dtype, device=device),
                 Q=zeros(K, n, r), sig=torch.ones(K, r, dtype=dtype, device=device),
                 logdet=zeros(K))
    x, grad_old, step = x0s, zeros(K, n), zeros(K, n)
    S, Y, rho = zeros(K, history, n), zeros(K, history, n), zeros(K, history)
    hist = zeros(K, dt=torch.int32)
    gamma = torch.ones(K, dtype=dtype, device=device)
    active = torch.ones(K, dtype=torch.bool, device=device)
    status = torch.full((K,), _RUNNING, dtype=torch.int32, device=device)
    n_fev, n_gev = zeros(K, dt=torch.int32), zeros(K, dt=torch.int32)
    trace_elbo, trace_active = [], []
    log2pi = n * math.log(2.0 * math.pi)

    for it in range(max_iters):
        f0, g = vag_b(x)
        was_active = active
        nonfinite = ~torch.isfinite(f0)

        # the curvature pair of the previous accepted step
        S, Y, rho, hist, gamma = push(S, Y, rho, hist, gamma, step, grad_old - g)

        # the candidate Gaussian at this iterate
        gam_h, Q, sig = lowrank(S, Y, hist, gamma)
        if device.type == "cuda":  # eigh reads its status from the card
            pathfinder.host_syncs += 1
        logdet = _logdet_H(gam_h, sig, n)
        mu = x + _apply_H(gam_h, Q, sig, g[:, None, :])[:, 0]
        xi = _pathfinder_elbo_noise(key, it, K, E, n, dtype, device)
        zs = mu[:, None, :] + _apply_sqrt_H(gam_h, Q, sig, xi)
        # with z = mu + H^(1/2) xi the quadratic form is exactly |xi|^2
        logq = -0.5 * (log2pi + logdet[:, None] + torch.sum(xi * xi, -1))
        logp = f_b(zs.reshape(K * E, n)).reshape(K, E)
        elbo = torch.mean(logp - logq, -1)
        # -inf unless this step was a live, finite candidate: the same value
        # feeds the running argmax and the trace the winner's index comes from
        elbo_eff = torch.where(was_active & ~nonfinite & torch.isfinite(elbo), elbo,
                               torch.full_like(elbo, -math.inf))
        consider = elbo_eff > best.elbo
        best = _Best(
            elbo=torch.where(consider, elbo_eff, best.elbo),
            mu=torch.where(consider[:, None], mu, best.mu),
            gamma=torch.where(consider, gam_h, best.gamma),
            Q=torch.where(consider[:, None, None], Q, best.Q),
            sig=torch.where(consider[:, None], sig, best.sig),
            logdet=torch.where(consider, logdet, best.logdet),
        )
        trace_elbo.append(elbo_eff)
        trace_active.append(was_active)

        # the L-BFGS advance, masked where a path is done
        converged = torch.amax(torch.abs(g), dim=1) < tol
        d, m = direction(S, Y, rho, hist, gamma, g)
        reset = m <= 0.0
        d = torch.where(reset[:, None], g, d)
        m = torch.where(reset, torch.sum(g * g, 1), m)
        hist = torch.where(reset, torch.zeros_like(hist), hist)
        gamma = torch.where(reset, torch.ones_like(gamma), gamma)

        # every path live at the body's start searches and is counted, one
        # that just converged or went non-finite included (its step is
        # discarded below)
        alpha, ls_failed, ls_fev, ls_gev, reads = _lockstep_linesearch(
            ls, f_b, vag_b, x, d, f0, m, was_active)
        pathfinder.host_syncs += reads
        advance = was_active & ~nonfinite & ~converged
        take = advance & ~ls_failed
        step = torch.where(take[:, None], alpha[:, None] * d, torch.zeros_like(d))
        status = torch.where(
            nonfinite & was_active, _NONFINITE_VALUE,
            torch.where(converged & was_active, _CONVERGED,
                        torch.where(ls_failed & advance, _LINESEARCH_FAILURE, status)),
        ).to(torch.int32)
        x = x + step
        grad_old = g
        active = take
        n_fev = n_fev + torch.where(was_active, 1 + ls_fev + E, 0).to(torch.int32)
        n_gev = n_gev + torch.where(was_active, 1 + ls_gev, 0).to(torch.int32)

    # the winner's trajectory index, recovered from the effective ELBO trace
    if max_iters:
        first_max = torch.argmax(torch.stack(trace_elbo), dim=0).to(torch.int32)
        iterations = torch.stack(trace_active).to(torch.int32).sum(0, dtype=torch.int32)
    else:
        first_max = iterations = zeros(K, dt=torch.int32)
    best_iter = torch.where(torch.isfinite(best.elbo), first_max, torch.full_like(first_max, -1))
    status = torch.where(status == _RUNNING, _MAX_ITERATIONS, status).to(torch.int32)
    return best, best_iter, status, iterations, n_fev, n_gev


# ---------------------------------------------------------------------------
# Pareto-smoothed importance sampling (Vehtari, Simpson, Gelman, Yao, Gabry
# 2024): static shapes, no branch on the data


def _tail_size(S: int) -> int:
    """M, the number of largest weights the GPD is fitted to."""
    M = int(math.ceil(min(0.2 * S, 3.0 * math.sqrt(S))))
    return max(min(M, S - 1), 5) if S > 6 else max(S // 2, 1)


def _x_star_index(M: int) -> int:
    return max(int(M / 4.0 + 0.5) - 1, 0)


def gpd_fit_khat(x_sorted: torch.Tensor) -> tuple:
    """Zhang–Stephens (2009) profile-likelihood fit of a generalized Pareto
    to ascending-sorted, nonnegative exceedances (..., M), a fit per row.
    Returns (khat, sigma). Includes the weak prior regularization arviz/loo
    apply (khat <- (M*khat + 5*0.5) / (M + 10))."""
    x = x_sorted
    M = x.shape[-1]
    m_grid = 30 + int(math.floor(math.sqrt(M)))
    jj = torch.arange(1, m_grid + 1, dtype=x.dtype, device=x.device)
    x_star = x[..., _x_star_index(M)]
    x_max = x[..., -1]
    b = 1.0 / x_max[..., None] + (1.0 - torch.sqrt(m_grid / (jj - 0.5))) / (3.0 * x_star[..., None])
    # Zhang–Stephens' shape k(b) = -mean log(1 - b x), the NEGATIVE of the
    # Coles/Vehtari xi that the PSIS quantiles use
    k_b = -torch.mean(torch.log1p(-b[..., :, None] * x[..., None, :]), dim=-1)
    l_b = M * (torch.log(b / k_b) + k_b - 1.0)
    w = torch.softmax(l_b, dim=-1)
    b_hat = torch.sum(w * b, dim=-1)
    k_zs = -torch.mean(torch.log1p(-b_hat[..., None] * x), dim=-1)
    khat = -k_zs  # Coles shape xi
    sigma = k_zs / b_hat
    return (M * khat + 10.0 * 0.5) / (M + 10.0), sigma


def _psis_smooth_rows(logw: torch.Tensor) -> tuple:
    """`psis_smooth` of every row of logw (B, S) in one batched pass:
    (smoothed (B, S), khat (B,))."""
    S = logw.shape[-1]
    M = _tail_size(S)
    dtype, device = logw.dtype, logw.device
    order = torch.argsort(logw, dim=-1, stable=True)
    logw_sorted = torch.gather(logw, -1, order)
    log_cut = logw_sorted[:, S - M - 1, None]  # threshold (stays unsmoothed)
    log_max = logw_sorted[:, -1, None]
    tail = logw_sorted[:, S - M:]
    # exceedances on the ratio scale, shifted by the cut for stability
    exc = torch.expm1(tail - log_cut) * torch.exp(log_cut - log_max)
    # degenerate tails (ties at the cut, non-finite values) skip the fit,
    # which divides by the first-quartile exceedance and the maximum;
    # khat = -inf signals "no tail"
    idx = _x_star_index(M)
    finite = torch.isfinite(exc).all(-1) & (exc[:, -1] > 0) & (exc[:, idx] > 0)
    exc_safe = torch.where(finite[:, None], exc,
                           torch.linspace(0.1, 1.0, M, dtype=torch.float64, device=device).to(dtype))
    khat, sigma = gpd_fit_khat(exc_safe)
    khat, sigma = khat[:, None], sigma[:, None]
    p = (torch.arange(1, M + 1, dtype=dtype, device=device) - 0.5) / M
    # the GPD's inverse CDF over the threshold; k -> 0 is the exponential
    q = torch.where(torch.abs(khat) < 1e-6, -sigma * torch.log1p(-p),
                    sigma / khat * (torch.pow(1.0 - p, -khat) - 1.0))
    smoothed = log_max + torch.log(q + torch.exp(log_cut - log_max))
    smoothed = torch.minimum(smoothed, log_max)  # truncate at the maximum
    smoothed = torch.where(finite[:, None], smoothed, tail)
    out = torch.cat([logw_sorted[:, :S - M], smoothed], dim=-1)
    # back to the original positions
    result = torch.empty_like(out).scatter_(-1, order, out)
    return result, torch.where(finite, khat[:, 0], torch.full_like(khat[:, 0], -math.inf))


def psis_smooth(logw: torch.Tensor) -> tuple:
    """Pareto-smooth a vector of log importance weights.

    Fits a GPD to the largest ``M = ceil(min(0.2 S, 3 sqrt(S)))`` weights
    (on the raw-ratio scale, threshold = the (S-M)-th order statistic),
    replaces them with the fitted quantiles, truncates at the raw maximum,
    and returns ``(smoothed_logw, khat)``. khat > 0.7 means the proposal
    is unreliable (Vehtari et al. 2024 threshold); -inf means the tail was
    degenerate and was left as it was. No host read."""
    logw = as_device_tensor(logw, "logw")
    out, khat = _psis_smooth_rows(logw[None])
    return out[0], khat[0]


# ---------------------------------------------------------------------------
# the public API


class PathfinderResult(NamedTuple):
    """Draws + per-path variational diagnostics.

    ``draws`` are the PSIS-resampled posterior draws (n_draws, n);
    ``khat`` the Pareto diagnostic of the pooled importance weights
    (> 0.7 = unreliable proposal — fall back to sampler warmup);
    ``elbo``/``best_iter``/``status``/``iterations`` are per-path (K,);
    ``mu``/``gamma``/``Q``/``sig`` the selected Gaussians (leading K axis);
    ``pool``/``pool_logw`` the pre-resampling proposal pool;
    ``logp_draws`` the target log-density at ``draws``.
    """

    draws: torch.Tensor
    khat: torch.Tensor
    elbo: torch.Tensor
    best_iter: torch.Tensor
    status: torch.Tensor
    iterations: torch.Tensor
    mu: torch.Tensor
    gamma: torch.Tensor
    Q: torch.Tensor
    sig: torch.Tensor
    pool: torch.Tensor
    pool_logw: torch.Tensor
    logp_draws: torch.Tensor
    n_fev: torch.Tensor
    n_gev: torch.Tensor

    def mass(self, path: Optional[int] = None) -> LowRankMass:
        """The selected inverse Hessian as a sampler metric (`LowRankMass`)
        — the covariance handoff for chees/nuts. ``path=None`` picks the
        highest-ELBO path (one read of the ELBOs)."""
        i = int(torch.argmax(self.elbo)) if path is None else int(path)
        return LowRankMass(gamma=self.gamma[i], Q=self.Q[i], sig=self.sig[i])


@_pin_matmul_precision
def _pathfinder_run(obj, key, x0, n_paths, n_draws, draws_per_path, history, max_iters,
                    elbo_draws, ls, tol, init_scale, value_and_grad_fn) -> PathfinderResult:
    vag_raw, f_raw = _batched_objective(obj, value_and_grad_fn)

    def vag_b(x):
        pathfinder.gradient_evals += 1
        return vag_raw(x)

    def f_b(x):
        pathfinder.gradient_evals += 1
        return f_raw(x)

    n = x0.shape[-1]
    dtype, device = x0.dtype, x0.device
    if x0.ndim == 1:
        x0s = x0[None, :] + init_scale * _pathfinder_init_noise(key, n_paths, n, dtype, device)
    else:
        x0s = x0
    K = x0s.shape[0]
    best, best_iter, status, iterations, n_fev, n_gev = _paths(
        vag_b, f_b, x0s, key, history, max_iters, elbo_draws, ls, tol)

    valid = torch.isfinite(best.elbo)  # paths whose every iterate failed drop out

    # the proposal pool: draws_per_path from each selected Gaussian
    R = draws_per_path
    xi = _pathfinder_pool_noise(key, K, R, n, dtype, device)
    pool = (best.mu[:, None, :] + _apply_sqrt_H(best.gamma, best.Q, best.sig, xi)).reshape(K * R, n)

    # the uniform mixture's log q over the valid paths
    logq_all = _log_q(best.gamma, best.Q, best.sig, best.logdet, best.mu, pool)  # (K, K*R)
    logq_all = torch.where(valid[:, None], logq_all, torch.full_like(logq_all, -math.inf))
    n_valid = torch.clamp(torch.sum(valid.to(dtype)), min=1.0)
    logq_mix = torch.logsumexp(logq_all, dim=0) - torch.log(n_valid)

    logp_pool = f_b(pool)
    logw = logp_pool - logq_mix
    # draws of invalid paths are excluded outright
    path_of = torch.arange(K, device=device).repeat_interleave(R)
    logw = torch.where(valid[path_of] & torch.isfinite(logw), logw,
                       torch.full_like(logw, -math.inf))

    logw_smooth, khat = _psis_smooth_rows(logw[None])
    logw_smooth, khat = logw_smooth[0], khat[0]
    gumbel = _pathfinder_resample_noise(key, n_draws, K * R, dtype, device)
    idx = torch.argmax(gumbel + logw_smooth, dim=-1)
    return PathfinderResult(
        draws=pool[idx],
        khat=khat,
        elbo=best.elbo,
        best_iter=best_iter,
        status=status,
        iterations=iterations,
        mu=best.mu,
        gamma=best.gamma,
        Q=best.Q,
        sig=best.sig,
        pool=pool,
        pool_logw=logw_smooth,
        logp_draws=logp_pool[idx],
        n_fev=n_fev,
        n_gev=n_gev,
    )


def pathfinder(
    obj,
    key,
    x0,
    n_paths: int = 8,
    n_draws: int = 1000,
    draws_per_path: Optional[int] = None,
    history: int = 8,
    max_iters: int = 64,
    elbo_draws: int = 16,
    ls: BackTracking = BackTracking(),
    tol: float = 1e-5,
    init_scale: float = 2.0,
    value_and_grad_fn: Optional[Callable] = None,
) -> PathfinderResult:
    """Multi-path Pathfinder variational inference (see module docstring).

    ``obj`` is any objective this package accepts (maximization
    convention — a log-density). ``key`` is an int seed, a
    ``torch.Generator`` or the two uint32 words of a JAX key, as the
    samplers take it. ``x0`` is either an (n,) center (each path starts at
    ``x0 + init_scale * normal``) or explicit (K, n) starts (overrides
    ``n_paths``); a tensor keeps its device and dtype, other input goes to
    the card (`utils.device.as_device_tensor`). Returns PSIS-resampled
    ``draws`` plus per-path ELBOs, the Pareto ``khat`` reliability
    diagnostic, and the selected low-rank Gaussians (``.mass()`` converts
    the best one into the samplers' `LowRankMass` metric for a chees/nuts
    handoff).

    Wall cost ≈ one L-BFGS fleet of ``n_paths`` lanes with ``elbo_draws``
    extra objective evaluations per iteration, all batched; memory is
    O(paths · n · history) — nothing per-iterate is retained but the (K,)
    ELBO trace. The loop's device reads are counted in
    ``pathfinder.host_syncs`` (module docstring).
    """
    x0 = as_device_tensor(x0, "x0")
    if not x0.is_floating_point():
        x0 = x0.to(torch.float32)  # JAX's default float with x64 off
    if x0.ndim == 2:
        n_paths = x0.shape[0]
    elif x0.ndim != 1:
        raise ValueError(f"x0 must be rank-1 or rank-2, got shape {tuple(x0.shape)}")
    if draws_per_path is None:
        draws_per_path = max(1, (4 * n_draws) // max(n_paths, 1))
    key = _as_key(key, pathfinder)
    return _pathfinder_run(obj, key, x0, n_paths, n_draws, draws_per_path, history, max_iters,
                           elbo_draws, ls, tol, init_scale, value_and_grad_fn)


pathfinder.host_syncs = 0
pathfinder.gradient_evals = 0
