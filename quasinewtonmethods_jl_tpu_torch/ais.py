"""Annealed importance sampling and adaptive tempered SMC: model evidence —
the PyTorch port of ``quasinewtonmethods_jl_tpu/ais.py``.

`laplace_evidence` is exact for Gaussian posteriors and biased everywhere
else (skew, heavy tails, and by a whole basin on multimodal posteriors).
AIS (Neal 2001) anneals N particles from the Laplace Gaussian
q0 = N(x*, B) to the posterior p along

    pi_t(x) ∝ q0(x)^(1-b_t) · p(x)^(b_t),   0 = b_0 < ... < b_T = 1,

accumulating log-importance weights  Δlog w = (b_{t+1} − b_t)·(log p −
log q0)  and applying one tempered-target HMC move per rung, preconditioned
by the base covariance. E_q0[w] = Z since q0 is normalized, so

    log Ẑ = logsumexp(log w) − log N.

``schedule='adaptive'`` is adaptive tempered SMC (Del Moral–Doucet–Jasra
2012): each rung bisects the largest temperature increment whose ESS
criterion stays at ``adapt_target · N``, floored at the remaining-budget
linear split ``(1−b)/(rungs left)`` so that b reaches 1 within the
``n_steps`` cap.

The particle fleet is one (N, n) batch. JAX's ``lax.scan`` over rungs and
``fori_loop`` of leapfrog steps are Python loops of batched torch ops; a
leapfrog step evaluates the model's gradient over the fleet once
(`sampling._batched_objective`), plus one seed a rung, counted in
``ais_evidence.gradient_evals``. JAX's ``lax.cond`` on resampling is a
systematic resample computed every rung and selected by ``torch.where``,
so the fixed ladder reads nothing from the device. The adaptive anneal's
``while_loop`` is a Python loop capped at ``n_steps`` whose condition
b < 1 is read from the device before every rung but the first (b = 0
there), and once more when b reaches 1 before the cap; a fleet base's
any-lane-converged test is one more read. Every read is counted in
``ais_evidence.host_syncs``.

Randomness. JAX's draws cannot be reproduced; each kind of draw goes
through one seam, seeded on the host from (key, AIS's stream word, ...) as
`sampling._step_noise` is: `_ais_init_noise` (the base draw) and
`_ais_rung_noise` (a rung's momenta, Metropolis uniforms and resampling
uniform, drawn every rung whether or not it resamples). ``key`` is what
the samplers take (`sampling`'s module docstring).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .sampling import (
    _AIS_STREAM,
    _as_key,
    _as_mass_tensor,
    _batched_objective,
    _counter,
    _da_update,
    _full,
    _generator,
    chain_init_from_map,
)
from .state import Status
from .utils.device import as_device_tensor

__all__ = ["AISResult", "ais_evidence"]

_LOG_2PI = math.log(2.0 * math.pi)
# the adaptive anneal's bisection steps on the temperature increment
_BISECTION_STEPS = 30


class AISResult(NamedTuple):
    """logZ: the AIS evidence estimate (logsumexp(logw) − log N).
    logw: (N,) per-particle log weights (for stratified reuse).
    ess: scalar weight effective sample size in [1, N] — the reliability
    diagnostic (ess ≪ N means lengthen the anneal / check the base).
    accept_rate: (T,) fleet-mean HMC acceptance per rung (adaptive mode:
    zero-padded past ``n_rungs``).
    step_size: final adapted leapfrog step.
    n_resamples: scalar int32 count of SMC resampling events (0 in
    plain-AIS mode or when the weights never collapsed).
    final_x: (N, n) particles at b = 1 (posterior draws, weighted by w).
    betas: (T+1,) the temperature ladder actually used (adaptive mode:
    padded with 1.0 past ``n_rungs``).
    n_rungs: scalar int32 — rungs executed (== n_steps for a fixed
    schedule; ≤ n_steps when the adaptive anneal finishes early).
    """

    logZ: torch.Tensor
    logw: torch.Tensor
    ess: torch.Tensor
    accept_rate: torch.Tensor
    step_size: torch.Tensor
    n_resamples: torch.Tensor
    final_x: torch.Tensor
    betas: torch.Tensor
    n_rungs: torch.Tensor


def _ais_init_noise(key, N, n, dtype, device):
    """The standard-normal (N, n) draw of the base particles (JAX's
    ``k_init``)."""
    gen = _generator(key, device, _AIS_STREAM, 0)
    return torch.randn((N, n), generator=gen, dtype=dtype, device=device)


def _ais_rung_noise(key, t, N, n, dtype, device):
    """(z, u_accept, u0_resample) of rung ``t``: the standard-normal (N, n)
    momentum draw, the (N,) Metropolis uniforms and the resampling uniform
    (JAX's ``k1``, ``k2``, ``k3`` of ``fold_in(k_anneal, t)``)."""
    gen = _generator(key, device, _AIS_STREAM, 1, t)
    z = torch.randn((N, n), generator=gen, dtype=dtype, device=device)
    u = torch.rand((N,), generator=gen, dtype=dtype, device=device)
    u0 = torch.rand((), generator=gen, dtype=dtype, device=device)
    return z, u, u0


def _base_from(base, dtype, device, engine):
    """(mu, cov) in ``dtype`` on ``device`` from an explicit pair or a solve
    result (scalar or batched fleet — the Laplace base the MAP engines
    already produced). A fleet's any-lane-converged test is one device
    read, counted in ``engine.host_syncs``."""
    if isinstance(base, tuple) and len(base) == 2:
        mu, cov = base
        return _as_mass_tensor(mu, dtype, device), _as_mass_tensor(cov, dtype, device)
    x = getattr(base, "x", None)
    state = getattr(base, "state", None)
    if x is None or state is None or not hasattr(state, "B"):
        raise TypeError(
            "base must be a (mu, cov) pair or a BFGS solve result "
            "(OptimizeResult with a dense-B state); for L-BFGS fleets "
            "pass (x_map, mass) from chain_init_from_map explicitly"
        )
    if x.ndim == 2:  # fleet: best converged lane's mode, lane-averaged B
        ok = base.status == Status.CONVERGED
        engine.host_syncs += 1
        if not bool(torch.any(ok)):
            # a no-converged-lane fleet would silently anchor the base at
            # a failed iterate with an identity mass: refuse loudly
            raise ValueError(
                "ais_evidence: no lane of the base fleet converged — "
                "the Laplace base would be meaningless; fix the MAP "
                "solve or pass an explicit (mu, cov)"
            )
        fun = torch.where(ok, base.fun, torch.full_like(base.fun, -math.inf))
        mu = torch.index_select(x, 0, torch.argmax(fun).reshape(1))[0]
        _, cov = chain_init_from_map(base)
        return mu.to(device=device, dtype=dtype), cov.to(device=device, dtype=dtype)
    return x.to(device=device, dtype=dtype), state.B.to(device=device, dtype=dtype)


def _linear_ladder(T, dtype, device):
    """The (T+1,) ladder 0, 1/T, ..., 1 as JAX's ``linspace(0, 1, T+1)``
    evaluates it on the CPU: ``i * (1/T)`` with the reciprocal rounded in
    ``dtype``, the last entry exactly 1 (``torch.linspace`` and
    ``arange / T`` differ from it by an ulp on some rungs). Made on
    ``device`` itself: a host scalar written into a card tensor is a
    synchronization."""
    one = torch.ones((1,), dtype=dtype, device=device)
    return torch.cat([torch.arange(T, dtype=dtype, device=device) * (one / T), one])


def _systematic_resample(logw, x, q0x, px, u0):
    """Systematic resampling: ONE uniform stratifies N positions over the
    normalized-weight CDF (searchsorted + gather). Returns equal-weight
    particles."""
    N = logw.shape[0]
    w = torch.exp(logw - torch.logsumexp(logw, 0))
    cdf = torch.cumsum(w, 0)
    pos = (u0 + torch.arange(N, dtype=logw.dtype, device=logw.device)) / N
    idx = torch.clamp(torch.searchsorted(cdf, pos, right=False), 0, N - 1)
    return x[idx], q0x[idx], px[idx]


def _make_gaussian_base(mu, cov, diag_cov):
    """The base Gaussian q0 = N(mu, cov) and the cov-preconditioned HMC
    kinetics: (q0_draw, q0_val_grad, draw_p, kin, vel), the draws from a
    standard normal z. All through one Cholesky (diag: elementwise); a cov
    that is not positive definite gives a NaN factor, as JAX's, and no
    raise."""
    n = mu.shape[0]
    if diag_cov:
        sd = torch.sqrt(cov)
        logdet = torch.sum(torch.log(cov))

        def q0_draw(z):
            return mu[None, :] + sd[None, :] * z

        def q0_val_grad(x):
            d = (x - mu[None, :]) / cov[None, :]
            val = -0.5 * torch.sum((x - mu[None, :]) * d, dim=1) - 0.5 * (logdet + n * _LOG_2PI)
            return val, -d

        def draw_p(z):
            return z / sd[None, :]

        def kin(p):
            return 0.5 * torch.sum(cov[None, :] * p * p, dim=1)

        def vel(p):
            return cov[None, :] * p
    else:
        L, info = torch.linalg.cholesky_ex(cov)
        chol = torch.where(info != 0, torch.full_like(L, math.nan), L)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        prec = torch.cholesky_solve(torch.eye(n, dtype=cov.dtype, device=cov.device), chol)
        chol_u = chol.T

        def q0_draw(z):
            return mu[None, :] + z @ chol.T

        def q0_val_grad(x):
            d = (x - mu[None, :]) @ prec  # (N, n) = Σ⁻¹ (x − mu) rows
            val = -0.5 * torch.sum((x - mu[None, :]) * d, dim=1) - 0.5 * (logdet + n * _LOG_2PI)
            return val, -d

        def draw_p(z):
            return torch.linalg.solve_triangular(chol_u, z.T, upper=True).T

        def kin(p):
            return 0.5 * torch.sum((p @ cov) * p, dim=1)

        def vel(p):
            return p @ cov.T

    return q0_draw, q0_val_grad, draw_p, kin, vel


def _tempered_hmc_move(x, q0x, px, b1, eps, z, u, n_leapfrog, base, p_val_grad):
    """One fleet HMC move targeting pi_{b1} ∝ q0^(1-b1) · p^(b1),
    preconditioned by the base covariance. Returns the post-Metropolis
    (x, q0x, px) and the fleet acceptance probabilities."""
    _q0_draw, q0_val_grad, draw_p, kin, vel = base
    p0 = draw_p(z)

    def grad_t(xx):
        qv, qg = q0_val_grad(xx)
        pv, pg = p_val_grad(xx)
        return qv, pv, (1.0 - b1) * qg + b1 * pg

    # the gradient and both values ride the carry: one evaluation a
    # leapfrog step plus the seed, and the Metropolis values come free
    q0_new, p_val_new, g = grad_t(x)
    x_new, p_new = x, p0
    for _ in range(n_leapfrog):
        p_new = p_new + 0.5 * eps * g
        x_new = x_new + eps * vel(p_new)
        q0_new, p_val_new, g = grad_t(x_new)
        p_new = p_new + 0.5 * eps * g
    ais_evidence.gradient_evals += n_leapfrog + 1
    logpi_old = (1.0 - b1) * q0x + b1 * px
    logpi_new = (1.0 - b1) * q0_new + b1 * p_val_new
    log_ratio = (logpi_new - kin(p_new)) - (logpi_old - kin(p0))
    a_prob = torch.exp(torch.clamp_max(log_ratio, 0.0))
    a_prob = torch.where(torch.isfinite(a_prob), a_prob, torch.zeros_like(a_prob))
    acc = u < a_prob
    x = torch.where(acc[:, None], x_new, x)
    q0x = torch.where(acc, q0_new, q0x)
    px = torch.where(acc, p_val_new, px)
    return x, q0x, px, a_prob


def _weight_ess(logw):
    """exp(2·lse(w) − lse(w²)): the weight effective sample size."""
    return torch.exp(2.0 * torch.logsumexp(logw, 0) - torch.logsumexp(2.0 * logw, 0))


def _finite_or_neg_inf(dw):
    """A weight increment, -inf where it is not finite: failed or
    overflowed particles carry -inf weight, not NaN poison."""
    return torch.where(torch.isfinite(dw), dw, torch.full_like(dw, -math.inf))


class _Anneal:
    """The particle fleet both anneals carry, its base and the rung they
    share: the weight update, resampling, one tempered HMC move and the
    dual-averaging update of the step."""

    def __init__(self, obj, key, mu, cov, n_particles, n_leapfrog, step_size, target_accept,
                 value_and_grad_fn, resample, resample_threshold):
        self.vag_b, f_b = _batched_objective(obj, value_and_grad_fn)
        self.key, self.N, self.n_leapfrog, self.resample = key, n_particles, n_leapfrog, resample
        self.n = mu.shape[0]
        self.dtype, self.device = mu.dtype, mu.device
        self.target_accept = target_accept
        self.threshold = _full(resample_threshold, self.dtype, self.device) * self.N
        self.log_n = torch.log(_full(self.N, self.dtype, self.device))
        self.base = _make_gaussian_base(mu, cov, cov.ndim == 1)
        self.x = self.base[0](_ais_init_noise(key, self.N, self.n, self.dtype, self.device))
        self.q0x, _ = self.base[1](self.x)
        self.px = f_b(self.x)
        self.logw = torch.zeros((self.N,), dtype=self.dtype, device=self.device)
        self.logz_acc = torch.zeros((), dtype=self.dtype, device=self.device)
        self.n_resamp = _counter(0, self.device)
        eps0 = _full(step_size, self.dtype, self.device)
        self.mu_da = torch.log(10.0 * eps0)
        self.log_eps = self.log_eps_bar = torch.log(eps0)
        self.h_bar = self.t_da = torch.zeros((), dtype=self.dtype, device=self.device)

    def reweigh(self, db):
        """Weight the CURRENT particles (before the move) by the increment
        db of the temperature."""
        self.logw = self.logw + _finite_or_neg_inf(db * (self.px - self.q0x))

    def rung(self, t, b1):
        """Resample (when the weights collapsed), move towards pi_{b1} and
        adapt the step: returns the fleet-mean acceptance."""
        z, u, u0 = _ais_rung_noise(self.key, t, self.N, self.n, self.dtype, self.device)
        if self.resample:
            # SMC: when the weight ESS collapses, bank the partial evidence
            # (logsumexp(w) − log N) and restart equal weights on
            # resampled particles
            lse_t = torch.logsumexp(self.logw, 0)
            do = torch.exp(2.0 * lse_t - torch.logsumexp(2.0 * self.logw, 0)) < self.threshold
            xr, q0r, pr = _systematic_resample(self.logw, self.x, self.q0x, self.px, u0)
            self.x = torch.where(do, xr, self.x)
            self.q0x = torch.where(do, q0r, self.q0x)
            self.px = torch.where(do, pr, self.px)
            self.logw = torch.where(do, torch.zeros_like(self.logw), self.logw)
            self.logz_acc = torch.where(do, self.logz_acc + lse_t - self.log_n, self.logz_acc)
            self.n_resamp = self.n_resamp + do.to(torch.int32)
        self.x, self.q0x, self.px, a_prob = _tempered_hmc_move(
            self.x, self.q0x, self.px, b1, torch.exp(self.log_eps), z, u, self.n_leapfrog,
            self.base, self.vag_b)
        mean_a = torch.mean(a_prob)
        self.log_eps, self.log_eps_bar, self.h_bar, self.t_da = _da_update(
            self.h_bar, self.log_eps_bar, self.t_da, self.target_accept - mean_a, self.mu_da)
        return mean_a

    def result(self, accept_rate, betas, n_rungs):
        lse = torch.logsumexp(self.logw, 0)
        return AISResult(
            logZ=self.logz_acc + lse - self.log_n,
            logw=self.logw,
            ess=torch.exp(2.0 * lse - torch.logsumexp(2.0 * self.logw, 0)),
            accept_rate=accept_rate,
            step_size=torch.exp(self.log_eps),
            n_resamples=self.n_resamp,
            final_x=self.x,
            betas=betas,
            n_rungs=_counter(n_rungs, self.device),
        )


def _ais_core(anneal: _Anneal, betas) -> AISResult:
    """The fixed ladder: T rungs, no device read."""
    T = betas.shape[0] - 1
    accs = torch.zeros((T,), dtype=anneal.dtype, device=anneal.device)
    for t in range(T):
        anneal.reweigh(betas[t + 1] - betas[t])
        accs[t] = anneal.rung(t, betas[t + 1])
    return anneal.result(accs, betas, T)


def _smc_adaptive_core(anneal: _Anneal, n_steps, adapt_target) -> AISResult:
    """Adaptive tempered SMC: rungs run under a Python loop capped at
    ``n_steps``; each rung bisects the temperature increment db so the
    post-update ESS criterion lands on ``adapt_target · N`` (the largest
    db that keeps it there), floored at the remaining-budget linear split
    so b reaches 1 by the cap."""
    T, dtype, device = n_steps, anneal.dtype, anneal.device
    one = torch.ones((), dtype=dtype, device=device)
    ess_target = _full(adapt_target, dtype, device) * anneal.N
    n_full = _full(anneal.N, dtype, device)
    b = torch.zeros((), dtype=dtype, device=device)
    acc_buf = torch.zeros((T,), dtype=dtype, device=device)
    beta_buf = torch.cat([torch.zeros((1,), dtype=dtype, device=device),
                          torch.ones((T,), dtype=dtype, device=device)])
    t = 0
    while t < T:
        if t > 0:  # b = 0 before the first rung
            ais_evidence.host_syncs += 1
            if not bool(b < one):
                break
        logw = anneal.logw
        delta = anneal.px - anneal.q0x  # (N,) the per-particle log-weight slope in b

        if anneal.resample:
            # the combined-weight ESS, which resampling resets
            def crit_ess(db):
                return _weight_ess(logw + _finite_or_neg_inf(db * delta))
        else:
            # without resampling the combined ESS never rises again, so the
            # criterion is the conditional ESS of the increment
            # (Zhou–Johansen–Aston 2016): N·(Σ Ŵ·w)²/(Σ Ŵ·w²) with Ŵ the
            # normalized carried weights and w = exp(db·delta)
            lW = logw - torch.logsumexp(logw, 0)

            def crit_ess(db):
                dw = _finite_or_neg_inf(db * delta)
                return n_full * torch.exp(2.0 * torch.logsumexp(lW + dw, 0)
                                          - torch.logsumexp(lW + 2.0 * dw, 0))

        rem = one - b
        # the largest db in (0, rem] with the criterion >= target
        full_ok = crit_ess(rem) >= ess_target
        lo, hi = torch.zeros_like(rem), rem
        for _ in range(_BISECTION_STEPS):
            mid = 0.5 * (lo + hi)
            ok = crit_ess(mid) >= ess_target
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        db = torch.where(full_ok, rem, lo)
        # remaining-budget floor: termination at the cap, the linear ladder
        # when the target is unreachable
        db = torch.minimum(torch.maximum(db, rem / float(T - t)), rem)
        b1 = torch.where(db >= rem, one, b + db)
        anneal.reweigh(b1 - b)
        acc_buf[t] = anneal.rung(t, b1)
        beta_buf[t + 1] = b1
        b = b1
        t += 1
    return anneal.result(acc_buf, beta_buf, t)


def ais_evidence(
    obj,
    key,
    base,
    n_particles: int = 1024,
    n_steps: int = 64,
    n_leapfrog: int = 8,
    step_size: float = 0.2,
    target_accept: float = 0.8,
    schedule=1.0,
    resample: bool = False,
    resample_threshold: float = 0.5,
    adapt_target: float = 0.5,
    value_and_grad_fn: Optional[Callable] = None,
) -> AISResult:
    """Annealed-importance-sampling log evidence from a Laplace base.

    ``base``: a BFGS solve result (scalar or fleet — mode x* and
    curvature B become the base Gaussian q0 = N(x*, B); for a fleet the
    best converged lane's mode and the converged-lane-averaged B), or an
    explicit ``(mu, cov)`` pair with ``cov`` dense (n, n) or diagonal
    (n,) — e.g. `chain_init_from_map`'s mass for L-BFGS fleets.

    ``n_steps`` rungs anneal q0 → posterior (one fleet HMC move per rung,
    preconditioned by the base covariance, step size dual-averaged along
    the anneal); ``schedule``: a float power p gives b_t = (t/T)^p (p > 1
    spends rungs near the base, p = 1 linear), an explicit (n_steps+1,)
    array from 0 to 1, or ``'adaptive'`` for adaptive tempered SMC — each
    rung bisects the largest temperature increment keeping an ESS
    criterion at ``adapt_target · n_particles``; ``n_steps`` becomes a
    cap (``result.n_rungs`` reports rungs used and ``result.betas`` the
    ladder found, padded with 1.0). With ``resample=True`` the criterion
    is the combined-weight ESS the resampler acts on; without it, the
    conditional ESS of each increment (CESS).

    ``resample=True`` upgrades plain AIS to an SMC sampler: whenever the
    weight ESS drops below ``resample_threshold · n_particles``, the
    partial evidence logsumexp(w) − log N is banked into the estimate and
    the particles systematically resample to equal weights;
    `result.n_resamples` reports how often it fired.

    `result.logZ` estimates log Z (unbiased in the weights); compare
    `laplace_evidence` to measure the Gaussian approximation's error.
    `result.ess` ≪ n_particles means the anneal is too short or the base
    too narrow.

    ``key``: see `sampling`'s module docstring. A numpy or list base pair
    follows the entry points' device rule (`utils.device.as_device_tensor`):
    the card, in float32; a tensor keeps its device and dtype.
    """
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    x_probe = getattr(base, "x", base[0] if isinstance(base, tuple) else None)
    if x_probe is None:
        raise TypeError("base must be a solve result or a (mu, cov) pair")
    x_probe = as_device_tensor(x_probe, "base")
    mu, cov = _base_from(base, x_probe.dtype, x_probe.device, ais_evidence)
    if mu.ndim != 1:
        raise ValueError(f"base mean must be (n,), got {tuple(mu.shape)}")
    if cov.ndim not in (1, 2):
        raise ValueError("base cov must be (n, n) dense or (n,) diagonal")
    if not (0.0 < resample_threshold < 1.0):
        raise ValueError("resample_threshold must be in (0, 1)")
    adaptive = isinstance(schedule, str)
    if adaptive:
        if schedule != "adaptive":
            raise ValueError(
                f"schedule must be a power, an array, or 'adaptive'; "
                f"got {schedule!r}"
            )
        if not (0.0 < adapt_target < 1.0):
            raise ValueError("adapt_target must be in (0, 1)")
    elif isinstance(schedule, (int, float)):
        if schedule <= 0:
            raise ValueError("schedule power must be > 0")
        betas = _linear_ladder(n_steps, mu.dtype, mu.device) ** float(schedule)
    else:
        betas = _as_mass_tensor(schedule, mu.dtype, mu.device)
        if tuple(betas.shape) != (n_steps + 1,):
            raise ValueError(
                f"schedule array must be ({n_steps + 1},), got {tuple(betas.shape)}"
            )
    anneal = _Anneal(obj, _as_key(key, ais_evidence), mu, cov, int(n_particles),
                     int(n_leapfrog), step_size, target_accept, value_and_grad_fn, resample,
                     resample_threshold)
    if adaptive:
        return _smc_adaptive_core(anneal, int(n_steps), adapt_target)
    return _ais_core(anneal, betas)


ais_evidence.host_syncs = 0
ais_evidence.gradient_evals = 0
