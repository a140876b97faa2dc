"""Replica-exchange (parallel tempering) HMC over fleet axes — the PyTorch
port of ``quasinewtonmethods_jl_tpu/tempering.py``.

A single-temperature sampler started in one basin of a multimodal
posterior essentially never crosses to another; replica exchange is the
standard fix. The temperature ladder × chain fleet is one (K, C, n) batch:
every replica advances through the same leapfrog loop in lockstep (the
tempered gradient beta_k·∇f is a broadcast scale), and the exchange move
is an even–odd sweep over adjacent temperature pairs, a masked shift along
the small leading axis. Every chain column swaps independently, so C
chains give C independent tempering ladders.

  * one HMC step per replica per round (velocity Verlet, ``n_leapfrog``
    steps; the gradient over all K·C replicas is one
    `sampling._batched_objective` call, ``n_leapfrog + 1`` a round, since
    JAX seeds the gradient afresh each round — counted in
    ``pt_sample.gradient_evals``), per-temperature step size adapted by
    dual averaging on that temperature's fleet-mean acceptance;
  * exchange every ``swap_every`` rounds, alternating even/odd pairs by
    the global sweep parity; the host owns the round index, so the swap
    cadence and parity are Python ints and a round without a swap skips
    the swap's arithmetic;
  * optional warmup ladder adaptation (``adapt_ladder=True``): anchored
    swap-rate equalization of the log-spacings;
  * the cached per-replica logdensity is untempered, so a swap never
    re-evaluates the objective; samples are the cold (beta = 1) row.

Neither loop reads the device; `pt_sample`'s validation of an explicit
ladder on the card and `pt_sample_from_state`'s phase counters are one
counted read each (``pt_sample.host_syncs``).

Randomness: each round's momenta, HMC uniforms and swap uniforms come from
`_pt_round_noise`, seeded on the host from (key, replica exchange's
stream word, phase, round) as in `sampling._step_noise`, so a chunked run
replays one long run exactly.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .sampling import (
    _MASS_ADAPT_MIN_CHAINS,
    _PT_STREAM,
    _apply_mass,
    _as_key,
    _as_mass_tensor,
    _batched_objective,
    _counter,
    _da_update,
    _full,
    _generator,
    _kinetic,
    _mass_setup,
    _momentum,
    _read_counters,
)
from .utils.device import as_device_state, as_device_tensor
from .utils.placement import fleet, fleet_count, own_rows

__all__ = ["PTState", "PTResult", "pt_sample", "pt_sample_from_state", "geometric_ladder"]

# ladder adaptation: EMA weight for per-pair swap acceptance, base rate
# and decay scale (in swap sweeps) for the multiplicative spacing update
_LADDER_EMA = 0.2
_LADDER_KAPPA0 = 0.4
_LADDER_T0 = 50.0
# adapt_mass: per-rung fleet-variance EMA weight
_MASS_EMA = 0.15
# log10(x) = log(x) * this, as the JAX package's geomspace computes it
_LOG10_E = 0.43429448190325182


class PTState(NamedTuple):
    """Resumable replica-exchange state: per-round noise derives from
    (key, phase, round), so chunking needs only the counters. ``key`` is
    the (2,) int64 CPU tensor of `sampling`'s module docstring; every
    other leaf lives on the replicas' device."""

    x: torch.Tensor  # (K, C, n) replica positions (row 0 = cold)
    f: torch.Tensor  # (K, C) untempered logdensity at x
    betas: torch.Tensor  # (K,) inverse temperatures, betas[0] == 1
    log_eps: torch.Tensor  # (K,) per-temperature DA iterate
    log_eps_bar: torch.Tensor  # (K,) averaged iterate (the frozen eps)
    h_bar: torch.Tensor  # (K,) DA error accumulator
    t_da: torch.Tensor  # () DA step count
    mu: torch.Tensor  # () DA shrink target log(10 * eps0)
    key: torch.Tensor  # (2,) int64 on the CPU: the run's base key
    i_warm: torch.Tensor  # () int32 warmup rounds completed
    i_samp: torch.Tensor  # () int32 sampling rounds completed
    swap_acc: torch.Tensor  # (K-1,) summed swap accept probabilities
    swap_att: torch.Tensor  # (K-1,) swap attempts (per adjacent pair)
    swap_ema: torch.Tensor  # (K-1,) per-pair acceptance EMA (ladder adapt)
    tag: torch.Tensor  # (K, C) int32 replica-flow tag (0 unset, 1 last
    # visited the cold end, 2 the hot end) — rides the swaps
    round_trips: torch.Tensor  # (C,) int32 completed hot→cold transits
    var_ema: torch.Tensor  # (K, n) per-rung fleet-variance EMA (adapt_mass)


class PTResult(NamedTuple):
    """samples: (n_samples, C, n) cold-chain draws.
    accept_rate: (K,) fleet-mean HMC acceptance per temperature.
    swap_rate: (K-1,) mean exchange acceptance per adjacent pair
    (cumulative over the whole run, warmup included).
    step_size: (K,) adapted per-temperature leapfrog step.
    betas: (K,) the ladder sampled with (adapted if adapt_ladder).
    round_trips: (C,) per-chain completed replica round trips over the
    whole run.
    energies: (n_samples, C) cold-row Hamiltonians at each HMC
    transition's selected point (recorded before the exchange).
    divergences: (C,) int32 cold-row divergent-transition counts over
    sampling.
    final_x: (K, C, n) last replica positions.
    state: PTState — resume via `pt_sample_from_state`."""

    samples: torch.Tensor
    accept_rate: torch.Tensor
    swap_rate: torch.Tensor
    step_size: torch.Tensor
    betas: torch.Tensor
    round_trips: torch.Tensor
    energies: torch.Tensor
    divergences: torch.Tensor
    final_x: torch.Tensor
    state: PTState


def _pt_round_noise(key, phase, step, K, C, n, dtype, device):
    """(z, u_hmc, u_swap) of round ``step`` of ``phase`` (0 warmup, 1
    sampling): the standard-normal momentum draw (K·C, n) in row order
    (temperature-major), the HMC uniforms (K, C) and the swap uniforms
    (K-1, C), the last drawn every round, with or without a swap."""
    gen = _generator(key, device, _PT_STREAM, phase, step)
    z = torch.randn((K * C, n), generator=gen, dtype=dtype, device=device)
    u_hmc = torch.rand((K, C), generator=gen, dtype=dtype, device=device)
    u_swap = torch.rand((max(K - 1, 0), C), generator=gen, dtype=dtype, device=device)
    return z, u_hmc, u_swap


def geometric_ladder(n_temps: int, beta_min: float = 0.05, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """The standard geometric inverse-temperature ladder
    1 = beta_0 > ... > beta_{K-1} = beta_min, computed in ``dtype`` as the
    JAX package's ``geomspace`` computes it (float32 as JAX with x64 off:
    the ``beta_min`` end of the 8-rung 0.05 ladder is 0.049999993).
    Geometric spacing gives roughly constant swap acceptance between
    neighbours on Gaussian-like targets."""
    if n_temps < 1:
        raise ValueError("n_temps must be >= 1")
    if n_temps == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    if not (0.0 < beta_min < 1.0):
        raise ValueError("beta_min must be in (0, 1)")
    # made on ``device`` itself: a host tensor copied to the card would be a
    # synchronization
    lo = torch.log(_full(beta_min, dtype, device)) * _LOG10_E
    div = n_temps - 1
    step = torch.arange(div, dtype=dtype, device=device) / _full(float(div), dtype, device)
    # linspace(log10(1) = 0, log10(beta_min)) with its end exact, then 10**
    lin = torch.cat([lo * step, lo[None]])
    return torch.pow(_full(10.0, dtype, device), lin)


def _ladder_adapt(betas, swap_ema, sweep_idx):
    """Anchored swap-rate equalization: redistribute the ladder's
    log-spacings multiplicatively toward equal per-pair acceptance.
    Endpoints stay pinned (total log-span conserved)."""
    s = torch.log(betas[:-1]) - torch.log(betas[1:])  # (K-1,) > 0 spacings
    sweep = _full(sweep_idx, betas.dtype, betas.device)
    kappa = _LADDER_KAPPA0 / (1.0 + sweep / _LADDER_T0)
    # above-average pairs widen, below-average shrink
    s_new = s * torch.exp(kappa * (swap_ema - torch.mean(swap_ema)))
    s_new = s_new * (torch.sum(s) / torch.sum(s_new))  # conserve the span
    log_b = torch.cat([torch.zeros((1,), dtype=betas.dtype, device=betas.device),
                       -torch.cumsum(s_new, dim=0)])
    return torch.exp(log_b)


def _pt_core(obj, state: PTState, mass, n_samples, n_warmup, n_leapfrog, swap_every,
             target_accept, adapt_ladder, adapt_mass, value_and_grad_fn, i_warm0,
             i_samp0) -> PTResult:
    vag_b, f_b = _batched_objective(obj, value_and_grad_fn)
    K, C, n = state.x.shape
    dtype, device = state.x.dtype, state.x.device
    mass_b, chol_u = _mass_setup(mass, n, dtype, device)

    def f_all(x):  # (K, C, n) -> (K, C), untempered
        return f_b(x.reshape(K * C, n)).reshape(K, C)

    def vag_all(x):  # (K, C, n) -> ((K, C), (K, C, n)), untempered
        pt_sample.gradient_evals += 1
        f, g = vag_b(x.reshape(K * C, n))
        return f.reshape(K, C), g.reshape(K, C, n)

    # metric ops: with adapt_mass a per-temperature (K, n) diagonal, else
    # the shared preconditioner. The exchange move reads only f, so
    # per-row metrics leave swap validity untouched
    if adapt_mass:
        def draw_p(z, m):
            return z.reshape(K, C, n) / torch.sqrt(m)[:, None, :]

        def kin(p, m):
            return 0.5 * torch.sum(m[:, None, :] * p * p, dim=2)

        def vel(p, m):
            return m[:, None, :] * p
    else:
        def draw_p(z, m):
            return _momentum(z, mass_b, chol_u).reshape(K, C, n)

        def kin(p, m):
            return _kinetic(p.reshape(K * C, n), mass_b).reshape(K, C)

        def vel(p, m):
            return _apply_mass(mass_b, p.reshape(K * C, n)).reshape(K, C, n)

    def leapfrog(x, p, eps, betas, m):
        """Velocity Verlet on the tempered targets (dp/dt = +beta·∇f), eps
        (K,) per temperature: the end point, its momentum and its
        logdensity (the last gradient evaluation's value)."""
        if n_leapfrog == 0:
            return x, p, f_all(x)
        e = eps[:, None, None]
        b = betas[:, None, None]
        _f, g = vag_all(x)
        for _ in range(n_leapfrog):
            p = p + 0.5 * e * (b * g)
            x = x + e * vel(p, m)
            f_new, g = vag_all(x)
            p = p + 0.5 * e * (b * g)
        return x, p, f_new

    def hmc_move(x, f, eps, betas, m, z, u):
        """One tempered HMC step on every replica: the new (x, f), the
        (K, C) acceptance probabilities and the cold row's energy and
        divergence flag."""
        p = draw_p(z, m)
        kin0 = kin(p, m)
        x_new, p_new, f_new = leapfrog(x, p, eps, betas, m)
        kin1 = kin(p_new, m)
        log_ratio = betas[:, None] * (f_new - f) - (kin1 - kin0)
        a_prob = torch.exp(torch.clamp_max(log_ratio, 0.0))
        a_prob = torch.where(torch.isfinite(a_prob), a_prob, torch.zeros_like(a_prob))
        acc = u < a_prob
        x = torch.where(acc[:, :, None], x_new, x)
        f = torch.where(acc, f_new, f)
        # the cold row's Hamiltonian at the transition's selected point
        e_cold = torch.where(acc[0], kin1[0] - f_new[0], kin0[0] - f[0])
        div_cold = ~torch.isfinite(log_ratio[0]) | (log_ratio[0] < -1000.0)
        return x, f, a_prob, e_cold, div_cold

    pair_on_parity = [(torch.arange(max(K - 1, 0), device=device) % 2) == parity
                      for parity in (0, 1)]
    zrow = torch.zeros((1, C), dtype=torch.bool, device=device)
    # the chains of the whole fleet (all of them on every rank's ladder)
    C_all = fleet_count(C)
    att_c = _full(C_all, dtype, device)

    def swap_move(x, f, tag, trips, betas, sweep, u):
        """Even–odd exchange sweep over adjacent temperature pairs: pair
        (p, p+1) is active when p % 2 == sweep % 2, so the sweep is one
        masked shift along K (``roll`` wraps around, but the zero rows of
        take_up / take_dn leave the wrap inert). The flow tag rides the
        same shift; a hot-tagged state landing on the cold row completes
        a round trip. Returns (x, f, tag, trips) and the (K-1,) per-pair
        accept probabilities and attempts."""
        pair_on = pair_on_parity[sweep % 2]
        log_a = (betas[:-1] - betas[1:])[:, None] * (f[1:] - f[:-1])
        a_prob = torch.exp(torch.clamp_max(log_a, 0.0))
        a_prob = torch.where(torch.isfinite(a_prob), a_prob, torch.zeros_like(a_prob))
        acc = (u < a_prob) & pair_on[:, None]
        take_up = torch.cat([acc, zrow], 0)  # row p takes row p+1
        take_dn = torch.cat([zrow, acc], 0)  # row p takes row p-1

        def shift(v, up, dn):
            return torch.where(up, torch.roll(v, -1, 0), torch.where(dn, torch.roll(v, 1, 0), v))

        x = shift(x, take_up[:, :, None], take_dn[:, :, None])
        f = shift(f, take_up, take_dn)
        tag = shift(tag, take_up, take_dn)
        # a hot-tagged state on the cold row completes a round trip (and
        # re-arms as cold-tagged); any state on the hot row arms hot
        trips = trips + (tag[0] == 2).to(torch.int32)
        tag[0] = 1
        tag[K - 1] = 2
        a_all = fleet(a_prob, 1)
        pair_acc = torch.sum(torch.where(pair_on[:, None], a_all, torch.zeros_like(a_all)), dim=1)
        pair_att = torch.where(pair_on, att_c, torch.zeros_like(att_c))
        return x, f, tag, trips, pair_acc, pair_att

    def round_(x, f, tag, trips, eps, betas, m, phase, i, swap_acc, swap_att, swap_ema):
        """One HMC move on every replica and, on schedule, an exchange
        sweep. ``i`` is the global round index: the cadence and the sweep
        parity derive from it, so chunked runs replay exactly."""
        # the whole fleet's draw, this rank's chains of it (all unsharded)
        z, u_hmc, u_swap = _pt_round_noise(state.key, phase, i, K, C_all, n, dtype, device)
        z = own_rows(z.reshape(K, C_all, n), 1).reshape(K * C, n)
        u_hmc, u_swap = own_rows(u_hmc, 1), own_rows(u_swap, 1)
        x, f, a_prob, e_cold, div_cold = hmc_move(x, f, eps, betas, m, z, u_hmc)
        if K > 1 and i % swap_every == 0:
            x, f, tag, trips, pair_acc, pair_att = swap_move(x, f, tag, trips, betas,
                                                             i // swap_every, u_swap)
            swap_acc = swap_acc + pair_acc
            swap_att = swap_att + pair_att
            # per-pair acceptance EMA, updated only on attempted pairs
            rate = pair_acc / torch.clamp_min(pair_att, 1.0)
            upd = (pair_att > 0).to(dtype)
            swap_ema = swap_ema + upd * _LADDER_EMA * (rate - swap_ema)
        return x, f, tag, trips, a_prob, swap_acc, swap_att, swap_ema, e_cold, div_cold

    # first-ever call: the cached logdensity is not populated yet
    f = f_all(state.x) if (i_warm0 == 0 and i_samp0 == 0) else state.f
    x, tag, trips, betas, var_ema = (state.x, state.tag, state.round_trips, state.betas,
                                     state.var_ema)
    log_eps, log_eps_bar, h_bar, t_da = state.log_eps, state.log_eps_bar, state.h_bar, state.t_da
    swap_acc, swap_att, swap_ema = state.swap_acc, state.swap_att, state.swap_ema

    # ---- warmup: per-temperature dual averaging (+ ladder and mass) ----
    for i in range(i_warm0, i_warm0 + n_warmup):
        x, f, tag, trips, a_prob, swap_acc, swap_att, swap_ema, _e, _d = round_(
            x, f, tag, trips, torch.exp(log_eps), betas, var_ema, 0, i, swap_acc, swap_att,
            swap_ema)
        if adapt_mass and C_all >= _MASS_ADAPT_MIN_CHAINS:
            # per-rung across-chain variance EMA, floored against collapse
            v = torch.clamp_min(torch.var(fleet(x, 1), dim=1, correction=0), 1e-10)
            var_ema = (1.0 - _MASS_EMA) * var_ema + _MASS_EMA * v
        if adapt_ladder and K > 2 and i % swap_every == 0:
            betas = _ladder_adapt(betas, swap_ema, i // swap_every)
        acc_err = target_accept - torch.mean(fleet(a_prob, 1), dim=1)  # (K,)
        log_eps, log_eps_bar, h_bar, t_da = _da_update(h_bar, log_eps_bar, t_da, acc_err,
                                                       state.mu)
    eps_final = torch.exp(log_eps_bar)

    # ---- sampling at the adapted steps on the (frozen) final ladder ----
    samples = torch.empty((n_samples, C, n), dtype=dtype, device=device)
    a_probs = torch.empty((n_samples, K, C), dtype=dtype, device=device)
    energies = torch.empty((n_samples, C), dtype=dtype, device=device)
    divs = torch.empty((n_samples, C), dtype=torch.int32, device=device)
    for j in range(n_samples):
        x, f, tag, trips, a_prob, swap_acc, swap_att, swap_ema, e, dv = round_(
            x, f, tag, trips, eps_final, betas, var_ema, 1, i_samp0 + j, swap_acc, swap_att,
            swap_ema)
        samples[j], a_probs[j], energies[j], divs[j] = x[0], a_prob, e, dv
    accept_rate = (torch.mean(fleet(a_probs, 2), dim=(0, 2)) if n_samples > 0
                   else torch.zeros((K,), dtype=dtype, device=device))

    out_state = PTState(
        x=x, f=f, betas=betas, log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar,
        t_da=t_da, mu=state.mu, key=state.key, i_warm=_counter(i_warm0 + n_warmup, device),
        i_samp=_counter(i_samp0 + n_samples, device), swap_acc=swap_acc, swap_att=swap_att,
        swap_ema=swap_ema, tag=tag, round_trips=trips, var_ema=var_ema,
    )
    return PTResult(
        samples=samples,
        accept_rate=accept_rate,
        swap_rate=swap_acc / torch.clamp_min(swap_att, 1.0),
        step_size=eps_final,
        betas=betas,
        round_trips=trips,
        energies=energies,
        divergences=torch.sum(divs, dim=0, dtype=torch.int32),
        final_x=x,
        state=out_state,
    )


def _check_adapt_mass(adapt_mass, mass):
    if adapt_mass and mass is not None:
        raise ValueError(
            "adapt_mass=True adapts its own per-rung diagonal metric; "
            "drop mass= (or pass the mass and keep adapt_mass=False)"
        )


def pt_sample(
    obj,
    key,
    x0s,  # (chains, n) or (K, chains, n) initial positions
    mass=None,
    betas=None,
    n_temps: int = 8,
    beta_min: float = 0.05,
    n_samples: int = 1000,
    n_warmup: int = 500,
    n_leapfrog: int = 16,
    swap_every: int = 1,
    step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_ladder: bool = False,
    adapt_mass: bool = False,
    value_and_grad_fn: Optional[Callable] = None,
) -> PTResult:
    """Replica-exchange (parallel tempering) HMC for multimodal targets.

    Runs ``n_temps`` tempered copies of the chain fleet — replica k
    targets beta_k·logdensity — with even–odd exchange sweeps between
    adjacent temperatures every ``swap_every`` rounds; the cold row's
    draws are returned. The whole ladder advances as one (K·C)-batched
    HMC program.

    ``x0s``: (chains, n) starts every temperature from the same fleet, or
    (K, chains, n) per-temperature starts. ``betas``: an explicit ladder
    (betas[0] must be 1.0; validated on a host copy, one counted read for
    a card tensor), default `geometric_ladder(n_temps, beta_min)`.
    ``mass``: the usual shared preconditioner (dense / diag / LowRankMass
    / None). Warmup adapts a per-temperature step size by dual averaging;
    ``adapt_ladder=True`` (K > 2) also reshapes the ladder toward equal
    per-pair swap acceptance, endpoints pinned; ``adapt_mass=True`` adapts
    a per-rung (K, n) diagonal metric (the identity below 8 chains),
    exclusive with ``mass=``.

    ``key``: see `sampling`'s module docstring. ``x0s`` follows the entry
    points' device rule (`utils.device.as_device_tensor`).
    """
    _check_adapt_mass(adapt_mass, mass)
    if swap_every < 1:
        raise ValueError(f"swap_every must be >= 1, got {swap_every}")
    x0s = as_device_tensor(x0s)
    if betas is not None:
        # validate on the host copy (one conversion, no repeated reads)
        if isinstance(betas, torch.Tensor):
            if betas.device.type != "cpu":
                pt_sample.host_syncs += 1
            b_host = betas.detach().cpu().to(torch.float64).numpy()
        else:
            b_host = np.asarray(betas, dtype=np.float64)
        if b_host.ndim != 1 or b_host.shape[0] < 1:
            raise ValueError("betas must be a 1-D ladder")
        # beta_0 = 1 is the samples contract (row 0 IS the posterior);
        # beta <= 0 is an improper target; non-monotone ladders break the
        # adjacent-pair exchange semantics
        if b_host[0] != 1.0:
            raise ValueError("betas[0] must be exactly 1.0 (the cold chain)")
        if b_host.shape[0] > 1 and (
            np.any(b_host[1:] <= 0.0) or np.any(np.diff(b_host) >= 0.0)
        ):
            raise ValueError(
                "betas must be strictly decreasing with every entry > 0"
            )
        K = b_host.shape[0]
    else:
        K = n_temps
    if x0s.ndim == 2:
        x0s = x0s[None].expand((K,) + tuple(x0s.shape)).clone()
    elif x0s.ndim != 3 or x0s.shape[0] != K:
        raise ValueError(
            "x0s must be (chains, n) or (n_temps, chains, n); got "
            f"{tuple(x0s.shape)} with {K} temperatures"
        )
    key = _as_key(key, pt_sample)
    dtype, device = x0s.dtype, x0s.device
    if betas is None:
        betas = geometric_ladder(K, beta_min, dtype, device)
    else:
        betas = _as_mass_tensor(betas, dtype, device)
    _, C, n = x0s.shape
    eps0 = _full(step_size, dtype, device)
    log_eps0 = torch.log(eps0).expand(K).clone()
    rows = torch.arange(K, device=device)[:, None]
    # flow tags: cold row armed 1, hot row armed 2, interior unset
    tag = torch.where(rows == 0, 1, torch.where(rows == K - 1, 2, 0)).to(torch.int32)
    state0 = PTState(
        x=x0s,
        f=_full(math.nan, dtype, device, (K, C)),
        betas=betas,
        log_eps=log_eps0,
        log_eps_bar=log_eps0,
        h_bar=torch.zeros((K,), dtype=dtype, device=device),
        t_da=torch.zeros((), dtype=dtype, device=device),
        mu=torch.log(10.0 * eps0),
        key=key,
        i_warm=_counter(0, device),
        i_samp=_counter(0, device),
        swap_acc=torch.zeros((max(K - 1, 0),), dtype=dtype, device=device),
        swap_att=torch.zeros((max(K - 1, 0),), dtype=dtype, device=device),
        swap_ema=_full(0.5, dtype, device, (max(K - 1, 0),)),
        tag=tag * torch.ones((1, C), dtype=torch.int32, device=device),
        round_trips=torch.zeros((C,), dtype=torch.int32, device=device),
        var_ema=torch.ones((K, n), dtype=dtype, device=device),
    )
    return _pt_core(obj, state0, mass, int(n_samples), int(n_warmup), int(n_leapfrog),
                    int(swap_every), target_accept, adapt_ladder, adapt_mass,
                    value_and_grad_fn, 0, 0)


def pt_sample_from_state(
    obj,
    state: PTState,
    mass=None,
    n_samples: int = 0,
    n_warmup: int = 0,
    n_leapfrog: int = 16,
    swap_every: int = 1,
    target_accept: float = 0.8,
    adapt_ladder: bool = False,
    adapt_mass: bool = False,
    value_and_grad_fn: Optional[Callable] = None,
) -> PTResult:
    """Continue a `pt_sample` run: ``n_warmup`` more warmup rounds, then
    ``n_samples`` more draws. Chunked calls replay one long run exactly
    (``mass``/``n_leapfrog``/``swap_every``/``target_accept``/
    ``adapt_ladder``/``adapt_mass`` are config, not state, and must be
    re-passed). Warmup cannot resume after sampling has begun. The phase
    counters are read once, counted in ``pt_sample.host_syncs``."""
    if swap_every < 1:
        raise ValueError(f"swap_every must be >= 1, got {swap_every}")
    _check_adapt_mass(adapt_mass, mass)
    state = as_device_state(state)
    i_warm0, i_samp0 = _read_counters(pt_sample, state.i_warm, state.i_samp)
    if n_warmup > 0 and i_samp0 > 0:
        raise ValueError(
            "cannot add warmup after sampling has begun "
            f"(state has {i_samp0} draws)"
        )
    return _pt_core(obj, state, mass, int(n_samples), int(n_warmup), int(n_leapfrog),
                    int(swap_every), target_accept, adapt_ladder, adapt_mass,
                    value_and_grad_fn, i_warm0, i_samp0)


pt_sample.host_syncs = 0
pt_sample.gradient_evals = 0
