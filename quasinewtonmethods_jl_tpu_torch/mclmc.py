"""Microcanonical Langevin Monte Carlo — the unadjusted, fixed-cost fleet
sampler (Robnik, De Luca, Silverstein & Seljak 2022; Robnik & Seljak 2023)
— the PyTorch port of ``quasinewtonmethods_jl_tpu/mclmc.py``.

Every chain takes the same two batched gradient evaluations a step: no
accept/reject, no trees, no tuning loops at sample time. The dynamics move
on the isokinetic constraint ||u|| = 1, whose stationary x-marginal is the
target; a partial momentum refresh with decoherence length ``L`` makes it
ergodic. The price is an O(eps²) discretization bias instead of MH
exactness: warmup adapts eps until the per-step energy-error variance is
``desired_energy_var`` per dimension.

Chains are the leading axis of (chains, n) tensors. The integrator is the
minimal-norm (McLachlan) two-stage splitting, two gradients a step
(`sampling._batched_objective`, one autograd pass through the vmapped
value). Tuning is fleet-native: warmup adapts eps by a damped log-Newton on
the fleet's energy-error variance and sets L = sqrt(Σᵢ varᵢ/mᵢ) from the
fleet variance EMA, frozen at ``mass_freeze``. ``log_eps``, ``var_ema``
and ``varE_ema`` stay tensors on the chains' device, and JAX's two
``lax.scan``s are Python loops that read nothing from the device;
``mclmc_sample.gradient_evals`` counts the fleet-wide gradient evaluations
and ``mclmc_sample.host_syncs`` the one read of the phase counters a
resume makes.

A chain whose step produces a non-finite state reverts to its pre-step
point with a fresh random velocity (a "bounce", counted in
``divergences``); a chain starting outside the support (f non-finite)
walks ballistically until a step lands inside.

Randomness: each step's bounce direction and refresh normals come from
`_mclmc_step_noise`, and the first call's velocities from
`_mclmc_init_noise`, each seeded on the host from (key, MCLMC's stream
word, ...) as in `sampling._step_noise`, so a chunked run draws what a long
run draws.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .sampling import (
    _MCLMC_STREAM,
    LowRankMass,
    _as_key,
    _as_mass_tensor,
    _batched_objective,
    _counter,
    _full,
    _generator,
    _read_counters,
)
from .utils.device import as_device_state, as_device_tensor
from .utils.placement import fleet, fleet_count, own_rows

__all__ = ["MCLMCResult", "MCLMCState", "mclmc_sample", "mclmc_sample_from_state"]

# McLachlan two-stage minimal-norm coefficient (the b1 of the
# v(b1)-p(1/2)-v(1-2b1)-p(1/2)-v(b1) splitting)
_MCLACHLAN_B1 = 0.1931833275037836
# the kinds of draw under MCLMC's stream word
_INIT, _STEP = 0, 1


class MCLMCState(NamedTuple):
    """Resumable state for `mclmc_sample`: positions, unit velocities,
    cached (logdensity, gradient), the eps/L adaptation state, the base
    key and the phase counters. ``n_warmup_total`` / ``mass_freeze`` pin
    the variance-EMA freeze step so chunked runs replay the long run
    exactly. ``key`` is the (2,) int64 CPU tensor of `sampling`'s module
    docstring; every other leaf lives on the chains' device."""

    x: torch.Tensor  # (chains, n) positions
    f: torch.Tensor  # (chains,) logdensity at x
    g: torch.Tensor  # (chains, n) gradient at x
    u: torch.Tensor  # (chains, n) unit velocities
    log_eps: torch.Tensor  # () adapted step size (log)
    var_ema: torch.Tensor  # (n,) fleet-variance EMA (sets L and the adaptive diagonal)
    varE_ema: torch.Tensor  # () EMA of the per-dim energy-error variance
    key: torch.Tensor  # (2,) int64 on the CPU: the run's base key
    i_warm: torch.Tensor  # () int32 warmup steps completed
    i_samp: torch.Tensor  # () int32 sampling steps completed
    n_warmup_total: torch.Tensor  # () int32 the run's planned warmup length
    mass_freeze: torch.Tensor  # () int32 var-EMA freeze step


class MCLMCResult(NamedTuple):
    """Samples and diagnostics for a batched MCLMC run.

    samples: (n_samples, chains, n) draws (every post-warmup step is one)
    step_size: () the adapted integrator step
    L: () the momentum decoherence length in the preconditioned space
    mass_diag: (n,) the diagonal preconditioner the run sampled with
    energy_changes: (n_samples, chains) per-step energy errors ΔE
    energy_var: () mean ΔE²/n over the sampling phase (compare with
        ``desired_energy_var``)
    divergences: (chains,) int32 bounce counts over sampling
    final_x: (chains, n) last positions
    state: MCLMCState — resume via `mclmc_sample_from_state`
    """

    samples: torch.Tensor
    step_size: torch.Tensor
    L: torch.Tensor
    mass_diag: torch.Tensor
    energy_changes: torch.Tensor
    energy_var: torch.Tensor
    divergences: torch.Tensor
    final_x: torch.Tensor
    state: MCLMCState


def _mclmc_init_noise(key, chains, n, dtype, device):
    """The standard normals (chains, n) of the first call's velocities."""
    gen = _generator(key, device, _MCLMC_STREAM, _INIT)
    return torch.randn((chains, n), generator=gen, dtype=dtype, device=device)


def _mclmc_step_noise(key, phase, step, chains, n, dtype, device):
    """(fresh, refresh) of the step at global ``step`` of ``phase`` (0
    warmup, 1 sampling): the standard normals (chains, n) of the bounce
    direction and of the partial refresh, drawn for every chain whether or
    not it bounces."""
    gen = _generator(key, device, _MCLMC_STREAM, _STEP, phase, step)
    fresh = torch.randn((chains, n), generator=gen, dtype=dtype, device=device)
    refresh = torch.randn((chains, n), generator=gen, dtype=dtype, device=device)
    return fresh, refresh


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _mom_update(dt, u, g_eff):
    """Exact solution of the isokinetic velocity ODE du/dτ = P⊥(u) g/(d−1)
    over time ``dt`` for frozen g (the Robnik et al. closed form), batched
    over chains: the new unit velocity and the per-chain kinetic-energy
    change (d−1)·Δr. A zero gradient gives the identity with zero energy
    change."""
    _chains, d = u.shape
    gn = torch.linalg.vector_norm(g_eff, dim=1)
    # zero-gradient guard by a select, not max(gn, tiny): a flushed tiny
    # constant would make 0/0 exactly where the guard is needed
    e = g_eff / torch.where(gn > 0.0, gn, torch.ones_like(gn))[:, None]
    ue = torch.sum(u * e, dim=1)
    delta = dt * gn / (d - 1)
    zeta = torch.exp(-delta)
    uu = (e * ((1.0 - zeta) * (1.0 + zeta + ue * (1.0 - zeta)))[:, None]
          + (2.0 * zeta)[:, None] * u)
    u_new = _unit(uu)
    dk = (d - 1) * (delta - math.log(2.0) + torch.log1p(ue + (1.0 - ue) * zeta * zeta))
    return u_new, dk


def _partial_refresh(u, z, eps, L):
    """O-U partial momentum refresh on the sphere with decoherence length
    L: u ← normalize(u + ν z), ν² = e^{2eps/L} − 1."""
    nu = torch.sqrt(torch.expm1(2.0 * eps / L))
    return _unit(u + nu * z)


def _mass_diagonal(mass, n, dtype, device):
    """The (n,) diagonal the isokinetic dynamics precondition with: an
    (n,) mass itself, an (n, n) mass's diagonal, ones for None."""
    if mass is None:
        return torch.ones((n,), dtype=dtype, device=device)
    if isinstance(mass, LowRankMass):
        raise ValueError(
            "mclmc_sample takes an (n,) or (n, n) mass; a LowRankMass is not accepted (the "
            "JAX package's MCLMC raises on one as well): pass its diagonal, mass.diag"
        )
    m = _as_mass_tensor(mass, dtype, device)
    return torch.diagonal(m) if m.ndim == 2 else m


def _mclmc_core(obj, state: MCLMCState, mass, n_samples, n_warmup, desired_energy_var,
                adapt_mass, value_and_grad_fn, i_warm0, i_samp0) -> MCLMCResult:
    chains, n = state.x.shape
    dtype, device = state.x.dtype, state.x.device
    mass_m = None if adapt_mass else _mass_diagonal(mass, n, dtype, device)
    vag_b, _f_b = _batched_objective(obj, value_and_grad_fn)
    b1 = _full(_MCLACHLAN_B1, dtype, device)
    target = _full(desired_energy_var, dtype, device)
    mass_freeze = state.mass_freeze

    def precond(var_ema):
        """(s, L) from the variance EMA: s whitens (when adapting or given
        a mass), L is the decoherence length in the whitened space."""
        m = var_ema if adapt_mass else mass_m
        return torch.sqrt(m), torch.sqrt(torch.sum(var_ema / m))

    def vag(x):
        mclmc_sample.gradient_evals += 1
        return vag_b(x)

    def step(x, f, g, u, eps, s, L, phase, i):
        """One McLachlan step, the bounce guard and the partial refresh:
        (x, f, g, u, dE, bad, outside)."""
        # the whole fleet's draw, this rank's rows of it (all of it unsharded)
        fresh, refresh = (own_rows(t) for t in _mclmc_step_noise(
            state.key, phase, i, fleet_count(chains), n, dtype, device))
        u1, dk1 = _mom_update(b1 * eps, u, s * g)
        x1 = x + (0.5 * eps) * (s * u1)
        _f1, g1 = vag(x1)
        u2, dk2 = _mom_update((1.0 - 2.0 * _MCLACHLAN_B1) * eps, u1, s * g1)
        x2 = x1 + (0.5 * eps) * (s * u2)
        f2, g2 = vag(x2)
        u3, dk3 = _mom_update(b1 * eps, u2, s * g2)
        # inside -> outside or non-finite: revert with a fresh direction
        # and count a divergence; outside (f non-finite): move
        # ballistically, ΔE referenced to the landing value
        f_ref = torch.where(torch.isfinite(f), f, f2)
        dE = (dk1 + dk2 + dk3) - (f2 - f_ref)
        structural_ok = (torch.all(torch.isfinite(g2), dim=1)
                         & torch.all(torch.isfinite(x2), dim=1)
                         & torch.all(torch.isfinite(u3), dim=1))
        outside = ~torch.isfinite(f)
        move = structural_ok & (torch.isfinite(f2) | outside)
        m = move[:, None]
        x_o = torch.where(m, x2, x)
        f_o = torch.where(move, f2, f)
        g_o = torch.where(m, g2, g)
        u_o = torch.where(m, u3, _unit(fresh))
        dE_o = torch.where(move & torch.isfinite(dE), dE, torch.zeros_like(dE))
        u_o = _partial_refresh(u_o, refresh, eps, L)
        return x_o, f_o, g_o, u_o, dE_o, ~move, outside

    # first-ever call: cached (f, g) and the initial velocities
    if i_warm0 == 0 and i_samp0 == 0:
        f, g = vag(state.x)
        u = _unit(own_rows(_mclmc_init_noise(state.key, fleet_count(chains), n, dtype, device)))
    else:
        f, g, u = state.f, state.g, state.u
    x, log_eps, var_ema, varE_ema = state.x, state.log_eps, state.var_ema, state.varE_ema

    # ---- warmup: eps by damped log-Newton on the fleet energy-error
    # variance; L (and optionally the preconditioner) from the fleet
    # variance EMA, frozen at mass_freeze ----
    for i in range(i_warm0, i_warm0 + n_warmup):
        s, L = precond(var_ema)
        x, f, g, u, dE, bad, outside = step(x, f, g, u, torch.exp(log_eps), s, L, 0, i)
        # bounced chains feed a penalty of 100x the target, chains still
        # outside the support exactly the target
        vE = torch.mean(fleet(torch.where(bad, 1e2 * target * n,
                                          torch.where(outside, target * n, dE * dE)))) / n
        varE_ema = 0.8 * varE_ema + 0.2 * vE
        # ΔE ~ eps³: a damped Newton step on log eps, clipped to ±0.25
        move = (torch.log(target) - torch.log(varE_ema + 1e-30)) / 6.0
        log_eps = log_eps + torch.clamp(0.5 * move, -0.25, 0.25)
        var_now = torch.clamp_min(torch.var(fleet(x), dim=0, correction=0), 1e-10)
        var_ema = torch.where(i < mass_freeze, 0.9 * var_ema + 0.1 * var_now, var_ema)
    eps_final = torch.exp(log_eps)
    s_final, L_final = precond(var_ema)

    # ---- sampling at the frozen (eps, s, L): every step is a draw ----
    samples = torch.empty((n_samples, chains, n), dtype=dtype, device=device)
    dEs = torch.empty((n_samples, chains), dtype=dtype, device=device)
    bads = torch.empty((n_samples, chains), dtype=torch.int32, device=device)
    for j in range(n_samples):
        x, f, g, u, dE, bad, _outside = step(x, f, g, u, eps_final, s_final, L_final, 1,
                                             i_samp0 + j)
        samples[j], dEs[j], bads[j] = x, dE, bad
    out_state = MCLMCState(
        x=x, f=f, g=g, u=u, log_eps=log_eps, var_ema=var_ema, varE_ema=varE_ema,
        key=state.key, i_warm=_counter(i_warm0 + n_warmup, device),
        i_samp=_counter(i_samp0 + n_samples, device),
        n_warmup_total=state.n_warmup_total, mass_freeze=mass_freeze,
    )
    n_draws = max(n_samples, 1)
    dEs_all = fleet(dEs, 1)
    return MCLMCResult(
        samples=samples,
        step_size=eps_final,
        L=L_final,
        mass_diag=s_final * s_final,
        energy_changes=dEs,
        energy_var=torch.sum(dEs_all * dEs_all) / (n_draws * dEs_all.shape[1] * n),
        divergences=torch.sum(bads, dim=0, dtype=torch.int32),
        final_x=x,
        state=out_state,
    )


def mclmc_sample(
    obj,
    key,
    x0s,  # (chains, n) initial positions (e.g. the MAP fleet)
    mass=None,  # (n,) diagonal (or (n, n): its diagonal)
    n_samples: int = 1000,
    n_warmup: int = 500,
    step_size: Optional[float] = None,
    desired_energy_var: float = 5e-4,
    adapt_mass: bool = False,
    total_warmup: Optional[int] = None,
    value_and_grad_fn: Optional[Callable] = None,
) -> MCLMCResult:
    """Batched microcanonical Langevin Monte Carlo over a chain fleet.

    ``obj`` is the logdensity (maximized). Each post-warmup step is a
    draw: two batched gradient evaluations, no accept/reject. Warmup
    adapts eps until the per-step energy-error variance is
    ``desired_energy_var`` per dimension.

    ``mass``: an optional (n,) variance-like diagonal preconditioner; a
    dense (n, n) B is accepted and its diagonal used. A `LowRankMass`
    raises a ValueError, as it does in the JAX package. ``adapt_mass=True``
    learns the diagonal from the fleet variance during warmup instead
    (frozen at warmup/2). L is always fleet-tuned.

    ``key``: see `sampling`'s module docstring. ``x0s`` follows the entry
    points' device rule (`utils.device.as_device_tensor`). To chunk
    through warmup, announce the plan with ``total_warmup`` and run
    ``n_warmup <= total_warmup`` steps now, the rest via
    `mclmc_sample_from_state`.
    """
    x0s = as_device_tensor(x0s)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (chains, n), got shape {tuple(x0s.shape)}")
    chains, n = x0s.shape
    if n < 2:
        raise ValueError(
            "MCLMC needs n >= 2 (the isokinetic dynamics divide by n-1); "
            "use hmc/chees/nuts for univariate targets"
        )
    if n_warmup < 0 or n_samples < 0:
        raise ValueError("n_samples and n_warmup must be >= 0")
    if total_warmup is None:
        total_warmup = n_warmup
    if n_warmup > total_warmup:
        raise ValueError(
            f"n_warmup ({n_warmup}) exceeds total_warmup ({total_warmup})"
        )
    if n_samples > 0 and n_warmup < total_warmup:
        raise ValueError(
            "cannot draw samples before the announced warmup plan is "
            f"complete ({n_warmup} of {total_warmup} steps); chunk with "
            "mclmc_sample_from_state"
        )
    if desired_energy_var <= 0.0:
        raise ValueError("desired_energy_var must be > 0")
    if mass is not None and adapt_mass:
        raise ValueError("pass either mass= or adapt_mass=True, not both")
    key = _as_key(key, mclmc_sample)
    dtype, device = x0s.dtype, x0s.device
    # eps0: a quarter of the isotropic L (the published warm start)
    eps0 = float(step_size) if step_size is not None else 0.25 * math.sqrt(n)
    if eps0 <= 0.0:
        raise ValueError("step_size must be > 0")
    state0 = MCLMCState(
        x=x0s,
        f=_full(math.nan, dtype, device, (chains,)),
        g=torch.zeros((chains, n), dtype=dtype, device=device),
        u=torch.zeros((chains, n), dtype=dtype, device=device),
        log_eps=_full(math.log(eps0), dtype, device),
        var_ema=torch.ones((n,), dtype=dtype, device=device),
        varE_ema=_full(desired_energy_var, dtype, device),
        key=key,
        i_warm=_counter(0, device),
        i_samp=_counter(0, device),
        n_warmup_total=_counter(total_warmup, device),
        mass_freeze=_counter(max(total_warmup // 2, 1), device),
    )
    return _mclmc_core(obj, state0, mass, int(n_samples), int(n_warmup),
                       float(desired_energy_var), bool(adapt_mass), value_and_grad_fn, 0, 0)


def mclmc_sample_from_state(
    obj,
    state: MCLMCState,
    mass=None,
    n_samples: int = 0,
    n_warmup: int = 0,
    desired_energy_var: float = 5e-4,
    adapt_mass: bool = False,
    value_and_grad_fn: Optional[Callable] = None,
) -> MCLMCResult:
    """Continue an `mclmc_sample` run from its saved state: ``n_warmup``
    more warmup steps, then ``n_samples`` more draws. Chunked calls are
    trajectory-identical to one long run with the same totals
    (``mass``/``adapt_mass``/``desired_energy_var`` are config, not state,
    and must be re-passed). Warmup cannot resume after sampling has begun,
    nor exceed (or be left short of) the plan the first call announced.
    The phase counters are read once, counted in
    ``mclmc_sample.host_syncs``."""
    state = as_device_state(state)
    i_warm0, i_samp0, n_total = _read_counters(mclmc_sample, state.i_warm, state.i_samp,
                                               state.n_warmup_total)
    if n_warmup > 0 and i_samp0 > 0:
        raise ValueError(
            "cannot add warmup after sampling has begun "
            f"(state has {i_samp0} draws)"
        )
    if i_warm0 + n_warmup > n_total:
        raise ValueError(
            f"warmup plan exceeded: state has {i_warm0} of "
            f"{n_total} planned steps; requested {n_warmup} more"
        )
    if n_samples > 0 and i_warm0 + n_warmup < n_total:
        raise ValueError(
            "cannot draw samples before the announced warmup plan is "
            f"complete ({i_warm0 + n_warmup} of {n_total} steps)"
        )
    if mass is not None and adapt_mass:
        raise ValueError("pass either mass= or adapt_mass=True, not both")
    return _mclmc_core(obj, state, mass, int(n_samples), int(n_warmup),
                       float(desired_energy_var), bool(adapt_mass), value_and_grad_fn,
                       i_warm0, i_samp0)


mclmc_sample.host_syncs = 0
mclmc_sample.gradient_evals = 0
