"""Batched HMC, ChEES-HMC and NUTS warm-started by the MAP fleet — the
PyTorch port of ``quasinewtonmethods_jl_tpu/sampling.py`` (HMC, ChEES,
NUTS and depth-sorted NUTS).

The reference is "the inner MAP/mode-finding engine intended for
ProbabilityModels.jl + InplaceDHMC.jl (HMC chain initialization)"
(reference README.md:14). This module is the machine that takes the fleet
over:

  * the batched MAP result's iterates are the chain starts, one chain per
    lane (`chain_init_from_map`);
  * the converged inverse Hessian B ≈ the posterior covariance at the
    mode is the dense mass preconditioner: kinetic energy 0.5 pᵀ B p,
    position update x += eps · B p, momenta p = U⁻¹ z through the upper
    Cholesky factor U of B, so that cov(p) = B⁻¹.

Chains are a leading axis and advance in lockstep: each transition is a
handful of batched torch ops, the objective's value and gradient under
``torch.func.vmap``. JAX's ``lax.scan`` over steps is a Python loop here,
and its ``fori_loop``/``while_loop`` of leapfrog steps another; the
gradient at a leapfrog step's end is the next step's start, computed once
(JAX computes it twice, to the same value), and the last evaluation's
value is the proposal's logdensity (JAX evaluates it once more). An
autodiff gradient is one autograd pass through the vmapped value
(`_batched_objective`). HMC's loop reads nothing from
the device. ChEES reads one number a round, its shared leapfrog count,
which the Python loop needs; every read is counted in
``chees_sample.host_syncs`` (and the ``*_from_state`` entry points' reads
of the phase counters in ``hmc_sample.host_syncs`` /
``chees_sample.host_syncs``). NUTS builds its trees in lockstep: JAX's two
``while_loop``s (doublings; leaves within a subtree) are Python loops whose
conditions read one flag from the device a leaf and one a doubling,
counted in ``nuts_sample.host_syncs``. ``hmc_sample.gradient_evals`` /
``chees_sample.gradient_evals`` / ``nuts_sample.gradient_evals`` count the
fleet-wide gradient evaluations (one evaluation over every chain counts
one).

Randomness. In JAX each transition's noise is a pure function of the
run's key, the phase (0 warmup, 1 sampling) and the global step, which is
what makes a chunked run equal a long one. The port keeps that property
with its own generator: `_step_noise` derives a 64-bit seed on the host
from (key, phase, step) by a fixed mixing function (splitmix64), seeds a
``torch.Generator`` on the chains' device with it, and draws the momenta z
and then the Metropolis uniforms u. No stream is consumed across calls and
no seed derivation reads the card. The draws differ from JAX's
``threefry`` streams: the two packages' runs agree in distribution, not
draw for draw (the tests hold them draw for draw by injecting JAX's noise
through `_step_noise`). NUTS draws through its own seams
(`_nuts_momentum_noise`, `_nuts_doubling_noise`, `_nuts_leaf_noise`), each
seeded from (key, a NUTS stream word, phase, step, ...) the same way, so
that its streams never meet HMC's or ChEES's, and the depth-sorted
driver's sub-fleets run under keys derived by `_subfleet_key`.

A ``key`` is an int seed (as ``jax.random.PRNGKey``: the high and low 32
bits), a ``torch.Generator`` (one seed is drawn from it, a read on a CUDA
generator), or the two uint32 words of a JAX key. States hold it as a (2,)
int64 tensor on the CPU.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .api import ProbabilityModel, _pin_matmul_precision, as_value_and_grad, as_value_fn
from .ops.lbfgs_compact import lbfgs_diag_inv_hessian, lbfgs_lowrank_inv_hessian
from .state import Status
from .utils.device import as_device_state, as_device_tensor
from .utils.placement import fleet, fleet_any, fleet_count, own_rows

__all__ = [
    "get_sampler",
    "LowRankMass",
    "HMCResult",
    "HMCState",
    "ChEESResult",
    "ChEESState",
    "hmc_sample",
    "hmc_sample_from_state",
    "chees_sample",
    "chees_sample_from_state",
    "chain_init_from_map",
    "NUTSState",
    "NUTSResult",
    "nuts_sample",
    "nuts_sample_from_state",
    "DepthSortInfo",
    "nuts_sample_depth_sorted",
]


class HMCState(NamedTuple):
    """Full resumable sampler state for `hmc_sample`: positions, cached
    log-densities, the complete dual-averaging accumulators, the base key
    and the phase counters. `hmc_sample_from_state` continues a run
    trajectory-identically to one long run; `utils.checkpoint.save_state`
    / `load_state` serialize it. ``key`` is the (2,) int64 CPU tensor of
    the module docstring; every other leaf lives on the chains' device."""

    x: torch.Tensor  # (chains, n) current positions
    f: torch.Tensor  # (chains,) logdensity at x
    log_eps: torch.Tensor  # (chains,) dual-averaging iterate
    log_eps_bar: torch.Tensor  # (chains,) averaged iterate (the frozen eps)
    h_bar: torch.Tensor  # (chains,) DA error accumulator
    t_da: torch.Tensor  # () DA step count
    mu: torch.Tensor  # () DA shrink target log(10 * eps0)
    key: torch.Tensor  # (2,) int64 on the CPU: the run's base key
    i_warm: torch.Tensor  # () int32 warmup steps completed
    i_samp: torch.Tensor  # () int32 sampling steps completed


class HMCResult(NamedTuple):
    """Samples and diagnostics for a batched HMC run.

    samples: (n_samples, chains, n) post-warmup draws
    accept_rate: (chains,) mean Metropolis acceptance over sampling
    step_size: (chains,) final (adapted) leapfrog step size
    energies: (n_samples, chains) Hamiltonian -f(x)+K(p) of each
        transition's selected phase-space point (Stan's ``energy__``)
    divergences: (chains,) int32 count of divergent transitions over
        sampling (non-finite or catastrophic energy error)
    final_x: (chains, n) last state
    state: HMCState — resume via `hmc_sample_from_state`
    """

    samples: torch.Tensor
    accept_rate: torch.Tensor
    step_size: torch.Tensor
    energies: torch.Tensor
    divergences: torch.Tensor
    final_x: torch.Tensor
    state: HMCState


def get_sampler(name: str):
    """Resolve a sampler by name — one registry for every dispatch site.
    ``"pt"``, ``"ensemble"`` and ``"mclmc"`` import their modules when
    resolved (tempering imports this module)."""
    samplers = {"chees": chees_sample, "hmc": hmc_sample, "nuts": nuts_sample}
    lazy = {"ensemble": "ensemble", "mclmc": "mclmc", "pt": "tempering"}
    if name in lazy:
        import importlib

        module = importlib.import_module(f".{lazy[name]}", __package__)
        return getattr(module, f"{name}_sample")
    if name not in samplers:
        raise ValueError(
            f"unknown sampler {name!r}; use one of {sorted((*samplers, *lazy))}"
        )
    return samplers[name]


# ---------------------------------------------------------------------------
# Keys and noise
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
_JITTER_STREAM = 2  # chain_init_from_map's stream (phases 0 and 1 are the samplers')
# NUTS's streams: this word first, then (phase, step, kind, ...); the kinds
# are the momenta, a doubling's direction and uniform, and a leaf's uniform
_NUTS_STREAM = 3
_NUTS_MOMENTUM, _NUTS_DOUBLING, _NUTS_LEAF = 0, 1, 2
# the depth-sorted driver's sub-fleet keys
_SUBFLEET_STREAM = 4
# Pathfinder's streams (pathfinder.py): this word first, then the kind of draw
_PATHFINDER_STREAM = 5
# MCLMC's (mclmc.py), the ensemble's (ensemble.py) and replica exchange's
# (tempering.py) streams, each word first
_MCLMC_STREAM = 6
_ENSEMBLE_STREAM = 7
_PT_STREAM = 8
# annealed importance sampling's (ais.py) and bridge sampling's (bridge.py)
_AIS_STREAM = 9
_BRIDGE_STREAM = 10
# the one-call workflow's sub-keys and its own draws (workflow.py)
_WORKFLOW_STREAM = 11


def _as_key(key, engine=None) -> torch.Tensor:
    """``key`` (module docstring) as the (2,) int64 CPU tensor of its two
    uint32 words. Drawing from a CUDA generator is a device read, counted
    in ``engine.host_syncs`` where an engine is given."""
    if isinstance(key, torch.Generator):
        words = torch.randint(0, 1 << 32, (2,), generator=key, device=key.device,
                              dtype=torch.int64)
        if words.device.type != "cpu" and engine is not None:
            engine.host_syncs += 1
        return words.cpu()
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        seed = int(key) & _MASK64
        return torch.tensor([seed >> 32, seed & _MASK32], dtype=torch.int64)
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    try:
        a = np.asarray(key)
    except TypeError as e:  # a typed JAX key has no numpy form
        raise TypeError(f"key must be an int seed, a torch.Generator or the two uint32 words "
                        f"of a JAX key, got {type(key).__name__}") from e
    if a.shape != (2,) or not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"key must be an int seed, a torch.Generator or the two uint32 words "
                        f"of a JAX key, got an array of shape {a.shape} and dtype {a.dtype}")
    return torch.tensor([int(w) & _MASK32 for w in a], dtype=torch.int64)


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _seed(key: torch.Tensor, *words: int) -> int:
    """A 64-bit seed from the key's two words and ``words``, on the host."""
    hi, lo = key.tolist()
    h = _splitmix64(((hi & _MASK32) << 32) | (lo & _MASK32))
    for w in words:
        h = _splitmix64(h ^ (int(w) & _MASK64))
    return h


def _generator(key, device, *words) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(key, *words))
    return gen


def _step_noise(key, phase, step, chains, n, dtype, device):
    """(z, u): the standard-normal momentum draw (chains, n) and the
    Metropolis uniforms (chains,) of the transition at global ``step`` of
    ``phase`` (0 warmup, 1 sampling): a pure function of its arguments,
    so that a chunked run draws what a long run draws."""
    gen = _generator(key, device, phase, step)
    z = torch.randn((chains, n), generator=gen, dtype=dtype, device=device)
    u = torch.rand((chains,), generator=gen, dtype=dtype, device=device)
    return z, u


def _jitter_noise(key, shape, dtype, device):
    """`chain_init_from_map`'s standard-normal jitter draw."""
    gen = _generator(key, device, _JITTER_STREAM)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _nuts_momentum_noise(key, phase, step, chains, n, dtype, device):
    """The standard-normal momentum draw z (chains, n) of NUTS's transition
    at global ``step`` of ``phase`` (0 warmup, 1 sampling)."""
    gen = _generator(key, device, _NUTS_STREAM, phase, step, _NUTS_MOMENTUM)
    return torch.randn((chains, n), generator=gen, dtype=dtype, device=device)


def _nuts_doubling_noise(key, phase, step, j, chains, dtype, device):
    """(d, u) of doubling ``j`` of that transition: the direction d, ±1 in
    the chains' dtype, and the uniform of the multinomial step between the
    old tree and the new subtree."""
    gen = _generator(key, device, _NUTS_STREAM, phase, step, _NUTS_DOUBLING, j)
    d = torch.randint(0, 2, (chains,), generator=gen, device=device).to(dtype) * 2 - 1
    u = torch.rand((chains,), generator=gen, dtype=dtype, device=device)
    return d, u


def _nuts_leaf_noise(key, phase, step, j, i, chains, dtype, device):
    """The progressive multinomial uniform (chains,) of leaf ``i`` of
    doubling ``j`` of that transition."""
    gen = _generator(key, device, _NUTS_STREAM, phase, step, _NUTS_LEAF, j, i)
    return torch.rand((chains,), generator=gen, dtype=dtype, device=device)


def _subfleet_key(key, group):
    """The key sub-fleet ``group`` of `nuts_sample_depth_sorted` samples
    under (JAX: ``fold_in(key, 2 + group)``), derived on the host."""
    h = _seed(key, _SUBFLEET_STREAM, 2 + group)
    return torch.tensor([h >> 32, h & _MASK32], dtype=torch.int64)


# ---------------------------------------------------------------------------
# The MAP handoff
# ---------------------------------------------------------------------------


def chain_init_from_map(result, jitter: float = 0.0, key=None, mass_form: str = "auto"):
    """(x0s, mass) from a batched MAP result (`optimize_batched*`,
    `least_squares` or the L-BFGS fleet engines).

    Returns the per-chain initial positions and a single mass
    preconditioner ≈ posterior covariance. ``mass_form``:

      * 'auto' (default): the dense (n, n) B for BFGS fleets, averaged
        over the converged lanes; inv of the masked average of JTJ for LM
        fleets; for L-BFGS fleets the compact-form diag(H)
        (`ops.lbfgs_compact.lbfgs_diag_inv_hessian`), averaged likewise.
        With no converged lane the mass is the identity.
      * 'lowrank' (L-BFGS fleets): a `LowRankMass` from the best converged
        lane's ring via `lbfgs_lowrank_inv_hessian`.

    Optional Gaussian jitter (``key`` required) decorrelates chains that
    share the mode. Nothing is read to the host (a CUDA generator as
    ``key`` excepted: one seed is drawn from it).
    """
    if jitter and key is None:
        raise ValueError(
            "chain_init_from_map: jitter > 0 needs an explicit `key` "
            "(silently skipping it would hand back perfectly correlated "
            "chain starts)"
        )
    if mass_form not in ("auto", "lowrank"):
        raise ValueError(
            f"mass_form must be 'auto' or 'lowrank', got {mass_form!r}"
        )
    x0s = result.x
    dtype, device = x0s.dtype, x0s.device
    ok = (result.status == Status.CONVERGED).to(dtype)
    # zero converged lanes: the identity instead of the all-zero average
    # (which gives NaN momenta through cholesky / sqrt), branchless
    n_ok = torch.sum(ok)
    any_ok = n_ok > 0
    w = ok / torch.clamp_min(n_ok, 1.0)
    state = result.state
    n = x0s.shape[-1]
    eye = torch.eye(n, dtype=dtype, device=device)
    if hasattr(state, "B"):
        if mass_form == "lowrank":
            raise ValueError(
                "mass_form='lowrank' is the L-BFGS handoff; a BFGS fleet "
                "already has the dense B (use the default)"
            )
        mass = torch.where(any_ok, torch.einsum("b,bij->ij", w, state.B), eye)
    elif hasattr(state, "JTJ"):
        # LM fleet: JTJ at the solution is the observed information of the
        # Gaussian log-likelihood, so mass ~ covariance = inv(JTJ). Failed
        # lanes can carry NaN products: masked before weighting (0 * NaN)
        if mass_form == "lowrank":
            raise ValueError(
                "mass_form='lowrank' is the L-BFGS handoff; an LM fleet "
                "hands over the dense inv(JTJ) (use the default)"
            )
        jtj = torch.where((ok > 0)[:, None, None], state.JTJ, torch.zeros_like(state.JTJ))
        avg = torch.where(any_ok, torch.einsum("b,bij->ij", w, jtj), eye)
        minv, info = torch.linalg.inv_ex(avg)
        # a singular JTJ gives a non-finite inverse: the identity, in-band
        mass = torch.where((info == 0) & torch.all(torch.isfinite(minv)), minv, eye)
    elif mass_form == "lowrank":
        # the best converged lane (-inf-masked argmax, the first maximum)
        fun = torch.where(ok > 0, result.fun, torch.full_like(result.fun, -math.inf))
        best = torch.argmax(fun).reshape(1)

        def lane(t):
            return torch.index_select(t, 0, best)[0]

        gamma, Q, sig = lbfgs_lowrank_inv_hessian(
            lane(state.S), lane(state.Y), lane(state.hist), lane(state.gamma))
        # no converged lane: identity metric (gamma 1, sig 1)
        gamma = torch.where(any_ok, gamma, torch.ones_like(gamma))
        sig = torch.where(any_ok, sig, torch.ones_like(sig))
        mass = LowRankMass(gamma=gamma, Q=Q, sig=sig)
    else:  # L-BFGS: diagonal of the compact-form inverse-Hessian estimate
        diags = torch.func.vmap(lbfgs_diag_inv_hessian)(state.S, state.Y, state.hist,
                                                        state.gamma)
        # a lane that never pushed a pair contributes gamma = 1s; negative
        # entries (indefinite secant noise) are floored out
        diags = torch.clamp_min(diags, 1e-10)
        mass = torch.einsum("b,bn->n", w, diags)
        mass = torch.where(any_ok, mass, torch.ones_like(mass))
    if jitter and key is not None:
        x0s = x0s + jitter * _jitter_noise(_as_key(key), x0s.shape, dtype, device)
    return x0s, mass


# ---------------------------------------------------------------------------
# Mass forms
# ---------------------------------------------------------------------------


class LowRankMass(NamedTuple):
    """Low-rank + scalar covariance-like metric for large n:

        M = γ·(I − QQᵀ) + Q·diag(sig)·Qᵀ,  Q (n, r) orthonormal, sig > 0

    M acts as γ off the captured subspace and with eigenvalues ``sig`` on
    it, so M^(1/2) and M^(-1/2) are closed-form in the same basis (no n×n
    Cholesky anywhere): the form the L-BFGS compact representation factors
    into (`chain_init_from_map(mass_form='lowrank')`). Accepted wherever
    the samplers take ``mass``.

    ``d`` (optional): a per-coordinate outer scale making the metric
    M_d = D^(1/2)·M·D^(1/2) with D = diag(d), the low-rank core in
    d-standardized coordinates (what ``adapt_mass='lowrank'`` produces).
    Velocity M_d·p = √d·(M·(√d·p)), the kinetic energy through the same
    standardization, momenta p = (1/√d)·M^(-1/2)z giving cov(p) = M_d⁻¹."""

    gamma: torch.Tensor  # ()
    Q: torch.Tensor  # (n, r) orthonormal columns
    sig: torch.Tensor  # (r,) positive eigenvalues along Q
    d: Optional[torch.Tensor] = None  # (n,) outer scale (None = ones)

    @property
    def diag(self) -> torch.Tensor:
        """diag(M_d) = d·(γ + Σ_j (sig_j − γ)·Q_ij²) — for reporting."""
        core = self.gamma + torch.sum((self.sig[None, :] - self.gamma) * self.Q * self.Q, dim=1)
        return core if self.d is None else self.d * core


def _as_mass_tensor(a, dtype, device) -> torch.Tensor:
    """A mass leaf in the chains' dtype on their device (JAX's
    ``jnp.asarray(mass, dtype)``)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _chol_upper(mass: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor of the symmetrized ``mass`` (as
    ``jnp.linalg.cholesky(mass).T``), NaN where it is not positive
    definite (JAX's in-band failure), with no device read."""
    L, info = torch.linalg.cholesky_ex((mass + mass.mT) / 2)
    return torch.where(info != 0, torch.full_like(L, math.nan), L).mT


def _mass_setup(mass, n, dtype, device):
    """(mass_arr, chol_u) for a covariance-like preconditioner: (n, n)
    dense (chol_u the upper Cholesky factor, momenta p = U⁻¹ z have
    cov(p) = mass⁻¹ = M), (n,) diagonal, `LowRankMass` (closed-form roots,
    chol_u unused), or None (identity diagonal)."""
    if mass is None:
        return torch.ones((n,), dtype=dtype, device=device), None
    if isinstance(mass, LowRankMass):
        return LowRankMass(*(None if leaf is None else _as_mass_tensor(leaf, dtype, device)
                             for leaf in mass)), None
    mass = _as_mass_tensor(mass, dtype, device)
    if mass.ndim == 2:
        return mass, _chol_upper(mass)
    if mass.ndim == 1:
        return mass, None
    raise ValueError("mass must be (n, n), (n,), LowRankMass, or None")


def _momentum(z, mass_arr, chol_u):
    """p ~ N(0, M⁻¹) from the standard-normal draw ``z`` (JAX's
    `_draw_momentum` after its draw), for every metric form. Dense without
    a precomputed chol_u (the fleet-adapted dense EMA inside warmup)
    factors on the fly."""
    if isinstance(mass_arr, LowRankMass):
        # core: M^(-1/2) z = z/sqrt(γ) + Q[(1/sqrt(sig) − 1/sqrt(γ))·(Qᵀz)]
        g, Q, sig = mass_arr.gamma, mass_arr.Q, mass_arr.sig
        qz = z @ Q  # (chains, r)
        p = z * torch.rsqrt(g) + (qz * (torch.rsqrt(sig) - torch.rsqrt(g))[None, :]) @ Q.T
        if mass_arr.d is not None:
            p = p * torch.rsqrt(mass_arr.d)[None, :]
        return p
    if mass_arr.ndim == 2:
        if chol_u is None:
            chol_u = _chol_upper(mass_arr)
        return torch.linalg.solve_triangular(chol_u, z.T, upper=True).T
    return z / torch.sqrt(mass_arr)[None, :]


def _apply_mass(mass_arr, p):
    """M⁻¹ p — the preconditioned leapfrog velocity (any metric form)."""
    if isinstance(mass_arr, LowRankMass):
        g, Q, sig = mass_arr.gamma, mass_arr.Q, mass_arr.sig
        if mass_arr.d is not None:
            sd = torch.sqrt(mass_arr.d)[None, :]
            ps = p * sd
            return sd * (g * ps + ((ps @ Q) * (sig - g)[None, :]) @ Q.T)
        return g * p + ((p @ Q) * (sig - g)[None, :]) @ Q.T
    if mass_arr.ndim == 2:
        return p @ mass_arr.T
    return mass_arr[None, :] * p


def _kinetic(p, mass_arr):
    """0.5 pᵀ M⁻¹ p with M⁻¹ = mass_arr (any metric form)."""
    if isinstance(mass_arr, LowRankMass):
        g, Q, sig = mass_arr.gamma, mass_arr.Q, mass_arr.sig
        if mass_arr.d is not None:
            p = p * torch.sqrt(mass_arr.d)[None, :]
        pq = p @ Q
        return 0.5 * (g * torch.sum(p * p, dim=1)
                      + torch.sum(pq * pq * (sig - g)[None, :], dim=1))
    if mass_arr.ndim == 2:
        return 0.5 * torch.sum((p @ mass_arr) * p, dim=1)
    return 0.5 * torch.sum(mass_arr[None, :] * p * p, dim=1)


def _mass_diag(mass_arr) -> torch.Tensor:
    """(n,) diagonal of any metric form — the result-field reporting."""
    if isinstance(mass_arr, LowRankMass):
        return mass_arr.diag
    if mass_arr.ndim == 2:
        return torch.diagonal(mass_arr)
    return mass_arr


# Dual averaging toward a target acceptance (Hoffman & Gelman 2014, the
# standard schedule). Elementwise: per-chain vectors (hmc_sample) and the
# fleet-mean scalar (chees_sample) alike.
_DA_T0, _DA_KAPPA, _DA_GAMMA = 10.0, 0.75, 0.05

# Fleet mass adaptation needs enough chains for the across-chain variance
# to mean anything (1 chain gives exactly 0; 2-4 are biased low): below
# this the samplers keep the identity metric.
_MASS_ADAPT_MIN_CHAINS = 8


def _da_update(h_bar, log_eps_bar, t, accept_err, mu):
    t = t + 1.0
    eta = 1.0 / (t + _DA_T0)
    h_bar = (1.0 - eta) * h_bar + eta * accept_err
    log_eps = mu - torch.sqrt(t) / _DA_GAMMA * h_bar
    w = t ** (-_DA_KAPPA)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return log_eps, log_eps_bar, h_bar, t


def _batched_objective(obj, value_and_grad_fn):
    """(value and gradient over the fleet, value over the fleet). A
    gradient derived by autodiff is one reverse pass of autograd through
    the vmapped value (a chain's value depends on its own row only, so the
    gradient of the sum is each chain's gradient): it dispatches fewer host
    ops a call than ``vmap(grad_and_value)``, to the same values. An
    explicit ``value_and_grad_fn`` or a model's own
    ``logdensity_and_gradient`` runs under ``vmap``."""
    f_b = torch.func.vmap(as_value_fn(obj, value_and_grad_fn))
    own = getattr(obj, "logdensity_and_gradient", None)
    derived = own is None or getattr(own, "__func__", None) is (
        ProbabilityModel.logdensity_and_gradient)
    if value_and_grad_fn is not None or not derived:
        return torch.func.vmap(as_value_and_grad(obj, value_and_grad_fn)), f_b

    def vag_b(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = f_b(x)
            g, = torch.autograd.grad(f.sum(), x)
        return f.detach(), g

    return vag_b, f_b


def _metropolis(x, f, p, x_new, p_new, f_new, u, mass_arr):
    """The accept/reject shared by both samplers: (x, f, accepted,
    acceptance probability, energy of the selected point, divergence)."""
    e_init = _kinetic(p, mass_arr) - f
    e_prop = _kinetic(p_new, mass_arr) - f_new
    log_ratio = e_init - e_prop
    # NaN-robust: a diverged trajectory (non-finite ratio) is rejected
    a_prob = torch.exp(torch.clamp_max(log_ratio, 0.0))
    a_prob = torch.where(torch.isfinite(a_prob), a_prob, torch.zeros_like(a_prob))
    acc = u < a_prob
    x = torch.where(acc[:, None], x_new, x)
    f = torch.where(acc, f_new, f)
    # Stan's energy__ and divergence flag (energy error non-finite or past
    # the blow-up threshold; fixed-length HMC rejects these in-band above)
    energy = torch.where(acc, e_prop, e_init)
    div = ~torch.isfinite(log_ratio) | (log_ratio < -1000.0)
    return x, f, acc, a_prob, energy, div


def _full(value, dtype, device, shape=()):
    return torch.full(shape, value, dtype=dtype, device=device)


def _counter(value, device):
    return torch.full((), value, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# HMC
# ---------------------------------------------------------------------------


def _hmc_core(obj, state: HMCState, mass, n_samples, n_warmup, n_leapfrog, target_accept,
              value_and_grad_fn, i_warm0, i_samp0) -> HMCResult:
    """Run ``n_warmup`` more warmup steps (global indices i_warm0..), then
    ``n_samples`` draws (global indices i_samp0..). The noise of each step
    is `_step_noise` of its phase and global index, so a chunked run
    replays the long run's draws."""
    vag_b, f_b = _batched_objective(obj, value_and_grad_fn)
    chains, n = state.x.shape
    dtype, device = state.x.dtype, state.x.device
    mass_b, chol_u = _mass_setup(mass, n, dtype, device)

    def leapfrog(x, p, eps):
        """Velocity Verlet with a per-chain eps (chains, 1): the end point,
        its momentum and its logdensity (the last evaluation's value)."""
        if n_leapfrog == 0:
            return x, p, f_b(x)
        _f, g = vag_b(x)
        for _ in range(n_leapfrog):
            p = p + 0.5 * eps * g
            x = x + eps * _apply_mass(mass_b, p)
            f_new, g = vag_b(x)
            p = p + 0.5 * eps * g
        hmc_sample.gradient_evals += n_leapfrog + 1
        return x, p, f_new

    def hmc_step(x, f, eps, phase, step):
        # the whole fleet's draw, this rank's rows of it (all of it unsharded)
        z, u = (own_rows(t) for t in _step_noise(state.key, phase, step, fleet_count(chains), n,
                                                 dtype, device))
        p = _momentum(z, mass_b, chol_u)
        x_new, p_new, f_new = leapfrog(x, p, eps[:, None])
        return _metropolis(x, f, p, x_new, p_new, f_new, u, mass_b)

    # first-ever call: the cached logdensity is not populated yet
    x = state.x
    f = f_b(x) if (i_warm0 == 0 and i_samp0 == 0) else state.f
    log_eps, log_eps_bar, h_bar, t_da = state.log_eps, state.log_eps_bar, state.h_bar, state.t_da

    # ---- warmup: dual averaging toward target_accept (per chain) ----
    for i in range(i_warm0, i_warm0 + n_warmup):
        x, f, _acc, a_prob, _e, _d = hmc_step(x, f, torch.exp(log_eps), 0, i)
        log_eps, log_eps_bar, h_bar, t_da = _da_update(
            h_bar, log_eps_bar, t_da, target_accept - a_prob, state.mu)
    eps_final = torch.exp(log_eps_bar)

    # ---- sampling at the adapted step ----
    samples = torch.empty((n_samples, chains, n), dtype=dtype, device=device)
    accs = torch.empty((n_samples, chains), dtype=dtype, device=device)
    energies = torch.empty((n_samples, chains), dtype=dtype, device=device)
    divs = torch.empty((n_samples, chains), dtype=torch.int32, device=device)
    for j in range(n_samples):
        x, f, acc, _a, energy, div = hmc_step(x, f, eps_final, 1, i_samp0 + j)
        samples[j], accs[j], energies[j], divs[j] = x, acc, energy, div
    out_state = HMCState(
        x=x, f=f, log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, t_da=t_da,
        mu=state.mu, key=state.key, i_warm=_counter(i_warm0 + n_warmup, device),
        i_samp=_counter(i_samp0 + n_samples, device),
    )
    return HMCResult(
        samples=samples,
        accept_rate=torch.mean(accs, dim=0),
        step_size=eps_final,
        energies=energies,
        divergences=torch.sum(divs, dim=0, dtype=torch.int32),
        final_x=x,
        state=out_state,
    )


def hmc_sample(
    obj,
    key,
    x0s,  # (chains, n) initial positions (e.g. the MAP fleet)
    mass=None,  # (n, n) dense, (n,) diagonal ~ cov, LowRankMass, or None
    n_samples: int = 1000,
    n_warmup: int = 500,
    n_leapfrog: int = 16,
    step_size: float = 0.1,
    target_accept: float = 0.8,
    value_and_grad_fn: Optional[Callable] = None,
) -> HMCResult:
    """Batched Euclidean HMC over independent chains.

    ``obj`` is the same logdensity (maximized, the log target) the
    optimizer takes; ``mass`` is the covariance-like preconditioner
    (`chain_init_from_map` provides B from the MAP fleet; None =
    identity). Warmup adapts a per-chain step size by dual averaging
    toward ``target_accept``; sampling runs at the adapted step. Chains
    advance in lockstep with a fixed path of ``n_leapfrog`` steps, and the
    loop reads nothing from the device.

    ``key``: see the module docstring. ``x0s`` follows the entry points'
    device rule (`utils.device.as_device_tensor`). The result carries a
    resumable `state`; `hmc_sample_from_state` continues (or
    checkpoint-chunks) the run trajectory-identically.
    """
    x0s = as_device_tensor(x0s)
    key = _as_key(key, hmc_sample)
    chains, _n = x0s.shape
    dtype, device = x0s.dtype, x0s.device
    eps0 = _full(step_size, dtype, device)
    log_eps0 = torch.log(eps0).expand(chains).clone()
    state0 = HMCState(
        x=x0s,
        f=_full(math.nan, dtype, device, (chains,)),
        log_eps=log_eps0,
        log_eps_bar=log_eps0,
        h_bar=torch.zeros((chains,), dtype=dtype, device=device),
        t_da=torch.zeros((), dtype=dtype, device=device),
        mu=torch.log(10.0 * eps0),
        key=key,
        i_warm=_counter(0, device),
        i_samp=_counter(0, device),
    )
    return _hmc_core(obj, state0, mass, n_samples, n_warmup, n_leapfrog, target_accept,
                     value_and_grad_fn, 0, 0)


def _read_counters(engine, *values) -> list:
    """0-d integer state leaves on the host in one read, counted in
    ``engine.host_syncs``."""
    engine.host_syncs += 1
    return torch.stack([v.to(torch.int64).reshape(()) for v in values]).tolist()


def hmc_sample_from_state(
    obj,
    state: HMCState,
    mass=None,
    n_samples: int = 0,
    n_warmup: int = 0,
    n_leapfrog: int = 16,
    target_accept: float = 0.8,
    value_and_grad_fn: Optional[Callable] = None,
) -> HMCResult:
    """Continue an `hmc_sample` run from its saved state: ``n_warmup``
    more warmup steps, then ``n_samples`` more draws. Chunked calls are
    trajectory-identical to one long run with the same totals (same key,
    same configuration: ``mass``/``n_leapfrog``/``target_accept`` are
    config, not state, and must be re-passed). Warmup cannot resume after
    sampling has begun (phases are monotone). The phase counters are read
    once, counted in ``hmc_sample.host_syncs``."""
    state = as_device_state(state)
    i_warm0, i_samp0 = _read_counters(hmc_sample, state.i_warm, state.i_samp)
    if n_warmup > 0 and i_samp0 > 0:
        raise ValueError(
            "cannot add warmup after sampling has begun "
            f"(state has {i_samp0} draws)"
        )
    return _hmc_core(obj, state, mass, n_samples, n_warmup, n_leapfrog, target_accept,
                     value_and_grad_fn, i_warm0, i_samp0)


hmc_sample.host_syncs = 0
hmc_sample.gradient_evals = 0


# ---------------------------------------------------------------------------
# ChEES-HMC
# ---------------------------------------------------------------------------


class ChEESState(NamedTuple):
    """Resumable state for `chees_sample`: positions, cached logdensity,
    the full adaptation state (dual-averaging accumulators, Adam moments
    on log T, the fleet-variance mass EMA), the base key and the phase
    counters. ``n_warmup_total`` / ``mass_freeze`` pin the Halton index
    offset and the mass-freeze step so chunked runs replay the long run
    exactly. Serializable via `utils.checkpoint.save_state`; ``key`` is
    the (2,) int64 CPU tensor of the module docstring."""

    x: torch.Tensor  # (chains, n)
    f: torch.Tensor  # (chains,)
    log_eps: torch.Tensor  # () DA iterate (shared step size)
    log_eps_bar: torch.Tensor  # () averaged iterate
    h_bar: torch.Tensor  # ()
    t_da: torch.Tensor  # ()
    mu: torch.Tensor  # () DA shrink target
    log_T: torch.Tensor  # () Adam iterate (mean trajectory length)
    m1: torch.Tensor  # () Adam first moment
    m2: torch.Tensor  # () Adam second moment
    t_adam: torch.Tensor  # () Adam step count
    log_T_min: torch.Tensor  # () lower clip (config bound at init)
    var_ema: torch.Tensor  # (n,) variance or (n, n) covariance mass EMA
    key: torch.Tensor  # (2,) int64 on the CPU
    i_warm: torch.Tensor  # () int32
    i_samp: torch.Tensor  # () int32
    n_warmup_total: torch.Tensor  # () int32 planned warmup length
    mass_freeze: torch.Tensor  # () int32 freeze step (n_warmup_total // 2)
    # adapt_mass='lowrank' only: the tracked covariance subspace, None in
    # every other mode
    lr_Q: Optional[torch.Tensor] = None  # (n, r) orthonormal basis
    lr_sig: Optional[torch.Tensor] = None  # (r,) eigenvalues along lr_Q


class ChEESResult(NamedTuple):
    """Samples and adaptation diagnostics for a ChEES-HMC run.

    samples: (n_samples, chains, n) post-warmup draws
    accept_rate: (chains,) mean Metropolis acceptance over sampling
    step_size: () adapted shared leapfrog step size
    traj_length: () adapted mean trajectory length (time units)
    mass_diag: (n,) the (possibly fleet-adapted) diagonal preconditioner
    energies: (n_samples, chains) Hamiltonian of each transition's
        selected phase-space point (Stan's ``energy__``)
    divergences: (chains,) int32 count of divergent transitions over
        sampling
    final_x: (chains, n) last state
    state: ChEESState — resume via `chees_sample_from_state`
    """

    samples: torch.Tensor
    accept_rate: torch.Tensor
    step_size: torch.Tensor
    traj_length: torch.Tensor
    mass_diag: torch.Tensor
    energies: torch.Tensor
    divergences: torch.Tensor
    final_x: torch.Tensor
    state: ChEESState


def _lowrank_gamma(lr_sig, n):
    """Off-subspace eigenvalue of the standardized low-rank core: the
    standardized covariance has trace ≈ n, so the mean residual
    eigenvalue is (n − Σsig)/(n − r). Derived from (lr_sig, n), not
    carried, so chunked runs replay long runs exactly."""
    r = lr_sig.shape[0]
    return torch.clamp_min((n - torch.sum(lr_sig)) / max(n - r, 1), 1e-10)


def _lowrank_metric(var_ema, lr_Q, lr_sig):
    """The sampling metric for adapt_mass='lowrank': the diagonal variance
    EMA as the outer scale times the standardized low-rank core."""
    n = lr_Q.shape[0]
    return LowRankMass(gamma=_lowrank_gamma(lr_sig, n), Q=lr_Q, sig=lr_sig, d=var_ema)


def _fleet_mass_step(adapt_mass, x, var_ema, lr_Q, lr_sig):
    """One round of the fleet metric's EMA from the whole fleet's (chains,
    n) positions ``x``: the across-chain covariance ('dense'; PD, as it
    mixes the PD carry with a ridged PSD sample covariance), the low-rank
    subspace step ('lowrank') or the across-chain variance (diag).
    Returns (var_ema, lr_Q, lr_sig)."""
    chains, n = x.shape
    if adapt_mass == "dense":
        xc = x - torch.mean(x, dim=0, keepdim=True)
        cov_now = xc.T @ xc / (chains - 1)
        cov_now = cov_now + 1e-8 * torch.eye(n, dtype=x.dtype, device=x.device) * (
            1.0 + torch.trace(cov_now) / n)
        return 0.9 * var_ema + 0.1 * cov_now, lr_Q, lr_sig
    if adapt_mass == "lowrank":
        lr_Q, lr_sig, var_ema = _lowrank_mass_step(x, var_ema, lr_Q, lr_sig, True, chains)
        return var_ema, lr_Q, lr_sig
    return 0.9 * var_ema + 0.1 * torch.clamp_min(_fleet_var(x), 1e-10), lr_Q, lr_sig


def _fleet_var(x):
    """Across-chain variance (ddof 0), as ``jnp.var(x, axis=0)``."""
    xc = x - torch.mean(x, dim=0, keepdim=True)
    return torch.sum(xc * xc, dim=0) / x.shape[0]


@_pin_matmul_precision
def _lowrank_mass_step(x, var_ema, lr_Q, lr_sig, upd, chains):
    """One subspace-iteration step on the EMA'd standardized covariance
    operator M' = 0.9·M_prev + 0.1·Cs_now, Cs = D^(-1/2)·C·D^(-1/2) with D
    the diagonal variance EMA — never an n×n matrix: each apply is
    O(chains·n·r + n·r²); the QR and the (r, r) eigh rotate the basis
    toward M''s top-r eigenspace. Float32 products in full float32 (no
    TF32), as JAX's "highest" precision. ``upd`` False returns the inputs.
    On a CUDA device ``torch.linalg.eigh`` synchronizes with the host."""
    if not upd:
        return lr_Q, lr_sig, var_ema
    xc = x - torch.mean(x, dim=0, keepdim=True)
    xs = xc * torch.rsqrt(var_ema)[None, :]  # standardized residuals
    gam = _lowrank_gamma(lr_sig, lr_Q.shape[0])

    def M_apply(V):
        qv = lr_Q.T @ V  # (r, cols)
        prev = gam * (V - lr_Q @ qv) + lr_Q @ (lr_sig[:, None] * qv)
        cur = xs.T @ (xs @ V) / (chains - 1)
        return 0.9 * prev + 0.1 * cur

    Qn, _r = torch.linalg.qr(M_apply(lr_Q))
    B = Qn.T @ M_apply(Qn)
    eigval, U = torch.linalg.eigh(0.5 * (B + B.T))
    lr_Q = Qn @ U
    lr_sig = torch.clamp_min(eigval, 1e-10)
    var_now = torch.clamp_min(_fleet_var(x), 1e-10)
    var_ema = 0.9 * var_ema + 0.1 * var_now
    return lr_Q, lr_sig, var_ema


def _lowrank_mass_init(mass_rank, n, chains, dtype, device=None):
    """Identity metric at rank r: first-r coordinate basis, unit
    eigenvalues. r is capped so Qᵀ·C·Q stays an honest eigenproblem
    (r < chains) and r <= n."""
    r = max(1, min(mass_rank, n, fleet_count(chains) - 1))
    return (torch.eye(n, r, dtype=dtype, device=device),
            torch.ones((r,), dtype=dtype, device=device))


def _halton(count: int, device=None) -> torch.Tensor:
    """Base-2 van der Corput sequence (the trajectory-length jitter grid
    the ChEES paper uses), in float64 on ``device``: bit k of the index
    adds 2^-(k+1), summed in the order of JAX's numpy loop, so the values
    are JAX's bit for bit. Cast to the chains' dtype before use (float32
    chains must not promote)."""
    idx = torch.arange(1, count + 1, dtype=torch.int64, device=device)
    out = torch.zeros(count, dtype=torch.float64, device=device)
    base = 0.5
    for _ in range(count.bit_length()):
        out += base * (idx & 1).to(torch.float64)
        idx >>= 1
        base *= 0.5
    return out


def _trip_count(ratio, max_leapfrog) -> int:
    """clip(round(t_jit / eps), 1, max_leapfrog) on the host from the
    device's rounded ``ratio`` (half to even, as ``jnp.round``): one read,
    counted in ``chees_sample.host_syncs``. NaN maps to 1 and ±inf to the
    clip's ends, as JAX's saturating conversion to int32 does."""
    chees_sample.host_syncs += 1
    r = float(torch.round(ratio))
    if math.isnan(r):
        return 1
    return int(min(max(r, 1.0), float(max_leapfrog)))


def _chees_core(obj, state: ChEESState, mass, n_samples, n_warmup, target_accept,
                max_leapfrog, adapt_mass, value_and_grad_fn, i_warm0, i_samp0,
                n_warmup_total, mass_freeze) -> ChEESResult:
    """Chunkable core (see `_hmc_core` for the noise discipline).
    ``n_warmup_total`` pins the Halton offset of the sampling phase and
    ``mass_freeze`` the EMA freeze step."""
    vag_b, f_b = _batched_objective(obj, value_and_grad_fn)
    chains, n = state.x.shape
    dtype, device = state.x.dtype, state.x.device
    # an explicit dense mass is static (adaptation is off), so its
    # Cholesky is factored once
    mass0, chol_u = _mass_setup(mass, n, dtype, device)

    def leapfrog_dyn(x, p, eps, mass_d, n_steps):
        """Velocity Verlet, one shared trip count (n_steps >= 1, all chains
        lockstep), the last step's second half kick a half step: the end
        point, its momentum and its logdensity."""
        p = p + 0.5 * eps * vag_b(x)[1]
        for i in range(n_steps):
            x = x + eps * _apply_mass(mass_d, p)
            f_new, g = vag_b(x)
            p = p + (eps if i < n_steps - 1 else 0.5 * eps) * g
        chees_sample.gradient_evals += n_steps + 1
        return x, p, f_new

    def round_(x, f, log_eps, log_T, mass_d, u, phase, step, chol_d):
        """One jittered-trajectory HMC round shared by warmup and
        sampling: new (x, f), acceptance probabilities, the ChEES gradient
        with respect to log T, energies and divergences."""
        eps = torch.exp(log_eps)
        t_jit = u * 2.0 * torch.exp(log_T)
        n_steps = _trip_count(t_jit / eps, max_leapfrog)
        z, u_mh = (own_rows(t) for t in _step_noise(state.key, phase, step, fleet_count(chains),
                                                    n, dtype, device))
        p = _momentum(z, mass_d, chol_d)
        x_new, p_new, f_new = leapfrog_dyn(x, p, eps, mass_d, n_steps)
        x_out, f_out, _acc, a_prob, energy, div = _metropolis(
            x, f, p, x_new, p_new, f_new, u_mh, mass_d)
        # ChEES gradient with respect to log T (chain rule through
        # t = u * 2T): Delta_c * <x'_c - mean(x'), M⁻¹ p'_c>, weighted by
        # the acceptance probability over the fleet
        # (the fleet's averages over all chains, sharded or not)
        w = x_new - torch.mean(fleet(x_new), dim=0, keepdim=True)
        v = x - torch.mean(fleet(x), dim=0, keepdim=True)
        delta = torch.sum(w * w, dim=1) - torch.sum(v * v, dim=1)
        dxdt = _apply_mass(mass_d, p_new)
        per_chain = delta * torch.sum(w * dxdt, dim=1)
        wsum = torch.clamp_min(torch.sum(fleet(a_prob)), 1e-6)
        g_chees = torch.sum(fleet(a_prob * per_chain)) / wsum * t_jit
        g_chees = torch.where(torch.isfinite(g_chees), g_chees, torch.zeros_like(g_chees))
        return x_out, f_out, a_prob, g_chees, energy, div

    # first-ever call: populate the cached logdensity
    x = state.x
    f = f_b(x) if (i_warm0 == 0 and i_samp0 == 0) else state.f
    # the Halton index is global (warmup step i -> halton[i]; sampling
    # step j -> halton[n_warmup_total + j]), cast to the chains' dtype
    us_all = _halton(n_warmup_total + i_samp0 + n_samples, device).to(dtype)

    # ---- warmup: joint (eps, T, mass) adaptation ----
    b1, b2, adam_lr = 0.9, 0.95, 0.025
    log_T_min = state.log_T_min
    log_eps, log_eps_bar, h_bar, tda = state.log_eps, state.log_eps_bar, state.h_bar, state.t_da
    log_T, m1, m2, tad = state.log_T, state.m1, state.m2, state.t_adam
    var_ema, lr_Q, lr_sig = state.var_ema, state.lr_Q, state.lr_sig
    frozen_chol = None  # the dense EMA's factor once it is frozen
    for i in range(i_warm0, i_warm0 + n_warmup):
        adapting = i < mass_freeze
        if adapt_mass == "lowrank":
            mass_d, chol_d = _lowrank_metric(var_ema, lr_Q, lr_sig), None
        elif adapt_mass:
            if adapt_mass == "dense" and not adapting and frozen_chol is None:
                frozen_chol = _chol_upper(var_ema)
            # adapting dense rounds factor on the fly in _momentum
            mass_d, chol_d = var_ema, frozen_chol
        else:
            mass_d, chol_d = mass0, chol_u
        x, f, a_prob, g_chees, _e, _d = round_(x, f, log_eps, log_T, mass_d, us_all[i], 0, i,
                                              chol_d)

        # dual averaging on the fleet-mean acceptance
        log_eps, log_eps_bar, h_bar, tda = _da_update(
            h_bar, log_eps_bar, tda, target_accept - torch.mean(fleet(a_prob)), state.mu)

        # Adam ascent on log T with the ChEES gradient
        tad = tad + 1.0
        m1 = b1 * m1 + (1.0 - b1) * g_chees
        m2 = b2 * m2 + (1.0 - b2) * g_chees * g_chees
        mhat = m1 / (1.0 - b1 ** tad)
        vhat = m2 / (1.0 - b2 ** tad)
        log_T = log_T + adam_lr * mhat / (torch.sqrt(vhat) + 1e-8)
        log_T = torch.minimum(torch.maximum(log_T, log_T_min),
                              torch.log(max_leapfrog * torch.exp(log_eps_bar)))

        # fleet mass: across-chain variance (diag) or covariance (dense)
        # EMA, frozen at half-warmup. The dense EMA stays PD: it mixes a PD
        # carry (eye init) with a PSD sample covariance + tiny ridge.
        if not adapting:
            continue
        if adapt_mass:
            var_ema, lr_Q, lr_sig = _fleet_mass_step(adapt_mass, fleet(x), var_ema, lr_Q, lr_sig)

    if adapt_mass == "lowrank":
        mass_final = _lowrank_metric(var_ema, lr_Q, lr_sig)
    else:
        mass_final = var_ema if adapt_mass else mass0
    eps_final = torch.exp(log_eps_bar)
    if adapt_mass == "dense":
        chol_final = frozen_chol if frozen_chol is not None else _chol_upper(mass_final)
    else:
        chol_final = chol_u if not adapt_mass else None

    # ---- sampling at frozen (eps, T, mass), still Halton-jittered ----
    samples = torch.empty((n_samples, chains, n), dtype=dtype, device=device)
    a_probs = torch.empty((n_samples, chains), dtype=dtype, device=device)
    energies = torch.empty((n_samples, chains), dtype=dtype, device=device)
    divs = torch.empty((n_samples, chains), dtype=torch.int32, device=device)
    for j in range(n_samples):
        x, f, a_prob, _g, energy, div = round_(
            x, f, log_eps_bar, log_T, mass_final, us_all[n_warmup_total + i_samp0 + j], 1,
            i_samp0 + j, chol_final)
        samples[j], a_probs[j], energies[j], divs[j] = x, a_prob, energy, div
    out_state = ChEESState(
        x=x, f=f, log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, t_da=tda,
        mu=state.mu, log_T=log_T, m1=m1, m2=m2, t_adam=tad, log_T_min=state.log_T_min,
        var_ema=var_ema, key=state.key, i_warm=_counter(i_warm0 + n_warmup, device),
        i_samp=_counter(i_samp0 + n_samples, device),
        n_warmup_total=_counter(n_warmup_total, device),
        mass_freeze=_counter(mass_freeze, device), lr_Q=lr_Q, lr_sig=lr_sig,
    )
    return ChEESResult(
        samples=samples,
        accept_rate=torch.mean(a_probs, dim=0),
        step_size=eps_final,
        traj_length=torch.exp(log_T),
        mass_diag=_mass_diag(mass_final),
        energies=energies,
        divergences=torch.sum(divs, dim=0, dtype=torch.int32),
        final_x=x,
        state=out_state,
    )


def _chees_adapt_mass(adapt_mass, mass, chains):
    """The static adapt-mass decision (the same rule on first call and on
    resume): an explicit mass or a tiny fleet disables the across-chain
    metric. Returns the normalized mode: False, 'diag' (the across-chain
    variance EMA), 'dense' (full across-chain covariance EMA, for n up to
    a few hundred) or 'lowrank' (rank-r across-chain covariance tracked by
    per-round subspace iteration)."""
    if not adapt_mass or mass is not None or fleet_count(chains) < _MASS_ADAPT_MIN_CHAINS:
        return False
    if adapt_mass is True:
        return "diag"
    if adapt_mass in ("diag", "dense", "lowrank"):
        return adapt_mass
    raise ValueError(
        f"adapt_mass must be bool, 'diag', 'dense' or 'lowrank', "
        f"got {adapt_mass!r}"
    )


def _check_resume_mass_mode(adapt_mass, var_ema, lr_Q=None) -> None:
    """Resume guard: the saved state's mass EMA must match the re-passed
    ``adapt_mass`` mode. The (n,) diag variance and the (n, n) covariance
    live in the same ``var_ema`` field and adapt_mass is config, so
    resuming a 'dense' run under 'diag' would otherwise broadcast the (n,)
    variance into the covariance EMA; 'lowrank' likewise must find its
    saved subspace."""
    if not adapt_mass:
        return
    saved = (
        "lowrank" if lr_Q is not None
        else ("dense" if var_ema.ndim == 2 else "diag")
    )
    if adapt_mass != saved:
        raise ValueError(
            f"adapt_mass={adapt_mass!r} does not match the saved state's "
            f"{saved!r} mass adaptation (var_ema.ndim={var_ema.ndim}, "
            f"lr_Q={'set' if lr_Q is not None else 'None'}); re-pass "
            f"adapt_mass={saved!r} to resume this run"
        )


def chees_sample(
    obj,
    key,
    x0s,  # (chains, n) initial positions (e.g. the MAP fleet)
    mass=None,  # (n,n) dense / (n,) diag ~ cov / LowRankMass; None = adapt diag
    n_samples: int = 1000,
    n_warmup: int = 500,
    step_size: float = 0.1,
    traj_length: float = 1.0,
    target_accept: float = 0.75,
    max_leapfrog: int = 1024,
    adapt_mass=True,
    value_and_grad_fn: Optional[Callable] = None,
    total_warmup: Optional[int] = None,
    mass_rank: int = 16,
) -> ChEESResult:
    """Batched HMC with ChEES-adapted trajectory lengths (Hoffman, Radul &
    Sountsov, AISTATS 2021): all chains run the same jittered trajectory
    each round, and the mean trajectory length is learned by gradient
    ascent on the Change-in-Estimator of the Expected Square criterion,
    whose per-chain signal Delta_c * <x'_c - mean(x'), p'_c> (weighted by
    the Metropolis acceptance probability) the fleet estimates in one
    cross-chain reduction per round.

    Adaptation (warmup only):
      * trajectory length: Adam on log T with the ChEES gradient; each
        round uses t = u * 2T with u from a base-2 Halton sequence,
        clamped so the leapfrog count stays in [1, max_leapfrog];
      * step size: dual averaging of the fleet-mean acceptance toward
        ``target_accept`` (one shared eps);
      * mass: with ``adapt_mass`` and no explicit ``mass``, the diagonal
        preconditioner is the across-chain variance of the fleet
        (EMA-smoothed, frozen after warmup/2); ``adapt_mass='dense'``
        tracks the full (n, n) covariance EMA, ``adapt_mass='lowrank'``
        its top-``mass_rank`` eigenspace by one subspace-iteration step
        a round and samples with the closed-form `LowRankMass`.

    Returns post-warmup draws at frozen (eps, T, mass), the trajectory
    still Halton-jittered. Each round reads its leapfrog count from the
    device once (``chees_sample.host_syncs``). For chunked warmup announce
    the plan with ``total_warmup`` (it pins the Halton offset and the
    mass-freeze step), run ``n_warmup <= total_warmup`` steps now and the
    rest via `chees_sample_from_state`.
    """
    x0s = as_device_tensor(x0s)
    chains, n = x0s.shape
    dtype, device = x0s.dtype, x0s.device
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
            "n_samples=0 and finish warmup via chees_sample_from_state"
        )
    key = _as_key(key, chees_sample)
    adapt_mass = _chees_adapt_mass(adapt_mass, mass, chains)
    var0 = (
        torch.eye(n, dtype=dtype, device=device)
        if adapt_mass == "dense"
        else torch.ones((n,), dtype=dtype, device=device)
    )
    if adapt_mass == "lowrank":
        lr_Q0, lr_sig0 = _lowrank_mass_init(mass_rank, n, chains, dtype, device)
    else:
        lr_Q0 = lr_sig0 = None
    eps0 = _full(step_size, dtype, device)

    def zero():
        return torch.zeros((), dtype=dtype, device=device)

    mass_freeze = max(total_warmup // 2, 1)
    state0 = ChEESState(
        x=x0s,
        f=_full(math.nan, dtype, device, (chains,)),
        log_eps=torch.log(eps0),
        log_eps_bar=torch.log(eps0),
        h_bar=zero(),
        t_da=zero(),
        mu=torch.log(10.0 * eps0),
        log_T=torch.log(_full(traj_length, dtype, device)),
        m1=zero(),
        m2=zero(),
        t_adam=zero(),
        log_T_min=torch.log(eps0 * 0.5),
        var_ema=var0,
        key=key,
        i_warm=_counter(0, device),
        i_samp=_counter(0, device),
        n_warmup_total=_counter(total_warmup, device),
        mass_freeze=_counter(mass_freeze, device),
        lr_Q=lr_Q0,
        lr_sig=lr_sig0,
    )
    return _chees_core(obj, state0, mass, n_samples, n_warmup, target_accept, max_leapfrog,
                       adapt_mass, value_and_grad_fn, 0, 0, total_warmup, mass_freeze)


def chees_sample_from_state(
    obj,
    state: ChEESState,
    mass=None,
    n_samples: int = 0,
    n_warmup: int = 0,
    target_accept: float = 0.75,
    max_leapfrog: int = 1024,
    adapt_mass=True,
    value_and_grad_fn: Optional[Callable] = None,
) -> ChEESResult:
    """Continue a `chees_sample` run: ``n_warmup`` more warmup steps, then
    ``n_samples`` more draws, trajectory-identical to one long run with
    the same totals. The warmup plan is pinned by the first call's
    ``total_warmup``; extending warmup beyond the plan, or drawing before
    the plan is complete, raises. Config args (``mass``/
    ``target_accept``/``max_leapfrog``/``adapt_mass``) are not state and
    must be re-passed. The phase counters are read once, counted in
    ``chees_sample.host_syncs``."""
    state = as_device_state(state)
    i_warm0, i_samp0, n_total, mass_freeze = _read_counters(
        chees_sample, state.i_warm, state.i_samp, state.n_warmup_total, state.mass_freeze)
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
    chains = state.x.shape[0]
    adapt_mass = _chees_adapt_mass(adapt_mass, mass, chains)
    _check_resume_mass_mode(adapt_mass, state.var_ema, state.lr_Q)
    return _chees_core(obj, state, mass, n_samples, n_warmup, target_accept, max_leapfrog,
                       adapt_mass, value_and_grad_fn, i_warm0, i_samp0, n_total, mass_freeze)


chees_sample.host_syncs = 0
chees_sample.gradient_evals = 0


# ---------------------------------------------------------------------------
# NUTS
# ---------------------------------------------------------------------------


class NUTSState(NamedTuple):
    """Resumable state for `nuts_sample`: positions, cached (logdensity,
    gradient), the per-chain dual-averaging accumulators, the
    fleet-variance mass EMA, the base key and the phase counters.
    ``n_warmup_total`` / ``mass_freeze`` pin the freeze schedule so
    chunked runs replay the long run exactly. Serializable via
    `utils.checkpoint.save_state`; ``key`` is the (2,) int64 CPU tensor of
    the module docstring."""

    x: torch.Tensor  # (chains, n)
    f: torch.Tensor  # (chains,)
    g: torch.Tensor  # (chains, n) gradient at x
    log_eps: torch.Tensor  # (chains,)
    log_eps_bar: torch.Tensor  # (chains,)
    h_bar: torch.Tensor  # (chains,)
    t_da: torch.Tensor  # ()
    mu: torch.Tensor  # ()
    var_ema: torch.Tensor  # (n,) variance or (n, n) covariance EMA
    key: torch.Tensor  # (2,) int64 on the CPU
    i_warm: torch.Tensor  # () int32
    i_samp: torch.Tensor  # () int32
    n_warmup_total: torch.Tensor  # () int32
    mass_freeze: torch.Tensor  # () int32
    # adapt_mass='lowrank' only: the tracked covariance subspace, None in
    # every other mode
    lr_Q: Optional[torch.Tensor] = None  # (n, r) orthonormal basis
    lr_sig: Optional[torch.Tensor] = None  # (r,) eigenvalues along lr_Q
    # warmup depth telemetry: per-chain tree-depth sums over the two tail
    # windows of the warmup plan (`_warm_depth_windows`), the probe data of
    # `nuts_sample_depth_sorted`; None on states from before it (the
    # sorter then spends probe legs)
    warm_dsum: Optional[torch.Tensor] = None  # (2, chains)


class NUTSResult(NamedTuple):
    """Samples and diagnostics for a batched NUTS run.

    samples: (n_samples, chains, n) post-warmup draws
    accept_prob: (chains,) mean leaf acceptance-probability surrogate
    step_size: (chains,) adapted leapfrog step size
    mean_tree_depth: (chains,) mean doublings per draw over sampling
    mass_diag: (n,) the (possibly fleet-adapted) diagonal preconditioner
    energies: (n_samples, chains) post-momentum-refresh Hamiltonian of
        each transition — feed `diagnostics.energy_bfmi` for the
        Betancourt E-BFMI check
    divergences: (chains,) int32 count of draws whose tree hit a
        divergent leaf (energy error past ``max_energy_change``)
    final_x: (chains, n) last state
    state: NUTSState — resume via `nuts_sample_from_state`
    """

    samples: torch.Tensor
    accept_prob: torch.Tensor
    step_size: torch.Tensor
    mean_tree_depth: torch.Tensor
    mass_diag: torch.Tensor
    energies: torch.Tensor
    divergences: torch.Tensor
    final_x: torch.Tensor
    state: NUTSState


def _warm_depth_windows(total: int):
    """The two tail windows of a warmup plan used for depth telemetry:
    W rounds each (W = min(32, total // 4), >= 1), ending at the plan's
    last round — post-freeze, so the step size is near-final and tree
    depths are representative of the sampling phase."""
    W = max(1, min(32, total // 4))
    return total - 2 * W, total - W, total, W


def _any(flags) -> bool:
    """Whether any flag is set over the whole fleet: one read of the
    device, counted in ``nuts_sample.host_syncs``."""
    nuts_sample.host_syncs += 1
    return bool(fleet_any(flags))


def _nuts_core(obj, state: NUTSState, mass, n_samples, n_warmup, max_depth, target_accept,
               max_energy_change, adapt_mass, value_and_grad_fn, i_warm0, i_samp0, mass_freeze,
               warm_total) -> NUTSResult:
    """Chunkable core (see `_hmc_core` for the noise discipline); the
    algorithm notes are `nuts_sample`'s.

    Batched multinomial NUTS, iterative formulation, over lockstep chains:
    the trees double in lockstep, and chains that have U-turned or
    diverged are frozen by masks (every leaf still evaluates every chain).
    A round of doublings ends as soon as every chain is done, and a
    subtree as soon as none of its chains is active: each such condition
    is one counted read (`_any`). A subtree's first leaf needs no read,
    since its chains are the ones the doubling's read found not done.

    The checkpoint stack: leaf i (0-based) of a subtree stores its state
    at slot popcount(i) when i is even; when i is odd, the subtrees ending
    at i span [i - 2^k + 1, i] for k = 1..t (t the trailing one-bits of i)
    and their start states sit at slots popcount(i) - k. The slot indices
    are host ints. U-turn checks between a stored checkpoint and the
    current leaf use forward-time orientation dx = d·(x - x_ckpt): the
    leapfrog with -eps traces the forward trajectory into the past, so
    stored momenta are already forward-convention.

    A chain reads a stack slot only where it was active at every earlier
    leaf of the subtree, so only slots it wrote in this subtree: the stack
    is allocated once per call and not cleared between subtrees."""
    vag_b, _f_b = _batched_objective(obj, value_and_grad_fn)
    chains, n = state.x.shape
    dtype, device = state.x.dtype, state.x.device
    mass_b, chol_u = _mass_setup(mass, n, dtype, device)
    key = state.key
    stack_x = torch.zeros((max_depth + 1, chains, n), dtype=dtype, device=device)
    stack_p = torch.zeros_like(stack_x)

    def no_uturn(dx, va, vb):
        """True where not turning: dx oriented forward-time, va and vb the
        velocities M⁻¹p at its two ends."""
        return (torch.sum(dx * va, dim=1) >= 0.0) & (torch.sum(dx * vb, dim=1) >= 0.0)

    def build_subtree(x, p, g, d, n_leaf, eps, h0, alive, mass_d, phase, step, j):
        """Integrate up to n_leaf leaves from (x, p) in direction d (±1),
        multinomial-sampling a proposal and checking U-turns iteratively.
        One fleet-wide value and gradient a leaf. A chain stops at its
        first turning or divergent leaf, so the divergent chains are found
        at the end: alive, not turned, and no longer active."""
        e = (d * eps)[:, None]
        half_e = 0.5 * e
        lw = torch.full((chains,), -math.inf, dtype=dtype, device=device)
        xp, fp, gp = x, torch.zeros((chains,), dtype=dtype, device=device), g
        turn = torch.zeros((chains,), dtype=torch.bool, device=device)
        sa = torch.zeros((chains,), dtype=dtype, device=device)
        na = torch.zeros((chains,), dtype=torch.int32, device=device)
        dcol = d[:, None]
        act = alive  # alive & ~turn & ~div, carried from leaf to leaf
        for i in range(n_leaf):
            if i > 0 and not _any(act):
                break
            # one leapfrog step
            p_half = p + half_e * g
            x2 = x + e * _apply_mass(mass_d, p_half)
            f2, g2 = vag_b(x2)
            nuts_sample.gradient_evals += 1
            p2 = p_half + half_e * g2
            lw_leaf = f2 - _kinetic(p2, mass_d) - h0
            # not divergent: finite and not below -max_energy_change
            ok = act & torch.isfinite(lw_leaf) & (lw_leaf >= -max_energy_change)
            # exp(min(lw, 0)) lies in [0, 1] or is NaN: NaN maps to 0
            alpha = torch.nan_to_num(torch.exp(torch.clamp_max(lw_leaf, 0.0)), nan=0.0)
            # progressive multinomial: take the new leaf w.p. w/W (u < NaN
            # is False where both weights are -inf)
            lw_new = torch.logaddexp(lw, lw_leaf)
            u = own_rows(_nuts_leaf_noise(key, phase, step, j, i, fleet_count(chains), dtype,
                                          device))
            take = ok & (u < torch.exp(lw_leaf - lw_new))
            xp = torch.where(take[:, None], x2, xp)
            fp = torch.where(take, f2, fp)
            gp = torch.where(take[:, None], g2, gp)
            lw = torch.where(ok, lw_new, lw)
            sa = sa + torch.where(act, alpha, 0.0)
            na = na + act
            slot = bin(i).count("1")
            okc = ok[:, None]
            if i % 2 == 0:
                stack_x[slot] = torch.where(okc, x2, stack_x[slot])
                stack_p[slot] = torch.where(okc, p2, stack_p[slot])
                act = ok
            else:
                t_ones = bin(i ^ (i + 1)).count("1") - 1
                v2 = _apply_mass(mass_d, p2)
                good = None
                for kk in range(1, t_ones + 1):
                    ck = max(slot - kk, 0)
                    g_k = no_uturn(dcol * (x2 - stack_x[ck]), _apply_mass(mass_d, stack_p[ck]),
                                   v2)
                    good = g_k if good is None else good & g_k
                turn = turn | (ok & ~good)
                act = ok & good
            # frozen lanes keep their previous endpoint state
            x = torch.where(okc, x2, x)
            p = torch.where(okc, p2, p)
            g = torch.where(okc, g2, g)
        div = alive & ~turn & ~act
        return x, p, g, lw, xp, fp, gp, turn, div, sa, na

    def one_draw(x, f, g, eps, mass_d, chol_d, phase, step):
        """One NUTS transition for all chains: the new (x, f, g), the mean
        leaf-acceptance surrogate, the tree depth, the start-of-trajectory
        Hamiltonian (for E-BFMI) and the per-chain divergence flag.
        ``chol_d``: the dense mass's factor where it is fixed, None for the
        adapting dense EMA (factored per draw)."""
        z = own_rows(_nuts_momentum_noise(key, phase, step, fleet_count(chains), n, dtype,
                                          device))
        p0 = _momentum(z, mass_d, chol_d)
        h0 = f - _kinetic(p0, mass_d)
        x_l, p_l, g_l = x_r, p_r, g_r = x, p0, g
        xp, fp, gp = x, f, g
        lw_tot = torch.zeros((chains,), dtype=dtype, device=device)  # initial leaf weight exp(0)
        sa = torch.zeros((chains,), dtype=dtype, device=device)
        na = torch.zeros((chains,), dtype=torch.int32, device=device)
        depth = torch.zeros((chains,), dtype=torch.int32, device=device)
        divflag = torch.zeros((chains,), dtype=torch.bool, device=device)
        done = torch.zeros_like(divflag)
        for j in range(max_depth):
            # no chain is done before the first doubling
            if j > 0 and not _any(~done):
                break
            d, u = (own_rows(t) for t in _nuts_doubling_noise(key, phase, step, j,
                                                              fleet_count(chains), dtype, device))
            fwd = (d > 0)[:, None]
            (x_e, p_e, g_e, st_lw, st_xp, st_fp, st_gp, st_turn, st_div, st_sa,
             st_na) = build_subtree(torch.where(fwd, x_r, x_l), torch.where(fwd, p_r, p_l),
                                    torch.where(fwd, g_r, g_l), d, 2 ** j, eps, h0, ~done,
                                    mass_d, phase, step, j)
            ok = ~done & ~st_turn & ~st_div
            # biased progressive between subtrees: favor the new one
            take = ok & (u < torch.exp(torch.clamp_max(st_lw - lw_tot, 0.0)))
            xp = torch.where(take[:, None], st_xp, xp)
            fp = torch.where(take, st_fp, fp)
            gp = torch.where(take[:, None], st_gp, gp)
            lw_tot = torch.where(ok, torch.logaddexp(lw_tot, st_lw), lw_tot)
            okm = ok[:, None] & fwd
            x_r, p_r, g_r = (torch.where(okm, x_e, x_r), torch.where(okm, p_e, p_r),
                             torch.where(okm, g_e, g_r))
            okm = ok[:, None] & ~fwd
            x_l, p_l, g_l = (torch.where(okm, x_e, x_l), torch.where(okm, p_e, p_l),
                             torch.where(okm, g_e, g_l))
            # global U-turn across the merged tree's true-time ends
            turn_g = ~no_uturn(x_r - x_l, _apply_mass(mass_d, p_l), _apply_mass(mass_d, p_r))
            depth = depth + ok.to(torch.int32)
            sa = sa + torch.where(~done, st_sa, 0.0)
            na = na + torch.where(~done, st_na, 0)
            divflag = divflag | st_div
            done = done | st_turn | st_div | (ok & turn_g)
        alpha = sa / torch.clamp_min(na, 1).to(dtype)
        return xp, fp, gp, alpha, depth, -h0, divflag

    # first-ever call: populate the cached (logdensity, gradient)
    if i_warm0 == 0 and i_samp0 == 0:
        f, g = vag_b(state.x)
        nuts_sample.gradient_evals += 1
    else:
        f, g = state.f, state.g
    x = state.x

    # ---- warmup: per-chain dual averaging + fleet mass ----
    w1s, w2s, w2e, _W = _warm_depth_windows(warm_total)
    wds = (torch.zeros((2, chains), dtype=dtype, device=device) if state.warm_dsum is None
           else state.warm_dsum.clone())
    log_eps, log_eps_bar, h_bar, t_da = state.log_eps, state.log_eps_bar, state.h_bar, state.t_da
    var_ema, lr_Q, lr_sig = state.var_ema, state.lr_Q, state.lr_sig
    frozen_chol = None  # the dense EMA's factor once it is frozen
    for i in range(i_warm0, i_warm0 + n_warmup):
        adapting = i < mass_freeze
        if adapt_mass == "lowrank":
            # diag-EMA outer scale x standardized low-rank core
            mass_d, chol_d = _lowrank_metric(var_ema, lr_Q, lr_sig), None
        elif adapt_mass:
            if adapt_mass == "dense" and not adapting and frozen_chol is None:
                frozen_chol = _chol_upper(var_ema)
            # adapting dense rounds factor on the fly in _momentum
            mass_d, chol_d = var_ema, frozen_chol
        else:
            mass_d, chol_d = mass_b, chol_u
        x, f, g, alpha, depth, _e, _d = one_draw(x, f, g, torch.exp(log_eps), mass_d, chol_d,
                                                 0, i)
        # depth telemetry over the plan's two tail windows (post-freeze
        # rounds: eps is near-final and depths match the sampling phase)
        if w1s <= i < w2s:
            wds[0] += depth.to(dtype)
        elif w2s <= i < w2e:
            wds[1] += depth.to(dtype)
        log_eps, log_eps_bar, h_bar, t_da = _da_update(
            h_bar, log_eps_bar, t_da, target_accept - alpha, state.mu)
        if not adapting:
            continue
        # chees_sample's fleet estimator, frozen at warmup/2 so eps
        # re-adapts to the final metric
        if adapt_mass:
            var_ema, lr_Q, lr_sig = _fleet_mass_step(adapt_mass, fleet(x), var_ema, lr_Q, lr_sig)

    eps_final = torch.exp(log_eps_bar)
    if adapt_mass == "lowrank":
        mass_final = _lowrank_metric(var_ema, lr_Q, lr_sig)
    else:
        mass_final = var_ema if adapt_mass else mass_b
    if adapt_mass == "dense":
        chol_final = frozen_chol if frozen_chol is not None else _chol_upper(mass_final)
    else:
        chol_final = chol_u if not adapt_mass else None

    # ---- sampling at the adapted (eps, mass) ----
    samples = torch.empty((n_samples, chains, n), dtype=dtype, device=device)
    alphas = torch.empty((n_samples, chains), dtype=dtype, device=device)
    depths = torch.empty((n_samples, chains), dtype=dtype, device=device)
    energies = torch.empty((n_samples, chains), dtype=dtype, device=device)
    divs = torch.empty((n_samples, chains), dtype=torch.int32, device=device)
    for j in range(n_samples):
        x, f, g, alpha, depth, energy, div = one_draw(x, f, g, eps_final, mass_final,
                                                      chol_final, 1, i_samp0 + j)
        samples[j], alphas[j], depths[j], energies[j], divs[j] = x, alpha, depth, energy, div
    out_state = NUTSState(
        x=x, f=f, g=g, log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, t_da=t_da,
        mu=state.mu, var_ema=var_ema, key=state.key,
        i_warm=_counter(i_warm0 + n_warmup, device), i_samp=_counter(i_samp0 + n_samples, device),
        n_warmup_total=state.n_warmup_total, mass_freeze=_counter(mass_freeze, device),
        lr_Q=lr_Q, lr_sig=lr_sig, warm_dsum=wds,
    )
    # means as JAX's compiled mean takes them: the sum over draws times the
    # reciprocal of their count (NaN without draws)
    inv_count = 1.0 / n_samples if n_samples else math.nan
    return NUTSResult(
        samples=samples,
        accept_prob=torch.sum(alphas, dim=0) * inv_count,
        step_size=eps_final,
        mean_tree_depth=torch.sum(depths, dim=0) * inv_count,
        mass_diag=_mass_diag(mass_final),
        energies=energies,
        divergences=torch.sum(divs, dim=0, dtype=torch.int32),
        final_x=x,
        state=out_state,
    )


def nuts_sample(
    obj,
    key,
    x0s,  # (chains, n) initial positions (e.g. the MAP fleet)
    mass=None,  # (n, n) dense / (n,) diag ~ cov / LowRankMass; None = adapt
    n_samples: int = 1000,
    n_warmup: int = 500,
    step_size: float = 0.1,
    max_depth: int = 8,
    target_accept: float = 0.8,
    max_energy_change: float = 1000.0,
    adapt_mass=True,
    value_and_grad_fn: Optional[Callable] = None,
    total_warmup: Optional[int] = None,
    mass_rank: int = 16,
) -> NUTSResult:
    """Batched multinomial NUTS over lockstep chains.

    The No-U-Turn Sampler (Hoffman & Gelman 2014) with the refinements
    Stan ships: multinomial sampling over the trajectory (progressive
    within a subtree, biased toward the new subtree between subtrees —
    Betancourt 2017), iterative tree building with a checkpoint stack of
    O(max_depth) boundary states, dual-averaged per-chain step sizes
    driven by the leaf acceptance-probability surrogate, divergence
    rejection at ``max_energy_change``, and (with ``adapt_mass``, no
    explicit ``mass``) `chees_sample`'s fleet mass adaptation, frozen at
    warmup/2. ``adapt_mass`` takes the same modes: True/'diag', 'dense'
    (full across-chain covariance EMA) and 'lowrank' (top-``mass_rank``
    eigenspace by subspace iteration, sampling through `LowRankMass`).
    Each doubling costs 2^j gradient evaluations, so a better metric,
    which shrinks the depth, is a direct throughput lever.

    Chains advance in lockstep (see `_nuts_core`): every chain waits for
    the deepest tree of each draw, and the loops read one flag a leaf and
    one a doubling (``nuts_sample.host_syncs``). `chees_sample` is the
    lockstep-native alternative.

    ``key``: see the module docstring. ``x0s`` follows the entry points'
    device rule (`utils.device.as_device_tensor`). The result carries a
    resumable `state`; `nuts_sample_from_state` continues the run
    trajectory-identically. For chunked warmup announce the plan with
    ``total_warmup`` (it pins the mass-freeze step and the depth
    telemetry's windows) and run ``n_warmup <= total_warmup`` steps now,
    the rest via the resume entry point.
    """
    x0s = as_device_tensor(x0s)
    chains, n = x0s.shape
    dtype, device = x0s.dtype, x0s.device
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
            "n_samples=0 and finish warmup via nuts_sample_from_state"
        )
    key = _as_key(key, nuts_sample)
    adapt_mass = _chees_adapt_mass(adapt_mass, mass, chains)
    var0 = (
        torch.eye(n, dtype=dtype, device=device)
        if adapt_mass == "dense"
        else torch.ones((n,), dtype=dtype, device=device)
    )
    if adapt_mass == "lowrank":
        lr_Q0, lr_sig0 = _lowrank_mass_init(mass_rank, n, chains, dtype, device)
    else:
        lr_Q0 = lr_sig0 = None
    eps0 = _full(step_size, dtype, device)
    log_eps0 = torch.log(eps0).expand(chains).clone()
    mass_freeze = max(total_warmup // 2, 1)
    state0 = NUTSState(
        x=x0s,
        f=_full(math.nan, dtype, device, (chains,)),
        g=torch.zeros_like(x0s),
        log_eps=log_eps0,
        log_eps_bar=log_eps0,
        h_bar=torch.zeros((chains,), dtype=dtype, device=device),
        t_da=torch.zeros((), dtype=dtype, device=device),
        mu=torch.log(10.0 * eps0),
        var_ema=var0,
        key=key,
        i_warm=_counter(0, device),
        i_samp=_counter(0, device),
        n_warmup_total=_counter(total_warmup, device),
        mass_freeze=_counter(mass_freeze, device),
        lr_Q=lr_Q0,
        lr_sig=lr_sig0,
        warm_dsum=torch.zeros((2, chains), dtype=dtype, device=device),
    )
    return _nuts_core(obj, state0, mass, n_samples, n_warmup, max_depth, target_accept,
                      max_energy_change, adapt_mass, value_and_grad_fn, 0, 0, mass_freeze,
                      total_warmup)


def nuts_sample_from_state(
    obj,
    state: NUTSState,
    mass=None,
    n_samples: int = 0,
    n_warmup: int = 0,
    max_depth: int = 8,
    target_accept: float = 0.8,
    max_energy_change: float = 1000.0,
    adapt_mass=True,
    value_and_grad_fn: Optional[Callable] = None,
) -> NUTSResult:
    """Continue a `nuts_sample` run from its saved state; the chunking
    contract of `chees_sample_from_state` (config args re-passed, phases
    monotone, warmup plan pinned by the first call). The phase counters
    are read once, counted in ``nuts_sample.host_syncs``."""
    state = as_device_state(state)
    i_warm0, i_samp0, n_total, mass_freeze = _read_counters(
        nuts_sample, state.i_warm, state.i_samp, state.n_warmup_total, state.mass_freeze)
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
    chains = state.x.shape[0]
    adapt_mass = _chees_adapt_mass(adapt_mass, mass, chains)
    _check_resume_mass_mode(adapt_mass, state.var_ema, state.lr_Q)
    return _nuts_core(obj, state, mass, n_samples, n_warmup, max_depth, target_accept,
                      max_energy_change, adapt_mass, value_and_grad_fn, i_warm0, i_samp0,
                      mass_freeze, n_total)


nuts_sample.host_syncs = 0
nuts_sample.gradient_evals = 0


# ---------------------------------------------------------------------------
# Depth-sorted NUTS sub-fleets
# ---------------------------------------------------------------------------

_NUTS_CHAIN_FIELDS = ("x", "f", "g", "log_eps", "log_eps_bar", "h_bar")


class DepthSortInfo(NamedTuple):
    """What `nuts_sample_depth_sorted` decided and why.

    sorted: whether the sub-fleet path ran (False = persistence or spread
        below threshold; the draws are then bitwise-identical to a plain
        `nuts_sample_from_state` run of the same length)
    persistence: leg-to-leg Pearson r of per-chain mean tree depth across
        the two probe legs (nan when the fleet has no depth spread)
    depth_spread: max - min per-chain mean depth on the second probe leg
    group_sizes: chains per sub-fleet (empty when not sorted)
    group_mean_depths: mean tree depth per sub-fleet over the main leg
    """

    sorted: bool
    persistence: float
    depth_spread: float
    group_sizes: tuple
    group_mean_depths: tuple


def _nuts_take_chains(state: NUTSState, idx: torch.Tensor) -> NUTSState:
    """Sub-fleet view of a NUTS state: per-chain fields gathered at
    ``idx`` (an index tensor on the chains' device); the fleet-shared
    fields (mass EMA, DA clock, key, phase counters) ride along
    unchanged."""
    out = state._replace(
        **{k: torch.index_select(getattr(state, k), 0, idx) for k in _NUTS_CHAIN_FIELDS})
    if state.warm_dsum is not None:
        out = out._replace(warm_dsum=torch.index_select(state.warm_dsum, 1, idx))
    return out


def _host_float64(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as float64 numpy: one read, counted in
    ``nuts_sample.host_syncs``."""
    nuts_sample.host_syncs += 1
    return t.detach().cpu().numpy().astype(np.float64)


def nuts_sample_depth_sorted(
    obj,
    state: NUTSState,
    n_samples: int,
    mass=None,
    groups: int = 4,
    probe_draws: int = 16,
    min_persistence: float = 0.5,
    min_depth_spread: float = 0.25,
    max_depth: int = 8,
    target_accept: float = 0.8,
    max_energy_change: float = 1000.0,
    adapt_mass=True,
    value_and_grad_fn: Optional[Callable] = None,
):
    """Post-warmup NUTS sampling with depth-homogeneous sub-fleets.

    Lockstep NUTS charges every chain the fleet-max tree work per draw.
    When per-chain tree depth is recurringly predictable — chains in
    tighter regions of the target keep needing deeper trees — sorting
    chains by recent mean depth into ``groups`` sub-fleets cuts
    sum(group_size x group_max_work) below fleet_size x fleet_max_work.
    On a depth-homogeneous target the split only adds dispatch cost, which
    is why this entry point probes first and only sorts when the geometry
    can pay.

    Probe data: the NUTS warmup records per-chain tree-depth telemetry
    over the plan's two tail windows (``NUTSState.warm_dsum``), so by
    default no probe draws are spent. States without it
    (``warm_dsum=None``) fall back to two full-fleet probe legs of
    ``probe_draws`` each (real post-warmup draws, counted toward
    ``n_samples``). Either way, two per-chain mean-depth vectors d1/d2 are
    measured on the host in float64; if their across-chain Pearson r
    reaches ``min_persistence`` and the depth spread reaches
    ``min_depth_spread`` doublings, chains sort (stably) into ``groups``
    contiguous depth classes and the remaining draws run per sub-fleet,
    scattered back to the original chain order on the device.

    Noise: sub-fleets must not share the parent's streams (chains at the
    same position would draw identical momenta), so sub-fleet g samples
    under `_subfleet_key` (key, g); the sorted path is distributionally
    equivalent to the unsorted run, not bitwise-identical. The fallback
    path is bitwise-identical to a plain `nuts_sample_from_state` run of
    the same length.

    Returns ``(NUTSResult, DepthSortInfo)``. The result's ``state`` is
    merged back to the original chain order under the parent key and
    resumes through any NUTS entry point. Requires a completed warmup plan
    (mass and DA schedules are fleet-shared and frozen). Every read (the
    counters, the telemetry or the probe legs' depths, the groups' mean
    depths) is counted in ``nuts_sample.host_syncs``.
    """
    state = as_device_state(state)
    i_warm, n_total = _read_counters(nuts_sample, state.i_warm, state.n_warmup_total)
    if i_warm < n_total:
        raise ValueError(
            "nuts_sample_depth_sorted requires a completed warmup plan "
            f"(state has {i_warm} of "
            f"{n_total} steps); finish warmup via "
            "nuts_sample / nuts_sample_from_state first"
        )
    chains = state.x.shape[0]
    device = state.x.device
    if groups < 1:
        raise ValueError(f"groups must be >= 1 (got {groups})")
    if groups > chains:
        raise ValueError(
            f"groups ({groups}) exceeds the chain count ({chains})"
        )
    if n_samples < 0:
        raise ValueError(f"n_samples must be >= 0 (got {n_samples})")

    kw = dict(
        mass=mass, max_depth=max_depth, target_accept=target_accept,
        max_energy_change=max_energy_change, adapt_mass=adapt_mass,
        value_and_grad_fn=value_and_grad_fn,
    )

    def plain(st, n):
        return nuts_sample_from_state(obj, st, n_samples=n, **kw)

    wds = None if state.warm_dsum is None else state.warm_dsum.double()
    wds_host = None if wds is None else _host_float64(wds)
    have_telemetry = wds_host is not None and bool(wds_host[1].sum() > 0)
    if groups == 1 or n_samples <= 0 or (
        not have_telemetry and (probe_draws <= 0 or n_samples <= 2 * probe_draws)
    ):
        res = plain(state, n_samples)
        info = DepthSortInfo(
            sorted=False, persistence=float("nan"),
            depth_spread=float("nan"), group_sizes=(),
            group_mean_depths=(),
        )
        return res, info

    if have_telemetry:
        # free probe data from the warmup's tail windows
        _w1s, _w2s, _w2e, W = _warm_depth_windows(n_total)
        d1, d2 = wds_host[0] / W, wds_host[1] / W
        d2_dev = wds[1] / W
        pre = []  # no probe legs spent
        st = state
        remaining = n_samples
    else:
        p1 = plain(state, probe_draws)
        p2 = plain(p1.state, probe_draws)
        d2_dev = p2.mean_tree_depth.double()
        d1, d2 = _host_float64(torch.stack([p1.mean_tree_depth, p2.mean_tree_depth]))
        pre = [(probe_draws, p1), (probe_draws, p2)]
        st = p2.state
        remaining = n_samples - 2 * probe_draws

    spread = float(d2.max() - d2.min())
    if d1.std() > 0.0 and d2.std() > 0.0:
        persistence = float(np.corrcoef(d1, d2)[0, 1])
    else:
        persistence = float("nan")

    def merge_legs(legs):
        """Concatenate (n_draws, result) legs in original chain order."""
        tot = sum(w for w, _ in legs)
        return legs[-1][1]._replace(
            samples=torch.cat([r.samples for _, r in legs]),
            accept_prob=sum(w * r.accept_prob for w, r in legs) / tot,
            mean_tree_depth=sum(w * r.mean_tree_depth for w, r in legs) / tot,
            energies=torch.cat([r.energies for _, r in legs]),
            divergences=sum(r.divergences for _, r in legs),
        )

    if not (persistence >= min_persistence and spread >= min_depth_spread):
        # geometry can't pay: run unsorted — with telemetry this is one
        # plain call; with probe legs, the chunking identity makes legs +
        # tail one plain run of n_samples
        tail = plain(st, remaining)
        res = merge_legs(pre + [(remaining, tail)])
        info = DepthSortInfo(
            sorted=False, persistence=persistence, depth_spread=spread,
            group_sizes=(), group_mean_depths=(),
        )
        return res, info

    # numpy's stable argsort and array_split of d2, on the device from the
    # same float64 values (a stable sort is one permutation), so that no
    # index table is copied to the card
    order = torch.argsort(d2_dev, stable=True)
    sizes = [len(a) for a in np.array_split(np.arange(chains), groups)]
    sub_results = []
    for gi, idx in enumerate(torch.split(order, sizes)):
        sub = _nuts_take_chains(st, idx)
        sub = sub._replace(key=_subfleet_key(st.key, gi))
        sub_results.append(plain(sub, remaining))

    inv = torch.empty_like(order).scatter_(0, order, torch.arange(chains, device=device))

    def scatter(parts, axis):
        return torch.index_select(torch.cat(parts, dim=axis), axis, inv)

    samples_main = scatter([r.samples for r in sub_results], 1)
    acc_main = scatter([r.accept_prob for r in sub_results], 0)
    dep_main = scatter([r.mean_tree_depth for r in sub_results], 0)
    final_x = scatter([r.final_x for r in sub_results], 0)
    energies = torch.cat([r.energies for _, r in pre]
                         + [scatter([r.energies for r in sub_results], 1)])
    divergences = sum(r.divergences for _, r in pre) + scatter(
        [r.divergences for r in sub_results], 0)
    samples = torch.cat([r.samples for _, r in pre] + [samples_main])
    acc = (sum(w * r.accept_prob for w, r in pre) + remaining * acc_main) / n_samples
    dep = (sum(w * r.mean_tree_depth for w, r in pre) + remaining * dep_main) / n_samples

    first = sub_results[0].state
    merged = st._replace(
        key=st.key,  # the parent's; the groups sampled under _subfleet_key
        i_samp=first.i_samp,
        t_da=first.t_da,
        var_ema=first.var_ema,
        **{k: scatter([getattr(r.state, k) for r in sub_results], 0)
           for k in _NUTS_CHAIN_FIELDS},
    )
    if st.warm_dsum is not None:
        merged = merged._replace(warm_dsum=scatter([r.state.warm_dsum for r in sub_results], 1))
    res = NUTSResult(
        samples=samples,
        accept_prob=acc,
        step_size=scatter([r.step_size for r in sub_results], 0),
        mean_tree_depth=dep,
        mass_diag=sub_results[0].mass_diag,
        energies=energies,
        divergences=divergences,
        final_x=final_x,
        state=merged,
    )
    nuts_sample.host_syncs += 1
    group_depths = torch.stack([torch.mean(r.mean_tree_depth) for r in sub_results]).tolist()
    info = DepthSortInfo(
        sorted=True, persistence=persistence, depth_spread=spread,
        group_sizes=tuple(sizes),
        group_mean_depths=tuple(group_depths),
    )
    return res, info
