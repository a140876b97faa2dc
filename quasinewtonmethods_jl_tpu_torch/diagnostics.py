"""MCMC convergence diagnostics — split R-hat and effective sample size —
the PyTorch port of ``quasinewtonmethods_jl_tpu/diagnostics.py``.

Given (draws, chains, n) samples, the two numbers every HMC user needs
before trusting them: the split-chain potential scale reduction factor
(R-hat, Gelman & Rubin in the split form of Vehtari et al. 2021) and the
autocorrelation-aware effective sample size (Geyer's initial monotone
sequence, the Stan formulation), with the rank-normalized and tail
variants and the posterior summary table.

Two implementations, one contract:

  * `split_rhat` / `ess` / `diagnose_chains` / ... — host-side numpy, the
    port's own copy of the JAX package's numpy code: the readable oracle.
  * `split_rhat_device` / `ess_device` / `diagnose_chains_device` / ... —
    the same math as torch ops on the samples' device: an rFFT on the
    draws axis for the autocovariance, ``torch.cummin`` for Geyer's
    monotone envelope, a cumulative product of the positive-pair mask for
    the truncation, stable sorts for the ranks (JAX's sort is stable,
    torch's default is not: tied draws would rank differently) and
    ``torch.special.ndtri`` for the normal quantiles. Only (n,)-sized
    results come out. Numpy input follows the entry points' device rule
    (`as_device_tensor`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .utils.device import as_device_tensor

__all__ = [
    "ChainDiagnostics",
    "split_rhat",
    "ess",
    "rank_normalized_rhat",
    "tail_ess",
    "diagnose_chains",
    "energy_bfmi",
    "PosteriorSummary",
    "posterior_summary",
    "split_rhat_device",
    "ess_device",
    "rank_normalized_rhat_device",
    "tail_ess_device",
    "diagnose_chains_device",
    "energy_bfmi_device",
]


class ChainDiagnostics(NamedTuple):
    """Per-dimension convergence summary for a batch of chains.

    rhat: (n,) split-chain R-hat (want < 1.01)
    ess: (n,) bulk effective sample size (out of draws * chains)
    mean/std: (n,) pooled posterior moment estimates
    rhat_rank: (n,) rank-normalized R-hat — max of the bulk
    (rank-normalized) and folded (|x − median| rank-normalized) split
    R-hats (Vehtari et al. 2021). Catches chain-VARIANCE mismatch the
    mean-based `rhat` is structurally blind to. None when not computed
    (`rank=False`).
    ess_tail: (n,) tail ESS — min over the 5%/95% quantile-indicator
    ESSs; ≪ `ess` means the chains mix in the bulk but not the tails
    (credible-interval endpoints are then untrustworthy). None when not
    computed.
    """

    rhat: np.ndarray
    ess: np.ndarray
    mean: np.ndarray
    std: np.ndarray
    rhat_rank: object = None
    ess_tail: object = None


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(draws, chains, n) -> (draws//2, 2*chains, n): each chain split in
    half, so a chain drifting between halves shows up as between-chain
    variance (the 'split' in split R-hat)."""
    d = (x.shape[0] // 2) * 2
    first, second = x[: d // 2], x[d // 2 : d]
    return np.concatenate([first, second], axis=1)


def split_rhat(samples) -> np.ndarray:
    """Split-chain R-hat per dimension.

    samples: (draws, chains, n) array (as returned by the samplers).
    Returns (n,) — values near 1 indicate the chains agree; > 1.01 means
    keep sampling (Vehtari et al. 2021 threshold)."""
    x = _split_chains(np.asarray(samples, np.float64))
    n_draw, n_chain, _ = x.shape
    if n_draw < 2:
        raise ValueError("need at least 4 draws for split R-hat")
    chain_mean = x.mean(axis=0)  # (chains, n)
    chain_var = x.var(axis=0, ddof=1)  # (chains, n)
    w = chain_var.mean(axis=0)  # within
    b = n_draw * chain_mean.var(axis=0, ddof=1)  # between
    var_plus = (n_draw - 1) / n_draw * w + b / n_draw
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.sqrt(var_plus / w)
    # a dimension the chains never move in (w == 0) is perfectly mixed
    return np.where(w > 0, out, 1.0)


def _chain_autocov(x: np.ndarray) -> np.ndarray:
    """Biased (1/N) autocovariance per (chain, dim) via FFT.
    x: (draws, chains, n) -> (draws, chains, n)."""
    n_draw = x.shape[0]
    xc = x - x.mean(axis=0, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n_draw)))
    f = np.fft.rfft(xc, n=size, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=size, axis=0)[:n_draw]
    return acov.real / n_draw


def ess(samples) -> np.ndarray:
    """Bulk effective sample size per dimension (Geyer initial monotone
    sequence over the multi-chain autocorrelation, as in Stan).

    samples: (draws, chains, n). Returns (n,) — iid draws give
    ~draws*chains; sticky chains give much less."""
    x = _split_chains(np.asarray(samples, np.float64))
    n_draw, n_chain, n_dim = x.shape
    if n_draw < 4:
        raise ValueError("need at least 8 draws for ess")
    acov = _chain_autocov(x)  # (draws, chains, n)
    chain_var = acov[0] * n_draw / (n_draw - 1.0)  # (chains, n)
    w = chain_var.mean(axis=0)
    var_plus = (n_draw - 1) / n_draw * w + n_draw * x.mean(axis=0).var(
        axis=0, ddof=1
    ) / n_draw
    var_plus = np.where(var_plus > 0, var_plus, 1.0)

    # rho_t = 1 - (W - mean_chain_acov_t) / var_plus     (Stan eq.)
    rho = 1.0 - (w[None, :] - acov.mean(axis=1)) / var_plus[None, :]
    rho[0] = 1.0

    # Geyer: sum consecutive pairs while positive, enforce monotone decay
    n_pair = n_draw // 2
    pair = rho[0 : 2 * n_pair : 2] + rho[1 : 2 * n_pair : 2]  # (n_pair, n)
    # monotone decreasing envelope
    pair = np.minimum.accumulate(pair, axis=0)
    # truncate at the first non-positive pair (exclusive)
    positive = pair > 0.0
    first_bad = np.where(
        positive.all(axis=0), n_pair, positive.argmin(axis=0)
    )  # (n,)
    mask = np.arange(n_pair)[:, None] < first_bad[None, :]
    tau = -1.0 + 2.0 * np.sum(pair * mask, axis=0)  # sum includes rho_0 pair
    tau = np.maximum(tau, 1.0 / np.log10(n_draw * n_chain + 10.0))
    return n_draw * n_chain / tau


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Pooled rank-normalization per dimension (Vehtari et al. 2021):
    ordinal ranks over ALL draws × chains, mapped through the normal
    quantile function with the Blom offset z = Φ⁻¹((r − 3/8)/(S + 1/4)).
    x: (draws, chains, n) -> same shape, now standard-normal-ish
    regardless of the target's tails (this is what makes rank R-hat and
    its folded variant robust to heavy tails / infinite variance)."""
    from scipy.special import ndtri

    d, c, n = x.shape
    flat = x.reshape(d * c, n)
    # double argsort = ordinal ranks (draws are continuous; ties
    # measure-zero), 1-based
    r = np.argsort(np.argsort(flat, axis=0), axis=0) + 1.0
    z = ndtri((r - 0.375) / (d * c + 0.25))
    return z.reshape(d, c, n)


def rank_normalized_rhat(samples) -> np.ndarray:
    """Rank-normalized split R-hat per dimension: the max of the bulk
    statistic (split R-hat of the rank-normalized draws) and the FOLDED
    statistic (same, on |x − median|, which measures scale/tail
    disagreement between chains). This is the R-hat modern Stan reports:
    a chain stuck at the right mean but the wrong variance passes the
    classic `split_rhat` (between-chain variance of MEANS is zero) and
    fails here. Want < 1.01."""
    x = np.asarray(samples, np.float64)
    bulk = split_rhat(_rank_normalize(x))
    folded = split_rhat(
        _rank_normalize(np.abs(x - np.median(x, axis=(0, 1))))
    )
    # ordinal ranks of an all-tied (constant) dimension would fabricate a
    # drift pattern; a dimension the chains never move in is perfectly
    # mixed (same contract as split_rhat's w == 0 guard)
    const = x.max(axis=(0, 1)) == x.min(axis=(0, 1))
    return np.where(const, 1.0, np.maximum(bulk, folded))


def tail_ess(samples) -> np.ndarray:
    """Tail effective sample size per dimension: the min of the Geyer
    ESSs of the 5%- and 95%-quantile indicator sequences I(x ≤ q)
    (Vehtari et al. 2021). Bulk `ess` can look healthy while the chains
    rarely exchange tail visits — this is the number that certifies
    credible-interval ENDPOINTS."""
    x = np.asarray(samples, np.float64)
    q05, q95 = np.quantile(x, [0.05, 0.95], axis=(0, 1))  # (n,) each
    e05 = ess((x <= q05).astype(np.float64))
    e95 = ess((x <= q95).astype(np.float64))
    return np.minimum(e05, e95)


def diagnose_chains(samples, rank: bool = True) -> ChainDiagnostics:
    """One-call summary: split R-hat, bulk ESS, pooled mean/std — and,
    with ``rank=True`` (default), the rank-normalized/folded R-hat and
    tail ESS (Vehtari et al. 2021) that catch variance mismatch and
    tail stickiness the classic pair can't."""
    x = np.asarray(samples, np.float64)
    pooled = x.reshape(-1, x.shape[-1])
    return ChainDiagnostics(
        rhat=split_rhat(x),
        ess=ess(x),
        mean=pooled.mean(axis=0),
        std=pooled.std(axis=0, ddof=1),
        rhat_rank=rank_normalized_rhat(x) if rank else None,
        ess_tail=tail_ess(x) if rank else None,
    )


# ---------------------------------------------------------------------------
# On the device: the same math as torch ops on the samples' device. The
# split/center/variance steps are shared; f32 draws are accumulated in f32
# after centering.
# ---------------------------------------------------------------------------


def _samples(samples) -> torch.Tensor:
    return as_device_tensor(samples, "samples")


def _split_chains_t(x: torch.Tensor) -> torch.Tensor:
    d = (x.shape[0] // 2) * 2
    return torch.cat([x[: d // 2], x[d // 2 : d]], dim=1)


def _split_rhat_t(samples: torch.Tensor) -> torch.Tensor:
    if samples.shape[0] < 4:
        raise ValueError("need at least 4 draws for split R-hat")
    x = _split_chains_t(samples)
    n_draw = x.shape[0]
    chain_mean = torch.mean(x, dim=0)  # (chains, n)
    chain_var = torch.var(x, dim=0, correction=1)
    w = torch.mean(chain_var, dim=0)
    b = n_draw * torch.var(chain_mean, dim=0, correction=1)
    var_plus = (n_draw - 1) / n_draw * w + b / n_draw
    out = torch.sqrt(var_plus / w)
    return torch.where(w > 0, out, torch.ones_like(out))


def split_rhat_device(samples) -> torch.Tensor:
    """`split_rhat` in torch ops on the samples' device.

    samples: (draws, chains, n) tensor; returns an (n,) tensor on the same
    device — nothing else leaves it."""
    return _split_rhat_t(_samples(samples))


def _chain_autocov_t(x: torch.Tensor) -> torch.Tensor:
    """Biased (1/N) autocovariance per (chain, dim) by a batched rFFT on
    the draws axis. x: (draws, chains, n) -> (draws, chains, n)."""
    n_draw = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True)
    size = 2 ** int(np.ceil(np.log2(2 * n_draw)))
    f = torch.fft.rfft(xc, n=size, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=size, dim=0)[:n_draw]
    return acov.to(x.dtype) / n_draw


def _ess_t(samples: torch.Tensor) -> torch.Tensor:
    if samples.shape[0] < 8:
        raise ValueError("need at least 8 draws for ess")
    x = _split_chains_t(samples)
    n_draw, n_chain, _ = x.shape
    acov = _chain_autocov_t(x)  # (draws, chains, n)
    chain_var = acov[0] * n_draw / (n_draw - 1.0)
    w = torch.mean(chain_var, dim=0)
    var_plus = (n_draw - 1) / n_draw * w + n_draw * torch.var(
        torch.mean(x, dim=0), dim=0, correction=1
    ) / n_draw
    var_plus = torch.where(var_plus > 0, var_plus, torch.ones_like(var_plus))

    rho = 1.0 - (w[None, :] - torch.mean(acov, dim=1)) / var_plus[None, :]
    rho = torch.cat([torch.ones_like(rho[:1]), rho[1:]], dim=0)

    n_pair = n_draw // 2
    pair = rho[0 : 2 * n_pair : 2] + rho[1 : 2 * n_pair : 2]  # (n_pair, n)
    pair = torch.cummin(pair, dim=0).values
    # mask[t] = every pair up to and including t is positive (a cumulative
    # AND, JAX's associative_scan of logical_and)
    mask = torch.cumprod((pair > 0.0).to(torch.int32), dim=0).to(torch.bool)
    tau = -1.0 + 2.0 * torch.sum(torch.where(mask, pair, torch.zeros_like(pair)), dim=0)
    tau = torch.clamp_min(tau, 1.0 / math.log10(n_draw * n_chain + 10.0))
    return n_draw * n_chain / tau


def ess_device(samples) -> torch.Tensor:
    """`ess` in torch ops on the samples' device: the batched-FFT
    autocovariance, the Stan rho formula, and Geyer's initial monotone
    sequence by ``torch.cummin`` (the envelope) and a cumulative-AND mask
    (truncation at the first non-positive pair). Returns an (n,) tensor."""
    return _ess_t(_samples(samples))


def _rank_normalize_t(x: torch.Tensor) -> torch.Tensor:
    """`_rank_normalize` on the device: two stable sorts and the normal
    quantile map, in float64 (the JAX package's x64 arithmetic), the result
    in the samples' dtype."""
    d, c, n = x.shape
    flat = x.reshape(d * c, n)
    order = torch.argsort(flat, dim=0, stable=True)
    r = torch.argsort(order, dim=0, stable=True).to(torch.float64) + 1.0
    z = torch.special.ndtri((r - 0.375) / (d * c + 0.25)).to(x.dtype)
    return z.reshape(d, c, n)


def _quantile_t(pooled: torch.Tensor, q: float, midpoint: bool = False) -> torch.Tensor:
    """``jnp.quantile(pooled, q, axis=0)`` (linear interpolation, or with
    ``midpoint`` ``jnp.median``'s rule) from one sort, NaN in any column
    that holds one, with no size limit (``torch.quantile`` refuses more
    than 2^24 elements)."""
    s = torch.sort(pooled, dim=0).values
    pos = q * (s.shape[0] - 1)
    lo, hi = s[math.floor(pos)], s[math.ceil(pos)]
    if midpoint:
        out = (lo + hi) * 0.5
    else:
        w_hi = pos - math.floor(pos)
        out = lo * (1.0 - w_hi) + hi * w_hi
    return torch.where(torch.isnan(pooled).any(dim=0), torch.full_like(out, float("nan")), out)


def rank_normalized_rhat_device(samples) -> torch.Tensor:
    """`rank_normalized_rhat` in torch ops on the samples' device (two
    pooled sorts per statistic are its only non-elementwise ops)."""
    samples = _samples(samples)
    pooled = samples.reshape(-1, samples.shape[-1])
    pooled_med = _quantile_t(pooled, 0.5, midpoint=True)
    bulk = _split_rhat_t(_rank_normalize_t(samples))
    folded = _split_rhat_t(_rank_normalize_t(torch.abs(samples - pooled_med)))
    # an all-tied (constant) dimension: ordinal ranks would fabricate drift
    const = torch.amax(pooled, dim=0) == torch.amin(pooled, dim=0)
    return torch.where(const, torch.ones_like(bulk), torch.maximum(bulk, folded))


def tail_ess_device(samples) -> torch.Tensor:
    """`tail_ess` in torch ops on the samples' device: two pooled
    quantiles and the Geyer ESS of the two indicator sequences."""
    samples = _samples(samples)
    pooled = samples.reshape(-1, samples.shape[-1])
    if pooled.dtype == torch.bfloat16:
        pooled = pooled.float()
    e05 = _ess_t((samples <= _quantile_t(pooled, 0.05)).to(samples.dtype))
    e95 = _ess_t((samples <= _quantile_t(pooled, 0.95)).to(samples.dtype))
    return torch.minimum(e05, e95)


def diagnose_chains_device(samples, rank: bool = False) -> ChainDiagnostics:
    """`diagnose_chains` computed on the device: (n,)-sized tensors, to be
    fetched whenever convenient (or never).

    ``rank=False`` by default (unlike the host oracle), as in the JAX
    package, whose chain-sharded pipeline keeps the pooled sorts opt-in;
    pass ``rank=True`` for the full Vehtari et al. 2021 panel."""
    samples = _samples(samples)
    pooled = samples.reshape(-1, samples.shape[-1])
    return ChainDiagnostics(
        rhat=split_rhat_device(samples),
        ess=ess_device(samples),
        mean=torch.mean(pooled, dim=0),
        std=torch.std(pooled, dim=0, correction=1),
        rhat_rank=rank_normalized_rhat_device(samples) if rank else None,
        ess_tail=tail_ess_device(samples) if rank else None,
    )


def energy_bfmi(energies) -> np.ndarray:
    """Per-chain E-BFMI, the Bayesian fraction of missing information of
    the Hamiltonian transition (Betancourt 2016, "Diagnosing suboptimal
    cotangent disintegrations"; Stan's ``E-BFMI`` check):

        E-BFMI_c = sum_t (E_t - E_{t-1})^2 / sum_t (E_t - E_bar)^2

    where E_t are the per-draw Hamiltonians that `hmc_sample` /
    `chees_sample` / `nuts_sample` return as ``result.energies``
    ((draws, chains)). It compares how far momentum refreshment moves the
    energy (numerator) against the marginal energy spread the chain must
    traverse (denominator): values near 2 are an ideally mixing Gaussian
    energy spectrum; **below ~0.3** (Stan's warning bar) the sampler
    random-walks across energy levels — heavy-tailed or funnel-like
    targets — and no amount of extra draws fixes it (reparameterize, or
    hand the geometry a better mass via `chain_init_from_map` /
    ``adapt_mass``).

    Host-side numpy; `energy_bfmi_device` is the on-device twin.
    """
    e = np.asarray(energies, np.float64)
    if e.ndim != 2 or e.shape[0] < 3:
        raise ValueError(
            f"energies must be (draws >= 3, chains), got shape {e.shape}"
        )
    num = np.sum(np.diff(e, axis=0) ** 2, axis=0)
    den = np.sum((e - e.mean(axis=0)) ** 2, axis=0)
    return num / np.maximum(den, np.finfo(np.float64).tiny)


def energy_bfmi_device(energies) -> torch.Tensor:
    """`energy_bfmi` in torch ops on the (draws, chains) energies' device:
    two reductions, nothing fetched."""
    e = as_device_tensor(energies, "energies")
    num = torch.sum(torch.diff(e, dim=0) ** 2, dim=0)
    den = torch.sum((e - torch.mean(e, dim=0)) ** 2, dim=0)
    return num / torch.clamp_min(den, torch.finfo(e.dtype).tiny)


class PosteriorSummary(NamedTuple):
    """The Stan/ArviZ-style per-dimension posterior table — everything a
    practitioner reads off ``print(fit)`` before trusting a run. All
    fields (n,) host numpy; build with `posterior_summary`, render with
    `.table()`.

    mean/sd: pooled posterior moments
    mcse: Monte Carlo standard error of the mean, sd/sqrt(ess_bulk) —
        the "is my posterior mean itself converged?" number
    q5/median/q95: pooled quantiles (the 90% credible interval + center)
    ess_bulk: rank-normalized-bulk-equivalent ESS (Geyer, per
        `diagnose_chains`)
    ess_tail: min of the 5%/95% quantile-indicator ESSs
    rhat: rank-normalized split R-hat (max of bulk and folded — the
        Vehtari et al. 2021 recommendation; want < 1.01)
    """

    mean: np.ndarray
    sd: np.ndarray
    mcse: np.ndarray
    q5: np.ndarray
    median: np.ndarray
    q95: np.ndarray
    ess_bulk: np.ndarray
    ess_tail: np.ndarray
    rhat: np.ndarray

    def table(self, names=None, precision: int = 3) -> str:
        """Render the summary as the fixed-width table every Bayesian
        toolkit prints; ``names`` labels the rows (default x[i])."""
        n = self.mean.shape[0]
        if names is None:
            names = [f"x[{i}]" for i in range(n)]
        elif len(names) != n:
            raise ValueError(
                f"names has {len(names)} entries for {n} dimensions"
            )
        cols = ("mean", "sd", "mcse", "q5", "median", "q95",
                "ess_bulk", "ess_tail", "rhat")
        w = max(9, precision + 6)
        name_w = max(len(str(s)) for s in names) + 1
        out = [" " * name_w + "".join(f"{c:>{w}}" for c in cols)]
        for i in range(n):
            row = f"{str(names[i]):<{name_w}}"
            for c in cols:
                v = float(getattr(self, c if c != "mcse" else "mcse")[i])
                if c in ("ess_bulk", "ess_tail"):
                    row += f"{v:>{w}.0f}"
                elif c == "rhat":
                    row += f"{v:>{w}.3f}"
                else:
                    row += f"{v:>{w}.{precision}g}"
            out.append(row)
        return "\n".join(out)


def posterior_summary(samples) -> PosteriorSummary:
    """One-call posterior report over (draws, chains, n) samples from any
    of the library's samplers: pooled moments and quantiles, the MCSE of
    the mean, bulk/tail ESS, and the rank-normalized split R-hat — the
    numbers `diagnose_chains` computes, arranged as the standard
    publication-ready panel (plus MCSE, which no other entry point
    reports). Host-side numpy (analysis time); print
    ``summary.table(names)`` for the classic fixed-width readout.
    """
    x = np.asarray(samples, np.float64)
    if x.ndim != 3:
        raise ValueError(
            f"samples must be (draws, chains, n), got shape {x.shape}"
        )
    d = diagnose_chains(x, rank=True)
    pooled = x.reshape(-1, x.shape[-1])
    q5, med, q95 = np.percentile(pooled, [5.0, 50.0, 95.0], axis=0)
    ess_bulk = np.maximum(d.ess, 1.0)
    return PosteriorSummary(
        mean=d.mean,
        sd=d.std,
        mcse=d.std / np.sqrt(ess_bulk),
        q5=q5,
        median=med,
        q95=q95,
        ess_bulk=d.ess,
        ess_tail=d.ess_tail,
        rhat=d.rhat_rank,
    )
