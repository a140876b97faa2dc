"""PSIS-LOO cross-validation and WAIC: out-of-sample model comparison from
posterior draws — the PyTorch port of ``quasinewtonmethods_jl_tpu/loo.py``.

Leave-one-out predictive density is estimated by importance sampling from
the full-posterior draws (Vehtari, Gelman & Gabry 2017), each
observation's weights Pareto-smoothed by the GPD machinery that
`pathfinder.psis_smooth` uses for its proposal pool, so that the estimate
stays stable where raw weights have infinite variance; the
per-observation Pareto k̂ reports where even that fails (k̂ > 0.7).

Inputs are pointwise log-likelihoods log p(y_i | θ_s) — an (S, N) matrix,
or a callable evaluated here over the draws under ``torch.func.vmap`` —
because only the user's model knows how its density factorizes over
observations. The N observation columns are smoothed in one batched pass
(`pathfinder._psis_smooth_rows` over the transposed matrix), then reduced
by logsumexp; the draws stay on their device and nothing is read from it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from .pathfinder import _psis_smooth_rows
from .utils.device import as_device_tensor

__all__ = ["LOOResult", "WAICResult", "loo_psis", "loo_compare", "waic"]


class LOOResult(NamedTuple):
    """elpd: expected log pointwise predictive density, summed over
    observations (higher = better out-of-sample fit).
    se: standard error of elpd (sqrt(N · var of the pointwise terms)).
    p_loo: effective number of parameters (lpd − elpd; ≈ the true
    parameter count for well-specified regular models — a much larger
    value flags misspecification).
    elpd_pointwise: (N,) per-observation contributions (feed to
    `loo_compare`; inspect alongside khat).
    khat: (N,) per-observation Pareto k̂ diagnostics — k̂ > 0.7 means
    that observation's importance weights are unreliable (typically an
    influential/outlying point); -inf means the weights were
    near-uniform and needed no smoothing.
    """

    elpd: torch.Tensor
    se: torch.Tensor
    p_loo: torch.Tensor
    elpd_pointwise: torch.Tensor
    khat: torch.Tensor


class WAICResult(NamedTuple):
    """elpd: WAIC expected log pointwise predictive density (higher =
    better). se: its standard error. p_waic: effective parameter count
    (sum of per-observation log-likelihood variances over draws).
    elpd_pointwise: (N,) per-observation terms (feeds `loo_compare` —
    it only reads `.elpd_pointwise`, so LOO and WAIC results mix)."""

    elpd: torch.Tensor
    se: torch.Tensor
    p_waic: torch.Tensor
    elpd_pointwise: torch.Tensor


def _se(pointwise, like):
    """sqrt(N · var(pointwise, ddof=1)), 0 for one observation."""
    n = pointwise.shape[0]
    if n > 1:
        return torch.sqrt(n * torch.var(pointwise, correction=1))
    return torch.zeros_like(like)


def _lpd(ll):
    """log mean_s p(y_i | θ_s), per observation."""
    return torch.logsumexp(ll, dim=0) - torch.log(
        torch.full((), ll.shape[0], dtype=ll.dtype, device=ll.device))


def _loo_core(ll):
    # raw LOO importance log-weights per observation: w_s ∝ 1/p(y_i|θ_s)
    smooth, khat = _psis_smooth_rows(-ll.T)  # (N, S), (N,)
    smooth = smooth.T
    logw_norm = smooth - torch.logsumexp(smooth, dim=0, keepdim=True)
    elpd_i = torch.logsumexp(logw_norm + ll, dim=0)  # (N,)
    elpd = torch.sum(elpd_i)
    return LOOResult(elpd=elpd, se=_se(elpd_i, elpd), p_loo=torch.sum(_lpd(ll) - elpd_i),
                     elpd_pointwise=elpd_i, khat=khat)


def _waic_core(ll):
    p_i = torch.var(ll, dim=0, correction=1)
    elpd_i = _lpd(ll) - p_i
    elpd = torch.sum(elpd_i)
    return WAICResult(elpd=elpd, se=_se(elpd_i, elpd), p_waic=torch.sum(p_i),
                      elpd_pointwise=elpd_i)


def _pointwise_loglik(loglik, draws) -> torch.Tensor:
    """The (S, N) matrix of `loo_psis` / `waic`'s input, its shape checked."""
    if callable(loglik):
        if draws is None:
            raise ValueError("a callable loglik needs draws= (posterior samples)")
        x = as_device_tensor(draws, "draws")
        if x.ndim == 3:
            x = x.reshape(-1, x.shape[-1])
        if x.ndim != 2:
            raise ValueError(
                f"draws must be (S, n) or (n_samples, chains, n), got {tuple(x.shape)}"
            )
        ll = torch.func.vmap(loglik)(x)
    else:
        ll = as_device_tensor(loglik, "loglik")
    if ll.ndim != 2:
        raise ValueError(
            f"pointwise log-likelihood must be (S draws, N obs), got {tuple(ll.shape)}"
        )
    return ll


def loo_psis(
    loglik: Union[torch.Tensor, Callable],
    draws: Optional[torch.Tensor] = None,
) -> LOOResult:
    """Pareto-smoothed importance-sampling LOO (Vehtari et al. 2017).

    ``loglik``: an (S, N) pointwise log-likelihood matrix — S posterior
    draws × N observations, log p(y_i | θ_s) — or a callable
    ``theta -> (N,) pointwise log-likelihood`` evaluated here over
    ``draws`` ((S, n) or the samplers' (n_samples, chains, n), flattened)
    under one ``torch.func.vmap``. A tensor keeps its device and dtype;
    other input goes to the card (`utils.device.as_device_tensor`).

    Returns `LOOResult`; compare fitted models on the same data with
    `loo_compare` (never by raw elpd alone — the pointwise pairing is what
    gives the difference its standard error). Check `khat`: any
    observation above 0.7 makes its contribution unreliable.
    """
    ll = _pointwise_loglik(loglik, draws)
    if ll.shape[0] < 8:
        raise ValueError("need at least 8 draws for PSIS-LOO")
    return _loo_core(ll)


def waic(
    loglik: Union[torch.Tensor, Callable],
    draws: Optional[torch.Tensor] = None,
) -> WAICResult:
    """Widely applicable information criterion (Watanabe 2010; the Gelman
    et al. 2014 elpd formulation). Same inputs as `loo_psis`; pure
    reductions, no importance weights — cheaper but less robust than
    PSIS-LOO (its variance-based penalty understates under strong
    influence, and there is no per-observation reliability diagnostic), so
    prefer `loo_psis` and use WAIC as its cross-check."""
    ll = _pointwise_loglik(loglik, draws)
    if ll.shape[0] < 2:
        raise ValueError("need at least 2 draws for WAIC")
    return _waic_core(ll)


def loo_compare(a: LOOResult, b: LOOResult) -> tuple:
    """Paired model comparison: returns ``(elpd_diff, se_diff)`` where
    ``elpd_diff = a.elpd − b.elpd`` (> 0 favors model a) and ``se_diff``
    is the standard error OF THE DIFFERENCE, computed from the paired
    pointwise terms (pointwise elpds on the same data are strongly
    correlated across models, so this is far smaller than combining the
    marginal SEs). |elpd_diff| ≲ 2·se_diff means the data cannot
    distinguish the models."""
    da = a.elpd_pointwise
    db = b.elpd_pointwise
    if da.shape != db.shape:
        raise ValueError(
            f"models were evaluated on different observation sets: "
            f"{tuple(da.shape)} vs {tuple(db.shape)}"
        )
    d = da - db
    return torch.sum(d), _se(d, a.elpd)
