"""Gaussian-mixture fixture — the PyTorch port of
``quasinewtonmethods_jl_tpu/models/mixture.py``.

The multimodal target: its known answers are the mode locations and
weights and the exact mixture moments (reference test/runtests.jl:4-33's
strategy of analytic fixtures). A BFGS fleet started across the space
climbs into the modes, each lane into the basin it starts in.
"""

from __future__ import annotations

import torch

from .logistic import _tensor

__all__ = ["GaussianMixture"]


class GaussianMixture:
    """Isotropic K-component Gaussian mixture log-density (MAXIMIZED form,
    like every objective in this framework).

    logdensity(x) = logsumexp_k [ log w_k − ‖x − mu_k‖² / (2 sigma_k²)
                                  − n·log(sigma_k) ]  (+ const dropped)

    ``means``: (K, n); ``weights``: (K,), normalized (uniform when None);
    ``sigmas``: scalar or (K,). The tensors keep the means' dtype (or
    ``dtype``) on ``device`` and follow the point the model is evaluated
    at (device and dtype).

    Exact moments: mean = Σ w_k mu_k, cov = Σ w_k (sigma_k² I + mu_k mu_kᵀ)
    − mean meanᵀ (`mean`, `cov`); `mode_weights` soft-assigns draws to the
    nearest mode.
    """

    def __init__(self, means, weights=None, sigmas=1.0, dtype=None, device=None):
        means = _tensor(means, dtype, device)  # dtype None keeps the means' own
        if means.ndim != 2:
            raise ValueError("means must be (K, n)")
        K, n = means.shape
        if weights is None:
            weights = torch.full((K,), 1.0 / K, dtype=means.dtype, device=means.device)
        weights = _tensor(weights, means.dtype, means.device)
        weights = weights / torch.sum(weights)
        sigmas = torch.broadcast_to(_tensor(sigmas, means.dtype, means.device), (K,))
        self.means = means
        self.weights = weights
        self.sigmas = sigmas.contiguous()
        self.dimension = n

    def __len__(self):
        return self.dimension

    def _on(self, x):
        """means, weights and sigmas on x's device and in its dtype."""
        return tuple(t.to(device=x.device, dtype=x.dtype)
                     for t in (self.means, self.weights, self.sigmas))

    def logdensity(self, x):
        means, weights, sigmas = self._on(x)
        d2 = torch.sum((x[None, :] - means) ** 2, dim=1)  # (K,)
        comp = (
            torch.log(weights)
            - 0.5 * d2 / sigmas**2
            - self.dimension * torch.log(sigmas)
        )
        return torch.logsumexp(comp, dim=0)

    __call__ = logdensity

    def mean(self):
        return self.weights @ self.means

    def cov(self):
        m = self.mean()
        second = torch.einsum(
            "k,kn,km->nm", self.weights, self.means, self.means
        ) + torch.sum(self.weights * self.sigmas**2) * torch.eye(
            self.dimension, dtype=self.means.dtype, device=self.means.device
        )
        return second - torch.outer(m, m)

    def mode_weights(self, draws):
        """Empirical mode masses: the fraction of ``draws`` (..., n) nearest
        (Euclidean) to each component mean — the multimodal recovery metric
        (compare to ``weights`` for well-separated modes)."""
        flat = _tensor(draws, self.means.dtype, self.means.device).reshape(-1, self.dimension)
        d2 = torch.sum((flat[:, None, :] - self.means[None, :, :]) ** 2, dim=2)
        idx = torch.argmin(d2, dim=1)
        return torch.bincount(idx, minlength=self.means.shape[0]) / flat.shape[0]
