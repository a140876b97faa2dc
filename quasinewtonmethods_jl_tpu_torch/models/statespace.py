"""Linear-Gaussian state-space (AR(1)-with-drift) MAP objective — the
PyTorch port of ``quasinewtonmethods_jl_tpu/models/statespace.py``.

The scan-shaped log-density class: estimate the drift vector w of the
latent recursion

    z_t = A z_{t-1} + w,      y_t ~ N(z_t, sigma² I),   z_0 = 0,

by MAP over w with a N(0, prior_scale² I) prior (A, the observations and
sigma are fixed data). The log-posterior is strictly concave in w (the
recursion is linear in w) and has a closed-form optimum by the normal
equations (`map_solution`). JAX traces the recursion to a ``lax.scan``;
here `logdensity` is a Python loop over the steps that carries z in the
scan's order, with the scan body's expression per step.

JAX draws A, w_true and the noise with ``jax.random``, which torch cannot
reproduce: the port's model takes ``A`` (the recursion's matrix, used as
given) and ``ys`` (n_steps, n) as arrays, with ``w_true`` optionally (how
the tests and `chip_smoke.py` carry one dataset to both packages), and
otherwise draws them by JAX's recipe from a ``torch.Generator`` seeded with
``seed``, on the CPU: A = N(0, 1) scaled on the host in numpy to the
requested spectral radius (general eig, as in JAX), w_true = N(0, 1), the
recursion simulated from z_0 = 0, ys = z + obs_scale·N(0, 1). The model's
tensors follow the point it is evaluated at (device and dtype).
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import ProbabilityModel
from .logistic import _tensor

__all__ = ["AR1DriftMAP"]


class AR1DriftMAP(ProbabilityModel):
    """AR(1)-with-drift posterior over the drift w, its data ``A`` (n, n)
    and ``ys`` (n_steps, n) kept on ``device`` in ``dtype``."""

    def __init__(self, dimension: int = 8, n_steps: int = 32, spectral_radius: float = 0.6,
                 obs_scale: float = 0.5, prior_scale: float = 10.0, seed: int = 0,
                 dtype=torch.float64, device=None, A=None, ys=None, w_true=None):
        super().__init__(dimension)
        n = dimension
        if (A is None) != (ys is None):
            raise ValueError("pass both A and ys, or neither")
        if A is None:
            gen = torch.Generator().manual_seed(seed)
            A = torch.randn(n, n, generator=gen, dtype=dtype)
            eig = float(np.max(np.abs(np.linalg.eigvals(A.numpy().astype(np.float64)))))
            A = A * torch.tensor(spectral_radius / eig, dtype=dtype)
            w_true = torch.randn(n, generator=gen, dtype=dtype)
            z = torch.zeros(n, dtype=dtype)
            zs = []
            for _ in range(n_steps):
                z = A @ z + w_true
                zs.append(z)
            noise = obs_scale * torch.randn(n_steps, n, generator=gen, dtype=dtype)
            ys = torch.stack(zs) + noise
        self.A = _tensor(A, dtype, device)
        self.ys = _tensor(ys, dtype, device)
        if self.A.shape != (n, n) or self.ys.ndim != 2 or self.ys.shape[1] != n:
            raise ValueError(f"A must be ({n}, {n}) and ys (n_steps, {n}), got "
                             f"{tuple(self.A.shape)} and {tuple(self.ys.shape)}")
        self.w_true = None if w_true is None else _tensor(w_true, dtype, device)
        self.obs_scale = float(obs_scale)
        self.prior_scale = float(prior_scale)

    @property
    def n_steps(self) -> int:
        return self.ys.shape[0]

    def _on(self, w):
        """A and ys on w's device and in its dtype."""
        return (self.A.to(device=w.device, dtype=w.dtype),
                self.ys.to(device=w.device, dtype=w.dtype))

    def logdensity(self, w):
        A, ys = self._on(w)
        inv2s2 = 0.5 / self.obs_scale**2
        z = torch.zeros_like(w)
        lls = []
        for y in ys:  # the scan: carry z, one log-likelihood term per step
            z = A @ z + w
            lls.append(-inv2s2 * torch.sum((y - z) ** 2))
        return torch.sum(torch.stack(lls)) - 0.5 * torch.sum(w * w) / self.prior_scale**2

    def map_solution(self):
        """Closed form via the normal equations: z_t = M_t w with
        M_t = Σ_{j<=t} A^j, so the MAP solves
        (Σ M_tᵀM_t / s² + I/p²) w = Σ M_tᵀ y_t / s²."""
        n = self.dimension
        dtype, device = self.ys.dtype, self.ys.device
        M = torch.zeros((n, n), dtype=dtype, device=device)
        P = torch.eye(n, dtype=dtype, device=device)  # A^0
        lhs = torch.eye(n, dtype=dtype, device=device) / self.prior_scale**2
        rhs = torch.zeros(n, dtype=dtype, device=device)
        s2 = self.obs_scale**2
        for t in range(self.n_steps):
            M = M + P  # M_t = I + A + ... + A^t
            lhs = lhs + (M.T @ M) / s2
            rhs = rhs + (M.T @ self.ys[t]) / s2
            P = self.A @ P
        return torch.linalg.solve(lhs, rhs)
