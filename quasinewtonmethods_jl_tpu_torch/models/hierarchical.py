"""Hierarchical (multilevel) regression with correlated random effects — the
PyTorch port of ``quasinewtonmethods_jl_tpu/models/hierarchical.py``.

The canonical real Bayesian workload of the reference's pipeline: MAP
mode-finding as HMC chain initialisation (reference README.md:14). A
varying-intercept, varying-slope linear model:

    y_i  = x_iᵀ β + z_iᵀ u_{g(i)} + ε_i,      ε_i ~ N(0, σ²)
    u_j  = diag(τ) L_R e_j  (non-centered),   e_j ~ N(0, I_q)
    β    ~ N(0, 5²),   τ ~ half-Cauchy(0, 2.5),   σ ~ half-Cauchy(0, 2.5)
    L_R  ~ LKJ-Cholesky(η)

The constrained parameters are one flat vector, and ``transform`` is the
matching `BlockTransform` (solve ``transform_objective(m, m.transform)``):

    [ β (p) | e (J·q, non-centered effects) | τ (q, >0) | σ (1, >0)
      | packed L_R (q(q+1)/2, CorrCholesky) ]

Every shape is static: the per-observation group lookup is one gather
(``u[group]``, constant indices), the rest dense products and elementwise
ops, so the transformed model runs under ``torch.func.vmap`` and traces
into the resident kernel B3.

JAX draws the data with ``jax.random``, which torch cannot reproduce: the
port's model takes ``X`` (n_obs, p), ``Z`` (n_obs, q), ``group`` (n_obs,),
``y`` (n_obs,) and optionally ``beta_true`` (p,) and ``u_true`` (J, q) as
arrays (how the tests and `chip_smoke.py` carry one dataset to both
packages), and otherwise draws them by JAX's recipe from a
``torch.Generator`` seeded with ``seed``, on the CPU so that every device
gets the same draw: X = N(0, 1), Z = [1 | N(0, 1)], group uniform on
0..J-1, β = N(0, 1), u = τ_true·N(0, 1) with τ_true = (0.8, 0.5, ...),
y = X β + Σ_k Z_k u[group]_k + 0.5·N(0, 1). The data stay on ``device`` in
``dtype`` (``group`` as int64); the log-density reads them on the point's
device and in its dtype.
"""

from __future__ import annotations

import torch

from ..api import ProbabilityModel
from ..transforms import BlockTransform, CorrCholesky, Identity, Positive, unpack_cholesky
from .logistic import _tensor

__all__ = ["HierarchicalRegression"]


def _half_cauchy_logpdf(x, scale):
    # unnormalized on x > 0 (positivity enforced by the transform)
    return -torch.log1p((x / scale) ** 2)


class HierarchicalRegression(ProbabilityModel):
    """Correlated random-effects posterior: ``n_groups`` groups × ``q``
    group-level effects (intercept + q-1 slopes), ``p`` population-level
    coefficients, ``n_obs`` observations. `logdensity` takes the
    CONSTRAINED flat vector (see the module docstring); pair it with
    ``self.transform``."""

    def __init__(self, n_groups: int = 8, q: int = 2, p: int = 3, n_obs: int = 256,
                 lkj_eta: float = 2.0, seed: int = 0, dtype=torch.float64, device=None,
                 X=None, Z=None, group=None, y=None, beta_true=None, u_true=None):
        self.n_groups, self.q, self.p = int(n_groups), int(q), int(p)
        self.lkj_eta = float(lkj_eta)
        tril = q * (q + 1) // 2
        super().__init__(p + n_groups * q + q + 1 + tril)
        given = [a is not None for a in (X, Z, group, y)]
        if any(given) and not all(given):
            raise ValueError("pass all of X, Z, group and y, or none")
        self.tau_true = torch.tensor([0.8] + [0.5] * (q - 1), dtype=dtype)
        self.sigma_true = 0.5
        if X is None:
            gen = torch.Generator().manual_seed(seed)

            def randn(*shape):
                return torch.randn(shape, generator=gen, dtype=dtype)

            X = randn(n_obs, p)
            Z = torch.cat([torch.ones((n_obs, 1), dtype=dtype), randn(n_obs, q - 1)], dim=1)
            group = torch.randint(0, n_groups, (n_obs,), generator=gen)
            beta_true = randn(p)
            u_true = self.tau_true * randn(n_groups, q)
            noise = self.sigma_true * randn(n_obs)
            y = X @ beta_true + torch.sum(Z * u_true[group], dim=1) + noise
        self.X = _tensor(X, dtype, device)
        self.Z = _tensor(Z, dtype, device)
        self.group = _tensor(group, torch.int64, device)
        self.y = _tensor(y, dtype, device)
        self.beta_true = None if beta_true is None else _tensor(beta_true, dtype, device)
        self.u_true = None if u_true is None else _tensor(u_true, dtype, device)
        n = self.X.shape[0]
        if (self.X.shape != (n, p) or self.Z.shape != (n, q) or self.group.shape != (n,)
                or self.y.shape != (n,)):
            raise ValueError(f"X must be (n_obs, {p}), Z (n_obs, {q}), group and y (n_obs,), got "
                             f"{tuple(self.X.shape)}, {tuple(self.Z.shape)}, "
                             f"{tuple(self.group.shape)}, {tuple(self.y.shape)}")
        # LKJ-Cholesky(eta) exponents over 0-indexed rows: q - i - 1 + 2(eta - 1)
        self._lkj_expo = (torch.arange(q - 1, -1, -1, dtype=dtype)
                          + 2.0 * (self.lkj_eta - 1.0)).to(device)
        self.transform = BlockTransform(
            [Identity(p), Identity(n_groups * q), Positive(q), Positive(1), CorrCholesky(q)])

    @property
    def n_obs(self) -> int:
        return self.X.shape[0]

    def split(self, x):
        """Unpack the constrained flat vector into named parts:
        (beta, e, tau, sigma, L) with L the (q, q) correlation factor."""
        p, J, q = self.p, self.n_groups, self.q
        beta = x[:p]
        e = x[p: p + J * q].reshape(J, q)
        tau = x[p + J * q: p + J * q + q]
        sigma = x[p + J * q + q]
        L = unpack_cholesky(x[p + J * q + q + 1:], q)
        return beta, e, tau, sigma, L

    def random_effects(self, x):
        """The implied group effects u_j = diag(τ) L e_j, shape (J, q)."""
        _, e, tau, _, L = self.split(x)
        return (e @ L.T) * tau

    def _on(self, x):
        """X, Z, y and the LKJ exponents on x's device and in its dtype,
        and the groups on its device."""
        return (*(t.to(device=x.device, dtype=x.dtype)
                  for t in (self.X, self.Z, self.y, self._lkj_expo)),
                self.group.to(device=x.device))

    def logdensity(self, x):
        X, Z, y, lkj_expo, group = self._on(x)
        beta, e, tau, sigma, L = self.split(x)
        u = (e @ L.T) * tau
        mean = X @ beta + torch.sum(Z * u[group], dim=1)
        resid = y - mean
        n = y.shape[0]
        loglik = -0.5 * torch.sum(resid * resid) / sigma**2 - n * torch.log(sigma)
        lp = loglik
        lp = lp + -0.5 * torch.sum(beta * beta) / 25.0
        lp = lp + -0.5 * torch.sum(e * e)
        lp = lp + torch.sum(_half_cauchy_logpdf(tau, 2.5))
        lp = lp + _half_cauchy_logpdf(sigma, 2.5)
        lp = lp + torch.sum(lkj_expo * torch.log(torch.diagonal(L)))
        return lp

    def initial_point(self):
        """A constrained-space start: zeros through the transform (unit
        scales, identity correlation, zero effects)."""
        return self.transform.forward(
            torch.zeros(self.transform.unconstrained_size, dtype=self.X.dtype,
                        device=self.X.device))
