"""Constrained-parameter transforms (bijectors) for log-density models — the
PyTorch port of ``quasinewtonmethods_jl_tpu/transforms.py``.

The reference library optimizes over unconstrained R^n and leaves
constrained parameters (variances > 0, simplices, ordered cutpoints,
correlation matrices) to its parent ecosystem, which builds the
unconstraining transform and its log-Jacobian into the log-density
(reference src/QuasiNewtonMethods.jl:8-9; README.md:14). Here, as in the
JAX package, each transform is a static-shape bijection z (unconstrained)
-> x (constrained) with its exact log|det J|, so every engine runs on z
while the user thinks in x.

Design rules (those of the JAX package):

* **Static shapes, no data-dependent control flow**: elementwise ops,
  cumsum and index maps with constant indices, so a transform runs under
  ``torch.func.vmap`` and traces into the resident kernel B3
  (ops/kernels/objective_trace.py). Every map is written out of place:
  JAX's ``.at[rows, cols].set(v)`` is ``torch.zeros(...).index_put((rows,
  cols), v)``, and ``torch.tril_indices`` gives ``jnp.tril_indices``'s
  row-major order.
* **Maximization convention**: the wrapped objective is ``l(forward(z)) +
  log|det dforward/dz|``, maximized like any other.
* **Analytic gradients survive wrapping**: `TransformedModel` pulls a
  user's analytic gradient back through the transform with one
  ``torch.func.vjp`` of ``forward``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

from .api import ProbabilityModel, as_logdensity

__all__ = [
    "Transform",
    "Identity",
    "Positive",
    "Interval",
    "Ordered",
    "Simplex",
    "CorrCholesky",
    "CovCholesky",
    "BlockTransform",
    "TransformedModel",
    "transform_objective",
    "forward_draws",
    "unpack_cholesky",
    "pack_cholesky",
]


class Transform:
    """A static-shape bijection z (unconstrained) -> x (constrained).

    Subclasses define ``unconstrained_size`` / ``constrained_size`` (equal
    for most transforms; the simplex maps k-1 -> k) and the maps below,
    which take and return flat 1-D tensors of the advertised sizes."""

    @property
    def unconstrained_size(self) -> int:
        raise NotImplementedError

    @property
    def constrained_size(self) -> int:
        raise NotImplementedError

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """Map unconstrained z to constrained x."""
        return self.forward_and_log_det(z)[0]

    def forward_and_log_det(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x, log|det dforward/dz|) in one pass."""
        raise NotImplementedError

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        """Map constrained x back to z (for user-supplied starts)."""
        raise NotImplementedError

    def log_det_jacobian(self, z: torch.Tensor) -> torch.Tensor:
        """log|det dforward/dz| at z."""
        return self.forward_and_log_det(z)[1]


@dataclasses.dataclass(frozen=True)
class Identity(Transform):
    """Unconstrained block (passthrough, zero log-Jacobian)."""

    size: int

    @property
    def unconstrained_size(self) -> int:
        return self.size

    @property
    def constrained_size(self) -> int:
        return self.size

    def forward_and_log_det(self, z):
        return z, torch.zeros((), dtype=z.dtype, device=z.device)

    def inverse(self, x):
        return x


@dataclasses.dataclass(frozen=True)
class Positive(Transform):
    """Lower-bounded block: x = lo + exp(z); log|J| = sum(z). ``lo`` is a
    Python float (default 0.0: variances, scales, rates)."""

    size: int
    lo: float = 0.0

    @property
    def unconstrained_size(self) -> int:
        return self.size

    @property
    def constrained_size(self) -> int:
        return self.size

    def forward_and_log_det(self, z):
        return self.lo + torch.exp(z), torch.sum(z)

    def inverse(self, x):
        return torch.log(x - self.lo)


@dataclasses.dataclass(frozen=True)
class Interval(Transform):
    """Bounded block: x = lo + (hi - lo)·sigmoid(z);
    log|J| = sum(log(hi - lo) + log_sigmoid(z) + log_sigmoid(-z))."""

    size: int
    lo: float = 0.0
    hi: float = 1.0

    def __post_init__(self):
        if not self.hi > self.lo:
            raise ValueError(f"Interval requires hi > lo, got lo={self.lo}, hi={self.hi}")

    @property
    def unconstrained_size(self) -> int:
        return self.size

    @property
    def constrained_size(self) -> int:
        return self.size

    def forward_and_log_det(self, z):
        # Python floats, not tensors made here: a tensor made on the card
        # inside the objective is a host-to-device copy on every trace
        width = self.hi - self.lo
        x = self.lo + width * torch.sigmoid(z)
        lsig = torch.nn.functional.logsigmoid
        ld = torch.sum(math.log(width) + lsig(z) + lsig(-z))
        return x, ld

    def inverse(self, x):
        p = (x - self.lo) / (self.hi - self.lo)
        return torch.log(p) - torch.log1p(-p)


@dataclasses.dataclass(frozen=True)
class Ordered(Transform):
    """Strictly increasing block (cutpoints): x_0 = z_0,
    x_i = x_{i-1} + exp(z_i); log|J| = sum(z_1..)."""

    size: int

    @property
    def unconstrained_size(self) -> int:
        return self.size

    @property
    def constrained_size(self) -> int:
        return self.size

    def forward_and_log_det(self, z):
        zero = torch.zeros((1,), dtype=z.dtype, device=z.device)
        x = z[:1] + torch.cat([zero, torch.cumsum(torch.exp(z[1:]), 0)])
        return x, torch.sum(z[1:])

    def inverse(self, x):
        return torch.cat([x[:1], torch.log(torch.diff(x))])


def _simplex_offsets(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.arange(k - 1, 0, -1, dtype=like.dtype, device=like.device))


@dataclasses.dataclass(frozen=True)
class Simplex(Transform):
    """Probability simplex of ``size`` components (stick-breaking; the
    unconstrained dimension is size - 1).

    Stan's construction: break fraction v_i = sigmoid(z_i - log(K-1-i)),
    x_i = v_i·(remaining stick), so z = 0 maps to the uniform simplex; the
    running stick is an exclusive cumsum of log(1 - v) in log space."""

    size: int

    def __post_init__(self):
        if self.size < 2:
            raise ValueError(f"Simplex needs size >= 2, got {self.size}")

    @property
    def unconstrained_size(self) -> int:
        return self.size - 1

    @property
    def constrained_size(self) -> int:
        return self.size

    def forward_and_log_det(self, z):
        lsig = torch.nn.functional.logsigmoid
        za = z - _simplex_offsets(self.size, z)
        lv = lsig(za)  # log v_i
        l1mv = lsig(-za)  # log(1 - v_i)
        # exclusive cumulative log-remaining-stick: [0, l1mv_0, l1mv_0 + l1mv_1, ...]
        zero = torch.zeros((1,), dtype=z.dtype, device=z.device)
        lrem = torch.cat([zero, torch.cumsum(l1mv, 0)])
        x = torch.cat([torch.exp(lv + lrem[:-1]), torch.exp(lrem[-1:])])
        ld = torch.sum(lv + l1mv + lrem[:-1])
        return x, ld

    def inverse(self, x):
        zero = torch.zeros((1,), dtype=x.dtype, device=x.device)
        rem = 1.0 - torch.cat([zero, torch.cumsum(x[:-1], 0)])[:-1]
        v = x[:-1] / rem
        return torch.log(v) - torch.log1p(-v) + _simplex_offsets(self.size, x)


def unpack_cholesky(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Unpack a row-major packed lower triangle (with the diagonal; length
    dim·(dim+1)/2) into a (dim, dim) lower-triangular matrix. Leading batch
    axes pass through."""
    if x.ndim > 1:
        flat = x.reshape(-1, x.shape[-1])
        out = torch.func.vmap(lambda v: unpack_cholesky(v, dim))(flat)
        return out.reshape(*x.shape[:-1], dim, dim)
    rows, cols = torch.tril_indices(dim, dim, device=x.device)
    return torch.zeros((dim, dim), dtype=x.dtype, device=x.device).index_put((rows, cols), x)


def pack_cholesky(L: torch.Tensor) -> torch.Tensor:
    """Pack the lower triangle (with the diagonal) of a (dim, dim) matrix
    into a flat row-major vector: the inverse of `unpack_cholesky`."""
    rows, cols = torch.tril_indices(L.shape[-1], L.shape[-1], device=L.device)
    return L[..., rows, cols]


def _stable_log1m_tanh2(z: torch.Tensor) -> torch.Tensor:
    # log(1 - tanh(z)^2) without cancellation: 2(log 2 - z - softplus(-2z)),
    # softplus as logaddexp(x, 0) (JAX's, with no threshold: torch's
    # softplus returns x itself above 20)
    return 2.0 * (math.log(2.0) - z - torch.logaddexp(-2.0 * z, torch.zeros_like(z)))


@dataclasses.dataclass(frozen=True)
class CorrCholesky(Transform):
    """Cholesky factor of a ``dim x dim`` correlation matrix (the LKJ
    parameterization): z (dim·(dim-1)/2 canonical partial correlations,
    row-major strict lower order) -> x = packed lower triangle of L
    (row-major with the derived diagonal, length dim·(dim+1)/2), with
    L Lᵀ a unit-diagonal positive-definite correlation matrix.

    Stan's construction: w_ij = tanh(z_ij); L_ij = w_ij·prod_{k<j}
    sqrt(1 - w_ik²); L_ii closes each row to unit norm: a masked (dim, dim)
    tanh and a row-wise exclusive cumsum in log space. log|det J| is over
    the strict lower triangle: sum_ij [log(1 - w_ij²) + (1/2) sum_{k<j}
    log(1 - w_ik²)]. Use `unpack_cholesky(x, dim)` to get L itself."""

    dim: int

    def __post_init__(self):
        if self.dim < 2:
            raise ValueError(f"CorrCholesky needs dim >= 2, got {self.dim}")

    @property
    def unconstrained_size(self) -> int:
        return self.dim * (self.dim - 1) // 2

    @property
    def constrained_size(self) -> int:
        return self.dim * (self.dim + 1) // 2

    def forward_and_log_det(self, z):
        d = self.dim
        rows, cols = torch.tril_indices(d, d, -1, device=z.device)
        Z = torch.zeros((d, d), dtype=z.dtype, device=z.device).index_put((rows, cols), z)
        i = torch.arange(d, device=z.device)
        mask = i[:, None] > i[None, :]  # the strict lower triangle
        l1mw2 = torch.where(mask, _stable_log1m_tanh2(Z), 0.0)
        # exclusive row cumsum: c[i, j] = sum_{k<j} l1mw2[i, k]
        c = torch.cumsum(l1mw2, 1) - l1mw2
        L = torch.where(mask, torch.tanh(Z) * torch.exp(0.5 * c), 0.0)
        # row closure: c at the diagonal column already sums the whole row
        L = L + torch.diag(torch.exp(0.5 * torch.diagonal(c)))
        ld = torch.sum(torch.where(mask, l1mw2 + 0.5 * c, 0.0))
        return pack_cholesky(L), ld

    def inverse(self, x):
        L = unpack_cholesky(x, self.dim)
        # remaining stick: 1 - sum_{k<j} L_ik² (exclusive row cumsum)
        sq = L * L
        rem = 1.0 - (torch.cumsum(sq, 1) - sq)
        w = L / torch.sqrt(rem)
        rows, cols = torch.tril_indices(self.dim, self.dim, -1, device=x.device)
        return torch.atanh(w[rows, cols])


@dataclasses.dataclass(frozen=True)
class CovCholesky(Transform):
    """Cholesky factor of a ``dim x dim`` covariance matrix: the diagonal
    entries of z map through exp, the strict lower triangle passes
    through. Packing order that of `CorrCholesky` / `pack_cholesky`; z and
    x have length dim·(dim+1)/2; log|det J| = sum of the diagonal z."""

    dim: int

    def __post_init__(self):
        if self.dim < 1:
            raise ValueError(f"CovCholesky needs dim >= 1, got {self.dim}")

    @property
    def unconstrained_size(self) -> int:
        return self.dim * (self.dim + 1) // 2

    @property
    def constrained_size(self) -> int:
        return self.dim * (self.dim + 1) // 2

    def _diag_positions(self, like):
        # position of (i, i) within the row-major packed lower triangle
        i = torch.arange(self.dim, device=like.device)
        return i * (i + 1) // 2 + i

    def forward_and_log_det(self, z):
        pos = self._diag_positions(z)
        zd = z[pos]
        return z.index_put((pos,), torch.exp(zd)), torch.sum(zd)

    def inverse(self, x):
        pos = self._diag_positions(x)
        return x.index_put((pos,), torch.log(x[pos]))


@dataclasses.dataclass(frozen=True)
class BlockTransform(Transform):
    """Concatenation of per-block transforms over one flat vector: z is the
    concatenation of each block's unconstrained slice, x of each
    constrained slice, log|J| the sum (e.g. ``BlockTransform([Identity(p),
    Positive(1)])`` for a regression with a scale parameter)."""

    blocks: Tuple[Transform, ...]

    def __init__(self, blocks: Sequence[Transform]):
        object.__setattr__(self, "blocks", tuple(blocks))
        if not self.blocks:
            raise ValueError("BlockTransform needs at least one block")

    @property
    def unconstrained_size(self) -> int:
        return sum(b.unconstrained_size for b in self.blocks)

    @property
    def constrained_size(self) -> int:
        return sum(b.constrained_size for b in self.blocks)

    def forward_and_log_det(self, z):
        xs = []
        ld = torch.zeros((), dtype=z.dtype, device=z.device)
        off = 0
        for b in self.blocks:
            x_b, ld_b = b.forward_and_log_det(z[off: off + b.unconstrained_size])
            xs.append(x_b)
            ld = ld + ld_b
            off += b.unconstrained_size
        return torch.cat(xs), ld

    def inverse(self, x):
        zs = []
        off = 0
        for b in self.blocks:
            zs.append(b.inverse(x[off: off + b.constrained_size]))
            off += b.constrained_size
        return torch.cat(zs)


class TransformedModel(ProbabilityModel):
    """A ProbabilityModel over unconstrained z wrapping a constrained-space
    objective: logdensity(z) = l(forward(z)) + log|det J(z)|.

    An analytic gradient (``value_and_grad_fn`` or the object's own
    ``logdensity_and_gradient``) is pulled back through the transform with
    one ``torch.func.vjp`` of ``forward``; only the log-Jacobian term is
    differentiated (``torch.func.grad_and_value``)."""

    def __init__(self, obj, transform: Transform, value_and_grad_fn=None):
        super().__init__(transform.unconstrained_size)
        self._obj = obj
        self.transform = transform
        self._logdensity_x = as_logdensity(obj)
        if value_and_grad_fn is not None:
            self._vag_x = value_and_grad_fn
        elif hasattr(obj, "logdensity_and_gradient"):
            self._vag_x = obj.logdensity_and_gradient
        else:
            self._vag_x = None

    def logdensity(self, z: torch.Tensor) -> torch.Tensor:
        x, ld = self.transform.forward_and_log_det(z)
        return self._logdensity_x(x) + ld

    def logdensity_and_gradient(self, z: torch.Tensor):
        if self._vag_x is None:
            grad, value = torch.func.grad_and_value(self.logdensity)(z)
            return value, grad
        x, vjp_fwd = torch.func.vjp(self.transform.forward, z)
        val_x, grad_x = self._vag_x(x)
        grad_ld, ld = torch.func.grad_and_value(self.transform.log_det_jacobian)(z)
        return val_x + ld, vjp_fwd(grad_x)[0] + grad_ld

    def constrain(self, z: torch.Tensor) -> torch.Tensor:
        """Map a z-space iterate or draw (or a batch of them) to x-space."""
        return forward_draws(self.transform, z)

    def unconstrain(self, x: torch.Tensor) -> torch.Tensor:
        """Map x-space points (or batches) to z-space starts."""
        if x.ndim == 1:
            return self.transform.inverse(x)
        flat = x.reshape(-1, x.shape[-1])
        z = torch.func.vmap(self.transform.inverse)(flat)
        return z.reshape(*x.shape[:-1], self.transform.unconstrained_size)


def transform_objective(obj, transform: Transform, value_and_grad_fn=None):
    """Wrap a constrained-space objective into a `TransformedModel` over
    unconstrained z (see the module docstring)."""
    return TransformedModel(obj, transform, value_and_grad_fn=value_and_grad_fn)


def forward_draws(transform: Transform, z: torch.Tensor) -> torch.Tensor:
    """Apply ``transform.forward`` over the last axis of ``z`` with any
    number of leading batch axes ((draws, chains, n_z) -> (..., n_x))."""
    if z.ndim == 1:
        return transform.forward(z)
    flat = z.reshape(-1, z.shape[-1])
    x = torch.func.vmap(transform.forward)(flat)
    return x.reshape(*z.shape[:-1], transform.constrained_size)
