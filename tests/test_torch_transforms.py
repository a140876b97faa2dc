"""The port's constrained-parameter transforms (transforms.py) against the
JAX package's, on the same numpy inputs in float64 on the CPU.

Every transform of JAX's tests/test_transforms.py (``ALL_TRANSFORMS`` and
``CHOL_TRANSFORMS``): forward, log|det J| and inverse agree to 1e-12, the
round trip returns z, a `BlockTransform` is the sum of its parts, a
`TransformedModel` gives JAX's value and gradient with and without an
analytic ``value_and_grad_fn`` (the pull-back through ``torch.func.vjp``),
`forward_draws` and ``unconstrain`` keep the batch axes, float32 stays
float32, and the argument errors are JAX's. `CorrCholesky` near z = -12
shows why its log(1 - tanh²) takes softplus as ``logaddexp(x, 0)``: torch's
``softplus`` returns x itself above 20 and would differ from JAX's there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu import transforms as jt
from quasinewtonmethods_jl_tpu_torch import transforms as tt

torch.set_num_threads(1)


def pairs():
    """(port transform, JAX transform) for every transform JAX's tests use."""
    made = []
    for mod in (tt, jt):
        square = [mod.Identity(5), mod.Positive(4), mod.Positive(3, lo=-2.0),
                  mod.Interval(4, lo=-1.0, hi=3.0), mod.Ordered(5)]
        every = square + [mod.Simplex(4), mod.BlockTransform(
            [mod.Identity(2), mod.Positive(2), mod.Simplex(3), mod.Interval(1)])]
        chol = [mod.CorrCholesky(2), mod.CorrCholesky(4), mod.CovCholesky(3)]
        made.append(every + chol)
    return list(zip(*made))


PAIRS = pairs()
IDS = [f"{type(p).__name__}{i}" for i, (p, _) in enumerate(PAIRS)]


def close(port, ref, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_forward_log_det_and_inverse_match_jax(rng, pair):
    port, ref = pair
    for scale in (0.5, 2.0):
        z = scale * rng.standard_normal(port.unconstrained_size)
        x, ld = port.forward_and_log_det(torch.tensor(z))
        jx, jld = ref.forward_and_log_det(jnp.asarray(z))
        assert x.shape == (port.constrained_size,) and ld.shape == ()
        close(x, jx)
        close(ld, jld)
        close(port.forward(torch.tensor(z)), jx)
        close(port.log_det_jacobian(torch.tensor(z)), jld)
        close(port.inverse(x), ref.inverse(jx), rtol=1e-10)
        close(port.inverse(x), z, rtol=1e-9)  # the round trip


def test_block_transform_is_the_sum_of_its_parts(rng):
    blocks = [tt.Identity(2), tt.Positive(2), tt.Simplex(3), tt.Interval(1), tt.CorrCholesky(3)]
    block = tt.BlockTransform(blocks)
    assert block.unconstrained_size == 2 + 2 + 2 + 1 + 3
    assert block.constrained_size == 2 + 2 + 3 + 1 + 6
    z = torch.tensor(rng.standard_normal(block.unconstrained_size))
    x, ld = block.forward_and_log_det(z)
    xs, lds, off = [], torch.zeros((), dtype=z.dtype), 0
    for b in blocks:
        xb, ldb = b.forward_and_log_det(z[off: off + b.unconstrained_size])
        xs.append(xb)
        lds = lds + ldb
        off += b.unconstrained_size
    assert torch.equal(x, torch.cat(xs)) and torch.equal(ld, lds)
    close(block.inverse(x), z, rtol=1e-9)


A = np.array([2.0, 3.0, 4.0, 5.0])
B = np.array([1.0, 2.0, 0.5, 4.0])


def gamma_logdensities():
    """A Gamma-product log-density on x > 0 in both packages, and the
    port's analytic value and gradient of it."""
    At, Bt, Aj, Bj = torch.tensor(A), torch.tensor(B), jnp.asarray(A), jnp.asarray(B)

    def port(x):
        return torch.sum((At - 1.0) * torch.log(x) - Bt * x)

    def port_vag(x):
        return port(x), (At - 1.0) / x - Bt

    def ref(x):
        return jnp.sum((Aj - 1.0) * jnp.log(x) - Bj * x)

    return port, port_vag, ref


@pytest.mark.parametrize("analytic", [False, True], ids=["autodiff", "value_and_grad_fn"])
def test_transformed_model_value_and_gradient_match_jax(rng, analytic):
    port, port_vag, ref = gamma_logdensities()
    for port_t, ref_t in ((tt.Positive(4), jt.Positive(4)),
                          (tt.BlockTransform([tt.Interval(2, lo=0.0, hi=9.0), tt.Positive(2)]),
                           jt.BlockTransform([jt.Interval(2, lo=0.0, hi=9.0), jt.Positive(2)]))):
        m = tt.transform_objective(port, port_t, value_and_grad_fn=port_vag if analytic else None)
        jm = jt.transform_objective(ref, ref_t)
        assert len(m) == m.dimension == 4
        for _ in range(3):
            z = rng.standard_normal(4)
            value, grad = m.logdensity_and_gradient(torch.tensor(z))
            jvalue, jgrad = jax.value_and_grad(jm.logdensity)(jnp.asarray(z))
            close(value, jvalue)
            close(grad, jgrad)
            close(m.logdensity(torch.tensor(z)), jvalue)


def test_a_models_own_gradient_is_pulled_back(rng):
    """A model with ``logdensity_and_gradient`` is not re-differentiated:
    its analytic gradient goes through the vjp of ``forward``."""
    port, port_vag, ref = gamma_logdensities()
    calls = []

    class Model:
        def logdensity(self, x):
            return port(x)

        def logdensity_and_gradient(self, x):
            calls.append(1)
            return port_vag(x)

    m = tt.transform_objective(Model(), tt.Positive(4))
    z = rng.standard_normal(4)
    value, grad = m.logdensity_and_gradient(torch.tensor(z))
    jvalue, jgrad = jax.value_and_grad(jt.transform_objective(ref, jt.Positive(4)).logdensity)(
        jnp.asarray(z))
    assert calls == [1]
    close(value, jvalue)
    close(grad, jgrad)


def test_forward_draws_and_unconstrain_keep_batch_axes(rng):
    t, j = tt.Simplex(4), jt.Simplex(4)
    z = rng.standard_normal((5, 3, 3))
    x = tt.forward_draws(t, torch.tensor(z))
    assert x.shape == (5, 3, 4)
    close(x, jt.forward_draws(j, jnp.asarray(z)))
    close(tt.forward_draws(t, torch.tensor(z[0, 0])), j.forward(jnp.asarray(z[0, 0])))
    m = tt.transform_objective(lambda x: -torch.sum(x * x), t)
    back = m.unconstrain(x)
    assert back.shape == (5, 3, 3)
    close(back, z, rtol=1e-9)
    close(m.constrain(torch.tensor(z)), x)
    close(m.unconstrain(x[0, 0]), z[0, 0], rtol=1e-9)
    L = tt.unpack_cholesky(torch.tensor(rng.standard_normal((2, 3, 6))), 3)
    assert L.shape == (2, 3, 3, 3)
    close(L, jt.unpack_cholesky(jnp.asarray(L.numpy()[..., np.tril_indices(3)[0],
                                                       np.tril_indices(3)[1]]), 3))


def test_pack_and_unpack_cholesky_match_jax(rng):
    x = rng.standard_normal(10)
    L = tt.unpack_cholesky(torch.tensor(x), 4)
    close(L, jt.unpack_cholesky(jnp.asarray(x), 4))
    close(tt.pack_cholesky(L), x)
    M = rng.standard_normal((2, 4, 4))
    close(tt.pack_cholesky(torch.tensor(M)), jt.pack_cholesky(jnp.asarray(M)))


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_float32_stays_float32(rng, pair):
    port, _ = pair
    z = torch.tensor(rng.standard_normal(port.unconstrained_size), dtype=torch.float32)
    x, ld = port.forward_and_log_det(z)
    assert x.dtype == ld.dtype == port.inverse(x).dtype == torch.float32


def test_argument_errors_and_immutability():
    for bad, match in ((lambda: tt.Interval(2, lo=1.0, hi=1.0), "hi > lo"),
                       (lambda: tt.Simplex(1), "size >= 2"),
                       (lambda: tt.CorrCholesky(1), "dim >= 2"),
                       (lambda: tt.CovCholesky(0), "dim >= 1"),
                       (lambda: tt.BlockTransform([]), "at least one block")):
        with pytest.raises(ValueError, match=match):
            bad()
    for t in (tt.Positive(2), tt.CorrCholesky(3), tt.BlockTransform([tt.Identity(1)])):
        with pytest.raises(dataclasses.FrozenInstanceError):
            t.size = 3
    assert tt.Positive(3) == tt.Positive(3) and hash(tt.Positive(3)) == hash(tt.Positive(3))


def test_corr_cholesky_far_in_the_tail_matches_jax():
    """At z = -12, -2z = 24 lies past torch.nn.functional.softplus's
    threshold of 20, where it returns x itself: the log-Jacobian must
    still be JAX's, whose softplus is logaddexp(x, 0)."""
    z = np.array([-12.0, -11.0, 0.3])
    port, ref = tt.CorrCholesky(3), jt.CorrCholesky(3)
    x, ld = port.forward_and_log_det(torch.tensor(z))
    jx, jld = ref.forward_and_log_det(jnp.asarray(z))
    close(x, jx)
    close(ld, jld)
    thresholded = 2.0 * (np.log(2.0) - z - torch.nn.functional.softplus(
        torch.tensor(-2.0 * z)).numpy())
    exact = 2.0 * (np.log(2.0) - z - np.logaddexp(-2.0 * z, 0.0))
    # what torch's softplus would have cost: 2·exp(-24), beyond the 1e-12 held here
    assert abs(thresholded[0] - exact[0]) > 1e-12 * abs(exact[0])
    R = (lambda L: L @ L.T)(tt.unpack_cholesky(x, 3))
    close(torch.diagonal(R), np.ones(3))
