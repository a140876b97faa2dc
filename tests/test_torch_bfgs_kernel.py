"""The port's fused BFGS update (quasinewtonmethods_jl_tpu_torch/ops/kernels/
bfgs_kernel.py) against the JAX package's, on the same numpy inputs.

On the CPU the port's update is its plain PyTorch version; it is held
against the JAX Pallas kernel in interpret mode, the JAX jnp twin, and the
single-lane `bfgs_update`, in f64. Tolerances are absolute 1e-10 on values
of order 1-10: the summation order differs between torch and XLA, nothing
else does. The CUDA kernel is held to the plain version on the card, on
this fixture and at more sizes and in f32, by
tests/test_torch_kernels_cuda.py, which imports no jax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quasinewtonmethods_jl_tpu.ops.bfgs import bfgs_update as jax_bfgs_update
from quasinewtonmethods_jl_tpu.ops.bfgs import bfgs_update_reference as jax_bfgs_update_reference
from quasinewtonmethods_jl_tpu.ops.bfgs import h0_gamma as jax_h0_gamma
from quasinewtonmethods_jl_tpu.ops.pallas.bfgs_kernel import (
    fused_bfgs_update_batched as jax_fused_kernel,
    fused_bfgs_update_reference as jax_fused_reference,
)
from quasinewtonmethods_jl_tpu_torch.ops.bfgs import bfgs_update, bfgs_update_reference, h0_gamma
from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
    fused_bfgs_update_batched,
    fused_bfgs_update_reference,
)
from test_torch_kernels_cuda import make_inputs

torch.set_num_threads(1)

ATOL = 1e-10  # f64, summation order only (torch vs XLA)


def to_batch_minor(B, step, g, g_old, active, fresh):
    """Port-layout numpy arrays (lane-major, bool masks) -> the JAX kernel's
    arguments (batch-minor, (1, batch) float masks)."""
    return (
        jnp.asarray(np.moveaxis(B, 0, -1)),
        jnp.asarray(step.T),
        jnp.asarray(g.T),
        jnp.asarray(g_old.T),
        jnp.asarray(active.astype(B.dtype)[None, :]),
        jnp.asarray(fresh.astype(B.dtype)[None, :]),
    )


def from_batch_minor(B, d, m, reset):
    """The JAX kernel's outputs -> port layout (reset as a bool mask)."""
    return (
        np.moveaxis(np.asarray(B), -1, 0),
        np.asarray(d).T,
        np.asarray(m)[0],
        np.asarray(reset)[0] > 0,
    )


def port_update(fn, B, s, g, gold, active, fresh):
    out = fn(*(torch.tensor(a) for a in (B, s, g, gold, active, fresh)))
    return [t.numpy() for t in out]


@pytest.mark.parametrize(
    "n, batch, kinds",
    [(12, 32, False), (12, 32, True), (7, 24, True), (13, 24, True), (1, 16, True)],
)
def test_reference_matches_jax_kernel_and_twin(rng, n, batch, kinds):
    args = make_inputs(rng, n, batch, kinds)
    port = port_update(fused_bfgs_update_reference, *args)
    jax_args = to_batch_minor(*args)
    twin = from_batch_minor(*jax_fused_reference(*jax_args))
    pallas = from_batch_minor(
        *jax_fused_kernel(*jax_args, block_batch=8, interpret=True)
    )
    for other in (twin, pallas):
        for mine, theirs, name in zip(port, other, ["B", "d", "m"]):
            np.testing.assert_allclose(mine, theirs, atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_array_equal(port[3], other[3])
    if kinds:
        assert port[3][9:13].all()  # forced resets
        assert not port[3][13:16].any()  # NaN lanes do not reset
        assert np.isnan(port[2][13:16]).all()


def test_frozen_reset_lane_semantics(rng):
    B, s, g, gold, active, fresh = make_inputs(rng, 6, 16, kinds=True)
    Bt = torch.tensor(B)
    B_out, d, m, reset = fused_bfgs_update_reference(
        Bt, *(torch.tensor(a) for a in (s, g, gold, active, fresh))
    )
    assert B_out is Bt  # in place
    np.testing.assert_array_equal(B_out[:5].numpy(), B[:5])  # frozen: bit for bit
    assert (d[:5] == 0).all() and (m[:5] == 1).all() and not reset[:5].any()
    np.testing.assert_array_equal(B_out[9:13].numpy(), np.broadcast_to(np.eye(6), (4, 6, 6)))
    np.testing.assert_array_equal(d[9:13].numpy(), g[9:13])
    np.testing.assert_allclose(m[9:13].numpy(), (g[9:13] ** 2).sum(1), rtol=1e-15)


def test_reference_matches_single_lane_update(rng):
    """The closed-form fleet update agrees with the reference-form
    single-lane bfgs_update (matvec through B_new), port and JAX alike."""
    n, batch = 9, 12
    B, s, g, gold, active, fresh = make_inputs(rng, n, batch)
    active[:] = True
    fresh[:] = False
    Bo, do, mo, _ = port_update(fused_bfgs_update_reference, B, s, g, gold, active, fresh)
    for b in range(batch):
        B1, d1, m1 = (t.numpy() for t in bfgs_update(*(torch.tensor(a[b]) for a in (B, s, g, gold))))
        Bj, dj, mj = (np.asarray(t) for t in jax_bfgs_update(*(jnp.asarray(a[b]) for a in (B, s, g, gold))))
        np.testing.assert_allclose(B1, Bj, atol=ATOL, rtol=0)
        np.testing.assert_allclose(d1, dj, atol=ATOL, rtol=0)
        np.testing.assert_allclose(m1, mj, rtol=1e-12)
        if m1 > 0:  # non-reset lane: full update comparison
            np.testing.assert_allclose(Bo[b], B1, atol=ATOL, rtol=0)
            np.testing.assert_allclose(do[b], d1, atol=ATOL, rtol=0)
            np.testing.assert_allclose(mo[b], m1, rtol=1e-9)


def test_single_lane_update_fresh_scaling(rng):
    B, s, g, gold, _, _ = make_inputs(rng, 5, 1)
    for fresh in (True, False):
        port = bfgs_update(*(torch.tensor(a[0]) for a in (B, s, g, gold)), fresh=torch.tensor(fresh))
        ref = jax_bfgs_update(*(jnp.asarray(a[0]) for a in (B, s, g, gold)), fresh=jnp.asarray(fresh))
        for mine, theirs in zip(port, ref):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=ATOL, rtol=0)


def test_textbook_form_matches_jax_and_the_update(rng):
    """`bfgs_update_reference` (V B Vᵀ + ρ ssᵀ) against JAX's and against
    the port's rank-2 `bfgs_update`, lane by lane in f64."""
    B, s, g, gold, _, _ = make_inputs(rng, 9, 12)
    for b in range(B.shape[0]):
        port = bfgs_update_reference(*(torch.tensor(a[b]) for a in (B, s, g, gold)))
        ref = jax_bfgs_update_reference(*(jnp.asarray(a[b]) for a in (B, s, g, gold)))
        fast = bfgs_update(*(torch.tensor(a[b]) for a in (B, s, g, gold)))
        for mine, theirs, other in zip(port, ref, fast):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=ATOL, rtol=1e-12)
            np.testing.assert_allclose(mine.numpy(), other.numpy(), atol=ATOL, rtol=1e-12)


def test_h0_gamma_matches_jax():
    nan, inf = np.nan, np.inf
    sty = np.array([1.0, 2e-5, 3e4, nan, 0.0, -1.0, inf, 1.0, 1.0])
    yty = np.array([2.0, 1.0, 1.0, 1.0, 0.0, 1.0, inf, 0.0, nan])
    for fresh in (True, False):
        f = np.full(sty.shape, fresh)
        port = h0_gamma(torch.tensor(sty), torch.tensor(yty), torch.tensor(f), torch.float64)
        ref = jax_h0_gamma(jnp.asarray(sty), jnp.asarray(yty), jnp.asarray(f), jnp.float64)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing(rng):
    args = make_inputs(rng, 6, 16, kinds=True)
    before = fused_bfgs_update_batched.launches
    out = port_update(fused_bfgs_update_batched, *args)
    ref = port_update(fused_bfgs_update_reference, *args)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert fused_bfgs_update_batched.launches == before


@pytest.mark.parametrize(
    "bad, error",
    [
        ({"B": np.zeros((4, 3, 2))}, ValueError),
        ({"g": np.zeros((4, 2))}, ValueError),
        ({"active": np.ones(4)}, ValueError),
        ({"dtype": np.float16}, TypeError),
    ],
)
def test_wrapper_rejects_bad_arguments(bad, error):
    batch, n = 4, 3
    dtype = bad.pop("dtype", np.float64)
    args = {
        "B": np.broadcast_to(np.eye(n), (batch, n, n)).astype(dtype),
        "step": np.zeros((batch, n), dtype),
        "g": np.zeros((batch, n), dtype),
        "g_old": np.zeros((batch, n), dtype),
        "active": np.ones(batch, bool),
        "fresh": np.ones(batch, bool),
    }
    args.update(bad)
    with pytest.raises(error):
        fused_bfgs_update_batched(**{k: torch.tensor(v) for k, v in args.items()})
