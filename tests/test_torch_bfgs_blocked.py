"""The port's two-pass update B2 (quasinewtonmethods_jl_tpu_torch/ops/kernels/
bfgs_blocked.py) and the fleet engine's kernel dispatch, against the JAX
package's `fused_bfgs_update_blocked`, on the same numpy inputs, in f64.

On CPU tensors both passes take their plain versions, so what is held
against JAX here is the plain passes, the algebra between them
(`update_algebra`) and the engine driven through them; the JAX passes run
in interpret mode. Tolerance atol 1e-10 on values of order 1-10: torch and
XLA sum in different orders, nothing else differs. The CUDA kernels are
held to the same plain versions on the card in
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from quasinewtonmethods_jl_tpu.batched_solve import (
    optimize_batched_fused as jax_optimize_batched_fused,
)
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock
from quasinewtonmethods_jl_tpu.ops.pallas.bfgs_blocked import (
    _matvec_kernel as jax_matvec_kernel,
    _update_kernel as jax_update_kernel,
    fused_bfgs_update_blocked as jax_blocked,
)
from quasinewtonmethods_jl_tpu.ops.pallas.bfgs_kernel import (
    fused_bfgs_update_reference as jax_reference,
)
from quasinewtonmethods_jl_tpu_torch import BackTracking, Status, optimize_batched_fused
from quasinewtonmethods_jl_tpu_torch.api import as_value_and_grad, as_value_fn
from quasinewtonmethods_jl_tpu_torch.batched_solve import (
    _auto_kernel,
    _UPDATE_FNS,
    _fresh_bfgs_carry,
    _solve_loop_batched,
)
from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity
from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_blocked import (
    blocked_matvec,
    blocked_update,
    fused_bfgs_update_blocked,
)
from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
    fused_bfgs_update_batched,
    fused_bfgs_update_reference,
    fused_update_fits,
    update_algebra,
)
from test_torch_bfgs_kernel import from_batch_minor, port_update, to_batch_minor
from test_torch_kernels_cuda import make_inputs

torch.set_num_threads(1)

ATOL = 1e-10  # f64, summation order only (torch vs XLA)
COUNTERS = ("status", "iterations", "n_fev", "n_gev", "n_resets")
N, BATCH, BLOCK_R = 12, 16, 4


def jax_pass(kernel, B, *args, out_shape):
    """Run one of the JAX module's pass bodies through ``pl.pallas_call`` in
    interpret mode, with its wrapper's row-slab grid (BLOCK_R rows, all
    lanes in one block)."""
    n, _, batch = B.shape
    slab = pl.BlockSpec((BLOCK_R, n, batch), lambda i, j: (j, 0, i))
    row = pl.BlockSpec((BLOCK_R, batch), lambda i, j: (j, i))
    full = pl.BlockSpec((n, batch), lambda i, j: (0, i))
    sca = pl.BlockSpec((1, batch), lambda i, j: (0, i))
    if kernel is jax_matvec_kernel:  # (B, y, g) -> (By, Bg)
        in_specs, out_specs = [slab, row, row], [full, full]
    else:  # (B, s rows, u rows, s, u, c1, scale, do_upd, reset) -> B
        in_specs, out_specs = [slab, row, row, full, full, sca, sca, sca, sca], slab
    return pl.pallas_call(
        kernel, grid=(1, n // BLOCK_R), in_specs=in_specs, out_specs=out_specs,
        out_shape=out_shape, interpret=True,
    )(B, *args)


def test_blocked_update_matches_jax_blocked_and_reference():
    """Every lane kind: active, frozen (0-4), fresh (5-8), forced reset
    (9-12), NaN (13-15)."""
    args = make_inputs(np.random.default_rng(20260816), N, BATCH, kinds=True)
    before = (blocked_matvec.launches, blocked_update.launches)
    port = port_update(fused_bfgs_update_blocked, *args)
    assert (blocked_matvec.launches, blocked_update.launches) == before  # CPU: plain passes
    jax_args = to_batch_minor(*args)
    blocked = from_batch_minor(*jax_blocked(*jax_args, block_r=BLOCK_R, block_batch=BATCH,
                                            interpret=True))
    twin = from_batch_minor(*jax_reference(*jax_args))
    for other in (blocked, twin):
        for mine, theirs, name in zip(port, other, ["B", "d", "m"]):
            np.testing.assert_allclose(mine, theirs, atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_array_equal(port[3], other[3])
    np.testing.assert_array_equal(port[0][:5], args[0][:5])  # frozen: bit for bit
    np.testing.assert_array_equal(port[0][9:13], np.broadcast_to(np.eye(N), (4, N, N)))
    assert port[3][9:13].all() and not port[3][13:16].any()


def test_blocked_update_equals_plain_fused_update_on_cpu():
    """On CPU tensors the two-pass update is the plain fused update's own
    arithmetic: equal bit for bit."""
    args = make_inputs(np.random.default_rng(3), 9, BATCH, kinds=True)
    for a, b in zip(port_update(fused_bfgs_update_blocked, *args),
                    port_update(fused_bfgs_update_reference, *args)):
        np.testing.assert_array_equal(a, b)


def test_plain_passes_match_jax_pass_kernels():
    B, s, g, g_old, active, fresh = make_inputs(np.random.default_rng(5), N, BATCH, kinds=True)
    tB, ts, tg, tg_old, tactive, tfresh = (torch.tensor(a) for a in (B, s, g, g_old, active, fresh))
    y = g_old - g
    By, Bg = blocked_matvec(tB, torch.tensor(y), tg)
    vec = jax.ShapeDtypeStruct((N, BATCH), jnp.float64)
    jBy, jBg = jax_pass(jax_matvec_kernel, jnp.asarray(np.moveaxis(B, 0, -1)),
                        jnp.asarray(y.T), jnp.asarray(g.T), out_shape=[vec, vec])
    np.testing.assert_allclose(By.numpy(), np.asarray(jBy).T, atol=ATOL, rtol=0)
    np.testing.assert_allclose(Bg.numpy(), np.asarray(jBg).T, atol=ATOL, rtol=0)

    alg = update_algebra(By, Bg, ts, torch.tensor(y), tg, tactive, tfresh)
    out = blocked_update(tB.clone(), ts, alg.u, alg.c1, alg.scale, alg.do_upd, alg.reset)

    def row(t):
        return jnp.asarray(t.numpy()[None, :].astype(np.float64))

    jB = jax_pass(
        lambda *refs: jax_update_kernel(BLOCK_R, *refs), jnp.asarray(np.moveaxis(B, 0, -1)),
        jnp.asarray(s.T), jnp.asarray(alg.u.numpy().T), jnp.asarray(s.T),
        jnp.asarray(alg.u.numpy().T), row(alg.c1), row(alg.scale), row(alg.do_upd), row(alg.reset),
        out_shape=jax.ShapeDtypeStruct((N, N, BATCH), jnp.float64),
    )
    np.testing.assert_allclose(out.numpy(), np.moveaxis(np.asarray(jB), -1, 0), atol=ATOL, rtol=0)


def test_engine_through_blocked_update_matches_jax_blocked_engine():
    """The port's engine with the two-pass update as its update_fn, against
    the JAX engine through its two-pass kernel in interpret mode (8 x 12
    Rosenbrock, seed 0, tol 1e-8): statuses and counters exactly equal."""
    X0 = np.random.default_rng(0).standard_normal((8, N))
    vag_b = torch.func.vmap(as_value_and_grad(rosenbrock_logdensity))
    f_b = torch.func.vmap(as_value_fn(rosenbrock_logdensity))
    X = torch.tensor(X0)
    status0 = torch.full((8,), int(Status.RUNNING), dtype=torch.int32)
    with torch.no_grad():
        carry = _solve_loop_batched(vag_b, f_b, _fresh_bfgs_carry(X, status0), BackTracking(),
                                    1e-8, 10_000, fused_bfgs_update_blocked)
    ref = jax_optimize_batched_fused(jax_rosenbrock, jnp.asarray(X0), tol=1e-8,
                                     kernel="pallas_blocked_interpret", block_batch=8)
    port = {"status": carry.status, "iterations": carry.iterations, "n_fev": carry.n_fev,
            "n_gev": carry.n_gev, "n_resets": carry.n_resets}
    for name in COUNTERS:
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert (carry.status == Status.CONVERGED).all()
    np.testing.assert_allclose(carry.X.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)


@pytest.mark.parametrize(
    "kernel, device, n, dtype, resolved",
    [
        ("cuda", "cuda", 60, torch.float32, "cuda"),
        ("cuda", "cuda", 237, torch.float32, "cuda"),
        ("cuda", "cuda", 238, torch.float32, "blocked"),
        ("cuda", "cuda", 250, torch.float32, "blocked"),
        ("cuda", "cuda", 200, torch.float64, "blocked"),
        ("auto", "cuda", 512, torch.float32, "blocked"),
        ("auto", "cuda", 60, torch.float64, "cuda"),
        ("cuda", "cuda", 167, torch.float64, "cuda"),
        ("auto", "cpu", 512, torch.float32, "torch"),
        ("torch", "cuda", 512, torch.float32, "torch"),
    ],
)
def test_dispatch_resolves_once_without_a_card(kernel, device, n, dtype, resolved):
    """'cuda' is B1 where one lane's B fits a block's shared memory, else
    B2; the resolution needs no card, only the device type."""
    name = _auto_kernel(kernel, torch.device(device), n, dtype)
    assert name == resolved
    expected = {"cuda": fused_bfgs_update_batched, "blocked": fused_bfgs_update_blocked,
                "torch": fused_bfgs_update_reference}[resolved]
    assert _UPDATE_FNS[name] is expected


@pytest.mark.parametrize(
    "kernel, message",
    [("cuda", "needs CUDA tensors"), ("cuda_blocked", "unknown kernel"),
     ("blocked", "unknown kernel")],
)
def test_cuda_kernel_names_refuse_cpu_tensors(kernel, message):
    """'cuda' needs CUDA tensors; B2 has no name of its own: 'cuda' picks it
    where B1 does not fit."""
    with pytest.raises(ValueError, match=message):
        optimize_batched_fused(rosenbrock_logdensity, torch.zeros((2, 5)), kernel=kernel)


@pytest.mark.parametrize(
    "n, itemsize, fits",
    [(60, 4, True), (237, 4, True), (238, 4, False), (512, 4, False),
     (167, 8, True), (168, 8, False), (200, 8, False)],
)
def test_fused_update_fits_is_the_kernels_byte_count(n, itemsize, fits):
    """csrc/bfgs_update.cu :: smem_bytes: (n² + 6n + 4·16)·itemsize against
    the 232,448 bytes a Hopper block may opt into."""
    assert fused_update_fits(n, itemsize) is fits
    assert fits == ((n * n + 6 * n + 64) * itemsize <= 232_448)


@pytest.mark.parametrize(
    "bad, error",
    [
        ({"y": torch.zeros((4, 2))}, ValueError),
        ({"B": torch.zeros((4, 3, 3), dtype=torch.float16)}, TypeError),
        ({"B": torch.zeros((4, 3, 2))}, ValueError),
    ],
)
def test_matvec_pass_rejects_bad_arguments(bad, error):
    args = {"B": torch.zeros((4, 3, 3), dtype=torch.float64),
            "y": torch.zeros((4, 3), dtype=torch.float64),
            "g": torch.zeros((4, 3), dtype=torch.float64)}
    args.update(bad)
    with pytest.raises(error):
        blocked_matvec(**args)


def test_update_pass_rejects_a_float_mask():
    B = torch.eye(3, dtype=torch.float64).expand(4, 3, 3).clone()
    vec, sca = torch.zeros((4, 3), dtype=torch.float64), torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="do_upd"):
        blocked_update(B, vec, vec, sca, sca, sca, torch.zeros(4, dtype=torch.bool))
