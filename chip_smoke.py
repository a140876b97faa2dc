#!/usr/bin/env python3
"""Smoke run of the PyTorch port (quasinewtonmethods_jl_tpu_torch) on one
NVIDIA GPU: builds the hand-written CUDA kernel, checks it against its
plain PyTorch version, and drives the port's main path — the BFGS fleet
engine through `optimize_batched` — once at the benchmark protocol's size.

Phases (one summary line each on stdout; any failed check raises):
  1. device: name, CUDA version, ``nvidia-smi`` name and power limit;
  2. build: the kernel library from ``quasinewtonmethods_jl_tpu_torch/csrc``
     for sm_90a (nvcc's resource report goes to stderr);
  3. kernel against plain version: f32 and f64, n in {2, 7, 60, 61, 128},
     every lane kind (active, frozen, fresh, forced reset, NaN);
  4. main path: 4096 split-Rosenbrock n=60 solves in f32 (seed 20260816,
     analytic gradient, tol 1e-3, at most 3000 iterations) on cuda:0; every
     lane must converge, and every loop body must have launched the kernel;
  5. exact parity of kernel and plain update on an f64 quadratic fleet;
  6. times: the kernel and the plain version per call at 4096 x 60 f32, and
     solves/s of phase 4 through each.
Then one JSON line of kernel records and, last, the JSON result line.

Run from anywhere: ``python3 chip_smoke.py``. Needs one CUDA card and nvcc;
exits non-zero without a card, and without the package beside it.
"""

import json
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

BENCH_SEED = 20260816
BATCH, N = 4096, 60
TOL, MAX_ITERS = 1e-3, 3000
# The JAX package on this protocol (same seed and sizes, kernel="xla" on the
# CPU): 4096/4096 converged, median 139 and max 225 iterations.
JAX_MEDIAN_ITERS, JAX_MAX_ITERS = 139, 225
# Normwise relative tolerance of kernel vs plain version (max |diff| /
# max |plain| per output): the kernel sums each dot product and matvec in
# another order than cuBLAS and torch's reductions, nothing else differs;
# that costs a few ulps times n.
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
KERNEL_SOURCE = "quasinewtonmethods_jl_tpu_torch/csrc/bfgs_update.cu"
KERNEL_REPLACES = "quasinewtonmethods_jl_tpu/ops/pallas/bfgs_kernel.py:234"


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def device_phase():
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    smi = ""
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        log(smi)
    return name, smi


def build_phase():
    from quasinewtonmethods_jl_tpu_torch.ops.kernels._build import NVCC_FLAGS, load_library

    t0 = time.perf_counter()
    lib = load_library()
    seconds = time.perf_counter() - t0
    print(lib.log, file=sys.stderr, flush=True)
    check("arch=compute_90a,code=sm_90a" in NVCC_FLAGS, "kernel not built for sm_90a")
    log(f"[build] {lib.path.name} from {KERNEL_SOURCE}: nvcc {lib.build_seconds:.2f}s, "
        f"load {seconds:.2f}s, flags {' '.join(NVCC_FLAGS)}")


def kernel_inputs(rng, n, batch, dtype, device, kinds=True):
    """Random SPD B and, with ``kinds``, one of five lane kinds per lane
    (lane % 5): active, frozen, fresh, forced reset (s = -g, g_old = 2g:
    y = g, m_pre = -|g|²), NaN gradient. Without, every lane is active."""
    A = rng.standard_normal((batch, n, n)) * 0.2
    B = A @ np.swapaxes(A, 1, 2) + np.eye(n)
    s = rng.standard_normal((batch, n)) * 0.1
    g = rng.standard_normal((batch, n))
    g_old = g + s + 0.01 * rng.standard_normal((batch, n))
    kind = np.arange(batch) % 5 if kinds else np.zeros(batch, int)
    active = kind != 1
    fresh = kind == 2
    s[kind == 3] = -g[kind == 3]
    g_old[kind == 3] = 2.0 * g[kind == 3]
    g[kind == 4, 0] = np.nan
    out = [torch.tensor(a, dtype=dtype, device=device) for a in (B, s, g, g_old)]
    out += [torch.tensor(a, device=device) for a in (active, fresh)]
    return out, kind


def kernel_phase(device):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
        fused_bfgs_update_batched,
        fused_bfgs_update_reference,
    )

    rng = np.random.default_rng(BENCH_SEED)
    main_abs_err = None
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for n in (2, 7, 60, 61, 128):
            batch = BATCH if n == N else 512
            args, kind = kernel_inputs(rng, n, batch, dtype, device)
            kern = fused_bfgs_update_batched(*(a.clone() for a in args))
            plain = fused_bfgs_update_reference(*(a.clone() for a in args))
            torch.cuda.synchronize()
            check(torch.equal(kern[3], plain[3]), f"reset masks differ (n={n}, {dtype})")
            check(bool(kern[3][torch.tensor(kind == 3, device=device)].all()),
                  f"forced-reset lanes did not reset (n={n}, {dtype})")
            check(not bool(kern[3][torch.tensor(kind == 4, device=device)].any()),
                  f"NaN lanes reset (n={n}, {dtype})")
            frozen = torch.tensor(kind == 1, device=device)
            check(torch.equal(kern[0][frozen], args[0][frozen]),
                  f"frozen lanes' B changed (n={n}, {dtype})")
            abs_err = 0.0
            for name, a, b in zip(("B", "d", "m"), kern[:3], plain[:3]):
                check(torch.equal(torch.isnan(a), torch.isnan(b)), f"NaN pattern of {name} differs")
                ok = ~torch.isnan(b)
                err = float((a[ok] - b[ok]).abs().max())
                rel = err / float(b[ok].abs().max())
                abs_err = max(abs_err, err)
                key = (str(dtype).replace("torch.", ""), name)
                worst[key] = max(worst.get(key, 0.0), rel)
                check(rel <= KERNEL_RTOL[dtype],
                      f"{name} rel err {rel:.3e} > {KERNEL_RTOL[dtype]} (n={n}, {dtype})")
            if n == N and dtype == torch.float32:
                main_abs_err = abs_err
    summary = ", ".join(f"{d} {o} {r:.2e}" for (d, o), r in sorted(worst.items()))
    log(f"[kernel] B1 vs plain, n in (2, 7, 60, 61, 128), f32+f64, all lane kinds: "
        f"max normwise rel err {summary} (limits f32 {KERNEL_RTOL[torch.float32]}, "
        f"f64 {KERNEL_RTOL[torch.float64]}); max abs err at {BATCH}x{N} f32 {main_abs_err:.3e}")
    return main_abs_err


def bench_fleet(device):
    X = np.random.default_rng(BENCH_SEED).standard_normal((BATCH, N)).astype(np.float32)
    return torch.tensor(X, device=device)


def solve_bench(qt, X, kernel):
    from quasinewtonmethods_jl_tpu_torch.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    return qt.optimize_batched(
        rosenbrock_logdensity, X, tol=TOL, max_iterations=MAX_ITERS,
        value_and_grad_fn=rosenbrock_value_and_grad, kernel=kernel,
    )


def main_path_phase(qt, device):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import fused_bfgs_update_batched

    engine = qt.optimize_batched_fused
    X = bench_fleet(device)
    torch.cuda.synchronize()
    fused_bfgs_update_batched.launches = 0
    engine.host_syncs = engine.loop_bodies = 0
    # torch's sync debug mode flags every host-device synchronisation: each
    # must be one of the engine's counted control-flow reads
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = solve_bench(qt, X, "auto")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, bodies, syncs = (
        fused_bfgs_update_batched.launches, engine.loop_bodies, engine.host_syncs
    )
    flagged = sum("synchroniz" in str(w.message) for w in caught)
    check(launches > 0 and launches == bodies,
          f"kernel launches {launches} != loop bodies {bodies}")
    check(flagged == syncs, f"{flagged} synchronisations flagged, {syncs} counted")
    status = res.status.cpu().numpy()
    iters = res.iterations.cpu().numpy()
    hist = {qt.Status(s).name: int(c) for s, c in zip(*np.unique(status, return_counts=True))}
    converged = int((status == qt.Status.CONVERGED).sum())
    x_err = float((res.x - 1.0).abs().max())
    check(res.x.shape == (BATCH, N) and res.x.dtype == torch.float32, "result shape/dtype")
    check(bool(torch.isfinite(res.x).all()), "non-finite iterates")
    med, itmax = float(np.median(iters)), int(iters.max())
    log(f"[main] optimize_batched {BATCH}x{N} f32 on {device}: converged {converged}/{BATCH}, "
        f"status {hist}, iterations median {med:g} max {itmax} (JAX package on the same "
        f"inputs: median {JAX_MEDIAN_ITERS} max {JAX_MAX_ITERS}), max|x-1| {x_err:.3e}, "
        f"max|grad| {float(res.grad.abs().max()):.3e}, kernel launches {launches} = loop "
        f"bodies {bodies}, host syncs {syncs} (all the solve's synchronisations), "
        f"wall {wall:.3f}s (first call, sync debug mode on)")
    check(converged == BATCH, f"only {converged}/{BATCH} lanes converged")
    check(float(res.grad.abs().max()) < TOL, "gradient certificate not met")
    check(abs(med - JAX_MEDIAN_ITERS) <= 0.1 * JAX_MEDIAN_ITERS,
          f"median iterations {med} not within 10% of {JAX_MEDIAN_ITERS}")
    return launches, syncs


def parity_phase(qt, device):
    def quad_logdensity(x):
        diag = torch.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype, device=x.device)
        return -0.5 * torch.sum(diag * x * x)

    X = torch.tensor(np.random.default_rng(BENCH_SEED + 1).standard_normal((256, 6)),
                     device=device)
    a = qt.optimize_batched_fused(quad_logdensity, X, kernel="cuda")
    b = qt.optimize_batched_fused(quad_logdensity, X, kernel="torch")
    for name in ("status", "iterations", "n_fev", "n_gev", "n_resets"):
        check(torch.equal(getattr(a, name), getattr(b, name)), f"{name} differs cuda vs torch")
    dx = float((a.x - b.x).abs().max())
    check(dx <= 1e-10, f"x differs by {dx}")
    check(bool((a.status == qt.Status.CONVERGED).all()), "quadratic fleet did not converge")
    log(f"[parity] f64 quadratic fleet 256x6, kernel='cuda' vs 'torch': statuses and "
        f"counters equal, max|dx| {dx:.3e}")


def time_calls(fn, args, calls=20):
    """ms per call over ``calls`` back-to-back calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def timing_phase(qt, device, smi):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
        fused_bfgs_update_batched,
        fused_bfgs_update_reference,
    )

    # all lanes active and not fresh: the steady-state call of the main path
    args, _ = kernel_inputs(
        np.random.default_rng(BENCH_SEED + 2), N, BATCH, torch.float32, device, kinds=False
    )
    fns = {"cuda": fused_bfgs_update_batched, "torch": fused_bfgs_update_reference}
    for fn in fns.values():
        time_calls(fn, args, calls=3)  # warm-up
    ms = {k: [] for k in fns}
    for order in (("torch", "cuda"), ("cuda", "torch")) * 3:
        for k in order:
            ms[k].append(time_calls(fns[k], args))
    kernel_ms, plain_ms = float(np.median(ms["cuda"])), float(np.median(ms["torch"]))
    bytes_moved = 2 * BATCH * N * N * 4
    log(f"[time] B1 at {BATCH}x{N} f32: kernel {kernel_ms:.4f} ms/call "
        f"({bytes_moved / kernel_ms / 1e6:.0f} GB/s of B traffic), plain {plain_ms:.4f} ms/call "
        f"(median of 6 x 20 calls) on {smi}")

    X = bench_fleet(device)
    engine = qt.optimize_batched_fused
    solve_bench(qt, X, "torch")  # warm-up of the plain path
    walls = {"cuda": [], "torch": []}
    syncs = {}
    for order in (("torch", "cuda"), ("cuda", "torch")) * 2:
        for k in order:
            engine.host_syncs = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve_bench(qt, X, k)
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
            syncs[k] = engine.host_syncs
            check(bool((res.status == qt.Status.CONVERGED).all()), f"kernel={k} run did not converge")
    rate = {k: BATCH / float(np.median(v)) for k, v in walls.items()}
    log(f"[time] solves/s at {BATCH}x{N} f32 (median of 4 solves): kernel='cuda' {rate['cuda']:.1f} "
        f"({float(np.median(walls['cuda'])):.4f} s/solve, {syncs['cuda']} host syncs), "
        f"kernel='torch' {rate['torch']:.1f} ({float(np.median(walls['torch'])):.4f} s/solve, "
        f"{syncs['torch']} host syncs) on {smi}")
    return kernel_ms, plain_ms


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import quasinewtonmethods_jl_tpu_torch as qt

    device = torch.device("cuda", 0)
    name, smi = device_phase()
    build_phase()
    max_abs_err = kernel_phase(device)
    launches, _ = main_path_phase(qt, device)
    parity_phase(qt, device)
    kernel_ms, plain_ms = timing_phase(qt, device, smi)
    print(json.dumps({"kernels": [{
        "name": "fused_bfgs_update_batched",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
