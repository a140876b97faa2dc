#!/usr/bin/env python3
"""Smoke run of the PyTorch port (quasinewtonmethods_jl_tpu_torch) on one
NVIDIA GPU: builds the hand-written CUDA kernels, checks each against its
plain PyTorch version, and drives the port's three paths once at full
width: the BFGS fleet engine through `optimize_batched` on the benchmark
fleet (kernel B1), the same engine on a large-n fleet (the two-pass kernels
B2a and B2b), and the resident engine `optimize_batched_resident` (B3).

Phases (one summary line each on stdout, or a few; any failed check raises):
  1. device: name, CUDA version, ``nvidia-smi`` name and power limit;
  2. build: the kernel library from ``quasinewtonmethods_jl_tpu_torch/csrc``
     for sm_90a, one nvcc per source in parallel (nvcc's resource report
     goes to stderr);
  3. B1 against its plain version: f32 and f64, n in {2, 7, 33, 60, 61, 65,
     128} and the largest n that fits (237 f32, 167 f64), every lane kind
     (active, frozen, fresh, forced reset, NaN);
  4. main path: 4096 split-Rosenbrock n=60 solves in f32 (seed 20260816,
     analytic gradient, tol 1e-3, at most 3000 iterations) on cuda:0; every
     lane must converge, and every loop body must have launched B1;
  5. exact parity of B1 and the plain update on an f64 quadratic fleet;
  6. times: B1 and the plain version per call at 4096 x 60 f32 (B1 also
     by its device time per launch, torch.profiler; the run fails if the
     profiler records no launch), B1's share of its bound by each time and
     its launch shape (registers, threads, blocks per SM), and solves/s of
     phase 4 through each;
  7. B2 (each pass and the whole two-pass update) against its plain
     version: f32 and f64, n in {2, 7, 60, 250, 512}, every lane kind;
  8. large-n path: 1024 split-Rosenbrock n=512 solves in f32 (seed
     20260816, tol 1e-3, at most 3000 iterations) through `optimize_batched`,
     which must dispatch to B2 (both passes launched once per loop body, B1
     never); and an f64 64 x 200 fleet, B2 against the plain update;
  9. B3 against its plain version (the fleet engine with the plain update):
     f64 Rosenbrock fleets, n in {2, 5, 6, 17, 24, 60, 65}, and the phase-4
     fleet in f32, both line-search orders, h0 scaling on and off, caps 0,
     1, 5 and 3000; a tol 1e-14 run and an f32 overflow start; the errors
     and, over whole solves, the lanes whose counters differ, each against
     what a change of rounding alone does to the plain version (started 1
     ulp away; run on the CPU); and how fast a 1-ulp difference grows along
     a trajectory;
 10. resident path: `optimize_batched_resident` on the phase-4 fleet, one
     launch and no host synchronisation;
 11. times: B2 and each pass against the plain version at 1024 x 512 f32,
     B1 and B2 near their split (n in {128, 192, 232}, batch 1024), solves/s
     of the large-n fleet through B2 and the plain update, and of the
     benchmark fleet through B3, B1 and the plain update, with peak device
     memory; the device's busy time in one solve of each fleet-engine path
     (torch.profiler), and B3's time against fleet size (CUDA events), its
     share of its bound and its launch shape.
Then one JSON line of kernel records and, last, the JSON result line. Each
record's ``bound_ms`` is the least time the card could take for the
kernel's work on this run's inputs: the larger of the bytes it must move
(each input read once, each output written once) over 3.35 TB/s and the
floating-point operations its inputs need, however a kernel rounds (see
``update_ops``), over 67 TFLOP/s (H100 SXM, f32 outside the tensor
cores); ``ms`` is B1's device time per launch, B2's per call by CUDA
events, B3's per solve by CUDA events; ``library_ms`` is one PyTorch call
that computes the same function (B2a: ``torch.bmm``), null where none
does.

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
BLOCKED_SOURCE = "quasinewtonmethods_jl_tpu_torch/csrc/bfgs_blocked.cu"
MATVEC_REPLACES = "quasinewtonmethods_jl_tpu/ops/pallas/bfgs_blocked.py:236"
UPDATE_REPLACES = "quasinewtonmethods_jl_tpu/ops/pallas/bfgs_blocked.py:288"
RESIDENT_SOURCE = "quasinewtonmethods_jl_tpu_torch/csrc/resident_solve.cu"
RESIDENT_REPLACES = "quasinewtonmethods_jl_tpu/resident_solve.py:465"
# The large-n fleet. The JAX package on it (same seed and sizes,
# kernel="xla" on the CPU): 1024/1024 converged, median 172 and max 246.
LARGE_BATCH, LARGE_N = 1024, 512
JAX_LARGE_MEDIAN_ITERS, JAX_LARGE_MAX_ITERS = 172, 246
SPLIT_NS = (128, 192, 232)  # B1 fits up to n = 237 in f32
B1_NS = (2, 7, 33, 60, 61, 65, 128)  # one warp per lane up to 64; ragged bulk copies at 7, 33, 61, 65
B1_LARGEST_N = {torch.float32: 237, torch.float64: 167}
RESIDENT_NS = (2, 5, 6, 17, 24, 60, 65)  # one warp per lane up to n = 64, two at 65
# Published peaks of one H100 SXM: device memory and float32 outside the
# tensor cores (the kernels' type on the main path).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


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
    from quasinewtonmethods_jl_tpu_torch.ops.kernels._build import (
        NVCC_FLAGS,
        SOURCES,
        load_library,
    )

    t0 = time.perf_counter()
    lib = load_library()
    seconds = time.perf_counter() - t0
    print(lib.log, file=sys.stderr, flush=True)
    check("arch=compute_90a,code=sm_90a" in NVCC_FLAGS, "kernel not built for sm_90a")
    log(f"[build] {lib.path.name} from csrc/{{{', '.join(SOURCES)}}}: nvcc {lib.build_seconds:.2f}s, "
        f"load {seconds:.2f}s, flags {' '.join(NVCC_FLAGS)}")


def kernel_inputs(seed, n, batch, dtype, device, kinds=True):
    """Random SPD B, drawn on the card (at 1024 x 512 x 512 in f64 it is
    2 GB), and with ``kinds`` one of five lane kinds per lane (lane % 5):
    active, frozen, fresh, forced reset (s = -g, g_old = 2g: y = g,
    m_pre = -|g|²), NaN gradient. Without, every lane is active."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64, device=device)

    A = randn(batch, n, n) * 0.2
    B = torch.baddbmm(torch.eye(n, dtype=torch.float64, device=device), A, A.transpose(1, 2))
    del A
    s = randn(batch, n) * 0.1
    g = randn(batch, n)
    g_old = g + s + 0.01 * randn(batch, n)
    kind = torch.arange(batch, device=device) % 5 if kinds else torch.zeros(batch, device=device)
    active, fresh, forced = kind != 1, kind == 2, kind == 3
    s[forced] = -g[forced]
    g_old[forced] = 2.0 * g[forced]
    g[kind == 4, 0] = float("nan")
    return [t.to(dtype) for t in (B, s, g, g_old)] + [active, fresh], kind


def kernel_phase(device):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
        fused_bfgs_update_batched,
        fused_bfgs_update_reference,
    )

    main_abs_err = None
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for n in (*B1_NS, B1_LARGEST_N[dtype]):
            batch = BATCH if n == N else 512
            args, kind = kernel_inputs(BENCH_SEED + n, n, batch, dtype, device)
            kern = fused_bfgs_update_batched(*(a.clone() for a in args))
            plain = fused_bfgs_update_reference(*(a.clone() for a in args))
            torch.cuda.synchronize()
            check(torch.equal(kern[3], plain[3]), f"reset masks differ (n={n}, {dtype})")
            check(bool(kern[3][kind == 3].all()), f"forced-reset lanes did not reset (n={n}, {dtype})")
            check(not bool(kern[3][kind == 4].any()), f"NaN lanes reset (n={n}, {dtype})")
            frozen = kind == 1
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
    log(f"[kernel] B1 vs plain, n in {B1_NS} and the largest that fits ({B1_LARGEST_N[torch.float32]} "
        f"f32, {B1_LARGEST_N[torch.float64]} f64), f32+f64, all lane kinds: "
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


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` float32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def update_ops(n, updates, rank2, scaled):
    """Floating-point operations that ``updates`` active lanes' fused
    updates need, however a kernel rounds, where ``rank2`` of them change B
    by the rank-2 formula (the others reset it to I, which needs none) and
    ``scaled`` of those have a scale other than 1 (the update after a
    reset). Per update: the two matvecs (4n²) and the O(n) algebra around
    them (y and the four sums that need no B 9n, u n, the three sums after
    the matvecs 6n, d 6n, a = c1·s - u 2n: 24n). Per rank-2 change, written
    B[r, c] = scale·B[r, c] + s[r]·a[c] - u[r]·s[c]: 4 per element of B, 5
    where scaled (and the matvecs' scaling, 2n)."""
    return (updates * (4 * n * n + 24 * n) + rank2 * (4 * n * n)
            + scaled * (n * n + 2 * n))


def b1_bound(batch, n, itemsize, lanes_active, lanes_reset):
    """B1's bound on inputs with no fresh lane: active lanes read and write
    B and read step, g, g_old; every lane reads its two masks and writes d,
    m and reset."""
    nbytes = (lanes_active * (2 * n * n + 3 * n) * itemsize
              + batch * (2 + n * itemsize + itemsize + 1))
    return bound(nbytes, update_ops(n, lanes_active, lanes_active - lanes_reset, 0))


def b3_bound(res, n, itemsize, h0_scale):
    """B3's bound from the solve's own counters: it reads X0 and writes X,
    G, G_old, STEP, B and the per-lane scalars once. Per lane: n_gev
    value-and-gradient evaluations with the tolerance test (7n);
    iterations - 1 updates (the first iteration is the peel, which counts
    one reset), n_resets - 1 of which reset B; an update right after a
    reset is scaled (with h0_scale): there are n_resets of those less one
    where the last iteration reset (the fresh flag it ends with), and at
    least that less the resets are rank-2 changes; n_fev - n_gev
    line-search trials (6n); and a step per iteration (2n)."""
    batch = res.x.shape[0]
    iters = res.iterations.to(torch.float64)
    gev = res.n_gev.to(torch.float64)
    trials = res.n_fev.to(torch.float64) - gev
    n_resets = res.n_resets.to(torch.float64)
    updates = (iters - 1).clamp(min=0)
    resets = (n_resets - (iters > 0).to(torch.float64)).clamp(min=0)
    after_reset = n_resets - res.state.fresh.to(torch.float64)
    scaled = (after_reset - resets).clamp(min=0) * float(h0_scale)
    ops = (update_ops(n, updates, updates - resets, scaled)
           + gev * 7 * n + trials * 6 * n + iters * 2 * n)
    nbytes = batch * ((5 * n + n * n + 1) * itemsize + 6 * 4 + 1)
    return bound(nbytes, float(ops.sum()))


def shape_line(occupancy):
    return (f"{occupancy['registers']} registers x {occupancy['threads']} threads per block, "
            f"{occupancy['blocks_per_sm']} blocks per SM")


def device_ms_per_launch(fn, args, kernel_name, calls=20):
    """Mean device time of one launch of the kernel named ``kernel_name``
    over ``calls`` calls of ``fn``, from torch.profiler's device events: the
    kernel's own time, whatever the pace at which the host enqueues it.
    None where the profiler recorded no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel_name in e.name]
    return sum(spans) / len(spans) / 1e3 if spans else None


def timing_phase(qt, device, smi):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
        fused_bfgs_update_batched,
        fused_bfgs_update_reference,
        fused_update_occupancy,
    )

    # all lanes active and not fresh: the steady-state call of the main path
    args, _ = kernel_inputs(BENCH_SEED + 2, N, BATCH, torch.float32, device, kinds=False)
    lanes_reset = int(fused_bfgs_update_reference(*(a.clone() for a in args))[3].sum())
    fns = {"cuda": fused_bfgs_update_batched, "torch": fused_bfgs_update_reference}
    for fn in fns.values():
        time_calls(fn, args, calls=3)  # warm-up
    ms = {k: [] for k in fns}
    for order in (("torch", "cuda"), ("cuda", "torch")) * 3:
        for k in order:
            ms[k].append(time_calls(fns[k], args))
    call_ms, plain_ms = float(np.median(ms["cuda"])), float(np.median(ms["torch"]))
    # The wrapper's host time per call is about the kernel's, so back-to-back
    # calls can be paced by the host: the kernel's own time (the `ms` of its
    # record) comes from the profiler's device events (median of 3 x 20
    # launches). A run whose profiler misses the kernel fails rather than
    # report a time by the other method under the same name.
    device_ms = [device_ms_per_launch(fused_bfgs_update_batched, args, "bfgs_update_kernel")
                 for _ in range(3)]
    check(None not in device_ms, "torch.profiler recorded no launch of bfgs_update_kernel")
    kernel_ms = float(np.median(device_ms))
    bytes_moved = 2 * BATCH * N * N * 4
    bound_ms, bound_by = b1_bound(BATCH, N, 4, BATCH, lanes_reset)
    log(f"[time] B1 at {BATCH}x{N} f32: kernel {kernel_ms:.4f} ms (device time per launch, "
        f"torch.profiler; {bytes_moved / kernel_ms / 1e6:.0f} GB/s of B traffic), {call_ms:.4f} "
        f"ms per call by CUDA events over back-to-back calls, plain {plain_ms:.4f} ms/call (median "
        f"of 6 x 20 calls, in turns); bound {bound_ms:.4f} ms ({bound_by}; {lanes_reset} of "
        f"{BATCH} lanes reset), B1 at {100 * bound_ms / kernel_ms:.1f} % of it by device time, "
        f"{100 * bound_ms / call_ms:.1f} % by CUDA events per call; launch "
        f"{shape_line(fused_update_occupancy(N, 4))} on {smi}")

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
    return kernel_ms, plain_ms, (bound_ms, bound_by)


def counted_kernels():
    """The port's kernel wrappers, each counting its launches."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_blocked import (
        blocked_matvec,
        blocked_update,
    )
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import fused_bfgs_update_batched
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import resident_bfgs_solve

    return {"B1": fused_bfgs_update_batched, "B2a": blocked_matvec, "B2b": blocked_update,
            "B3": resident_bfgs_solve}


def reset_counters(qt):
    """Every kernel's launch count and the fleet engine's loop counts to 0."""
    for fn in counted_kernels().values():
        fn.launches = 0
    qt.optimize_batched_fused.host_syncs = qt.optimize_batched_fused.loop_bodies = 0


def read_counters(qt):
    counts = {name: fn.launches for name, fn in counted_kernels().items()}
    counts.update(bodies=qt.optimize_batched_fused.loop_bodies,
                  syncs=qt.optimize_batched_fused.host_syncs)
    return counts


def normwise_err(a, b):
    """(max |a - b|, that over max |b|) where both are finite; inf for both
    where one is not finite and the two differ (NaN matches NaN)."""
    finite = torch.isfinite(a) & torch.isfinite(b)
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if not bool((finite | same).all()):
        return float("inf"), float("inf")
    if not bool(finite.any()):
        return 0.0, 0.0
    err = float((a[finite] - b[finite]).abs().max())
    scale = float(b[finite].abs().max())
    return err, err / scale if scale else err


def blocked_kernel_phase(device):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_blocked import (
        blocked_matvec,
        blocked_matvec_reference,
        blocked_update,
        blocked_update_reference,
        fused_bfgs_update_blocked,
    )
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
        fused_bfgs_update_reference,
        update_algebra,
    )

    worst, main_err = {}, {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        for n in (2, 7, 60, 250, LARGE_N):
            batch = LARGE_BATCH if n == LARGE_N else 320
            (B, s, g, g_old, active, fresh), kind = kernel_inputs(
                BENCH_SEED + n, n, batch, dtype, device)
            where = f"(n={n}, {name})"
            y = g_old - g
            By, Bg = blocked_matvec(B, y, g)
            pBy, pBg = blocked_matvec_reference(B, y, g)
            errs = [normwise_err(By, pBy), normwise_err(Bg, pBg)]
            mv_abs, mv_rel = max(e[0] for e in errs), max(e[1] for e in errs)
            check(mv_rel <= KERNEL_RTOL[dtype], f"B2a rel err {mv_rel:.3e} {where}")
            alg = update_algebra(pBy, pBg, s, y, g, active, fresh)
            del By, Bg, pBy, pBg
            kB = blocked_update(B.clone(), s, alg.u, alg.c1, alg.scale, alg.do_upd, alg.reset)
            pB = blocked_update_reference(B.clone(), s, alg.u, alg.c1, alg.scale, alg.do_upd,
                                          alg.reset)
            check(torch.equal(kB.nan_to_num(), pB.nan_to_num())
                  and torch.equal(torch.isnan(kB), torch.isnan(pB)),
                  f"B2b differs from its plain pass {where}")
            up_abs = normwise_err(kB, pB)[0]
            del kB, pB, alg
            kern = fused_bfgs_update_blocked(B.clone(), s, g, g_old, active, fresh)
            check(torch.equal(kern[0][kind == 1], B[kind == 1]), f"frozen lanes' B changed {where}")
            check(bool(kern[3][kind == 3].all()), f"forced-reset lanes did not reset {where}")
            check(not bool(kern[3][kind == 4].any()), f"NaN lanes reset {where}")
            eye = torch.eye(n, dtype=dtype, device=device)
            check(bool((kern[0][kind == 3] == eye).all()), f"reset lanes' B is not I {where}")
            plain = fused_bfgs_update_reference(B, s, g, g_old, active, fresh)
            torch.cuda.synchronize()
            check(torch.equal(kern[3], plain[3]), f"reset masks differ {where}")
            for out, a, b in zip(("B", "d", "m"), kern[:3], plain[:3]):
                _, rel = normwise_err(a, b)
                worst[(name, out)] = max(worst.get((name, out), 0.0), rel)
                check(rel <= KERNEL_RTOL[dtype], f"B2 {out} rel err {rel:.3e} {where}")
            worst[(name, "By,Bg")] = max(worst.get((name, "By,Bg"), 0.0), mv_rel)
            if n == LARGE_N and dtype == torch.float32:
                main_err = {"B2a": mv_abs, "B2b": up_abs}
            del B, s, g, g_old, kern, plain
    summary = ", ".join(f"{d} {o} {r:.2e}" for (d, o), r in sorted(worst.items()))
    log(f"[kernel] B2 vs plain, n in (2, 7, 60, 250, {LARGE_N}) (batch {LARGE_BATCH} at "
        f"n={LARGE_N}), f32+f64, all lane kinds: max normwise rel err {summary} (limits "
        f"{KERNEL_RTOL[torch.float32]} / {KERNEL_RTOL[torch.float64]}: B2a sums each column "
        f"in row order, cuBLAS in its own); B2b equal to its plain pass bit for bit; frozen "
        f"lanes' B bit for bit; max abs err at {LARGE_BATCH}x{LARGE_N} f32: B2a "
        f"{main_err['B2a']:.3e}, B2b {main_err['B2b']:.3e}")
    return main_err


def large_fleet(device, dtype=torch.float32, batch=LARGE_BATCH, n=LARGE_N):
    X = np.random.default_rng(BENCH_SEED).standard_normal((batch, n))
    return torch.tensor(X, dtype=dtype, device=device)


def counters_equal(a, b):
    """Per lane (on the CPU): every counter of the two results equal."""
    same = torch.ones(a.status.shape, dtype=torch.bool)
    for name in ("status", "iterations", "n_fev", "n_gev", "n_resets"):
        same &= getattr(a, name).cpu() == getattr(b, name).cpu()
    for name in ("fresh", "stall"):
        same &= getattr(a.state, name).cpu() == getattr(b.state, name).cpu()
    return same


def large_n_phase(qt, device):
    from quasinewtonmethods_jl_tpu_torch.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    X = large_fleet(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counters(qt)
    t0 = time.perf_counter()
    res = solve_bench(qt, X, "auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counters(qt)
    check(c["bodies"] > 0 and c["B2a"] == c["bodies"] and c["B2b"] == c["bodies"],
          f"B2 launches {c['B2a']}/{c['B2b']} != loop bodies {c['bodies']}")
    check(c["B1"] == 0 and c["B3"] == 0, f"other kernels launched: {c}")
    status = res.status.cpu().numpy()
    iters = res.iterations.cpu().numpy()
    converged = int((status == qt.Status.CONVERGED).sum())
    med, itmax = float(np.median(iters)), int(iters.max())
    check(res.x.shape == (LARGE_BATCH, LARGE_N) and bool(torch.isfinite(res.x).all()),
          "large-n result shape or values")
    log(f"[large] optimize_batched {LARGE_BATCH}x{LARGE_N} f32 on {device}: dispatched to B2, "
        f"launches B2a {c['B2a']} = B2b {c['B2b']} = loop bodies {c['bodies']}, B1 {c['B1']}; "
        f"converged {converged}/{LARGE_BATCH}, iterations median {med:g} max {itmax} (JAX "
        f"package on the same inputs: median {JAX_LARGE_MEDIAN_ITERS} max {JAX_LARGE_MAX_ITERS}), "
        f"max|grad| {float(res.grad.abs().max()):.3e}, max|x-1| {float((res.x - 1).abs().max()):.3e}, "
        f"host syncs {c['syncs']}, wall {wall:.3f}s (first call), peak memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    check(converged == LARGE_BATCH, f"only {converged}/{LARGE_BATCH} lanes converged")
    check(float(res.grad.abs().max()) < TOL, "gradient certificate not met")
    check(abs(med - JAX_LARGE_MEDIAN_ITERS) <= 0.1 * JAX_LARGE_MEDIAN_ITERS,
          f"median iterations {med} not within 10% of {JAX_LARGE_MEDIAN_ITERS}")

    # f64 at n = 200, where B1 does not fit: B2 against the plain update
    X = large_fleet(device, torch.float64, 64, 200)
    runs = {}
    for kernel in ("cuda", "torch"):
        for cap in (5, MAX_ITERS):
            runs[kernel, cap] = qt.optimize_batched(
                rosenbrock_logdensity, X, tol=TOL, max_iterations=cap,
                value_and_grad_fn=rosenbrock_value_and_grad, kernel=kernel)
    short = counters_equal(runs["cuda", 5], runs["torch", 5])
    dx5 = float((runs["cuda", 5].x - runs["torch", 5].x).abs().max())
    a, b = runs["cuda", MAX_ITERS], runs["torch", MAX_ITERS]
    full = counters_equal(a, b)
    dx = float((a.x - b.x).abs().max())
    log(f"[large] f64 64x200 (B1 does not fit f64), kernel='cuda' (B2) vs 'torch': 5 iterations: "
        f"counters equal on {int(short.sum())}/64 lanes, max|dx| {dx5:.3e}; to convergence: "
        f"statuses equal {bool(torch.equal(a.status, b.status))}, converged {int(a.converged.sum())}"
        f" / {int(b.converged.sum())}, max|grad| {float(a.grad.abs().max()):.3e} / "
        f"{float(b.grad.abs().max()):.3e}, counters equal on {int(full.sum())}/64 lanes, max|dx| "
        f"{dx:.3e} (the trajectories separate: see the growth in the next phase)")
    check(bool(short.all()) and dx5 <= 1e-10, "B2 and the plain update differ in 5 iterations")
    check(torch.equal(a.status, b.status) and bool(a.converged.all()),
          "B2 and the plain update end differently")
    check(max(float(a.grad.abs().max()), float(b.grad.abs().max())) < TOL,
          "gradient certificate not met")
    return c


# B3 against its plain version. Over a few iterations (caps 0, 1, 5) the
# two follow one trajectory, so every counter must be equal on every lane
# and floats equal to rounding (normwise, max|diff| / max|plain| over x,
# grad and B: gradients reach ~1e3 on Rosenbrock): within 1e-10 in f64; in
# f32 within 1e-5 or, where more, within ROUNDING_FACTOR times what the
# plain version itself moves when torch sums in the CPU's order instead of
# the card's. Summed in another order, a difference in the last bit grows
# about tenfold every three iterations on these fleets, so over a whole
# solve the two trajectories separate: there both must end in the same
# status on every lane, pass the certificate, and in f64 converge to the
# same optimum within what the certificate allows (tol 1e-8 over
# Rosenbrock's smallest Hessian eigenvalue at 1⃗, ~0.4: 1e-6 is ample). The
# share of lanes whose counters then differ is held to what a change of
# rounding alone does to the plain version: the same run started 1 ulp
# away, and the same run on the CPU.
SHORT_CAPS = (0, 1, 5)
EXACT_RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
CONVERGED_DX = 1e-6
ROUNDING_FACTOR = 2  # B3 against the rounding witnesses: errors, and shares of lanes


def state_err(a, b):
    """(max abs, max normwise) difference of x, grad and B, on b's device."""
    errs = [normwise_err(getattr(a.state, f).to(getattr(b.state, f).device), getattr(b.state, f))
            for f in ("x", "grad", "B")]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def resident_parity_phase(qt, device):
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity
    from quasinewtonmethods_jl_tpu_torch.resident_solve import optimize_batched_resident_reference

    stall = qt.STALL_LIMIT_DEFAULT
    rows, failures = [], []
    groups = ("small", "main")  # the small fleets; the main path's shape (f32 bench fleet)
    # at short caps: max abs and max normwise error of B3, max normwise of the CPU witness
    exact = {g: [0.0, 0.0, 0.0] for g in groups}
    full_dx = 0.0
    witnesses = ("B3", "plain from x0 + 1 ulp", "plain on the CPU")
    diverged = {g: dict.fromkeys(witnesses, 0) for g in groups}
    full_lanes = dict.fromkeys(groups, 0)

    def compare(X, ls, tol, cap, h0_scale, label):
        nonlocal full_dx

        def plain_run(x0):
            return optimize_batched_resident_reference(x0, ls, tol, cap, h0_scale, stall)

        kern = qt.optimize_batched_resident(rosenbrock_logdensity, X, ls=ls, tol=tol,
                                            max_iterations=cap, h0_scale=h0_scale, kernel="cuda")
        plain = plain_run(X)
        same = counters_equal(kern, plain)
        err_abs, err_rel = state_err(kern, plain)
        statuses = bool(torch.equal(kern.status, plain.status))
        group = "main" if X.shape == (BATCH, N) else "small"
        rows.append((label, group, cap, int(same.sum()), X.shape[0], err_rel, statuses))
        if cap in SHORT_CAPS:
            limit = EXACT_RTOL[X.dtype]
            worst = exact[group]
            if group == "main" and cap > 0:
                witness = state_err(plain_run(X.cpu()), plain)[1]
                worst[2] = max(worst[2], witness)
                limit = max(limit, ROUNDING_FACTOR * witness)
            worst[0], worst[1] = max(worst[0], err_abs), max(worst[1], err_rel)
            ok = bool(same.all()) and err_rel <= limit
        else:
            ok = (statuses and bool(kern.converged.all())
                  and max(float(kern.grad.abs().max()), float(plain.grad.abs().max())) < tol)
            if X.dtype == torch.float64:
                dx = float((kern.x - plain.x).abs().max())
                full_dx = max(full_dx, dx)
                ok = ok and dx <= CONVERGED_DX
            nudged = torch.nextafter(X, torch.full_like(X, float("inf")))
            full_lanes[group] += X.shape[0]
            for key, other in zip(witnesses, (kern, plain_run(nudged), plain_run(X.cpu()))):
                diverged[group][key] += int((~counters_equal(other, plain)).sum())
        if not ok:
            failures.append(label)
        return kern, plain

    for n in RESIDENT_NS:
        X = torch.tensor(np.random.default_rng(BENCH_SEED + n).standard_normal((64, n)),
                         device=device)
        for order in (2, 3):
            for h0_scale in (True, False):
                for cap in (*SHORT_CAPS, MAX_ITERS):
                    compare(X, qt.BackTracking(order=order), 1e-8, cap, h0_scale,
                            f"f64 n={n} order={order} h0={int(h0_scale)} cap={cap}")
    X = torch.tensor(np.random.default_rng(BENCH_SEED).standard_normal((64, 6)), device=device)
    kern, _ = compare(X, qt.BackTracking(), 1e-14, 5, True, "tol=1e-14 cap=5")
    check(bool((kern.status == qt.Status.MAX_ITERATIONS).all()), "tol 1e-14 run did not hit the cap")
    X = torch.full((64, 6), 1e20, dtype=torch.float32, device=device)
    kern, _ = compare(X, qt.BackTracking(), TOL, 5, True, "f32 overflow start cap=5")
    check(bool((kern.status == qt.Status.NONFINITE_VALUE).all()) and bool(torch.isnan(kern.fun).all()),
          "overflow start did not end NONFINITE_VALUE with fun NaN")
    # the main path's shape and dtype: the phase-4 fleet in f32
    X = bench_fleet(device)
    for order in (2, 3):
        for h0_scale in (True, False):
            for cap in SHORT_CAPS:
                compare(X, qt.BackTracking(order=order), TOL, cap, h0_scale,
                        f"f32 {BATCH}x{N} order={order} h0={int(h0_scale)} cap={cap}")
    compare(X, qt.BackTracking(), TOL, MAX_ITERS, True, f"f32 {BATCH}x{N} cap={MAX_ITERS}")
    for label, _, _, same, batch, err, statuses in rows:
        print(f"  B3 vs plain {label}: counters equal {same}/{batch}, statuses equal {statuses}, "
              f"max normwise d(x, grad, B) {err:.3e}", file=sys.stderr)
    for group in groups:
        share = {k: v / full_lanes[group] for k, v in diverged[group].items()}
        witness = max(v for k, v in share.items() if k != "B3")
        if share["B3"] > ROUNDING_FACTOR * witness:
            failures.append(f"{group} fleets: B3's share of lanes with other counters "
                            f"{share['B3']:.3f} > {ROUNDING_FACTOR} x rounding's {witness:.3f}")
    # how a difference in the last bit grows along the trajectories
    X = torch.tensor(np.random.default_rng(6).standard_normal((64, 6)), device=device)
    growth = []
    for cap in (5, 10, 20, 40, 80):
        kern = qt.optimize_batched_resident(rosenbrock_logdensity, X, max_iterations=cap,
                                            h0_scale=False, kernel="cuda")
        plain = optimize_batched_resident_reference(X, qt.BackTracking(), 1e-8, cap, False,
                                                    qt.STALL_LIMIT_DEFAULT)
        growth.append(f"{cap}: {float((kern.x - plain.x).abs().max()):.1e}")

    def summary(group, limit):
        short = [r for r in rows if r[1] == group and r[2] in SHORT_CAPS]
        full = [r for r in rows if r[1] == group and r[2] not in SHORT_CAPS]
        lanes = full_lanes[group]
        return (f"caps {SHORT_CAPS}: {sum(r[3] == r[4] for r in short)}/{len(short)} runs with "
                f"every counter equal on every lane, max normwise d(x, grad, B) "
                f"{exact[group][1]:.3e} (limit {limit}), max abs {exact[group][0]:.3e}; "
                f"cap {MAX_ITERS}: statuses equal in {sum(r[6] for r in full)}/{len(full)} runs, "
                f"all converged; lanes whose counters differ from the plain run's: "
                + ", ".join(f"{k} {v}/{lanes} ({100 * v / lanes:.1f} %)"
                            for k, v in diverged[group].items())
                + f" (B3's share limit {ROUNDING_FACTOR} x the larger witness's)")

    log(f"[resident] B3 vs plain, f64 Rosenbrock 64 lanes, n in {RESIDENT_NS} x order "
        f"(2, 3) x h0 (on, off), tol 1e-8, plus tol 1e-14 and an f32 overflow start: "
        f"{summary('small', '1e-10 in f64, 1e-5 in f32')}; max|dx| at cap {MAX_ITERS} "
        f"{full_dx:.3e} (limit {CONVERGED_DX}); max|dx| after k iterations (n=6, h0 off) "
        f"{', '.join(growth)}")
    log(f"[resident] B3 vs plain on the main path's shape, f32 {BATCH}x{N} (seed {BENCH_SEED}, "
        f"tol {TOL}), order (2, 3) x h0 (on, off): "
        f"{summary('main', f'max({EXACT_RTOL[torch.float32]}, {ROUNDING_FACTOR} x the CPU run)')}; "
        f"the plain version on the CPU against it on the card at caps 1 and 5: max normwise "
        f"d(x, grad, B) {exact['main'][2]:.3e}")
    check(not failures, f"B3 and its plain version differ: {failures}")
    return exact["main"][0]


def resident_path_phase(qt, device):
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity

    X = bench_fleet(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counters(qt)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = qt.optimize_batched_resident(rosenbrock_logdensity, X, tol=TOL,
                                               max_iterations=MAX_ITERS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counters(qt)
    flagged = sum("synchroniz" in str(w.message) for w in caught)
    check(c["B3"] == 1 and c["B1"] == c["B2a"] == c["B2b"] == 0, f"launches {c}")
    check(flagged == 0, f"{flagged} host synchronisations inside the resident solve")
    status = res.status.cpu().numpy()
    iters = res.iterations.cpu().numpy()
    converged = int((status == qt.Status.CONVERGED).sum())
    med, itmax = float(np.median(iters)), int(iters.max())
    log(f"[resident] optimize_batched_resident {BATCH}x{N} f32 on {device}: launches B3 {c['B3']} "
        f"(B1/B2 0), host synchronisations 0; converged {converged}/{BATCH}, iterations median "
        f"{med:g} max {itmax} (JAX package: median {JAX_MEDIAN_ITERS} max {JAX_MAX_ITERS}), "
        f"max|grad| {float(res.grad.abs().max()):.3e}, max|x-1| {float((res.x - 1).abs().max()):.3e}, "
        f"wall {wall:.3f}s (first call), peak memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
    check(converged == BATCH, f"only {converged}/{BATCH} lanes converged")
    check(float(res.grad.abs().max()) < TOL, "gradient certificate not met")
    check(abs(med - JAX_MEDIAN_ITERS) <= 0.1 * JAX_MEDIAN_ITERS,
          f"median iterations {med} not within 10% of {JAX_MEDIAN_ITERS}")
    return c, b3_bound(res, N, 4, h0_scale=True)  # the entry point's default


def alternate(fns, rounds):
    """Median seconds of each of ``fns`` (name -> no-argument callable that
    ends with the device idle), run in turns, forward then backward, after
    one warm-up call each; also each one's peak device memory."""
    for fn in fns.values():
        fn()
    secs = {k: [] for k in fns}
    peak = {}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            secs[k].append(time.perf_counter() - t0)
            peak[k] = torch.cuda.max_memory_allocated()
    return {k: float(np.median(v)) for k, v in secs.items()}, peak


def per_call_ms(fns, args, rounds=4, calls=10):
    """Median ms per call of each of ``fns`` on ``args``, by CUDA events,
    in turns after a warm-up."""
    for fn in fns.values():
        time_calls(fn, args, calls=2)
    ms = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            ms[k].append(time_calls(fns[k], args, calls=calls))
    return {k: float(np.median(v)) for k, v in ms.items()}


def device_profile(fn, top=4):
    """Run ``fn`` once under torch.profiler (device activity only): its wall
    in s, the device's busy time in s (the union of the device events'
    intervals), the number of device events, and the ``top`` kernels by
    device time. Busy None where the profiler recorded no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return wall, None, 0, []
    busy, end, per_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        per_name[name] = per_name.get(name, 0.0) + (stop - start)
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return wall, busy * 1e-6, len(spans), [(name[:60], us * 1e-6) for name, us in ranked]


def profile_line(label, wall, busy, events, ranked, bodies):
    if busy is None:
        return f"[profile] {label}: wall {wall:.4f} s; device busy not measured (no device events)"
    kernels = ", ".join(f"{name} {s:.4f} s ({100 * s / busy:.1f} %)" for name, s in ranked)
    return (f"[profile] {label}: wall {wall:.4f} s (profiled), device busy {busy:.4f} s "
            f"({100 * (1 - busy / wall):.1f} % idle), {events} device events over {bodies} loop "
            f"bodies ({events / max(bodies, 1):.1f} per body); top: {kernels}")


def blocked_and_resident_timing_phase(qt, device, smi, b3_bounds):
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_blocked import (
        blocked_matvec,
        blocked_matvec_reference,
        blocked_update,
        blocked_update_reference,
        fused_bfgs_update_blocked,
    )
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
        fused_bfgs_update_batched,
        fused_bfgs_update_reference,
        update_algebra,
    )
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import resident_occupancy

    # B2 per call at the large-n shape: all lanes active and not fresh
    args, _ = kernel_inputs(BENCH_SEED + 3, LARGE_N, LARGE_BATCH, torch.float32, device,
                                   kinds=False)
    B, s, g, g_old, active, fresh = args
    y = g_old - g
    alg = update_algebra(*blocked_matvec_reference(B, y, g), s, y, g, active, fresh)
    upd_args = (B, s, alg.u, alg.c1, alg.scale, alg.do_upd, alg.reset)
    ms = per_call_ms({"cuda": fused_bfgs_update_blocked, "torch": fused_bfgs_update_reference}, args)
    yg = torch.stack([y, g], dim=1)  # the library call alone, without the stack
    mv = per_call_ms({"cuda": blocked_matvec, "torch": blocked_matvec_reference,
                      "library": lambda B, y, g: torch.bmm(yg, B)}, (B, y, g))
    up = per_call_ms({"cuda": blocked_update, "torch": blocked_update_reference}, upd_args)
    n, nn = LARGE_N, LARGE_N * LARGE_N
    # B2a reads B, y and g and writes By and Bg; B2b reads and writes B on
    # updated lanes, writes it on reset lanes, and reads s, u and the scalars
    upd_lanes, rst_lanes = int(alg.do_upd.sum()), int(alg.reset.sum())
    # (operations: B2a's two matvecs 4n² per lane; B2b's rank-2 change as in
    # update_ops, 4 per element of B plus a = c1·s - u, 5 where scaled)
    scaled_lanes = int((alg.do_upd & (alg.scale != 1)).sum())
    mv_bound = bound(LARGE_BATCH * (nn + 4 * n) * 4, LARGE_BATCH * 4 * nn)
    up_bound = bound((upd_lanes * 2 * nn + rst_lanes * nn) * 4
                     + LARGE_BATCH * (2 * n * 4 + 2 * 4 + 2),
                     upd_lanes * (4 * nn + 2 * n) + scaled_lanes * nn)
    peak = {}
    for k, fn in (("cuda", fused_bfgs_update_blocked), ("torch", fused_bfgs_update_reference)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(*args)
        torch.cuda.synchronize()
        peak[k] = (torch.cuda.max_memory_allocated() - base) / 2**30
    nbytes = LARGE_BATCH * LARGE_N * LARGE_N * 4
    log(f"[time] B2 at {LARGE_BATCH}x{LARGE_N} f32 per call: kernels {ms['cuda']:.4f} ms "
        f"({3 * nbytes / ms['cuda'] / 1e6:.0f} GB/s of B traffic over 3 passes; floor "
        f"{3 * nbytes / 3.35e12 * 1e3:.3f} ms at 3.35 TB/s), plain {ms['torch']:.4f} ms; B2a "
        f"{mv['cuda']:.4f} ms ({nbytes / mv['cuda'] / 1e6:.0f} GB/s) vs plain {mv['torch']:.4f} ms; "
        f"B2b {up['cuda']:.4f} ms ({2 * nbytes / up['cuda'] / 1e6:.0f} GB/s) vs plain "
        f"{up['torch']:.4f} ms; bounds B2a {mv_bound[0]:.4f} ms ({mv_bound[1]}, "
        f"{100 * mv_bound[0] / mv['cuda']:.1f} %), B2b {up_bound[0]:.4f} ms ({up_bound[1]}, "
        f"{100 * up_bound[0] / up['cuda']:.1f} %); torch.bmm alone (B2a's function, stacked "
        f"beforehand) {mv['library']:.4f} ms; memory a call allocates at its peak: kernels {peak['cuda']:.2f} "
        f"GiB, plain {peak['torch']:.2f} GiB (B itself {nbytes / 2**30:.2f} GiB) (median of 4 x "
        f"10 calls, in turns) on {smi}")
    del args, B, s, g, g_old, y, alg, upd_args

    split = []
    for n in SPLIT_NS:
        args, _ = kernel_inputs(BENCH_SEED + n, n, LARGE_BATCH, torch.float32, device,
                                       kinds=False)
        t = per_call_ms({"B1": fused_bfgs_update_batched, "B2": fused_bfgs_update_blocked,
                         "plain": fused_bfgs_update_reference}, args)
        split.append(f"n={n}: B1 {t['B1']:.4f}, B2 {t['B2']:.4f}, plain {t['plain']:.4f}")
    log(f"[time] B1 and B2 near their split, batch {LARGE_BATCH} f32, ms per call (CUDA events "
        f"over back-to-back calls: the host may pace B1's): "
        f"{'; '.join(split)} (B1 fits up to n=237) on {smi}")

    X = large_fleet(device)
    walls, peaks = alternate({k: (lambda k=k: solve_bench(qt, X, k)) for k in ("cuda", "torch")}, 2)
    log(f"[time] solves/s at {LARGE_BATCH}x{LARGE_N} f32 (median of 2 solves, in turns): "
        f"kernel='cuda' (B2) {LARGE_BATCH / walls['cuda']:.1f} ({walls['cuda']:.4f} s/solve, peak "
        f"{peaks['cuda'] / 2**30:.2f} GiB), kernel='torch' {LARGE_BATCH / walls['torch']:.1f} "
        f"({walls['torch']:.4f} s/solve, peak {peaks['torch'] / 2**30:.2f} GiB) on {smi}")
    qt.optimize_batched_fused.loop_bodies = 0
    prof = device_profile(lambda: solve_bench(qt, X, "cuda"))
    log(profile_line(f"large-n fleet {LARGE_BATCH}x{LARGE_N} f32 through B2", *prof,
                     qt.optimize_batched_fused.loop_bodies))
    del X

    X = bench_fleet(device)
    fns = {
        "B3": lambda: qt.optimize_batched_resident(rosenbrock_logdensity, X, tol=TOL,
                                                   max_iterations=MAX_ITERS),
        "B1": lambda: solve_bench(qt, X, "cuda"),
        "plain": lambda: solve_bench(qt, X, "torch"),
    }
    walls, peaks = alternate(fns, 4)
    log(f"[time] solves/s at {BATCH}x{N} f32 (median of 4 solves, in turns): resident B3 "
        f"{BATCH / walls['B3']:.1f} ({walls['B3']:.4f} s/solve, peak {peaks['B3'] / 2**20:.1f} "
        f"MiB), fleet engine with B1 {BATCH / walls['B1']:.1f} ({walls['B1']:.4f} s/solve, peak "
        f"{peaks['B1'] / 2**20:.1f} MiB), with the plain update {BATCH / walls['plain']:.1f} "
        f"({walls['plain']:.4f} s/solve, peak {peaks['plain'] / 2**20:.1f} MiB) on {smi}")
    qt.optimize_batched_fused.loop_bodies = 0
    prof = device_profile(fns["B1"])
    log(profile_line(f"bench fleet {BATCH}x{N} f32 through B1", *prof,
                     qt.optimize_batched_fused.loop_bodies))

    # B3 against fleet size, by CUDA events (no profiler): device time from
    # the solve's first operation to its last, beside the host's wall
    series = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for batch in (132, 264, 528, 1056, 1716, 2112, BATCH, 2 * BATCH):  # 1716 = 13 x 132
        Xb = torch.tensor(np.random.default_rng(BENCH_SEED).standard_normal((batch, N)),
                          dtype=torch.float32, device=device)
        times = []
        for _ in range(4):  # the first is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            res = qt.optimize_batched_resident(rosenbrock_logdensity, Xb, tol=TOL,
                                               max_iterations=MAX_ITERS)
            end.record()
            torch.cuda.synchronize()
            times.append((start.elapsed_time(end), 1e3 * (time.perf_counter() - t0)))
        check(bool((res.status == qt.Status.CONVERGED).all()), f"B3 at batch {batch} did not converge")
        dev, wall = (float(np.median(v)) for v in zip(*times[1:]))
        series.append(f"{batch} {dev:.3f} ms (wall {wall:.3f} ms, max iterations "
                      f"{int(res.iterations.max())})")
        if batch == BATCH:
            b3_ms = dev
    log(f"[profile] B3 against fleet size, n={N} f32 (median of 3 by CUDA events, device busy "
        f"from the solve's first op to its last): {'; '.join(series)} on {smi}")
    b3_bound_ms, b3_bound_by = b3_bounds
    log(f"[time] B3 at {BATCH}x{N} f32: {b3_ms:.4f} ms per solve (CUDA events), bound "
        f"{b3_bound_ms:.4f} ms ({b3_bound_by} the solve needs, from the main path's iterations, "
        f"evaluations and resets), "
        f"B3 at {100 * b3_bound_ms / b3_ms:.1f} % of it; launch {shape_line(resident_occupancy(N, 4))} "
        f"on {smi}")
    # the plain update's run is B3's plain version (optimize_batched_resident_reference)
    return {"B2a": (mv["cuda"], mv["torch"], *mv_bound, mv["library"]),
            "B2b": (up["cuda"], up["torch"], *up_bound, None),
            "B3": (b3_ms, 1e3 * walls["plain"], b3_bound_ms, b3_bound_by, None)}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import quasinewtonmethods_jl_tpu_torch as qt

    device = torch.device("cuda", 0)
    name, smi = device_phase()
    build_phase()
    max_abs_err = kernel_phase(device)
    reset_counters(qt)
    launches, _ = main_path_phase(qt, device)
    parity_phase(qt, device)
    kernel_ms, plain_ms, b1_bound_ms = timing_phase(qt, device, smi)
    blocked_err = blocked_kernel_phase(device)
    large = large_n_phase(qt, device)
    resident_err = resident_parity_phase(qt, device)
    resident, b3_bounds = resident_path_phase(qt, device)
    times = blocked_and_resident_timing_phase(qt, device, smi, b3_bounds)

    def record(name, source, replaces, launches, err, ms):
        kernel_ms, plain_ms, bound_ms, bound_by, library_ms = ms
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}

    print(json.dumps({"kernels": [
        record("fused_bfgs_update_batched", KERNEL_SOURCE, KERNEL_REPLACES, launches,
               max_abs_err, (kernel_ms, plain_ms, *b1_bound_ms, None)),
        record("blocked_matvec", BLOCKED_SOURCE, MATVEC_REPLACES, large["B2a"],
               blocked_err["B2a"], times["B2a"]),
        record("blocked_update", BLOCKED_SOURCE, UPDATE_REPLACES, large["B2b"],
               blocked_err["B2b"], times["B2b"]),
        record("resident_bfgs_solve", RESIDENT_SOURCE, RESIDENT_REPLACES, resident["B3"],
               resident_err, times["B3"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
