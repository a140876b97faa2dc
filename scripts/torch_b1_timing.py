#!/usr/bin/env python3
"""Times the PyTorch port's fused update B1 (`fused_bfgs_update_batched`)
at the bench fleet's shape, 4096 x 60 f32 with every lane active and not
fresh (the main path's steady-state call, the inputs of chip_smoke.py's
phase 6), by both of chip_smoke.py's methods:

  - ms per call by CUDA events over 20 back-to-back calls (median of 6);
  - device time per launch from torch.profiler's device events (median of
    3 x 20 launches); a run fails if the profiler records no launch;

and the resident solve B3 on the bench fleet itself (4096 split-Rosenbrock
n = 60 solves, f32, tol 1e-3, through `optimize_batched_resident`, one
launch each): ms per solve by CUDA events over 5 back-to-back solves
(median of 6).

Each checkout named on the command line is timed in a process of its own,
in the order given, so that two versions can be compared on one card in
turns:

    python3 scripts/torch_b1_timing.py OTHER . . OTHER

where OTHER is another checkout of the repo (for example an earlier commit
unpacked by `git archive` into a git-ignored directory). The inputs and the
timing helpers are this checkout's chip_smoke.py; only the package under
test comes from each checkout. Prints the card's name and power limit, one
JSON line per run, and last one JSON line with each checkout's medians and
shares of B1's bound. Needs one CUDA card and nvcc.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_helpers():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_one(root):
    """One checkout's B1 times, as a dict."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_b1_timing: torch.cuda.is_available() is False; this needs a CUDA card")
    sys.path.insert(0, os.path.abspath(root))
    from quasinewtonmethods_jl_tpu_torch.ops.kernels import bfgs_kernel

    cs = smoke_helpers()
    device = torch.device("cuda", 0)
    args, _ = cs.kernel_inputs(cs.BENCH_SEED + 2, cs.N, cs.BATCH, torch.float32, device,
                               kinds=False)
    lanes_reset = int(bfgs_kernel.fused_bfgs_update_reference(*(a.clone() for a in args))[3].sum())
    fn = bfgs_kernel.fused_bfgs_update_batched
    cs.time_calls(fn, args, calls=3)  # build and warm-up
    events = [cs.time_calls(fn, args) for _ in range(6)]
    device_ms = [cs.device_ms_per_launch(fn, args, "bfgs_update_kernel") for _ in range(3)]
    cs.check(None not in device_ms, "torch.profiler recorded no launch of bfgs_update_kernel")
    bound_ms, bound_by = cs.b1_bound(cs.BATCH, cs.N, 4, cs.BATCH, lanes_reset)

    from quasinewtonmethods_jl_tpu_torch import optimize_batched_resident
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity

    X = cs.bench_fleet(device)

    def b3():
        return optimize_batched_resident(rosenbrock_logdensity, X, tol=cs.TOL,
                                         max_iterations=cs.MAX_ITERS)

    cs.time_calls(b3, (), calls=2)  # warm-up
    b3_runs = [cs.time_calls(b3, (), calls=5) for _ in range(6)]
    return {"root": root, "package": os.path.dirname(bfgs_kernel.__file__),
            "events_ms": float(np.median(events)), "events_runs": events,
            "device_ms": float(np.median(device_ms)), "device_runs": device_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "b3_ms": float(np.median(b3_runs)), "b3_runs": b3_runs}


def main(roots):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    runs = []
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            sys.exit(f"torch_b1_timing: the run of {root} failed (exit {out.returncode})")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary, b3 = {}, {}
    for root in dict.fromkeys(roots):
        mine = [r for r in runs if r["root"] == root]
        ev = sorted(r["events_ms"] for r in mine)
        dv = sorted(r["device_ms"] for r in mine)
        bound_ms = mine[0]["bound_ms"]
        summary[root] = {"events_ms": ev, "device_ms": dv,
                         "share_by_events": [bound_ms / t for t in ev],
                         "share_by_device": [bound_ms / t for t in dv],
                         "bound_ms": bound_ms, "bound_by": mine[0]["bound_by"]}
        b3[root] = {"ms_per_solve": sorted(r["b3_ms"] for r in mine)}
    print(json.dumps({"card": smi.splitlines()[0], "b1": summary, "b3": b3}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(time_one(sys.argv[2])), flush=True)
    elif len(sys.argv) > 1:
        main(sys.argv[1:])
    else:
        sys.exit(__doc__)
