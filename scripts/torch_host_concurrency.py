"""Do two host-bound solve streams overlap on one CUDA card?

`chip_smoke.py` runs phase 16's float32 starts (scalar `optimize`, DFP)
beside the plain runs it makes ahead while its kernels build. Both are
host-bound: the card idles between small kernels. This script times each
alone, then both at once, first as two threads of one process (they share
the interpreter's lock), then as two processes on the card:

    python3 scripts/torch_host_concurrency.py

It prints the seconds of each stream alone, in threads and in processes.
Needs a CUDA card; run from the repo root.
"""

import os
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import quasinewtonmethods_jl_tpu_torch as qt  # noqa: E402
from quasinewtonmethods_jl_tpu_torch.models import (  # noqa: E402
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)
from quasinewtonmethods_jl_tpu_torch.resident_solve import (  # noqa: E402
    optimize_batched_resident_reference,
)

DEVICE = torch.device("cuda", 0)


def starts(count=3):
    """``count`` of phase 16's float32 DFP starts, one after the other: s."""
    kw = dict(tol=cs.TOL, value_and_grad_fn=rosenbrock_value_and_grad)
    t0 = time.perf_counter()
    for x0 in cs.scalar_starts(count, DEVICE):
        qt.optimize(rosenbrock_logdensity, x0, update_method="dfp", h0_scale=False,
                    max_iterations=cs.MAX_ITERS, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def plain():
    """Phase 9's plain whole solves at n = 17, 24, 60 (64 lanes, f64): s."""
    t0 = time.perf_counter()
    for n in (17, 24, 60):
        X = torch.tensor(np.random.default_rng(cs.BENCH_SEED + n).standard_normal((64, n)),
                         device=DEVICE)
        optimize_batched_resident_reference(X, qt.BackTracking(), 1e-8, cs.MAX_ITERS, True,
                                            qt.STALL_LIMIT_DEFAULT)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def child(tag):
    """The second process: warm up, say so, wait for the go, time the starts."""
    starts(1)
    open(tag + ".ready", "w").close()
    while not os.path.exists(tag + ".go"):
        time.sleep(0.01)
    print(f"second process: starts {starts():.2f} s", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_host_concurrency: needs a CUDA card")
    starts(1), plain()  # warm-up
    for turn in (1, 2):
        print(f"alone, turn {turn}: starts {starts():.2f} s, plain {plain():.2f} s", flush=True)
    out = {}
    thread = threading.Thread(target=lambda: out.update(s=starts()))
    t0 = time.perf_counter()
    thread.start()
    p = plain()
    thread.join()
    print(f"two threads: starts {out['s']:.2f} s, plain {p:.2f} s, both "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tag = os.path.join(tmp, "second")
        proc = subprocess.Popen([sys.executable, __file__, "--child", tag])
        try:
            while not os.path.exists(tag + ".ready"):
                time.sleep(0.01)
            t0 = time.perf_counter()
            open(tag + ".go", "w").close()
            p = plain()
            proc.wait()
        finally:
            proc.kill()
    print(f"two processes: plain {p:.2f} s, both {time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        main()
