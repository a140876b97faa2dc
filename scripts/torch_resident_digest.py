#!/usr/bin/env python3
"""Digests of the resident kernel B3's results, to show that a change of
its source left an instantiation's arithmetic as it was.

For each of the instantiations older than the GLM row loop (split
Rosenbrock, ill-conditioned quadratic, logistic-regression MAP) one fixed
solve runs on the card through `optimize_batched_resident(kernel="cuda")`,
and the SHA-256 of every output (the counters, fresh, stall, x, grad, B,
fun, as bytes in that order) is printed with the instantiation's
registers per thread (`resident_occupancy`):

  - rosenbrock: the bench fleet, 4096 x 60 f32 standard_normal starts from
    numpy seed 20260816, tol 1e-3;
  - quadratic: 64 x 60 f32, condition 1e4, x* and starts from numpy seed
    20260876, tol 1e-3;
  - logistic f32: BASELINE config 3's posterior and its 4096 starts as
    chip_smoke.py's `logistic_data` draws them, tol 3e-3;
  - logistic f64: 64 x 20, 500 observations drawn by the model's recipe
    with numpy from seed 20260836, tol 1e-6.

Each checkout named on the command line runs in a process of its own, so
that two versions can be compared on one card:

    python3 scripts/torch_resident_digest.py OTHER .

where OTHER is another checkout of the repo (for example an earlier commit
unpacked by `git archive` into a git-ignored directory). Prints one JSON
line per checkout. The kernels use no atomics and sum in a fixed order, so
one build gives the same bytes on every run; another CUDA toolkit may
round its exp and log differently. Needs one CUDA card and nvcc.
"""

import hashlib
import json
import os
import subprocess
import sys

SEED = 20260816


def _digest(res):
    import torch

    h = hashlib.sha256()
    for t in (res.status, res.iterations, res.n_fev, res.n_gev, res.n_resets,
              res.state.fresh, res.state.stall, res.x, res.grad, res.state.B, res.fun):
        h.update(t.detach().to("cpu").contiguous().numpy().tobytes())
    return h.hexdigest()


def digests(device):
    """{instantiation: (sha256 of the solve's outputs, registers per thread)}
    for the fixed solves above, on ``device`` (a CUDA device)."""
    import numpy as np
    import torch

    import quasinewtonmethods_jl_tpu_torch as qt
    from quasinewtonmethods_jl_tpu_torch.models import (
        IllConditionedQuadratic,
        LogisticRegressionMAP,
        rosenbrock_logdensity,
    )
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import resident_occupancy

    f32, f64 = torch.float32, torch.float64
    out = {}

    def solve(name, model, X, tol, objective):
        res = qt.optimize_batched_resident(model, X, tol=tol, max_iterations=3000,
                                           kernel="cuda")
        torch.cuda.synchronize()
        occ = resident_occupancy(X.shape[1], X.element_size(), objective)
        out[name] = (_digest(res), occ["registers"])

    rng = np.random.default_rng(SEED)
    X = torch.tensor(rng.standard_normal((4096, 60)), dtype=f32, device=device)
    solve("rosenbrock f32", rosenbrock_logdensity, X, 1e-3, None)

    rng = np.random.default_rng(SEED + 60)
    quad = IllConditionedQuadratic(60, condition=1e4, x_star=rng.standard_normal(60), dtype=f32,
                                   device=device)
    X = torch.tensor(rng.standard_normal((64, 60)), dtype=f32, device=device)
    solve("quadratic f32", quad, X, 1e-3, quad)

    rng = np.random.default_rng(SEED)  # chip_smoke.py :: logistic_data
    Xd = rng.standard_normal((500, 100)) / np.sqrt(100)
    w_true = rng.standard_normal(100)
    yd = (rng.random(500) < 1.0 / (1.0 + np.exp(-(Xd @ w_true)))).astype(np.float64)
    starts = rng.standard_normal((4096, 100))
    logistic = LogisticRegressionMAP(100, 500, prior_scale=10.0, X=Xd, y=yd, dtype=f32,
                                     device=device)
    solve("logistic f32", logistic, torch.tensor(starts, dtype=f32, device=device), 3e-3,
          logistic)

    rng = np.random.default_rng(SEED + 20)
    Xd = rng.standard_normal((500, 20)) / np.sqrt(20)
    yd = (rng.random(500) < 1.0 / (1.0 + np.exp(-(Xd @ rng.standard_normal(20))))).astype(float)
    logistic = LogisticRegressionMAP(20, 500, X=Xd, y=yd, dtype=f64, device=device)
    X = torch.tensor(rng.standard_normal((64, 20)), dtype=f64, device=device)
    solve("logistic f64", logistic, X, 1e-6, logistic)
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        import torch

        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        if not torch.cuda.is_available():
            sys.exit("torch_resident_digest: torch.cuda.is_available() is False")
        print(json.dumps({"checkout": sys.argv[2],
                          "digests": digests(torch.device("cuda", 0))}), flush=True)
        return
    for root in sys.argv[1:] or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)


if __name__ == "__main__":
    main()
