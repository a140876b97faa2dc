#!/usr/bin/env python3
"""Digests of the resident kernel B3's results, to show that a change of
its source left an instantiation's arithmetic as it was.

For each of the seven hand-written instantiations one fixed solve runs on
the card through `optimize_batched_resident(kernel="cuda")`,
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
    with numpy from seed 20260836, tol 1e-6;

and for the four fixture instantiations, each over 64 starts from numpy
seed 20260816 + n:

  - funnel f64: n = 4, N(0, 1) starts, tol 1e-6;
  - mixture f32: 8 components at n = 60, means and starts 3·N(0, 1),
    sigma 4, tol 1e-3;
  - poisson f32: n = 50, 400 observations (X = N(0, 1)/sqrt(n), y =
    Poisson(exp(X w)), w = 0.5·N(0, 1)), prior scale 10, tol 1e-2;
  - ar1 f64: n = 8, 32 steps, A scaled to spectral radius 0.6, observation
    scale 0.5, prior scale 10, tol 1e-6.

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
        AR1DriftMAP,
        GaussianMixture,
        IllConditionedQuadratic,
        LogisticRegressionMAP,
        PoissonRegressionMAP,
        funnel_logdensity,
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

    rng = np.random.default_rng(SEED + 4)
    X = torch.tensor(rng.standard_normal((64, 4)), dtype=f64, device=device)
    solve("funnel f64", funnel_logdensity, X, 1e-6, funnel_logdensity)

    rng = np.random.default_rng(SEED + 60)
    mixture = GaussianMixture(3.0 * rng.standard_normal((8, 60)), sigmas=4.0, dtype=f32,
                              device=device)
    X = torch.tensor(3.0 * rng.standard_normal((64, 60)), dtype=f32, device=device)
    solve("mixture f32", mixture, X, 1e-3, mixture)

    rng = np.random.default_rng(SEED + 50)
    Xd = rng.standard_normal((400, 50)) / np.sqrt(50)
    yd = rng.poisson(np.exp(Xd @ (0.5 * rng.standard_normal(50)))).astype(np.float64)
    poisson = PoissonRegressionMAP(50, 400, prior_scale=10.0, X=Xd, y=yd, dtype=f32,
                                   device=device)
    X = torch.tensor(rng.standard_normal((64, 50)), dtype=f32, device=device)
    solve("poisson f32", poisson, X, 1e-2, poisson)

    rng = np.random.default_rng(SEED + 8)
    A = rng.standard_normal((8, 8))
    A = A * (0.6 / np.max(np.abs(np.linalg.eigvals(A))))
    w_true, z, zs = rng.standard_normal(8), np.zeros(8), []
    for _ in range(32):
        z = A @ z + w_true
        zs.append(z)
    ys = np.stack(zs) + 0.5 * rng.standard_normal((32, 8))
    ar1 = AR1DriftMAP(8, 32, spectral_radius=0.6, obs_scale=0.5, prior_scale=10.0, A=A, ys=ys,
                      dtype=f64, device=device)
    X = torch.tensor(rng.standard_normal((64, 8)), dtype=f64, device=device)
    solve("ar1 f64", ar1, X, 1e-6, ar1)
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
