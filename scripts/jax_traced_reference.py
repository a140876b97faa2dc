#!/usr/bin/env python3
"""The JAX package's counts on the full-width fleets of `chip_smoke.py`'s
phase 22 (B3 on traced objectives), which `chip_smoke.py` keeps as
constants (the machine with the card has no JAX).

Four fleets, each drawn with numpy from a fresh
``numpy.random.default_rng(20260816)`` in the order below, so that both
packages get the same arrays (`chip_smoke.py` draws them the same way),
all float32 (x64 off), at most 3000 iterations:
  1. the bench fleet: the split Rosenbrock, starts
     standard_normal((4096, 60)), tol 1e-3 (the port passes it as
     ``lambda x: rosenbrock_logdensity(x)``);
  2. BASELINE config 3's logistic posterior (n = 100, 500 observations,
     prior scale 10): X = standard_normal((500, 100)) / sqrt(100), w_true =
     standard_normal(100), y = 1[random(500) < σ(X w_true)], then starts
     standard_normal((4096, 100)), tol 3e-3 (the port passes the model's
     bound ``logdensity``);
  3. ROADMAP B.1's dense quadratic form -0.5·x@(Q@x) + b@x at n = 232, the
     largest n one lane of B3 holds for the traced form in float32: U from
     the QR of standard_normal((232, 232)), Q = U diag(logspace(-4, 0, 232))
     Uᵀ (config 2's spectrum, condition 1e4, models/quadratic.py:27-29),
     x* = standard_normal(232), b = Q x*, then starts
     standard_normal((1024, 232)), tol 1e-3; Q and b are computed in
     float64 and cast;
  4. the Gaussian mixture of 8 components at n = 60, sigma 4, uniform
     weights: means 3·standard_normal((8, 60)), then starts
     3·standard_normal((4096, 60)), tol 1e-3 (the port passes the model's
     bound ``logdensity``).
Every fleet goes through `optimize_batched_fused` (kernel "xla",
BackTracking) on the CPU: the engine the port's resident kernel and fleet
engine are held to. One JSON line per fleet (a few minutes on a CPU).

    JAX_PLATFORMS=cpu python scripts/jax_traced_reference.py
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import quasinewtonmethods_jl_tpu as qnm  # noqa: E402
from quasinewtonmethods_jl_tpu.batched_solve import optimize_batched_fused  # noqa: E402
from quasinewtonmethods_jl_tpu.models import (  # noqa: E402
    GaussianMixture,
    LogisticRegressionMAP,
    rosenbrock_logdensity,
)

SEED = 20260816
MAX_ITERS = 3000
QUAD_BATCH, QUAD_N = 1024, 232


def dense_quadratic_data(rng, n=QUAD_N, batch=QUAD_BATCH):
    """Q, b and the starts, float64, as chip_smoke.py draws them."""
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Q = (U * np.logspace(-4.0, 0.0, n)) @ U.T
    b = Q @ rng.standard_normal(n)
    return Q, b, rng.standard_normal((batch, n))


def fleets():
    """(name, objective, float32 starts, tol) of the four fleets."""
    f32 = jnp.float32
    rng = np.random.default_rng(SEED)
    yield "rosenbrock 4096x60", rosenbrock_logdensity, rng.standard_normal((4096, 60)), 1e-3

    rng = np.random.default_rng(SEED)
    X = rng.standard_normal((500, 100)) / np.sqrt(100)
    w_true = rng.standard_normal(100)
    y = (rng.random(500) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    model = LogisticRegressionMAP(100, 500, prior_scale=10.0, dtype=f32)
    model.X, model.y = jnp.asarray(X, f32), jnp.asarray(y, f32)
    yield "logistic 4096x100", model.logdensity, rng.standard_normal((4096, 100)), 3e-3

    Q, b, starts = dense_quadratic_data(np.random.default_rng(SEED))
    Qj, bj = jnp.asarray(Q, f32), jnp.asarray(b, f32)
    yield (f"dense quadratic {QUAD_BATCH}x{QUAD_N}", lambda x: -0.5 * x @ (Qj @ x) + bj @ x,
           starts, 1e-3)

    rng = np.random.default_rng(SEED)
    means = 3.0 * rng.standard_normal((8, 60))
    mixture = GaussianMixture(jnp.asarray(means, f32), sigmas=4.0)
    yield "mixture 4096x60", mixture.logdensity, 3.0 * rng.standard_normal((4096, 60)), 1e-3


def main():
    for name, obj, starts, tol in fleets():
        t0 = time.perf_counter()
        res = optimize_batched_fused(obj, jnp.asarray(starts, jnp.float32), tol=tol,
                                     max_iterations=MAX_ITERS, kernel="xla")
        status = np.asarray(res.status)
        iters = np.asarray(res.iterations)
        print(json.dumps({
            "fleet": name, "tol": tol, "cpu_seconds": round(time.perf_counter() - t0, 2),
            "converged": int((status == int(qnm.Status.CONVERGED)).sum()),
            "statuses": {int(s): int((status == s).sum()) for s in np.unique(status)},
            "median": float(np.median(iters)), "max": int(iters.max()),
            "median_n_fev": float(np.median(np.asarray(res.n_fev))),
        }), flush=True)


if __name__ == "__main__":
    main()
