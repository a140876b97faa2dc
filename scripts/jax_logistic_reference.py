#!/usr/bin/env python3
"""The JAX package's iteration counts on the logistic-regression MAP inputs
of `chip_smoke.py`'s phase 20, which `chip_smoke.py` keeps as constants
(the machine with the card has no JAX).

The data are BASELINE config 3's posterior (n = 100 weights, 500
observations, prior scale 10), drawn with numpy so that both packages get
the same arrays: ``rng = numpy.random.default_rng(20260816)``, then X =
rng.standard_normal((500, 100)) / sqrt(100), w_true =
rng.standard_normal(100), y = 1[rng.random(500) < σ(X w_true)], and the
fleet's starts rng.standard_normal((4096, 100)), in that order
(`chip_smoke.py :: logistic_data` draws them the same way). A JAX
`LogisticRegressionMAP` is built and then given that X and y. Everything
runs in float32 (x64 off) on the CPU, at tol 3e-3 (bench_full.py:87-93's
float32 tolerance):
  * the fleet engine `optimize_batched_fused` (kernel "xla", BackTracking,
    at most 3000 iterations) from the 4096 starts: the engine the resident
    kernel is held to lane for lane;
  * the scalar `optimize` from zeros(100), as bench_full.py's config 3.
One JSON line per run (about a minute on a CPU).

    JAX_PLATFORMS=cpu python scripts/jax_logistic_reference.py
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
from quasinewtonmethods_jl_tpu.models import LogisticRegressionMAP  # noqa: E402

SEED = 20260816
N, N_OBS, BATCH, PRIOR_SCALE, TOL = 100, 500, 4096, 10.0, 3e-3


def logistic_data(rng):
    """X, y and the starts, as chip_smoke.py draws them (float64)."""
    X = rng.standard_normal((N_OBS, N)) / np.sqrt(N)
    w_true = rng.standard_normal(N)
    y = (rng.random(N_OBS) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    starts = rng.standard_normal((BATCH, N))
    return X, y, starts


def emit(name, t0, **fields):
    print(json.dumps({"run": name, "cpu_seconds": round(time.perf_counter() - t0, 2), **fields}),
          flush=True)


def main():
    X, y, starts = logistic_data(np.random.default_rng(SEED))
    model = LogisticRegressionMAP(N, N_OBS, prior_scale=PRIOR_SCALE, dtype=jnp.float32)
    model.X = jnp.asarray(X, jnp.float32)
    model.y = jnp.asarray(y, jnp.float32)

    t0 = time.perf_counter()
    res = optimize_batched_fused(model, jnp.asarray(starts, jnp.float32), tol=TOL,
                                 max_iterations=3000)
    iters = np.asarray(res.iterations)
    status = np.asarray(res.status)
    emit(f"optimize_batched_fused logistic {BATCH}x{N}", t0,
         converged=int((status == int(qnm.Status.CONVERGED)).sum()),
         statuses={int(s): int((status == s).sum()) for s in np.unique(status)},
         median=float(np.median(iters)), max=int(iters.max()),
         median_n_fev=float(np.median(np.asarray(res.n_fev))))

    t0 = time.perf_counter()
    res = qnm.optimize(model, jnp.zeros(N, jnp.float32), tol=TOL)
    emit(f"optimize logistic n={N} from zeros", t0, status=int(res.status),
         iterations=int(res.iterations), n_fev=int(res.n_fev))


if __name__ == "__main__":
    main()
