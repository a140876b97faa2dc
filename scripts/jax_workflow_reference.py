#!/usr/bin/env python3
"""The JAX package's numbers for `chip_smoke.py`'s phase 31 (the one-call
pipeline `map_then_sample`), which `chip_smoke.py` keeps as constants
(the machine with the card has no JAX).

BASELINE config 3's logistic posterior (n = 100 weights, 500 observations,
prior scale 10) and the fleet's 4096 starts, drawn with numpy as
`chip_smoke.py :: logistic_data` draws them (``numpy.random.default_rng(
20260816)``: X, w_true, y, then the starts), in float32 (x64 off) on the
CPU, through phase 31's plan:

    map_then_sample(model, PRNGKey(20260816), starts, map_engine="bfgs",
                    map_tol=3e-3, sampler="hmc", n_warmup=100,
                    n_samples=16, n_leapfrog=16, compute_evidence="bridge")

It prints one JSON line: the MAP stage's converged count and median / max
iterations (JAX's ``backend="auto"`` runs the fleet through ``vmap`` off
the TPU, `parallel/batch.py:101-103`), the same fleet through
``backend="fused"`` (the engine the port's ``"auto"`` picks), the largest
split R-hat of the draws and the bridge's logZ. Takes ~1 min on a CPU:

    JAX_PLATFORMS=cpu python scripts/jax_workflow_reference.py
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import quasinewtonmethods_jl_tpu as qnm  # noqa: E402
from quasinewtonmethods_jl_tpu.models import LogisticRegressionMAP  # noqa: E402

SEED = 20260816
N, N_OBS, BATCH, PRIOR_SCALE, TOL = 100, 500, 4096, 10.0, 3e-3
HMC_WARMUP, HMC_DRAWS, HMC_LEAPFROG = 100, 16, 16


def logistic_data(rng):
    """X, y and the starts, as chip_smoke.py draws them (float64)."""
    X = rng.standard_normal((N_OBS, N)) / np.sqrt(N)
    w_true = rng.standard_normal(N)
    y = (rng.random(N_OBS) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    starts = rng.standard_normal((BATCH, N))
    return X, y, starts


def iterations(fleet):
    it = np.asarray(fleet.iterations)
    ok = np.asarray(fleet.status) == int(qnm.Status.CONVERGED)
    return {"converged": int(ok.sum()), "median_iterations": float(np.median(it)),
            "max_iterations": int(it.max())}


def main():
    X, y, starts = logistic_data(np.random.default_rng(SEED))
    model = LogisticRegressionMAP(N, N_OBS, prior_scale=PRIOR_SCALE, dtype=jnp.float32)
    model.X = jnp.asarray(X, jnp.float32)
    model.y = jnp.asarray(y, jnp.float32)
    x0s = jnp.asarray(starts, jnp.float32)
    t0 = time.perf_counter()
    out = qnm.map_then_sample(model, jax.random.PRNGKey(SEED), x0s, map_engine="bfgs",
                              map_tol=TOL, sampler="hmc", n_warmup=HMC_WARMUP,
                              n_samples=HMC_DRAWS, n_leapfrog=HMC_LEAPFROG,
                              compute_evidence="bridge")
    jax.block_until_ready(out.samples)
    secs = round(time.perf_counter() - t0, 1)
    fused = qnm.optimize_batched(model, x0s, tol=TOL, backend="fused")
    print(json.dumps({
        "plan": {"map_tol": TOL, "warmup": HMC_WARMUP, "draws": HMC_DRAWS,
                 "leapfrog": HMC_LEAPFROG},
        "map": iterations(out.map_result), "map_fused": iterations(fused),
        "rhat_max": float(np.max(np.asarray(out.diagnostics.rhat))),
        "bridge_logZ": float(out.log_evidence), "bridge_n_iter": int(out.evidence_extra.n_iter),
        "cpu_seconds": secs,
    }), flush=True)


if __name__ == "__main__":
    main()
