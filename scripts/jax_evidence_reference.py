#!/usr/bin/env python3
"""The JAX package's numbers for `chip_smoke.py`'s phase 30 (evidence by
sampling: annealed importance sampling, adaptive tempered SMC and bridge
sampling), written to ``scripts/jax_evidence_reference.json``, which
`chip_smoke.py` reads (the machine with the card has no JAX).

BASELINE config 3's logistic posterior (n = 100 weights, 500 observations,
prior scale 10) and the fleet's 4096 starts, drawn with numpy as
`chip_smoke.py :: logistic_data` draws them (``numpy.random.default_rng(
20260816)``: X, w_true, y, then the starts), in float32 (x64 off) on the
CPU:

  * the MAP fleet, `optimize_batched(model, starts, tol=3e-3)`, and
    `laplace_evidence` with the exact Hessian at its best converged lane
    (the mode `ais_evidence` and `bridge_evidence` take from the fleet);
  * then under each of KEYS keys k, phase 28 (c)'s sampler run made
    longer: `chain_init_from_map(fleet, jitter=0.05, key=k)` and
    `hmc_sample(model, k, x0s, mass, n_samples=HMC_DRAWS,
    n_warmup=HMC_WARMUP, n_leapfrog=16)` on all 4096 chains (its first
    draw is phase 28's LOO draw);
  * `ais_evidence(model, fold_in(k, 1), fleet, n_particles=4096,
    n_steps=64, n_leapfrog=8, step_size=0.2)` on the linear ladder, and
    `ais_evidence(model, fold_in(k, 2), fleet, ..., schedule="adaptive",
    resample=True)` with the same cap: logZ, ess, the mean acceptance over
    the rungs run, the adapted step, n_rungs and n_resamples;
  * `bridge_evidence(model, fold_in(k, 3), draws, fleet)` on the HMC run's
    HMC_DRAWS x 4096 draws with the default n_proposal (as many as
    draws): logZ, n_iter, delta and re2.

Key count. A gate that asks for the distance to JAX's mean within twice
JAX's key-to-key spread fails a correct port under 0.5 % of the time with
6 keys (independent normal draws; scripts/jax_pathfinder_reference.py).

Takes ~6 min on a CPU:

    JAX_PLATFORMS=cpu python scripts/jax_evidence_reference.py
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import quasinewtonmethods_jl_tpu as qnm  # noqa: E402
from quasinewtonmethods_jl_tpu.models import LogisticRegressionMAP  # noqa: E402

SEED = 20260816
N, N_OBS, BATCH, PRIOR_SCALE, TOL = 100, 500, 4096, 10.0, 3e-3
JITTER, HMC_WARMUP, HMC_LEAPFROG, HMC_DRAWS = 0.05, 100, 16, 16
PARTICLES, RUNGS, LEAPFROG, STEP = 4096, 64, 8, 0.2
KEYS = 6
OUT = os.path.join(ROOT, "scripts", "jax_evidence_reference.json")


def logistic_data(rng):
    """X, y and the starts, as chip_smoke.py draws them (float64)."""
    X = rng.standard_normal((N_OBS, N)) / np.sqrt(N)
    w_true = rng.standard_normal(N)
    y = (rng.random(N_OBS) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    starts = rng.standard_normal((BATCH, N))
    return X, y, starts


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, round(time.perf_counter() - t0, 1)


def ais_record(res, secs):
    rungs = int(res.n_rungs)
    return {"logZ": float(res.logZ), "ess": float(res.ess),
            "accept_mean": float(np.mean(np.asarray(res.accept_rate, np.float64)[:rungs])),
            "step_size": float(res.step_size), "n_rungs": rungs,
            "n_resamples": int(res.n_resamples), "cpu_seconds": secs}


def main():
    X, y, starts = logistic_data(np.random.default_rng(SEED))
    model = LogisticRegressionMAP(N, N_OBS, prior_scale=PRIOR_SCALE, dtype=jnp.float32)
    model.X = jnp.asarray(X, jnp.float32)
    model.y = jnp.asarray(y, jnp.float32)
    fleet, secs = timed(lambda: qnm.optimize_batched(model, jnp.asarray(starts, jnp.float32),
                                                     tol=TOL))
    status = np.asarray(fleet.status)
    ok = status == int(qnm.Status.CONVERGED)
    best = int(np.argmax(np.where(ok, np.asarray(fleet.fun), -np.inf)))
    mode = fleet._replace(x=fleet.x[best], fun=fleet.fun[best])
    out = {"plan": {"particles": PARTICLES, "rungs": RUNGS, "leapfrog": LEAPFROG,
                    "step_size": STEP, "keys": KEYS,
                    "hmc": {"jitter": JITTER, "warmup": HMC_WARMUP, "leapfrog": HMC_LEAPFROG,
                            "draws": HMC_DRAWS}},
           "map": {"converged": int(ok.sum()),
                   "median_iterations": float(np.median(np.asarray(fleet.iterations))),
                   "best_lane": best, "cpu_seconds": secs},
           "laplace": float(qnm.laplace_evidence(mode, obj=model)),
           "runs": []}
    print(json.dumps(out["map"]), out["laplace"], flush=True)
    for k in range(KEYS):
        key = jax.random.PRNGKey(SEED + k)
        x0s, mass = qnm.chain_init_from_map(fleet, jitter=JITTER, key=key)
        hmc, hmc_secs = timed(lambda: qnm.hmc_sample(
            model, key, x0s, mass, n_samples=HMC_DRAWS, n_warmup=HMC_WARMUP,
            n_leapfrog=HMC_LEAPFROG))
        common = {"n_particles": PARTICLES, "n_steps": RUNGS, "n_leapfrog": LEAPFROG,
                  "step_size": STEP}
        fixed = ais_record(*timed(lambda: qnm.ais_evidence(
            model, jax.random.fold_in(key, 1), fleet, **common)))
        adaptive = ais_record(*timed(lambda: qnm.ais_evidence(
            model, jax.random.fold_in(key, 2), fleet, schedule="adaptive", resample=True,
            **common)))
        br, br_secs = timed(lambda: qnm.bridge_evidence(model, jax.random.fold_in(key, 3),
                                                        hmc.samples, fleet))
        run = {"key": SEED + k, "hmc_accept_mean": float(np.mean(np.asarray(hmc.accept_rate))),
               "hmc_cpu_seconds": hmc_secs, "ais": fixed, "adaptive": adaptive,
               "bridge": {"logZ": float(br.logZ), "n_iter": int(br.n_iter),
                          "delta": float(br.delta), "re2": float(br.re2),
                          "cpu_seconds": br_secs}}
        out["runs"].append(run)
        print(json.dumps(run), flush=True)
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
