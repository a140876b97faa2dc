#!/usr/bin/env python3
"""The JAX package's numbers for `chip_smoke.py`'s phase 29 (the other three
samplers: MCLMC, the affine-invariant ensemble and replica-exchange HMC),
written to ``scripts/jax_tempering_reference.json``, which `chip_smoke.py`
reads (the machine with the card has no JAX).

BASELINE config 3's logistic posterior (n = 100 weights, 500 observations,
prior scale 10) and the fleet's 4096 starts, drawn with numpy as
`chip_smoke.py :: logistic_data` draws them (``numpy.random.default_rng(
20260816)``: X, w_true, y, then the starts), in float32 (x64 off) on the
CPU:

  * (a) the MAP fleet, `optimize_batched(model, starts, tol=3e-3)` on all
    4096 starts, then `chain_init_from_map(fleet, jitter=0.05,
    key=PRNGKey(20260816))`: the jittered starts and the dense B the
    workflow hands to ``sampler="mclmc"`` and ``"pt"``;
  * (b) the ``sampler="mclmc"`` route on 512 of the chains (4096 take too
    long on a CPU; the chip's gates carry the difference in chain counts
    through the MCSEs): `mclmc_sample(model, key, x0s[:512], mass=B,
    n_samples=MCLMC_DRAWS, n_warmup=MCLMC_WARMUP)`: per coordinate the
    pooled mean, sd and MCSE = sd / sqrt(ESS) (the package's `ess`), the
    step size, L, energy_var and the divergences;
  * (c) the ``sampler="ensemble"`` route at the full 4096 walkers, under
    each key k the whole route: `chain_init_from_map(fleet, jitter=0.05,
    key=k)`'s starts, then `ensemble_sample(model, k, x0s_k,
    n_samples=ENSEMBLE_DRAWS, n_warmup=ENSEMBLE_WARMUP, partner=p)` for
    ``p`` in ("gather", "shift"), under KEYS keys: the mean acceptance, the
    draws' per-coordinate mean and sd, and `ensemble_autocorr_time`'s tau
    over the first TAU_WALKERS walkers (all 4096 take ~12 s of host FFTs
    a run, on the card's host as here);
  * (d) the ``sampler="pt"`` route on 512 chains (8 temperatures, 4096
    replicas): `pt_sample(model, key, x0s[:512], mass=B,
    n_samples=PT_DRAWS, n_warmup=PT_WARMUP)` with the other arguments at
    their defaults (`geometric_ladder(8, 0.05)`, 16 leapfrog steps): the
    cold row's moments as (b)'s, the per-temperature acceptance and step
    size, every pair's swap rate, the round trips and divergences;
  * (e) the bimodal mixture of tests/test_tempering.py:63-92 (modes at ±4
    in n = 2, weights 0.75 / 0.25, sigma 1) on 4096 chains, every one
    started in the heavy mode (0.1 times a standard normal from
    ``numpy.random.default_rng(20260816 + 2)`` around it), 6 temperatures,
    beta_min 0.05, 8 leapfrog steps, BIMODAL_WARMUP + BIMODAL_DRAWS
    rounds, under KEYS keys: the cold row's mode weights, the swap rates
    and the round trips.

Key counts. A gate that holds the port's run (another independent draw)
inside the band of JAX's runs widened by half that band fails a correct
port about 24 % of the time with 3 keys and 2 % with 10 (independent
normal draws; scripts/jax_pathfinder_reference.py), so (c) and (e) run
under 10.

Takes ~10 min on a CPU:

    JAX_PLATFORMS=cpu python scripts/jax_tempering_reference.py
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
from quasinewtonmethods_jl_tpu.ensemble import ensemble_autocorr_time  # noqa: E402
from quasinewtonmethods_jl_tpu.models import GaussianMixture, LogisticRegressionMAP  # noqa: E402

SEED = 20260816
N, N_OBS, BATCH, PRIOR_SCALE, TOL, JITTER = 100, 500, 4096, 10.0, 3e-3, 0.05
CHAINS, KEYS, TAU_WALKERS = 512, 10, 512
MCLMC_WARMUP, MCLMC_DRAWS = 200, 200
ENSEMBLE_WARMUP, ENSEMBLE_DRAWS = 300, 200
PT_WARMUP, PT_DRAWS = 80, 80
BIMODAL_TEMPS, BIMODAL_BETA_MIN, BIMODAL_LEAPFROG = 6, 0.05, 8
BIMODAL_WARMUP, BIMODAL_DRAWS = 100, 150
OUT = os.path.join(ROOT, "scripts", "jax_tempering_reference.json")


def logistic_data(rng):
    """X, y and the starts, as chip_smoke.py draws them (float64)."""
    X = rng.standard_normal((N_OBS, N)) / np.sqrt(N)
    w_true = rng.standard_normal(N)
    y = (rng.random(N_OBS) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    starts = rng.standard_normal((BATCH, N))
    return X, y, starts


def bimodal_starts():
    """The 4096 starts of (e), as chip_smoke.py draws them."""
    noise = np.random.default_rng(SEED + 2).standard_normal((BATCH, 2))
    return np.asarray([4.0, 4.0]) + 0.1 * noise


def moments(samples):
    """Per coordinate the pooled mean, sd and MCSE; the largest R-hat."""
    s = np.asarray(samples, np.float64)
    pooled = s.reshape(-1, s.shape[-1])
    sd = pooled.std(axis=0)
    return {"chains": int(s.shape[1]), "draws": int(s.shape[0]),
            "mean": pooled.mean(axis=0).tolist(), "sd": sd.tolist(),
            "mcse": (sd / np.sqrt(qnm.ess(s))).tolist(),
            "rhat_max": float(np.max(qnm.split_rhat(s)))}


def timed(label, fn):
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    seconds = round(time.perf_counter() - t0, 1)
    print(f"{label}: {seconds} s", flush=True)
    return out, seconds


def main():
    X, y, starts = logistic_data(np.random.default_rng(SEED))
    model = LogisticRegressionMAP(N, N_OBS, prior_scale=PRIOR_SCALE, dtype=jnp.float32)
    model.X = jnp.asarray(X, jnp.float32)
    model.y = jnp.asarray(y, jnp.float32)
    key = jax.random.PRNGKey(SEED)
    keys = [jax.random.PRNGKey(SEED + k) for k in range(KEYS)]
    out = {"plan": {"chains": CHAINS, "keys": KEYS,
                    "tau_walkers": TAU_WALKERS, "mclmc": [MCLMC_WARMUP, MCLMC_DRAWS],
                    "ensemble": [ENSEMBLE_WARMUP, ENSEMBLE_DRAWS], "pt": [PT_WARMUP, PT_DRAWS],
                    "bimodal": [BIMODAL_TEMPS, BIMODAL_BETA_MIN, BIMODAL_LEAPFROG,
                                BIMODAL_WARMUP, BIMODAL_DRAWS]}}

    # (a) the MAP fleet and the handoff
    fleet, secs = timed("MAP fleet", lambda: qnm.optimize_batched(
        model, jnp.asarray(starts, jnp.float32), tol=TOL))
    x0s, mass = qnm.chain_init_from_map(fleet, jitter=JITTER, key=key)
    status = np.asarray(fleet.status)
    out["map"] = {"converged": int((status == int(qnm.Status.CONVERGED)).sum()),
                  "median_iterations": float(np.median(np.asarray(fleet.iterations))),
                  "cpu_seconds": secs}
    print(json.dumps(out["map"]), flush=True)

    # (b) MCLMC on 512 chains with the dense B (its diagonal)
    res, secs = timed("mclmc", lambda: qnm.mclmc_sample(
        model, key, x0s[:CHAINS], mass=mass, n_samples=MCLMC_DRAWS, n_warmup=MCLMC_WARMUP))
    out["mclmc"] = {**moments(res.samples), "step_size": float(res.step_size),
                    "L": float(res.L), "energy_var": float(res.energy_var),
                    "divergences": int(np.sum(np.asarray(res.divergences))),
                    "cpu_seconds": secs}
    print(json.dumps({k: v for k, v in out["mclmc"].items() if k not in ("mean", "sd", "mcse")}),
          flush=True)
    del res

    # (c) the ensemble at 4096 walkers, both partners, KEYS keys
    out["ensemble"] = {}
    for partner in ("gather", "shift"):
        runs = []
        for k in keys:
            x0s_k, _mass = qnm.chain_init_from_map(fleet, jitter=JITTER, key=k)
            res, secs = timed(f"ensemble {partner}", lambda: qnm.ensemble_sample(
                model, k, x0s_k, n_samples=ENSEMBLE_DRAWS, n_warmup=ENSEMBLE_WARMUP,
                partner=partner))
            s = np.asarray(res.samples, np.float64).reshape(-1, N)
            tau, _rel = ensemble_autocorr_time(res.samples[:, :TAU_WALKERS])
            runs.append({"accept_mean": float(np.mean(np.asarray(res.accept_rate))),
                         "mean": s.mean(axis=0).tolist(), "sd": s.std(axis=0).tolist(),
                         "tau_median": float(np.median(tau)), "tau_max": float(np.max(tau)),
                         "cpu_seconds": secs})
            print(json.dumps({k2: v for k2, v in runs[-1].items() if k2 not in ("mean", "sd")}),
                  flush=True)
        out["ensemble"][partner] = runs
        del res

    # (d) replica exchange on 512 chains with the dense B, the defaults
    res, secs = timed("pt", lambda: qnm.pt_sample(
        model, key, x0s[:CHAINS], mass=mass, n_samples=PT_DRAWS, n_warmup=PT_WARMUP))
    out["pt"] = {**moments(res.samples),
                 "accept_rate": np.asarray(res.accept_rate, np.float64).tolist(),
                 "step_size": np.asarray(res.step_size, np.float64).tolist(),
                 "swap_rate": np.asarray(res.swap_rate, np.float64).tolist(),
                 "betas": np.asarray(res.betas, np.float64).tolist(),
                 "round_trips": int(np.sum(np.asarray(res.round_trips))),
                 "divergences": int(np.sum(np.asarray(res.divergences))),
                 "cpu_seconds": secs}
    print(json.dumps({k: v for k, v in out["pt"].items() if k not in ("mean", "sd", "mcse")}),
          flush=True)
    del res

    # (e) the bimodal mixture, KEYS keys
    mix = GaussianMixture(means=jnp.asarray([[4.0, 4.0], [-4.0, -4.0]], jnp.float32),
                          weights=[0.75, 0.25], sigmas=1.0)
    bstarts = jnp.asarray(bimodal_starts(), jnp.float32)
    runs = []
    for k in keys:
        res, secs = timed("bimodal", lambda: qnm.pt_sample(
            mix.logdensity, k, bstarts, n_temps=BIMODAL_TEMPS, beta_min=BIMODAL_BETA_MIN,
            n_samples=BIMODAL_DRAWS, n_warmup=BIMODAL_WARMUP, n_leapfrog=BIMODAL_LEAPFROG))
        runs.append({"mode_weights": np.asarray(mix.mode_weights(res.samples),
                                                np.float64).tolist(),
                     "swap_rate": np.asarray(res.swap_rate, np.float64).tolist(),
                     "round_trips": int(np.sum(np.asarray(res.round_trips))),
                     "cpu_seconds": secs})
        print(json.dumps(runs[-1]), flush=True)
    out["bimodal"] = runs
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
