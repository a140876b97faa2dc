#!/usr/bin/env python3
"""The JAX package's numbers for `chip_smoke.py`'s phase 26 (the samplers
the MAP fleet hands over to), written to ``scripts/jax_sampling_reference.json``,
which `chip_smoke.py` reads (the machine with the card has no JAX).

BASELINE config 3's logistic posterior (n = 100 weights, 500 observations,
prior scale 10) and the fleet's 4096 starts, drawn with numpy as
`chip_smoke.py :: logistic_data` draws them (``numpy.random.default_rng(
20260816)``: X, w_true, y, then the starts), in float32 (x64 off) on the
CPU:

  * the MAP fleet: `optimize_batched(model, starts, tol=3e-3)` on all 4096
    starts, its converged count and median iterations; then
    `chain_init_from_map(fleet, jitter=0.05, key=PRNGKey(20260816))`: the
    diagonal of the handed-over dense mass;
  * `hmc_sample(model, PRNGKey(20260816), x0s[:512], mass, n_samples=500,
    n_warmup=500, n_leapfrog=16)` and `chees_sample(model,
    PRNGKey(20260816), x0s[:512], n_samples=500, n_warmup=500)` (no mass:
    the fleet adapts its diagonal; 500 draws, as `chip_smoke.py` draws
    them) on 512 of the chains (4096 take too long on a CPU; the chip's
    moment gates carry the difference in chain counts through the
    MCSEs): per coordinate the
    pooled mean, sd and MCSE = sd / sqrt(ESS) (the package's `ess`), the
    largest split R-hat, the mean accept rate, the step size (HMC: the
    median over chains), ChEES's trajectory length, the divergences and
    the E-BFMI (median and min over chains).

Takes ~3 min on a CPU:

    JAX_PLATFORMS=cpu python scripts/jax_sampling_reference.py
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
JITTER, CHAINS, DRAWS, WARMUP, LEAPFROG = 0.05, 512, 500, 500, 16
OUT = os.path.join(ROOT, "scripts", "jax_sampling_reference.json")


def logistic_data(rng):
    """X, y and the starts, as chip_smoke.py draws them (float64)."""
    X = rng.standard_normal((N_OBS, N)) / np.sqrt(N)
    w_true = rng.standard_normal(N)
    y = (rng.random(N_OBS) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    starts = rng.standard_normal((BATCH, N))
    return X, y, starts


def moments(samples, energies, accept_rate, divergences):
    """The phase's per-coordinate and fleet summaries of one run."""
    s = np.asarray(samples, np.float64)
    pooled = s.reshape(-1, s.shape[-1])
    sd = pooled.std(axis=0)
    bfmi = qnm.energy_bfmi(np.asarray(energies))
    return {
        "chains": int(s.shape[1]), "draws": int(s.shape[0]),
        "mean": pooled.mean(axis=0).tolist(), "sd": sd.tolist(),
        "mcse": (sd / np.sqrt(qnm.ess(s))).tolist(),
        "rhat_max": float(np.max(qnm.split_rhat(s))),
        "accept_mean": float(np.mean(np.asarray(accept_rate))),
        "divergences": int(np.sum(np.asarray(divergences))),
        "ebfmi_median": float(np.median(bfmi)), "ebfmi_min": float(np.min(bfmi)),
    }


def main():
    X, y, starts = logistic_data(np.random.default_rng(SEED))
    model = LogisticRegressionMAP(N, N_OBS, prior_scale=PRIOR_SCALE, dtype=jnp.float32)
    model.X = jnp.asarray(X, jnp.float32)
    model.y = jnp.asarray(y, jnp.float32)
    key = jax.random.PRNGKey(SEED)
    out = {}

    t0 = time.perf_counter()
    fleet = qnm.optimize_batched(model, jnp.asarray(starts, jnp.float32), tol=TOL)
    x0s, mass = qnm.chain_init_from_map(fleet, jitter=JITTER, key=key)
    status = np.asarray(fleet.status)
    out["map"] = {"converged": int((status == int(qnm.Status.CONVERGED)).sum()),
                  "median_iterations": float(np.median(np.asarray(fleet.iterations))),
                  "mass_diag": np.diagonal(np.asarray(mass)).tolist(),
                  "cpu_seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps({k: v for k, v in out["map"].items() if k != "mass_diag"}), flush=True)

    t0 = time.perf_counter()
    hmc = qnm.hmc_sample(model, key, x0s[:CHAINS], mass, n_samples=DRAWS, n_warmup=WARMUP,
                         n_leapfrog=LEAPFROG)
    out["hmc"] = {**moments(hmc.samples, hmc.energies, hmc.accept_rate, hmc.divergences),
                  "step_size_median": float(np.median(np.asarray(hmc.step_size))),
                  "cpu_seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps({k: v for k, v in out["hmc"].items()
                      if k not in ("mean", "sd", "mcse")}), flush=True)

    t0 = time.perf_counter()
    chees = qnm.chees_sample(model, key, x0s[:CHAINS], n_samples=DRAWS, n_warmup=WARMUP)
    out["chees"] = {**moments(chees.samples, chees.energies, chees.accept_rate,
                              chees.divergences),
                    "step_size": float(chees.step_size),
                    "traj_length": float(chees.traj_length),
                    "cpu_seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps({k: v for k, v in out["chees"].items()
                      if k not in ("mean", "sd", "mcse")}), flush=True)
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
