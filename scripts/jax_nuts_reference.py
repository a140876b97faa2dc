#!/usr/bin/env python3
"""The JAX package's numbers for `chip_smoke.py`'s phase 27 (NUTS and
depth-sorted NUTS), written to ``scripts/jax_nuts_reference.json``, which
`chip_smoke.py` reads (the machine with the card has no JAX).

BASELINE config 3's logistic posterior (n = 100 weights, 500 observations,
prior scale 10) and the fleet's 4096 starts, drawn with numpy as
`chip_smoke.py :: logistic_data` draws them (``numpy.random.default_rng(
20260816)``: X, w_true, y, then the starts), in float32 (x64 off) on the
CPU, as `scripts/jax_sampling_reference.py` builds them:

  * the MAP fleet: `optimize_batched(model, starts, tol=3e-3)` on all 4096
    starts (its converged count and median iterations), then
    `chain_init_from_map(fleet, jitter=0.05, key=PRNGKey(20260816))`;
  * the workflow's depth-sort route on 512 of the chains (4096 take too
    long on a CPU; the chip's gates carry the difference in chain counts
    through the MCSEs): `nuts_sample(model, key, x0s[:512], n_samples=0,
    n_warmup=150, total_warmup=150)` with no mass (the fleet adapts its
    diagonal, max_depth 8; the warmup of chip_smoke.py's phase 27, which
    cut JAX's default 500 for its time limit), then `nuts_sample_from_state(model, warm,
    n_samples=250)`: per coordinate the pooled mean, sd and MCSE = sd /
    sqrt(ESS) (the package's `ess`), the largest split R-hat, the mean
    accept, the median step size, the fleet mean of mean_tree_depth and
    the histogram of the chains' mean depths (fractions of chains in bins
    of 0.5), the divergences and the E-BFMI (median and min over chains);
  * `nuts_sample_depth_sorted(model, warm, 50)` with its defaults: the
    decision (printed by chip_smoke, not gated: it depends on the fleet
    size);
  * the forced sorted path, `nuts_sample_depth_sorted(model, warm, 100,
    groups=4, min_persistence=-1.0, min_depth_spread=0.0)`: its decision
    and the moments of its draws.

Takes ~2 min on a CPU:

    JAX_PLATFORMS=cpu python scripts/jax_nuts_reference.py
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
JITTER, CHAINS, WARMUP, DRAWS, MAX_DEPTH = 0.05, 512, 150, 250, 8
DEFAULT_SORT_DRAWS, FORCED_DRAWS, FORCED_GROUPS = 50, 100, 4
OUT = os.path.join(ROOT, "scripts", "jax_nuts_reference.json")


def logistic_data(rng):
    """X, y and the starts, as chip_smoke.py draws them (float64)."""
    X = rng.standard_normal((N_OBS, N)) / np.sqrt(N)
    w_true = rng.standard_normal(N)
    y = (rng.random(N_OBS) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    starts = rng.standard_normal((BATCH, N))
    return X, y, starts


def depth_histogram(mean_tree_depth):
    """Fractions of chains whose mean depth lies in [0, 0.5), [0.5, 1), ...
    up to MAX_DEPTH."""
    counts, _ = np.histogram(np.asarray(mean_tree_depth, np.float64),
                             bins=np.arange(0.0, MAX_DEPTH + 1.0, 0.5))
    return (counts / counts.sum()).tolist()


def moments(res):
    """The phase's per-coordinate and fleet summaries of one NUTS run."""
    s = np.asarray(res.samples, np.float64)
    pooled = s.reshape(-1, s.shape[-1])
    sd = pooled.std(axis=0)
    bfmi = qnm.energy_bfmi(np.asarray(res.energies))
    depth = np.asarray(res.mean_tree_depth, np.float64)
    return {
        "chains": int(s.shape[1]), "draws": int(s.shape[0]),
        "mean": pooled.mean(axis=0).tolist(), "sd": sd.tolist(),
        "mcse": (sd / np.sqrt(qnm.ess(s))).tolist(),
        "rhat_max": float(np.max(qnm.split_rhat(s))),
        "accept_mean": float(np.mean(np.asarray(res.accept_prob))),
        "step_size_median": float(np.median(np.asarray(res.step_size))),
        "mean_depth": float(depth.mean()),
        "depth_histogram": depth_histogram(depth),
        "divergences": int(np.sum(np.asarray(res.divergences))),
        "ebfmi_median": float(np.median(bfmi)), "ebfmi_min": float(np.min(bfmi)),
    }


def info_dict(info):
    return {"sorted": bool(info.sorted), "persistence": float(info.persistence),
            "depth_spread": float(info.depth_spread),
            "group_sizes": [int(v) for v in info.group_sizes],
            "group_mean_depths": [float(v) for v in info.group_mean_depths]}


def main():
    X, y, starts = logistic_data(np.random.default_rng(SEED))
    model = LogisticRegressionMAP(N, N_OBS, prior_scale=PRIOR_SCALE, dtype=jnp.float32)
    model.X = jnp.asarray(X, jnp.float32)
    model.y = jnp.asarray(y, jnp.float32)
    key = jax.random.PRNGKey(SEED)
    out = {"plan": {"chains": CHAINS, "warmup": WARMUP, "draws": DRAWS, "max_depth": MAX_DEPTH,
                    "default_sort_draws": DEFAULT_SORT_DRAWS, "forced_draws": FORCED_DRAWS,
                    "forced_groups": FORCED_GROUPS}}

    t0 = time.perf_counter()
    fleet = qnm.optimize_batched(model, jnp.asarray(starts, jnp.float32), tol=TOL)
    x0s, _mass = qnm.chain_init_from_map(fleet, jitter=JITTER, key=key)
    status = np.asarray(fleet.status)
    out["map"] = {"converged": int((status == int(qnm.Status.CONVERGED)).sum()),
                  "median_iterations": float(np.median(np.asarray(fleet.iterations))),
                  "cpu_seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out["map"]), flush=True)

    t0 = time.perf_counter()
    warm = qnm.nuts_sample(model, key, x0s[:CHAINS], n_samples=0, n_warmup=WARMUP,
                           total_warmup=WARMUP, max_depth=MAX_DEPTH).state
    jax.block_until_ready(warm)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = qnm.nuts_sample_from_state(model, warm, n_samples=DRAWS, max_depth=MAX_DEPTH)
    out["nuts"] = {**moments(res), "warmup_cpu_seconds": round(warm_s, 1),
                   "cpu_seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps({k: v for k, v in out["nuts"].items()
                      if k not in ("mean", "sd", "mcse")}), flush=True)

    t0 = time.perf_counter()
    _res, info = qnm.nuts_sample_depth_sorted(model, warm, DEFAULT_SORT_DRAWS,
                                              max_depth=MAX_DEPTH)
    out["default_sort"] = {**info_dict(info), "cpu_seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out["default_sort"]), flush=True)

    t0 = time.perf_counter()
    forced, finfo = qnm.nuts_sample_depth_sorted(
        model, warm, FORCED_DRAWS, groups=FORCED_GROUPS, min_persistence=-1.0,
        min_depth_spread=0.0, max_depth=MAX_DEPTH)
    out["forced_sort"] = {**moments(forced), **info_dict(finfo),
                          "cpu_seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps({k: v for k, v in out["forced_sort"].items()
                      if k not in ("mean", "sd", "mcse")}), flush=True)
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
