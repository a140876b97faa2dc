#!/usr/bin/env python3
"""The JAX package's numbers for `chip_smoke.py`'s phase 28 (the workflow's
initializers and PSIS), written to ``scripts/jax_pathfinder_reference.json``,
which `chip_smoke.py` reads (the machine with the card has no JAX).

BASELINE config 3's logistic posterior (n = 100 weights, 500 observations,
prior scale 10) and the fleet's 4096 starts, drawn with numpy as
`chip_smoke.py :: logistic_data` draws them (``numpy.random.default_rng(
20260816)``: X, w_true, y, then the starts), in float32 (x64 off) on the
CPU:

  * (a) the workflow's ``init="pathfinder"`` route: ``pathfinder(model,
    key, zeros(100), n_draws=4096, init_scale=1.0)``, the other arguments
    at their defaults (8 paths, 2048 draws a path, history 8, 64
    iterations, 16 ELBO draws), under KEYS keys: per key the paths'
    ELBOs, statuses, iterations, best_iter, n_fev and n_gev, the median
    path ELBO, khat, and the draws' per-coordinate mean and sd;
  * (b) the workflow's ``init="svgd"`` route: ``svgd_sample(model,
    starts)`` with its defaults (500 steps) from the 4096 numpy starts
    (x0 = 0 plus 1.0 times a standard normal) and from six witnesses of
    those starts moved by one ulp (all up; all down; even particles up
    and odd down, and the reverse; even coordinates up and odd down, and
    the reverse): each run's final bandwidth, the particles'
    per-coordinate mean and sd, and every 512th particle (8 rows);
  * (c) PSIS-LOO and WAIC on sampler draws: ``optimize_batched(model,
    starts, tol=3e-3)`` (its converged count and median iterations),
    then under each of LOO_KEYS keys ``chain_init_from_map(fleet,
    jitter=0.05, key)`` and ``hmc_sample(model, key, x0s, mass,
    n_samples=1, n_warmup=LOO_WARMUP, n_leapfrog=16)`` on all 4096 chains,
    and ``loo_psis`` / ``waic`` on the (4096, 500) pointwise Bernoulli
    log-likelihood of those draws.

Key counts. A gate that holds the port's run (another independent draw)
inside the band of JAX's runs widened by half that band fails a correct
port about 24 % of the time with 3 keys and 2 % with 10; one that asks
for the distance to JAX's mean within 2x the spread fails about 26 % of
the time with 2 keys and under 0.5 % with 6 (independent normal draws).
So (a) runs under 10 keys and (c) under 6. SVGD is deterministic, but at
this size its 500 steps amplify rounding until runs whose starts differ
by one ulp end ~1e-2 apart in the bandwidth and ~0.1 in a coordinate's
mean (the median flips between neighbouring order statistics); one
witness's spread is then a single draw of that spread, and a gate of
twice it fails a correct port about 27 % of the time, twice the largest
of six about 1 %. So (b) records six witnesses.

Takes ~10 min on a CPU:

    JAX_PLATFORMS=cpu python scripts/jax_pathfinder_reference.py
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
PF_DRAWS, PF_INIT_SCALE, KEYS = 4096, 1.0, 10
SVGD_ROW_STRIDE = 512
JITTER, LOO_KEYS, LOO_WARMUP, LEAPFROG = 0.05, 6, 100, 16
OUT = os.path.join(ROOT, "scripts", "jax_pathfinder_reference.json")


def logistic_data(rng):
    """X, y and the starts, as chip_smoke.py draws them (float64)."""
    X = rng.standard_normal((N_OBS, N)) / np.sqrt(N)
    w_true = rng.standard_normal(N)
    y = (rng.random(N_OBS) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    starts = rng.standard_normal((BATCH, N))
    return X, y, starts


def pathfinder_leg(model):
    runs = []
    for k in range(KEYS):
        t0 = time.perf_counter()
        pf = qnm.pathfinder(model, jax.random.PRNGKey(SEED + k), jnp.zeros(N, jnp.float32),
                            n_draws=PF_DRAWS, init_scale=PF_INIT_SCALE)
        d = np.asarray(pf.draws, np.float64)
        elbo = np.asarray(pf.elbo, np.float64)
        run = {
            "key": SEED + k,
            "elbo": [float(v) for v in elbo],
            "elbo_finite": np.isfinite(elbo).tolist(),
            "median_elbo": float(np.median(elbo)),
            "khat": float(pf.khat),
            "status": np.asarray(pf.status).tolist(),
            "iterations": np.asarray(pf.iterations).tolist(),
            "best_iter": np.asarray(pf.best_iter).tolist(),
            "n_fev": np.asarray(pf.n_fev).tolist(),
            "n_gev": np.asarray(pf.n_gev).tolist(),
            "mean": d.mean(axis=0).tolist(),
            "sd": d.std(axis=0).tolist(),
            "draws_finite": bool(np.isfinite(d).all()),
            "cpu_seconds": round(time.perf_counter() - t0, 2),
        }
        runs.append(run)
        print(json.dumps({k: v for k, v in run.items() if k not in ("mean", "sd")}), flush=True)
    return {"plan": {"n_draws": PF_DRAWS, "init_scale": PF_INIT_SCALE, "keys": KEYS},
            "runs": runs}


def svgd_witnesses(starts):
    """The starts and six one-ulp witnesses of them (module docstring)."""
    up = np.nextafter(starts, np.float32(np.inf))
    down = np.nextafter(starts, np.float32(-np.inf))
    rows = (np.arange(starts.shape[0]) % 2 == 0)[:, None]
    cols = (np.arange(starts.shape[1]) % 2 == 0)[None, :]
    return (("base", starts), ("ulp_up", up), ("ulp_down", down),
            ("rows_up_down", np.where(rows, up, down)), ("rows_down_up", np.where(rows, down, up)),
            ("cols_up_down", np.where(cols, up, down)), ("cols_down_up", np.where(cols, down, up)))


def svgd_leg(model, starts):
    out = {"witnesses": {}}
    for name, x0 in svgd_witnesses(starts):
        t0 = time.perf_counter()
        res = qnm.svgd_sample(model, jnp.asarray(x0, jnp.float32))
        p = np.asarray(res.particles, np.float64)
        run = {"bandwidth": float(res.bandwidth), "mean": p.mean(axis=0).tolist(),
               "sd": p.std(axis=0).tolist(), "rows": p[::SVGD_ROW_STRIDE].tolist(),
               "n_steps": int(res.n_steps),
               "logp_finite": bool(np.isfinite(np.asarray(res.logp)).all()),
               "cpu_seconds": round(time.perf_counter() - t0, 1)}
        if name == "base":
            out["base"] = run
        else:
            out["witnesses"][name] = run
        print(json.dumps({"run": name, **{k: v for k, v in run.items()
                                         if k not in ("mean", "sd", "rows")}}), flush=True)
    out["plan"] = {"particles": BATCH, "n_steps": out["base"]["n_steps"],
                   "row_stride": SVGD_ROW_STRIDE}
    return out


def pointwise_loglik(X, y, draws):
    logits = draws @ X.T  # (S, N_OBS)
    return y * jax.nn.log_sigmoid(logits) + (1.0 - y) * jax.nn.log_sigmoid(-logits)


def loo_leg(model, starts, X, y):
    t0 = time.perf_counter()
    fleet = qnm.optimize_batched(model, jnp.asarray(starts, jnp.float32), tol=TOL)
    status = np.asarray(fleet.status)
    out = {"map": {"converged": int((status == int(qnm.Status.CONVERGED)).sum()),
                   "median_iterations": float(np.median(np.asarray(fleet.iterations))),
                   "cpu_seconds": round(time.perf_counter() - t0, 1)},
           "plan": {"jitter": JITTER, "warmup": LOO_WARMUP, "leapfrog": LEAPFROG,
                    "draws": 1, "keys": LOO_KEYS},
           "runs": []}
    print(json.dumps(out["map"]), flush=True)
    Xj, yj = jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32)
    for k in range(LOO_KEYS):
        key = jax.random.PRNGKey(SEED + k)
        t0 = time.perf_counter()
        x0s, mass = qnm.chain_init_from_map(fleet, jitter=JITTER, key=key)
        res = qnm.hmc_sample(model, key, x0s, mass, n_samples=1, n_warmup=LOO_WARMUP,
                             n_leapfrog=LEAPFROG)
        ll = pointwise_loglik(Xj, yj, res.samples.reshape(-1, N))
        lo, w = qnm.loo_psis(ll), qnm.waic(ll)
        khat = np.asarray(lo.khat, np.float64)
        run = {"key": SEED + k, "elpd_loo": float(lo.elpd), "se_loo": float(lo.se),
               "p_loo": float(lo.p_loo), "elpd_waic": float(w.elpd), "se_waic": float(w.se),
               "p_waic": float(w.p_waic), "khat_max": float(khat.max()),
               "khat_over_07": int((khat > 0.7).sum()),
               "accept_mean": float(np.mean(np.asarray(res.accept_rate))),
               "cpu_seconds": round(time.perf_counter() - t0, 1)}
        out["runs"].append(run)
        print(json.dumps(run), flush=True)
    return out


def main():
    X, y, starts = logistic_data(np.random.default_rng(SEED))
    model = LogisticRegressionMAP(N, N_OBS, prior_scale=PRIOR_SCALE, dtype=jnp.float32)
    model.X = jnp.asarray(X, jnp.float32)
    model.y = jnp.asarray(y, jnp.float32)
    starts32 = starts.astype(np.float32)
    out = {"pathfinder": pathfinder_leg(model)}
    out["svgd"] = svgd_leg(model, starts32)
    out["loo"] = loo_leg(model, starts32, X, y)
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
