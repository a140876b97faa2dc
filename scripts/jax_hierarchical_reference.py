#!/usr/bin/env python3
"""The JAX package's counts on the full-width hierarchical fleet of
`chip_smoke.py`'s phase 23 (B3 on the transformed hierarchical model),
which `chip_smoke.py` keeps as constants (the machine with the card has no
JAX).

The model is the repo's own on-chip configuration of
`models.HierarchicalRegression` (scripts/tpu_experiments_r4i.py:69-75): 8
groups, q = 2 group-level effects, p = 3 coefficients, 512 observations,
LKJ eta 2, solved as ``transform_objective(m, m.transform)`` (n = 23). Its
data are drawn with numpy from ``numpy.random.default_rng(20260816)`` by the
model's own recipe (quasinewtonmethods_jl_tpu/models/hierarchical.py:74-91),
in this order: X = standard_normal((512, 3)), Z = [1 | standard_normal((512,
1))], group = integers(0, 8, 512), beta_true = standard_normal(3), u_true =
(0.8, 0.5)·standard_normal((8, 2)), y = X beta_true + Σ Z·u_true[group] +
0.5·standard_normal(512); then the 4096 starts unconstrain(initial_point())
+ 0.5·standard_normal((4096, 23)) from the same generator (`chip_smoke.py`
draws them the same way). The data go into JAX's model by setting its
attributes after construction. The fleet runs in float32 (x64 off) and in
float64 (x64 on), one child process each, tol 1e-3 (that script's
tolerance), at most 3000 iterations, through `optimize_batched_fused`
(kernel "xla", BackTracking) on the CPU: the engine the port's resident
kernel and fleet engine are held to. In float32 most lanes end
LINESEARCH_FAILURE on float32's floor (the value's rounding is larger than
the increase a step near the mode can show), so that fleet's converged
count and iterations measure rounding; in float64 every lane converges.
Prints one JSON line per dtype (about a minute on a CPU).

    JAX_PLATFORMS=cpu python scripts/jax_hierarchical_reference.py
"""

import json
import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import quasinewtonmethods_jl_tpu as qnm  # noqa: E402
from quasinewtonmethods_jl_tpu import transforms as tfm  # noqa: E402
from quasinewtonmethods_jl_tpu.batched_solve import optimize_batched_fused  # noqa: E402
from quasinewtonmethods_jl_tpu.models import HierarchicalRegression  # noqa: E402

SEED = 20260816
GROUPS, Q, P, OBS, ETA = 8, 2, 3, 512, 2.0
BATCH, TOL, MAX_ITERS = 4096, 1e-3, 3000


def hierarchical_data(rng, groups=GROUPS, q=Q, p=P, n_obs=OBS):
    """X, Z, group, y, beta_true, u_true by the model's recipe, float64."""
    X = rng.standard_normal((n_obs, p))
    Z = np.concatenate([np.ones((n_obs, 1)), rng.standard_normal((n_obs, q - 1))], axis=1)
    group = rng.integers(0, groups, n_obs)
    beta_true = rng.standard_normal(p)
    u_true = np.array([0.8] + [0.5] * (q - 1)) * rng.standard_normal((groups, q))
    y = X @ beta_true + np.sum(Z * u_true[group], axis=1) + 0.5 * rng.standard_normal(n_obs)
    return {"X": X, "Z": Z, "group": group, "y": y, "beta_true": beta_true, "u_true": u_true}


def run(dtype_name):
    rng = np.random.default_rng(SEED)
    data = hierarchical_data(rng)
    dtype = jnp.dtype(dtype_name)
    index = jnp.int64 if dtype == jnp.float64 else jnp.int32
    model = HierarchicalRegression(GROUPS, Q, P, OBS, lkj_eta=ETA, dtype=dtype)
    for name, a in data.items():
        setattr(model, name, jnp.asarray(a, index if name == "group" else dtype))
    tm = tfm.transform_objective(model, model.transform)
    z0 = np.asarray(tm.unconstrain(model.initial_point()), np.float64)
    starts = z0 + 0.5 * rng.standard_normal((BATCH, z0.shape[0]))
    t0 = time.perf_counter()
    res = optimize_batched_fused(tm, jnp.asarray(starts, dtype), tol=TOL,
                                 max_iterations=MAX_ITERS, kernel="xla")
    status = np.asarray(res.status)
    iters = np.asarray(res.iterations)
    print(json.dumps({
        "fleet": f"hierarchical {BATCH}x{z0.shape[0]} {dtype_name}", "tol": TOL,
        "cpu_seconds": round(time.perf_counter() - t0, 2),
        "converged": int((status == int(qnm.Status.CONVERGED)).sum()),
        "statuses": {int(s): int((status == s).sum()) for s in np.unique(status)},
        "median": float(np.median(iters)), "max": int(iters.max()),
        "median_n_fev": float(np.median(np.asarray(res.n_fev))),
        "z0": [float(v) for v in z0],
    }), flush=True)


def main():
    if len(sys.argv) > 1:
        run(sys.argv[1])
        return
    for dtype_name, x64 in (("float32", "0"), ("float64", "1")):
        env = dict(os.environ, JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"),
                   JAX_ENABLE_X64=x64)
        subprocess.run([sys.executable, os.path.abspath(__file__), dtype_name], env=env,
                       check=True)


if __name__ == "__main__":
    main()
