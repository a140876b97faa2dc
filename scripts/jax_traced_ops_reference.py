#!/usr/bin/env python3
"""The JAX package's counts on the full-width fleets of `chip_smoke.py`'s
phase 33 (B3 on the ops its trace takes since the comparisons, the
elementwise functions, mean and norms and the per-lane linear algebra
joined it), which `chip_smoke.py` keeps as constants (the machine with the
card has no JAX).

Five fleets, their data and starts drawn with numpy by
`chip_smoke.ops_data` (a fresh ``numpy.random.default_rng(20260816)`` per
fleet; imported from there, so that both packages get the same arrays), at
most 3000 iterations:
  1. pseudo-Huber regression -m·mean(sqrt(1 + r²) - 1) - |w|²/(2·10²), r =
     y - X w, on BASELINE config 3's widths (n = 100, 500 observations, X =
     N(0, 1)/10, y = X w_true + 0.5·t3 noise), 4096 N(0, 1) starts, float32,
     tol 3e-3;
  2. a Poisson GLM with a softplus link on the same widths (y ~
     Poisson(softplus(X w_true))), float32, tol 3e-3;
  3. the bounded log-density on the bench fleet's 4096 x 60 starts: per
     entry -d·(z - c)²/2 with z = clip(x, -4, 4) and d = logspace(-0.5, 1,
     60), less x² - 16 where x² >= 16,
     plus 0.2 sin z - 0.1 |x - 6| - max(x - 5, 0), less |x - c2|/2, float32,
     tol 1e-3;
  4. and 5. Gaussian-process hyperparameter MAP on 32 points in the plane,
     N(0, 1) priors on log amplitude, log lengthscale and log noise, 4096
     N(0, 1) starts, float64, tol 1e-6, written with jnp.linalg.cholesky and
     solve_triangular, and with slogdet and solve.
Every fleet goes through `optimize_batched_fused` (kernel "xla",
BackTracking) on the CPU: the engine the port's resident kernel and fleet
engine are held to. float32 fleets run with x64 off, float64 ones with it
on (one child process each). One JSON line per fleet (~13 minutes on a
CPU, ~12 of them the Cholesky form's fleet: XLA's batched float64
Cholesky on the CPU).

    JAX_PLATFORMS=cpu python scripts/jax_traced_ops_reference.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MAX_ITERS = 3000
FLEETS = (("robust", "float32", 3e-3), ("softplus poisson", "float32", 3e-3),
          ("bounded", "float32", 1e-3), ("gp cholesky", "float64", 1e-6),
          ("gp logdet", "float64", 1e-6))
PRIOR2 = 10.0 ** 2
GP_JITTER = 1e-6


def jax_objective(name, data, dtype):
    import jax
    import jax.numpy as jnp
    import jax.scipy.linalg as jsl

    def t(a):
        return jnp.asarray(a, dtype)

    if name.startswith("gp"):
        d2, y = t(data["d2"]), t(data["y"])
        eye = jnp.eye(y.shape[0], dtype=dtype)

        def K(th):
            return (jnp.exp(th[0]) * jnp.exp(-0.5 * d2 * jnp.exp(-2.0 * th[1]))
                    + (jnp.exp(th[2]) + GP_JITTER) * eye)

        if name == "gp cholesky":
            def gp(th):
                L = jnp.linalg.cholesky(K(th))
                a = jsl.solve_triangular(L, y, lower=True)
                return -0.5 * a @ a - jnp.sum(jnp.log(jnp.diagonal(L))) - 0.5 * th @ th
        else:
            def gp(th):
                Kt = K(th)
                return (-0.5 * y @ jnp.linalg.solve(Kt, y) - 0.5 * jnp.linalg.slogdet(Kt)[1]
                        - 0.5 * th @ th)
        return gp
    if name == "bounded":
        c, c2 = t(data["c"]), t(data["c2"])
        d = t(np.logspace(-0.5, 1.0, c.shape[0]))

        def bounded(x):
            z = jnp.clip(x, -4.0, 4.0)
            r2 = x * x
            q = -0.5 * d * (z - c) ** 2
            body = jnp.where(r2 < 16.0, q, q - (r2 - 16.0))
            return (jnp.sum(body) + 0.2 * jnp.sum(jnp.sin(z)) - 0.1 * jnp.sum(jnp.abs(x - 6.0))
                    - jnp.sum(jnp.maximum(x - 5.0, 0.0)) - 0.5 * jnp.linalg.norm(x - c2))
        return bounded
    X, y = t(data["X"]), t(data["y"])
    m = X.shape[0]
    if name == "robust":
        def robust(w):
            r = y - X @ w
            return -m * jnp.mean(jnp.sqrt(1.0 + r * r) - 1.0) - 0.5 * jnp.sum(w * w) / PRIOR2
        return robust

    def poisson(w):
        rate = jax.nn.softplus(X @ w)
        return jnp.sum(y * jnp.log(rate) - rate) - 0.5 * jnp.sum(w * w) / PRIOR2
    return poisson


def run(dtype_name):
    import jax.numpy as jnp

    import chip_smoke
    import quasinewtonmethods_jl_tpu as qnm
    from quasinewtonmethods_jl_tpu.batched_solve import optimize_batched_fused

    dtype = getattr(jnp, dtype_name)
    for name, fleet_dtype, tol in FLEETS:
        if fleet_dtype != dtype_name:
            continue
        data = chip_smoke.ops_data(name)
        starts = jnp.asarray(data["starts"], dtype)
        t0 = time.perf_counter()
        res = optimize_batched_fused(jax_objective(name, data, dtype), starts, tol=tol,
                                     max_iterations=MAX_ITERS, kernel="xla")
        iters = np.asarray(res.iterations)
        status = np.asarray(res.status)
        print(json.dumps({
            "run": f"optimize_batched_fused {name} {starts.shape[0]}x{starts.shape[1]} "
                   f"{dtype_name} tol {tol}",
            "cpu_seconds": round(time.perf_counter() - t0, 2),
            "converged": int((status == int(qnm.Status.CONVERGED)).sum()),
            "statuses": {int(s): int((status == s).sum()) for s in np.unique(status)},
            "median": float(np.median(iters)), "max": int(iters.max()),
            "median_n_fev": float(np.median(np.asarray(res.n_fev))),
        }), flush=True)


def main():
    if len(sys.argv) > 1:
        sys.path.insert(0, ROOT)
        run(sys.argv[1])
        return
    for dtype_name, x64 in (("float32", "0"), ("float64", "1")):
        env = dict(os.environ, JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"),
                   JAX_ENABLE_X64=x64)
        subprocess.run([sys.executable, os.path.abspath(__file__), dtype_name], env=env,
                       check=True)


if __name__ == "__main__":
    main()
