#!/usr/bin/env python3
"""The JAX package's counts on the fixture fleets of `chip_smoke.py`'s
phase 21, which `chip_smoke.py` keeps as constants (the machine with the
card has no JAX).

Five full-width fleets of 4096 starts, each drawn with numpy from a fresh
``numpy.random.default_rng(20260816)`` in the order below, so that both
packages get the same arrays (`chip_smoke.py :: fixture_data` draws them
the same way):
  * funnel n = 4 (tests/test_edge_cases.py:91-110's shape), float64, tol
    1e-6: starts standard_normal((4096, 4));
  * Gaussian mixture K = 8, n = 60, sigma 4, uniform weights, float32, tol
    1e-3: means 3·standard_normal((8, 60)), then starts
    3·standard_normal((4096, 60));
  * Poisson GLM n = 50, 400 observations, prior scale 10
    (tests/test_baseline_configs.py:69-90), float32 at tol 1e-2 and float64
    at tol 1e-6: X = standard_normal((400, 50)) / sqrt(50), w_true =
    0.5·standard_normal(50), y = poisson(exp(X w_true)), then starts
    standard_normal((4096, 50));
  * AR(1) with drift, dimension 8, 32 steps, spectral radius 0.6, obs
    scale 0.5, prior scale 10 (models/statespace.py:37-45's defaults),
    float64, tol 1e-6: A = standard_normal((8, 8)) scaled to the spectral
    radius (numpy eigvals), w_true = standard_normal(8), the recursion
    from z_0 = 0, ys = z + 0.5·standard_normal((32, 8)), then starts
    standard_normal((4096, 8)).
Each JAX model is built and then given those arrays. Every fleet goes
through `optimize_batched_fused` (kernel "xla", BackTracking, at most 3000
iterations) on the CPU: the engine the port's resident kernel and fleet
engine are held to. float32 fleets run with x64 off, float64 ones with it
on (one child process each). One JSON line per fleet (a few minutes on a
CPU).

    JAX_PLATFORMS=cpu python scripts/jax_fixture_reference.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 20260816
BATCH, MAX_ITERS = 4096, 3000
FUNNEL_N = 4
MIXTURE_K, MIXTURE_N, MIXTURE_SIGMA = 8, 60, 4.0
POISSON_N, POISSON_OBS, POISSON_PRIOR = 50, 400, 10.0
AR1_N, AR1_STEPS, AR1_RADIUS, AR1_OBS_SCALE, AR1_PRIOR = 8, 32, 0.6, 0.5, 10.0
# (fixture, dtype, tol): the fleets of phase 21
FLEETS = (("funnel", "float64", 1e-6), ("mixture", "float32", 1e-3),
          ("poisson", "float32", 1e-2), ("poisson", "float64", 1e-6),
          ("ar1", "float64", 1e-6))


def fixture_data(name):
    """The fixture's data and its fleet's starts, float64 numpy, as
    chip_smoke.py draws them."""
    rng = np.random.default_rng(SEED)
    if name == "funnel":
        return {"starts": rng.standard_normal((BATCH, FUNNEL_N))}
    if name == "mixture":
        means = 3.0 * rng.standard_normal((MIXTURE_K, MIXTURE_N))
        return {"means": means, "starts": 3.0 * rng.standard_normal((BATCH, MIXTURE_N))}
    if name == "poisson":
        X = rng.standard_normal((POISSON_OBS, POISSON_N)) / np.sqrt(POISSON_N)
        w_true = 0.5 * rng.standard_normal(POISSON_N)
        y = rng.poisson(np.exp(X @ w_true)).astype(np.float64)
        return {"X": X, "y": y, "starts": rng.standard_normal((BATCH, POISSON_N))}
    A = rng.standard_normal((AR1_N, AR1_N))
    A = A * (AR1_RADIUS / np.max(np.abs(np.linalg.eigvals(A))))
    w_true = rng.standard_normal(AR1_N)
    z, zs = np.zeros(AR1_N), []
    for _ in range(AR1_STEPS):
        z = A @ z + w_true
        zs.append(z)
    ys = np.stack(zs) + AR1_OBS_SCALE * rng.standard_normal((AR1_STEPS, AR1_N))
    return {"A": A, "ys": ys, "w_true": w_true, "starts": rng.standard_normal((BATCH, AR1_N))}


def jax_model(name, data, dtype):
    import jax.numpy as jnp

    from quasinewtonmethods_jl_tpu.models import (
        AR1DriftMAP,
        GaussianMixture,
        PoissonRegressionMAP,
        funnel_logdensity,
    )

    if name == "funnel":
        return funnel_logdensity
    if name == "mixture":
        return GaussianMixture(jnp.asarray(data["means"], dtype), sigmas=MIXTURE_SIGMA)
    if name == "poisson":
        model = PoissonRegressionMAP(POISSON_N, POISSON_OBS, prior_scale=POISSON_PRIOR, dtype=dtype)
        model.X, model.y = jnp.asarray(data["X"], dtype), jnp.asarray(data["y"], dtype)
        return model
    model = AR1DriftMAP(AR1_N, AR1_STEPS, spectral_radius=AR1_RADIUS, obs_scale=AR1_OBS_SCALE,
                        prior_scale=AR1_PRIOR, dtype=dtype)
    model.A, model.ys = jnp.asarray(data["A"], dtype), jnp.asarray(data["ys"], dtype)
    model.w_true = jnp.asarray(data["w_true"], dtype)
    return model


def run(dtype_name):
    import jax.numpy as jnp

    import quasinewtonmethods_jl_tpu as qnm
    from quasinewtonmethods_jl_tpu.batched_solve import optimize_batched_fused

    dtype = getattr(jnp, dtype_name)
    for name, fleet_dtype, tol in FLEETS:
        if fleet_dtype != dtype_name:
            continue
        data = fixture_data(name)
        model = jax_model(name, data, dtype)
        t0 = time.perf_counter()
        res = optimize_batched_fused(model, jnp.asarray(data["starts"], dtype), tol=tol,
                                     max_iterations=MAX_ITERS, kernel="xla")
        iters = np.asarray(res.iterations)
        status = np.asarray(res.status)
        print(json.dumps({
            "run": f"optimize_batched_fused {name} {BATCH}x{data['starts'].shape[1]} "
                   f"{dtype_name} tol {tol}",
            "cpu_seconds": round(time.perf_counter() - t0, 2),
            "converged": int((status == int(qnm.Status.CONVERGED)).sum()),
            "statuses": {int(s): int((status == s).sum()) for s in np.unique(status)},
            "median": float(np.median(iters)), "max": int(iters.max()),
            "median_n_fev": float(np.median(np.asarray(res.n_fev))),
        }), flush=True)


def main():
    if len(sys.argv) > 1:
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
        run(sys.argv[1])
        return
    for dtype_name, x64 in (("float32", "0"), ("float64", "1")):
        env = dict(os.environ, JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"),
                   JAX_ENABLE_X64=x64)
        subprocess.run([sys.executable, os.path.abspath(__file__), dtype_name], env=env,
                       check=True)


if __name__ == "__main__":
    main()
