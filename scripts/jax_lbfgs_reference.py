#!/usr/bin/env python3
"""The JAX package's iteration counts on the inputs of `chip_smoke.py`'s
scalar and L-BFGS phases, which `chip_smoke.py` keeps as constants (the
machine with the card has no JAX).

Runs the JAX package on the CPU in float32 (x64 off), seed 20260816:
  * `optimize` on standard_normal(60), analytic value-and-grad, tol 1e-3,
    for each update method, and DFP again without the H0 scaling (with it,
    DFP stalls on this start);
  * `optimize_lbfgs(history=10)` on the n = 4096 diagonal quadratic of
    bench_full.py:106-119 (diag = linspace(0.2, 5.0, n), x* =
    standard_normal(n) from a fresh generator, x0 = 0, tol 1e-3, at most 500
    iterations), both direction methods;
  * `optimize_lbfgs_batched` (the fused fleet, history 10, tol 1e-3, at most
    3000 iterations, analytic value-and-grad) on standard_normal((1024, 512))
    and standard_normal((256, 4096)).
One JSON line per run. ``--skip-large`` leaves out the 256 x 4096 fleet
(about two and a half minutes on a CPU).

    JAX_PLATFORMS=cpu python scripts/jax_lbfgs_reference.py
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
from quasinewtonmethods_jl_tpu.models import (  # noqa: E402
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)

SEED = 20260816


def emit(name, t0, **fields):
    print(json.dumps({"run": name, "cpu_seconds": round(time.perf_counter() - t0, 2), **fields}),
          flush=True)


def main():
    x0 = jnp.asarray(np.random.default_rng(SEED).standard_normal(60), jnp.float32)
    for method, h0_scale in (("bfgs", True), ("dfp", True), ("dfp", False), ("sr1", True)):
        t0 = time.perf_counter()
        res = qnm.optimize(rosenbrock_logdensity, x0, tol=1e-3,
                           value_and_grad_fn=rosenbrock_value_and_grad, update_method=method,
                           h0_scale=h0_scale)
        emit(f"optimize n=60 {method} h0_scale={h0_scale}", t0, status=int(res.status),
             iterations=int(res.iterations), n_fev=int(res.n_fev))

    n = 4096
    diag = jnp.asarray(np.linspace(0.2, 5.0, n), jnp.float32)
    xs = jnp.asarray(np.random.default_rng(SEED).standard_normal(n), jnp.float32)

    def quad(x):
        return -0.5 * jnp.sum(diag * (x - xs) ** 2)

    for method in ("compact", "two_loop"):
        t0 = time.perf_counter()
        res = qnm.optimize_lbfgs(quad, jnp.zeros(n, jnp.float32), history=10, tol=1e-3,
                                 max_iterations=500, direction_method=method)
        emit(f"optimize_lbfgs n=4096 {method}", t0, status=int(res.status),
             iterations=int(res.iterations), n_fev=int(res.n_fev))

    shapes = [(1024, 512)] + ([] if "--skip-large" in sys.argv else [(256, 4096)])
    for batch, width in shapes:
        X = jnp.asarray(np.random.default_rng(SEED).standard_normal((batch, width)), jnp.float32)
        t0 = time.perf_counter()
        res = qnm.optimize_lbfgs_batched(rosenbrock_logdensity, X, history=10, tol=1e-3,
                                         max_iterations=3000,
                                         value_and_grad_fn=rosenbrock_value_and_grad)
        iters = np.asarray(res.iterations)
        emit(f"optimize_lbfgs_batched {batch}x{width}", t0,
             converged=int((np.asarray(res.status) == qnm.Status.CONVERGED).sum()),
             median=float(np.median(iters)), max=int(iters.max()),
             median_n_fev=float(np.median(np.asarray(res.n_fev))))


if __name__ == "__main__":
    main()
