#!/usr/bin/env python3
"""The JAX package's counts on the full-width fleets of `chip_smoke.py`'s
phase 35 (B3 on softmax, constant-index gathers, shape-only factories,
per-lane values of rank 3, prod / cumprod), which `chip_smoke.py` keeps as
constants (the machine with the card has no JAX).

Three fleets, their data and starts drawn with numpy by
`chip_smoke.softmax_data` (a fresh ``numpy.random.default_rng(20260816)``
per fleet; imported from there, so that both packages get the same arrays),
at most 3000 iterations, each the jnp twin of the torch objective:
  1. softmax regression (`jax.nn.log_softmax` and `jnp.take_along_axis`, a
     N(0, 1) prior on W), 25 features x 4 classes on BASELINE config 3's 500
     observations, n = 100, float32, tol 3e-3;
  2. a multivariate normal with unknown mean and Cholesky factor (L =
     diag(exp(d)) + a strictly lower triangle from the point), d = 6, 200
     observations, n = 27, float64, tol `chip_smoke.MVN_TOL`, written as torch's
     D.MultivariateNormal computes it, a triangular solve by L and the log
     of L's diagonal (`multivariate_normal.logpdf` factorizes L Lᵀ again,
     which fails at far line-search trials where torch's solve does not;
     tests/test_torch_objective_softmax.py holds the two to each other
     where both are finite);
  3. the K = 4 mixture of normals on 500 points and its stick-breaking
     twin (`jax.nn.log_softmax` of the logits; `jnp.cumprod` of 1 -
     sigmoid(b)), Gumbel and inverse-gamma priors written out, n = 25,
     float64, tol `chip_smoke.MIX_TOL` (in float32 the fleet ends on
     float32's floor below tol 0.1, and lanes of the port's float32 run
     end there at 0.1 too).
Every fleet goes through `optimize_batched_fused` (kernel "xla",
BackTracking) on the CPU: the engine the port's resident kernel and fleet
engine are held to, each fleet in a child process of its own, all at once,
float32 fleets with x64 off, float64 ones with it on. One JSON line per
fleet, in the order they finish.

    JAX_PLATFORMS=cpu python scripts/jax_traced_softmax_reference.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MAX_ITERS = 3000


def fleets():
    import chip_smoke

    return (("regression", "float32", chip_smoke.LOGISTIC_TOL),
            ("mvn", "float64", chip_smoke.MVN_TOL), ("mixture", "float64", chip_smoke.MIX_TOL))


def jax_objective(name, data, dtype):
    import jax
    import jax.numpy as jnp
    import jax.scipy.linalg  # noqa: F401 - jax.scipy.linalg.solve_triangular
    from jax.scipy import special, stats

    import chip_smoke

    def t(a):
        return jnp.asarray(a, dtype)

    if name == "regression":
        X, y = t(data["X"]), jnp.asarray(data["y"])
        shape = (chip_smoke.SOFTMAX_FEATURES, chip_smoke.SOFTMAX_CLASSES)

        def regression(th):
            logp = jax.nn.log_softmax(X @ th.reshape(shape), axis=1)
            return jnp.sum(jnp.take_along_axis(logp, y[:, None], axis=1)) - 0.5 * jnp.sum(th * th)
        return regression
    if name == "mvn":
        d, V = chip_smoke.MVN_D, t(data["V"])
        rows, cols = np.tril_indices(d, -1)

        def mvn(th):  # torch's formula: a triangular solve by L, the log of L's diagonal
            mu, logd, lower = th[:d], th[d:2 * d], th[2 * d:]
            L = jnp.diag(jnp.exp(logd)) + jnp.zeros((d, d), dtype).at[rows, cols].set(lower)
            z = jax.scipy.linalg.solve_triangular(L, (V - mu).T, lower=True)
            lp = (-0.5 * jnp.sum(z * z) - V.shape[0] * (jnp.sum(jnp.log(jnp.diagonal(L)))
                                                       + 0.5 * d * jnp.log(2.0 * jnp.pi)))
            return lp - 0.005 * jnp.sum(mu * mu) - 0.5 * jnp.sum(th[d:] * th[d:])
        return mvn
    v, K = t(data["v"]), chip_smoke.MIX_K

    def gumbel(x, loc, scale):  # D.Gumbel's log-density
        z = (x - loc) / scale
        return -(z + jnp.exp(-z)) - jnp.log(scale)

    def inverse_gamma(x, conc, rate):  # D.InverseGamma's log-density
        return conc * jnp.log(rate) - special.gammaln(conc) - (conc + 1.0) * jnp.log(x) - rate / x

    def mixture(th):
        a, mu, b, nu = th[:K], th[K:2 * K], th[3 * K:4 * K - 1], th[4 * K - 1:5 * K - 1]
        s = 15.0 * jnp.tanh(th[2 * K:3 * K] / 15.0)  # log-sds within ±15, as the torch twin's
        r = 15.0 * jnp.tanh(th[5 * K - 1:6 * K - 1] / 15.0)
        m, c = th[6 * K - 1], th[6 * K]
        lp = jnp.sum(special.logsumexp(jax.nn.log_softmax(a)
                                       + stats.norm.logpdf(v[:, None], mu, jnp.exp(s)), axis=1))
        u = jax.nn.sigmoid(b)
        one = jnp.ones((1,), dtype)
        w = jnp.concatenate([u, one]) * jnp.concatenate([one, jnp.cumprod(1.0 - u)])
        lp = lp + jnp.sum(special.logsumexp(jnp.log(w)
                                            + stats.norm.logpdf(v[:, None], nu, jnp.exp(r)),
                                            axis=1))
        for loc, logsd in ((mu, s), (nu, r)):
            lp = lp + jnp.sum(gumbel(loc, m, 2.0))
            lp = lp + jnp.sum(inverse_gamma(jnp.exp(2.0 * logsd), 2.0, jnp.exp(c)) + 2.0 * logsd)
        return lp - 0.5 * (jnp.sum(a * a) + jnp.sum(b * b) + m * m + c * c)
    return mixture


def run(fleet, tol=None):
    import jax.numpy as jnp

    import chip_smoke
    import quasinewtonmethods_jl_tpu as qnm
    from quasinewtonmethods_jl_tpu.batched_solve import optimize_batched_fused

    for name, dtype_name, fleet_tol in fleets():
        if name != fleet:
            continue
        tol = fleet_tol if tol is None else tol
        dtype = getattr(jnp, dtype_name)
        data = chip_smoke.softmax_data(name)
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
    sys.path.insert(0, ROOT)
    if len(sys.argv) > 1:
        run(sys.argv[1], float(sys.argv[2]) if len(sys.argv) > 2 else None)
        return
    children = []
    for name, dtype_name, _ in fleets():
        env = dict(os.environ, JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"),
                   JAX_ENABLE_X64="1" if dtype_name == "float64" else "0")
        children.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), name],
                                         env=env))
    if any(child.wait() for child in children):
        sys.exit("a fleet's run failed")


if __name__ == "__main__":
    main()
