#!/usr/bin/env python3
"""The JAX package's counts on the full-width fleets of `chip_smoke.py`'s
phase 34 (B3 on log-densities written with torch.distributions), which
`chip_smoke.py` keeps as constants (the machine with the card has no JAX).

Four fleets, their data and starts drawn with numpy by
`chip_smoke.dists_data` (a fresh ``numpy.random.default_rng(20260816)`` per
fleet; imported from there, so that both packages get the same arrays), at
most 3000 iterations, each written with the `jax.scipy.stats` twins of the
torch families:
  1. and 2. negative binomial regression with an unknown dispersion
     (`nbinom.logpmf` with r = exp(s) and success probability σ(-(1 + X w -
     s)), torch's logits negated), N(0, 10²) on w and N(0, 1) on s, n = 101,
     on BASELINE config 3's widths (500 observations), float32 and float64,
     tol 3e-3;
  3. probit regression (`norm.logcdf((2y - 1)·X w)`), n = 100, float32,
     tol 3e-3;
  4. the distributions mix on the bench fleet's 4096 x 60 starts (`gamma`,
     `beta`, `poisson`, `dirichlet`, `uniform` log-densities, the Weibull's
     written out, Bernoulli with logits as jnp.maximum(z, 0) - z·y +
     log1p(exp(-|z|)), and the expm1 / lax.rsqrt / arctan2 / jnp.max
     terms), float32, tol 1e-2.
Every fleet goes through `optimize_batched_fused` (kernel "xla",
BackTracking) on the CPU: the engine the port's resident kernel and fleet
engine are held to, each fleet in a child process of its own, all at once,
float32 fleets with x64 off, float64 ones with it on. One JSON line per
fleet, in the order they finish.

    JAX_PLATFORMS=cpu python scripts/jax_traced_dists_reference.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MAX_ITERS = 3000
FLEETS = (("negbin", "float32", 3e-3), ("negbin f64", "float64", 3e-3),
          ("probit", "float32", 3e-3), ("mix", "float32", 1e-2))
PRIOR2 = 10.0 ** 2


def mix_objective(data, dtype):
    import jax.numpy as jnp
    from jax import lax
    from jax.scipy import stats

    import chip_smoke

    def t(a):
        return jnp.asarray(a, dtype)

    g, b, k, p = t(data["gamma"]), t(data["beta"]), t(data["poisson"]), t(data["dirichlet"])
    wd, u, Z, c = t(data["weibull"]), t(data["uniform"]), t(data["Z"]), t(data["c"])
    h, shift = t(data["h"]), t(data["shift"])
    at = chip_smoke.MIX_BLOCKS

    def mix(x):
        def block(name, size, skip=0):  # a block's positive parameters, exp(x/2)
            return jnp.exp(0.5 * jnp.clip(x[at[name] + skip: at[name] + skip + size], -20.0,
                                          20.0))

        lp = jnp.sum(stats.gamma.logpdf(g, block("gamma", 5), scale=1.0 / block("gamma", 5, 5)))
        lp = lp + jnp.sum(stats.beta.logpdf(b, block("beta", 1), block("beta", 1, 1)))
        lp = lp + jnp.sum(stats.poisson.logpmf(k, block("poisson", 10)))
        lp = lp + jnp.sum(stats.dirichlet.logpdf(p.T, block("dirichlet", 10)))
        scale, conc = block("weibull", 5), block("weibull", 5, 5)
        lp = lp + jnp.sum(jnp.log(conc / scale) + (conc - 1.0) * jnp.log(wd / scale)
                          - (wd / scale) ** conc)
        low, high = -0.5 - block("uniform", 2), 0.5 + block("uniform", 2, 2)
        lp = lp + jnp.sum(stats.uniform.logpdf(u, low, high - low))
        z = Z @ x[at["bernoulli"]:]
        lp = lp - jnp.sum(jnp.maximum(z, 0.0) - z * c + jnp.log1p(jnp.exp(-jnp.abs(z))))
        xs = {name: x[at[name]: at[name] + 10] for name in ("gamma", "beta", "poisson", "weibull")}
        return (lp - 0.1 * jnp.sum(jnp.expm1(0.2 * xs["gamma"]))
                + 0.1 * jnp.sum(lax.rsqrt(1.0 + xs["beta"] ** 2))
                + 0.05 * jnp.sum(jnp.arctan2(xs["weibull"], h))
                + 0.1 * jnp.max(xs["poisson"] + shift) - 0.5 * jnp.sum(x * x))
    return mix


def jax_objective(name, data, dtype):
    import jax
    import jax.numpy as jnp
    from jax.scipy import stats

    kind = name.split()[0]
    if kind == "mix":
        return mix_objective(data, dtype)
    X, y = jnp.asarray(data["X"], dtype), jnp.asarray(data["y"], dtype)
    m = X.shape[1]
    if kind == "negbin":
        def negbin(th):
            w, s = th[:m], th[m]
            logits = X @ w + 1.0 - s
            lp = stats.nbinom.logpmf(y, jnp.exp(s), jax.nn.sigmoid(-logits))
            return jnp.sum(lp) - 0.5 * jnp.sum(w * w) / PRIOR2 - 0.5 * s * s
        return negbin
    sign = 2.0 * y - 1.0

    def probit(w):
        return jnp.sum(stats.norm.logcdf(sign * (X @ w))) - 0.5 * jnp.sum(w * w) / PRIOR2
    return probit


def run(fleet):
    import jax.numpy as jnp

    import chip_smoke
    import quasinewtonmethods_jl_tpu as qnm
    from quasinewtonmethods_jl_tpu.batched_solve import optimize_batched_fused

    for name, dtype_name, tol in FLEETS:
        if name != fleet:
            continue
        dtype = getattr(jnp, dtype_name)
        data = chip_smoke.dists_data(name)
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
    children = []
    for name, dtype_name, _ in FLEETS:
        env = dict(os.environ, JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"),
                   JAX_ENABLE_X64="1" if dtype_name == "float64" else "0")
        children.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), name],
                                         env=env))
    if any(child.wait() for child in children):
        sys.exit("a fleet's run failed")


if __name__ == "__main__":
    main()
