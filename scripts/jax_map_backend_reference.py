#!/usr/bin/env python3
"""The JAX package's numbers for `chip_smoke.py`'s phase 25 (the MAP back
end: multistart, Newton polish, Laplace evidence, the implicit gradient and
the chain diagnostics), which `chip_smoke.py` keeps as constants (the
machine with the card has no JAX).

- (a) `optimize_multistart(rosenbrock_logdensity, None, 4096, 60, x0s=X,
  tol=1e-3, max_iterations=3000)` on the bench fleet (X =
  ``numpy.random.default_rng(20260816).standard_normal((4096, 60))`` in
  float32, autodiff gradients), x64 off: converged count, the median and
  max of ``iterations``, best index and value; then `laplace_evidence` on
  the fleet's own ``state.B`` (float32, the BFGS screen).
- (b) `polish_newton(rosenbrock_logdensity, fleet, steps=3,
  dtype=float64)` on those 4096 lanes, x64 on: the ``improved`` count, the
  median and max of ``grad_norm_after``.
- (c) `laplace_evidence(polished, obj=rosenbrock_logdensity)` (exact, f64):
  its median, and the median and max of |exact - B| per lane.
- (f) `optimize_implicit` of one f64 solve of obj(x, log_s) = the logistic
  log-likelihood of BASELINE config 3's data (500 x 100, drawn as
  `chip_smoke.py`'s phase 20 draws it) plus a N(0, exp(log_s)²) prior on
  x, at log_s = 0.7 from x0 = 0: fun, d fun / d log_s and d sum(x*) /
  d log_s by ``jax.grad``.
- (g) AR(1) chains, phi = 0.9, shape (1000, 64, 60), drawn by
  ``numpy.random.default_rng(20260816)`` (x_0 = e_0 / sqrt(1 - phi²),
  x_t = phi x_{t-1} + e_t), f64, and their energies 0.5 Σ x² per draw and
  chain: every ``*_device`` function, each summarized by [sum, min, max,
  first element].

The float32 stage runs with x64 off and the float64 stage with it on, one
child process each; the fleet crosses between them as an .npz in a
temporary directory. Prints one JSON line per stage (~1 min on a CPU):

    JAX_PLATFORMS=cpu python scripts/jax_map_backend_reference.py
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SEED = 20260816
BATCH, N = 4096, 60
TOL, MAX_ITERS = 1e-3, 3000
LOGISTIC_N, LOGISTIC_OBS, LOG_S = 100, 500, 0.7
DRAWS, CHAINS, DIAG_N, PHI = 1000, 64, 60, 0.9


def bench_fleet():
    import numpy as np

    return np.random.default_rng(SEED).standard_normal((BATCH, N)).astype(np.float32)


def logistic_data():
    """Config 3's data in the order chip_smoke.logistic_data draws it."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    X = rng.standard_normal((LOGISTIC_OBS, LOGISTIC_N)) / np.sqrt(LOGISTIC_N)
    w_true = rng.standard_normal(LOGISTIC_N)
    y = (rng.random(LOGISTIC_OBS) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    return X, y


def ar1_chains():
    import numpy as np

    eps = np.random.default_rng(SEED).standard_normal((DRAWS, CHAINS, DIAG_N))
    x = np.empty_like(eps)
    x[0] = eps[0] / np.sqrt(1.0 - PHI * PHI)
    for t in range(1, DRAWS):
        x[t] = PHI * x[t - 1] + eps[t]
    return x


def summary(v):
    import numpy as np

    v = np.asarray(v, np.float64)
    return [float(v.sum()), float(v.min()), float(v.max()), float(v.reshape(-1)[0])]


def stage_f32(path):
    import jax.numpy as jnp
    import numpy as np

    import quasinewtonmethods_jl_tpu as qnm
    from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity

    t0 = time.perf_counter()
    ms = qnm.optimize_multistart(rosenbrock_logdensity, None, BATCH, N,
                                 x0s=jnp.asarray(bench_fleet()), tol=TOL,
                                 max_iterations=MAX_ITERS)
    fleet = ms.fleet
    iters = np.asarray(fleet.iterations)
    lz_b = np.asarray(qnm.laplace_evidence(fleet))
    seconds = time.perf_counter() - t0
    np.savez(path, x=np.asarray(fleet.x), status=np.asarray(fleet.status), lz_b=lz_b)
    print(json.dumps({
        "stage": "multistart f32", "converged": int(ms.n_converged),
        "median_iterations": float(np.median(iters)), "max_iterations": int(iters.max()),
        "best_index": int(ms.best_index), "fun": float(ms.fun),
        "laplace_b_median": float(np.median(lz_b)), "seconds": seconds,
    }), flush=True)


class _Fleet(NamedTuple):
    x: object
    status: object


def stage_f64(path):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import quasinewtonmethods_jl_tpu as qnm
    from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity

    out = {"stage": "f64"}
    with np.load(path) as z:
        fleet = _Fleet(jnp.asarray(z["x"]), jnp.asarray(z["status"]))
        lz_b = z["lz_b"]
    t0 = time.perf_counter()
    pol = qnm.polish_newton(rosenbrock_logdensity, fleet, steps=3, dtype=jnp.float64)
    after = np.asarray(pol.grad_norm_after)
    out.update(polish_improved=int(np.asarray(pol.improved).sum()),
               polish_after_median=float(np.median(after)), polish_after_max=float(after.max()),
               polish_seconds=time.perf_counter() - t0)
    lz = np.asarray(qnm.laplace_evidence(pol, obj=rosenbrock_logdensity))
    gap = np.abs(lz - lz_b)
    out.update(laplace_exact_median=float(np.median(lz)), laplace_gap_median=float(np.median(gap)),
               laplace_gap_max=float(gap.max()))

    Xd, yd = (jnp.asarray(a) for a in logistic_data())

    def obj(w, log_s):
        logits = Xd @ w
        loglik = jnp.sum(yd * jax.nn.log_sigmoid(logits) + (1 - yd) * jax.nn.log_sigmoid(-logits))
        return loglik - 0.5 * jnp.sum(w * w) * jnp.exp(-2.0 * log_s) - LOGISTIC_N * log_s

    def solve(log_s):
        return qnm.optimize_implicit(obj, jnp.zeros(LOGISTIC_N), log_s)

    x_star, fun = solve(jnp.asarray(LOG_S))
    out.update(implicit_fun=float(fun), implicit_sum_x=float(jnp.sum(x_star)),
               implicit_dfun=float(jax.grad(lambda s: solve(s)[1])(LOG_S)),
               implicit_dsum_x=float(jax.grad(lambda s: jnp.sum(solve(s)[0]))(LOG_S)))

    x = jnp.asarray(ar1_chains())
    energies = 0.5 * jnp.sum(x * x, axis=-1)
    diag = qnm.diagnose_chains_device(x, rank=True)
    out["diagnostics"] = {
        "split_rhat": summary(qnm.split_rhat_device(x)),
        "ess": summary(qnm.ess_device(x)),
        "rank_normalized_rhat": summary(qnm.rank_normalized_rhat_device(x)),
        "tail_ess": summary(qnm.tail_ess_device(x)),
        "mean": summary(diag.mean), "std": summary(diag.std),
        "energy_bfmi": summary(qnm.energy_bfmi_device(energies)),
    }
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) > 2:
        {"float32": stage_f32, "float64": stage_f64}[sys.argv[1]](sys.argv[2])
        return
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fleet.npz")
        for stage, x64 in (("float32", "0"), ("float64", "1")):
            env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64=x64)
            subprocess.run([sys.executable, os.path.abspath(__file__), stage, path], env=env,
                           check=True)


if __name__ == "__main__":
    main()
