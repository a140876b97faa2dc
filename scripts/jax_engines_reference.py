#!/usr/bin/env python3
"""The JAX package's counts on the full-width fleets of `chip_smoke.py`'s
phase 24 (least squares, trust region, the augmented Lagrangian and the
constrained `minimize`), which `chip_smoke.py` keeps as constants (the
machine with the card has no JAX).

The fleets are bench_full.py's configurations 8, 9 and 14, in float32
(x64 off), their data and starts drawn with numpy, each from its own
``numpy.random.default_rng(20260816)`` (`chip_smoke.py` draws them the same
way):

- LM (config 8, bench_full.py:149-166): t = linspace(0, 1, 40), amplitude
  uniform(0.5, 3.0, 4096), rate uniform(-2.5, -0.5, 4096), y = amplitude ·
  exp(rate · t), all float32; starts (1, 0);
  ``least_squares(resid8, X, data=(t, y), tol=1e-3)``;
- TR (config 9, :168-185): Q from the QR of standard_normal((256, 256)),
  A = Q diag(geomspace(1, 1e4, 256)) Qᵀ, b = standard_normal(256), starts
  standard_normal((1024, 256)); ``optimize_tr(quad9, X, tol=1e-3,
  max_cg=256)``;
- auglag (config 14, :240-260): starts standard_normal((4096, 60));
  ``optimize_auglag(rosenbrock_logdensity, X, ineq=30 - x·x, engine=...,
  tol=1e-3, ctol=1e-3, max_iterations=2000)`` with engine "cg" (config 14)
  and "bfgs"; then ``minimize(rosenbrock, X[:64], ineq=..., method="bfgs",
  tol=1e-3, ctol=1e-3, max_iterations=2000)`` on the minimized Rosenbrock.

Prints one JSON line per fleet: converged count, status counts, the median
and max of ``iterations`` (and of ``n_hev`` for TR, of ``n_outer`` for
auglag), max viol over converged lanes, and seconds on this CPU (a few
minutes in all).

    JAX_PLATFORMS=cpu python scripts/jax_engines_reference.py
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
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity  # noqa: E402

SEED = 20260816
LM_BATCH, LM_M = 4096, 40
TR_BATCH, TR_N = 1024, 256
AUG_BATCH, AUG_N, AUG_MIN_LANES = 4096, 60, 64
TOL = 1e-3


def lm_data():
    rng = np.random.default_rng(SEED)
    t = np.linspace(0.0, 1.0, LM_M, dtype=np.float32)
    amp = rng.uniform(0.5, 3.0, LM_BATCH).astype(np.float32)
    rate = rng.uniform(-2.5, -0.5, LM_BATCH).astype(np.float32)
    y = amp[:, None] * np.exp(rate[:, None] * t[None, :])
    X = np.tile(np.array([1.0, 0.0], np.float32), (LM_BATCH, 1))
    return X, (np.tile(t, (LM_BATCH, 1)), y)


def tr_data():
    rng = np.random.default_rng(SEED)
    Q, _ = np.linalg.qr(rng.standard_normal((TR_N, TR_N)))
    A = ((Q * np.geomspace(1.0, 1e4, TR_N)) @ Q.T).astype(np.float32)
    b = rng.standard_normal(TR_N).astype(np.float32)
    X = rng.standard_normal((TR_BATCH, TR_N)).astype(np.float32)
    return X, A, b


def auglag_data():
    return np.random.default_rng(SEED).standard_normal((AUG_BATCH, AUG_N)).astype(np.float32)


def summary(name, res, seconds, extra=()):
    status = np.asarray(res.status)
    out = {"fleet": name, "lanes": int(status.size),
           "converged": int((status == int(qnm.Status.CONVERGED)).sum()),
           "status_counts": {int(k): int(v) for k, v in zip(*np.unique(status, return_counts=True))},
           "iterations_median": float(np.median(np.asarray(res.iterations))),
           "iterations_max": int(np.asarray(res.iterations).max())}
    for field in extra:
        v = np.asarray(getattr(res, field))
        out[f"{field}_median"] = float(np.median(v))
        out[f"{field}_max"] = float(v.max())
    if hasattr(res, "viol"):
        ok = status == int(qnm.Status.CONVERGED)
        out["max_viol_converged"] = float(np.asarray(res.viol)[ok].max()) if ok.any() else None
    out["seconds"] = round(seconds, 1)
    print(json.dumps(out), flush=True)


def timed(fn):
    t0 = time.perf_counter()
    res = fn()
    np.asarray(res.status)
    return res, time.perf_counter() - t0


def main():
    X, (t, y) = lm_data()

    def resid8(p, d):
        tt, yy = d
        return p[..., 0:1] * jnp.exp(p[..., 1:2] * tt) - yy

    res, s = timed(lambda: qnm.least_squares(resid8, jnp.asarray(X),
                                             data=(jnp.asarray(t), jnp.asarray(y)), tol=TOL))
    summary("lm", res, s)

    X, A, b = tr_data()
    Aj, bj = jnp.asarray(A), jnp.asarray(b)

    def quad9(x):
        return -0.5 * x @ (Aj @ x) + bj @ x

    res, s = timed(lambda: qnm.optimize_tr(quad9, jnp.asarray(X), tol=TOL, max_cg=256))
    summary("tr", res, s, ("n_hev",))

    X = jnp.asarray(auglag_data())

    def disk14(x):
        return 30.0 - jnp.sum(x * x)

    for engine in ("cg", "bfgs"):
        res, s = timed(lambda: qnm.optimize_auglag(rosenbrock_logdensity, X, ineq=disk14,
                                                   engine=engine, tol=TOL, ctol=TOL,
                                                   max_iterations=2000))
        summary(f"auglag_{engine}", res, s, ("n_outer",))

    def rosen_min(x):
        return -rosenbrock_logdensity(x)

    res, s = timed(lambda: qnm.minimize(rosen_min, X[:AUG_MIN_LANES], ineq=disk14, method="bfgs",
                                        tol=TOL, ctol=TOL, max_iterations=2000))
    summary("minimize_bfgs", res, s, ("n_outer",))


if __name__ == "__main__":
    main()
