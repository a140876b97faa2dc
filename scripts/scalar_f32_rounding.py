#!/usr/bin/env python3
"""Whether DFP and SR1 converge on bench_full.py's n = 60 Rosenbrock start
(seed 20260816, tol 1e-3, analytic gradient) in float32, in the JAX package
and in the port, both on the CPU: the evidence behind `chip_smoke.py`'s
holding the port's float32 DFP and SR1 on the card to the JAX package's
share of converged starts.

Prints, one line each: JAX's DFP with the H0 scaling given 100000
iterations; both packages' SR1 from the start; JAX's SR1 resumed from the
port's state after 480 and 490 iterations. Then, for two sets of 32
starts, the (status, iterations) of each package's DFP without the H0
scaling and SR1 in float32, and of the port's DFP without the H0 scaling
in float64, with each row's count of converged starts and of distinct
outcomes:
  * "ulp": the start and its 31 neighbours one float32 ulp away in one
    coordinate (start k moves coordinate k up). Rounding absorbs many such
    nudges within the first iterations, so starts share a trajectory;
  * "perturbed": `perturbed_starts`, each a trajectory of its own; for them
    also how many of the first 16 converged within 3000 iterations, the
    JAX counts `chip_smoke.py` keeps.

    JAX_PLATFORMS=cpu python scripts/scalar_f32_rounding.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import quasinewtonmethods_jl_tpu as qj  # noqa: E402
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_f  # noqa: E402
from quasinewtonmethods_jl_tpu.models import rosenbrock_value_and_grad as jax_vg  # noqa: E402
import quasinewtonmethods_jl_tpu_torch as qt  # noqa: E402
from quasinewtonmethods_jl_tpu_torch.models import (  # noqa: E402
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)

SEED = 20260816
KW = dict(tol=1e-3)
STARTS, CARD_STARTS, CARD_CAP = 32, 16, 3000


def perturbed_starts(count, seed=SEED, n=60):
    """float32 starts: the bench start (standard_normal(n), seed ``seed``),
    then start k = the bench start plus 1e-6 * standard_normal(n) from seed
    ``seed + k`` (chip_smoke.py makes the same)."""
    x = np.random.default_rng(seed).standard_normal(n)
    return [(x if k == 0 else x + 1e-6 * np.random.default_rng(seed + k).standard_normal(n))
            .astype(np.float32) for k in range(count)]


def ulp_starts(count, seed=SEED, n=60):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    out = []
    for k in range(count):
        xk = x.copy()
        if k:
            xk[k] = np.nextafter(xk[k], np.float32(np.inf))
        out.append(xk)
    return out


def jax_run(x, method, h0_scale=True, **kw):
    r = qj.optimize(jax_f, jnp.asarray(x), value_and_grad_fn=jax_vg, update_method=method,
                    h0_scale=h0_scale, **KW, **kw)
    return int(r.status), int(r.iterations)


def port_run(x, method, h0_scale=True, **kw):
    r = qt.optimize(rosenbrock_logdensity, torch.tensor(x), value_and_grad_fn=rosenbrock_value_and_grad,
                    update_method=method, h0_scale=h0_scale, **KW, **kw)
    return r, (int(r.status), int(r.iterations))


def table(label, starts):
    rows = {"JAX dfp f32 (h0 off)": lambda x: jax_run(x, "dfp", False),
            "port dfp f32 (h0 off)": lambda x: port_run(x, "dfp", False)[1],
            "JAX sr1 f32": lambda x: jax_run(x, "sr1"),
            "port sr1 f32": lambda x: port_run(x, "sr1")[1],
            "port dfp f64 (h0 off)": lambda x: port_run(x.astype(np.float64), "dfp", False)[1]}
    converged = int(qj.Status.CONVERGED)
    for name, run in rows.items():
        row = [run(x) for x in starts]
        ok = [status == converged for status, _ in row]
        within = sum(status == converged and it <= CARD_CAP for status, it in row[:CARD_STARTS])
        print(f"{label} starts, {name}: converged {sum(ok)}/{len(row)}, "
              f"{len(set(row))} distinct outcomes; first {CARD_STARTS} converged within "
              f"{CARD_CAP} iterations: {within}; {row}", flush=True)


def main():
    x = perturbed_starts(1)[0]
    print("JAX dfp f32, h0 scaling, cap 100000:", jax_run(x, "dfp", max_iterations=100_000))
    print("JAX sr1 f32:", jax_run(x, "sr1"), " port sr1 f32:", port_run(x, "sr1")[1])
    for cap in (480, 490):
        part, _ = port_run(x, "sr1", max_iterations=cap)
        state = qj.BFGSState(*jax.tree_util.tree_map(jnp.asarray, qt.bfgs_state_to_numpy(part.state)))
        r = qj.optimize_from_state(jax_f, state, value_and_grad_fn=jax_vg, update_method="sr1", **KW)
        print(f"JAX sr1 f32 from the port's state at iteration {cap}:",
              (int(r.status), int(r.iterations)), flush=True)
    table("ulp", ulp_starts(STARTS))
    table("perturbed", perturbed_starts(STARTS))


if __name__ == "__main__":
    main()
