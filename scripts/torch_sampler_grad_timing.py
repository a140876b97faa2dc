#!/usr/bin/env python3
"""Seconds per HMC transition of the port's two fleet-gradient routes on
the card, in turns: the autodiff gradient as one autograd pass through the
vmapped logdensity (the samplers' route for a model without its own
gradient, `sampling._batched_objective`) against ``vmap(grad_and_value)``
(the route an explicit ``value_and_grad_fn`` takes; here the model's own
``torch.func`` gradient passed as one).

BASELINE config 3's logistic posterior (n = 100, 500 observations, prior
scale 10, float32) with 4096 chains from numpy seed 20260816, as
`chip_smoke.py`'s phase 26; identity mass, no warmup, 16 leapfrog steps,
``TRANSITIONS`` draws a call, after one warm-up call of each route; the
turns run autograd, vmap, vmap, autograd, ... Prints one JSON line.

    python3 scripts/torch_sampler_grad_timing.py
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import quasinewtonmethods_jl_tpu_torch as qt  # noqa: E402

SEED, CHAINS, N, N_OBS, PRIOR = 20260816, 4096, 100, 500, 10.0
TRANSITIONS, LEAPFROG, TURNS = 30, 16, 4


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_sampler_grad_timing: needs a CUDA card")
    rng = np.random.default_rng(SEED)
    X = rng.standard_normal((N_OBS, N)) / np.sqrt(N)
    y = (rng.random(N_OBS) < 1.0 / (1.0 + np.exp(-(X @ rng.standard_normal(N))))).astype(float)
    model = qt.LogisticRegressionMAP(N, N_OBS, prior_scale=PRIOR, X=X, y=y,
                                     dtype=torch.float32, device="cuda")
    x0s = torch.tensor(0.1 * rng.standard_normal((CHAINS, N)), dtype=torch.float32,
                       device="cuda")
    routes = {"autograd": None, "vmap": qt.as_value_and_grad(model)}

    def call(route):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = qt.hmc_sample(model, SEED, x0s, n_samples=TRANSITIONS, n_warmup=0,
                            n_leapfrog=LEAPFROG, step_size=0.05,
                            value_and_grad_fn=routes[route])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res.samples

    first = {k: call(k) for k in routes}
    same = bool(torch.equal(first["autograd"][1], first["vmap"][1]))
    secs = {k: [] for k in routes}
    for turn in range(TURNS):
        for k in (list(routes) if turn % 2 == 0 else list(routes)[::-1]):
            secs[k].append(call(k)[0])
    per = {k: float(np.median(v)) / TRANSITIONS * 1e3 for k, v in secs.items()}
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(json.dumps({
        "card": smi.strip(), "chains": CHAINS, "n": N, "leapfrog": LEAPFROG,
        "ms_per_transition": per,
        "ms_per_gradient": {k: v / (LEAPFROG + 1) for k, v in per.items()},
        "turn_seconds": secs, "samples_equal": same,
    }), flush=True)


if __name__ == "__main__":
    main()
