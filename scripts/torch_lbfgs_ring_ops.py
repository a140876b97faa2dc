#!/usr/bin/env python3
"""Operations the port's L-BFGS fleet dispatches per loop body with each
history ring: every aten call of a solve counted by a TorchDispatchMode and
divided by the solve's loop bodies. On a host-bound engine each aten call is
a kernel launch the host pays for, so this is the ring's host cost. Runs on
the CPU (the count does not depend on the device):

    python scripts/torch_lbfgs_ring_ops.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import quasinewtonmethods_jl_tpu_torch as qt  # noqa: E402
from quasinewtonmethods_jl_tpu_torch import lbfgs_batched_solve as lbs  # noqa: E402
from quasinewtonmethods_jl_tpu_torch.models import (  # noqa: E402
    rosenbrock_logdensity,
    rosenbrock_value_and_grad,
)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        return func(*args, **(kwargs or {}))


def main():
    X = torch.tensor(np.random.default_rng(20260816).standard_normal((64, 60)),
                     dtype=torch.float32)
    engine = lbs.optimize_lbfgs_batched_fused
    for ring, limit in (("shift", 10**9), ("circular", 1)):
        lbs._RING_CIRCULAR_MIN_N = limit
        engine.loop_bodies = 0
        with _Count() as count:
            qt.optimize_lbfgs_batched(rosenbrock_logdensity, X, history=10, tol=1e-3,
                                      max_iterations=40,
                                      value_and_grad_fn=rosenbrock_value_and_grad)
        print(f"{ring} ring: {count.calls / engine.loop_bodies:.1f} aten ops per loop body "
              f"({engine.loop_bodies} bodies, 64 x 60 f32)")


if __name__ == "__main__":
    main()
