"""The n each shared-memory kernel of the port takes, on the CPU.

B1 (`fused_update_fits`) and B3 (`resident_feasible`) hold one lane's B in
one block's shared memory; the Python side decides from n and the dtype
which n go to them. Their range is part of the port's behaviour (beyond
it B1's callers take B2, and B3 raises), so it is pinned: every n up to the
largest admitted, and not the next one.
"""

import pytest

from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import fused_update_fits
from quasinewtonmethods_jl_tpu_torch.resident_solve import resident_feasible


@pytest.mark.parametrize(
    "admits, itemsize, largest",
    [
        (fused_update_fits, 4, 237),
        (fused_update_fits, 8, 167),
        (resident_feasible, 4, 236),
        (resident_feasible, 8, 165),
    ],
    ids=["B1-f32", "B1-f64", "B3-f32", "B3-f64"],
)
def test_shared_memory_kernels_admit_every_n_up_to_their_largest(admits, itemsize, largest):
    assert all(admits(n, itemsize) for n in range(1, largest + 1))
    assert not admits(largest + 1, itemsize)
