"""Parallel execution: fleet entry points on one device (batch.py) and the
device mesh over ``torch.distributed`` (mesh.py: data-parallel fleets and
parameter-sharded single solves; distributed.py: joining the ranks)."""

from .batch import optimize_batched, optimize_lbfgs_batched
from .mesh import (
    least_squares_sharded,
    make_mesh,
    optimize_auglag_sharded,
    optimize_batched_sharded,
    optimize_cg_model_sharded,
    optimize_cg_sharded,
    optimize_lbfgs_sharded,
    optimize_tr_model_sharded,
    optimize_tr_sharded,
    psum_dot,
    sample_sharded,
)

__all__ = [
    "optimize_batched",
    "optimize_lbfgs_batched",
    "least_squares_sharded",
    "optimize_auglag_sharded",
    "optimize_cg_model_sharded",
    "optimize_cg_sharded",
    "optimize_tr_sharded",
    "optimize_tr_model_sharded",
    "make_mesh",
    "optimize_batched_sharded",
    "optimize_lbfgs_sharded",
    "psum_dot",
    "sample_sharded",
]
