"""Ranks for the port's mesh tests: a pool of gloo processes on the CPU.

`RankPool` spawns ``world`` processes that join one gloo group through a
FileStore in a directory the test gives (no TCP port, so parallel test
workers never collide), each with one torch thread. A test sends a task by
name with numpy arguments to every rank (`RankPool.run`) and gets every
rank's answer back, as nested dicts of numpy arrays. The tasks below are
what the ranks run: each calls a `parallel.mesh` entry point the way a
user's script on every rank would. This module imports torch, numpy and
the port, never JAX: a rank reports whether JAX is loaded in it.
"""

from __future__ import annotations

import multiprocessing
import queue
import sys
import time
import traceback

import numpy as np
import torch


class RankPool:
    """``world`` gloo ranks that run named tasks of this module."""

    def __init__(self, world: int, workdir, timeout: float = 180.0):
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        store = f"file://{workdir}/gloo_store"
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, world, store, self._tasks[r], self._results),
                                   daemon=True) for r in range(world)]
        for p in self._procs:
            p.start()
        self._broken = None
        # each rank answers whether JAX is loaded in it
        self.jax_loaded = self._collect(timeout)

    def run(self, name: str, *args, timeout: float = 180.0) -> list:
        """Every rank's answer to task ``name`` of this module, by rank."""
        self.start(name, *args)
        return self.wait(timeout)

    def start(self, name: str, *args) -> None:
        """Send task ``name`` to every rank; `wait` collects the answers
        (the test computes its reference meanwhile)."""
        if self._broken:
            raise RuntimeError(f"the rank pool broke earlier: {self._broken}")
        for q in self._tasks:
            q.put((name, args))

    def wait(self, timeout: float = 180.0) -> list:
        return self._collect(timeout)

    def _collect(self, timeout: float) -> list:
        out, errors = [None] * self.world, []
        deadline = time.monotonic() + timeout
        for _ in range(self.world):
            while True:
                try:
                    rank, ok, value = self._results.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                    if dead or time.monotonic() > deadline:
                        self._broken = (f"ranks {dead} died" if dead else
                                        f"no answer within {timeout} s") + f"; errors: {errors}"
                        self.close()
                        raise RuntimeError(self._broken) from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def close(self):
        for q in self._tasks:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)


def _plain(value):
    """A result as nested dicts, lists and numpy arrays."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return {k: _plain(v) for k, v in zip(value._fields, value)}
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


def _rank_main(rank, world, store, tasks, results):
    torch.set_num_threads(1)
    from quasinewtonmethods_jl_tpu_torch.parallel import distributed

    distributed.initialize(store, world, rank, backend="gloo")
    results.put((rank, True, "jax" in sys.modules))
    while True:
        item = tasks.get()
        if item is None:
            break
        name, args = item
        try:
            results.put((rank, True, _plain(globals()[name](*args))))
        except Exception:  # the test reads the traceback
            results.put((rank, False, traceback.format_exc()))
    torch.distributed.destroy_process_group()


# --- objectives (torch) ------------------------------------------------------


def quad_logdensity(x):
    diag = torch.arange(1.0, x.shape[-1] + 1.0, dtype=x.dtype)
    return -0.5 * torch.sum(diag * x * x)


def gauss_logdensity(x):
    return -0.5 * torch.sum(x * x)


def diag_quadratic(d):
    d = torch.as_tensor(d)

    def obj(x):
        return -0.5 * torch.sum(d.to(x.dtype) * x * x)

    return obj


def _objective(name, arg=None):
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity

    if name == "diag":
        return diag_quadratic(arg)
    return {"quad": quad_logdensity, "gauss": gauss_logdensity,
            "rosenbrock": rosenbrock_logdensity}[name]


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a))


def _error(fn):
    """The message of the ValueError ``fn`` raises (None if it returns)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


# --- the mesh and the process group -----------------------------------------


def mesh_layout():
    from quasinewtonmethods_jl_tpu_torch.parallel import distributed, make_mesh

    flat = make_mesh({"data": 4})
    grid = make_mesh({"data": 2, "model": 2})
    x = torch.tensor([float(distributed.process_index() + 1)])
    return {
        "flat_shape": flat.shape, "grid_shape": grid.shape,
        "grid_index": (grid.index("data"), grid.index("model")),
        "flat_index": flat.index("data"),
        # the rank's value summed along each axis of the grid
        "psum_data": grid.psum(x, "data"), "psum_model": grid.psum(x, "model"),
        "too_big": _error(lambda: make_mesh({"data": 1024})),
        "is_distributed": distributed.is_distributed(),
        "host_count": distributed.host_count(),
        "process_index": distributed.process_index(),
    }


# --- data-parallel fleets ---------------------------------------------------


def batched(x0s, kwargs):
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity
    from quasinewtonmethods_jl_tpu_torch.parallel import make_mesh, optimize_batched_sharded

    return optimize_batched_sharded(rosenbrock_logdensity, _t(x0s), make_mesh({"data": 4}),
                                    **kwargs)


def tr_fleet(obj, arg, x0s, kwargs):
    from quasinewtonmethods_jl_tpu_torch.parallel import make_mesh, optimize_tr_sharded

    return optimize_tr_sharded(_objective(obj, arg), _t(x0s), make_mesh({"data": 4}), **kwargs)


def cg_fleet(obj, arg, x0s, kwargs):
    from quasinewtonmethods_jl_tpu_torch.parallel import make_mesh, optimize_cg_sharded

    return optimize_cg_sharded(_objective(obj, arg), _t(x0s), make_mesh({"data": 4}), **kwargs)


def auglag_disk(x0s, r2s):
    from quasinewtonmethods_jl_tpu_torch.parallel import make_mesh, optimize_auglag_sharded

    def f(z):
        return -torch.sum((z - 2.0) ** 2)

    def disk(z, r2):
        return r2 - torch.sum(z * z)

    return optimize_auglag_sharded(f, _t(x0s), make_mesh({"data": 4}), ineq=disk,
                                   constraint_data=_t(r2s))


def exp_residual(p, d):
    t, y = d
    return p[..., 0:1] * torch.exp(p[..., 1:2] * t) - y


def lsq_fleet(x0s, ts, ys, bounds, kwargs):
    from quasinewtonmethods_jl_tpu_torch.parallel import least_squares_sharded, make_mesh

    if bounds is not None:
        kwargs = dict(kwargs, bounds=tuple(_t(b) for b in bounds))
    return least_squares_sharded(exp_residual, _t(x0s), make_mesh({"data": 4}),
                                 data=(_t(ts), _t(ys)), **kwargs)


def fleet_refusals():
    from quasinewtonmethods_jl_tpu_torch import parallel as P

    mesh = P.make_mesh({"data": 4})
    z = torch.zeros
    return {
        "batched": _error(lambda: P.optimize_batched_sharded(quad_logdensity,
                                                             z((6, 4), dtype=torch.float64),
                                                             mesh)),
        "tr": _error(lambda: P.optimize_tr_sharded(quad_logdensity,
                                                   z((6, 4), dtype=torch.float64), mesh)),
        "tr_rank": _error(lambda: P.optimize_tr_sharded(quad_logdensity,
                                                        z(4, dtype=torch.float64), mesh)),
        "cg": _error(lambda: P.optimize_cg_sharded(quad_logdensity,
                                                   z((6, 4), dtype=torch.float64), mesh)),
        "auglag": _error(lambda: P.optimize_auglag_sharded(
            lambda x: -torch.sum(x * x), z((10, 4), dtype=torch.float64), mesh,
            ineq=lambda x: 1.0 - torch.sum(x * x))),
        "lsq": _error(lambda: P.least_squares_sharded(
            lambda p, d: p, z((6, 2), dtype=torch.float64), mesh,
            data=z((6, 3), dtype=torch.float64))),
        "lsq_rank": _error(lambda: P.least_squares_sharded(lambda p, d: p,
                                                           z(4, dtype=torch.float64), mesh)),
    }


# --- one solve, the parameter axis sharded -----------------------------------


def lbfgs_model(obj, x0, kwargs):
    from quasinewtonmethods_jl_tpu_torch.parallel import make_mesh, optimize_lbfgs_sharded

    kwargs = dict(kwargs)
    if kwargs.pop("wolfe", False):
        from quasinewtonmethods_jl_tpu_torch import Wolfe

        kwargs["ls"] = Wolfe()
    return optimize_lbfgs_sharded(_objective(obj), _t(x0), make_mesh({"model": 4}), **kwargs)


def lbfgs_separable(x0, diag_full):
    """The separable form: each rank evaluates its shard, sums the value
    over the axis itself, and never gathers x."""
    from quasinewtonmethods_jl_tpu_torch.parallel import make_mesh, optimize_lbfgs_sharded

    mesh = make_mesh({"model": 4})
    n = len(diag_full)
    loc = n // mesh.shape["model"]
    i = mesh.index("model")
    diag = torch.as_tensor(diag_full[i * loc:(i + 1) * loc])

    def local_vag(x_local):
        val = mesh.psum(-0.5 * torch.sum(diag * x_local * x_local), "model")
        return val, -diag * x_local

    return optimize_lbfgs_sharded(None, _t(x0), mesh, value_and_grad_fn=local_vag)


def cg_model(obj, arg, x0, kwargs):
    from quasinewtonmethods_jl_tpu_torch.parallel import make_mesh, optimize_cg_model_sharded

    return optimize_cg_model_sharded(_objective(obj, arg), _t(x0), make_mesh({"model": 4}),
                                     **kwargs)


def tr_model(obj, arg, x0, kwargs):
    from quasinewtonmethods_jl_tpu_torch.parallel import make_mesh, optimize_tr_model_sharded

    return optimize_tr_model_sharded(_objective(obj, arg), _t(x0), make_mesh({"model": 4}),
                                     **kwargs)


def model_refusals():
    from quasinewtonmethods_jl_tpu_torch import parallel as P

    mesh = P.make_mesh({"model": 4})
    z = torch.zeros
    return {
        "lbfgs": _error(lambda: P.optimize_lbfgs_sharded(quad_logdensity,
                                                         z(10, dtype=torch.float64), mesh)),
        "cg_rank": _error(lambda: P.optimize_cg_model_sharded(
            quad_logdensity, z((4, 8), dtype=torch.float64), mesh)),
        "cg": _error(lambda: P.optimize_cg_model_sharded(quad_logdensity,
                                                         z(10, dtype=torch.float64), mesh)),
        "tr_rank": _error(lambda: P.optimize_tr_model_sharded(
            quad_logdensity, z((4, 8), dtype=torch.float64), mesh)),
        "tr": _error(lambda: P.optimize_tr_model_sharded(quad_logdensity,
                                                         z(10, dtype=torch.float64), mesh)),
    }


# --- chain fleets -----------------------------------------------------------


def sample(sampler, key, x0s, kwargs):
    from quasinewtonmethods_jl_tpu_torch.parallel import make_mesh, sample_sharded

    return sample_sharded(gauss_logdensity, key, _t(x0s), make_mesh({"data": 4}),
                          sampler=sampler, **kwargs)


def sample_refusals():
    from quasinewtonmethods_jl_tpu_torch.parallel import make_mesh, sample_sharded

    mesh = make_mesh({"data": 4})
    x = torch.zeros((16, 2), dtype=torch.float64)
    return {
        "sampler": _error(lambda: sample_sharded(gauss_logdensity, 0, x, mesh,
                                                 sampler="slice")),
        "divide": _error(lambda: sample_sharded(gauss_logdensity, 0, x[:10], mesh)),
    }


def workflow(key, x0, kwargs):
    from quasinewtonmethods_jl_tpu_torch import map_then_sample
    from quasinewtonmethods_jl_tpu_torch.parallel import make_mesh

    res = map_then_sample(gauss_logdensity, key, _t(x0), mesh=make_mesh({"data": 4}), **kwargs)
    return {"samples": res.samples, "map_status": res.map_result.status,
            "map_iterations": res.map_result.iterations, "map_x": res.map_result.x,
            "x_map": res.x_map, "mass": res.mass, "chains": res.sampler_result.state.x,
            "rhat": res.diagnostics.rhat}


def workflow_refusals():
    from quasinewtonmethods_jl_tpu_torch import map_then_sample
    from quasinewtonmethods_jl_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"data": 4})
    x0 = torch.zeros(2, dtype=torch.float64)
    return {
        "depth_sort": _error(lambda: map_then_sample(
            gauss_logdensity, 0, x0, n_chains=8, sampler="nuts", n_samples=4, n_warmup=4,
            depth_sort=True, mesh=mesh)),
        "divide": _error(lambda: map_then_sample(gauss_logdensity, 0, x0, n_chains=6,
                                                 n_samples=4, n_warmup=4, mesh=mesh)),
    }


def per_coordinate_options(x0, d, lo, hi):
    """A fixed CG preconditioner and TR bounds with one entry per
    coordinate, cut like x on each rank."""
    from quasinewtonmethods_jl_tpu_torch.parallel import (
        make_mesh,
        optimize_cg_model_sharded,
        optimize_tr_model_sharded,
    )

    mesh = make_mesh({"model": 4})
    obj = diag_quadratic(d)
    return {"cg": optimize_cg_model_sharded(obj, _t(x0), mesh, precondition=_t(d)),
            "tr": optimize_tr_model_sharded(obj, _t(x0), mesh, bounds=(_t(lo), _t(hi)))}
