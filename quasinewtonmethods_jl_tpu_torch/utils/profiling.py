"""Tracing and profiling support — the PyTorch port of
``quasinewtonmethods_jl_tpu/utils/profiling.py``.

  * `trace(log_dir)` — a context manager around ``torch.profiler`` that
    writes a chrome trace of everything run inside the block (host ops,
    and every kernel when a card is present);
  * `summarize_trace(log_dir)` — the trace's events summed by name (the
    per-iteration cost map);
  * `solve_stats` / `practically_converged` — a solve result's counters
    and acceptance mask as plain numpy (one host copy of the fields read).

The trace lands where JAX's profiler puts its own,
``log_dir/plugins/profile/<run>/<host>.trace.json.gz`` with ``<run>`` the
start time, so `summarize_trace` reads either package's newest trace.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import glob
import gzip
import json
import os
import shutil
import socket
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

__all__ = ["trace", "summarize_trace", "solve_stats", "practically_converged"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of everything run inside the block:
    host activity, and the card's kernels where CUDA is available. On exit,
    as JAX's ``stop_trace`` does also when the block raises, the chrome
    trace is written gzipped under ``log_dir`` (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    run = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S_%f")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        _write_trace(prof, os.path.join(log_dir, "plugins", "profile", run))


def _write_trace(prof, run_dir: str) -> None:
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"{socket.gethostname()}.trace.json")
    prof.export_chrome_trace(path)
    # the fastest level: a pipeline's trace holds ~10^5 kernel launches'
    # events, and Python's default level (9) is several times slower
    with open(path, "rb") as fin, gzip.open(path + ".gz", "wb", compresslevel=1) as fout:
        shutil.copyfileobj(fin, fout)
    os.remove(path)


def summarize_trace(log_dir: str, top: int = 20,
                    min_count: int = 1) -> List[Tuple[str, float, int]]:
    """Aggregate (name, total_seconds, count) from the newest trace in
    ``log_dir``, sorted by total time. Kernels that run once per loop
    iteration show up with large counts — the per-iteration cost map."""
    paths = sorted(glob.glob(os.path.join(log_dir, "**/*.trace.json.gz"), recursive=True))
    if not paths:
        raise FileNotFoundError(f"no trace found under {log_dir}")
    with gzip.open(paths[-1]) as f:
        tr = json.load(f)
    dur = collections.Counter()
    cnt = collections.Counter()
    for e in tr.get("traceEvents", []):
        if e.get("ph") == "X" and "dur" in e:
            dur[e["name"]] += e["dur"]
            cnt[e["name"]] += 1
    rows = [
        (name, d / 1e6, cnt[name])
        for name, d in dur.most_common()
        if cnt[name] >= min_count
    ]
    return rows[:top]


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def solve_stats(result) -> Dict[str, float]:
    """Flatten a solve result's counters into plain floats (batched results
    are summarized with totals and maxima)."""

    def scalarize(v, red):
        a = _host(v)
        return float(red(a)) if a.ndim else float(a)

    return {
        "iterations_max": scalarize(result.iterations, np.max),
        "n_fev_total": scalarize(result.n_fev, np.sum),
        "n_gev_total": scalarize(result.n_gev, np.sum),
        "n_resets_total": scalarize(result.n_resets, np.sum),
        "converged_fraction": scalarize(_host(result.status) == 1, np.mean),
    }


def practically_converged(result, tol: float, factor: float = 10.0):
    """Per-lane acceptance mask: strictly converged, OR stalled at the
    floating-point noise floor with a near-tolerance gradient.

    The backtracking line search cannot certify objective increases below
    ~eps(dtype)*|f|, so a lane one step short of a tight tolerance exits
    with LINESEARCH_FAILURE while its iterate is perfectly usable (the
    reference returns NaN in the identical situation). Acceptance rule:
    status == CONVERGED, or status == LINESEARCH_FAILURE with
    max|grad| < factor * tol. Works for scalar and batched results; returns
    numpy.
    """
    status = _host(result.status)
    grad = _host(result.grad)
    gradmax = np.abs(grad).max(axis=-1) if grad.ndim > 1 else np.abs(grad).max()
    converged = status == 1  # Status.CONVERGED
    stalled_ok = (status == 3) & (gradmax < factor * tol)
    return converged | stalled_ok
