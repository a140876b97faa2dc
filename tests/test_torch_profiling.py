"""The port's profiling helpers (utils/profiling.py) against the JAX
package's, on the CPU: `summarize_trace` on the same hand-written trace
files, `trace` writing a file that `summarize_trace` reads, and
`solve_stats` / `practically_converged` on the same fleets (JAX's f64
results as CPU tensors; the fleets' parity is tests/test_torch_batched_solve.py's).
"""

import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu.models import rosenbrock_logdensity as jax_rosenbrock

torch.set_num_threads(1)


def write_trace(log_dir, run, events):
    path = os.path.join(log_dir, "plugins", "profile", run, "host.trace.json.gz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


EVENTS = [
    {"ph": "X", "name": "fusion.1", "dur": 30.0},
    {"ph": "X", "name": "fusion.1", "dur": 12.5},
    {"ph": "X", "name": "copy", "dur": 100.0},
    {"ph": "X", "name": "while.body", "dur": 1.0},
    {"ph": "X", "name": "while.body", "dur": 1.0},
    {"ph": "X", "name": "while.body", "dur": 1.0},
    {"ph": "X", "name": "no_duration"},
    {"ph": "B", "name": "begin_only", "dur": 7.0},
    {"ph": "i", "name": "instant", "ts": 3},
]


@pytest.mark.parametrize("top,min_count", [(20, 1), (2, 1), (20, 2), (1, 3)])
def test_summarize_trace_matches_jax(tmp_path, top, min_count):
    """The same rows from the same file, the newest run chosen by name."""
    write_trace(str(tmp_path), "2026_01_01_00_00_00", [{"ph": "X", "name": "old", "dur": 5.0}])
    write_trace(str(tmp_path), "2026_01_02_00_00_00", EVENTS)
    mine = qt.utils.summarize_trace(str(tmp_path), top=top, min_count=min_count)
    theirs = qj.utils.summarize_trace(str(tmp_path), top=top, min_count=min_count)
    assert mine == theirs
    assert ("old", 5e-6, 1) not in mine


def test_summarize_trace_without_a_trace_raises_as_jax(tmp_path):
    errors = []
    for package in (qj, qt):
        with pytest.raises(FileNotFoundError) as info:
            package.utils.summarize_trace(str(tmp_path))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_trace_on_the_cpu_writes_what_summarize_trace_reads(tmp_path):
    x = torch.randn(64, 64, dtype=torch.float64)
    with qt.utils.trace(str(tmp_path)):
        for _ in range(3):
            x = torch.tanh(x @ x) + 1.0
    paths = list(tmp_path.glob("plugins/profile/*/*.trace.json.gz"))
    assert len(paths) == 1 and not list(tmp_path.glob("plugins/profile/*/*.trace.json"))
    rows = qt.utils.summarize_trace(str(tmp_path), top=50)
    counts = {name: count for name, _secs, count in rows}
    assert counts.get("aten::mm", 0) == 3 and counts.get("aten::tanh", 0) == 3
    assert all(secs >= 0 for _name, secs, _count in rows)
    # a second trace is the newest: it is the one read
    with qt.utils.trace(str(tmp_path)):
        torch.exp(x)
    names = {name for name, _secs, _count in qt.utils.summarize_trace(str(tmp_path), top=50)}
    assert "aten::exp" in names and "aten::mm" not in names


def as_port_result(ref):
    """A JAX result's leaves as the port's `OptimizeResult` of CPU tensors
    (on the rounding floor the two packages' statuses are rounding's
    choice, so both functions get the same fleet)."""
    return qt.OptimizeResult(**{f: None if f == "state" else torch.tensor(np.asarray(v))
                                for f, v in zip(ref._fields, ref)})


@pytest.fixture(scope="module")
def fleets():
    """A Rosenbrock fleet at a tolerance below some lanes' rounding floor
    (LINESEARCH_FAILURE lanes for the acceptance rule), and a scalar solve."""
    X0 = np.random.default_rng(4).standard_normal((24, 6)) * 1.5
    jax_fleet = qj.optimize_batched(jax_rosenbrock, jnp.asarray(X0), backend="fused", tol=1e-14,
                                    max_iterations=400)
    jax_one = qj.optimize(jax_rosenbrock, jnp.asarray(X0[0]), tol=1e-8)
    return {"fleet": (as_port_result(jax_fleet), jax_fleet),
            "scalar": (as_port_result(jax_one), jax_one)}


@pytest.mark.parametrize("kind", ["fleet", "scalar"])
def test_solve_stats_matches_jax(fleets, kind):
    port, ref = fleets[kind]
    assert qt.utils.solve_stats(port) == qj.utils.solve_stats(ref)


@pytest.mark.parametrize("kind", ["fleet", "scalar"])
@pytest.mark.parametrize("tol", [1e-14, 1e-9, 1e-6])
def test_practically_converged_matches_jax(fleets, kind, tol):
    port, ref = fleets[kind]
    mine = qt.utils.practically_converged(port, tol)
    theirs = np.asarray(qj.utils.practically_converged(ref, tol))
    np.testing.assert_array_equal(mine, theirs)
    assert isinstance(mine, (np.ndarray, np.bool_))


def test_the_fleet_has_both_kinds_of_lane(fleets):
    status = fleets["fleet"][0].status.numpy()
    assert (status == int(qt.Status.CONVERGED)).any()
    assert (status == int(qt.Status.LINESEARCH_FAILURE)).any()


def test_trace_is_written_when_the_block_raises(tmp_path):
    """As JAX's trace, whose stop_trace runs in a finally."""
    with pytest.raises(ZeroDivisionError):
        with qt.utils.trace(str(tmp_path)):
            torch.exp(torch.ones(3))
            1 / 0
    names = {name for name, _secs, _count in qt.utils.summarize_trace(str(tmp_path), top=50)}
    assert "aten::exp" in names
