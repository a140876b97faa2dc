"""The port's scipy-convention front door (minimize.py) against the JAX
package's, on the same numpy inputs in f64, mirroring tests/test_minimize.py:
every method, with and without constraints, and its refusals; then the
device rule of this slice's entry points (least_squares, optimize_tr,
optimize_auglag, minimize and the resumes), with torch.cuda.is_available
monkeypatched, and the port's freedom from jax.

Counters must be equal lane by lane, floats within rtol 1e-8; minimize is a
relabelling, so against the port's own engine on the negated objective
every leaf is bit for bit equal, signs flipped.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qnm
import quasinewtonmethods_jl_tpu_torch as qt
from test_torch_fold_resume import _spy_cuda

torch.set_num_threads(1)

COUNTERS = {
    "bfgs": ("status", "iterations", "n_fev", "n_gev", "n_resets"),
    "lbfgs": ("status", "iterations", "n_fev", "n_gev", "n_resets"),
    "cg": ("status", "iterations", "n_fev", "n_gev", "n_resets"),
    "tr": ("status", "iterations", "n_fev", "n_hev"),
    "auglag": ("status", "n_outer", "iterations", "n_fev", "inner_status"),
}
FLOATS = ("x", "fun", "grad", "last_value")
TARGET = np.array([2.0, 1.0, 0.5])


def assert_same(port, ref, counters, rtol=1e-8, atol=1e-10):
    for name in counters:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in FLOATS:
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def quad_min(x):
    """A diagonal convex quadratic, the minimized form, either package."""
    xp = torch if isinstance(x, torch.Tensor) else jnp
    diag = xp.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype)
    return 0.5 * xp.sum(diag * x * x)


def rosenbrock_min(x):
    x0, x1 = x[::2], x[1::2]
    return (100.0 * (x1 - x0 ** 2) ** 2 + (1.0 - x0) ** 2).sum()


def bowl_min(z):
    xp = torch if isinstance(z, torch.Tensor) else jnp
    return xp.sum((z - xp.asarray(TARGET) if xp is jnp else z - torch.tensor(TARGET)) ** 2)


def eq_sum(z):
    return z.sum() - 1.0


def ineq_disk(z):
    """The disk and a half-space (tests/test_torch_constrained.py's
    fixture, whose trajectories both packages follow count for count)."""
    xp = torch if isinstance(z, torch.Tensor) else jnp
    return xp.stack([1.5 - (z * z).sum(), z[2] - 0.2])


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("method", ["bfgs", "lbfgs", "cg", "tr"])
def test_every_method_matches_jax(method, rank):
    rng = np.random.default_rng(11)
    x0 = rng.standard_normal(6) if rank == 1 else rng.standard_normal((4, 6))
    port = qt.minimize(quad_min, torch.tensor(x0), method=method, tol=1e-9)
    ref = qnm.minimize(quad_min, jnp.asarray(x0), method=method, tol=1e-9)
    assert_same(port, ref, COUNTERS[method])
    assert port.converged.all() and (port.fun.numpy() >= 0).all()


def test_rosenbrock_scalar_matches_jax():
    x0 = np.random.default_rng(12).standard_normal(8)
    port = qt.minimize(rosenbrock_min, torch.tensor(x0))
    ref = qnm.minimize(rosenbrock_min, jnp.asarray(x0))
    assert_same(port, ref, COUNTERS["bfgs"])
    assert 0.0 <= float(port.fun) < 1e-12


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("method", ["bfgs", "lbfgs", "cg", "tr"])
def test_constrained_route_matches_jax(method, rank):
    """eq and ineq route to optimize_auglag with ``method`` as the inner
    engine; lam/mu pass through unflipped."""
    x0 = np.array([0.3, -0.2, 0.6]) if rank == 1 else (
        np.random.default_rng(13).standard_normal((3, 3)) * 0.5)
    port = qt.minimize(bowl_min, torch.tensor(x0), method=method, eq=eq_sum, ineq=ineq_disk,
                       tol=1e-6, ctol=1e-6)
    ref = qnm.minimize(bowl_min, jnp.asarray(x0), method=method, eq=eq_sum, ineq=ineq_disk,
                       tol=1e-6, ctol=1e-6)
    assert_same(port, ref, COUNTERS["auglag"], atol=1e-8)
    for name in ("lam", "mu"):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-8, atol=1e-8, err_msg=name)
    assert port.converged.all() and (port.fun.numpy() > 0).all()


@pytest.mark.parametrize("method", ["bfgs", "lbfgs", "cg", "tr"])
def test_minimize_is_the_engine_on_the_negated_objective(method):
    """Bit for bit the port's own engine on −fun, signs flipped on fun,
    last_value and grad; the state stays in the maximization convention."""
    X0 = torch.tensor(np.random.default_rng(14).standard_normal((3, 6)))
    mini = qt.minimize(rosenbrock_min, X0, method=method, tol=1e-8)

    def neg(x):
        return -rosenbrock_min(x)

    if method == "bfgs":
        native = qt.optimize_batched(neg, X0, tol=1e-8)
    elif method == "lbfgs":
        native = qt.optimize_lbfgs_batched(neg, X0, tol=1e-8)
    elif method == "cg":
        native = qt.optimize_cg(neg, X0, tol=1e-8)
    else:
        native = qt.optimize_tr(neg, X0, tol=1e-8)
    for name in native._fields[:-1]:
        a, b = getattr(mini, name), getattr(native, name)
        if name in ("fun", "last_value", "grad"):
            b = -b
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), name
    assert all(torch.equal(a, b) for a, b in zip(mini.state, native.state))


def test_constrained_minimize_is_auglag_on_the_negated_objective():
    X0 = torch.tensor(np.random.default_rng(15).standard_normal((3, 3)) * 0.5)
    mini = qt.minimize(bowl_min, X0, eq=eq_sum, ineq=ineq_disk, tol=1e-6, ctol=1e-6,
                       max_outer=3)
    native = qt.optimize_auglag(lambda z: -bowl_min(z), X0, eq=eq_sum, ineq=ineq_disk, tol=1e-6,
                                ctol=1e-6, max_outer=3)
    for name in native._fields:
        a, b = getattr(mini, name), getattr(native, name)
        if name in ("fun", "last_value", "grad"):
            b = -b
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), name


def test_state_resumes_natively_and_cg_method_rides_through():
    x0 = torch.tensor(np.random.default_rng(16).standard_normal(8))
    part = qt.minimize(rosenbrock_min, x0, max_iterations=5)
    assert int(part.status) == qt.Status.MAX_ITERATIONS
    res = qt.optimize_from_state(lambda x: -rosenbrock_min(x), part.state)
    assert bool(res.converged)
    port = qt.minimize(quad_min, x0, method="cg", cg_method="pr", tol=1e-9)
    ref = qnm.minimize(quad_min, jnp.asarray(x0.numpy()), method="cg", cg_method="pr", tol=1e-9)
    assert_same(port, ref, COUNTERS["cg"])


def test_failure_stays_in_band():
    res = qt.minimize(lambda x: torch.nan * torch.sum(x), torch.ones(3, dtype=torch.float64))
    assert int(res.status) == qt.Status.NONFINITE_VALUE and torch.isnan(res.fun)


def test_refusals_match_jax():
    """The knobs that do not apply refuse loudly, in both packages."""
    cases = (
        (dict(method="newton"), "method"),
        (dict(method="tr", ls=qt.BackTracking()), "ls does not apply"),
        (dict(eq=eq_sum, method="nelder-mead"), "constrained minimize"),
        (dict(eq=eq_sum, h0_scale=False), "h0_scale does not apply"),
        (dict(eq=eq_sum, stall_limit=7), "stall_limit does not apply"),
    )
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            qt.minimize(bowl_min, torch.zeros(3, dtype=torch.float64), **kw)
        jax_kw = dict(kw)
        if "ls" in jax_kw:
            jax_kw["ls"] = qnm.BackTracking()
        with pytest.raises(ValueError, match=match):
            qnm.minimize(bowl_min, jnp.zeros(3), **jax_kw)


def _entry(name, x0):
    """One call of each entry point of this slice on ``x0`` (numpy or a
    CPU tensor), two iterations."""
    if name == "least_squares":
        return qt.least_squares(lambda x: x - 1.0, x0, max_iterations=2)
    if name == "optimize_tr":
        return qt.optimize_tr(quad_min, x0, max_iterations=2)
    if name == "optimize_auglag":
        return qt.optimize_auglag(lambda z: -quad_min(z), x0, eq=eq_sum, max_outer=1,
                                  max_iterations=2)
    return qt.minimize(quad_min, x0, max_iterations=2)


ENTRIES = ["least_squares", "optimize_tr", "optimize_auglag", "minimize"]


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_put_numpy_on_the_card(monkeypatch, entry, rank):
    """numpy goes to the card in the JAX package's default dtype (f64 runs
    in f32); without a card it raises; a CPU tensor stays on the CPU."""
    x0 = np.random.default_rng(17).standard_normal(3 if rank == 1 else (2, 3))
    seen = _spy_cuda(monkeypatch)
    res = _entry(entry, x0)
    assert seen[0] == "cuda" and res.x.dtype == torch.float32
    seen.clear()
    res = _entry(entry, torch.tensor(x0))
    assert seen == [] and res.x.device.type == "cpu" and res.x.dtype == torch.float64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
        _entry(entry, x0)


@pytest.mark.parametrize("resume", ["lm", "tr"])
def test_numpy_states_resume_on_the_card(monkeypatch, resume):
    """A state saved as numpy (`lm_state_to_numpy` / `tr_state_to_numpy`)
    resumes on the card, every leaf placed there, f64 leaves in f32;
    without a card it raises."""
    X0 = torch.tensor(np.random.default_rng(18).standard_normal((2, 3)))
    if resume == "lm":
        state = qt.lm_state_to_numpy(qt.least_squares(lambda x: x ** 2 - 1.0, X0,
                                                      max_iterations=2).state)

        def run():
            return qt.least_squares_from_state(lambda x: x ** 2 - 1.0, state, max_iterations=4)
    else:
        state = qt.tr_state_to_numpy(qt.optimize_tr(rosenbrock_min, X0, max_iterations=2).state)

        def run():
            return qt.optimize_tr_from_state(rosenbrock_min, state, max_iterations=4)
    seen = _spy_cuda(monkeypatch)
    res = run()
    assert seen == ["cuda"] * len(state) and res.x.dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="state.x is a ndarray"):
        run()


def test_slice_modules_and_chip_smoke_import_no_jax():
    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys, quasinewtonmethods_jl_tpu_torch.least_squares, "
        "quasinewtonmethods_jl_tpu_torch.trust_region, "
        "quasinewtonmethods_jl_tpu_torch.constrained, "
        "quasinewtonmethods_jl_tpu_torch.minimize, chip_smoke; "
        "assert 'jax' not in sys.modules, 'jax imported'"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
    imports = re.compile(r"^\s*(import|from)\s+(jax|quasinewtonmethods_jl_tpu)\b", re.M)
    for path in [root / "chip_smoke.py", *(root / "quasinewtonmethods_jl_tpu_torch").rglob("*.py")]:
        assert not imports.search(path.read_text()), path
