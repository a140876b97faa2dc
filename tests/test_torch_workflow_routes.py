"""The port's one-call pipeline (workflow.py) past its MAP stage against the
JAX package's, f64 on the CPU: the initializers, the sampler routes,
depth-sort, ``transform=``, the diagnostics, the evidence legs and the
pytree wrapper.

JAX's keys and the glue's draws are injected as in
tests/test_torch_workflow.py (`inject_jax_keys`); Pathfinder's, HMC's,
AIS's and the bridge's own draws through their seams (their test files'
injections). Where the sampler is recorded (`recorded_run`), the name,
key, chains and kwargs each package passes are compared exactly, the mass
to rounding, and the stages after the sampler see the same draws in both
packages. One whole HMC route runs the real sampler with JAX's noise.
Floats as tests/test_torch_workflow.py holds them (normwise, 1e-9 and
1e-12; the transform route also to twice JAX's one-ulp witness), the real
HMC draws and the evidence legs to 1e-10 normwise relative.
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from test_torch_ais import jax_init_noise as jax_ais_init_noise
from test_torch_ais import jax_rung_noise as jax_ais_rung_noise
from test_torch_bridge import jax_bridge_noise
from test_torch_pathfinder import inject_jax_noise as inject_pathfinder_noise
from test_torch_sampling_hmc import jax_hmc_noise, normwise
from test_torch_workflow import (
    _recording_get_sampler,
    _to_jax,
    _to_torch,
    as_np,
    compare,
    compare_runs,
    fake_draws,
    inject_jax_keys,
    jax_recorded,
    recorded_run,
    run_package,
)

ais = importlib.import_module("quasinewtonmethods_jl_tpu_torch.ais")
wf = importlib.import_module("quasinewtonmethods_jl_tpu_torch.workflow")
jwf = importlib.import_module("quasinewtonmethods_jl_tpu.workflow")
bridge = importlib.import_module("quasinewtonmethods_jl_tpu_torch.bridge")
sampling = importlib.import_module("quasinewtonmethods_jl_tpu_torch.sampling")
jsampling = importlib.import_module("quasinewtonmethods_jl_tpu.sampling")

torch.set_num_threads(1)

RTOL = 1e-10

# a correlated Gaussian with a quartic term (an exactly Gaussian target ties
# Pathfinder's ELBOs in exact arithmetic, ROADMAP.md C.7)
MU = np.array([0.5, -1.0, 0.25])
_A = np.random.default_rng(5).standard_normal((3, 3)) * 0.4
PREC = np.linalg.inv(_A @ _A.T + np.eye(3))


def jax_logd(x):
    d = x - jnp.asarray(MU)
    return -0.5 * d @ (jnp.asarray(PREC) @ d) - 0.05 * jnp.sum(d ** 4)


def port_logd(x):
    d = x - torch.tensor(MU)
    return -0.5 * d @ (torch.tensor(PREC) @ d) - 0.05 * torch.sum(d ** 4)


def objective(port):
    return port_logd if port else jax_logd


def x0_of(port, x0=MU + 0.3):
    return torch.tensor(x0) if port else jnp.asarray(x0)


BASE = {"n_chains": 8, "n_samples": 10, "n_warmup": 4, "map_tol": 1e-8,
        "map_kwargs": {"backend": "fused"}}
PATHFINDER = {"n_paths": 4, "max_iters": 30}

# name: workflow kwargs (the sampler recorded)
ROUTES = {
    **{f"map_{s}": {"sampler": s} for s in ("chees", "hmc", "nuts", "pt", "ensemble", "mclmc")},
    **{f"pathfinder_{s}": {"sampler": s, "init": "pathfinder", "pathfinder_kwargs": PATHFINDER}
       for s in ("chees", "hmc")},
    **{f"svgd_{s}": {"sampler": s, "init": "svgd", "svgd_kwargs": {"n_steps": 40}}
       for s in ("chees", "hmc", "pt")},
    **{f"lowrank_{s}": {"sampler": s, "map_engine": "lbfgs", "mass_form": "lowrank",
                        "map_kwargs": {}} for s in ("chees", "nuts")},
    "sampler_kwargs_win": {"sampler": "hmc", "mass": None, "n_leapfrog": 3, "n_warmup": 7},
    "pathfinder_map_tol": {"sampler": "nuts", "init": "pathfinder", "map_tol": 1e-4,
                           "pathfinder_kwargs": PATHFINDER},
}


def route_call(name, port):
    kw = {**BASE, **ROUTES[name]}
    return (objective(port), 11, x0_of(port)), kw


@pytest.fixture(scope="module")
def jax_routes():
    runs = {}
    for name in ROUTES:
        args, kw = route_call(name, port=False)
        runs[name] = jax_recorded(*args, **kw)
    return runs


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_sampler_routes_match_jax(monkeypatch, jax_routes, name):
    """The sampler each package calls, the key, chains and kwargs it
    passes (the mass by form and value), and every result field."""
    inject_pathfinder_noise(monkeypatch)
    args, kw = route_call(name, port=True)
    before = qt.map_then_sample.host_syncs
    port = recorded_run(monkeypatch, True, *args, **kw)
    compare_runs(port, jax_routes[name])
    # the glue's reads: the fleet's statuses; Pathfinder's finite-ELBO test
    # and its best path; SVGD's finite-logp test
    init = kw.get("init", "map")
    assert qt.map_then_sample.host_syncs - before == {"map": 1, "pathfinder": 2, "svgd": 1}[init]


def test_mclmc_with_a_lowrank_mass_fails_in_both_packages():
    """ROADMAP.md C.8: the workflow takes no route around it."""
    kw = {**BASE, "sampler": "mclmc", "map_engine": "lbfgs", "mass_form": "lowrank",
          "map_kwargs": {}}
    with pytest.raises(ValueError, match="LowRankMass"):
        run_package(True, port_logd, 0, x0_of(True), **kw)
    with pytest.raises((ValueError, TypeError)):
        run_package(False, jax_logd, 0, x0_of(False), **kw)


def test_ensemble_refuses_the_lowrank_mass_in_both_packages():
    kw = {**BASE, "sampler": "ensemble", "map_engine": "lbfgs", "mass_form": "lowrank",
          "map_kwargs": {}}
    errors = []
    for port in (False, True):
        with pytest.raises(ValueError, match="mass") as info:
            run_package(port, objective(port), 0, x0_of(port), **kw)
        errors.append(str(info.value))
    assert errors[1] == errors[0]


# ---------------------------------------------------------------------------
# One whole HMC route, the real sampler with JAX's noise
# ---------------------------------------------------------------------------


def test_one_full_hmc_route_matches_jax(monkeypatch):
    """MAP fleet -> dense B -> hmc_sample -> device diagnostics: the draws
    to 1e-10 normwise relative, and everything else compare() holds."""
    # a short warmup: per-chain dual averaging grows one-ulp differences
    # ~10x a step (at 10 steps JAX's own one-ulp witness moves 1e-9)
    kw = {**BASE, "sampler": "hmc", "n_samples": 10, "n_warmup": 4, "n_leapfrog": 5}
    ref = qj.map_then_sample(jax_logd, jax.random.PRNGKey(7), x0_of(False), **kw)
    inject_jax_keys(monkeypatch)
    monkeypatch.setattr(sampling, "_step_noise", jax_hmc_noise)
    out = qt.map_then_sample(port_logd, 7, x0_of(True), **kw)
    assert normwise(as_np(out.samples), np.asarray(ref.samples)) <= RTOL
    compare(out.sampler_result.divergences, ref.sampler_result.divergences, "divergences")
    for field in ("diagnostics", "map_result", "x_map", "mass"):
        compare(getattr(out, field), getattr(ref, field), field)
    assert isinstance(out.diagnostics.rhat, torch.Tensor)  # on the device, nothing fetched


# ---------------------------------------------------------------------------
# depth_sort: NUTS warmup, then the depth-sorted driver
# ---------------------------------------------------------------------------


def _record_depth_sort(monkeypatch, module, calls, to_array):
    def warm(obj, key, x0s, **kw):
        calls.append(("nuts_sample", as_np(key).astype(np.int64), as_np(x0s), kw))
        return types.SimpleNamespace(state="the warm state")

    def sorted_run(obj, state, n_samples, **kw):
        calls.append(("nuts_sample_depth_sorted", state, n_samples, kw))
        draws = to_array(fake_draws((n_samples, 8, 3)))
        return types.SimpleNamespace(samples=draws), "the decision record"

    monkeypatch.setattr(module, "nuts_sample", warm)
    monkeypatch.setattr(module, "nuts_sample_depth_sorted", sorted_run)


def test_depth_sort_route_matches_jax(monkeypatch):
    kw = {**BASE, "sampler": "nuts", "depth_sort": True, "groups": 2, "probe_draws": 3,
          "min_persistence": 2.0, "min_depth_spread": 0.1, "step_size": 0.3, "max_depth": 5}
    runs = []
    for port, module, to_array in ((False, jsampling, jnp.asarray),
                                   (True, sampling, torch.tensor)):
        calls = []
        if port:
            inject_jax_keys(monkeypatch)
        _record_depth_sort(monkeypatch, module, calls, to_array)
        runs.append((run_package(port, objective(port), 3, x0_of(port), **kw), calls))
    (out, calls), (ref, ref_calls) = runs[1], runs[0]
    assert [c[0] for c in calls] == [c[0] for c in ref_calls]
    (_, key, x0s, warm_kw), (_, jkey, jx0s, jwarm_kw) = calls[0], ref_calls[0]
    np.testing.assert_array_equal(key, jkey)
    compare(x0s, jx0s, "chains")
    assert sorted(warm_kw) == sorted(jwarm_kw)
    assert warm_kw["n_samples"] == 0 and warm_kw["total_warmup"] == kw["n_warmup"]
    for k in warm_kw:
        compare(warm_kw[k], jwarm_kw[k], k)
    assert calls[1][1:3] == ref_calls[1][1:3] == ("the warm state", kw["n_samples"])
    assert sorted(calls[1][3]) == sorted(ref_calls[1][3])
    assert out.depth_sort_info == ref.depth_sort_info == "the decision record"
    compare(out.diagnostics, ref.diagnostics, "diagnostics")


# ---------------------------------------------------------------------------
# transform=, the diagnostics below 8 draws, the evidence legs, pytrees
# ---------------------------------------------------------------------------

_GA, _GB = np.array([3.0, 5.0, 2.0]), np.array([2.0, 1.0, 4.0])


def gamma_product(port):
    """The Gamma product of tests/test_transforms.py:420-425 and its
    analytic value-and-grad."""
    lib, a, b = ((torch, torch.tensor(_GA), torch.tensor(_GB)) if port else
                 (jnp, jnp.asarray(_GA), jnp.asarray(_GB)))

    def logd(x):
        return lib.sum((a - 1.0) * lib.log(x) - b * x)

    return logd, lambda x: (logd(x), (a - 1.0) / x - b)


@pytest.mark.parametrize("analytic", [False, True])
def test_transform_route_matches_jax(monkeypatch, analytic):
    """The pipeline in unconstrained z, the draws and the diagnostics on the
    constrained scale; an analytic x-space gradient is pulled back."""
    runs = []
    for port, x0 in ((False, np.ones(3)), (False, np.nextafter(np.ones(3), 2.0)),
                     (True, np.ones(3))):
        logd, vag = gamma_product(port)
        t = (qt if port else qj).transforms.Positive(3)
        # map_tol 1e-4 keeps the lanes' last iterations above the rounding
        # floor and their final values apart (at 1e-8 several lanes end on
        # one mode within an ulp, and the stall counter and the best lane
        # are rounding's choice)
        kw = {**BASE, "sampler": "hmc", "transform": t, "map_tol": 1e-4}
        if analytic:
            kw["value_and_grad_fn"] = vag
        runs.append(recorded_run(monkeypatch, port, logd, 12, x0_of(port, x0), **kw))
    # exp and log enter every step: JAX's one-ulp witness moves the fleet's
    # secant B by ~1e-9 normwise
    compare_runs(runs[2], runs[0], witness=runs[1])
    out = runs[2][0]
    np.testing.assert_allclose(as_np(out.samples_constrained), np.exp(as_np(out.samples)),
                               rtol=1e-12)
    np.testing.assert_allclose(as_np(out.diagnostics.mean),
                               as_np(out.samples_constrained).reshape(-1, 3).mean(0), rtol=1e-12)


@pytest.mark.parametrize("chains,draws", [(8, 5), (1, 1)])
def test_few_draw_diagnostics_match_jax(monkeypatch, chains, draws):
    """Below 8 draws: numpy moments (sd ddof 1, NaN for one pooled draw)
    and NaN R-hat / ESS, one counted read of the draws."""
    kw = {**BASE, "n_chains": chains, "n_samples": draws}
    ref = recorded_run(monkeypatch, False, jax_logd, 4, x0_of(False), **kw)
    before = qt.map_then_sample.host_syncs
    port = recorded_run(monkeypatch, True, port_logd, 4, x0_of(True), **kw)
    assert qt.map_then_sample.host_syncs - before == 2  # the statuses, the draws
    compare_runs(port, ref)
    diag = port[0].diagnostics
    assert isinstance(diag.rhat, np.ndarray) and np.isnan(diag.rhat).all()
    assert np.isnan(diag.std).all() == (chains * draws == 1)


def test_diagnostics_opt_out():
    out = qt.map_then_sample(port_logd, 6, x0_of(True), **{**BASE, "compute_diagnostics": False})
    assert out.diagnostics is None and isinstance(out.samples, torch.Tensor)


EVIDENCE = {
    "laplace": {},
    "ais": {"ais_kwargs": {"n_particles": 64, "n_steps": 8, "n_leapfrog": 3}},
    "bridge": {"ais_kwargs": {"max_iter": 50}},
}


@pytest.mark.parametrize("leg", sorted(EVIDENCE))
def test_evidence_legs_match_jax(monkeypatch, leg):
    """Laplace at the best converged mode; AIS from the (x_map, mass) base
    and the bridge over the run's draws under JAX's fold_in(key, 3), their
    draws injected: logZ to 1e-10, every other field by compare()."""
    kw = {**BASE, "sampler": "hmc", "compute_evidence": leg, **EVIDENCE[leg]}
    ref_out, _ = recorded_run(monkeypatch, False, jax_logd, 9, x0_of(False), **kw)
    monkeypatch.setattr(ais, "_ais_init_noise", jax_ais_init_noise)
    monkeypatch.setattr(ais, "_ais_rung_noise", jax_ais_rung_noise)
    monkeypatch.setattr(bridge, "_bridge_noise", jax_bridge_noise)
    out, _ = recorded_run(monkeypatch, True, port_logd, 9, x0_of(True), **kw)
    assert normwise(as_np(out.log_evidence), np.asarray(ref_out.log_evidence)) <= RTOL
    if leg == "laplace":
        assert out.evidence_extra is None and ref_out.evidence_extra is None
    else:
        assert type(out.evidence_extra).__name__ == type(ref_out.evidence_extra).__name__
        for field in ref_out.evidence_extra._fields:
            a, b = as_np(getattr(out.evidence_extra, field)), np.asarray(
                getattr(ref_out.evidence_extra, field))
            if b.dtype.kind in "iu":
                np.testing.assert_array_equal(a, b, err_msg=field)
            else:
                fin = np.isfinite(b)
                np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=field)
                assert normwise(a[fin], b[fin]) <= RTOL, field


def test_pytree_route_matches_jax(monkeypatch):
    """map_then_sample_pytree over a dict of two blocks: the tree's leaves
    (draws, chains, *leaf.shape), x_map the unravel of flat.x_map, the
    names, and the flat result as JAX's."""
    runs = []
    for port in (False, True):
        lib, mu = (torch, torch.tensor([1.0, -2.0])) if port else (jnp, jnp.asarray([1.0, -2.0]))

        def logd(p, lib=lib, mu=mu):
            return (-0.5 * lib.sum((p["beta"] - mu) ** 2)
                    - 0.5 * lib.sum((p["scales"]["sigma"] - 0.5) ** 2))

        tree0 = {"beta": x0_of(port, np.zeros(2)),
                 "scales": {"sigma": x0_of(port, np.full((2, 2), 0.1))}}
        calls = []
        if port:
            inject_jax_keys(monkeypatch)
            monkeypatch.setattr(wf, "get_sampler", _recording_get_sampler(calls, _to_torch))
            runs.append(qt.map_then_sample_pytree(logd, 3, tree0, **BASE))
        else:
            monkeypatch.setattr(jwf, "get_sampler", _recording_get_sampler(calls, _to_jax))
            runs.append(qj.map_then_sample_pytree(logd, jax.random.PRNGKey(3), tree0, **BASE))
    ref, out = runs
    assert out.names == ref.names == ("beta[0]", "beta[1]", "scales.sigma[0,0]",
                                      "scales.sigma[0,1]", "scales.sigma[1,0]",
                                      "scales.sigma[1,1]")
    assert tuple(out.samples["beta"].shape) == (10, 8, 2)
    assert tuple(out.samples["scales"]["sigma"].shape) == (10, 8, 2, 2)
    for key in ("beta", "scales"):
        compare(out.samples[key] if key == "beta" else out.samples[key]["sigma"],
                ref.samples[key] if key == "beta" else ref.samples[key]["sigma"], key)
        compare(out.x_map[key] if key == "beta" else out.x_map[key]["sigma"],
                ref.x_map[key] if key == "beta" else ref.x_map[key]["sigma"], key)
    flat = as_np(out.flat.x_map)
    np.testing.assert_array_equal(as_np(out.x_map["beta"]), flat[:2])
    np.testing.assert_array_equal(as_np(out.x_map["scales"]["sigma"]), flat[2:].reshape(2, 2))
    for field in ("samples", "x_map", "mass", "map_result", "diagnostics"):
        compare(getattr(out.flat, field), getattr(ref.flat, field), field)
