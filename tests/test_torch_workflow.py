"""The port's one-call pipeline (workflow.py): its MAP stage and its
refusals against the JAX package's, f64 on the CPU.

JAX splits the run's key into ``k_init, k_jit, k_sample`` and folds 3 into
it for the evidence; the port derives four keys of its own
(`workflow._workflow_key`) and draws the glue's noise through three seams.
Every parity run injects JAX's keys and draws there (`inject_jax_keys`):
the starts normal(k_init), the reseeded failed lanes normal(fold_in(k_jit,
1)), and `chain_init_from_map`'s and the tr / cg handoff's jitter
normal(k_jit) (`sampling._jitter_noise`). The sampler is replaced in both
packages by a recorder (`recorded_run`) that keeps its name, key, chains
and kwargs and returns draws made from the chains with one fixed numpy
array, so that the stages after it see the same input in both packages.

JAX's `optimize_batched(backend="auto")` runs vmap off the TPU and the
port's runs its fused engine (ROADMAP.md C): the MAP stage is compared
with ``map_kwargs={"backend": "fused"}`` on both sides, and
`test_auto_backend_resolves_as_documented` pins what each engine does.

Statuses, counters, keys, sampler names and kwargs are held exactly;
floats normwise: max|port - JAX| <= RTOL * max|JAX| + ATOL over each array
(a secant B's small entries carry the rounding of its large ones; the
gradients of converged lanes are O(tol), their rounding O(eps) of the
iterate's scale). Where XLA's transcendental functions enter (a
transform's exp and log, which differ from torch's by an ulp on some
inputs), a run is also held to twice JAX's own spread between runs from
starts one ulp apart (its rounding witness).
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
from test_torch_sampling_hmc import jax_key

jwf = importlib.import_module("quasinewtonmethods_jl_tpu.workflow")
wf = importlib.import_module("quasinewtonmethods_jl_tpu_torch.workflow")
sampling = importlib.import_module("quasinewtonmethods_jl_tpu_torch.sampling")

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-12
WITNESS_FACTOR = 2
_JAX_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
DRAW_SEED = 20260816


# ---------------------------------------------------------------------------
# JAX's keys and draws, and the recorded sampler
# ---------------------------------------------------------------------------


def jax_workflow_key(key, i):
    """JAX's sub-key i (split(key, 3)[i], or fold_in(key, 3) for i = 3) as
    the port's (2,) key tensor."""
    k = jax_key(key)
    sub = jax.random.split(k, 3)[i] if i < 3 else jax.random.fold_in(k, 3)
    return torch.tensor(np.asarray(sub).astype(np.int64))


def _jax_normal(raw, shape, dtype):
    return torch.tensor(np.asarray(jax.random.normal(raw, tuple(shape), _JAX_DTYPE[dtype])))


def inject_jax_keys(monkeypatch):
    monkeypatch.setattr(wf, "_workflow_key", jax_workflow_key)
    monkeypatch.setattr(wf, "_start_noise", lambda key, shape, dtype, device: _jax_normal(
        jax_key(key), shape, dtype))
    monkeypatch.setattr(wf, "_fallback_noise", lambda key, shape, dtype, device: _jax_normal(
        jax.random.fold_in(jax_key(key), 1), shape, dtype))
    monkeypatch.setattr(sampling, "_jitter_noise", lambda key, shape, dtype, device: _jax_normal(
        jax_key(key), shape, dtype))


def fake_draws(shape):
    return 0.1 * np.random.default_rng(DRAW_SEED).standard_normal(shape)


def as_np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _recording_get_sampler(calls, to_array):
    """A `get_sampler` whose samplers record their call and return draws
    x0s + fake_draws (the samplers' result layout)."""

    def get_sampler(name):
        def sample(obj, key, x0s, **kw):
            calls.append({"sampler": name, "key": as_np(key).astype(np.int64),
                          "x0s": as_np(x0s), "kw": kw})
            draws = fake_draws((kw["n_samples"], *x0s.shape))
            return types.SimpleNamespace(samples=x0s[None] + to_array(draws, x0s))

        return sample

    return get_sampler


def _to_torch(a, like):
    return torch.tensor(a, dtype=like.dtype)


def _to_jax(a, like):
    return jnp.asarray(a, like.dtype)


def run_package(port, obj, key, *args, **kwargs):
    """One package's `map_then_sample`, an int ``key`` given to JAX as
    ``PRNGKey(key)`` (the port's int seed is that key's two words)."""
    if port:
        return qt.map_then_sample(obj, key, *args, **kwargs)
    return qj.map_then_sample(obj, jax.random.PRNGKey(key), *args, **kwargs)


def recorded_run(monkeypatch, port, *args, **kwargs):
    """(result, calls) of one package's `map_then_sample` with the sampler
    recorded; ``port`` selects the package (the port's run with JAX's keys
    and draws injected)."""
    calls = []
    if port:
        inject_jax_keys(monkeypatch)
        monkeypatch.setattr(wf, "get_sampler", _recording_get_sampler(calls, _to_torch))
    else:
        monkeypatch.setattr(jwf, "get_sampler", _recording_get_sampler(calls, _to_jax))
    return run_package(port, *args, **kwargs), calls


def jax_recorded(*args, **kwargs):
    """JAX's recorded run, for module-scoped fixtures."""
    with pytest.MonkeyPatch.context() as mp:
        return recorded_run(mp, False, *args, **kwargs)


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------


def lowrank_dense(m):
    """The metric a `LowRankMass` stands for (Q's basis is not unique)."""
    g, Q, sig = (as_np(m.gamma), as_np(m.Q), as_np(m.sig))
    n = Q.shape[0]
    M = g * (np.eye(n) - Q @ Q.T) + Q @ np.diag(sig) @ Q.T
    return M if getattr(m, "d", None) is None else M * np.sqrt(np.outer(as_np(m.d), as_np(m.d)))


def compare(a, b, name, witness=None):
    """``a`` (the port's) against ``b`` (JAX's): NamedTuples field by field
    (a `LowRankMass`, and a `PathfinderResult`'s (gamma, Q, sig) path by
    path, by the dense metric), None with None, integer and bool arrays
    exactly, floats normwise (module docstring) with non-finite entries
    equal. Given JAX's ``witness`` run from starts one ulp away, a float
    array may also differ by WITNESS_FACTOR times JAX's own spread."""
    if b is None:
        assert a is None, name
        return
    if type(b).__name__ == "LowRankMass":
        assert type(a).__name__ == "LowRankMass", name
        compare(lowrank_dense(a), lowrank_dense(b), name,
                None if witness is None else lowrank_dense(witness))
        return
    if isinstance(b, tuple) and hasattr(b, "_fields"):
        assert type(a).__name__ == type(b).__name__, name
        spectral = ("gamma", "Q", "sig") if type(b).__name__ == "PathfinderResult" else ()
        for field in b._fields:
            if field not in spectral:
                compare(getattr(a, field), getattr(b, field), f"{name}.{field}",
                        None if witness is None else getattr(witness, field))
        for i in range(len(b.gamma) if spectral else 0):  # each path's metric
            compare(*(lowrank_dense(types.SimpleNamespace(gamma=r.gamma[i], Q=r.Q[i],
                                                          sig=r.sig[i])) for r in (a, b)),
                    f"{name}[{i}] metric")
        return
    if callable(b):
        assert callable(a), name
        return
    x, y = as_np(a), as_np(b)
    assert x.shape == y.shape, (name, x.shape, y.shape)
    if y.dtype.kind in "biu":
        np.testing.assert_array_equal(x, y, err_msg=name)
        return
    fin = np.isfinite(y)
    np.testing.assert_array_equal(np.isfinite(x), fin, err_msg=name)
    np.testing.assert_array_equal(x[~fin], y[~fin], err_msg=name)
    if fin.any():
        err = np.max(np.abs(x[fin] - y[fin]))
        tol = RTOL * np.max(np.abs(y[fin])) + ATOL
        if witness is not None:
            tol = max(tol, WITNESS_FACTOR * np.max(np.abs(as_np(witness)[fin] - y[fin])))
        assert err <= tol, (name, err, tol)


RESULT_FIELDS = ("samples", "diagnostics", "map_result", "x_map", "mass", "polish_result",
                 "samples_constrained", "x_map_constrained", "log_evidence", "evidence_extra")


def compare_runs(port, ref, witness=None):
    """Two recorded runs: every sampler call (name, key, chains, kwargs)
    and every field of the results but the recorder's own result (against
    JAX's one-ulp ``witness`` run, see `compare`)."""
    (out, calls), (ref_out, ref_calls) = port, ref
    wit_out, wit_calls = witness if witness is not None else (None, [None] * len(ref_calls))
    assert len(calls) == len(ref_calls)
    for c, r, w in zip(calls, ref_calls, wit_calls):
        assert c["sampler"] == r["sampler"]
        np.testing.assert_array_equal(c["key"], r["key"].astype(np.int64))
        compare(c["x0s"], r["x0s"], "chains", None if w is None else w["x0s"])
        assert sorted(c["kw"]) == sorted(r["kw"])
        for k, v in r["kw"].items():
            compare(c["kw"][k], v, f"kwargs {k}", None if w is None else w["kw"][k])
    for field in RESULT_FIELDS:
        compare(getattr(out, field), getattr(ref_out, field), field,
                None if wit_out is None else getattr(wit_out, field))


# ---------------------------------------------------------------------------
# The MAP stage: every engine, starts from a center or explicit, failed
# lanes reseeded from the best mode
# ---------------------------------------------------------------------------

MU = np.array([1.0, -2.0, 0.5])
_A = np.random.default_rng(11).standard_normal((3, 3)) * 0.4
COV = _A @ _A.T + np.eye(3)
PREC = np.linalg.inv(COV)
CHOL_PREC = np.linalg.cholesky(PREC)  # PREC = L Lᵀ: r = Lᵀ(x - mu) gives ½|r|² = ½ (x-mu)ᵀP(x-mu)
POCKET = 50.0  # lanes started beyond this radius sit in a NaN pocket and fail


def jax_logd(x):
    d = x - jnp.asarray(MU)
    v = -0.5 * d @ (jnp.asarray(PREC) @ d)
    return jnp.where(jnp.sum(x * x) > POCKET ** 2, jnp.nan, v)


def port_logd(x):
    d = x - torch.tensor(MU)
    v = -0.5 * d @ (torch.tensor(PREC) @ d)
    return torch.where(torch.sum(x * x) > POCKET ** 2, torch.full_like(v, torch.nan), v)


def jax_resid(x):
    r = jnp.asarray(CHOL_PREC).T @ (x - jnp.asarray(MU))
    return jnp.where(jnp.sum(x * x) > POCKET ** 2, jnp.nan, r)


def port_resid(x):
    r = torch.tensor(CHOL_PREC).T @ (x - torch.tensor(MU))
    return torch.where(torch.sum(x * x) > POCKET ** 2, torch.full_like(r, torch.nan), r)


# 6 lanes near the mode, 2 in the NaN pocket
STARTS = np.concatenate([np.random.default_rng(3).standard_normal((6, 3)) + MU,
                         np.full((2, 3), 100.0)])

# name: (x0 kind, workflow kwargs)
MAP_CASES = {
    "bfgs_center": ("center", {"map_kwargs": {"backend": "fused"}}),
    "bfgs_failed_lanes": ("starts", {"map_kwargs": {"backend": "fused"}}),
    "bfgs_polish": ("starts", {"map_kwargs": {"backend": "fused"}, "polish_steps": 2}),
    "lbfgs": ("starts", {"map_engine": "lbfgs"}),
    "lbfgs_lowrank": ("center", {"map_engine": "lbfgs", "mass_form": "lowrank"}),
    "lm": ("starts", {"map_engine": "lm"}),
    "tr": ("starts", {"map_engine": "tr"}),
    "cg": ("starts", {"map_engine": "cg"}),
}


def map_case_args(name, port):
    kind, kw = MAP_CASES[name]
    kw = dict(kw, n_chains=8, sampler="hmc", n_samples=10, n_warmup=4, map_tol=1e-8)
    if kw.get("map_engine") == "lm":
        kw["map_kwargs"] = {"residual_fn": port_resid if port else jax_resid}
    x0 = MU + 0.5 if kind == "center" else STARTS
    return (port_logd if port else jax_logd, 3, torch.tensor(x0) if port else jnp.asarray(x0)), kw


@pytest.fixture(scope="module")
def jax_map_runs():
    runs = {}
    for name in MAP_CASES:
        args, kw = map_case_args(name, port=False)
        runs[name] = jax_recorded(*args, **kw)
    return runs


@pytest.mark.parametrize("name", sorted(MAP_CASES))
def test_map_stage_matches_jax(monkeypatch, jax_map_runs, name):
    """Chains, mass, x_map, the reseeded failed lanes and the fleet's
    statuses and counters, engine by engine, with JAX's draws injected."""
    ref = jax_map_runs[name]
    args, kw = map_case_args(name, port=True)
    before = qt.map_then_sample.host_syncs
    port = recorded_run(monkeypatch, True, *args, **kw)
    compare_runs(port, ref)
    assert qt.map_then_sample.host_syncs - before == 1  # the fleet's statuses
    statuses = as_np(port[0].map_result.status)
    if MAP_CASES[name][0] == "starts":
        # the pocket's lanes failed and restart at the best mode, jittered
        assert (statuses == int(qt.Status.CONVERGED)).sum() == 6
        chains = port[1][0]["x0s"]
        assert np.abs(chains[6:] - as_np(port[0].x_map)).max() < 0.5
    else:
        assert (statuses == int(qt.Status.CONVERGED)).all()


def test_exact_hessian_handoff_is_the_covariance(jax_map_runs):
    """tr and cg hand over inv(-H) at the best mode: the exact covariance."""
    for name in ("tr", "cg"):
        np.testing.assert_allclose(as_np(jax_map_runs[name][0].mass), COV, atol=1e-9)


@pytest.mark.parametrize("engine", ["tr", "cg"])
def test_exact_hessian_handoff_falls_back_to_the_identity(monkeypatch, engine):
    """At a mode where -H is not positive definite (a saddle in one
    direction's curvature), both packages hand over the identity, the port
    with no host read (inv_ex / cholesky_ex)."""

    def saddle(lib):
        def f(x):
            u = x[0] - 1.0
            return -0.5 * lib.sum((x - 1.0) ** 2) + 0.75 * u ** 2 - 0.25 * u ** 4

        return f

    jax_f, port_f = saddle(jnp), saddle(torch)

    kw = dict(n_chains=4, sampler="hmc", n_samples=4, n_warmup=2, map_engine=engine,
              map_tol=1e-8)
    x0 = np.array([[1.0, 0.3], [1.0, -0.2], [1.0, 1.5], [1.0, 0.9]])  # x[0] at the saddle
    ref = recorded_run(monkeypatch, False, jax_f, 5, jnp.asarray(x0), **kw)
    port = recorded_run(monkeypatch, True, port_f, 5, torch.tensor(x0), **kw)
    compare_runs(port, ref)
    np.testing.assert_array_equal(as_np(port[0].mass), np.eye(2))


# ---------------------------------------------------------------------------
# What the port does where JAX's "auto" picks another engine (ROADMAP.md C)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [1, 2])
def test_auto_backend_resolves_as_documented(cap):
    """On -0.5·Σx² from (0.5, -0.3) in 4 lanes: the port's fused engine
    equals JAX's fused engine and the port's vmap equals JAX's vmap in
    status, gradient and iterations; JAX's "auto" is its vmap off the TPU,
    the port's "auto" its fused engine. At cap 1 the two engines disagree
    (JAX's fused engine peels its first iteration), from cap 2 they agree."""
    x0 = np.tile([0.5, -0.3], (4, 1))
    runs = {}
    for backend in ("fused", "vmap", "auto"):
        runs["jax", backend] = qj.optimize_batched(lambda x: -0.5 * jnp.sum(x * x),
                                                   jnp.asarray(x0), max_iterations=cap,
                                                   backend=backend)
        runs["port", backend] = qt.optimize_batched(lambda x: -0.5 * torch.sum(x * x),
                                                    torch.tensor(x0), max_iterations=cap,
                                                    backend=backend)

    def fields(res):
        return as_np(res.status), as_np(res.grad), as_np(res.iterations)

    # each engine equals its counterpart; each "auto" equals its package's choice
    for a_run, b_run in ((("port", "fused"), ("jax", "fused")), (("port", "vmap"), ("jax", "vmap")),
                         (("port", "auto"), ("port", "fused")), (("jax", "auto"), ("jax", "vmap"))):
        for a, b in zip(fields(runs[a_run]), fields(runs[b_run])):
            np.testing.assert_array_equal(a, b, err_msg=f"{a_run} against {b_run}")
    fused, vmap = as_np(runs["port", "fused"].status), as_np(runs["port", "vmap"].status)
    assert (vmap == int(qt.Status.CONVERGED)).all()
    expected = qt.Status.MAX_ITERATIONS if cap == 1 else qt.Status.CONVERGED
    assert (fused == int(expected)).all()


# ---------------------------------------------------------------------------
# Refusals: the same exception and message as JAX's
# ---------------------------------------------------------------------------


def _jax_sq(x):
    return -0.5 * jnp.sum(x * x)


def _port_sq(x):
    return -0.5 * torch.sum(x * x)


def _jax_nan(x):
    return jnp.nan * jnp.sum(x)


def _port_nan(x):
    return torch.nan * torch.sum(x)


SMALL = {"n_chains": 8, "n_samples": 8, "n_warmup": 4}

# name: (objective, x0, kwargs, whether the sampler is recorded)
REFUSALS = {
    "init": ("sq", np.zeros(2), {"init": "laplace"}, False),
    "compute_evidence": ("sq", np.ones(2), {"compute_evidence": "bogus"}, False),
    "evidence_needs_map": ("sq", np.ones(2), {"init": "pathfinder",
                                               "compute_evidence": "laplace"}, False),
    "polish_needs_map": ("sq", np.zeros(3), {"init": "svgd", "polish_steps": 1}, False),
    "pathfinder_polish": ("sq", np.zeros(3), {"init": "pathfinder", "polish_steps": 1}, False),
    "sampler": ("sq", np.zeros(2), {"sampler": "slice"}, False),
    "x0_rank": ("sq", np.zeros((2, 2, 2)), {}, False),
    "pathfinder_center": ("sq", np.zeros((4, 5)), {"init": "pathfinder"}, False),
    "svgd_center": ("sq", np.zeros((4, 3)), {**SMALL, "init": "svgd"}, False),
    "map_engine": ("sq", np.zeros(4), {"map_engine": "newton"}, False),
    "no_lane_converged": ("nan", np.zeros(3), {**SMALL, "n_chains": 4}, False),
    "lm_needs_residual_fn": ("sq", np.zeros(3), {**SMALL, "map_engine": "lm"}, False),
    "lm_value_and_grad_fn": ("sq", np.zeros(3), {**SMALL, "map_engine": "lm", "vgf": True,
                                                  "map_kwargs": "resid"}, False),
    "lm_lowrank": ("sq", np.zeros(3), {**SMALL, "map_engine": "lm", "mass_form": "lowrank",
                                       "map_kwargs": "resid"}, False),
    "tr_mass_form": ("sq", np.zeros(3), {**SMALL, "map_engine": "tr", "mass_form": "lowrank"},
                     False),
    "cg_mass_form": ("sq", np.zeros(3), {**SMALL, "map_engine": "cg", "mass_form": "lowrank"},
                     False),
    "depth_sort_needs_nuts": ("sq", np.zeros(3), {**SMALL, "sampler": "chees",
                                                  "depth_sort": True}, True),
    "ais_needs_array_mass": ("sq", np.zeros(3), {**SMALL, "map_engine": "lbfgs",
                                                 "mass_form": "lowrank",
                                                 "compute_evidence": "ais"}, True),
    "bridge_needs_array_mass": ("sq", np.zeros(3), {**SMALL, "map_engine": "lbfgs",
                                                    "mass_form": "lowrank",
                                                    "compute_evidence": "bridge"}, True),
    "pathfinder_stage_failed": ("nan", np.zeros(3), {"init": "pathfinder", "n_chains": 8,
                                                     "pathfinder_kwargs": {"n_paths": 2,
                                                                           "max_iters": 4}},
                                False),
    "svgd_stage_failed": ("nan", np.zeros(3), {**SMALL, "init": "svgd",
                                               "svgd_kwargs": {"n_steps": 2}}, False),
}


def _refusal_call(name, port):
    kind, x0, kw, recorded = REFUSALS[name]
    kw = dict(kw)
    obj = {"sq": (_jax_sq, _port_sq), "nan": (_jax_nan, _port_nan)}[kind][port]
    if kw.pop("vgf", False):
        kw["value_and_grad_fn"] = (lambda x: (0.0, x)) if not port else (lambda x: (x.sum(), x))
    if kw.get("map_kwargs") == "resid":
        kw["map_kwargs"] = {"residual_fn": (lambda x: x) if port else (lambda x: x)}
    return obj, (torch.tensor(x0) if port else jnp.asarray(x0)), kw, recorded


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_jax(monkeypatch, name):
    errors = []
    for port in (False, True):
        obj, x0, kw, recorded = _refusal_call(name, port)
        run = ((lambda *a, **k: recorded_run(monkeypatch, port, *a, **k)) if recorded else
               (lambda *a, **k: run_package(port, *a, **k)))
        with pytest.raises(ValueError) as info:
            run(obj, 0, x0, **kw)
        errors.append(str(info.value))
    assert errors[1] == errors[0]


def test_mesh_waits_for_the_multi_device_module():
    """The device mesh is ported (parallel/mesh.py; 4 ranks in
    tests/test_torch_mesh_sampling.py): on a one-device mesh the pipeline
    runs and gives the unsharded run, and depth_sort=True with a mesh
    raises JAX's message."""
    mesh = qt.parallel.make_mesh({"data": 1})
    kw = dict(n_chains=8, n_samples=10, n_warmup=10)
    x0 = torch.zeros(3, dtype=torch.float64)
    sharded = qt.map_then_sample(_port_sq, 0, x0, mesh=mesh, **kw)
    plain = qt.map_then_sample(_port_sq, 0, x0, **kw)
    torch.testing.assert_close(sharded.samples, plain.samples, rtol=0, atol=0)
    torch.testing.assert_close(sharded.map_result.x, plain.map_result.x, rtol=0, atol=0)
    errors = []
    for package, obj, key, start, m in (
            (qt, _port_sq, 0, x0, mesh),
            (qj, _jax_sq, jax.random.PRNGKey(0), jnp.zeros(3), qj.parallel.make_mesh({"data": 1}))):
        with pytest.raises(ValueError) as info:
            package.map_then_sample(obj, key, start, n_chains=8, sampler="nuts", n_samples=4,
                                    n_warmup=4, depth_sort=True, mesh=m)
        errors.append(str(info.value))
    assert "depth_sort=True is single-chip" in errors[0] and errors[0] == errors[1]


def test_numpy_x0_goes_to_the_card_and_integers_promote(monkeypatch):
    """Numpy x0 follows the entry points' device rule (without a card, their
    error); an integer CPU tensor promotes to float32, as JAX's default
    float with x64 off, and the MAP tolerance follows it (1e-3)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
        qt.map_then_sample(_port_sq, 0, np.zeros(2))
    seen = {}
    real = qt.optimize_batched

    def spy(obj, x0s, **kw):
        seen.update(kw, dtype=x0s.dtype)
        return real(obj, x0s, **kw)

    monkeypatch.setattr(wf, "optimize_batched", spy)
    out, calls = recorded_run(monkeypatch, True, _port_sq, 3, torch.tensor([0, 0]), n_chains=8,
                              n_samples=5, n_warmup=5, map_kwargs={"tol": 1e-8})
    assert seen["dtype"] == torch.float32 and seen["tol"] == 1e-8  # map_kwargs win
    assert out.samples.dtype == torch.float32 and tuple(out.samples.shape) == (5, 8, 2)
    qt.map_then_sample(_port_sq, 3, torch.tensor([0, 0]), n_chains=8, n_samples=5, n_warmup=5,
                       sampler="hmc")
    assert seen["tol"] == 1e-3
