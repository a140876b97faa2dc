"""`nuts_sample_depth_sorted` in the port, case by case after
tests/test_depth_sorted.py, with the port's own noise: the bitwise
fallback, the small budget, the sorted path equal to a hand composition,
the probe legs without telemetry, the telemetry chunked equal to long, the
sorted state resuming, the guards and the sorted moments against the
plain run. Then the sorted path against JAX's with the noise seams and
`_subfleet_key` injected (tests/test_torch_sampling_nuts.py): the decision
equal (persistence to 1e-12, the group sizes exact) and the results to
1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quasinewtonmethods_jl_tpu as qj
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch import sampling
from quasinewtonmethods_jl_tpu_torch.models import funnel_logdensity
from quasinewtonmethods_jl_tpu_torch.sampling import _nuts_take_chains, _warm_depth_windows
from test_torch_sampling_funnel import funnel_value_and_grad
from test_torch_sampling_hmc import assert_close_or_witnessed, gaussian, normwise
from test_torch_sampling_nuts import inject_jax_noise

torch.set_num_threads(1)

FUNNEL = {"value_and_grad_fn": funnel_value_and_grad}


def std_normal(x):
    return -0.5 * torch.sum(x * x)


def warm_state(logd, chains, n, warmup=60, seed=0, max_depth=6, **kw):
    rng = np.random.default_rng(seed)
    x0 = torch.tensor(rng.standard_normal((chains, n)) * 0.5)
    return qt.nuts_sample(logd, seed, x0, n_samples=0, n_warmup=warmup, total_warmup=warmup,
                          max_depth=max_depth, **kw).state


def test_fallback_bitwise_identical_to_plain_run():
    """When the probe says don't sort, the whole output is bitwise what one
    plain run of n_samples gives."""
    st = warm_state(std_normal, 16, 3)
    res, info = qt.nuts_sample_depth_sorted(std_normal, st, n_samples=20, probe_draws=4,
                                            min_persistence=2.0, max_depth=6)
    assert info.sorted is False
    plain = qt.nuts_sample_from_state(std_normal, st, n_samples=20, max_depth=6)
    assert torch.equal(res.samples, plain.samples)
    assert torch.equal(res.state.x, plain.state.x)
    assert torch.equal(res.energies, plain.energies)
    assert int(res.state.i_samp) == int(plain.state.i_samp)


def test_small_budget_degenerates_to_plain_run():
    """Without telemetry, a budget too small for two probe legs is one
    plain run."""
    st = warm_state(std_normal, 8, 2)._replace(warm_dsum=None)
    res, info = qt.nuts_sample_depth_sorted(std_normal, st, n_samples=6, probe_draws=4,
                                            max_depth=6)
    assert info.sorted is False and res.samples.shape[0] == 6
    assert torch.equal(res.samples,
                       qt.nuts_sample_from_state(std_normal, st, n_samples=6,
                                                 max_depth=6).samples)


def _compose(st, order, groups, draws, max_depth=6, **kw):
    """The sorted path by hand: sub-fleets of ``order``'s stable groups
    under the sub-fleet keys, scattered back."""
    parts = []
    for gi, idx in enumerate(np.array_split(order, groups)):
        sub = _nuts_take_chains(st, torch.as_tensor(idx))
        sub = sub._replace(key=sampling._subfleet_key(st.key, gi))
        parts.append(qt.nuts_sample_from_state(funnel_logdensity, sub, n_samples=draws,
                                               max_depth=max_depth, **kw))
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    inv = torch.as_tensor(inv)
    return parts, inv


def test_sorted_path_matches_hand_composition():
    """Force the sorted path on the funnel (telemetry route: no probe legs)
    and pin the sort, scatter and merge bitwise against a hand-built
    composition from the same telemetry."""
    chains, n, draws, groups = 24, 4, 28, 3
    st = warm_state(funnel_logdensity, chains, n, warmup=80, seed=3, **FUNNEL)
    assert st.warm_dsum is not None
    syncs = qt.nuts_sample.host_syncs
    res, info = qt.nuts_sample_depth_sorted(funnel_logdensity, st, n_samples=draws,
                                            groups=groups, min_persistence=-2.0,
                                            min_depth_spread=0.0, max_depth=6, **FUNNEL)
    assert qt.nuts_sample.host_syncs > syncs
    assert info.sorted is True
    assert res.samples.shape == (draws, chains, n)
    assert info.group_sizes == (8, 8, 8)
    # the sort key: the warmup's second tail window's mean depth
    _w1s, _w2s, _w2e, W = _warm_depth_windows(int(st.n_warmup_total))
    d2 = st.warm_dsum.numpy().astype(np.float64)[1] / W
    order = np.argsort(d2, kind="stable")
    parts, inv = _compose(st, order, groups, draws, **FUNNEL)
    expected = torch.cat([r.samples for r in parts], dim=1)[:, inv]
    assert torch.equal(res.samples, expected)
    # merged state: per-chain fields scattered back, the parent key kept,
    # the telemetry kept in the original chain order
    assert torch.equal(res.state.x, torch.cat([r.state.x for r in parts])[inv])
    assert torch.equal(res.state.key, st.key)
    assert torch.equal(res.state.warm_dsum, st.warm_dsum)
    assert int(res.state.i_samp) == int(st.i_samp) + draws
    assert torch.equal(res.final_x, res.state.x)
    assert info.group_mean_depths == tuple(float(torch.mean(r.mean_tree_depth)) for r in parts)


def test_probe_leg_fallback_without_telemetry():
    """A state without telemetry sorts through two probe legs, bitwise
    reproducible by hand composition."""
    chains, n, draws, probe, groups = 16, 3, 20, 4, 2
    st = warm_state(funnel_logdensity, chains, n, warmup=60, seed=9,
                    **FUNNEL)._replace(warm_dsum=None)
    res, info = qt.nuts_sample_depth_sorted(funnel_logdensity, st, n_samples=draws,
                                            probe_draws=probe, groups=groups,
                                            min_persistence=-2.0, min_depth_spread=0.0,
                                            max_depth=6, **FUNNEL)
    assert info.sorted is True
    assert res.samples.shape == (draws, chains, n)
    p1 = qt.nuts_sample_from_state(funnel_logdensity, st, n_samples=probe, max_depth=6,
                                   **FUNNEL)
    p2 = qt.nuts_sample_from_state(funnel_logdensity, p1.state, n_samples=probe, max_depth=6,
                                   **FUNNEL)
    order = np.argsort(p2.mean_tree_depth.numpy().astype(np.float64), kind="stable")
    parts, inv = _compose(p2.state, order, groups, draws - 2 * probe, **FUNNEL)
    main = torch.cat([r.samples for r in parts], dim=1)[:, inv]
    assert torch.equal(res.samples, torch.cat([p1.samples, p2.samples, main]))


def test_warmup_depth_telemetry_chunked_equals_long():
    """warm_dsum rides the resume discipline: chunked warmup reproduces the
    long run's telemetry exactly (windows indexed by absolute round)."""
    x0 = torch.tensor(np.random.default_rng(2).standard_normal((12, 3)) * 0.5)
    kw = {"max_depth": 6, **FUNNEL}
    long = qt.nuts_sample(funnel_logdensity, 0, x0, n_samples=0, n_warmup=60, total_warmup=60,
                          **kw)
    c1 = qt.nuts_sample(funnel_logdensity, 0, x0, n_samples=0, n_warmup=33, total_warmup=60,
                        **kw)
    c2 = qt.nuts_sample_from_state(funnel_logdensity, c1.state, n_warmup=27, **kw)
    assert torch.equal(long.state.warm_dsum, c2.state.warm_dsum)
    assert float(long.state.warm_dsum.sum()) > 0


def test_sorted_state_resumes():
    st = warm_state(funnel_logdensity, 12, 3, warmup=60, seed=5, **FUNNEL)
    res, info = qt.nuts_sample_depth_sorted(funnel_logdensity, st, n_samples=16, probe_draws=3,
                                            groups=2, min_persistence=-2.0,
                                            min_depth_spread=0.0, max_depth=5, **FUNNEL)
    assert info.sorted is True
    cont = qt.nuts_sample_from_state(funnel_logdensity, res.state, n_samples=4, max_depth=5,
                                     **FUNNEL)
    assert cont.samples.shape == (4, 12, 3)
    assert bool(torch.isfinite(cont.samples).all())


def _errors(fn_port, fn_jax):
    with pytest.raises(ValueError) as port_err:
        fn_port()
    with pytest.raises(ValueError) as jax_err:
        fn_jax()
    assert str(port_err.value) == str(jax_err.value)
    return str(port_err.value)


def test_guards_keep_jax_text():
    """A partial warmup, a group count out of range and a negative budget
    raise with JAX's text (JAX's called on the port's states carried
    across: the guards raise before anything compiles)."""
    from test_torch_sampling_nuts_resume import jax_state

    def jax_f(x):
        return -0.5 * jnp.sum(x * x)

    st = warm_state(std_normal, 8, 2, warmup=6)
    partial = qt.nuts_sample(std_normal, 0, torch.zeros((8, 2), dtype=torch.float64),
                             n_samples=0, n_warmup=3, total_warmup=6)
    assert "completed warmup" in _errors(
        lambda: qt.nuts_sample_depth_sorted(std_normal, partial.state, n_samples=8),
        lambda: qj.nuts_sample_depth_sorted(jax_f, jax_state(partial.state), n_samples=8))
    stj = jax_state(st)
    assert "exceeds the chain count" in _errors(
        lambda: qt.nuts_sample_depth_sorted(std_normal, st, n_samples=8, groups=9),
        lambda: qj.nuts_sample_depth_sorted(jax_f, stj, n_samples=8, groups=9))
    assert "groups must be" in _errors(
        lambda: qt.nuts_sample_depth_sorted(std_normal, st, n_samples=8, groups=0),
        lambda: qj.nuts_sample_depth_sorted(jax_f, stj, n_samples=8, groups=0))
    assert "n_samples must be" in _errors(
        lambda: qt.nuts_sample_depth_sorted(std_normal, st, n_samples=-1),
        lambda: qj.nuts_sample_depth_sorted(jax_f, stj, n_samples=-1))


def test_sorted_moments_match_plain_run():
    """The sorted path's v-marginal moments agree with the plain full-fleet
    run from the same state at the same budget (guards against cross-fleet
    key correlation and scatter faults)."""
    chains, n = 128, 3
    st = warm_state(funnel_logdensity, chains, n, warmup=150, seed=7, max_depth=7, **FUNNEL)
    plain = qt.nuts_sample_from_state(funnel_logdensity, st, n_samples=160, max_depth=7,
                                      **FUNNEL)
    res, info = qt.nuts_sample_depth_sorted(funnel_logdensity, st, n_samples=160, groups=4,
                                            min_persistence=-2.0, min_depth_spread=0.0,
                                            max_depth=7, **FUNNEL)
    assert info.sorted
    vp = plain.samples[:, :, 0].numpy().ravel()
    vs = res.samples[:, :, 0].numpy().ravel()
    assert abs(vs.mean() - vp.mean()) < 0.5, (vs.mean(), vp.mean())
    assert 0.5 < vs.var() / vp.var() < 2.0, (vs.var(), vp.var())


def test_sorted_path_equals_jax_with_injected_seams(monkeypatch):
    """JAX's noise and sub-fleet keys injected: the port's warm state, its
    decision and its sorted run equal JAX's on a scale-spread Gaussian."""
    inject_jax_noise(monkeypatch)
    jax_f, port_f = gaussian((1.0, 1.0 / 30.0, 4.0))
    x0 = 0.5 * np.random.default_rng(12).standard_normal((12, 3))
    kw = {"max_depth": 5}
    port_warm = qt.nuts_sample(port_f, 8, torch.tensor(x0), n_samples=0, n_warmup=24,
                               **kw).state
    port, info = qt.nuts_sample_depth_sorted(port_f, port_warm, 8, groups=3,
                                             min_persistence=-1.0, min_depth_spread=0.0, **kw)

    def ref_run(start):
        warm = qj.nuts_sample(jax_f, jax.random.PRNGKey(8), jnp.asarray(start), n_samples=0,
                              n_warmup=24, **kw).state
        return qj.nuts_sample_depth_sorted(jax_f, warm, 8, groups=3, min_persistence=-1.0,
                                           min_depth_spread=0.0, **kw)

    ref, ref_info = ref_run(x0)
    assert info.sorted is ref_info.sorted is True
    assert info.group_sizes == ref_info.group_sizes == (4, 4, 4)
    assert abs(info.persistence - ref_info.persistence) <= 1e-12
    assert info.depth_spread == ref_info.depth_spread
    np.testing.assert_allclose(info.group_mean_depths, ref_info.group_mean_depths, rtol=1e-12)
    np.testing.assert_array_equal(port.mean_tree_depth.numpy(), np.asarray(ref.mean_tree_depth))
    np.testing.assert_array_equal(port.divergences.numpy(), np.asarray(ref.divergences))
    np.testing.assert_array_equal(port.state.key.numpy(),
                                  np.asarray(ref.state.key).astype(np.int64))
    errors = {f: normwise(getattr(port, f), getattr(ref, f))
              for f in ("samples", "energies", "step_size", "accept_prob", "final_x",
                        "mass_diag")}
    for field in ("x", "f", "g", "log_eps", "log_eps_bar", "h_bar", "var_ema", "warm_dsum"):
        errors[f"state.{field}"] = normwise(getattr(port.state, field),
                                            getattr(ref.state, field))

    def witness():
        return max(max(normwise(getattr(w, f), getattr(ref, f))
                       for f in ("samples", "energies", "step_size", "final_x"))
                   for w, _ in (ref_run(np.nextafter(x0, np.inf)),
                                ref_run(np.nextafter(x0, -np.inf))))

    assert_close_or_witnessed(errors, witness)
