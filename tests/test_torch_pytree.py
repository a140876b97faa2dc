"""The port's pytree adapters (pytree.py) against the JAX package's, on the
CPU in f64: the ravel order of an insertion-ordered dict (JAX sorts the
keys), ``None`` values (JAX drops them), mixed dtypes (one promoted flat
dtype, each leaf cast back), `pytree_names`, and every wrapper against its
JAX twin on the same numpy starts — single solves and ``stacked=True``
fleets, an analytic value_and_grad over the pytree, TR and LM bounds given
as pytrees.

The flat vectors are equal bit for bit; counters equal lane by lane;
floats within rtol 1e-8 (atol 1e-10).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import quasinewtonmethods_jl_tpu as qnm
import quasinewtonmethods_jl_tpu_torch as qt
from quasinewtonmethods_jl_tpu_torch.pytree import _ravel

torch.set_num_threads(1)

TA = np.array([1.0, -0.5, 0.25])
COUNTERS = {
    "bfgs": ("status", "iterations", "n_fev", "n_gev", "n_resets"),
    "tr": ("status", "iterations", "n_fev", "n_hev"),
    "lm": ("status", "iterations", "n_fev", "n_jev"),
    "auglag": ("status", "n_outer", "iterations", "n_fev", "inner_status"),
}


def _xp(t):
    return torch if isinstance(t, torch.Tensor) else jnp


def tree_obj(t):
    """A coupled, strictly concave log-density of {'b': (2,), 'a': (3,),
    'c': {'s': ()}} with a unique mode (either package)."""
    a, b, s = t["a"], t["b"], t["c"]["s"]
    xp = _xp(a)
    ta = torch.tensor(TA) if xp is torch else jnp.asarray(TA)
    return (-xp.sum((a - ta) ** 2) - 0.5 * xp.sum((b + 0.2) ** 2) - (s - 0.7) ** 2
            - 0.1 * (a[0] * b[1] - 0.3) ** 2 - 0.05 * xp.sum(a ** 4) - 0.3 * (s - b[0]) ** 2)


def tree_resid(t):
    a, b, s = t["a"], t["b"], t["c"]["s"]
    xp = _xp(a)
    ta = torch.tensor(TA) if xp is torch else jnp.asarray(TA)
    return xp.concatenate([a - ta, 0.7 * (b + 0.2), xp.stack([s - 0.7, a[0] * b[1] - 0.3])])


def _values(batch=None, seed=20260816):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return {"b": rng.standard_normal(lead + (2,)), "a": rng.standard_normal(lead + (3,)),
            "s": rng.standard_normal(lead)}


def _trees(batch=None):
    """The port's tree in insertion order b, a, c; JAX's the same (it
    sorts)."""
    v = _values(batch)
    port = {"b": torch.tensor(v["b"]), "a": torch.tensor(v["a"]),
            "c": {"s": torch.tensor(v["s"])}}
    ref = {"b": jnp.asarray(v["b"]), "a": jnp.asarray(v["a"]), "c": {"s": jnp.asarray(v["s"])}}
    return port, ref


def _assert_tree(port, ref):
    np.testing.assert_allclose(port["a"].numpy(), np.asarray(ref["a"]), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(port["b"].numpy(), np.asarray(ref["b"]), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(port["c"]["s"].numpy(), np.asarray(ref["c"]["s"]), rtol=1e-8,
                               atol=1e-10)
    assert list(port) == ["b", "a", "c"]  # the caller's own structure back


def _assert_same(port, ref, counters):
    (pp, pr), (rp, rr) = port, ref
    _assert_tree(pp, rp)
    for name in counters:
        np.testing.assert_array_equal(getattr(pr, name).numpy(), np.asarray(getattr(rr, name)),
                                      err_msg=name)
    np.testing.assert_allclose(pr.x.numpy(), np.asarray(rr.x), rtol=1e-8, atol=1e-10)


def test_an_insertion_ordered_dict_ravels_in_jaxs_order():
    port, ref = _trees()
    flat, unravel = _ravel(port)
    jflat, _ = ravel_pytree(ref)
    assert torch.equal(flat, torch.tensor(np.asarray(jflat)))
    np.testing.assert_array_equal(flat[:3].numpy(), port["a"].numpy())  # a before b
    back = unravel(flat)
    assert list(back) == ["b", "a", "c"]
    assert all(torch.equal(back[k], port[k]) for k in ("a", "b"))
    stacked, sref = _trees(batch=4)
    fleet, unravel_b = _ravel(stacked, batched=True)
    jfleet = jax.vmap(lambda t: ravel_pytree(t)[0])(sref)
    assert torch.equal(fleet, torch.tensor(np.asarray(jfleet)))
    assert torch.equal(unravel_b(fleet)["c"]["s"], stacked["c"]["s"])


def test_none_values_are_dropped_as_in_jax():
    v = _values()
    port = {"b": (torch.tensor(v["b"]), None), "skip": None, "a": torch.tensor(v["a"])}
    ref = {"b": (jnp.asarray(v["b"]), None), "skip": None, "a": jnp.asarray(v["a"])}
    flat, unravel = _ravel(port)
    assert torch.equal(flat, torch.tensor(np.asarray(ravel_pytree(ref)[0])))
    back = unravel(flat)
    assert back["skip"] is None and back["b"][1] is None and list(back) == ["b", "skip", "a"]
    assert qt.pytree_names(port) == qnm.pytree_names(ref) == ["a[0]", "a[1]", "a[2]", "b.0[0]",
                                                             "b.0[1]"]

    def obj(t):
        return tree_obj({"a": t["a"], "b": t["b"][0], "c": {"s": t["a"][1]}})

    pp, pr = qt.optimize_pytree(obj, port)
    rp, rr = qnm.optimize_pytree(obj, ref)
    np.testing.assert_allclose(pr.x.numpy(), np.asarray(rr.x), rtol=1e-8, atol=1e-10)
    assert pp["skip"] is None and pp["b"][1] is None
    assert int(pr.iterations) == int(rr.iterations)


@pytest.mark.parametrize("other", ["float32", "int32"])
def test_mixed_dtypes_promote_and_cast_back_as_in_jax(other):
    w = np.arange(3.0)
    k = np.arange(2.0).astype(other)
    port = {"w": torch.tensor(w), "k": torch.tensor(k)}
    ref = {"w": jnp.asarray(w), "k": jnp.asarray(k)}
    flat, unravel = _ravel(port)
    jflat, junravel = ravel_pytree(ref)
    assert str(flat.dtype).replace("torch.", "") == str(jflat.dtype)
    assert torch.equal(flat, torch.tensor(np.asarray(jflat)))
    back = unravel(flat * 1.5)
    jback = junravel(jflat * 1.5)
    for key in ("w", "k"):
        assert str(back[key].dtype).replace("torch.", "") == str(jback[key].dtype)
        np.testing.assert_array_equal(back[key].numpy(), np.asarray(jback[key]))
    with pytest.raises(TypeError, match="unravel function given array of dtype float32, but "
                                        "expected dtype float64"):
        unravel(flat.float())
    with pytest.raises(TypeError, match="unravel function given array of dtype float32, but "
                                        "expected dtype float64"):
        junravel(jflat.astype(jnp.float32))


def test_integer_parameters_raise_as_in_jax():
    with pytest.raises(TypeError, match="parameters must be floating point, got int32"):
        qt.optimize_pytree(lambda t: -torch.sum(t["n"] ** 2),
                           {"n": torch.tensor([1, 2], dtype=torch.int32)})
    with pytest.raises(TypeError, match="parameters must be floating point, got int32"):
        qnm.optimize_pytree(lambda t: -jnp.sum(t["n"] ** 2),
                            {"n": jnp.asarray([1, 2], dtype=jnp.int32)})


class Pair(NamedTuple):
    y: object
    x: object


def test_pytree_names_match_jax():
    def tree(xp):
        return {"beta": xp.zeros((2, 2)), "mu": xp.zeros(()),
                "groups": [xp.zeros(3), {"z": xp.zeros(()), "off": xp.zeros((1, 2))}],
                "nt": Pair(xp.zeros(1), xp.zeros(())), "none": None, "A": xp.zeros(2)}

    assert qt.pytree_names(tree(torch)) == qnm.pytree_names(tree(jnp))
    assert qt.pytree_names(torch.zeros(2)) == qnm.pytree_names(jnp.zeros(2)) == ["[0]", "[1]"]


@pytest.mark.parametrize("wrapper", ["optimize_pytree", "optimize_lbfgs_pytree"])
def test_single_solve_wrappers_match_jax(wrapper):
    port, ref = _trees()
    _assert_same(getattr(qt, wrapper)(tree_obj, port, tol=1e-6),
                 getattr(qnm, wrapper)(tree_obj, ref, tol=1e-6), COUNTERS["bfgs"])


def test_the_fleet_wrapper_matches_jax():
    port, ref = _trees(batch=4)
    out = qt.optimize_batched_pytree(tree_obj, port, tol=1e-6)
    jout = qnm.optimize_batched_pytree(tree_obj, ref, tol=1e-6)
    _assert_same(out, jout, COUNTERS["bfgs"])
    assert out[0]["a"].shape == (4, 3) and out[0]["c"]["s"].shape == (4,)
    with pytest.raises(ValueError, match="leading batch axis"):
        qt.optimize_batched_pytree(tree_obj, {"s": torch.tensor(1.0, dtype=torch.float64)})


def _vag(xp):
    if xp is torch:
        def vag(t):
            g, v = torch.func.grad_and_value(tree_obj)(t)
            return v, g
        return vag
    return jax.value_and_grad(tree_obj)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("analytic", [False, True])
def test_the_cg_wrapper_matches_jax(stacked, analytic):
    port, ref = _trees(batch=4 if stacked else None)
    kw = {"stacked": stacked, "tol": 1e-6}
    _assert_same(qt.optimize_cg_pytree(tree_obj, port, value_and_grad_fn=_vag(torch)
                                       if analytic else None, **kw),
                 qnm.optimize_cg_pytree(tree_obj, ref, value_and_grad_fn=_vag(jnp)
                                        if analytic else None, **kw), COUNTERS["bfgs"])


def _bounds(xp):
    """A pytree lower side (a[1] >= -0.3 binds) and a scalar upper side."""
    inf = float("inf")
    lo = {"b": [-inf, -inf], "a": [-inf, -0.3, -inf], "c": {"s": -inf}}
    leaf = (lambda v: torch.tensor(v, dtype=torch.float64)) if xp is torch else jnp.asarray
    return {"b": leaf(lo["b"]), "a": leaf(lo["a"]), "c": {"s": leaf(lo["c"]["s"])}}, inf


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("bounded", [False, True])
def test_the_tr_wrapper_matches_jax(stacked, bounded):
    port, ref = _trees(batch=4 if stacked else None)
    kw = {"stacked": stacked, "tol": 1e-6}
    out = qt.optimize_tr_pytree(tree_obj, port, bounds=_bounds(torch) if bounded else None, **kw)
    jout = qnm.optimize_tr_pytree(tree_obj, ref, bounds=_bounds(jnp) if bounded else None, **kw)
    _assert_same(out, jout, COUNTERS["tr"])
    if bounded:
        assert bool((out[0]["a"][..., 1] >= -0.3).all())
        np.testing.assert_allclose(out[0]["a"][..., 1].numpy(), -0.3, atol=1e-7)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("bounded", [False, True])
def test_the_least_squares_wrapper_matches_jax(stacked, bounded):
    port, ref = _trees(batch=4 if stacked else None)
    kw = {"stacked": stacked, "tol": 1e-6}
    out = qt.least_squares_pytree(tree_resid, port, bounds=_bounds(torch) if bounded else None,
                                  **kw)
    jout = qnm.least_squares_pytree(tree_resid, ref, bounds=_bounds(jnp) if bounded else None,
                                    **kw)
    _assert_same(out, jout, COUNTERS["lm"])


def _eq(t):
    return t["a"].sum() + t["c"]["s"]


def _ineq(t):
    xp = _xp(t["a"])
    return xp.stack([1.2 - xp.sum(t["a"] ** 2) - xp.sum(t["b"] ** 2)])


@pytest.mark.parametrize("stacked", [False, True])
def test_the_auglag_wrapper_matches_jax(stacked):
    port, ref = _trees(batch=3 if stacked else None)
    kw = {"stacked": stacked, "tol": 1e-7, "ctol": 1e-7}
    out = qt.optimize_auglag_pytree(tree_obj, port, eq=_eq, ineq=_ineq, **kw)
    jout = qnm.optimize_auglag_pytree(tree_obj, ref, eq=_eq, ineq=_ineq, **kw)
    _assert_same(out, jout, COUNTERS["auglag"])
    np.testing.assert_allclose(out[1].lam.numpy(), np.asarray(jout[1].lam), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("method", ["bfgs", "lbfgs", "cg", "tr"])
def test_the_minimize_wrapper_matches_jax(method):
    port, ref = _trees()
    counters = COUNTERS["tr"] if method == "tr" else COUNTERS["bfgs"]
    neg = lambda t: -tree_obj(t)  # noqa: E731
    out = qt.minimize_pytree(neg, port, method=method, tol=1e-6)
    jout = qnm.minimize_pytree(neg, ref, method=method, tol=1e-6)
    _assert_same(out, jout, counters)
    np.testing.assert_allclose(float(out[1].fun), float(jout[1].fun), rtol=1e-8)


def test_the_constrained_minimize_wrapper_matches_jax():
    port, ref = _trees(batch=3)
    neg = lambda t: -tree_obj(t)  # noqa: E731
    kw = {"stacked": True, "tol": 1e-7, "ctol": 1e-7}
    _assert_same(qt.minimize_pytree(neg, port, ineq=_ineq, **kw),
                 qnm.minimize_pytree(neg, ref, ineq=_ineq, **kw), COUNTERS["auglag"])
