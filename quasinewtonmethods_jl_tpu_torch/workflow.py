"""One-call MAP-then-sample pipeline — the PyTorch port of
``quasinewtonmethods_jl_tpu/workflow.py``.

The reference is "the inner MAP engine for HMC chain initialization"
(reference README.md:14); everything around it lived in other packages.
`map_then_sample` packages the whole loop:

    1. batched MAP solve from jittered starts (the fleet engines),
    2. chain initialization + preconditioner from the fleet
       (`chain_init_from_map`, or the exact Hessian for 'tr' / 'cg'),
    3. sampling through `sampling.get_sampler`,
    4. convergence diagnostics (split R-hat + ESS) over the draws,
    5. optionally, the evidence (Laplace, AIS or bridge sampling).

Each stage is the public entry point a user would call by hand; the
pipeline adds the glue, the failure handling (no converged lane ->
ValueError naming the statuses; failed lanes' chains reseeded from the
best mode) and one place to read the results.

Randomness. JAX splits ``key`` into ``k_init, k_jit, k_sample`` and takes
``fold_in(key, 3)`` for the evidence; the port derives the four keys on
the host by `_workflow_key` (the workflow's stream word, then 0-3), so no
existing sampler's stream changes. The glue's own draws go through seams,
as the samplers' do: `_start_noise` (the jittered starts, from
``k_init``), `_fallback_noise` (the reseeded failed lanes, JAX's
``fold_in(k_jit, 1)``) and `sampling._jitter_noise` (the 'tr' / 'cg'
chain jitter, JAX's ``normal(k_jit)``, the draw `chain_init_from_map`
makes from the same key). The tests fill them with JAX's draws.

Host reads. The glue reads the card where JAX's does: the MAP fleet's
statuses (one read for the failure check and the masks), Pathfinder's and
SVGD's any-finite tests and Pathfinder's best path (``pf.mass()``), and
the draws for the numpy moments below 8 draws. Each is counted in
``map_then_sample.host_syncs``; the engines it calls count their own.

``mesh=``: the chains are cut over ``mesh_axis`` of a `parallel.make_mesh`
mesh, every rank calling with the same arguments. The MAP fleet, polish
and the sampler run on each rank's chains (`parallel.mesh`'s data-parallel
path: B1 on the BFGS route) and are gathered; the glue between them (the
statuses, the handoff's fleet averages, the fallback), Pathfinder and SVGD,
the diagnostics over all chains and the evidence run on the gathered,
global values, the same on every rank. The result is the unsharded run's.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .api import as_logdensity
from .diagnostics import ChainDiagnostics, diagnose_chains_device
from . import sampling
from .parallel.batch import optimize_batched
from .sampling import (
    _MASK32,
    _WORKFLOW_STREAM,
    _as_key,
    _generator,
    _seed,
    chain_init_from_map,
    get_sampler,
)
from .state import Status
from .utils.device import as_device_tensor

__all__ = ["MapThenSampleResult", "map_then_sample"]


class MapThenSampleResult(NamedTuple):
    """Everything the pipeline produced, stage by stage.

    samples: (n_samples, chains, n) post-warmup draws
    diagnostics: per-dimension split R-hat / ESS / moments (None when
        compute_diagnostics=False was requested)
    map_result: the full batched MAP fleet result
    x_map: (n,) the best converged mode
    mass: the preconditioner handed to the sampler — (n, n) B for
        map_engine='bfgs', (n,) compact-form diag(H) for 'lbfgs', or
        None when the sampler adapts its own
    sampler_result: the sampler's own result object (adapted state etc.)
    """

    samples: torch.Tensor
    diagnostics: Optional[ChainDiagnostics]
    map_result: object
    x_map: torch.Tensor
    mass: Optional[torch.Tensor]
    sampler_result: object
    polish_result: object = None  # PolishResult when polish_steps > 0
    depth_sort_info: object = None  # DepthSortInfo when depth_sort=True
    # transform= only: the constrained-space view of the run. `samples` /
    # `x_map` stay in unconstrained z (that is what resume/state expects);
    # these are forward-mapped once, on the device.
    samples_constrained: Optional[torch.Tensor] = None
    x_map_constrained: Optional[torch.Tensor] = None
    # compute_evidence= only: log marginal likelihood ('laplace' at the
    # best mode, 'ais' from the fleet's Laplace base, 'bridge' over this
    # run's draws); evidence_extra carries the AISResult / BridgeResult
    # with its reliability diagnostic. For a transformed model it is the
    # constrained model's evidence (the Jacobian is part of the z-density).
    log_evidence: Optional[torch.Tensor] = None
    evidence_extra: object = None


def _workflow_key(key, i):
    """Sub-key ``i`` of the run's (2,) key tensor, derived on the host: 0-2 JAX's
    ``split(key, 3)`` (starts, jitter, sampler), 3 its ``fold_in(key, 3)``
    (the evidence)."""
    h = _seed(key, _WORKFLOW_STREAM, i)
    return torch.tensor([h >> 32, h & _MASK32], dtype=torch.int64)


def _start_noise(key, shape, dtype, device):
    """The standard-normal draw of the jittered starts (JAX's
    ``normal(k_init)``)."""
    gen = _generator(key, device, _WORKFLOW_STREAM, 0)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _fallback_noise(key, shape, dtype, device):
    """The standard-normal draw that reseeds failed lanes around the best
    mode (JAX's ``normal(fold_in(k_jit, 1))``)."""
    gen = _generator(key, device, _WORKFLOW_STREAM, 1)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _take(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[index]`` for a 0-d index tensor, without reading it to the host."""
    return torch.index_select(t, 0, index.reshape(1))[0]


def _best(ok: torch.Tensor, fun: torch.Tensor) -> torch.Tensor:
    """The -inf-masked argmax (the first maximum), on the device."""
    return torch.argmax(torch.where(ok, fun, torch.full_like(fun, -math.inf)))


def _status_counts(statuses: np.ndarray) -> dict:
    return {Status(int(s)).name: int(c)
            for s, c in zip(*np.unique(statuses, return_counts=True))}


def _check_array_mass(mass, leg):
    """The sampled evidence legs take a dense or diagonal mass only."""
    if mass is None or isinstance(mass, tuple) or not hasattr(mass, "ndim"):
        raise ValueError(
            f"compute_evidence={leg!r} needs an array mass (dense B or diag) from the MAP "
            f"handoff; mass_form='lowrank' is not supported — call qnm.{leg}_evidence with an "
            "explicit base"
        )


def map_then_sample(
    obj,
    key,
    x0,  # (n,) center for jittered starts, or (chains, n) starts
    n_chains: int = 64,
    sampler: str = "chees",
    map_engine: str = "bfgs",
    n_samples: int = 1000,
    n_warmup: int = 500,
    init_scale: float = 1.0,
    jitter: float = 0.05,
    map_tol: Optional[float] = None,
    compute_diagnostics: bool = True,
    value_and_grad_fn: Optional[Callable] = None,
    map_kwargs: Optional[dict] = None,
    polish_steps: int = 0,
    mass_form: str = "auto",
    mesh=None,
    mesh_axis: str = "data",
    depth_sort: bool = False,
    transform=None,
    init: str = "map",
    pathfinder_kwargs: Optional[dict] = None,
    svgd_kwargs: Optional[dict] = None,
    compute_evidence: Optional[str] = None,
    ais_kwargs: Optional[dict] = None,
    **sampler_kwargs,
) -> MapThenSampleResult:
    """MAP fleet -> preconditioner -> sampler -> diagnostics, in one call.

    ``x0``: an (n,) center (starts are x0 + init_scale * normal) or
    explicit (chains, n) starts; a tensor keeps its device and dtype,
    other input goes to the card (`utils.device.as_device_tensor`), and
    integer input is promoted to float32 (JAX's default float with x64
    off). ``key``: see `sampling`'s module docstring.

    ``sampler``: 'chees' (default), 'hmc' (the MAP fleet's dense B as
    mass), 'nuts', 'pt' (replica exchange; ladder kwargs pass through
    ``sampler_kwargs``, the MAP mass too), 'ensemble' (gradient-free, no
    mass handoff) or 'mclmc' (the mass's diagonal as preconditioner).
    ``map_engine``: 'bfgs', 'lbfgs' (the compact-form diag(H) as mass),
    'lm' (Levenberg–Marquardt on ``map_kwargs={'residual_fn': ...}``; the
    mass is inv(JTJ); ``obj`` must agree with −½Σρ(rᵢ²) up to a
    constant), 'tr' or 'cg' (matrix-free engines: the mass is the exact
    inv(−H) at the best converged mode, the identity where −H is not
    positive definite). ``map_tol`` defaults to 1e-3 for float32 and 1e-6
    otherwise; ``map_kwargs`` / ``sampler_kwargs`` override the
    pipeline's own on collision. Raises ValueError when no lane converges
    (statuses quoted); failed lanes' chains restart at the best converged
    mode, jittered.

    ``polish_steps > 0`` refines the converged modes by `polish_newton`
    before the handoff. ``mass_form='lowrank'`` (map_engine='lbfgs') hands
    the sampler a `LowRankMass` from the best lane's ring. ``depth_sort``
    (sampler='nuts' only) samples after warmup through
    `nuts_sample_depth_sorted` (its knobs ``groups``, ``probe_draws``,
    ``min_persistence``, ``min_depth_spread`` pass through
    ``sampler_kwargs``). ``transform``: a `transforms` bijection; ``x0`` is
    then constrained, every stage runs in unconstrained z, and the
    diagnostics are taken on the constrained draws
    (``samples_constrained``).

    ``compute_evidence``: 'laplace' (exact Hessian at the best converged
    mode), 'ais' (`ais_evidence` from the (x_map, mass) base) or 'bridge'
    (`bridge_evidence` on this run's draws against that base), with
    ``ais_kwargs`` passed to the estimator; needs init='map' and, for the
    sampled legs, an array mass.

    ``init='pathfinder'``: multi-path Pathfinder replaces the MAP fleet
    (chain starts its resampled draws, mass ``pf.mass()``, knobs in
    ``pathfinder_kwargs``); ``init='svgd'``: the chains start at SVGD
    particles and 'hmc' / 'pt' get their SPD-guarded covariance (knobs in
    ``svgd_kwargs``). Both take an (n,) center and refuse
    ``polish_steps`` and ``compute_evidence``.

    ``mesh`` / ``mesh_axis``: the chains cut over ``mesh_axis`` of a
    `parallel.make_mesh` mesh (see the module docstring); every rank
    calls with the same arguments and gets the whole result.
    ``depth_sort`` is single-device and refuses a mesh.
    """
    if init not in ("map", "pathfinder", "svgd"):
        raise ValueError(
            f"init must be 'map', 'pathfinder', or 'svgd', got {init!r}"
        )
    if compute_evidence not in (None, "laplace", "ais", "bridge"):
        raise ValueError(
            f"compute_evidence must be None, 'laplace', 'ais' or "
            f"'bridge', got {compute_evidence!r}"
        )
    if compute_evidence is not None and init != "map":
        raise ValueError(
            "compute_evidence needs the MAP fleet's mode/curvature — "
            "use init='map', or run qnm.ais_evidence with an explicit "
            f"(mu, cov) base on the init={init!r} output"
        )
    if init != "map" and polish_steps > 0:
        raise ValueError(
            f"init={init!r} has no MAP fleet to polish; drop "
            "polish_steps or use init='map'"
        )
    sample_fn = get_sampler(sampler)
    x0 = as_device_tensor(x0, "x0")
    if not x0.is_floating_point():
        x0 = x0.to(torch.float32)

    # constrained parameters: the whole pipeline runs in unconstrained z;
    # the constrained view of the outputs is forward-mapped at the end
    if transform is not None:
        from .transforms import TransformedModel, forward_draws

        obj = TransformedModel(obj, transform, value_and_grad_fn=value_and_grad_fn)
        value_and_grad_fn = None  # consumed: the wrapper pulls it back
        x0 = obj.unconstrain(x0)
    key = _as_key(key, map_then_sample)
    k_init, k_jit, k_sample = (_workflow_key(key, i) for i in range(3))
    if x0.ndim not in (1, 2):
        raise ValueError(f"x0 must be (n,) or (chains, n), got {tuple(x0.shape)}")
    if mesh is not None and x0.is_cuda:
        x0 = x0.to(mesh.device)
    if x0.ndim == 2:
        x0s, n_chains = x0, x0.shape[0]
    elif init != "pathfinder":  # Pathfinder jitters its own starts
        x0s = x0[None, :] + init_scale * _start_noise(k_init, (n_chains, x0.shape[0]),
                                                      x0.dtype, x0.device)
    if mesh is not None:
        from .parallel.mesh import _divides

        _divides(n_chains, mesh, mesh_axis, "n_chains")

    if init == "pathfinder":
        if x0.ndim != 1:
            raise ValueError(
                "init='pathfinder' takes an (n,) center (chain starts are "
                f"its resampled draws), got x0 shape {tuple(x0.shape)}"
            )
        from .pathfinder import pathfinder as _run_pathfinder

        pk = dict(n_draws=n_chains, init_scale=init_scale, value_and_grad_fn=value_and_grad_fn)
        if map_tol is not None:
            pk["tol"] = map_tol
        pk.update(pathfinder_kwargs or {})  # explicit kwargs win
        pf = _run_pathfinder(obj, k_init, x0, **pk)
        map_then_sample.host_syncs += 1
        if not bool(torch.any(torch.isfinite(pf.elbo))):
            map_then_sample.host_syncs += 1
            raise ValueError(
                f"pathfinder stage failed: no path produced a finite ELBO "
                f"(statuses: {_status_counts(pf.status.cpu().numpy())}); improve x0 or lower "
                f"init_scale"
            )
        fleet, pol, chains = pf, None, pf.draws  # n_draws=n_chains above
        map_then_sample.host_syncs += 1  # pf.mass() reads the best path
        mass = pf.mass()
        x_map = _take(pf.mu, torch.argmax(pf.elbo))
    elif init == "svgd":
        # deterministic particle transport: chain starts are the SVGD fleet;
        # its covariance is the 'hmc' / 'pt' mass (chees / nuts keep their
        # own adaptation: SVGD underestimates high-d covariance)
        if x0.ndim != 1:
            raise ValueError(
                "init='svgd' takes an (n,) center (chain starts are its "
                f"particles), got x0 shape {tuple(x0.shape)}"
            )
        from .svgd import svgd_sample as _run_svgd

        sk = dict(value_and_grad_fn=value_and_grad_fn)
        sk.update(svgd_kwargs or {})  # explicit kwargs win
        sv = _run_svgd(obj, x0s, **sk)  # x0s is JAX's `starts`: the same draw
        ok_sv = torch.isfinite(sv.logp)
        map_then_sample.host_syncs += 1
        if not bool(torch.any(ok_sv)):
            raise ValueError(
                "svgd stage failed: every particle's objective is "
                "non-finite; improve x0 or lower init_scale"
            )
        parts = sv.particles
        n = parts.shape[-1]
        w_sv = ok_sv.to(parts.dtype)
        w_sv = w_sv / torch.sum(w_sv)
        mu_sv = torch.einsum("b,bn->n", w_sv, parts)
        C = parts - mu_sv[None, :]
        cov_sv = torch.einsum("b,bi,bj->ij", w_sv, C, C)
        # SPD in-band: jittered toward its own diagonal scale; a degenerate
        # fleet (particles < n or collapsed) falls back to the diagonal
        eye = torch.eye(n, dtype=parts.dtype, device=parts.device)
        cov_j = cov_sv + (1e-6 * torch.trace(cov_sv) / n) * eye
        chol_sv, info = torch.linalg.cholesky_ex((cov_j + cov_j.mT) / 2)
        diag_sv = torch.clamp_min(torch.diagonal(cov_sv), 1e-10)
        spd = (info == 0) & torch.all(torch.isfinite(chol_sv))
        mass = torch.where(spd, cov_j, eye * diag_sv[None, :])
        fleet, pol, chains = sv, None, parts
        x_map = _take(parts, _best(ok_sv, sv.logp))
    else:
        fleet, pol, chains, mass, x_map = _map_stage(
            obj, x0s, x0.dtype, map_engine, map_tol, map_kwargs, value_and_grad_fn,
            polish_steps, jitter, k_jit, mass_form, _Lanes(mesh, mesh_axis),
        )

    kw = dict(n_samples=n_samples, n_warmup=n_warmup, value_and_grad_fn=value_and_grad_fn)
    if sampler in ("hmc", "pt", "mclmc"):
        # the dense-B handoff is the point of 'hmc'; 'pt' has no
        # self-adaptation either; 'mclmc' preconditions on the diagonal
        kw["mass"] = mass
    elif mass_form == "lowrank" or init == "pathfinder":
        # an explicitly requested low-rank metric (or Pathfinder's selected
        # one) overrides the self-adaptation of chees / nuts
        kw["mass"] = mass
    kw.update(sampler_kwargs)  # explicit sampler kwargs win
    ds_info = None
    if depth_sort:
        if sampler != "nuts":
            raise ValueError(
                f"depth_sort=True requires sampler='nuts' (got "
                f"{sampler!r}); ChEES/HMC trajectories are fleet-shared "
                "— there is no per-chain tree depth to sort on"
            )
        if mesh is not None:
            raise ValueError(
                "depth_sort=True is single-chip (the sort is a host-side "
                "permutation of the fleet state); drop mesh= or depth_sort"
            )
        from .sampling import nuts_sample, nuts_sample_depth_sorted

        ds_keys = ("groups", "probe_draws", "min_persistence", "min_depth_spread")
        ds_kw = {k: kw.pop(k) for k in ds_keys if k in kw}
        n_total = kw.pop("n_samples")
        warm = nuts_sample(obj, k_sample, chains, n_samples=0, total_warmup=kw["n_warmup"],
                           **kw)
        # the depth-sorted entry takes sampling-phase config only
        for k in ("n_warmup", "step_size", "mass_rank"):
            kw.pop(k, None)
        res, ds_info = nuts_sample_depth_sorted(obj, warm.state, n_total, **ds_kw, **kw)
        kw["n_samples"] = n_total  # the diagnostics gate below reads it
    elif mesh is not None:
        from .parallel.mesh import sample_sharded

        res = sample_sharded(obj, k_sample, chains, mesh, mesh_axis, sampler=sampler, **kw)
    else:
        res = sample_fn(obj, k_sample, chains, **kw)

    # transform=: report the draws and diagnostics on the constrained scale
    # (the Stan convention); the z-space outputs stay on the result
    samples_c = x_map_c = None
    if transform is not None:
        samples_c = forward_draws(transform, res.samples)
        x_map_c = transform.forward(x_map)
    diag_samples = res.samples if samples_c is None else samples_c

    if not compute_diagnostics:
        diag = None
    elif kw["n_samples"] >= 8:
        diag = diagnose_chains_device(diag_samples)
    else:
        # too few draws for split R-hat / ESS: the moments, NaN statistics
        map_then_sample.host_syncs += 1
        pooled = diag_samples.detach().cpu().numpy().reshape(-1, diag_samples.shape[-1])
        nan = np.full(pooled.shape[-1], np.nan)
        diag = ChainDiagnostics(
            rhat=nan, ess=nan.copy(), mean=pooled.mean(axis=0),
            std=pooled.std(axis=0, ddof=1) if pooled.shape[0] > 1 else nan.copy(),
        )

    # evidence: the fleet's mode and curvature are in hand (for a
    # transformed model this is the constrained model's evidence too)
    log_ev, ev_extra = None, None
    if compute_evidence == "laplace":
        from .laplace import laplace_evidence

        lz = laplace_evidence(fleet, obj=obj)
        log_ev = _take(lz, _best(fleet.status == Status.CONVERGED, fleet.fun))
    elif compute_evidence == "ais":
        from .ais import ais_evidence

        _check_array_mass(mass, "ais")
        ev = ais_evidence(obj, _workflow_key(key, 3), (x_map, mass),
                          value_and_grad_fn=value_and_grad_fn, **dict(ais_kwargs or {}))
        log_ev, ev_extra = ev.logZ, ev
    elif compute_evidence == "bridge":
        # post hoc: this run's z-space draws and the MAP base, no gradients
        from .bridge import bridge_evidence

        _check_array_mass(mass, "bridge")
        ev = bridge_evidence(obj, _workflow_key(key, 3), res.samples, (x_map, mass),
                             **dict(ais_kwargs or {}))
        log_ev, ev_extra = ev.logZ, ev

    return MapThenSampleResult(
        samples=res.samples,
        diagnostics=diag,
        map_result=fleet,
        x_map=x_map,
        mass=kw.get("mass"),
        sampler_result=res,
        polish_result=pol,
        depth_sort_info=ds_info,
        samples_constrained=samples_c,
        x_map_constrained=x_map_c,
        log_evidence=log_ev,
        evidence_extra=ev_extra,
    )


map_then_sample.host_syncs = 0


class _Lanes(NamedTuple):
    """How the pipeline's per-chain stages run: on this process's fleet, or
    on each rank's chains of ``mesh`` (cut over ``axis``) and gathered."""

    mesh: object
    axis: str

    def __call__(self, fn, lanes):
        """fn(lanes): ``lanes`` the starts or a fleet result."""
        if self.mesh is None:
            return fn(lanes)
        from .parallel.mesh import _fleet_call

        return _fleet_call(fn, lanes, self.mesh, self.mesh.axis(self.axis))


def _map_stage(obj, x0s, dtype, map_engine, map_tol, map_kwargs, value_and_grad_fn,
               polish_steps, jitter, k_jit, mass_form, on_lanes):
    """Stages 1-2 of the pipeline (MAP fleet -> polish -> handoff); split
    out so the other initializers can swap them wholesale. ``on_lanes``
    runs the per-chain stages (`_Lanes`)."""
    if map_tol is None:
        # the repo's precision contract: f32 is throughput mode, tol >= ~1e-3
        map_tol = 1e-3 if dtype == torch.float32 else 1e-6
    mk = dict(tol=map_tol, value_and_grad_fn=value_and_grad_fn)
    mk.update(map_kwargs or {})  # explicit map_kwargs win
    if map_engine == "lbfgs":
        from .parallel.batch import optimize_lbfgs_batched

        fleet = on_lanes(lambda x: optimize_lbfgs_batched(obj, x, **mk), x0s)
    elif map_engine == "bfgs":
        fleet = on_lanes(lambda x: optimize_batched(obj, x, **mk), x0s)
    elif map_engine == "lm":
        # the MAP as nonlinear least squares; `obj` must agree with
        # -1/2*sum(rho(r^2)) up to a constant (the pipeline cannot check it)
        from .least_squares import least_squares

        lm_kw = dict(mk)
        if lm_kw.pop("value_and_grad_fn", None) is not None:
            raise ValueError(
                "map_engine='lm' differentiates the residual_fn "
                "directly; value_and_grad_fn does not apply"
            )
        residual_fn = lm_kw.pop("residual_fn", None)
        if residual_fn is None:
            raise ValueError(
                "map_engine='lm' needs map_kwargs={'residual_fn': ...}"
                " (plus optional 'data', 'bounds', 'loss', ...)"
            )
        if on_lanes.mesh is None:
            fleet = least_squares(residual_fn, x0s, **lm_kw)
        else:  # per-lane data and bounds are cut with their lanes
            from .parallel.mesh import least_squares_sharded

            fleet = least_squares_sharded(residual_fn, x0s, on_lanes.mesh, on_lanes.axis,
                                          **lm_kw)
        # least_squares minimizes 1/2*|r|^2; the pipeline maximizes: fun,
        # last_value and grad flip together (JTJ and the state keep LM's
        # own orientation, so the state resumes unchanged)
        fleet = fleet._replace(fun=-fleet.fun, last_value=-fleet.last_value, grad=-fleet.grad)
    elif map_engine == "tr":
        # matrix-free: the mass is built after the solve from the exact
        # Hessian at the best mode (below)
        from .trust_region import optimize_tr

        fleet = on_lanes(lambda x: optimize_tr(obj, x, **mk), x0s)
    elif map_engine == "cg":
        # matrix-free like 'tr': it shares the exact-Hessian handoff
        from .cg_solve import optimize_cg

        fleet = on_lanes(lambda x: optimize_cg(obj, x, **mk), x0s)
    else:
        raise ValueError(
            f"unknown map_engine {map_engine!r}; use 'bfgs', 'lbfgs',"
            " 'lm', 'tr', or 'cg'"
        )

    # one status read serves the failure check and the fallback's need
    map_then_sample.host_syncs += 1
    statuses = fleet.status.cpu().numpy()
    converged = statuses == Status.CONVERGED
    if not converged.any():
        raise ValueError(
            f"MAP stage failed: no lane converged (statuses: {_status_counts(statuses)}); "
            "loosen map_tol or improve the starts"
        )

    pol = None
    if polish_steps > 0:
        from .polish import polish_newton

        pol = on_lanes(lambda fl: polish_newton(obj, fl, steps=polish_steps,
                                                value_and_grad_fn=value_and_grad_fn), fleet)
        # the polished modes feed the handoff; the curvature state stays
        fleet = fleet._replace(x=pol.x.to(fleet.x.dtype), fun=pol.fun.to(fleet.fun.dtype))

    ok = fleet.status == Status.CONVERGED  # the mask on the device, no copy of `converged`
    if map_engine in ("tr", "cg"):
        # the exact observed information at the best converged mode:
        # mass = inv(-H), the identity where -H is not positive definite
        # (JAX's inv and cholesky give NaN there; inv_ex and cholesky_ex
        # report it in `info`, with no host read)
        if mass_form != "auto":
            raise ValueError(
                f"map_engine={map_engine!r} hands over the exact-Hessian "
                f"inverse; mass_form={mass_form!r} does not apply "
                "(use 'auto')"
            )
        x_best = _take(fleet.x, _best(ok, fleet.fun))
        H = torch.func.hessian(as_logdensity(obj))(x_best)
        n = fleet.x.shape[-1]
        eye = torch.eye(n, dtype=fleet.x.dtype, device=fleet.x.device)
        minv, info_inv = torch.linalg.inv_ex(-H)
        chol, info_chol = torch.linalg.cholesky_ex(-(H + H.mT) / 2)
        spd = ((info_inv == 0) & (info_chol == 0) & torch.all(torch.isfinite(chol))
               & torch.all(torch.isfinite(minv)))
        mass = torch.where(spd, minv, eye)
        # the draw chain_init_from_map makes from the same key (its seam)
        chains = fleet.x + jitter * sampling._jitter_noise(k_jit, fleet.x.shape, fleet.x.dtype,
                                                           fleet.x.device)
    else:
        chains, mass = chain_init_from_map(fleet, jitter=jitter, key=k_jit, mass_form=mass_form)
    x_map = _take(fleet.x, _best(ok, fleet.fun))
    if not converged.all():
        # never seed a chain from a failed lane's off-mode iterate
        fallback = x_map[None, :] + jitter * _fallback_noise(k_jit, chains.shape, chains.dtype,
                                                             chains.device)
        chains = torch.where(ok[:, None], chains, fallback)
    return fleet, pol, chains, mass, x_map
