#!/usr/bin/env python3
"""Smoke run of the PyTorch port (quasinewtonmethods_jl_tpu_torch) on one
NVIDIA GPU: builds the hand-written CUDA kernels, checks each against its
plain PyTorch version, and drives the port's paths once at full width: the
BFGS fleet engine through `optimize_batched` on the benchmark fleet (kernel
B1), the same engine on a large-n fleet (the two-pass kernels B2a and B2b),
the resident engine `optimize_batched_resident` (B3, on the bench fleet, on
every model it has an instantiation for, and on traced objectives), the
nonlinear-CG fleet `optimize_cg` (the benchmark's headline engine; torch
ops, no hand-written kernel), the BFGS fleet with the Wolfe search (B1), with ``fold_eval``, and
with straggler compaction (`optimize_batched_compacted`, B1), the scalar
BFGS and L-BFGS drivers (`optimize`, `optimize_lbfgs`), the L-BFGS fleets
(`optimize_lbfgs_batched`) and ``backend="vmap"``, none of which runs a
hand-written kernel, the minimization front door: `least_squares`,
`optimize_tr`, `optimize_auglag` (its BFGS fleet on B1) and `minimize`,
and the MAP back end: `optimize_multistart` (B1), `polish_newton`,
`laplace_evidence`, checkpoints (`save_state` / `load_state`),
`optimize_batched_pytree` (B1), `optimize_implicit` and the chain
diagnostics, the samplers the MAP fleet hands over to: HMC, ChEES,
NUTS and depth-sorted NUTS, the workflow's other initializers and
samplers, and evidence by sampling (AIS, adaptive tempered SMC, bridge
sampling).

Phases (one summary line each on stdout, or a few; any failed check raises):
  1. device: name, CUDA version, ``nvidia-smi`` name and power limit;
  2. build: the kernel library from ``quasinewtonmethods_jl_tpu_torch/csrc``
     for sm_90a, one nvcc per source in parallel (nvcc's resource report
     goes to stderr), and beside it phases 22's and 23's objectives, traced,
     generated and built one nvcc each; both builds run in background
     processes (niced, off one core) while the traces are made; beside
     them phase 16's float32 starts and phase 9's plain runs (made ahead,
     saved to a file) run in processes of their own on the card, and this
     one makes ahead the plain versions phases 21-23 and 33-35 compare
     against (none of them launches a hand-written kernel or times
     anything; `prefetch_plain` stops once the four processes have
     ended); this phase waits for them: the run's order is 1, the traces
     (phases 22, 23 and 33-35) and the runs ahead, 2, then 3-35;
  3. B1 against its plain version: f32 and f64, n in {2, 7, 33, 60, 61, 65,
     128} and the largest n that fits (237 f32, 167 f64), every lane kind
     (active, frozen, fresh, forced reset, NaN);
  4. main path: 4096 split-Rosenbrock n=60 solves in f32 (seed 20260816,
     analytic gradient, tol 1e-3, at most 3000 iterations) on cuda:0; every
     lane must converge, and every loop body must have launched B1;
  5. exact parity of B1 and the plain update on an f64 quadratic fleet;
  6. times: B1 and the plain version per call at 4096 x 60 f32 (B1 also
     by its device time per launch, torch.profiler; the run fails if the
     profiler records no launch), B1's share of its bound by each time and
     its launch shape (registers, threads, blocks per SM), and solves/s of
     phase 4 through each;
  7. B2 (each pass and the whole two-pass update) against its plain
     version: f32 and f64, n in {2, 7, 60, 250, 512}, every lane kind;
  8. large-n path: 1024 split-Rosenbrock n=512 solves in f32 (seed
     20260816, tol 1e-3, at most 3000 iterations) through `optimize_batched`,
     which must dispatch to B2 (both passes launched once per loop body, B1
     never); and an f64 64 x 200 fleet, B2 against the plain update;
  9. B3 against its plain version (the fleet engine with the plain update):
     f64 Rosenbrock fleets, n in {2, 5, 6, 17, 24, 60, 65}, and the phase-4
     fleet in f32, both line-search orders, h0 scaling on and off, caps 0,
     1, 5 and 3000; a tol 1e-14 run and an f32 overflow start; the errors
     and, over whole solves, the lanes whose counters differ, each against
     what a change of rounding alone does to the plain version (started 1
     ulp away; at the phase-4 fleet's caps 1 and 5 also run on the CPU);
     and how fast a 1-ulp difference grows along a trajectory. A whole
     solve's plain run and its one-ulp witnesses on the card run as one
     fleet of their starts stacked (`stacked_runs`: the engine steps each
     lane on its own, and the host, which bounds these runs, drives the
     loop once), here and in phases 21-23;
 10. resident path: `optimize_batched_resident` on the phase-4 fleet, one
     launch and no host synchronisation;
 11. times: B2 and each pass against the plain version at 1024 x 512 f32,
     B1 and B2 near their split (n in {128, 192, 232}, batch 1024), solves/s
     of the large-n fleet through B2 and the plain update, and of the
     benchmark fleet through B3, B1 and the plain update, with peak device
     memory; the device's busy time in one solve of each fleet-engine path
     (torch.profiler), and B3's time against fleet size (CUDA events), its
     share of its bound and its launch shape;
 12. CG headline: the phase-4 fleet through `optimize_cg` with its defaults
     (Hager–Zhang, approximate Wolfe); every lane must converge with the
     median iteration count within 10 % of the JAX package's, no kernel
     launched, and every host synchronisation a counted one (sync debug
     mode); solves/s with and without ``fold_eval`` (2 turns each, with each
     turn's difference), host syncs and loop bodies per solve, peak device memory, the device's busy share
     over a solve's first 100 iterations (torch.profiler);
 13. BFGS with the Wolfe search: the phase-4 fleet through
     `optimize_batched(ls=Wolfe())`, every lane converged, median within 10 %
     of the JAX package's, B1 launched once per loop body; then
     ``fold_eval=True`` for the BFGS and CG engines (CG's: phase 12's
     timed solve), which must converge every lane with fewer evaluations;
     solves/s (2 turns each, with each turn's difference);
 14. compaction: the phase-4 fleet through `optimize_batched_compacted`
     with kernel='cuda': the statuses of `optimize_batched_fused`, every
     lane certified, B1 launched; the lanes whose counters differ from the
     fused run's (rounding, not asserted); solves/s of both (2 turns each,
     with each turn's difference);
 15. entry points given numpy: `optimize_batched` and `optimize_cg` given a
     float64 numpy fleet return float32 results on the card (JAX's x64-off
     dtype), and a CG state saved as numpy resumes there;
 16. scalar BFGS: `optimize` on bench_full.py's n=60 Rosenbrock start
     (seed 20260816, tol 1e-3, analytic gradient) with BFGS in f32, and
     DFP without the H0 scaling (with it DFP stalls, in JAX too) and SR1 in
     f64, each of which must converge; DFP (H0 scaling off) and SR1 in f32
     from the start and 15 starts near it (in f32 rounding decides whether
     a start converges), whose count of converged starts must not fall
     below the JAX package's on the same starts by more than chance (a
     one-sided Fisher exact test at 1 %); the n=256 condition-1e4
     quadratic; `optimize_from_state` resuming a 40-iteration solve saved
     as numpy; iterations beside the JAX package's, every host
     synchronisation a counted one (sync debug mode), no kernel launched;
 17. scalar L-BFGS: `optimize_lbfgs(history=10)` on the n=4096 diagonal
     quadratic of bench_full.py:106-119, both direction methods;
     iterations (JAX: 22) and host syncs per iteration;
 18. L-BFGS fleets: 1024 x 512 and 256 x 4096 Rosenbrock through
     `optimize_lbfgs_batched` (seed 20260816, tol 1e-3, at most 3000
     iterations, analytic gradient): every lane converged, the median
     iteration count within 10 % of the JAX package's, every sync counted,
     no kernel launched; solves/s (2 turns), host syncs and loop bodies per
     solve, device events per body and busy share (torch.profiler), peak
     memory; each fleet resumed from a state saved as numpy; TF32 off; then
     the shift ring against the circular ring, whole solves in turns at
     4096 x 60, 1024 x 512 and 256 x 4096, one turn each (wall per loop
     body), beside the dispatch constant `_RING_CIRCULAR_MIN_N`;
 19. ``backend="vmap"``: the bench fleet's first 16 lanes through
     `optimize_batched(backend="vmap")` (the scalar driver lane by lane):
     statuses equal to the fused engine's, median within 10 % of its;
 20. B3 on the data-bearing objectives (csrc/resident_objectives.cuh): the
     ill-conditioned quadratic (n in {7, 60, 100, 236} f32, {7, 60, 100,
     165} f64) and the logistic-regression MAP (n = 100, 500 observations)
     against the plain version on the same model, caps 0, 1, 5 (every
     counter equal) and whole solves (statuses equal), also at the two
     fleets below; then the slice at full width: BASELINE config 3's
     posterior (500 observations, prior scale 10, data drawn with numpy from
     seed 20260816) from 4096 N(0, 1) starts in f32, tol 3e-3, through
     `optimize_batched_resident` (one launch, no host synchronisation) and
     through `optimize_batched` (B1), each with every lane converged and the
     median within 10 % of the JAX package's; a 1024 x 236 f32 quadratic
     fleet (condition 1e4) through `optimize_batched_resident` (one launch);
     ms per solve of B3, the fleet engine and the plain version in turns,
     B3's share of its bound and launch shape, peak memory; and the scalar
     `optimize` on config 3 from zeros(100) against the JAX package's count;
 21. B3 on the fixture families (csrc/resident_objectives.cuh): Neal's
     funnel (n in {4, 10, 70} f64), the Gaussian mixture of 8 components
     (n in {60, 7, 100}), the Poisson GLM (n in {50, 7, 100}; both in f32
     and f64) and the AR(1) state-space MAP (n in {8, 5, 70} f64) against
     the plain version on the same model over 64 lanes: caps 0, 1, 5
     (every counter equal; floats within 1e-5 / 1e-10 or twice what the
     plain version moves when run on the CPU) and, at the first two n,
     whole solves, where the lanes whose status differs from the plain
     run's may be at most twice as many as a change of rounding alone
     gives the plain version (phase 9's witnesses: started 1 ulp up or
     down, run on the CPU); then the slice at
     full width: five fleets of 4096 starts with data and starts drawn by
     numpy from seed 20260816 (funnel n = 4 f64 tol 1e-6, mixture n = 60
     f32 tol 1e-3, Poisson n = 50 with 400 observations f32 tol 1e-2 and
     f64 tol 1e-6, AR(1) n = 8 with 32 steps f64 tol 1e-6), each against
     the plain version as above and then through
     `optimize_batched_resident` (one launch, no
     host synchronisation) and `optimize_batched` (B1, one launch per loop
     body): every lane converged where the JAX package converges every
     lane (mixture, Poisson), else the converged count not below the JAX
     package's by more than chance (a one-sided Fisher exact test at 1 %),
     and the median within 10 % of the JAX package's
     (scripts/jax_fixture_reference.py); ms per solve of B3 (in turns),
     the fleet engine (its counted B1 run, timed in place of a second
     call) and the plain version, B3's share of its bound and
     launch shape, and every B3 instantiation's registers per thread;
 22. B3 on traced objectives (ops/kernels/objective_trace.py,
     objective_codegen.py): every objective of the phase traced, generated
     as CUDA and built together (one nvcc per source in parallel; build
     seconds cold, loaded in the process and from the disk cache, ptxas's
     registers and spills); B3 against its plain version (the fleet engine
     with the plain update on the user's functions) on 64-lane fleets in
     f64 and f32: the torch twins of the JAX package's inline objectives
     (a quadratic form with a linear term, a logsumexp, a NaN-returning
     where, a logistic with logaddexp) and the port's models in forms the
     hand-written instantiations do not take (the Rosenbrock in a lambda
     and with its value_and_grad_fn, the mixture's, logistic's and AR(1)'s
     bound logdensity, the funnel in a lambda and with a user
     value_and_grad_fn, the dense quadratic), caps 0, 1, 5 (every counter
     equal on every lane, floats within twice what the plain version's own
     run on the CPU moves it on the lanes where that run keeps its
     counters) and whole solves (statuses, as in phase 21); then the slice at full width: the bench fleet as
     ``lambda x: rosenbrock_logdensity(x)``, BASELINE config 3's logistic
     posterior as ``model.logdensity``, ROADMAP B.1's dense quadratic
     -0.5·x@(Q@x) + b@x (1024 starts at n = 232, the largest n B3 holds
     for it in float32) and the mixture as ``model.logdensity``, each
     against its plain version, through `optimize_batched_resident` (one
     launch, no host synchronisation) and `optimize_batched` (B1): every
     lane converged, the median within 10 % of the JAX package's
     (scripts/jax_traced_reference.py); trace and codegen ms per call, ms
     per solve of B3 on the trace, of the entry point on the function
     itself (its first call, which traces, and a second, which takes the
     kept trace), of the hand-written instantiation (fleets 1, 2, 4) in
     turns, of the fleet engine (its counted B1 run, timed in place of a
     second call) and the plain version, B3 traced's share of its
     bound (what the function needs, as its hand-written twin counts it)
     and launch shape.
 23. B3 on the hierarchical model (transforms.py, models/hierarchical.py,
     the trace's cumsum, index maps and the transforms' elementwise ops):
     B3 against its plain version, as in phase 22, on 64-lane fleets in
     f64 and f32 of one transformed density per op group the transforms
     add (an Interval and a Simplex block; an Ordered and a CovCholesky
     block; a CorrCholesky; a gather with repeated indices, whose backward
     is a put with accumulate) and of the transformed hierarchical model at
     q = 2 (f64; in f32 it is the full-width fleet's objective) and q = 3
     (the caps held to three rounding witnesses, `traced_parity` with
     ``chaotic``); then the slice at full width: the repo's on-chip
     configuration of the model (scripts/tpu_experiments_r4i.py:69-75; 8
     groups, q = 2, p = 3, 512 observations, LKJ eta 2) as
     ``transform_objective(m, m.transform)``, n = 23, 4096 starts, tol
     1e-3, in f32 and f64 against its plain version (the caps and whole
     solves held to the rounding witnesses, as the model is chaotic in its
     first iterations: `traced_parity` with ``chaotic``; f64's plain whole
     solve timed alone, f32's stacked with its witnesses), then in f32 and
     f64 through `optimize_batched_resident` on the function itself (one
     launch each, no host synchronisation, its first call: it traces) and
     `optimize_batched` (B1): statuses CONVERGED or LINESEARCH_FAILURE
     (float32's floor), the converged count not below the JAX package's
     by more than chance (one-sided Fisher test at 1 %), in f64 the median
     within 10 % of its (scripts/jax_hierarchical_reference.py; in f32
     float32's floor decides it, so it is shown), the median lane's beta
     within 0.3 of the truth; trace and codegen ms, build,
     registers and spills, ms per solve of B3 on the trace, of the entry
     point's first and second call, the fleet engine and the plain
     version, the bound (what the function needs, `hierarchical_ops`),
     the share and the launch shape; the kernels line's record is the f64
     fleet's, whose time no floor decides.
 24. the minimization front door (least_squares.py, trust_region.py,
     constrained.py, minimize.py): (a) B1 under `optimize_auglag(engine=
     "bfgs")` against the plain update (``kernel="torch"``) on 64 lanes of
     the disk-constrained Rosenbrock (the bench fleet's first lanes, n =
     60, ineq 30 - x·x) in f64 (tol 1e-6) and f32 (tol 1e-3): at max_outer
     1 and 2 and inner caps 0, 1, 5 every counter equal (n_outer,
     iterations, n_fev, status, inner_status) and x, lam, mu, rho, viol
     within EXACT_RTOL or ROUNDING_FACTOR times the plain version's move
     on the CPU, B1 launched once per inner loop body; whole solves held
     to the rounding witnesses (the plain version 1 ulp up, down, on the
     CPU); (b) bench_full.py's configurations at full width, f32, data and
     starts from numpy seed 20260816: `least_squares` on 4096 exponential
     fits (config 8, n = 2, m = 40, tol 1e-3) and resumed from a state
     saved as numpy; `optimize_tr` on 1024 starts of a 256-d quadratic of
     condition 1e4 (config 9, tol 1e-3, max_cg 256), resumed from 5
     iterations to 10 (statuses and counts those of the one-leg run), and
     `minimize(method="tr")` on the negated function over the whole
     fleet for 5 iterations, equal to `optimize_tr`'s 5-iteration run
     after the sign flip;
     `optimize_auglag` on the bench fleet with ineq 30 - x·x (config 14,
     tol = ctol = 1e-3, at most 2000 inner iterations) through the CG
     engine (no kernel) and the BFGS engine (B1), and `minimize(ineq=...,
     method="bfgs")` over the first 64 lanes, equal to `optimize_auglag`'s
     after the sign flip: every lane converged where the JAX package
     converges every lane, else (TR, on float32's floor) the converged
     count not below its by more than chance (one-sided Fisher at 1 %),
     medians of iterations (and n_hev, n_outer) within 10 % of its
     (scripts/jax_engines_reference.py), max viol <= ctol on every
     converged auglag lane, every host synchronisation a counted one, no
     kernel launched on the LM, TR and auglag CG paths and B1 once per
     inner loop body on the auglag BFGS ones; solves/s of one call, host
     syncs and loop bodies (outer and inner) per solve, peak device
     memory, and the device's busy share of the TR fleet's first 5
     iterations (its resumed leg's first call) and of one auglag BFGS
     solve (torch.profiler; each fleet's timed call is its counted one:
     each takes seconds).
 25. the MAP back end (multistart.py, polish.py, laplace.py,
     utils/checkpoint.py, pytree.py, implicit.py, diagnostics.py), on the
     bench fleet (4096 x 60 f32) unless said otherwise, held to the JAX
     package's numbers on the same inputs
     (scripts/jax_map_backend_reference.py): (a) `optimize_multistart`
     (autodiff gradients, tol 1e-3, at most 3000 iterations) through B1,
     once per loop body: every lane converged, the median within 10 % of
     JAX's; then with a CUDA generator (seed 7) in place of the starts:
     the starts drawn on the card in float32, every lane converged; (b)
     `polish_newton(steps=3, dtype=torch.float64)` on that fleet: no
     lane's max|grad| grows, as many lanes improved as in JAX, the largest
     gradient left at most 10 times JAX's, the seconds it takes; (c)
     `laplace_evidence` exact (f64) on the polished modes, its median
     within 1e-8 of JAX's, and on the fleet's own B (f32), the gap to the
     exact shown beside JAX's; (d) the fleet through
     `optimize_batched_fused` to 20 iterations, `save_state`, `load_state`
     (every leaf bit for bit, on the card) and
     `optimize_batched_fused_from_state`: statuses and every counter equal
     to an uninterrupted run's on every lane; (e) `optimize_batched_pytree`
     on {'b': X[:, 30:], 'a': X[:, :30]} (raveled a, b as JAX orders a
     dict) with the Rosenbrock of cat(a, b): x, statuses, counters and B1
     launches equal to the flat solve's; (f) `optimize_implicit` of one
     f64 solve on BASELINE config 3's data (drawn as in phase 20) with a
     N(0, exp(log_s)²) prior, log_s = 0.7: d fun / d log_s within 1e-6 of
     a central finite difference (step 1e-4) and 1e-8 of JAX's, d sum(x*) /
     d log_s (the conjugate-gradient backward) within 1e-6 of JAX's; (g)
     AR(1) chains (phi 0.9, 1000 x 64 x 60, f64, numpy seed 20260816) on
     the card: every ``*_device`` statistic within 1e-8 of the port's
     numpy version per element and of JAX's summaries (sum, min, max,
     first element).
 26. the samplers the MAP fleet hands over to (sampling.py), on BASELINE
     config 3's logistic posterior (data and 4096 starts drawn as in
     phase 20), f32, held to the JAX package's numbers
     (scripts/jax_sampling_reference.py, which writes
     scripts/jax_sampling_reference.json; its samplers run 512 chains):
     (a) `optimize_batched(tol=3e-3)` through B1, once per loop body:
     every lane converged, the median within 10 % of JAX's 11; then
     `chain_init_from_map(jitter=0.05)`: the dense mass's Cholesky
     succeeds and its diagonal is within 1e-2 relative of JAX's; B1 at
     this fleet's shape (4096 x 100) against its plain version and timed;
     (b) `hmc_sample` on all 4096 chains with JAX's defaults but the draws
     (500 warmup, 16 leapfrog steps, the handed-over mass; 500 draws, not
     1000, for the time limit), no host read in
     its loop (sync debug mode): no NaN, max split R-hat < 1.01 (JAX's
     value + 0.01 where JAX's own run exceeds 1.01), mean
     accept within 0.05 of JAX's, median step size within 10 % of JAX's,
     per coordinate |mean - JAX's| <= 5 combined MCSEs (sd / sqrt(ESS),
     `ess_device`) and the sd within [0.9, 1.1] of JAX's; divergences and
     E-BFMI printed beside JAX's; (c) `chees_sample` (no mass: the fleet
     adapts its diagonal; 500 warmup rounds and 250 draws), the same
     gates, mean accept within 0.05 of its 0.75 target and one counted host
     read a round; step size and trajectory length printed beside JAX's;
     (d) a short plan (20 warmup steps, 10 draws) of each, long and with HMC's warmup and ChEES's two
     warmup halves through `save_state` / `load_state` on the card (every
     leaf bit for bit): the draws and every state leaf bit for bit; for (b)
     and (c) seconds a call, draws/s, gradient evaluations/s, host syncs,
     peak memory, and the device's busy share over 10 profiled transitions
     from (b)'s and (c)'s final states.
 27. NUTS and depth-sorted NUTS (sampling.py), the workflow's
     ``sampler="nuts"`` and ``depth_sort=True`` routes on the same
     posterior, f32, held to the JAX package's numbers
     (scripts/jax_nuts_reference.py, which writes
     scripts/jax_nuts_reference.json; 512 chains, the same warmup and
     more draws; the warmup and draws below were cut for the phase's
     120 s and the script's limit): (a)
     phase 26 (a)'s MAP fleet and gates (`logistic_map_fleet`), then
     `chain_init_from_map(jitter=0.05)`; B1 at that shape timed again;
     (b) `nuts_sample(n_samples=0, n_warmup=150, total_warmup=150)` on all
     4096 chains with no mass (the fleet adapts its diagonal, max_depth
     8), its state through `save_state` / `load_state` (every leaf bit for
     bit), then `nuts_sample_from_state(n_samples=50)`: phase 26's moment
     gates on ``accept_prob``, the mean accept within 0.05 of JAX's, the
     median step size within 10 % of JAX's, the fleet's mean tree depth
     within 0.5 of JAX's, every synchronisation flagged one of
     ``nuts_sample.host_syncs`` and no BFGS launch; divergences, E-BFMI,
     the chains' depth histogram and reads and gradients a draw printed
     beside JAX's; (c) `nuts_sample_depth_sorted(warm, 10)` with its
     defaults (its decision printed beside JAX's; unsorted, its draws
     equal (b)'s first 10 bit for bit, sorted, (b)'s gates), then the
     sorted path forced (4 groups, min_persistence -1, min_depth_spread
     0, 10 draws): sorted, the group sizes summing to 4096, the moment
     gates against JAX's forced run, final_x the merged state's x, which
     resumes for 5 draws; (d) `nuts_sample(n_warmup=20, n_samples=10)`
     against 10 + 10 warmup rounds and 10 draws through two checkpoints
     on all chains: samples, warm_dsum and every state leaf bit for bit;
     (e) for (b) seconds a call, draws/s, gradient evaluations/s, host
     syncs, peak memory, and the busy share and device events a leaf over
     3 profiled draws from the warm state.
 28. The workflow's other two initializers and PSIS (pathfinder.py,
     svgd.py, loo.py) on the same posterior, f32, held to the JAX
     package's numbers (scripts/jax_pathfinder_reference.py, which writes
     scripts/jax_pathfinder_reference.json): (a) the ``init="pathfinder"``
     route, `pathfinder(model, key, zeros(100), n_draws=4096,
     init_scale=1.0)` with its defaults (8 paths, a pool of 16384, history
     8, 64 iterations, 16 ELBO draws): no NaN in the draws, every path's
     ELBO finite and no NONFINITE_VALUE status (JAX has none), the median
     path ELBO and khat inside the band JAX's runs under 10 keys span,
     widened by half that band on each side, and the draws' per-coordinate
     mean and sd no further from JAX's key mean (the largest distance over
     the coordinates, in units of the sd) than 1.5 times the largest of
     JAX's own leave-one-key-out distances; every synchronisation flagged
     one of ``pathfinder.host_syncs`` and no BFGS launch; then the draws
     and ``pf.mass()`` handed to `chees_sample` (150 warmup rounds, 50
     draws): no NaN, mean accept within 0.05 of the 0.75 target; (b) the
     ``init="svgd"`` route, `svgd_sample` with its defaults (500 steps) on
     4096 particles (phase 20's numpy starts, x0 = 0 plus a standard
     normal): no host read at all, the final bandwidth, the particles'
     per-coordinate mean and sd and 8 particle rows each within twice the
     largest spread between JAX's run and JAX's runs from six witnesses of
     the starts moved by one ulp (at this size 500 steps amplify rounding
     to ~1e-2 in the bandwidth, so one witness is one draw of it), and
     250 steps + a checkpoint + 250 steps bit for bit equal to 500; (c)
     PSIS-LOO and WAIC on sampler draws: phase 26 (a)'s MAP fleet (B1),
     `chain_init_from_map(jitter=0.05)`, `hmc_sample` (100 warmup rounds,
     16 leapfrog steps, 16 draws a chain, the first for LOO: S = 4096,
     all 16 for phase 30), then `loo_psis` and
     `waic` on the (4096, 500) pointwise Bernoulli log-likelihood: elpd,
     se, p_loo, p_waic and every khat against the port's own float64 run
     of the same matrix on the CPU (LOO_F32_RTOL, LOO_KHAT_ATOL), and
     elpd_loo and elpd_waic no further from JAX's mean over 6 keys of the
     same plan than twice JAX's key-to-key spread; B1 at that shape timed
     again; (d) for (a) and (b) seconds a call, objective evaluations/s,
     host syncs, peak memory and the busy share over one profiled call.
 29. The other three samplers (mclmc.py, ensemble.py, tempering.py), the
     workflow's ``sampler="mclmc"`` / ``"ensemble"`` / ``"pt"`` routes on
     the same posterior, f32, held to the JAX package's numbers
     (scripts/jax_tempering_reference.py, which writes
     scripts/jax_tempering_reference.json; 512 chains for MCLMC and PT on
     the same plans, the ensemble and the mixture at full width under 10
     keys): (a) phase 26 (a)'s MAP fleet and gates (`logistic_map_fleet`,
     B1 once per loop body), `chain_init_from_map(jitter=0.05)`, whose
     dense B is the mass the workflow hands over; B1 at that shape timed
     again; (b) `mclmc_sample` on all 4096 chains with that mass (200
     warmup steps, 200 draws): no NaN, no host read in its loop (sync
     debug mode), 2 fleet-wide gradients a step plus the first call's 1,
     divergences 0 where JAX has 0, step size and L within 10 % of JAX's,
     energy_var within [0.5, 2] x its 5e-4 target, per coordinate |mean
     - JAX's| <= 5 combined MCSEs and the sd within [0.9, 1.1] of JAX's;
     (c) `ensemble_sample` on 4096 walkers from the jittered starts (300
     warmup steps, 200 draws) with ``partner="gather"``, then
     ``"shift"``: no NaN, no autograd pass (torch.autograd.grad and
     backward counted), 2 half-fleet value sweeps a step plus the start,
     no host read, the mean acceptance inside the band of JAX's 10 keys
     widened by half that band, and the draws' per-coordinate mean and sd
     no further from JAX's key mean than 1.5 times the largest of JAX's
     own leave-one-key-out distances; `ensemble_autocorr_time` over the
     first 512 walkers printed beside JAX's; (d) `pt_sample(model, key,
     x0s, mass=B)` with its defaults (8 temperatures from
     `geometric_ladder(8, 0.05)`, 16 leapfrog steps; 80 warmup rounds,
     80 draws) on all 4096 chains, 32768 replicas: no NaN, no host read,
     17 fleet-wide gradients a round, (b)'s moment gates on the cold row,
     per-temperature acceptance within 0.05 of JAX's, step sizes within
     10 %, every pair's swap rate within 0.05; (e) the bimodal mixture of
     tests/test_tempering.py:63-92 (modes at ±4 in n = 2, weights 0.75 /
     0.25, sigma 1) on 4096 chains started in the heavy mode, 6
     temperatures, beta_min 0.05, 8 leapfrog steps, 100 warmup rounds and
     150 draws (the test's 300 and 400 cut for the phase's 45 s): the cold row's mode weights within 0.05 of [0.75, 0.25]
     and the light mode's inside the band of JAX's 10 keys widened by
     half, every swap rate above 0.2, more round trips than chains; (f) a
     short plan of each sampler whole and through `save_state` /
     `load_state` on the card (MCLMC through its announced warmup plan,
     the ensemble through its warmup -> sampling transition, PT
     mid-warmup): the draws and every state leaf bit for bit; (g) for
     (b)-(d) seconds a call, draws/s, gradient or value evaluations/s,
     host syncs, peak memory, and the busy share over a few profiled
     steps from each warm state.
 30. Evidence by sampling (ais.py, bridge.py), the workflow's
     ``compute_evidence="ais"`` / ``"bridge"`` legs on the same posterior,
     f32, held to the JAX package's numbers
     (scripts/jax_evidence_reference.py, which writes
     scripts/jax_evidence_reference.json: the same data, fleet and plans
     under 6 keys): (a) phase 28 (c) hands over its B1 MAP fleet and its
     HMC run's 16 draws a chain (the first is LOO's draw), so this phase
     adds no fleet and no sampler run; (b) `ais_evidence` from the fleet
     result itself (the best converged lane's mode, the converged lanes'
     mean B) with 4096 particles, 64 rungs, 8 leapfrog steps, step 0.2,
     on the linear ladder and then with ``schedule="adaptive",
     resample=True`` (64 the cap): logZ, ess and the step finite, logZ no
     further from JAX's key mean than twice JAX's key-to-key spread (at
     least 0.01), the mean acceptance over the rungs run within 0.05 of
     JAX's and the step within 10 %, the adaptive run's rungs and resamples
     inside JAX's range widened by half of it (at least 1), one counted
     read for the fleet and, adaptive, one a rung, 9 fleet-wide gradients
     a rung and no BFGS launch; (c) `bridge_evidence` on the 65536 draws
     with the fleet's Gaussian as proposal (65536 proposal draws): logZ and
     re2 finite, logZ against JAX's keys as (b)'s, two logdensity sweeps,
     one read every 8 fixed-point bodies, and the bridge within JAX's gap
     between its bridge and AIS means plus twice both spreads of (b)'s
     linear-ladder logZ; `laplace_evidence` with the exact Hessian at the
     same mode printed beside them; (d) seconds a call, particle
     gradients/s, host syncs, peak memory, and the busy share over 4
     profiled rungs of each anneal and over the bridge.
 31. The one-call pipeline (workflow.py, utils/profiling.py) on the same
     posterior, f32: (a) `map_then_sample` at full width from the 4096
     starts (``map_engine="bfgs"``, map_tol 3e-3, ``sampler="hmc"`` with
     phase 28 (c)'s plan, 100 warmup steps and 16 draws of 16 leapfrog
     steps, ``compute_evidence="bridge"``) inside `utils.trace`, the
     pipeline's own reads and its engines' checked against sync debug
     mode: every MAP lane converged, the median iteration count within 10
     % of JAX's own `map_then_sample` on the CPU
     (scripts/jax_workflow_reference.py: its "auto" runs vmap off the TPU;
     the port's runs the fused engine, B1 once a loop body), every split
     R-hat finite (the largest printed beside JAX's), the bridge's logZ
     within phase 30's limit of phase 30's JAX estimates, the glue's
     counted reads (`map_then_sample.host_syncs`) equal to the one its
     code makes here (the fleet's statuses), HMC reading nothing; B1 at
     the fleet's shape against its plain version (record
     ``fused_bfgs_update_batched[workflow]``); the trace's top rows by
     `utils.summarize_trace` printed, never gated (torch.profiler once
     recorded no B1 launch late in the script); (b)
     `map_then_sample_pytree` on the same model over a dict of two blocks
     from an (n,) center (jittered starts drawn on the card), 20 warmup
     steps and 4 draws: the leaves (draws, chains, *leaf.shape), the
     tree's x_map the unravel of ``flat.x_map``, the numpy moments of
     fewer than 8 draws, two glue reads.
 32. The device mesh (parallel/mesh.py, parallel/distributed.py on
     torch.distributed), f32: (a) one rank over NCCL on cuda:0 (a
     FileStore group of world size 1), every collective run through NCCL:
     `optimize_batched_sharded` on the phase-4 fleet (B1 once a loop body;
     statuses, iterations and x equal to the unsharded engine's on the
     card), `optimize_lbfgs_sharded` and `optimize_cg_model_sharded` on one
     n = 1,048,576 solve of the geometric quadratic of JAX's
     test_optimize_cg_model_sharded_matches_unsharded, widened (tol 1e-3;
     held to the unsharded two-loop L-BFGS within 2 iterations and to the
     unsharded CG within 15 %), `map_then_sample(mesh=)` on config 3's
     posterior from the 4096 starts (MAP through B1, median within 10 % of
     JAX's 11, ``sampler="hmc"`` 10 + 10 steps) and `sample_sharded`
     ChEES from its handoff, 50 warmup rounds and 20 draws, equal to the
     unsharded `chees_sample` on the card (phase 26 gates the full-length
     run); B1 at 4096 x 60 against its plain version (record
     ``fused_bfgs_update_batched[mesh]``, CUDA events around calls queued
     behind a held stream, so that they time the kernels, not the
     dispatch); (b) two ranks on
     the one card over gloo (NCCL refuses two ranks on one GPU), processes
     of their own that load the library this one built: the same legs,
     gathered and held to (a): the fleet lane for lane, L-BFGS within 2
     iterations and CG within 15 % on the same optimum, the pipeline's MAP
     statuses equal and its median within 10 % of JAX's, ChEES from (a)'s
     starts with its step size (relative) and mean acceptance within
     1e-3 of (a)'s (the logistic's GEMM and the per-chain sums run at
     2048 rows on each rank, which the card sums in another order than
     at 4096; the distance a one-ulp change of the data makes is printed
     beside) and its acceptance within phase 26's 0.05 of the target; B1
     once a loop body on each rank, both ranks the same whole result.
 33. B3 on the trace's comparisons, elementwise functions, means and
     norms and per-lane linear algebra (objective_trace.py,
     objective_codegen.py, csrc/resident_linalg.cuh): comparisons and
     masks, sqrt, abs, softplus, sin, clamp, maximum and minimum, mean and
     2-norms, and per lane the Cholesky factorization, triangular solves,
     logdet / slogdet and solve; traced and generated beside phases 22's
     and 23's, built with them in the background. B3 against its plain
     version (the fleet engine with the plain update on the user's
     functions, under `in_band_linalg` where they factorize) as phase 22
     holds it, on 64-lane fleets of one objective per group (f64, most also
     f32), the two GP forms at m = 8 and two lanes of two warps (n = 70),
     one that factorizes an SPD matrix and one whose LU pivots on nearly
     every column of a non-symmetric m = 16 matrix; then the slice at full width, data and starts from
     numpy seed 20260816 (`ops_data`): pseudo-Huber regression through
     ``mean`` on config 3's widths (4096 x 100, 500 observations, f32, tol
     3e-3), a softplus-link Poisson GLM on the same widths, a bounded
     log-density on the bench fleet's 4096 x 60 f32 starts (``lt``,
     ``abs``, ``maximum``, ``clamp``, ``sin``, ``vector_norm``, tol 1e-3),
     and Gaussian-process hyperparameter MAP on 32 points, 4096 x 3 f64
     (tol 1e-6) in its Cholesky and its logdet + solve forms: each against
     its plain version (caps and whole solves; the plain whole solve timed
     alone), then through `optimize_batched_resident` (one launch, no host
     synchronisation), held to PERF.md's gate against the JAX package's
     counts (scripts/jax_traced_ops_reference.py: converged counts by a
     one-sided Fisher test at 1 % where JAX fails lanes in band, medians
     within 10 %); ms per solve of B3 (median of 2) and of the plain
     version, the bound (the traced graph's operations), the share, the
     scratch per lane and the launch shape.
 34. B3 on the log-densities of torch.distributions (objective_trace.py,
     objective_codegen.py; argument validation off, a data-dependent
     branch): lgamma and digamma, xlogy, erf / erfc / log_ndtr, expm1,
     reciprocal, rsqrt, atan2, pow with a tensor exponent, max / min,
     casts and BCE with logits, traced, generated and built with phases
     22, 23 and 33's (the parity objectives of each group of ops, f32 and
     f64, max and min over a lane of two warps, are
     tests/test_torch_kernels_cuda.py's cases); the slice at full
     width, data and starts from numpy seed 20260816 (`dists_data`): a
     negative binomial regression with an unknown dispersion
     (D.NegativeBinomial, 4096 x 101, config 3's 500 observations, f32 and
     f64, tol 3e-3), probit regression through
     torch.special.log_ndtr (4096 x 100, f32) and the distributions mix on
     the bench fleet's 4096 x 60 f32 starts (Gamma, Beta, Poisson,
     Dirichlet, Weibull, Uniform and Bernoulli-with-logits log-probabilities
     with expm1 / rsqrt / atan2 / amax terms, tol 1e-2): each against its
     plain version, through `optimize_batched_resident` (one launch, no
     host synchronisation) and held to PERF.md's gate against the JAX
     package's counts (scripts/jax_traced_dists_reference.py; the median
     held where JAX converged at least half its lanes, else float32's
     floor decides it and it is shown), with phase 33's times, bounds
     (`dists_needs`) and launch shapes.
 35. B3 on softmax and log-softmax, gathers and scatter_adds at constant
     indices, the factories that read only a shape (full_like, new_ones,
     new_full, full), prod / cumprod, erfinv and per-lane values of rank 3
     (bmm and the per-lane linear algebra over a leading batch dim),
     traced, generated and built with phases 22-34's: how far torch's
     erfinv on the card and on the CPU part (`erfinv_spread`); the parity
     objectives of three groups of ops (`softmax_case`: softmax and
     gathers, products and erfinv, f32 and f64; rank 3 over a lane of two
     warps, f64) against the plain version; then the slice at full width,
     data and starts from numpy seed 20260816 (`softmax_data`): softmax
     regression (D.Categorical(logits = X W), 4096 x 100, config 3's 500
     observations, f32, tol 3e-3), a multivariate normal with unknown mean
     and Cholesky factor (D.MultivariateNormal, d = 6, 200 observations,
     4096 x 27, f64, tol MVN_TOL) and a K = 4 mixture of normals on 500
     points with its stick-breaking twin (D.MixtureSameFamily, D.Gumbel
     and D.InverseGamma priors, 4096 x 25, f64, tol MIX_TOL), each as
     phase 34's against its plain
     version, through `optimize_batched_resident` and against the JAX
     package's counts (scripts/jax_traced_softmax_reference.py), with
     its time, bound (`softmax_needs`) and launch shape.
Then a [timing] line (seconds per phase, the card's name and power limit),
one JSON line of kernel records and, last, the JSON result line. Each
record's ``bound_ms`` is the least time the card could take for the
kernel's work on this run's inputs: the larger of the bytes it must move
(each input read once, each output written once) over 3.35 TB/s and the
floating-point operations its inputs need, however a kernel rounds (see
``update_ops``), over 67 TFLOP/s (H100 SXM, f32 outside the tensor
cores; 34 TFLOP/s for the float64 fleets); ``ms`` is B1's device time per
launch, B2's per call by CUDA
events, B3's per solve by CUDA events; ``library_ms`` is one PyTorch call
that computes the same function (B2a: ``torch.bmm``), null where none
does.

B3's records, one per instantiation the run launches
(``resident_bfgs_solve[quadratic]``, ``[logistic]``, ``[funnel]``,
``[mixture]``, ``[poisson]`` and ``[ar1]`` beside the Rosenbrock's), count
the launches of phases 20's and 21's full-width runs; the Poisson record's
times are its float32 fleet's (its float64 fleet's are on the log line).
B1 has a second record, ``fused_bfgs_update_batched[auglag]``: its launches
are phase 24's full-width auglag BFGS fleet's, its max_abs_err phase 24
(a)'s largest difference of x at the caps, its times and bound phase 6's
(the same 4096 x 60 f32 shape); and a third,
``fused_bfgs_update_batched[multistart]``: its launches are phase 25 (a)'s
multistart fleet's, its max_abs_err phase 3's at 4096 x 60 f32 and its
times and bound phase 6's (the fleet's shape and dtype); and a fourth,
``fused_bfgs_update_batched[sampling]``: its launches are phase 26 (a)'s
logistic MAP fleet's, its max_abs_err, times and bound B1's at that
fleet's shape (4096 x 100 f32, every lane active) in phase 26, its ``ms``
by CUDA events over back-to-back launches; and a fifth,
``fused_bfgs_update_batched[nuts]``: its launches are phase 27 (a)'s
fleet's, its max_abs_err, times and bound B1's at that shape measured
again in phase 27; and a sixth, ``fused_bfgs_update_batched[loo]``: phase
28 (c)'s fleet's launches, and B1 at that shape measured again in phase
28; and a seventh, ``fused_bfgs_update_batched[pt]``: phase 29 (a)'s
fleet's launches, and B1 at that shape measured again in phase 29; and an
eighth, ``fused_bfgs_update_batched[workflow]``: phase 31 (a)'s MAP
fleet's launches inside `map_then_sample`, and B1 at that shape measured
again in phase 31. B3 with a traced objective has one record per full-width fleet of phases
22 and 23 (``resident_bfgs_solve[traced:rosenbrock]``, ``[traced:logistic]``,
``[traced:dense_quadratic]``, ``[traced:mixture]``,
``[traced:hierarchical]``), its source the generator that writes the
objective into csrc/resident_solve.cuh's kernel; and one per full-width
fleet of phase 33 (``resident_bfgs_solve[ops:robust]``,
``[ops:softplus_poisson]``, ``[ops:bounded]``, ``[ops:gp_cholesky]``,
``[ops:gp_logdet]``), the GP records' source csrc/resident_linalg.cuh,
whose factorizations and solves their generated objectives call; and one
per full-width fleet of phase 34 (``resident_bfgs_solve[dists:negbin]``,
``[dists:negbin_f64]``, ``[dists:probit]``, ``[dists:mix]``); and one per
full-width fleet of phase 35 (``resident_bfgs_solve[softmax:regression]``,
``[softmax:mvn]``), the multivariate normal's source
csrc/resident_linalg.cuh, whose triangular solve its objective calls.

Run from anywhere: ``python3 chip_smoke.py``. Needs one CUDA card and nvcc;
exits non-zero without a card, and without the package beside it.
"""

import functools
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch

BENCH_SEED = 20260816
BATCH, N = 4096, 60
TOL, MAX_ITERS = 1e-3, 3000
# Timed turns of each engine in phases 12-14, whose solves take 0.5-10 s
# (1, after the counted run that warmed each engine, which leaves room for
# phases 16-25 in the time limit on the slowest hosts).
TURNS = 1
CG_PROFILED_ITERS = 100  # phase 12's profiled CG call stops here (its median is 218)
# The JAX package on this protocol (same seed and sizes, kernel="xla" on the
# CPU): 4096/4096 converged, median 139 and max 225 iterations.
JAX_MEDIAN_ITERS, JAX_MAX_ITERS = 139, 225
# Normwise relative tolerance of kernel vs plain version (max |diff| /
# max |plain| per output): the kernel sums each dot product and matvec in
# another order than cuBLAS and torch's reductions, nothing else differs;
# that costs a few ulps times n.
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
KERNEL_SOURCE = "quasinewtonmethods_jl_tpu_torch/csrc/bfgs_update.cu"
KERNEL_REPLACES = "quasinewtonmethods_jl_tpu/ops/pallas/bfgs_kernel.py:234"
BLOCKED_SOURCE = "quasinewtonmethods_jl_tpu_torch/csrc/bfgs_blocked.cu"
MATVEC_REPLACES = "quasinewtonmethods_jl_tpu/ops/pallas/bfgs_blocked.py:236"
UPDATE_REPLACES = "quasinewtonmethods_jl_tpu/ops/pallas/bfgs_blocked.py:288"
RESIDENT_SOURCE = "quasinewtonmethods_jl_tpu_torch/csrc/resident_solve.cu"
RESIDENT_REPLACES = "quasinewtonmethods_jl_tpu/resident_solve.py:465"
# B3 with a traced objective: the kernel of csrc/resident_solve.cuh around
# the objective this generator writes
TRACED_SOURCE = "quasinewtonmethods_jl_tpu_torch/ops/kernels/objective_codegen.py"
# the per-lane factorizations and solves the generated objective calls (phase 33)
LINALG_SOURCE = "quasinewtonmethods_jl_tpu_torch/csrc/resident_linalg.cuh"
# The JAX package on the phase-4 fleet (kernel="xla" on the CPU):
# `optimize_cg` with its defaults 4096/4096 converged, median 218 and max 457
# iterations (fold_eval: median 218, max 587); `optimize_batched_fused` with
# ls=Wolfe() median 137, max 245 (fold_eval: 137 / 235).
JAX_CG_MEDIAN_ITERS, JAX_CG_MAX_ITERS = 218, 457
JAX_WOLFE_MEDIAN_ITERS, JAX_WOLFE_MAX_ITERS = 137, 245
# The large-n fleet. The JAX package on it (same seed and sizes,
# kernel="xla" on the CPU): 1024/1024 converged, median 172 and max 246.
LARGE_BATCH, LARGE_N = 1024, 512
JAX_LARGE_MEDIAN_ITERS, JAX_LARGE_MAX_ITERS = 172, 246
# The scalar and L-BFGS phases (16-19). The JAX package's counts on the same
# inputs come from `python scripts/jax_lbfgs_reference.py` (JAX on the CPU,
# float32, seed 20260816, tol 1e-3, analytic value-and-grad):
# `optimize` on standard_normal(60): BFGS 132 iterations, 271 evaluations.
JAX_BFGS_ITERS = 132
# f32 DFP (h0_scale=False) and SR1 from `scalar_starts(SCALAR_F32_STARTS)`:
# the JAX package's count of starts converged within 3000 iterations, from
# `python scripts/scalar_f32_rounding.py` ("perturbed" rows, JAX on the CPU):
# DFP 14 (of the other two, one converges after 5055 iterations, one fails
# its line search after 9620), SR1 15 (one line-search failure).
SCALAR_F32_STARTS = 16
JAX_F32_CONVERGED = {"dfp": 14, "sr1": 15}
# `optimize_lbfgs(history=10)` on the n = 4096 diagonal quadratic of
# bench_full.py:106-119 (x* from a fresh generator, x0 = 0, at most 500
# iterations): 22 iterations and 47 evaluations with either direction.
LBFGS_N, JAX_LBFGS_ITERS = 4096, 22
# `optimize_lbfgs_batched` (history 10, at most 3000 iterations) on
# standard_normal((batch, n)): 1024 x 512 converged 1024/1024, median 156,
# max 259, median n_fev 328; 256 x 4096 converged 256/256, median 200, max
# 334, median n_fev 417.
LBFGS_FLEETS = {(1024, 512): (156, 259), (256, 4096): (200, 334)}
LBFGS_HISTORY = 10
# (64 x 16384 is not timed: the time limit holds phase 24 too)
RING_SHAPES = ((BATCH, N), (1024, 512), (256, 4096))
RING_TURNS = 1  # whole solves per ring and shape
VMAP_LANES = 16
SPLIT_NS = (128, 192, 232)  # B1 fits up to n = 237 in f32
B1_NS = (2, 7, 33, 60, 61, 65, 128)  # one warp per lane up to 64; ragged bulk copies at 7, 33, 61, 65
B1_LARGEST_N = {torch.float32: 237, torch.float64: 167}
RESIDENT_NS = (2, 5, 6, 17, 24, 60, 65)  # one warp per lane up to n = 64, two at 65
# Phase 20: B3 on the data-bearing objectives. BASELINE config 3's
# posterior: n = 100 weights, 500 observations, prior scale 10
# (bench_full.py:87-96). Its float32 tolerance is bench_full.py's 3e-3:
# with |f| ~ 233 the line search cannot certify increases below
# eps(f32)·|f| ~ 3e-5, so tighter gradient tolerances stall in-band at
# this scale.
LOGISTIC_N, LOGISTIC_OBS, LOGISTIC_PRIOR, LOGISTIC_TOL = 100, 500, 10.0, 3e-3
# The JAX package on the same data (`python scripts/jax_logistic_reference.py`,
# JAX on the CPU, float32, tol 3e-3): `optimize_batched_fused` from the
# 4096 starts converged 4096/4096, median 11 and max 13 iterations;
# `optimize` from zeros(100) converged in 11 iterations.
JAX_LOGISTIC_MEDIAN, JAX_LOGISTIC_MAX, JAX_LOGISTIC_SCALAR_ITERS = 11, 13, 11
# The quadratic's parity widths: where the lane group's layout changes, and
# the largest n one lane of B3 holds (236 f32, 165 f64). Its full-width
# fleet takes config 2's spectrum (condition 1e4) at the largest n B3 holds
# in f32 (config 2's n = 256 does not fit a block's shared memory).
OBJECTIVE_NS = {torch.float32: (7, 60, 100, 236), torch.float64: (7, 60, 100, 165)}
QUAD_BATCH, QUAD_N, QUAD_CONDITION = 1024, 236, 1e4
OBJECTIVE_LANES = 64  # lanes of the parity fleets
# Phase 21: B3 on the fixture families. Each full-width fleet's data and
# its 4096 starts come from a fresh numpy generator seeded BENCH_SEED
# (`fixture_data`): Neal's funnel at n = 4 (tests/test_edge_cases.py:91-110's
# shape; float64, since at v* = -4.5(n-1) e^{-v} overflows float32 once
# n > 20), the Gaussian mixture of 8 components at n = 60 (means 3·N(0, 1),
# sigma 4, starts 3·N(0, 1)), the Poisson GLM of tests/test_baseline_configs.py:69-90
# (n = 50, 400 observations, prior scale 10) in float32 and float64, and
# the AR(1) with drift at the JAX class's defaults (n = 8, 32 steps,
# spectral radius 0.6). float32 runs at the tolerance its Armijo value
# test can certify (mixture 1e-3, Poisson 1e-2); float64 at 1e-6.
# The JAX package on the same data (`python scripts/jax_fixture_reference.py`,
# its fleet engine on the CPU, at most 3000 iterations): (converged, median,
# max) funnel (4010, 34, 99; 86 LINESEARCH_FAILURE), mixture (4096, 5, 62),
# Poisson f32 (4096, 12, 28), Poisson f64 (4096, 26, 60), AR(1) (4074, 29,
# 36; 22 LINESEARCH_FAILURE).
FIXTURE_FLEETS = {  # name: (fixture, dtype, tol, JAX converged, median, max)
    "funnel": ("funnel", torch.float64, 1e-6, 4010, 34, 99),
    "mixture": ("mixture", torch.float32, 1e-3, 4096, 5, 62),
    "poisson f32": ("poisson", torch.float32, 1e-2, 4096, 12, 28),
    "poisson f64": ("poisson", torch.float64, 1e-6, 4096, 26, 60),
    "ar1": ("ar1", torch.float64, 1e-6, 4074, 29, 36),
}
FUNNEL_N = 4
MIXTURE_K, MIXTURE_N, MIXTURE_SIGMA = 8, 60, 4.0
POISSON_N, POISSON_OBS, POISSON_PRIOR = 50, 400, 10.0
AR1_N, AR1_STEPS, AR1_RADIUS, AR1_OBS_SCALE, AR1_PRIOR = 8, 32, 0.6, 0.5, 10.0
# The parity fleets (OBJECTIVE_LANES lanes each): the full-width n, n where
# the lane group's layout changes (two warps from 65) and, for the funnel,
# n = 10, where the float64 fleet already fails many lanes; whole solves at
# the first two n, caps only at the last.
FIXTURE_PARITY = {  # fixture: (n, dtypes)
    "funnel": ((4, 10, 70), (torch.float64,)),
    "mixture": ((60, 7, 100), (torch.float32, torch.float64)),
    "poisson": ((50, 7, 100), (torch.float32, torch.float64)),
    "ar1": ((8, 5, 70), (torch.float64,)),
}
FIXTURE_TOL = {"funnel": {torch.float64: 1e-6},
               "mixture": {torch.float32: 1e-3, torch.float64: 1e-6},
               "poisson": {torch.float32: 1e-2, torch.float64: 1e-6},
               "ar1": {torch.float64: 1e-6}}
# Phase 22: B3 on traced objectives (ops/kernels/objective_trace.py,
# objective_codegen.py). The full-width fleets, each drawn with numpy from a
# fresh generator seeded BENCH_SEED, float32, at most 3000 iterations: the
# bench fleet as ``lambda x: rosenbrock_logdensity(x)`` (tol 1e-3),
# BASELINE config 3's logistic posterior as its model's bound
# ``logdensity`` (tol 3e-3), ROADMAP B.1's dense quadratic -0.5·x@(Q@x) +
# b@x with Q = U diag(logspace(-4, 0, n)) Uᵀ (config 2's spectrum, U from a
# numpy QR), b = Q x*, over 1024 starts at n = 232, the largest n
# `resident_feasible` admits for this traced form in float32 (tol 1e-3),
# and the Gaussian mixture of phase 21 as its bound ``logdensity`` (tol
# 1e-3). The JAX package on the same data (`python
# scripts/jax_traced_reference.py`, its fleet engine on the CPU): (converged,
# median, max) Rosenbrock (4096, 139, 227), logistic (4096, 11, 13), dense
# quadratic (1024, 104, 127), mixture (4096, 5, 62).
TRACED_FLEETS = {  # fleet: (dtype, tol, JAX converged, median, max)
    "rosenbrock": (torch.float32, TOL, 4096, 139, 227),
    "logistic": (torch.float32, LOGISTIC_TOL, 4096, 11, 13),
    "dense quadratic": (torch.float32, TOL, 1024, 104, 127),
    "mixture": (torch.float32, 1e-3, 4096, 5, 62),
}
DENSE_QUAD_BATCH, DENSE_QUAD_N = 1024, 232
# The parity objectives (OBJECTIVE_LANES lanes, N(0, 1) starts from seed
# BENCH_SEED + n, tol 1e-3 in float32 and 1e-6 in float64): the torch twins
# of the JAX package's inline objectives (tests/test_resident.py:147-260)
# and the port's models in the forms the hand-written instantiations do not
# take. (kind, n, dtypes)
TRACED_PARITY = (
    ("quadratic with b", 60, (torch.float64, torch.float32)),
    ("quadratic with b", 100, (torch.float64,)),
    ("logsumexp", 60, (torch.float64, torch.float32)),
    ("nan where", 60, (torch.float64, torch.float32)),
    ("logistic with logaddexp", 60, (torch.float64, torch.float32)),
    ("rosenbrock in a lambda", 60, (torch.float64, torch.float32)),
    ("rosenbrock with its value_and_grad_fn", 61, (torch.float64,)),
    ("mixture's bound logdensity", 60, (torch.float64, torch.float32)),
    ("logistic's bound logdensity", 100, (torch.float64, torch.float32)),
    ("ar1's bound logdensity", 8, (torch.float64,)),
    ("funnel in a lambda", 4, (torch.float64,)),
    ("funnel with value_and_grad_fn", 4, (torch.float64,)),
    ("dense quadratic", 232, (torch.float32,)),
)
# Phase 23: B3 on the hierarchical model (transforms.py, models/hierarchical.py
# and the trace's index maps, cumsum and the transforms' elementwise ops).
# The full-width fleet is the repo's own on-chip configuration of the model
# (scripts/tpu_experiments_r4i.py:69-75): 8 groups, q = 2, p = 3, 512
# observations, LKJ eta 2, solved as transform_objective(m, m.transform), n =
# 23; data drawn with numpy from seed BENCH_SEED by the model's recipe
# (`hierarchical_data`), then 4096 starts unconstrain(initial_point()) +
# 0.5·N(0, 1) from the same generator; tol 1e-3 (that script's tolerance),
# at most 3000 iterations, in float32 (that script's dtype, and the main
# path's) and in float64. The JAX package on the same data and starts
# (`python scripts/jax_hierarchical_reference.py`, its fleet engine on the
# CPU): (converged, median, max) float32 (92, 108, 614), the other 4004
# lanes LINESEARCH_FAILURE on float32's floor, where the value's rounding
# exceeds the increase a step near the mode can show (there rounding decides
# when a lane stops: the port's plain version on the CPU ends at median 172);
# float64 (4096, 106, 504). Each fleet is held to its plain version at the
# caps and over whole solves by rounding witnesses (`traced_parity`,
# chaotic), to JAX's converged count (a one-sided Fisher test) and to the
# model's own check (beta near the truth); the float64 fleet's median, where
# every lane converges, within 10 % of JAX's (float32's median is shown, not
# held: rounding decides it). The kernels line's record is the float64
# fleet's, whose time no floor decides.
HIER_GROUPS, HIER_Q, HIER_P, HIER_OBS, HIER_ETA = 8, 2, 3, 512, 2.0
HIER_BATCH = 4096
JAX_HIER = {torch.float32: (92, 108, 614), torch.float64: (4096, 106, 504)}
# The parity objectives (OBJECTIVE_LANES lanes, seed BENCH_SEED + n as in
# phase 22): one per group of ops the transforms add to the table, each a
# transformed density of known mode, and the transformed hierarchical model
# at q = 2 (n = 23) and q = 3 (n = 34) on the full-width fleet's sizes (q =
# 2 in float32 is the full-width fleet's own objective, held to its plain
# version over all 4096 lanes).
HIER_PARITY = (
    ("interval and simplex", 60, (torch.float64, torch.float32)),
    ("ordered and cov cholesky", 31, (torch.float64, torch.float32)),
    ("corr cholesky", 28, (torch.float64, torch.float32)),
    ("gather with repeats", 60, (torch.float64, torch.float32)),
    ("hierarchical q=2", 23, (torch.float64,)),
    ("hierarchical q=3", 34, (torch.float64, torch.float32)),
)
# Phase 24 (the minimization front door): bench_full.py's configurations 8
# (LM, 4096 exponential fits of 40 points), 9 (TR, 1024 starts on a 256-d
# quadratic of condition 1e4) and 14 (auglag, the bench fleet on the disk
# x·x <= 30), f32, data from numpy seed BENCH_SEED. The JAX package's counts
# on the same inputs (`JAX_PLATFORMS=cpu python scripts/jax_engines_reference.py`,
# its fleet engines on the CPU in float32, ~30 s): lanes, converged, and
# the medians the gates hold (TR: 909 of its lanes end LINESEARCH_FAILURE
# on float32's floor, Δ-collapse on the stiff quadratic).
LM_BATCH, LM_M = 4096, 40
TR_BATCH, TR_N = 1024, 256
TR_RESUME_CAP = 10  # the TR fleet's resume runs to this lifetime cap
AUG_BATCH, AUG_TOL, AUG_MAX_ITERS = BATCH, 1e-3, 2000
AUG_PARITY_LANES = 64  # phase 24 (a): B1 under auglag against the plain update
AUG_MIN_LANES = 64  # the constrained minimize
JAX_ENGINES = {
    "lm": {"lanes": 4096, "converged": 4096, "iterations": 4.0},
    "tr": {"lanes": 1024, "converged": 115, "iterations": 26.0, "n_hev": 1865.0},
    "auglag_cg": {"lanes": 4096, "converged": 4096, "iterations": 189.0, "n_outer": 2.0},
    "auglag_bfgs": {"lanes": 4096, "converged": 4096, "iterations": 116.0, "n_outer": 2.0},
    "minimize_bfgs": {"lanes": 64, "converged": 64, "iterations": 114.0, "n_outer": 2.0},
}
# Phase 25, the MAP back end: the JAX package's numbers on the same inputs
# (scripts/jax_map_backend_reference.py, on the CPU; float32 fleet with x64
# off, the rest in float64). Summaries are [sum, min, max, first element].
JAX_MAP = {
    "multistart_converged": 4096, "multistart_median": 139.0,
    "polish_improved": 4096, "polish_after_median": 0.0, "polish_after_max": 0.0,
    "laplace_exact_median": -34.73565621434002, "laplace_gap_median": 93.90742545069904,
    "laplace_gap_max": 109.73484854640216,
    "implicit_fun": -341.1907670826241, "implicit_dfun": -65.87036253629162,
    "implicit_dsum_x": 4.985616859944153,
}
JAX_DIAGNOSTICS = {
    "split_rhat": [61.06667792909804, 1.0136828763388606, 1.023592964499655,
                   1.0207538521487727],
    "ess": [202957.49052815564, 2262.3226161682073, 3749.421987623164, 3144.8283761515863],
    "rank_normalized_rhat": [61.06597039200578, 1.0136627911734089, 1.0235164119368452,
                             1.0207065173871814],
    "tail_ess": [442641.0630127286, 6254.409952392986, 8420.342164098445, 7215.577471041661],
    "mean": [-0.5045120819232782, -0.11047750224939636, 0.07682352243864324,
             -0.004794993802162193],
    "std": [137.5481556054245, 2.247324370664974, 2.3461672991019484, 2.2933727873994645],
    "energy_bfmi": [25.23270024373886, 0.32129062810744846, 0.4897109314390273,
                    0.4342257510326339],
}
MAP_RTOL = 1e-8  # exact evidence, implicit gradient against JAX, diagnostics
MAP_FD_RTOL, MAP_FD_STEP, MAP_LOG_S = 1e-6, 1e-4, 0.7
CHECKPOINT_CAP = 20  # the checkpointed leg's iterations
DIAG_DRAWS, DIAG_CHAINS, DIAG_PHI = 1000, 64, 0.9
# Published peaks of one H100 SXM: device memory and float32 outside the
# tensor cores (the kernels' type on the main path); float64 outside the
# tensor cores for the float64 fleets (NVIDIA's data sheet).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
# the H100 SXM's top SM clock (1980 MHz), sizing `torch.cuda._sleep`: at a
# lower clock the sleep lasts longer, which only holds the stream longer
GPU_SLEEP_CYCLES_PER_S = 1.98e9


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def device_phase():
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    smi = ""
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        log(smi)
    return name, smi


# A build in the background: a process of its own that runs
# `_build.load_library` (no sources given) or `_build.load_generated`
# (the generated sources), niced and kept off one core, so that the phases
# that launch no hand-written kernel run beside it; it writes nvcc's
# reports and its seconds to a JSON file, and the library files to
# `_build.BUILD_DIR`, where the loads in this process find them.
BUILD_SCRIPT = r"""
import importlib.util, json, sys, time
spec = importlib.util.spec_from_file_location("_qnm_build", sys.argv[1])
build = importlib.util.module_from_spec(spec)
spec.loader.exec_module(build)
with open(sys.argv[2]) as f:
    sources = json.load(f)
t0 = time.perf_counter()
if sources is None:
    lib = build.load_library()
    out = {"logs": {str(lib.path): lib.log}, "nvcc": lib.build_seconds}
else:
    libs = build.load_generated(*sources)
    out = {"logs": {str(lib.path): lib.log for lib in libs},
           "nvcc": max((lib.build_seconds for lib in libs), default=0.0)}
out["wall"] = time.perf_counter() - t0
with open(sys.argv[3], "w") as f:
    json.dump(out, f)
"""


def _background_priority():
    os.nice(19)
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > 2:  # one core for this process's own phases
        os.sched_setaffinity(0, cores[1:])


def start_build(sources=None):
    """Start building the kernel library (``sources`` None) or the
    generated CUDA ``sources`` in the background (see BUILD_SCRIPT);
    returns the handle `build_phase` waits on."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    request, result = os.path.join(tmp, "sources.json"), os.path.join(tmp, "result.json")
    with open(request, "w") as f:
        json.dump(sources, f)
    with open(os.path.join(tmp, "output.txt"), "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", BUILD_SCRIPT, _build.__file__, request, result],
            stdout=out, stderr=subprocess.STDOUT, start_new_session=True,
            preexec_fn=_background_priority)
    return {"proc": proc, "tmp": tmp, "result": result, "t0": time.perf_counter()}


def stop_build(handle):
    """End a background build and every compiler it started, if it still runs."""
    if handle["proc"].poll() is None:
        try:
            os.killpg(handle["proc"].pid, 9)
        except ProcessLookupError:
            pass
        handle["proc"].wait()


def finish_build(handle):
    """Wait for a background build: (nvcc's reports by library path, nvcc
    seconds, the build's wall seconds from its start to its end here).
    Raises with the build's output when it failed."""
    rc = handle["proc"].wait()
    try:
        with open(os.path.join(handle["tmp"], "output.txt")) as f:
            output = f.read()
        check(rc == 0, f"the kernel build failed with exit code {rc}:\n{output[-20000:]}")
        with open(handle["result"]) as f:
            out = json.load(f)
    finally:
        shutil.rmtree(handle["tmp"], ignore_errors=True)
    return out["logs"], out["nvcc"], time.perf_counter() - handle["t0"]


def build_phase(sources, started=None):
    """The kernel library, and beside it, in parallel, the generated CUDA
    ``sources`` (phases 22's and 23's, so that their nvcc runs overlap the
    library's), each in a background process (`start_build`; ``started``:
    the two handles where they were started earlier, so that other phases
    ran beside them): returns the generated libraries and the seconds
    their build took."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels._build import (
        NVCC_FLAGS,
        SOURCES,
        load_generated,
        load_library,
    )

    main, generated = started or (start_build(), start_build(sources))
    try:
        main_logs, main_nvcc, main_wall = finish_build(main)
    except BaseException:
        stop_build(generated)
        raise
    gen_logs, _, generated_seconds = finish_build(generated)
    t0 = time.perf_counter()
    lib = load_library()
    seconds = time.perf_counter() - t0
    libs = [g._replace(log=gen_logs.get(str(g.path), g.log)) for g in load_generated(*sources)]
    print(main_logs.get(str(lib.path), lib.log), file=sys.stderr, flush=True)
    check("arch=compute_90a,code=sm_90a" in NVCC_FLAGS, "kernel not built for sm_90a")
    log(f"[build] {lib.path.name} from csrc/{{{', '.join(SOURCES)}}}: nvcc {main_nvcc:.2f}s "
        f"in the background ({main_wall:.2f}s from its start), load {seconds:.2f}s, flags "
        f"{' '.join(NVCC_FLAGS)}; beside it phases 22 and 23's {len({g.path for g in libs})} "
        f"generated objectives in {generated_seconds:.2f}s from their start")
    return libs, generated_seconds


# Processes of their own on the card beside the build (`start_helper`):
# phase 16's float32 starts, and phase 9's plain runs made ahead (saved to a
# file this process loads); neither launches a hand-written kernel or times
# anything, and this process makes the other plain runs ahead meanwhile
# (`prefetch_plain`). Two host-bound processes on one H100 each kept ~90 %
# of their pace alone (a thread in this process instead halved both: the
# interpreter's lock; scripts/torch_host_concurrency.py).
HELPER_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke
import quasinewtonmethods_jl_tpu_torch as qt
getattr(chip_smoke, sys.argv[2])(qt, torch.device("cuda", 0), *sys.argv[3:])
"""


def _off_core_zero():
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > 2:  # the core this process's own phases keep
        os.sched_setaffinity(0, cores[1:])


def start_helper(name, *args):
    """Start this script's function ``name``(qt, the card, *args) in a
    process of its own (see above); returns the handle `finish_helper`
    waits on."""
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", HELPER_SCRIPT, os.path.dirname(os.path.abspath(__file__)), name,
         *args], stdout=out, stderr=subprocess.STDOUT, start_new_session=True,
        preexec_fn=_off_core_zero)
    return {"proc": proc, "out": out, "name": name}


def finish_helper(handle):
    """Wait for a helper process and show its summary lines; raises with
    its output when a check there failed."""
    rc = handle["proc"].wait()
    handle["out"].seek(0)
    output = handle["out"].read()
    handle["out"].close()
    check(rc == 0, f"{handle['name']} failed with exit code {rc}:\n{output[-20000:]}")
    for line in output.splitlines():
        if line.startswith("["):
            log(line)


def resident_plain_ahead(qt, device, path):
    """Phase 9's plain runs made ahead (`resident_plain`, ``ahead``), saved
    to ``path`` for `load_ahead`."""
    t0 = time.perf_counter()
    for entry in resident_parity_plan(qt, device):
        resident_plain(qt, *entry[:-1], ahead=True)
    torch.save(AHEAD, path)
    log(f"[ahead] phase 9's {len(AHEAD)} plain runs made ahead in a process of their own in "
        f"{time.perf_counter() - t0:.1f} s")


def load_ahead(path):
    """The plain runs `resident_plain_ahead` saved, kept as if made here."""
    AHEAD.update(torch.load(path, weights_only=False))


def prefetch_plain(qt, device, phase22, phase23, groups, handles):
    """B3's plain versions that phases 21-23 and 33-35 compare against, made
    on the card ahead of them (`plain_reference`, ``ahead``), until the
    background processes of ``handles`` have all ended: the hierarchical
    fleet's float32 runs, phase 23's and 22's parity objectives, phase 22's
    full-width fleets, phase 21's parity and full-width fleets (phase
    9's: `resident_plain_ahead`), then for each of ``groups`` (phases 33, 34
    and 35, `traced_group`) its parity objectives and its fleets' caps. Returns a
    summary."""
    def done():
        return all(h["proc"].poll() is not None for h in handles)

    _, X, trace = phase23["fleets"][torch.float32]
    work = [lambda: parity_ahead(qt, trace, X, TOL, chaotic=True)]
    for cases in (phase23["cases"], phase22["cases"]):
        work += [lambda c=c: parity_ahead(qt, c[1], c[2], c[3],
                                          chaotic=c[4][0].startswith("hierarchical"))
                 for c in cases]
    fleets, traced = phase22["fleets"], phase22["traced"]
    work += [lambda name=name: parity_ahead(qt, traced[name], *fleets[name][1:3])
             for name in fleets]
    work += [lambda c=c: parity_ahead(qt, *fixture_parity_fleet(*c[:3], device), c[3],
                                      whole=c[4]) for c in fixture_parity_cases()]
    work += [lambda f=f: parity_ahead(qt, *f) for f in fixture_fleets(device).values()]
    for group in groups:
        work += [lambda c=c: parity_ahead(qt, c[1], c[2], c[3]) for c in group["cases"]]
        work += [lambda g=group, name=name: parity_ahead(qt, g["traced"][name],
                                                         *g["fleets"][name][1:3], whole=False)
                 for name in group["fleets"]]
    made = 0
    for fn in work:
        if done():
            break
        fn()
        made += 1
    torch.cuda.synchronize()
    return f"{made} of {len(work)} groups of plain runs made ahead ({len(AHEAD)} runs kept)"


def parity_ahead(qt, objective, X, tol, chaotic=False, whole=True):
    """`traced_parity`'s and `fixture_parity`'s plain runs on the card, made
    ahead (see `plain_reference`): at each cap the plain run and, with
    ``chaotic``, past cap 0 its one-ulp witnesses; with ``whole`` the whole
    solve stacked with its one-ulp witnesses (not where ``walls`` times it
    alone)."""
    ls, stall = qt.BackTracking(), qt.STALL_LIMIT_DEFAULT
    ulps = ulp_starts(X)

    def run(x0, cap):
        return plain_reference(x0, ls, tol, cap, True, stall, objective, ahead=True)

    for cap in SHORT_CAPS:
        run(X, cap)
        if chaotic and cap > 0:
            for x0 in ulps.values():
                run(x0, cap)
    if whole:
        stacked_runs(lambda x0: run(x0, MAX_ITERS), X, *ulps.values())


def kernel_inputs(seed, n, batch, dtype, device, kinds=True):
    """Random SPD B, drawn on the card (at 1024 x 512 x 512 in f64 it is
    2 GB), and with ``kinds`` one of five lane kinds per lane (lane % 5):
    active, frozen, fresh, forced reset (s = -g, g_old = 2g: y = g,
    m_pre = -|g|²), NaN gradient. Without, every lane is active."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64, device=device)

    A = randn(batch, n, n) * 0.2
    B = torch.baddbmm(torch.eye(n, dtype=torch.float64, device=device), A, A.transpose(1, 2))
    del A
    s = randn(batch, n) * 0.1
    g = randn(batch, n)
    g_old = g + s + 0.01 * randn(batch, n)
    kind = torch.arange(batch, device=device) % 5 if kinds else torch.zeros(batch, device=device)
    active, fresh, forced = kind != 1, kind == 2, kind == 3
    s[forced] = -g[forced]
    g_old[forced] = 2.0 * g[forced]
    g[kind == 4, 0] = float("nan")
    return [t.to(dtype) for t in (B, s, g, g_old)] + [active, fresh], kind


def kernel_phase(device):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
        fused_bfgs_update_batched,
        fused_bfgs_update_reference,
    )

    main_abs_err = None
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for n in (*B1_NS, B1_LARGEST_N[dtype]):
            batch = BATCH if n == N else 512
            args, kind = kernel_inputs(BENCH_SEED + n, n, batch, dtype, device)
            kern = fused_bfgs_update_batched(*(a.clone() for a in args))
            plain = fused_bfgs_update_reference(*(a.clone() for a in args))
            torch.cuda.synchronize()
            check(torch.equal(kern[3], plain[3]), f"reset masks differ (n={n}, {dtype})")
            check(bool(kern[3][kind == 3].all()), f"forced-reset lanes did not reset (n={n}, {dtype})")
            check(not bool(kern[3][kind == 4].any()), f"NaN lanes reset (n={n}, {dtype})")
            frozen = kind == 1
            check(torch.equal(kern[0][frozen], args[0][frozen]),
                  f"frozen lanes' B changed (n={n}, {dtype})")
            abs_err = 0.0
            for name, a, b in zip(("B", "d", "m"), kern[:3], plain[:3]):
                check(torch.equal(torch.isnan(a), torch.isnan(b)), f"NaN pattern of {name} differs")
                ok = ~torch.isnan(b)
                err = float((a[ok] - b[ok]).abs().max())
                rel = err / float(b[ok].abs().max())
                abs_err = max(abs_err, err)
                key = (str(dtype).replace("torch.", ""), name)
                worst[key] = max(worst.get(key, 0.0), rel)
                check(rel <= KERNEL_RTOL[dtype],
                      f"{name} rel err {rel:.3e} > {KERNEL_RTOL[dtype]} (n={n}, {dtype})")
            if n == N and dtype == torch.float32:
                main_abs_err = abs_err
    summary = ", ".join(f"{d} {o} {r:.2e}" for (d, o), r in sorted(worst.items()))
    log(f"[kernel] B1 vs plain, n in {B1_NS} and the largest that fits ({B1_LARGEST_N[torch.float32]} "
        f"f32, {B1_LARGEST_N[torch.float64]} f64), f32+f64, all lane kinds: "
        f"max normwise rel err {summary} (limits f32 {KERNEL_RTOL[torch.float32]}, "
        f"f64 {KERNEL_RTOL[torch.float64]}); max abs err at {BATCH}x{N} f32 {main_abs_err:.3e}")
    return main_abs_err


def bench_fleet(device):
    X = np.random.default_rng(BENCH_SEED).standard_normal((BATCH, N)).astype(np.float32)
    return torch.tensor(X, device=device)


def solve_bench(qt, X, kernel, **kw):
    from quasinewtonmethods_jl_tpu_torch.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    return qt.optimize_batched(
        rosenbrock_logdensity, X, tol=TOL, max_iterations=MAX_ITERS,
        value_and_grad_fn=rosenbrock_value_and_grad, kernel=kernel, **kw,
    )


def solve_cg(qt, X, **kw):
    """The benchmark's headline call (bench.py:75-83): `optimize_cg` with
    its defaults on the phase-4 protocol."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    kw = {"max_iterations": MAX_ITERS, **kw}
    return qt.optimize_cg(rosenbrock_logdensity, X, tol=TOL,
                          value_and_grad_fn=rosenbrock_value_and_grad, **kw)


def main_path_phase(qt, device):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import fused_bfgs_update_batched

    engine = qt.optimize_batched_fused
    X = bench_fleet(device)
    torch.cuda.synchronize()
    fused_bfgs_update_batched.launches = 0
    engine.host_syncs = engine.loop_bodies = 0
    # torch's sync debug mode flags every host-device synchronisation: each
    # must be one of the engine's counted control-flow reads
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = solve_bench(qt, X, "auto")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, bodies, syncs = (
        fused_bfgs_update_batched.launches, engine.loop_bodies, engine.host_syncs
    )
    flagged = sum("synchroniz" in str(w.message) for w in caught)
    check(launches > 0 and launches == bodies,
          f"kernel launches {launches} != loop bodies {bodies}")
    check(flagged == syncs, f"{flagged} synchronisations flagged, {syncs} counted")
    status = res.status.cpu().numpy()
    iters = res.iterations.cpu().numpy()
    hist = {qt.Status(s).name: int(c) for s, c in zip(*np.unique(status, return_counts=True))}
    converged = int((status == qt.Status.CONVERGED).sum())
    x_err = float((res.x - 1.0).abs().max())
    check(res.x.shape == (BATCH, N) and res.x.dtype == torch.float32, "result shape/dtype")
    check(bool(torch.isfinite(res.x).all()), "non-finite iterates")
    med, itmax = float(np.median(iters)), int(iters.max())
    log(f"[main] optimize_batched {BATCH}x{N} f32 on {device}: converged {converged}/{BATCH}, "
        f"status {hist}, iterations median {med:g} max {itmax} (JAX package on the same "
        f"inputs: median {JAX_MEDIAN_ITERS} max {JAX_MAX_ITERS}), max|x-1| {x_err:.3e}, "
        f"max|grad| {float(res.grad.abs().max()):.3e}, kernel launches {launches} = loop "
        f"bodies {bodies}, host syncs {syncs} (all the solve's synchronisations), "
        f"wall {wall:.3f}s (first call, sync debug mode on)")
    check(converged == BATCH, f"only {converged}/{BATCH} lanes converged")
    check(float(res.grad.abs().max()) < TOL, "gradient certificate not met")
    check(abs(med - JAX_MEDIAN_ITERS) <= 0.1 * JAX_MEDIAN_ITERS,
          f"median iterations {med} not within 10% of {JAX_MEDIAN_ITERS}")
    return launches, syncs


def parity_phase(qt, device):
    def quad_logdensity(x):
        diag = torch.arange(1.0, x.shape[0] + 1.0, dtype=x.dtype, device=x.device)
        return -0.5 * torch.sum(diag * x * x)

    X = torch.tensor(np.random.default_rng(BENCH_SEED + 1).standard_normal((256, 6)),
                     device=device)
    a = qt.optimize_batched_fused(quad_logdensity, X, kernel="cuda")
    b = qt.optimize_batched_fused(quad_logdensity, X, kernel="torch")
    for name in ("status", "iterations", "n_fev", "n_gev", "n_resets"):
        check(torch.equal(getattr(a, name), getattr(b, name)), f"{name} differs cuda vs torch")
    dx = float((a.x - b.x).abs().max())
    check(dx <= 1e-10, f"x differs by {dx}")
    check(bool((a.status == qt.Status.CONVERGED).all()), "quadratic fleet did not converge")
    log(f"[parity] f64 quadratic fleet 256x6, kernel='cuda' vs 'torch': statuses and "
        f"counters equal, max|dx| {dx:.3e}")


def time_calls(fn, args, calls=20, queued=False):
    """ms per call over ``calls`` back-to-back calls, by CUDA events. With
    ``queued`` the stream is first held busy (``torch.cuda._sleep``, twice
    the host's time to issue the calls) so that the calls queue behind it
    and the events time the device's work alone, not the host's dispatch
    where a call's host time exceeds its kernel's."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2 * host_s * GPU_SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(calls):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def bound(nbytes, flops, itemsize=4):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` operations in float32 (``itemsize``
    4) or float64 (8)."""
    peak = PEAK_F32_FLOPS if itemsize == 4 else PEAK_F64_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def update_ops(n, updates, rank2, scaled):
    """Floating-point operations that ``updates`` active lanes' fused
    updates need, however a kernel rounds, where ``rank2`` of them change B
    by the rank-2 formula (the others reset it to I, which needs none) and
    ``scaled`` of those have a scale other than 1 (the update after a
    reset). Per update: the two matvecs (4n²) and the O(n) algebra around
    them (y and the four sums that need no B 9n, u n, the three sums after
    the matvecs 6n, d 6n, a = c1·s - u 2n: 24n). Per rank-2 change, written
    B[r, c] = scale·B[r, c] + s[r]·a[c] - u[r]·s[c]: 4 per element of B, 5
    where scaled (and the matvecs' scaling, 2n)."""
    return (updates * (4 * n * n + 24 * n) + rank2 * (4 * n * n)
            + scaled * (n * n + 2 * n))


def b1_bound(batch, n, itemsize, lanes_active, lanes_reset):
    """B1's bound on inputs with no fresh lane: active lanes read and write
    B and read step, g, g_old; every lane reads its two masks and writes d,
    m and reset."""
    nbytes = (lanes_active * (2 * n * n + 3 * n) * itemsize
              + batch * (2 + n * itemsize + itemsize + 1))
    return bound(nbytes, update_ops(n, lanes_active, lanes_active - lanes_reset, 0))


def objective_ops(n, itemsize, objective=None):
    """(operations of one value-and-gradient with the tolerance test, of
    one line-search trial, bytes of the objective's data) that B3's
    objective needs; exp, log1p and a division count as one operation
    each. Rosenbrock (None): 6 per entry and the tolerance test's 1; a
    trial 6 per entry. Quadratic: r = x - x*, diag·r, ·r, its sum, the
    gradient -diag·r and the tolerance test, 6 per entry; a trial 6 (x +
    αd 2, r, diag·r, ·r, the sum); data diag and x*. Logistic over m
    observations: the logits 2mn and Xᵀr 2mn, per observation the term y
    log σ(z) + (1 - y) log σ(-z) 12 (|z|, exp, log1p, two minimums, two
    subtractions, 1 - y, two products, their sum, the accumulation) and
    the residual y - σ(z) 4 (exp, 1 + e, the division, the subtraction),
    per entry 5 (w², its sum, w / σ², the subtraction, the tolerance
    test); a trial the logits, 12 per observation and 4 per entry (x + αd
    2, w² and its sum); data X and y. Poisson over m observations: the
    same products, per observation the term y·z - exp(z) 4 (exp, the
    product, the subtraction, the accumulation) and the residual y - exp(z)
    1 (exp shared), per entry 5; a trial the logits, 4 per observation and
    4 per entry. Funnel: per entry 5 (x², its sum, the gradient's two
    products, the tolerance test) and 20 for v's terms (exp, the value's
    and v's gradient's products and sums); a trial 4 per entry (x + αd 2,
    x², its sum) and 12. Mixture of K components: per component and entry
    3 for the distance ((x - mu)², its sum) and 4 for the gradient (x - mu,
    the product by p/sigma², the sum over components), per component 12
    (two logarithms, sigma², the component's products and sums, its exp
    for the logsumexp and for p, p/sigma²) and 2 for the logsumexp's log
    and shift, per entry 1 (the tolerance test); a trial x + αd 2 per
    entry, 3 per component and entry, 8 per component. AR(1) over T steps:
    forward per step 2n² (A z) and 4n (+ w, y - z, its square, its sum),
    the adjoint per step 2n² (Aᵀ mu) and 4n (2 (y - z), the product, the
    sum, the accumulation into the gradient), per entry 5 (w², its sum,
    w / p², the subtraction, the tolerance test) and 4 for the value; a
    trial the forward recursion, x + αd 2n and w² 2n; data A and ys. A
    traced objective needs what the function needs, which is its
    hand-written twin's count where it has one, not its graph's
    (`graph_ops` counts every op autograd wrote, products by a literal 1
    among them)."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import objective_name

    name = objective_name(objective)
    if name == "rosenbrock":
        return 7 * n, 6 * n, 0
    if name == "quadratic":
        return 6 * n, 6 * n, 2 * n * itemsize
    if name == "funnel":
        return 5 * n + 20, 4 * n + 12, 0
    if name == "mixture":
        K = objective.means.shape[0]
        return (7 * K * n + 12 * K + 2 + n, 2 * n + 3 * K * n + 8 * K + 2,
                (K * n + 2 * K) * itemsize)
    if name == "ar1":
        T = objective.ys.shape[0]
        return (T * (4 * n * n + 8 * n) + 5 * n + 4, T * (2 * n * n + 4 * n) + 4 * n + 4,
                (n * n + T * n) * itemsize)
    m = objective.X.shape[0]
    if name == "poisson":
        return (4 * m * n + 5 * m + 5 * n, 2 * m * n + 4 * m + 4 * n, (m * n + m) * itemsize)
    return (4 * m * n + 16 * m + 5 * n, 2 * m * n + 12 * m + 4 * n,
            (m * n + m) * itemsize)


def dense_quadratic_ops(n, itemsize):
    """`objective_ops` of -0.5·x@(Q@x) + b@x for any Q, as the function
    states it: a value and gradient Q x and Qᵀ x (2n² each), the value's
    two dots (2n each), its scaling and sum (2), the gradient -0.5(Q x +
    Qᵀ x) + b (3n) and the tolerance test (n); a trial x + αd (2n), Q x,
    the two dots, the scaling and the sum; data Q and b."""
    return 4 * n * n + 8 * n + 2, 2 * n * n + 6 * n + 2, (n * n + n) * itemsize


def b3_bound(res, n, itemsize, h0_scale, objective=None, ops=None):
    """B3's bound from the solve's own counters: it reads X0 (and the
    objective's data) and writes X, G, G_old, STEP, B and the per-lane
    scalars once. Per lane: n_gev value-and-gradient evaluations with the
    tolerance test (`objective_ops`); iterations - 1 updates (the first
    iteration is the peel, which counts one reset), n_resets - 1 of which
    reset B; an update right after a reset is scaled (with h0_scale): there
    are n_resets of those less one where the last iteration reset (the
    fresh flag it ends with), and at least that less the resets are rank-2
    changes; n_fev - n_gev line-search trials (`objective_ops`, or ``ops``
    where given); and a step per iteration (2n)."""
    batch = res.x.shape[0]
    iters = res.iterations.to(torch.float64)
    gev = res.n_gev.to(torch.float64)
    trials = res.n_fev.to(torch.float64) - gev
    n_resets = res.n_resets.to(torch.float64)
    updates = (iters - 1).clamp(min=0)
    resets = (n_resets - (iters > 0).to(torch.float64)).clamp(min=0)
    after_reset = n_resets - res.state.fresh.to(torch.float64)
    scaled = (after_reset - resets).clamp(min=0) * float(h0_scale)
    vag_ops, trial_ops, data_bytes = ops or objective_ops(n, itemsize, objective)
    ops = (update_ops(n, updates, updates - resets, scaled)
           + gev * vag_ops + trials * trial_ops + iters * 2 * n)
    nbytes = batch * ((5 * n + n * n + 1) * itemsize + 6 * 4 + 1) + data_bytes
    return bound(nbytes, float(ops.sum()), itemsize)


def shape_line(occupancy):
    return (f"{occupancy['registers']} registers x {occupancy['threads']} threads per block, "
            f"{occupancy['blocks_per_sm']} blocks per SM")


def device_ms_per_launch(fn, args, kernel_name, calls=20):
    """Mean device time of one launch of the kernel named ``kernel_name``
    over ``calls`` calls of ``fn``, from torch.profiler's device events: the
    kernel's own time, whatever the pace at which the host enqueues it.
    None where the profiler recorded no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel_name in e.name]
    return sum(spans) / len(spans) / 1e3 if spans else None


def timing_phase(qt, device, smi):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
        fused_bfgs_update_batched,
        fused_bfgs_update_reference,
        fused_update_occupancy,
    )

    # all lanes active and not fresh: the steady-state call of the main path
    args, _ = kernel_inputs(BENCH_SEED + 2, N, BATCH, torch.float32, device, kinds=False)
    lanes_reset = int(fused_bfgs_update_reference(*(a.clone() for a in args))[3].sum())
    fns = {"cuda": fused_bfgs_update_batched, "torch": fused_bfgs_update_reference}
    for fn in fns.values():
        time_calls(fn, args, calls=3)  # warm-up
    ms = {k: [] for k in fns}
    for order in (("torch", "cuda"), ("cuda", "torch")) * 3:
        for k in order:
            ms[k].append(time_calls(fns[k], args))
    call_ms, plain_ms = float(np.median(ms["cuda"])), float(np.median(ms["torch"]))
    # The wrapper's host time per call is about the kernel's, so back-to-back
    # calls can be paced by the host: the kernel's own time (the `ms` of its
    # record) comes from the profiler's device events (median of 3 x 20
    # launches). A run whose profiler misses the kernel fails rather than
    # report a time by the other method under the same name.
    device_ms = [device_ms_per_launch(fused_bfgs_update_batched, args, "bfgs_update_kernel")
                 for _ in range(3)]
    check(None not in device_ms, "torch.profiler recorded no launch of bfgs_update_kernel")
    kernel_ms = float(np.median(device_ms))
    bytes_moved = 2 * BATCH * N * N * 4
    bound_ms, bound_by = b1_bound(BATCH, N, 4, BATCH, lanes_reset)
    log(f"[time] B1 at {BATCH}x{N} f32: kernel {kernel_ms:.4f} ms (device time per launch, "
        f"torch.profiler; {bytes_moved / kernel_ms / 1e6:.0f} GB/s of B traffic), {call_ms:.4f} "
        f"ms per call by CUDA events over back-to-back calls, plain {plain_ms:.4f} ms/call (median "
        f"of 6 x 20 calls, in turns); bound {bound_ms:.4f} ms ({bound_by}; {lanes_reset} of "
        f"{BATCH} lanes reset), B1 at {100 * bound_ms / kernel_ms:.1f} % of it by device time, "
        f"{100 * bound_ms / call_ms:.1f} % by CUDA events per call; launch "
        f"{shape_line(fused_update_occupancy(N, 4))} on {smi}")

    X = bench_fleet(device)
    engine = qt.optimize_batched_fused
    solve_bench(qt, X, "torch")  # warm-up of the plain path
    walls = {"cuda": [], "torch": []}
    syncs = {}
    for order in (("torch", "cuda"), ("cuda", "torch")):
        for k in order:
            engine.host_syncs = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve_bench(qt, X, k)
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
            syncs[k] = engine.host_syncs
            check(bool((res.status == qt.Status.CONVERGED).all()), f"kernel={k} run did not converge")
    rate = {k: BATCH / float(np.median(v)) for k, v in walls.items()}
    log(f"[time] solves/s at {BATCH}x{N} f32 (median of 2 solves): kernel='cuda' {rate['cuda']:.1f} "
        f"({float(np.median(walls['cuda'])):.4f} s/solve, {syncs['cuda']} host syncs), "
        f"kernel='torch' {rate['torch']:.1f} ({float(np.median(walls['torch'])):.4f} s/solve, "
        f"{syncs['torch']} host syncs) on {smi}")
    return kernel_ms, plain_ms, (bound_ms, bound_by)


def engines(qt):
    """The port's loop drivers, each counting its host reads (and the fleet
    engines their loop bodies; TR its Steihaug bodies, auglag its inner
    engines' bodies)."""
    from quasinewtonmethods_jl_tpu_torch.lbfgs_batched_solve import optimize_lbfgs_batched_fused

    return {"bfgs": qt.optimize_batched_fused, "cg": qt.optimize_cg, "scalar": qt.optimize,
            "lbfgs": qt.optimize_lbfgs, "lbfgs fleet": optimize_lbfgs_batched_fused,
            "lm": qt.least_squares, "tr": qt.optimize_tr, "auglag": qt.optimize_auglag}


def counted_kernels():
    """The port's kernel wrappers, each counting its launches."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_blocked import (
        blocked_matvec,
        blocked_update,
    )
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import fused_bfgs_update_batched
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import resident_bfgs_solve

    return {"B1": fused_bfgs_update_batched, "B2a": blocked_matvec, "B2b": blocked_update,
            "B3": resident_bfgs_solve}


def reset_counters(qt):
    """Every kernel's launch count and the fleet engines' loop counts to 0."""
    for fn in counted_kernels().values():
        fn.launches = 0
    counted_kernels()["B3"].objective_launches.update(
        dict.fromkeys(counted_kernels()["B3"].objective_launches, 0))
    for engine in engines(qt).values():
        for counter in ("host_syncs", "loop_bodies", "cg_bodies", "inner_bodies"):
            if hasattr(engine, counter):
                setattr(engine, counter, 0)


def read_counters(qt):
    counts = {name: fn.launches for name, fn in counted_kernels().items()}
    e = engines(qt)
    counts.update(bodies=e["bfgs"].loop_bodies, syncs=e["bfgs"].host_syncs,
                  cg_bodies=e["cg"].loop_bodies, cg_syncs=e["cg"].host_syncs,
                  scalar_syncs=e["scalar"].host_syncs, lbfgs_syncs=e["lbfgs"].host_syncs,
                  lbfgs_fleet_bodies=e["lbfgs fleet"].loop_bodies,
                  lbfgs_fleet_syncs=e["lbfgs fleet"].host_syncs,
                  lm_syncs=e["lm"].host_syncs, lm_bodies=e["lm"].loop_bodies,
                  tr_syncs=e["tr"].host_syncs, tr_bodies=e["tr"].loop_bodies,
                  tr_cg_bodies=e["tr"].cg_bodies, auglag_syncs=e["auglag"].host_syncs,
                  auglag_rounds=e["auglag"].loop_bodies,
                  auglag_inner_bodies=e["auglag"].inner_bodies)
    return counts


def no_kernel_launched(counts):
    return counts["B1"] == counts["B2a"] == counts["B2b"] == counts["B3"] == 0


def counted_run(qt, fn, syncs_key, kernels=False):
    """``fn()`` with every counter and the peak memory at 0 and torch's sync
    debug mode on: (result, counters, synchronisations flagged, wall s).
    Each flagged synchronisation must be one of the engine's counted reads,
    and no BFGS kernel may launch unless ``kernels`` (the paths that use
    this run none, but phase 24's auglag BFGS fleets, which run B1)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(qt)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counters(qt)
    flagged = sum("synchroniz" in str(w.message) for w in caught)
    check(flagged == c[syncs_key], f"{flagged} synchronisations flagged, {c[syncs_key]} counted")
    check(kernels or no_kernel_launched(c), f"a BFGS kernel launched on a path that has none: {c}")
    return res, c, flagged, wall


def lanes_of(res, lanes):
    """The fleet result ``res`` (a NamedTuple of per-lane leaves, nested)
    on ``lanes`` (an index along its leading axis)."""
    return type(res)(*(None if v is None else lanes_of(v, lanes) if isinstance(v, tuple)
                       else v[lanes] for v in res))


def stacked_runs(run, *starts):
    """``run`` (a fleet solve of one tensor of starts) from each of
    ``starts``, as one fleet of them all stacked: one result per tensor,
    its lanes'. The fleet engine steps every lane on its own, so that a
    lane's run is the run from its start (only the rounding of a batched
    op may change with the fleet's size: the plain run and its rounding
    witnesses differ by rounding in any case), and the host, which drives
    its loop one body at a time, pays for all the runs once."""
    res = run(torch.cat(starts))
    out, at = [], 0
    for x0 in starts:
        out.append(lanes_of(res, slice(at, at + x0.shape[0])))
        at += x0.shape[0]
    return out


# Plain runs made ahead on the card, while the kernels build (`prefetch_plain`):
# key -> (objective, result kept in host memory, so that the device memory
# the phases between report is their own); each is taken once.
AHEAD = {}


def moved(res, device):
    """The fleet result ``res`` (as `lanes_of` takes it) on ``device``."""
    return type(res)(*(None if v is None else moved(v, device) if isinstance(v, tuple)
                       else v.to(device) for v in res))


def plain_reference(x0s, ls, tol, cap, h0_scale, stall, objective=None, ahead=False):
    """`optimize_batched_resident_reference` on these arguments (B3's plain
    version). With ``ahead`` the run is kept for a later call on the same
    arguments and starts (by value); without, such a kept run is returned
    in its place, which is the run this call would make: the plain version
    launches no hand-written kernel, and its rounding does not depend on
    when, or in which process, it runs."""
    from quasinewtonmethods_jl_tpu_torch.resident_solve import optimize_batched_resident_reference

    # None (the split Rosenbrock) by name: phase 9's runs are made in another process
    key = ("rosenbrock" if objective is None else id(objective), repr(ls), tol, cap, h0_scale,
           stall, x0s.device.type, str(x0s.dtype),
           tuple(x0s.shape), hashlib.sha1(x0s.detach().cpu().numpy().tobytes()).hexdigest())
    if not ahead and key in AHEAD:
        return moved(AHEAD.pop(key)[1], x0s.device)
    res = optimize_batched_resident_reference(x0s, ls, tol, cap, h0_scale, stall, objective)
    if ahead:  # the objective kept alive, so that its id stays its own
        AHEAD[key] = (objective, moved(res, "cpu"))
    return res


def normwise_err(a, b):
    """(max |a - b|, that over max |b|) where both are finite; inf for both
    where one is not finite and the two differ (NaN matches NaN)."""
    finite = torch.isfinite(a) & torch.isfinite(b)
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if not bool((finite | same).all()):
        return float("inf"), float("inf")
    if not bool(finite.any()):
        return 0.0, 0.0
    err = float((a[finite] - b[finite]).abs().max())
    scale = float(b[finite].abs().max())
    return err, err / scale if scale else err


def blocked_kernel_phase(device):
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_blocked import (
        blocked_matvec,
        blocked_matvec_reference,
        blocked_update,
        blocked_update_reference,
        fused_bfgs_update_blocked,
    )
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
        fused_bfgs_update_reference,
        update_algebra,
    )

    worst, main_err = {}, {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        for n in (2, 7, 60, 250, LARGE_N):
            batch = LARGE_BATCH if n == LARGE_N else 320
            (B, s, g, g_old, active, fresh), kind = kernel_inputs(
                BENCH_SEED + n, n, batch, dtype, device)
            where = f"(n={n}, {name})"
            y = g_old - g
            By, Bg = blocked_matvec(B, y, g)
            pBy, pBg = blocked_matvec_reference(B, y, g)
            errs = [normwise_err(By, pBy), normwise_err(Bg, pBg)]
            mv_abs, mv_rel = max(e[0] for e in errs), max(e[1] for e in errs)
            check(mv_rel <= KERNEL_RTOL[dtype], f"B2a rel err {mv_rel:.3e} {where}")
            alg = update_algebra(pBy, pBg, s, y, g, active, fresh)
            del By, Bg, pBy, pBg
            kB = blocked_update(B.clone(), s, alg.u, alg.c1, alg.scale, alg.do_upd, alg.reset)
            pB = blocked_update_reference(B.clone(), s, alg.u, alg.c1, alg.scale, alg.do_upd,
                                          alg.reset)
            check(torch.equal(kB.nan_to_num(), pB.nan_to_num())
                  and torch.equal(torch.isnan(kB), torch.isnan(pB)),
                  f"B2b differs from its plain pass {where}")
            up_abs = normwise_err(kB, pB)[0]
            del kB, pB, alg
            kern = fused_bfgs_update_blocked(B.clone(), s, g, g_old, active, fresh)
            check(torch.equal(kern[0][kind == 1], B[kind == 1]), f"frozen lanes' B changed {where}")
            check(bool(kern[3][kind == 3].all()), f"forced-reset lanes did not reset {where}")
            check(not bool(kern[3][kind == 4].any()), f"NaN lanes reset {where}")
            eye = torch.eye(n, dtype=dtype, device=device)
            check(bool((kern[0][kind == 3] == eye).all()), f"reset lanes' B is not I {where}")
            plain = fused_bfgs_update_reference(B, s, g, g_old, active, fresh)
            torch.cuda.synchronize()
            check(torch.equal(kern[3], plain[3]), f"reset masks differ {where}")
            for out, a, b in zip(("B", "d", "m"), kern[:3], plain[:3]):
                _, rel = normwise_err(a, b)
                worst[(name, out)] = max(worst.get((name, out), 0.0), rel)
                check(rel <= KERNEL_RTOL[dtype], f"B2 {out} rel err {rel:.3e} {where}")
            worst[(name, "By,Bg")] = max(worst.get((name, "By,Bg"), 0.0), mv_rel)
            if n == LARGE_N and dtype == torch.float32:
                main_err = {"B2a": mv_abs, "B2b": up_abs}
            del B, s, g, g_old, kern, plain
    summary = ", ".join(f"{d} {o} {r:.2e}" for (d, o), r in sorted(worst.items()))
    log(f"[kernel] B2 vs plain, n in (2, 7, 60, 250, {LARGE_N}) (batch {LARGE_BATCH} at "
        f"n={LARGE_N}), f32+f64, all lane kinds: max normwise rel err {summary} (limits "
        f"{KERNEL_RTOL[torch.float32]} / {KERNEL_RTOL[torch.float64]}: B2a sums each column "
        f"in row order, cuBLAS in its own); B2b equal to its plain pass bit for bit; frozen "
        f"lanes' B bit for bit; max abs err at {LARGE_BATCH}x{LARGE_N} f32: B2a "
        f"{main_err['B2a']:.3e}, B2b {main_err['B2b']:.3e}")
    return main_err


def large_fleet(device, dtype=torch.float32, batch=LARGE_BATCH, n=LARGE_N):
    X = np.random.default_rng(BENCH_SEED).standard_normal((batch, n))
    return torch.tensor(X, dtype=dtype, device=device)


def counters_equal(a, b):
    """Per lane (on the CPU): every counter of the two results equal."""
    same = torch.ones(a.status.shape, dtype=torch.bool)
    for name in ("status", "iterations", "n_fev", "n_gev", "n_resets"):
        same &= getattr(a, name).cpu() == getattr(b, name).cpu()
    for name in ("fresh", "stall"):
        same &= getattr(a.state, name).cpu() == getattr(b.state, name).cpu()
    return same


def large_n_phase(qt, device):
    from quasinewtonmethods_jl_tpu_torch.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    X = large_fleet(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counters(qt)
    t0 = time.perf_counter()
    res = solve_bench(qt, X, "auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counters(qt)
    check(c["bodies"] > 0 and c["B2a"] == c["bodies"] and c["B2b"] == c["bodies"],
          f"B2 launches {c['B2a']}/{c['B2b']} != loop bodies {c['bodies']}")
    check(c["B1"] == 0 and c["B3"] == 0, f"other kernels launched: {c}")
    status = res.status.cpu().numpy()
    iters = res.iterations.cpu().numpy()
    converged = int((status == qt.Status.CONVERGED).sum())
    med, itmax = float(np.median(iters)), int(iters.max())
    check(res.x.shape == (LARGE_BATCH, LARGE_N) and bool(torch.isfinite(res.x).all()),
          "large-n result shape or values")
    log(f"[large] optimize_batched {LARGE_BATCH}x{LARGE_N} f32 on {device}: dispatched to B2, "
        f"launches B2a {c['B2a']} = B2b {c['B2b']} = loop bodies {c['bodies']}, B1 {c['B1']}; "
        f"converged {converged}/{LARGE_BATCH}, iterations median {med:g} max {itmax} (JAX "
        f"package on the same inputs: median {JAX_LARGE_MEDIAN_ITERS} max {JAX_LARGE_MAX_ITERS}), "
        f"max|grad| {float(res.grad.abs().max()):.3e}, max|x-1| {float((res.x - 1).abs().max()):.3e}, "
        f"host syncs {c['syncs']}, wall {wall:.3f}s (first call), peak memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    check(converged == LARGE_BATCH, f"only {converged}/{LARGE_BATCH} lanes converged")
    check(float(res.grad.abs().max()) < TOL, "gradient certificate not met")
    check(abs(med - JAX_LARGE_MEDIAN_ITERS) <= 0.1 * JAX_LARGE_MEDIAN_ITERS,
          f"median iterations {med} not within 10% of {JAX_LARGE_MEDIAN_ITERS}")

    # f64 at n = 200, where B1 does not fit: B2 against the plain update
    X = large_fleet(device, torch.float64, 64, 200)
    runs = {}
    for kernel in ("cuda", "torch"):
        for cap in (5, MAX_ITERS):
            runs[kernel, cap] = qt.optimize_batched(
                rosenbrock_logdensity, X, tol=TOL, max_iterations=cap,
                value_and_grad_fn=rosenbrock_value_and_grad, kernel=kernel)
    short = counters_equal(runs["cuda", 5], runs["torch", 5])
    dx5 = float((runs["cuda", 5].x - runs["torch", 5].x).abs().max())
    a, b = runs["cuda", MAX_ITERS], runs["torch", MAX_ITERS]
    full = counters_equal(a, b)
    dx = float((a.x - b.x).abs().max())
    log(f"[large] f64 64x200 (B1 does not fit f64), kernel='cuda' (B2) vs 'torch': 5 iterations: "
        f"counters equal on {int(short.sum())}/64 lanes, max|dx| {dx5:.3e}; to convergence: "
        f"statuses equal {bool(torch.equal(a.status, b.status))}, converged {int(a.converged.sum())}"
        f" / {int(b.converged.sum())}, max|grad| {float(a.grad.abs().max()):.3e} / "
        f"{float(b.grad.abs().max()):.3e}, counters equal on {int(full.sum())}/64 lanes, max|dx| "
        f"{dx:.3e} (the trajectories separate: see the growth in the next phase)")
    check(bool(short.all()) and dx5 <= 1e-10, "B2 and the plain update differ in 5 iterations")
    check(torch.equal(a.status, b.status) and bool(a.converged.all()),
          "B2 and the plain update end differently")
    check(max(float(a.grad.abs().max()), float(b.grad.abs().max())) < TOL,
          "gradient certificate not met")
    return c


# B3 against its plain version. Over a few iterations (caps 0, 1, 5) the
# two follow one trajectory, so every counter must be equal on every lane
# and floats equal to rounding (normwise, max|diff| / max|plain| over x,
# grad and B: gradients reach ~1e3 on Rosenbrock): within 1e-10 in f64; in
# f32 within 1e-5 or, where more, within ROUNDING_FACTOR times what the
# plain version itself moves when torch sums in the CPU's order instead of
# the card's. Summed in another order, a difference in the last bit grows
# about tenfold every three iterations on these fleets, so over a whole
# solve the two trajectories separate: there both must end in the same
# status on every lane, pass the certificate, and in f64 converge to the
# same optimum within what the certificate allows (tol 1e-8 over
# Rosenbrock's smallest Hessian eigenvalue at 1⃗, ~0.4: 1e-6 is ample). The
# share of lanes whose counters then differ is held to what a change of
# rounding alone does to the plain version: the same run started 1 ulp
# away, and the same run on the CPU.
SHORT_CAPS = (0, 1, 5)
EXACT_RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
CONVERGED_DX = 1e-6
ROUNDING_FACTOR = 2  # B3 against the rounding witnesses: errors, and shares of lanes


def state_err(a, b, lanes=None):
    """(max abs, max normwise) difference of x, grad and B, on b's device
    (over ``lanes``, a mask, where given)."""
    errs = []
    for f in ("x", "grad", "B"):
        ref = getattr(b.state, f)
        mask = slice(None) if lanes is None else lanes.to(ref.device)
        errs.append(normwise_err(getattr(a.state, f).to(ref.device)[mask], ref[mask]))
    return max(e[0] for e in errs), max(e[1] for e in errs)


def resident_parity_plan(qt, device):
    """Phase 9's B3-against-plain runs, in order: (X, ls, tol, cap,
    h0_scale, label), the small fleets, then the main path's shape."""
    plan = []
    for n in RESIDENT_NS:
        X = torch.tensor(np.random.default_rng(BENCH_SEED + n).standard_normal((64, n)),
                         device=device)
        for order in (2, 3):
            for h0_scale in (True, False):
                for cap in (*SHORT_CAPS, MAX_ITERS):
                    plan.append((X, qt.BackTracking(order=order), 1e-8, cap, h0_scale,
                                 f"f64 n={n} order={order} h0={int(h0_scale)} cap={cap}"))
    X = torch.tensor(np.random.default_rng(BENCH_SEED).standard_normal((64, 6)), device=device)
    plan.append((X, qt.BackTracking(), 1e-14, 5, True, "tol=1e-14 cap=5"))
    X = torch.full((64, 6), 1e20, dtype=torch.float32, device=device)
    plan.append((X, qt.BackTracking(), TOL, 5, True, "f32 overflow start cap=5"))
    # the main path's shape and dtype: the phase-4 fleet in f32
    X = bench_fleet(device)
    for order in (2, 3):
        for h0_scale in (True, False):
            for cap in SHORT_CAPS:
                plan.append((X, qt.BackTracking(order=order), TOL, cap, h0_scale,
                             f"f32 {BATCH}x{N} order={order} h0={int(h0_scale)} cap={cap}"))
    plan.append((X, qt.BackTracking(), TOL, MAX_ITERS, True, f"f32 {BATCH}x{N} cap={MAX_ITERS}"))
    return plan


def resident_plain(qt, X, ls, tol, cap, h0_scale, ahead=False):
    """The plain runs of one entry of phase 9's plan (`plain_reference`,
    ``ahead`` as there): at a short cap the plain run, past them the whole
    solve and its witness from x0 + 1 ulp as one fleet; (plain, witness or
    None)."""
    def run(x0):
        return plain_reference(x0, ls, tol, cap, h0_scale, qt.STALL_LIMIT_DEFAULT, ahead=ahead)

    if cap in SHORT_CAPS:
        return run(X), None
    nudged = torch.nextafter(X, torch.full_like(X, float("inf")))
    return tuple(stacked_runs(run, X, nudged))


def resident_parity_phase(qt, device):
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity

    rows, failures = [], []
    groups = ("small", "main")  # the small fleets; the main path's shape (f32 bench fleet)
    # at short caps: max abs and max normwise error of B3, max normwise of the CPU witness
    exact = {g: [0.0, 0.0, 0.0] for g in groups}
    full_dx = 0.0
    # the whole solves take no CPU witness: the main shape's 4096 lanes on the
    # CPU cost tens of seconds, the small fleets' 28 solves ~30 s (where it
    # ran, the CPU witness moved no more lanes than the one-ulp one: 22.8
    # against 23.9 % on an H100), and one witness fewer only lowers the limit
    diverged = {g: {"B3": 0, "plain from x0 + 1 ulp": 0} for g in groups}
    full_lanes = dict.fromkeys(groups, 0)

    def compare(X, ls, tol, cap, h0_scale, label):
        nonlocal full_dx
        kern = qt.optimize_batched_resident(rosenbrock_logdensity, X, ls=ls, tol=tol,
                                            max_iterations=cap, h0_scale=h0_scale, kernel="cuda")
        plain, nudged_run = resident_plain(qt, X, ls, tol, cap, h0_scale)
        same = counters_equal(kern, plain)
        err_abs, err_rel = state_err(kern, plain)
        statuses = bool(torch.equal(kern.status, plain.status))
        group = "main" if X.shape == (BATCH, N) else "small"
        rows.append((label, group, cap, int(same.sum()), X.shape[0], err_rel, statuses))
        if cap in SHORT_CAPS:
            limit = EXACT_RTOL[X.dtype]
            worst = exact[group]
            if group == "main" and cap > 0:
                witness = state_err(plain_reference(X.cpu(), ls, tol, cap, h0_scale,
                                                    qt.STALL_LIMIT_DEFAULT), plain)[1]
                worst[2] = max(worst[2], witness)
                limit = max(limit, ROUNDING_FACTOR * witness)
            worst[0], worst[1] = max(worst[0], err_abs), max(worst[1], err_rel)
            ok = bool(same.all()) and err_rel <= limit
        else:
            ok = (statuses and bool(kern.converged.all())
                  and max(float(kern.grad.abs().max()), float(plain.grad.abs().max())) < tol)
            if X.dtype == torch.float64:
                dx = float((kern.x - plain.x).abs().max())
                full_dx = max(full_dx, dx)
                ok = ok and dx <= CONVERGED_DX
            full_lanes[group] += X.shape[0]
            runs = {"B3": kern, "plain from x0 + 1 ulp": nudged_run}
            for key, other in runs.items():
                diverged[group][key] += int((~counters_equal(other, plain)).sum())
        if not ok:
            failures.append(label)
        return kern

    kerns = {entry[-1]: compare(*entry) for entry in resident_parity_plan(qt, device)}
    check(bool((kerns["tol=1e-14 cap=5"].status == qt.Status.MAX_ITERATIONS).all()),
          "tol 1e-14 run did not hit the cap")
    kern = kerns["f32 overflow start cap=5"]
    check(bool((kern.status == qt.Status.NONFINITE_VALUE).all()) and bool(torch.isnan(kern.fun).all()),
          "overflow start did not end NONFINITE_VALUE with fun NaN")
    del kerns, kern
    for label, _, _, same, batch, err, statuses in rows:
        print(f"  B3 vs plain {label}: counters equal {same}/{batch}, statuses equal {statuses}, "
              f"max normwise d(x, grad, B) {err:.3e}", file=sys.stderr)
    for group in groups:
        share = {k: v / full_lanes[group] for k, v in diverged[group].items()}
        witness = max(v for k, v in share.items() if k != "B3")
        if share["B3"] > ROUNDING_FACTOR * witness:
            failures.append(f"{group} fleets: B3's share of lanes with other counters "
                            f"{share['B3']:.3f} > {ROUNDING_FACTOR} x rounding's {witness:.3f}")
    # how a difference in the last bit grows along the trajectories
    X = torch.tensor(np.random.default_rng(6).standard_normal((64, 6)), device=device)
    growth = []
    for cap in (5, 10, 20, 40, 80):
        kern = qt.optimize_batched_resident(rosenbrock_logdensity, X, max_iterations=cap,
                                            h0_scale=False, kernel="cuda")
        plain = plain_reference(X, qt.BackTracking(), 1e-8, cap, False, qt.STALL_LIMIT_DEFAULT)
        growth.append(f"{cap}: {float((kern.x - plain.x).abs().max()):.1e}")

    def summary(group, limit):
        short = [r for r in rows if r[1] == group and r[2] in SHORT_CAPS]
        full = [r for r in rows if r[1] == group and r[2] not in SHORT_CAPS]
        lanes = full_lanes[group]
        return (f"caps {SHORT_CAPS}: {sum(r[3] == r[4] for r in short)}/{len(short)} runs with "
                f"every counter equal on every lane, max normwise d(x, grad, B) "
                f"{exact[group][1]:.3e} (limit {limit}), max abs {exact[group][0]:.3e}; "
                f"cap {MAX_ITERS}: statuses equal in {sum(r[6] for r in full)}/{len(full)} runs, "
                f"all converged; lanes whose counters differ from the plain run's: "
                + ", ".join(f"{k} {v}/{lanes} ({100 * v / lanes:.1f} %)"
                            for k, v in diverged[group].items())
                + f" (B3's share limit {ROUNDING_FACTOR} x the larger witness's)")

    log(f"[resident] B3 vs plain, f64 Rosenbrock 64 lanes, n in {RESIDENT_NS} x order "
        f"(2, 3) x h0 (on, off), tol 1e-8, plus tol 1e-14 and an f32 overflow start: "
        f"{summary('small', '1e-10 in f64, 1e-5 in f32')}; max|dx| at cap {MAX_ITERS} "
        f"{full_dx:.3e} (limit {CONVERGED_DX}); max|dx| after k iterations (n=6, h0 off) "
        f"{', '.join(growth)}")
    log(f"[resident] B3 vs plain on the main path's shape, f32 {BATCH}x{N} (seed {BENCH_SEED}, "
        f"tol {TOL}), order (2, 3) x h0 (on, off): "
        f"{summary('main', f'max({EXACT_RTOL[torch.float32]}, {ROUNDING_FACTOR} x the CPU run)')}; "
        f"the plain version on the CPU against it on the card at caps 1 and 5: max normwise "
        f"d(x, grad, B) {exact['main'][2]:.3e}")
    check(not failures, f"B3 and its plain version differ: {failures}")
    return exact["main"][0]


def resident_run(qt, model, X, tol):
    """One `optimize_batched_resident` solve under torch's sync debug mode:
    (result, synchronisations flagged, wall s)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = qt.optimize_batched_resident(model, X, tol=tol, max_iterations=MAX_ITERS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return res, sum("synchroniz" in str(w.message) for w in caught), time.perf_counter() - t0


def resident_path_phase(qt, device):
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity

    X = bench_fleet(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counters(qt)
    res, flagged, wall = resident_run(qt, rosenbrock_logdensity, X, TOL)
    c = read_counters(qt)
    check(c["B3"] == 1 and c["B1"] == c["B2a"] == c["B2b"] == 0, f"launches {c}")
    check(flagged == 0, f"{flagged} host synchronisations inside the resident solve")
    status = res.status.cpu().numpy()
    iters = res.iterations.cpu().numpy()
    converged = int((status == qt.Status.CONVERGED).sum())
    med, itmax = float(np.median(iters)), int(iters.max())
    log(f"[resident] optimize_batched_resident {BATCH}x{N} f32 on {device}: launches B3 {c['B3']} "
        f"(B1/B2 0), host synchronisations 0; converged {converged}/{BATCH}, iterations median "
        f"{med:g} max {itmax} (JAX package: median {JAX_MEDIAN_ITERS} max {JAX_MAX_ITERS}), "
        f"max|grad| {float(res.grad.abs().max()):.3e}, max|x-1| {float((res.x - 1).abs().max()):.3e}, "
        f"wall {wall:.3f}s (first call), peak memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
    check(converged == BATCH, f"only {converged}/{BATCH} lanes converged")
    check(float(res.grad.abs().max()) < TOL, "gradient certificate not met")
    check(abs(med - JAX_MEDIAN_ITERS) <= 0.1 * JAX_MEDIAN_ITERS,
          f"median iterations {med} not within 10% of {JAX_MEDIAN_ITERS}")
    return c, b3_bound(res, N, 4, h0_scale=True)  # the entry point's default


def alternate(fns, rounds, warmup=True):
    """Median seconds of each of ``fns`` (name -> no-argument callable that
    ends with the device idle), run in turns, forward then backward, after
    one warm-up call each unless the caller has just run them
    (``warmup=False``); also each one's peak device memory."""
    secs, peak = alternate_samples(fns, rounds, warmup)
    return {k: float(np.median(v)) for k, v in secs.items()}, peak


def turn_gains(secs, base, other):
    """``other``'s solves/s against ``base``'s, per turn, in %: (median,
    min, max) of base_s / other_s - 1 over the turns, as a string."""
    gains = [100 * (b / o - 1) for b, o in zip(secs[base], secs[other])]
    return (f"{other} against {base} per turn {float(np.median(gains)):+.1f} % (range "
            f"{min(gains):+.1f} to {max(gains):+.1f} % over {len(gains)} turns)")


def alternate_samples(fns, rounds, warmup=True):
    """`alternate`, but each one's seconds of every turn."""
    for fn in fns.values() if warmup else ():
        fn()
    secs = {k: [] for k in fns}
    peak = {}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            secs[k].append(time.perf_counter() - t0)
            peak[k] = torch.cuda.max_memory_allocated()
    return secs, peak


def per_call_ms(fns, args, rounds=4, calls=10, warmup=True, queued=False):
    """Median ms per call of each of ``fns`` on ``args``, by CUDA events,
    in turns after a warm-up call each (none with ``warmup=False``, for
    callables the caller has just run); ``queued``: see `time_calls`."""
    for fn in fns.values() if warmup else ():
        time_calls(fn, args, calls=1)
    ms = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            ms[k].append(time_calls(fns[k], args, calls=calls, queued=queued))
    return {k: float(np.median(v)) for k, v in ms.items()}


def device_profile(fn, top=4):
    """Run ``fn`` once under torch.profiler (device activity only): its wall
    in s, the device's busy time in s (the union of the device events'
    intervals), the number of device events, and the ``top`` kernels by
    device time. Busy None where the profiler recorded no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the raw kineto events, as prof.events() would keep them (hidden events
    # skipped), without building its event tree: that takes tens of seconds
    # at the 10^5 events of a host-bound solve
    spans = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and not getattr(e, "is_hidden_event", lambda: False)())
    if not spans:
        return wall, None, 0, []
    busy, end, per_name = 0, float("-inf"), {}
    for start, stop, name in spans:
        busy += max(0, stop - max(start, end))
        end = max(end, stop)
        per_name[name] = per_name.get(name, 0) + (stop - start)
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return wall, busy * 1e-9, len(spans), [(name[:60], ns * 1e-9) for name, ns in ranked]


def profile_line(label, wall, busy, events, ranked, bodies):
    if busy is None:
        return f"[profile] {label}: wall {wall:.4f} s; device busy not measured (no device events)"
    kernels = ", ".join(f"{name} {s:.4f} s ({100 * s / busy:.1f} %)" for name, s in ranked)
    return (f"[profile] {label}: wall {wall:.4f} s (profiled), device busy {busy:.4f} s "
            f"({100 * (1 - busy / wall):.1f} % idle), {events} device events over {bodies} loop "
            f"bodies ({events / max(bodies, 1):.1f} per body); top: {kernels}")


def blocked_and_resident_timing_phase(qt, device, smi, b3_bounds):
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_blocked import (
        blocked_matvec,
        blocked_matvec_reference,
        blocked_update,
        blocked_update_reference,
        fused_bfgs_update_blocked,
    )
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
        fused_bfgs_update_batched,
        fused_bfgs_update_reference,
        update_algebra,
    )
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import resident_occupancy

    # B2 per call at the large-n shape: all lanes active and not fresh
    args, _ = kernel_inputs(BENCH_SEED + 3, LARGE_N, LARGE_BATCH, torch.float32, device,
                                   kinds=False)
    B, s, g, g_old, active, fresh = args
    y = g_old - g
    alg = update_algebra(*blocked_matvec_reference(B, y, g), s, y, g, active, fresh)
    upd_args = (B, s, alg.u, alg.c1, alg.scale, alg.do_upd, alg.reset)
    ms = per_call_ms({"cuda": fused_bfgs_update_blocked, "torch": fused_bfgs_update_reference}, args)
    yg = torch.stack([y, g], dim=1)  # the library call alone, without the stack
    mv = per_call_ms({"cuda": blocked_matvec, "torch": blocked_matvec_reference,
                      "library": lambda B, y, g: torch.bmm(yg, B)}, (B, y, g))
    up = per_call_ms({"cuda": blocked_update, "torch": blocked_update_reference}, upd_args)
    n, nn = LARGE_N, LARGE_N * LARGE_N
    # B2a reads B, y and g and writes By and Bg; B2b reads and writes B on
    # updated lanes, writes it on reset lanes, and reads s, u and the scalars
    upd_lanes, rst_lanes = int(alg.do_upd.sum()), int(alg.reset.sum())
    # (operations: B2a's two matvecs 4n² per lane; B2b's rank-2 change as in
    # update_ops, 4 per element of B plus a = c1·s - u, 5 where scaled)
    scaled_lanes = int((alg.do_upd & (alg.scale != 1)).sum())
    mv_bound = bound(LARGE_BATCH * (nn + 4 * n) * 4, LARGE_BATCH * 4 * nn)
    up_bound = bound((upd_lanes * 2 * nn + rst_lanes * nn) * 4
                     + LARGE_BATCH * (2 * n * 4 + 2 * 4 + 2),
                     upd_lanes * (4 * nn + 2 * n) + scaled_lanes * nn)
    peak = {}
    for k, fn in (("cuda", fused_bfgs_update_blocked), ("torch", fused_bfgs_update_reference)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(*args)
        torch.cuda.synchronize()
        peak[k] = (torch.cuda.max_memory_allocated() - base) / 2**30
    nbytes = LARGE_BATCH * LARGE_N * LARGE_N * 4
    log(f"[time] B2 at {LARGE_BATCH}x{LARGE_N} f32 per call: kernels {ms['cuda']:.4f} ms "
        f"({3 * nbytes / ms['cuda'] / 1e6:.0f} GB/s of B traffic over 3 passes; floor "
        f"{3 * nbytes / 3.35e12 * 1e3:.3f} ms at 3.35 TB/s), plain {ms['torch']:.4f} ms; B2a "
        f"{mv['cuda']:.4f} ms ({nbytes / mv['cuda'] / 1e6:.0f} GB/s) vs plain {mv['torch']:.4f} ms; "
        f"B2b {up['cuda']:.4f} ms ({2 * nbytes / up['cuda'] / 1e6:.0f} GB/s) vs plain "
        f"{up['torch']:.4f} ms; bounds B2a {mv_bound[0]:.4f} ms ({mv_bound[1]}, "
        f"{100 * mv_bound[0] / mv['cuda']:.1f} %), B2b {up_bound[0]:.4f} ms ({up_bound[1]}, "
        f"{100 * up_bound[0] / up['cuda']:.1f} %); torch.bmm alone (B2a's function, stacked "
        f"beforehand) {mv['library']:.4f} ms; memory a call allocates at its peak: kernels {peak['cuda']:.2f} "
        f"GiB, plain {peak['torch']:.2f} GiB (B itself {nbytes / 2**30:.2f} GiB) (median of 4 x "
        f"10 calls, in turns) on {smi}")
    del args, B, s, g, g_old, y, alg, upd_args

    split = []
    for n in SPLIT_NS:
        args, _ = kernel_inputs(BENCH_SEED + n, n, LARGE_BATCH, torch.float32, device,
                                       kinds=False)
        t = per_call_ms({"B1": fused_bfgs_update_batched, "B2": fused_bfgs_update_blocked,
                         "plain": fused_bfgs_update_reference}, args)
        split.append(f"n={n}: B1 {t['B1']:.4f}, B2 {t['B2']:.4f}, plain {t['plain']:.4f}")
    log(f"[time] B1 and B2 near their split, batch {LARGE_BATCH} f32, ms per call (CUDA events "
        f"over back-to-back calls: the host may pace B1's): "
        f"{'; '.join(split)} (B1 fits up to n=237) on {smi}")

    X = large_fleet(device)
    walls, peaks = alternate({k: (lambda k=k: solve_bench(qt, X, k)) for k in ("cuda", "torch")}, 1,
                             warmup=False)  # phase 8 ran both paths at this shape
    log(f"[time] solves/s at {LARGE_BATCH}x{LARGE_N} f32 (one solve each): "
        f"kernel='cuda' (B2) {LARGE_BATCH / walls['cuda']:.1f} ({walls['cuda']:.4f} s/solve, peak "
        f"{peaks['cuda'] / 2**30:.2f} GiB), kernel='torch' {LARGE_BATCH / walls['torch']:.1f} "
        f"({walls['torch']:.4f} s/solve, peak {peaks['torch'] / 2**30:.2f} GiB) on {smi}")
    qt.optimize_batched_fused.loop_bodies = 0
    prof = device_profile(lambda: solve_bench(qt, X, "cuda"))
    log(profile_line(f"large-n fleet {LARGE_BATCH}x{LARGE_N} f32 through B2", *prof,
                     qt.optimize_batched_fused.loop_bodies))
    del X

    X = bench_fleet(device)
    fns = {
        "B3": lambda: qt.optimize_batched_resident(rosenbrock_logdensity, X, tol=TOL,
                                                   max_iterations=MAX_ITERS),
        "B1": lambda: solve_bench(qt, X, "cuda"),
        "plain": lambda: solve_bench(qt, X, "torch"),
    }
    walls, peaks = alternate(fns, 1, warmup=False)  # phases 4-10 ran all three
    log(f"[time] solves/s at {BATCH}x{N} f32 (one solve each): resident B3 "
        f"{BATCH / walls['B3']:.1f} ({walls['B3']:.4f} s/solve, peak {peaks['B3'] / 2**20:.1f} "
        f"MiB), fleet engine with B1 {BATCH / walls['B1']:.1f} ({walls['B1']:.4f} s/solve, peak "
        f"{peaks['B1'] / 2**20:.1f} MiB), with the plain update {BATCH / walls['plain']:.1f} "
        f"({walls['plain']:.4f} s/solve, peak {peaks['plain'] / 2**20:.1f} MiB) on {smi}")
    qt.optimize_batched_fused.loop_bodies = 0
    prof = device_profile(fns["B1"])
    log(profile_line(f"bench fleet {BATCH}x{N} f32 through B1", *prof,
                     qt.optimize_batched_fused.loop_bodies))

    # B3 against fleet size, by CUDA events (no profiler): device time from
    # the solve's first operation to its last, beside the host's wall
    series = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for batch in (132, 264, 528, 1056, 1716, 2112, BATCH, 2 * BATCH):  # 1716 = 13 x 132
        Xb = torch.tensor(np.random.default_rng(BENCH_SEED).standard_normal((batch, N)),
                          dtype=torch.float32, device=device)
        times = []
        for _ in range(4):  # the first is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            res = qt.optimize_batched_resident(rosenbrock_logdensity, Xb, tol=TOL,
                                               max_iterations=MAX_ITERS)
            end.record()
            torch.cuda.synchronize()
            times.append((start.elapsed_time(end), 1e3 * (time.perf_counter() - t0)))
        check(bool((res.status == qt.Status.CONVERGED).all()), f"B3 at batch {batch} did not converge")
        dev, wall = (float(np.median(v)) for v in zip(*times[1:]))
        series.append(f"{batch} {dev:.3f} ms (wall {wall:.3f} ms, max iterations "
                      f"{int(res.iterations.max())})")
        if batch == BATCH:
            b3_ms = dev
    log(f"[profile] B3 against fleet size, n={N} f32 (median of 3 by CUDA events, device busy "
        f"from the solve's first op to its last): {'; '.join(series)} on {smi}")
    b3_bound_ms, b3_bound_by = b3_bounds
    log(f"[time] B3 at {BATCH}x{N} f32: {b3_ms:.4f} ms per solve (CUDA events), bound "
        f"{b3_bound_ms:.4f} ms ({b3_bound_by} the solve needs, from the main path's iterations, "
        f"evaluations and resets), "
        f"B3 at {100 * b3_bound_ms / b3_ms:.1f} % of it; launch {shape_line(resident_occupancy(N, 4))} "
        f"on {smi}")
    # the plain update's run is B3's plain version (optimize_batched_resident_reference)
    return {"B2a": (mv["cuda"], mv["torch"], *mv_bound, mv["library"]),
            "B2b": (up["cuda"], up["torch"], *up_bound, None),
            "B3": (b3_ms, 1e3 * walls["plain"], b3_bound_ms, b3_bound_by, None)}


def fleet_line(qt, res):
    """Converged lanes, the iteration median and max, max|grad|, as numbers."""
    iters = res.iterations.cpu().numpy()
    converged = int((res.status == qt.Status.CONVERGED).sum())
    return converged, float(np.median(iters)), int(iters.max()), float(res.grad.abs().max())


def check_fleet(qt, res, label, jax_median):
    converged, med, itmax, gmax = fleet_line(qt, res)
    check(res.x.shape == (BATCH, N) and res.x.dtype == torch.float32
          and res.x.device.type == "cuda", f"{label}: result shape, dtype or device")
    check(bool(torch.isfinite(res.x).all()), f"{label}: non-finite iterates")
    check(converged == BATCH, f"{label}: only {converged}/{BATCH} lanes converged")
    check(gmax < TOL, f"{label}: gradient certificate not met")
    if jax_median is not None:
        check(abs(med - jax_median) <= 0.1 * jax_median,
              f"{label}: median iterations {med} not within 10% of {jax_median}")
    return converged, med, itmax, gmax


def cg_phase(qt, device, smi):
    """The CG headline on the bench fleet (see phase 12 above)."""
    X = bench_fleet(device)
    res, c, flagged, wall = counted_run(qt, lambda: solve_cg(qt, X), "cg_syncs")
    peak = torch.cuda.max_memory_allocated(device)
    converged, med, itmax, gmax = fleet_line(qt, res)
    log(f"[cg] optimize_cg {BATCH}x{N} f32 on {device} (hz, approximate Wolfe): converged "
        f"{converged}/{BATCH}, iterations median {med:g} max {itmax} (JAX package on the same "
        f"inputs: median {JAX_CG_MEDIAN_ITERS} max {JAX_CG_MAX_ITERS}), max|grad| {gmax:.3e}, "
        f"max|x-1| {float((res.x - 1).abs().max()):.3e}, n_fev median "
        f"{float(res.n_fev.float().median()):g}, loop bodies {c['cg_bodies']}, host syncs "
        f"{c['cg_syncs']} (all the solve's synchronisations: {flagged} flagged), kernel launches "
        f"B1 {c['B1']} B2a {c['B2a']} B2b {c['B2b']} B3 {c['B3']}, peak memory "
        f"{peak / 2**20:.1f} MiB, wall {wall:.3f}s (first call, sync debug mode on)")
    check_fleet(qt, res, "CG", JAX_CG_MEDIAN_ITERS)
    check(c["bodies"] == 0, f"the CG path ran the BFGS fleet's loop: {c}")

    folded = {}
    fns = {"cg": lambda: solve_cg(qt, X),
           "cg fold_eval": lambda: folded.update(res=solve_cg(qt, X, fold_eval=True))}
    # a CG solve is host-bound and takes seconds; the counted run warmed the engine
    secs, peaks = alternate_samples(fns, TURNS, warmup=False)
    walls = {k: float(np.median(v)) for k, v in secs.items()}
    bodies, syncs = c["cg_bodies"], c["cg_syncs"]
    # the busy share over a solve's first CG_PROFILED_ITERS iterations: a whole
    # solve's ~4 x 10^5 device events take seconds to read
    qt.optimize_cg.loop_bodies = 0
    prof = device_profile(lambda: solve_cg(qt, X, max_iterations=CG_PROFILED_ITERS))
    wall_p, busy = prof[0], prof[1]
    log(f"[time] CG solves/s at {BATCH}x{N} f32 (median of {TURNS} solves, in turns, after the "
        f"counted run): "
        f"optimize_cg {BATCH / walls['cg']:.1f} ({walls['cg']:.4f} s/solve, peak "
        f"{peaks['cg'] / 2**20:.1f} MiB), with fold_eval {BATCH / walls['cg fold_eval']:.1f} "
        f"({walls['cg fold_eval']:.4f} s/solve, peak {peaks['cg fold_eval'] / 2**20:.1f} MiB), "
        f"{turn_gains(secs, 'cg', 'cg fold_eval')}; "
        f"{bodies} loop bodies and {syncs} host syncs per solve, "
        f"{1e3 * walls['cg'] / max(bodies, 1):.3f} ms of wall per body; device busy share of a "
        f"solve's first {CG_PROFILED_ITERS} iterations "
        + ("not measured (no device events)" if busy is None else f"{100 * busy / wall_p:.1f} %")
        + f" on {smi}")
    log(profile_line(f"CG fleet {BATCH}x{N} f32, its first {CG_PROFILED_ITERS} iterations",
                     *prof, qt.optimize_cg.loop_bodies))
    return {"solves_per_s": BATCH / walls["cg"], "busy_share": None if busy is None else busy / wall_p,
            "n_fev": res.n_fev, "fold": folded["res"]}


def wolfe_phase(qt, device, smi, cg_n_fev, cg_fold):
    """BFGS with the Wolfe search through B1, and fold_eval for both
    engines (see phase 13 above); ``cg_fold``: phase 12's CG solve with
    fold_eval."""
    X = bench_fleet(device)
    runs = {}
    for label, kw in (("wolfe", dict(ls=qt.Wolfe())), ("wolfe fold", dict(ls=qt.Wolfe(), fold_eval=True)),
                      ("backtracking fold", dict(fold_eval=True))):
        reset_counters(qt)
        res = solve_bench(qt, X, "auto", **kw)
        torch.cuda.synchronize()
        c = read_counters(qt)
        runs[label] = res
        converged, med, itmax, gmax = fleet_line(qt, res)
        log(f"[wolfe] optimize_batched {BATCH}x{N} f32, {label}: converged {converged}/{BATCH}, "
            f"iterations median {med:g} max {itmax} (JAX package, Wolfe: median "
            f"{JAX_WOLFE_MEDIAN_ITERS} max {JAX_WOLFE_MAX_ITERS}), n_fev median "
            f"{float(res.n_fev.float().median()):g}, max|grad| {gmax:.3e}, B1 launches {c['B1']} "
            f"= loop bodies {c['bodies']}, host syncs {c['syncs']}")
        check(c["B1"] == c["bodies"] > 0 and c["B2a"] == c["B2b"] == c["B3"] == 0,
              f"{label}: launches {c}")
        check_fleet(qt, res, f"BFGS {label}", JAX_WOLFE_MEDIAN_ITERS if label == "wolfe" else None)
    check_fleet(qt, cg_fold, "CG fold_eval", None)
    fev = {"BFGS Wolfe": (runs["wolfe"].n_fev, runs["wolfe fold"].n_fev),
           "CG": (cg_n_fev, cg_fold.n_fev)}
    for label, (off, on) in fev.items():
        check(int(on.sum()) < int(off.sum()), f"{label}: fold_eval did not reduce n_fev")
    log(f"[wolfe] fold_eval: mean n_fev per lane BFGS Wolfe "
        f"{float(fev['BFGS Wolfe'][0].float().mean()):.2f} -> {float(fev['BFGS Wolfe'][1].float().mean()):.2f}, "
        f"CG {float(fev['CG'][0].float().mean()):.2f} -> {float(fev['CG'][1].float().mean()):.2f}; "
        f"CG fold_eval iterations median {fleet_line(qt, cg_fold)[1]:g} max {fleet_line(qt, cg_fold)[2]} "
        f"(JAX: 218 / 587)")
    fns = {"backtracking": lambda: solve_bench(qt, X, "cuda"),
           "wolfe": lambda: solve_bench(qt, X, "cuda", ls=qt.Wolfe()),
           "wolfe fold": lambda: solve_bench(qt, X, "cuda", ls=qt.Wolfe(), fold_eval=True)}
    secs, _ = alternate_samples(fns, TURNS, warmup=False)  # each was just run, counted
    walls = {k: float(np.median(v)) for k, v in secs.items()}
    log(f"[time] BFGS fleet solves/s at {BATCH}x{N} f32 through B1 (median of {TURNS} solves, in "
        f"turns): " + ", ".join(f"{k} {BATCH / v:.1f} ({v:.4f} s/solve)" for k, v in walls.items())
        + f"; {turn_gains(secs, 'wolfe', 'wolfe fold')} on {smi}")


def compacted_phase(qt, device, smi):
    """Straggler compaction through B1 against the fused engine (see phase
    14 above)."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    X = bench_fleet(device)

    def compacted():
        return qt.optimize_batched_compacted(
            rosenbrock_logdensity, X, tol=TOL, max_iterations=MAX_ITERS,
            value_and_grad_fn=rosenbrock_value_and_grad, kernel="cuda")

    fused = solve_bench(qt, X, "cuda")
    reset_counters(qt)
    comp = compacted()
    torch.cuda.synchronize()
    c = read_counters(qt)
    differ = int((~counters_equal(comp, fused)).sum())
    converged, med, itmax, gmax = fleet_line(qt, comp)
    log(f"[compacted] optimize_batched_compacted {BATCH}x{N} f32, chunk 64, kernel='cuda': "
        f"converged {converged}/{BATCH}, statuses equal to optimize_batched_fused's "
        f"{bool(torch.equal(comp.status, fused.status))}, iterations median {med:g} max {itmax}, "
        f"max|grad| {gmax:.3e}; B1 launches {c['B1']} (loop bodies {c['bodies']} plus the "
        f"resumed legs' peels), host syncs {c['syncs']}; lanes whose counters differ from the "
        f"fused run's {differ}/{BATCH} (rounding: B1 sums alike at every width, the objective's "
        f"vmapped ops need not)")
    check(c["B1"] >= c["bodies"] > 0 and c["B2a"] == c["B2b"] == c["B3"] == 0, f"launches {c}")
    check(torch.equal(comp.status, fused.status), "compacted statuses differ from fused")
    check_fleet(qt, comp, "compacted", None)
    secs, _ = alternate_samples({"fused": lambda: solve_bench(qt, X, "cuda"),
                                 "compacted": compacted}, TURNS, warmup=False)
    walls = {k: float(np.median(v)) for k, v in secs.items()}
    log(f"[time] solves/s at {BATCH}x{N} f32 through B1 (median of {TURNS} solves, in turns): fused "
        f"{BATCH / walls['fused']:.1f} ({walls['fused']:.4f} s/solve), compacted "
        f"{BATCH / walls['compacted']:.1f} ({walls['compacted']:.4f} s/solve), "
        f"{turn_gains(secs, 'fused', 'compacted')} on {smi}")


def repair_phase(qt):
    """Entry points given numpy run on the card (see phase 15 above)."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    Xn = np.random.default_rng(BENCH_SEED).standard_normal((64, N))  # float64
    kw = dict(tol=TOL, max_iterations=MAX_ITERS, value_and_grad_fn=rosenbrock_value_and_grad)
    results = {"optimize_batched": qt.optimize_batched(rosenbrock_logdensity, Xn, **kw),
               "optimize_cg": qt.optimize_cg(rosenbrock_logdensity, Xn, **kw)}
    saved = qt.cg_state_to_numpy(results["optimize_cg"].state)
    results["optimize_cg_from_state"] = qt.optimize_cg_from_state(rosenbrock_logdensity, saved,
                                                                  **kw)
    for name, res in results.items():
        check(res.x.device.type == "cuda" and res.status.device.type == "cuda",
              f"{name} on numpy input ran on {res.x.device}")
        check(res.x.dtype == torch.float32, f"{name} on float64 numpy input ran in {res.x.dtype}")
        check(bool(res.converged.all()), f"{name} on numpy input did not converge")
    log(f"[repair] numpy (64, {N}) float64 input, and the CG result's state saved as numpy: "
        + ", ".join(f"{k} -> {v.x.device}, {v.x.dtype}, converged {int(v.converged.sum())}/64"
                    for k, v in results.items()))


def scalar_start(device, n=N, dtype=torch.float32):
    """bench_full.py's single-solve start: standard_normal(n), seed 20260816."""
    x = np.random.default_rng(BENCH_SEED).standard_normal(n)
    return torch.tensor(x, dtype=dtype, device=device)


def scalar_starts(count, device):
    """f32 starts near the scalar start: start 0 is it, start k > 0 adds
    1e-6 * standard_normal(N) from seed BENCH_SEED + k
    (scripts/scalar_f32_rounding.py::perturbed_starts makes the same)."""
    x = np.random.default_rng(BENCH_SEED).standard_normal(N)
    return [torch.tensor((x if k == 0 else x + 1e-6 * np.random.default_rng(BENCH_SEED + k)
                          .standard_normal(N)).astype(np.float32), device=device)
            for k in range(count)]


def fewer_converged_p(port, ref, n):
    """One-sided Fisher exact test: were both packages' chances to converge
    equal, the probability that the port converges at most ``port`` of its
    ``n`` starts, given ``port + ref`` of the ``2n`` converged."""
    total = port + ref
    return sum(math.comb(n, k) * math.comb(n, total - k)
               for k in range(max(0, total - n), port + 1)) / math.comb(2 * n, total)


def scalar_f32_starts(qt, device):
    """f32 DFP (H0 scaling off) and SR1 over `scalar_starts`, each held to
    the JAX package's count of converged starts (see phase 16 above; run
    beside the build, its walls are shown, not measured)."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    kw = dict(tol=TOL, value_and_grad_fn=rosenbrock_value_and_grad)

    in_band = {int(qt.Status.CONVERGED), int(qt.Status.LINESEARCH_FAILURE),
               int(qt.Status.MAX_ITERATIONS)}
    lines = []
    for method, h0_scale in (("dfp", False), ("sr1", True)):
        t0 = time.perf_counter()
        runs = [qt.optimize(rosenbrock_logdensity, x0, update_method=method, h0_scale=h0_scale,
                            max_iterations=MAX_ITERS, **kw)
                for x0 in scalar_starts(SCALAR_F32_STARTS, device)]
        wall = time.perf_counter() - t0
        outcomes = [(qt.Status(int(r.status)).name, int(r.iterations)) for r in runs]
        for r, (status, _) in zip(runs, outcomes):
            check(int(r.status) in in_band and r.x.dtype == torch.float32
                  and bool(torch.isfinite(r.x).all()), f"f32 {method}: {status}, or non-finite x")
            check(status != "CONVERGED" or float(r.grad.abs().max()) < TOL,
                  f"f32 {method}: converged without the certificate")
        port = sum(status == "CONVERGED" for status, _ in outcomes)
        ref = JAX_F32_CONVERGED[method]
        p = fewer_converged_p(port, ref, SCALAR_F32_STARTS)
        lines.append(f"{method}{'' if h0_scale else ' (h0_scale=False)'}: converged "
                     f"{port}/{SCALAR_F32_STARTS} (JAX f32 on the CPU: {ref}/{SCALAR_F32_STARTS}; "
                     f"one-sided Fisher p = {p:.3f}), {wall:.3f} s; {outcomes}")
        check(p >= 0.01, f"f32 {method} converged {port}/{SCALAR_F32_STARTS} starts against "
              f"JAX's {ref}: fewer than chance allows (p = {p:.4f})")
    log(f"[scalar] optimize f32 on {device}, Rosenbrock n={N} from {SCALAR_F32_STARTS} starts near "
        f"bench_full.py's (at most {MAX_ITERS} iterations; beside the build): "
        + "; ".join(lines))


def scalar_phase(qt, device):
    """The scalar BFGS driver on the card (see phase 16 above)."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        IllConditionedQuadratic,
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    kw = dict(tol=TOL, value_and_grad_fn=rosenbrock_value_and_grad)
    x0 = scalar_start(device)
    # BFGS in f32, bench_full.py's configuration; DFP and SR1 in f64 here,
    # and in f32 over several starts below (on one f32 start rounding
    # decides whether they converge: PERF.md, section 6); DFP without the H0
    # scaling, with which it stalls, in JAX too
    for method, h0_scale, dtype in (("bfgs", True, torch.float32), ("dfp", False, torch.float64),
                                    ("sr1", True, torch.float64)):
        res, c, flagged, wall = counted_run(
            qt, lambda: qt.optimize(rosenbrock_logdensity, x0.to(dtype), update_method=method,
                                    h0_scale=h0_scale, **kw), "scalar_syncs")
        iters = int(res.iterations)
        status = qt.Status(int(res.status)).name
        beside = f" (JAX f32: {JAX_BFGS_ITERS})" if method == "bfgs" else ""
        log(f"[scalar] optimize {method}{'' if h0_scale else ' (h0_scale=False)'} "
            f"{str(dtype).replace('torch.', '')}, Rosenbrock n={N} from bench_full.py's start on "
            f"{res.x.device}: {status}, {iters} iterations{beside}, n_fev {int(res.n_fev)}, "
            f"max|grad| {float(res.grad.abs().max()):.3e}, {c['scalar_syncs']} host syncs "
            f"({c['scalar_syncs'] / max(iters, 1):.2f} per iteration, all {flagged} flagged "
            f"counted), {wall:.3f} s")
        check(res.x.device == device and res.x.dtype == dtype, f"{method}: result device or dtype")
        check(status == "CONVERGED" and float(res.grad.abs().max()) < TOL,
              f"optimize {method} {dtype} did not converge: {status}")

    model = IllConditionedQuadratic(256, condition=1e4, dtype=torch.float32, device=device)
    xq = scalar_start(device, 256)
    res, c, _, wall = counted_run(qt, lambda: qt.optimize(model, xq, tol=TOL, max_iterations=5000),
                                  "scalar_syncs")
    check(int(res.status) == qt.Status.CONVERGED, "ill-conditioned quadratic did not converge")
    quad = (f"quadratic n=256 condition 1e4 f32: CONVERGED in {int(res.iterations)} iterations, "
            f"max|grad| {float(res.grad.abs().max()):.3e}, max|x-x*| "
            f"{float((res.x - model.x_star).abs().max()):.3e}, {c['scalar_syncs']} host syncs, "
            f"{wall:.3f} s")

    long = qt.optimize(rosenbrock_logdensity, x0, **kw)
    part = qt.optimize(rosenbrock_logdensity, x0, max_iterations=40, **kw)
    saved = qt.bfgs_state_to_numpy(part.state)
    resumed = qt.optimize_from_state(rosenbrock_logdensity, saved, **kw)
    check(int(part.status) == qt.Status.MAX_ITERATIONS, "the capped solve did not hit its cap")
    check(resumed.x.device.type == "cuda" and resumed.x.dtype == torch.float32,
          "the numpy state did not resume on the card in f32")
    check(int(resumed.status) == qt.Status.CONVERGED, "optimize_from_state did not converge")
    log(f"[scalar] {quad}; optimize_from_state of a 40-iteration solve saved as numpy: "
        f"CONVERGED on {resumed.x.device} at iteration {int(resumed.iterations)} (one long solve: "
        f"{int(long.iterations)}), n_fev {int(resumed.n_fev)} (long {int(long.n_fev)}: the resume "
        f"evaluates once more at its start)")


def lbfgs_scalar_phase(qt, device):
    """The scalar L-BFGS driver on the card (see phase 17 above)."""
    diag = torch.linspace(0.2, 5.0, LBFGS_N, dtype=torch.float32, device=device)
    x_star = scalar_start(device, LBFGS_N)

    def quad(x):
        return -0.5 * torch.sum(diag * (x - x_star) ** 2)

    lines = []
    for method in ("compact", "two_loop"):
        x0 = torch.zeros(LBFGS_N, dtype=torch.float32, device=device)
        res, c, flagged, wall = counted_run(
            qt, lambda: qt.optimize_lbfgs(quad, x0, history=LBFGS_HISTORY, tol=TOL,
                                          max_iterations=500, direction_method=method),
            "lbfgs_syncs")
        iters = int(res.iterations)
        check(int(res.status) == qt.Status.CONVERGED, f"optimize_lbfgs {method} did not converge")
        lines.append(f"{method}: CONVERGED in {iters} iterations (JAX f32: {JAX_LBFGS_ITERS}), "
                     f"n_fev {int(res.n_fev)}, max|x-x*| {float((res.x - x_star).abs().max()):.3e}, "
                     f"{c['lbfgs_syncs']} host syncs ({c['lbfgs_syncs'] / max(iters, 1):.2f} per "
                     f"iteration, all {flagged} flagged counted), {wall:.3f} s")
    log(f"[lbfgs] optimize_lbfgs(history={LBFGS_HISTORY}), n={LBFGS_N} diagonal quadratic f32 on "
        f"{device}: " + "; ".join(lines))


def solve_lbfgs_fleet(qt, X, max_iterations=MAX_ITERS):
    """bench_full.py:121-136's call: history 10, tol 1e-3, analytic
    value-and-grad, the fused engine."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    return qt.optimize_lbfgs_batched(rosenbrock_logdensity, X, history=LBFGS_HISTORY, tol=TOL,
                                     max_iterations=max_iterations,
                                     value_and_grad_fn=rosenbrock_value_and_grad)


def lbfgs_fleet_phase(qt, device, smi):
    """The L-BFGS fleets on the card (see phase 18 above). Returns, per
    fleet, its solves/s, busy share and peak memory."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    out = {}
    for (batch, n), (jax_med, jax_max) in LBFGS_FLEETS.items():
        X = large_fleet(device, batch=batch, n=n)
        label = f"{batch}x{n}"
        res, c, flagged, wall = counted_run(qt, lambda: solve_lbfgs_fleet(qt, X),
                                            "lbfgs_fleet_syncs")
        bodies, syncs = c["lbfgs_fleet_bodies"], c["lbfgs_fleet_syncs"]
        converged, med, itmax, gmax = fleet_line(qt, res)
        log(f"[lbfgs-fleet] optimize_lbfgs_batched {label} f32 on {device}: converged "
            f"{converged}/{batch}, iterations median {med:g} max {itmax} (JAX package on the same "
            f"inputs: median {jax_med} max {jax_max}), n_fev median "
            f"{float(res.n_fev.float().median()):g}, max|grad| {gmax:.3e}, max|x-1| "
            f"{float((res.x - 1).abs().max()):.3e}; {bodies} loop bodies, {syncs} host syncs "
            f"({syncs / max(bodies, 1):.2f} per body; all {flagged} flagged counted), no kernel "
            f"launched; wall {wall:.3f}s (first call, sync debug mode on)")
        check(res.x.shape == (batch, n) and res.x.dtype == torch.float32
              and bool(torch.isfinite(res.x).all()), f"{label}: result shape, dtype or values")
        check(converged == batch, f"{label}: only {converged}/{batch} lanes converged")
        check(gmax < TOL, f"{label}: gradient certificate not met")
        check(abs(med - jax_med) <= 0.1 * jax_med,
              f"{label}: median iterations {med} not within 10% of {jax_med}")

        secs, peaks = alternate_samples({"fleet": lambda: solve_lbfgs_fleet(qt, X)}, 1,
                                        warmup=False)  # after the counted run
        wall_s = float(np.median(secs["fleet"]))
        reset_counters(qt)
        prof = device_profile(lambda: solve_lbfgs_fleet(qt, X))
        prof_bodies = engines(qt)["lbfgs fleet"].loop_bodies
        busy = None if prof[1] is None else prof[1] / prof[0]
        log(f"[time] L-BFGS fleet {label} f32: {batch / wall_s:.1f} solves/s ({wall_s:.4f} s/solve, "
            f"one solve after the counted run), "
            f"{bodies} loop bodies and {syncs} host syncs per solve, {1e3 * wall_s / bodies:.3f} ms "
            f"of wall per body, peak memory {peaks['fleet'] / 2**20:.1f} MiB; device busy share "
            + ("not measured (no device events)" if busy is None else f"{100 * busy:.1f} %")
            + f" on {smi}")
        log(profile_line(f"L-BFGS fleet {label} f32", *prof, prof_bodies))
        out[label] = {"solves_per_s": batch / wall_s, "busy_share": busy,
                      "peak_mib": peaks["fleet"] / 2**20, "bodies": bodies, "syncs": syncs}

        # resume from a state saved as numpy: it lands on the card in f32
        part = solve_lbfgs_fleet(qt, X, max_iterations=50)
        saved = qt.lbfgs_state_to_numpy(part.state)
        resumed = qt.optimize_lbfgs_batched_fused_from_state(
            rosenbrock_logdensity, saved, tol=TOL, max_iterations=MAX_ITERS,
            value_and_grad_fn=rosenbrock_value_and_grad)
        converged_r, med_r, itmax_r, gmax_r = fleet_line(qt, resumed)
        check(resumed.x.device.type == "cuda" and resumed.x.dtype == torch.float32,
              f"{label}: the numpy state did not resume on the card in f32")
        check(converged_r == batch and gmax_r < TOL, f"{label}: the resumed fleet did not converge")
        log(f"[lbfgs-fleet] {label} resumed from a 50-iteration state saved as numpy: on "
            f"{resumed.x.device} f32, converged {converged_r}/{batch}, iterations median "
            f"{med_r:g} max {itmax_r} (the one-leg run: {med:g} / {itmax})")
        del X, res, part, saved, resumed
    return out


def ring_phase(qt, device, smi):
    """The shift ring against the circular ring (see phase 18 above): whole
    fleet solves through each, in turns, at three shapes. Returns the ms
    per body of each ring at each shape."""
    import quasinewtonmethods_jl_tpu_torch.lbfgs_batched_solve as lbs

    fleet = engines(qt)["lbfgs fleet"]
    limit = lbs._RING_CIRCULAR_MIN_N
    rows, times = [], {}
    try:
        for batch, n in RING_SHAPES:
            X = large_fleet(device, batch=batch, n=n)
            bodies = {}

            def run(ring, X=X, bodies=bodies):
                lbs._RING_CIRCULAR_MIN_N = 1 if ring == "circular" else 10**9
                fleet.loop_bodies = 0
                res = solve_lbfgs_fleet(qt, X)
                torch.cuda.synchronize()
                bodies[ring] = fleet.loop_bodies
                check(bool(res.converged.all()), f"{ring} ring {batch}x{n}: not every lane converged")
                return res

            secs, _ = alternate_samples({r: (lambda r=r: run(r)) for r in ("shift", "circular")},
                                        RING_TURNS, warmup=False)
            ms = {r: 1e3 * float(np.median(v)) / bodies[r] for r, v in secs.items()}
            ratios = [(s_ / bodies["shift"]) / (c_ / bodies["circular"])
                      for s_, c_ in zip(secs["shift"], secs["circular"])]
            times[batch, n] = ms
            rows.append(f"{batch}x{n}: shift {ms['shift']:.3f}, circular {ms['circular']:.3f} ms per "
                        f"body ({bodies['shift']} / {bodies['circular']} bodies; the circular ring "
                        f"{ms['shift'] / ms['circular']:.2f}x, per turn "
                        f"{', '.join(f'{r:.2f}' for r in ratios)})")
            del X
    finally:
        lbs._RING_CIRCULAR_MIN_N = limit
    log(f"[ring] L-BFGS fleet f32, history {LBFGS_HISTORY}, whole solves per ring in turns (median "
        f"of {RING_TURNS}, wall per loop body): {'; '.join(rows)}; dispatch: circular for "
        f"n >= {limit} on {smi}")
    return times


def vmap_phase(qt, device):
    """``optimize_batched(backend="vmap")`` against the fused engine (see
    phase 19 above)."""
    X = bench_fleet(device)[:VMAP_LANES]
    t0 = time.perf_counter()
    vm = solve_bench(qt, X, "auto", backend="vmap")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fused = solve_bench(qt, X, "auto")
    _, med_v, max_v, gmax_v = fleet_line(qt, vm)
    _, med_f, max_f, _ = fleet_line(qt, fused)
    check(vm.x.shape == (VMAP_LANES, N) and vm.x.device.type == "cuda", "vmap result shape or device")
    check(torch.equal(vm.status, fused.status), "vmap statuses differ from the fused engine's")
    check(bool(vm.converged.all()) and gmax_v < TOL, "vmap lanes did not all converge")
    check(abs(med_v - med_f) <= 0.1 * med_f,
          f"vmap median iterations {med_v} not within 10% of the fused engine's {med_f}")
    log(f"[vmap] optimize_batched(backend='vmap') on the bench fleet's first {VMAP_LANES} lanes: "
        f"statuses equal to the fused engine's, converged {int(vm.converged.sum())}/{VMAP_LANES}, "
        f"iterations median {med_v:g} max {max_v} (fused: {med_f:g} / {max_f}), max|grad| "
        f"{gmax_v:.3e}, {wall:.3f} s for the {VMAP_LANES} scalar solves")


def logistic_data(rng):
    """BASELINE config 3's data and the fleet's starts, float64 numpy, drawn
    in the order scripts/jax_logistic_reference.py draws them: X =
    N(0, 1) / sqrt(n), w_true, y = 1[u < σ(X w_true)], the starts N(0, 1)."""
    X = rng.standard_normal((LOGISTIC_OBS, LOGISTIC_N)) / np.sqrt(LOGISTIC_N)
    w_true = rng.standard_normal(LOGISTIC_N)
    y = (rng.random(LOGISTIC_OBS) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    starts = rng.standard_normal((BATCH, LOGISTIC_N))
    return X, y, starts


def objective_fleet(kind, n, dtype, device, batch=OBJECTIVE_LANES):
    """A model of ``kind`` on the card in ``dtype`` and a fleet of N(0, 1)
    starts, from seed BENCH_SEED + n: the quadratic (condition 1e4, x*
    drawn) or a logistic posterior of LOGISTIC_OBS observations (drawn by
    the model's recipe with numpy)."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        IllConditionedQuadratic,
        LogisticRegressionMAP,
    )

    rng = np.random.default_rng(BENCH_SEED + n)
    if kind == "quadratic":
        model = IllConditionedQuadratic(n, condition=QUAD_CONDITION, x_star=rng.standard_normal(n),
                                        dtype=dtype, device=device)
    else:
        X = rng.standard_normal((LOGISTIC_OBS, n)) / np.sqrt(n)
        logits = X @ rng.standard_normal(n)
        y = (rng.random(LOGISTIC_OBS) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
        model = LogisticRegressionMAP(n, LOGISTIC_OBS, prior_scale=LOGISTIC_PRIOR, X=X, y=y,
                                      dtype=dtype, device=device)
    return model, torch.tensor(rng.standard_normal((batch, n)), dtype=dtype, device=device)


def objective_parity(qt, model, X, tol, label):
    """B3's instantiation for ``model`` against its plain version on the
    fleet ``X``: over caps 0, 1 and 5 every counter equal on every lane and
    x, grad and B normwise within KERNEL_RTOL (in f32 within it or, where
    more, within ROUNDING_FACTOR times what the plain version itself moves
    when run on the CPU, which sums in another order); to convergence equal
    statuses on every lane, all converged, the certificate met. Returns
    (summary, max abs error at the caps, failures)."""
    from quasinewtonmethods_jl_tpu_torch.resident_solve import optimize_batched_resident_reference

    ls, stall = qt.BackTracking(), qt.STALL_LIMIT_DEFAULT
    worst_abs = worst_rel = 0.0
    failures, same_runs = [], 0
    for cap in SHORT_CAPS:
        kern = qt.optimize_batched_resident(model, X, ls=ls, tol=tol, max_iterations=cap,
                                            kernel="cuda")
        plain = optimize_batched_resident_reference(X, ls, tol, cap, True, stall, model)
        err_abs, err_rel = state_err(kern, plain)
        limit = KERNEL_RTOL[X.dtype]
        if X.dtype == torch.float32 and cap > 0:
            cpu = optimize_batched_resident_reference(X.cpu(), ls, tol, cap, True, stall, model)
            limit = max(limit, ROUNDING_FACTOR * state_err(cpu, plain)[1])
        same = bool(counters_equal(kern, plain).all())
        same_runs += same
        worst_abs, worst_rel = max(worst_abs, err_abs), max(worst_rel, err_rel)
        if not (same and err_rel <= limit):
            failures.append(f"{label} cap={cap}: counters equal {same}, normwise {err_rel:.3e} "
                            f"(limit {limit:.3e})")
    kern = qt.optimize_batched_resident(model, X, ls=ls, tol=tol, max_iterations=MAX_ITERS,
                                        kernel="cuda")
    plain = optimize_batched_resident_reference(X, ls, tol, MAX_ITERS, True, stall, model)
    statuses = bool(torch.equal(kern.status, plain.status))
    converged = bool(kern.converged.all()) and bool(plain.converged.all())
    gmax = max(float(kern.grad.abs().max()), float(plain.grad.abs().max()))
    if not (statuses and converged and gmax < tol):
        failures.append(f"{label} cap={MAX_ITERS}: statuses equal {statuses}, all converged "
                        f"{converged}, max|grad| {gmax:.3e} (tol {tol})")
    lanes = int((~counters_equal(kern, plain)).sum())
    summary = (f"{label}: caps {SHORT_CAPS} {same_runs}/{len(SHORT_CAPS)} runs with every counter "
               f"equal, max normwise {worst_rel:.3e}, max abs {worst_abs:.3e}; cap {MAX_ITERS} "
               f"statuses equal {statuses}, all converged {converged}, {lanes}/{X.shape[0]} lanes "
               f"with other counters")
    return summary, worst_abs, failures


def objective_phase(qt, device, smi):
    """B3 on the data-bearing objectives (see phase 20 above). Returns each
    new instantiation's (launches, max abs error, (ms, plain ms, bound ms,
    bound kind, library ms))."""
    from quasinewtonmethods_jl_tpu_torch.models import LogisticRegressionMAP
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import resident_occupancy

    t_phase = time.perf_counter()
    failures = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        tol = {"quadratic": TOL if dtype == torch.float32 else 1e-6,
               "logistic": LOGISTIC_TOL if dtype == torch.float32 else 1e-6}
        for kind, ns in (("quadratic", OBJECTIVE_NS[dtype]), ("logistic", (LOGISTIC_N,))):
            for n in ns:
                model, X = objective_fleet(kind, n, dtype, device)
                summary, _, bad = objective_parity(
                    qt, model, X, tol[kind], f"{kind} {OBJECTIVE_LANES}x{n} {name} tol {tol[kind]}")
                print(f"  B3 vs plain {summary}", file=sys.stderr)
                failures += bad

    # the full-width fleets, in float32
    Xd, yd, starts = logistic_data(np.random.default_rng(BENCH_SEED))
    logistic = LogisticRegressionMAP(LOGISTIC_N, LOGISTIC_OBS, prior_scale=LOGISTIC_PRIOR, X=Xd,
                                     y=yd, dtype=torch.float32, device=device)
    starts = torch.tensor(starts, dtype=torch.float32, device=device)
    quad, Xq = objective_fleet("quadratic", QUAD_N, torch.float32, device, batch=QUAD_BATCH)
    main_summary, main_err = {}, {}
    for kind, model, X, tol in (("logistic", logistic, starts, LOGISTIC_TOL),
                                ("quadratic", quad, Xq, TOL)):
        main_summary[kind], main_err[kind], bad = objective_parity(
            qt, model, X, tol, f"{kind} {X.shape[0]}x{X.shape[1]} f32 tol {tol}")
        failures += bad
    log(f"[objectives] B3 vs plain (the fleet engine with the plain update on the same model): "
        f"quadratic n in {OBJECTIVE_NS[torch.float32]} f32 / {OBJECTIVE_NS[torch.float64]} f64 and "
        f"logistic n={LOGISTIC_N} ({LOGISTIC_OBS} observations) f32/f64, {OBJECTIVE_LANES} lanes "
        f"each (rows on stderr); at full width: {main_summary['logistic']}; "
        f"{main_summary['quadratic']}")
    check(not failures, f"B3 and its plain version differ on the objectives: {failures}")

    # the slice's main path: both instantiations at full width, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    reset_counters(qt)
    res, flagged, wall = resident_run(qt, logistic, starts, LOGISTIC_TOL)
    peak = torch.cuda.max_memory_allocated(device) - base  # what the solve adds at its peak
    res_q, flagged_q, wall_q = resident_run(qt, quad, Xq, TOL)
    c = read_counters(qt)
    launches = dict(counted_kernels()["B3"].objective_launches)
    check(launches == {**dict.fromkeys(launches, 0), "quadratic": 1, "logistic": 1}
          and c["B3"] == 2
          and c["B1"] == c["B2a"] == c["B2b"] == 0, f"launches {launches}, {c}")
    check(flagged == flagged_q == 0, f"{flagged} + {flagged_q} host synchronisations inside the "
          "resident solves")
    converged, med, itmax, gmax = fleet_line(qt, res)
    check(converged == BATCH and gmax < LOGISTIC_TOL,
          f"logistic through B3: {converged}/{BATCH} converged, max|grad| {gmax}")
    check(abs(med - JAX_LOGISTIC_MEDIAN) <= 0.1 * JAX_LOGISTIC_MEDIAN,
          f"logistic through B3: median {med} not within 10% of {JAX_LOGISTIC_MEDIAN}")
    conv_q, med_q, max_q, gmax_q = fleet_line(qt, res_q)
    check(conv_q == QUAD_BATCH and gmax_q < TOL,
          f"quadratic through B3: {conv_q}/{QUAD_BATCH} converged, max|grad| {gmax_q}")
    fleet = qt.optimize_batched(logistic, starts, tol=LOGISTIC_TOL, max_iterations=MAX_ITERS)
    conv_f, med_f, max_f, gmax_f = fleet_line(qt, fleet)
    check(conv_f == BATCH and gmax_f < LOGISTIC_TOL,
          f"logistic through the fleet engine: {conv_f}/{BATCH} converged, max|grad| {gmax_f}")
    check(abs(med_f - JAX_LOGISTIC_MEDIAN) <= 0.1 * JAX_LOGISTIC_MEDIAN,
          f"logistic through the fleet engine: median {med_f} not within 10% of "
          f"{JAX_LOGISTIC_MEDIAN}")
    log(f"[objectives] logistic MAP (BASELINE config 3: n={LOGISTIC_N}, {LOGISTIC_OBS} "
        f"observations, prior scale {LOGISTIC_PRIOR}) {BATCH} starts f32 tol {LOGISTIC_TOL} on "
        f"{device}: optimize_batched_resident launches B3[logistic] {launches['logistic']} (B1/B2 "
        f"0), host synchronisations {flagged}, converged {converged}/{BATCH}, iterations median "
        f"{med:g} max {itmax}, max|grad| {gmax:.3e}, wall {wall:.3f}s (first call), memory the "
        f"solve adds at its peak {peak / 2**20:.1f} MiB (B {BATCH * LOGISTIC_N ** 2 * 4 / 2**20:.1f} "
        f"MiB); "
        f"optimize_batched (B1) converged {conv_f}/{BATCH}, median {med_f:g} max {max_f}; JAX "
        f"package: median {JAX_LOGISTIC_MEDIAN} max {JAX_LOGISTIC_MAX}. Quadratic "
        f"{QUAD_BATCH}x{QUAD_N} f32 condition {QUAD_CONDITION:g} tol {TOL}: B3[quadratic] "
        f"{launches['quadratic']} launch, {flagged_q} host synchronisations, converged "
        f"{conv_q}/{QUAD_BATCH}, iterations median {med_q:g} max {max_q}, wall {wall_q:.3f}s")

    ms = per_call_ms({
        "B3": lambda: qt.optimize_batched_resident(logistic, starts, tol=LOGISTIC_TOL,
                                                   max_iterations=MAX_ITERS),
        "B1": lambda: qt.optimize_batched(logistic, starts, tol=LOGISTIC_TOL,
                                          max_iterations=MAX_ITERS, kernel="cuda"),
        "plain": lambda: qt.optimize_batched(logistic, starts, tol=LOGISTIC_TOL,
                                             max_iterations=MAX_ITERS, kernel="torch"),
    }, (), rounds=3, calls=1)
    ms_q = per_call_ms({
        "B3": lambda: qt.optimize_batched_resident(quad, Xq, tol=TOL, max_iterations=MAX_ITERS),
        "plain": lambda: qt.optimize_batched(quad, Xq, tol=TOL, max_iterations=MAX_ITERS,
                                             kernel="torch"),
    }, (), rounds=2, calls=1)
    bound_l = b3_bound(res, LOGISTIC_N, 4, True, logistic)
    bound_q = b3_bound(res_q, QUAD_N, 4, True, quad)
    log(f"[time] logistic {BATCH}x{LOGISTIC_N} f32 per solve (CUDA events, median of 3 in "
        f"turns): B3 {ms['B3']:.4f} ms ({1e3 * BATCH / ms['B3']:.1f} solves/s), fleet engine "
        f"with B1 {ms['B1']:.4f} ms ({1e3 * BATCH / ms['B1']:.1f} solves/s), with the plain update "
        f"{ms['plain']:.4f} ms; B3's bound {bound_l[0]:.4f} ms ({bound_l[1]} the solve needs), B3 "
        f"at {100 * bound_l[0] / ms['B3']:.1f} % of it; launch "
        f"{shape_line(resident_occupancy(LOGISTIC_N, 4, logistic))}. Quadratic "
        f"{QUAD_BATCH}x{QUAD_N} f32 (median of 2): B3 {ms_q['B3']:.4f} ms, plain "
        f"{ms_q['plain']:.4f} ms; bound {bound_q[0]:.4f} ms ({bound_q[1]}), B3 at "
        f"{100 * bound_q[0] / ms_q['B3']:.1f} %; launch "
        f"{shape_line(resident_occupancy(QUAD_N, 4, quad))} on {smi}")

    x0 = torch.zeros(LOGISTIC_N, dtype=torch.float32, device=device)
    scalar, c, syncs, wall_s = counted_run(
        qt, lambda: qt.optimize(logistic, x0, tol=LOGISTIC_TOL), "scalar_syncs")
    iters = int(scalar.iterations)
    check(int(scalar.status) == qt.Status.CONVERGED and float(scalar.grad.abs().max()) < LOGISTIC_TOL,
          f"scalar optimize on the logistic: {qt.Status(int(scalar.status)).name}")
    check(abs(iters - JAX_LOGISTIC_SCALAR_ITERS) <= 0.1 * JAX_LOGISTIC_SCALAR_ITERS,
          f"scalar optimize on the logistic: {iters} iterations, JAX {JAX_LOGISTIC_SCALAR_ITERS}")
    log(f"[objectives] optimize on the logistic (config 3) from zeros({LOGISTIC_N}) f32 tol "
        f"{LOGISTIC_TOL} on {scalar.x.device}: CONVERGED in {iters} iterations (JAX package: "
        f"{JAX_LOGISTIC_SCALAR_ITERS}), n_fev {int(scalar.n_fev)}, {syncs} host syncs, all "
        f"counted, {wall_s:.3f} s per solve; phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return {
        "quadratic": (launches["quadratic"], main_err["quadratic"],
                      (ms_q["B3"], ms_q["plain"], *bound_q, None)),
        "logistic": (launches["logistic"], main_err["logistic"],
                     (ms["B3"], ms["plain"], *bound_l, None)),
    }



def fixture_data(name):
    """A full-width fixture's data and its fleet's starts, float64 numpy,
    from a fresh generator seeded BENCH_SEED, drawn in the order
    scripts/jax_fixture_reference.py draws them (see phase 21 above)."""
    rng = np.random.default_rng(BENCH_SEED)
    if name == "funnel":
        return {"starts": rng.standard_normal((BATCH, FUNNEL_N))}
    if name == "mixture":
        means = 3.0 * rng.standard_normal((MIXTURE_K, MIXTURE_N))
        return {"means": means, "starts": 3.0 * rng.standard_normal((BATCH, MIXTURE_N))}
    if name == "poisson":
        X = rng.standard_normal((POISSON_OBS, POISSON_N)) / np.sqrt(POISSON_N)
        w_true = 0.5 * rng.standard_normal(POISSON_N)
        y = rng.poisson(np.exp(X @ w_true)).astype(np.float64)
        return {"X": X, "y": y, "starts": rng.standard_normal((BATCH, POISSON_N))}
    A, w_true, ys = ar1_data(rng, AR1_N, AR1_STEPS)
    return {"A": A, "ys": ys, "w_true": w_true, "starts": rng.standard_normal((BATCH, AR1_N))}


def ar1_data(rng, n, steps):
    """The AR(1)'s A scaled to AR1_RADIUS, w_true and the observations of
    the recursion from z_0 = 0 (models/statespace.py's recipe, in numpy)."""
    A = rng.standard_normal((n, n))
    A = A * (AR1_RADIUS / np.max(np.abs(np.linalg.eigvals(A))))
    w_true, z, zs = rng.standard_normal(n), np.zeros(n), []
    for _ in range(steps):
        z = A @ z + w_true
        zs.append(z)
    return A, w_true, np.stack(zs) + AR1_OBS_SCALE * rng.standard_normal((steps, n))


def fixture_model(name, data, dtype, device):
    """The port's model of fixture ``name`` on ``data`` (see
    `fixture_data`), its data on ``device`` in ``dtype``."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        AR1DriftMAP,
        GaussianMixture,
        PoissonRegressionMAP,
        funnel_logdensity,
    )

    if name == "funnel":
        return funnel_logdensity
    if name == "mixture":
        return GaussianMixture(data["means"], sigmas=MIXTURE_SIGMA, dtype=dtype, device=device)
    if name == "poisson":
        return PoissonRegressionMAP(data["X"].shape[1], data["X"].shape[0],
                                    prior_scale=POISSON_PRIOR, X=data["X"], y=data["y"],
                                    dtype=dtype, device=device)
    return AR1DriftMAP(data["A"].shape[0], data["ys"].shape[0], spectral_radius=AR1_RADIUS,
                       obs_scale=AR1_OBS_SCALE, prior_scale=AR1_PRIOR, A=data["A"],
                       ys=data["ys"], w_true=data["w_true"], dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def fixture_parity_fleet(name, n, dtype, device, batch=OBJECTIVE_LANES):
    """A parity fleet of fixture ``name`` at width n, from seed
    BENCH_SEED + n: the full-width recipe at that width (the mixture's 8
    components, the Poisson GLM's 400 observations, the AR(1)'s 32 steps)."""
    rng = np.random.default_rng(BENCH_SEED + n)
    data = {}
    if name == "mixture":
        data["means"] = 3.0 * rng.standard_normal((MIXTURE_K, n))
    elif name == "poisson":
        data["X"] = rng.standard_normal((POISSON_OBS, n)) / np.sqrt(n)
        data["y"] = rng.poisson(np.exp(data["X"] @ (0.5 * rng.standard_normal(n)))).astype(float)
    elif name == "ar1":
        data["A"], data["w_true"], data["ys"] = ar1_data(rng, n, AR1_STEPS)
    scale = 3.0 if name == "mixture" else 1.0
    X = torch.tensor(scale * rng.standard_normal((batch, n)), dtype=dtype, device=device)
    return fixture_model(name, data, dtype, device), X


@functools.lru_cache(maxsize=None)
def fixture_fleets(device):
    """Phase 21's full-width fleets: key -> (model, starts, tol), made once
    (the plain runs made ahead on them are taken by the model's identity)."""
    fleets = {}
    for key, (name, dtype, tol, *_) in FIXTURE_FLEETS.items():
        data = fixture_data(name)
        fleets[key] = (fixture_model(name, data, dtype, device),
                       torch.tensor(data["starts"], dtype=dtype, device=device), tol)
    return fleets


def fixture_parity_cases():
    """Phase 21's parity fleets, in order: (name, n, dtype, tol, whole)."""
    return [(name, n, dtype, FIXTURE_TOL[name][dtype], i < 2)
            for name, (ns, dtypes) in FIXTURE_PARITY.items() for dtype in dtypes
            for i, n in enumerate(ns)]


def fixture_parity(qt, model, X, tol, label, whole=True):
    """B3's instantiation for ``model`` against its plain version on the
    fleet ``X`` (phase 9's method): over caps 0, 1 and 5 every counter equal
    on every lane and x, grad and B normwise within EXACT_RTOL (1e-10 in
    f64, 1e-5 in f32) or, where more, within ROUNDING_FACTOR times what the
    plain version itself moves when run on the CPU (the funnel's curvature,
    up to e^{4.5(n-1)}, grows a last-bit difference by orders of magnitude
    within 5 iterations, in float64 too); with ``whole``, over whole solves
    every converged lane
    certified, and the lanes whose status differs from the plain run's at
    most ROUNDING_FACTOR times as many as a change of rounding alone gives
    the plain version, the largest count of three witnesses (the run from
    x0 one ulp up, one ulp down, and the run on the CPU; taken only where
    some lane differs). Returns (summary, max abs error at the caps,
    failures)."""
    ls, stall = qt.BackTracking(), qt.STALL_LIMIT_DEFAULT
    worst_abs = worst_rel = worst_cpu = 0.0
    failures, same_runs = [], 0
    for cap in SHORT_CAPS:
        kern = qt.optimize_batched_resident(model, X, ls=ls, tol=tol, max_iterations=cap,
                                            kernel="cuda")
        plain = plain_reference(X, ls, tol, cap, True, stall, model)
        err_abs, err_rel = state_err(kern, plain)
        limit = EXACT_RTOL[X.dtype]
        same = bool(counters_equal(kern, plain).all())
        if cap > 0 and same and err_rel > limit:  # a cap within EXACT_RTOL needs no witness
            cpu = plain_reference(X.cpu(), ls, tol, cap, True, stall, model)
            witness = state_err(cpu, plain)[1]
            worst_cpu = max(worst_cpu, witness)
            limit = max(limit, ROUNDING_FACTOR * witness)
        same_runs += same
        worst_abs, worst_rel = max(worst_abs, err_abs), max(worst_rel, err_rel)
        if not (same and err_rel <= limit):
            failures.append(f"{label} cap={cap}: counters equal {same}, normwise {err_rel:.3e} "
                            f"(limit {limit:.3e})")
    summary = (f"{label}: caps {SHORT_CAPS} {same_runs}/{len(SHORT_CAPS)} runs with every counter "
               f"equal, max normwise {worst_rel:.3e} (the CPU's run, made where a cap exceeds "
               f"{EXACT_RTOL[X.dtype]:.0e}, moves the plain version {worst_cpu:.3e}), max abs "
               f"{worst_abs:.3e}")
    if not whole:
        return summary, worst_abs, failures
    kern = qt.optimize_batched_resident(model, X, ls=ls, tol=tol, max_iterations=MAX_ITERS,
                                        kernel="cuda")

    def plain_run(x0):
        return plain_reference(x0, ls, tol, MAX_ITERS, True, stall, model)

    ulps = ulp_starts(X)  # the plain run and its two one-ulp witnesses as one fleet
    plain, *ulp_runs = stacked_runs(plain_run, X, *ulps.values())
    flips = int((kern.status != plain.status).sum())
    witness_flips = {}
    if flips:
        for key, other in (*zip(ulps, ulp_runs), ("CPU", plain_run(X.cpu()))):
            witness_flips[key] = int((other.status.to(X.device) != plain.status).sum())
    ok = kern.status == qt.Status.CONVERGED
    gmax = float(kern.grad[ok].abs().max()) if bool(ok.any()) else 0.0
    if flips > ROUNDING_FACTOR * max(witness_flips.values(), default=0) or gmax >= tol:
        failures.append(f"{label} cap={MAX_ITERS}: {flips} lanes with another status than the "
                        f"plain run's (rounding witnesses {witness_flips}), max|grad| of the "
                        f"converged {gmax:.3e} (tol {tol})")
    lanes = int((~counters_equal(kern, plain)).sum())
    summary += (f"; cap {MAX_ITERS}: converged {int(ok.sum())}/{X.shape[0]} (plain "
                f"{int((plain.status == qt.Status.CONVERGED).sum())}), lanes with another status "
                f"{flips}" + (f" (witnesses {witness_flips})" if flips else "")
                + f", with other counters {lanes}")
    return summary, worst_abs, failures


def fixture_phase(qt, device, smi):
    """B3 on the fixture families (see phase 21 above). Returns each new
    instantiation's (launches, max abs error, (ms, plain ms, bound ms,
    bound kind, library ms))."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        IllConditionedQuadratic,
        LogisticRegressionMAP,
    )
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import resident_occupancy

    t_phase = time.perf_counter()
    failures = []
    for name, n, dtype, tol, whole in fixture_parity_cases():
        model, X = fixture_parity_fleet(name, n, dtype, device)
        summary, _, bad = fixture_parity(
            qt, model, X, tol, f"{name} {OBJECTIVE_LANES}x{n} "
            f"{str(dtype).replace('torch.', '')} tol {tol}", whole=whole)
        print(f"  B3 vs plain {summary}", file=sys.stderr)
        failures += bad

    fleets = fixture_fleets(device)
    main_summary, main_err = {}, {}
    for key, (model, X, tol) in fleets.items():
        main_summary[key], main_err[key], bad = fixture_parity(
            qt, model, X, tol, f"{key} {X.shape[0]}x{X.shape[1]} tol {tol}")
        print(f"  B3 vs plain {main_summary[key]}", file=sys.stderr)
        failures += bad
    log(f"[fixtures] B3 vs plain (the fleet engine with the plain update on the same model), "
        f"{OBJECTIVE_LANES} lanes at n in "
        + "; ".join(f"{k} {ns} {'/'.join(str(d).replace('torch.', '') for d in dts)}"
                    for k, (ns, dts) in FIXTURE_PARITY.items())
        + " (rows on stderr); at full width: " + "; ".join(main_summary.values()))
    check(not failures, f"B3 and its plain version differ on the fixtures: {failures}")

    # the slice's main path: the five full-width fleets through B3 and B1, counted
    torch.cuda.synchronize()
    reset_counters(qt)
    resident, fleet, lines, b1_ms = {}, {}, [], {}
    for key, (model, X, tol) in fleets.items():
        res, flagged, wall = resident_run(qt, model, X, tol)
        check(flagged == 0, f"{key}: {flagged} host synchronisations inside the resident solve")
        resident[key] = (res, wall)
        # the counted B1 run is the one timed (CUDA events around the call)
        b1_ms[key] = time_calls(lambda: fleet.update({key: qt.optimize_batched(
            model, X, tol=tol, max_iterations=MAX_ITERS)}), (), calls=1)
    c = read_counters(qt)
    launches = dict(counted_kernels()["B3"].objective_launches)
    check(launches == {**dict.fromkeys(launches, 0), "funnel": 1, "mixture": 1, "poisson": 2,
                       "ar1": 1} and c["B3"] == 5
          and c["B2a"] == c["B2b"] == 0 and c["B1"] == c["bodies"] > 0,
          f"launches {launches}, {c}")
    for key, (name, dtype, tol, jax_conv, jax_med, jax_max) in FIXTURE_FLEETS.items():
        for engine, res in (("B3", resident[key][0]), ("B1", fleet[key])):
            conv = int((res.status == qt.Status.CONVERGED).sum())
            iters = res.iterations.cpu().numpy()
            med = float(np.median(iters))
            in_band = bool(((res.status == qt.Status.CONVERGED)
                            | (res.status == qt.Status.LINESEARCH_FAILURE)).all())
            ok = res.status == qt.Status.CONVERGED
            gmax = float(res.grad[ok].abs().max()) if conv else 0.0
            p = fewer_converged_p(conv, jax_conv, BATCH)
            lines.append(f"{key} through {engine}: converged {conv}/{BATCH} (JAX {jax_conv}, "
                         f"one-sided Fisher p = {p:.3f}), iterations median {med:g} max "
                         f"{int(iters.max())} (JAX {jax_med:g} / {jax_max}), max|grad| of the "
                         f"converged {gmax:.3e}")
            check(in_band and gmax < tol, f"{key} through {engine}: a status out of band or "
                  f"a converged lane not certified (max|grad| {gmax})")
            if jax_conv == BATCH:
                check(conv == BATCH, f"{key} through {engine}: {conv}/{BATCH} converged")
            check(p >= 0.01, f"{key} through {engine}: {conv} converged against JAX's "
                  f"{jax_conv}: fewer than chance allows (p = {p:.4f})")
            check(abs(med - jax_med) <= 0.1 * jax_med,
                  f"{key} through {engine}: median {med} not within 10% of {jax_med}")
    log(f"[fixtures] full-width fleets of {BATCH} starts on {device}: optimize_batched_resident "
        f"launches B3 {c['B3']} ({', '.join(f'{k} {v}' for k, v in launches.items() if v)}), "
        f"host synchronisations 0 in each; optimize_batched B1 {c['B1']} = loop bodies "
        f"{c['bodies']}; " + "; ".join(lines))

    records, timings = {}, []
    for key, (model, X, tol) in fleets.items():
        name, dtype = FIXTURE_FLEETS[key][:2]
        itemsize = X.element_size()
        ms = per_call_ms({
            "B3": lambda: qt.optimize_batched_resident(model, X, tol=tol,
                                                       max_iterations=MAX_ITERS),
        }, (), rounds=2, calls=1)
        # the fleet engine takes seconds a solve: B1's counted run, and one plain call
        ms.update(per_call_ms({
            "plain": lambda: qt.optimize_batched(model, X, tol=tol, max_iterations=MAX_ITERS,
                                                 kernel="torch"),
        }, (), rounds=1, calls=1, warmup=False), B1=b1_ms[key])
        b = b3_bound(resident[key][0], X.shape[1], itemsize, True, model)
        timings.append(
            f"{key} {BATCH}x{X.shape[1]}: B3 {ms['B3']:.4f} ms ({1e3 * BATCH / ms['B3']:.1f} "
            f"solves/s), fleet engine with B1 {ms['B1']:.4f} ms, with the plain update "
            f"{ms['plain']:.4f} ms; B3's bound {b[0]:.4f} ms ({b[1]}), B3 at "
            f"{100 * b[0] / ms['B3']:.1f} %; launch "
            f"{shape_line(resident_occupancy(X.shape[1], itemsize, model))}")
        if name not in records:  # the first fleet of each instantiation (Poisson: f32)
            records[name] = (launches[name], main_err[key], (ms["B3"], ms["plain"], *b, None))
        else:
            records[name] = (launches[name], max(records[name][1], main_err[key]),
                             records[name][2])
    log(f"[time] fixture fleets per solve (CUDA events; B3 median of 2 in turns, the fleet "
        f"engine one call each): "
        + "; ".join(timings) + f" on {smi}")

    # registers of every instantiation at its full-width n (ptxas's count)
    shapes = {"rosenbrock": (N, None), "quadratic": (QUAD_N, IllConditionedQuadratic(3)),
              "logistic": (LOGISTIC_N, LogisticRegressionMAP(3, 5))}
    shapes.update({FIXTURE_FLEETS[k][0]: (fleets[k][1].shape[1], fleets[k][0])
                   for k in FIXTURE_FLEETS})
    # (f64 at n <= 165, the largest that fits: the quadratic's 236 does not)
    regs = [f"{name} n={n} " + "/".join(
        str(resident_occupancy(min(n, 165) if size == 8 else n, size, model)["registers"])
        for size in (4, 8)) for name, (n, model) in shapes.items()]
    log(f"[fixtures] B3 registers per thread (f32/f64, cudaFuncGetAttributes = ptxas's count): "
        f"{', '.join(regs)}; phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return records


def dense_quadratic_data(rng, n=DENSE_QUAD_N, batch=DENSE_QUAD_BATCH):
    """ROADMAP B.1's dense quadratic form's Q, b and starts, float64 numpy,
    drawn as scripts/jax_traced_reference.py draws them: U from the QR of
    N(0, 1), Q = U diag(logspace(-4, 0, n)) Uᵀ, b = Q x* for x* ~ N(0, 1),
    then the starts N(0, 1)."""
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Q = (U * np.logspace(-4.0, 0.0, n)) @ U.T
    b = Q @ rng.standard_normal(n)
    return Q, b, rng.standard_normal((batch, n))


def dense_quadratic(Q, b, dtype, device):
    Qt = torch.tensor(Q, dtype=dtype, device=device)
    bt = torch.tensor(b, dtype=dtype, device=device)
    return lambda x: -0.5 * x @ (Qt @ x) + bt @ x


def hierarchical_data(rng, groups=HIER_GROUPS, q=HIER_Q, p=HIER_P, n_obs=HIER_OBS):
    """X, Z, group, y, beta_true and u_true of the hierarchical model, float64
    numpy, drawn as the JAX model's recipe draws them
    (quasinewtonmethods_jl_tpu/models/hierarchical.py:74-91) and as
    scripts/jax_hierarchical_reference.py does."""
    X = rng.standard_normal((n_obs, p))
    Z = np.concatenate([np.ones((n_obs, 1)), rng.standard_normal((n_obs, q - 1))], axis=1)
    group = rng.integers(0, groups, n_obs)
    beta_true = rng.standard_normal(p)
    u_true = np.array([0.8] + [0.5] * (q - 1)) * rng.standard_normal((groups, q))
    y = X @ beta_true + np.sum(Z * u_true[group], axis=1) + 0.5 * rng.standard_normal(n_obs)
    return {"X": X, "Z": Z, "group": group, "y": y, "beta_true": beta_true, "u_true": u_true}


def hierarchical_objective(rng, q, dtype, device, batch):
    """The transformed hierarchical model on `hierarchical_data` of ``rng``
    and ``batch`` starts unconstrain(initial_point()) + 0.5·N(0, 1) from it,
    numpy float64."""
    from quasinewtonmethods_jl_tpu_torch.models import HierarchicalRegression
    from quasinewtonmethods_jl_tpu_torch.transforms import transform_objective

    data = hierarchical_data(rng, q=q)
    model = HierarchicalRegression(HIER_GROUPS, q, HIER_P, HIER_OBS, lkj_eta=HIER_ETA,
                                   dtype=dtype, device=device, **data)
    obj = transform_objective(model, model.transform)
    z0 = obj.unconstrain(model.initial_point()).double().cpu().numpy()
    return obj, z0 + 0.5 * rng.standard_normal((batch, z0.shape[0]))


def hierarchical_ops(n, n_obs=HIER_OBS, groups=HIER_GROUPS, q=HIER_Q, p=HIER_P, itemsize=4):
    """`objective_ops` of the transformed hierarchical model over its
    ``n`` unconstrained parameters (p + Jq + q + 1 + q(q - 1)/2), as the
    function states it (exp, log, log1p, tanh and a division one each). A
    trial value: the transform (exp of the q + 1 scales and their log-det
    sum 2(q + 1); the correlation factor about 14 per entry of its q x q
    matrix: tanh, log(1 - tanh²) 5, the masks, the exclusive cumsum 2,
    exp(c/2) 2, the log-det sum), x + αd 2n; the effects e Lᵀ 2Jq² and ·τ
    Jq; per observation Z·u[g] and its row sum 2q, X β 2p, the mean, the
    residual, its square and sum 4; the priors and the LKJ term 2p + 2Jq +
    4q + 4 + 3q, the likelihood's scale 6. A value and gradient adds the
    backward: per observation the residual's scaling 1, Xᵀ of it 2p, the
    effects' products 2q (Z·dmean and its sum into u[g]); per group the
    effects' backward 4q² + 2q (through e Lᵀ and τ), the priors' p + Jq +
    4q, the transform's backward as much as its forward, and the tolerance
    test n. Data: X, Z, y in the solve's dtype and the groups as int32."""
    transform = 2 * (q + 1) + 14 * q * q
    trial = (2 * n + transform + 2 * groups * q * q + groups * q
             + n_obs * (2 * q + 2 * p + 4) + 2 * p + 2 * groups * q + 7 * q + 10)
    vag = (trial - 2 * n + n_obs * (2 * p + 2 * q + 1) + groups * (4 * q * q + 2 * q)
           + p + groups * q + 4 * q + transform + n)
    return vag, trial, n_obs * (p + q + 1) * itemsize + 4 * n_obs


def traced_case(kind, n, dtype, device):
    """(objective, value_and_grad_fn, numpy starts) of parity case ``kind`` at
    width n, its data drawn with numpy from seed BENCH_SEED + n and put on
    ``device`` in ``dtype`` (so that the plain version runs on the CPU too)."""
    from quasinewtonmethods_jl_tpu_torch import transforms as tt
    from quasinewtonmethods_jl_tpu_torch.models import (
        AR1DriftMAP,
        GaussianMixture,
        LogisticRegressionMAP,
        funnel_logdensity,
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    rng = np.random.default_rng(BENCH_SEED + n)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    vgf, scale = None, 1.0
    if kind == "quadratic with b":
        A = rng.standard_normal((n, n))
        Q, b = t(A @ A.T / n + np.eye(n)), t(rng.standard_normal(n))
        obj = lambda x: -0.5 * x @ (Q @ x) + b @ x  # noqa: E731
    elif kind == "dense quadratic":
        Q, b, _ = dense_quadratic_data(rng, n, 0)
        obj = dense_quadratic(Q, b, dtype, device)
    elif kind == "logsumexp":
        c = t(rng.standard_normal(n))
        obj = lambda x: -torch.logsumexp(x * x + c, 0) - 0.01 * torch.sum(x * x)  # noqa: E731
    elif kind == "nan where":  # starts with |x|² about 5, NaN beyond 9
        obj = lambda x: torch.where(torch.sum(x * x) > 9.0, torch.nan, -torch.sum(x * x))  # noqa
        scale = 0.3
    elif kind == "logistic with logaddexp":
        Xd, yd, zero = t(rng.standard_normal((200, n))), t(rng.random(200) < 0.5), t(0.0)

        def obj(w):
            z = Xd @ w
            return torch.sum(yd * z - torch.logaddexp(zero, z)) - 0.5 * torch.sum(w * w)
    elif kind.startswith("rosenbrock"):
        obj = lambda x: rosenbrock_logdensity(x)  # noqa: E731
        vgf = rosenbrock_value_and_grad if "value_and_grad_fn" in kind else None
    elif kind.startswith("mixture"):
        obj = GaussianMixture(3.0 * rng.standard_normal((MIXTURE_K, n)), sigmas=MIXTURE_SIGMA,
                              dtype=dtype, device=device).logdensity
        scale = 3.0
    elif kind.startswith("logistic"):
        Xd = rng.standard_normal((LOGISTIC_OBS, n)) / np.sqrt(n)
        yd = (rng.random(LOGISTIC_OBS) < 1.0 / (1.0 + np.exp(-(Xd @ rng.standard_normal(n)))))
        obj = LogisticRegressionMAP(n, LOGISTIC_OBS, prior_scale=LOGISTIC_PRIOR, X=Xd,
                                    y=yd.astype(np.float64), dtype=dtype, device=device).logdensity
    elif kind.startswith("ar1"):
        A, w_true, ys = ar1_data(rng, n, AR1_STEPS)
        obj = AR1DriftMAP(n, AR1_STEPS, spectral_radius=AR1_RADIUS, obs_scale=AR1_OBS_SCALE,
                          prior_scale=AR1_PRIOR, A=A, ys=ys, w_true=w_true, dtype=dtype,
                          device=device).logdensity
    elif kind == "funnel in a lambda":
        obj = lambda th: funnel_logdensity(th)  # noqa: E731
    elif kind == "funnel with value_and_grad_fn":
        obj = funnel_logdensity
        vgf = lambda th: torch.func.grad_and_value(funnel_logdensity)(th)[::-1]  # noqa: E731
    elif kind.startswith("hierarchical"):
        obj, starts = hierarchical_objective(rng, int(kind[-1]), dtype, device, OBJECTIVE_LANES)
        check(starts.shape[1] == n, f"{kind}: n = {starts.shape[1]}, not {n}")
        return obj, None, starts
    elif kind in ("interval and simplex", "ordered and cov cholesky", "corr cholesky"):
        obj = transformed_density(tt, kind, n, rng, t)
    elif kind == "gather with repeats":  # a gather whose backward is a put with accumulate
        idx = torch.tensor(rng.integers(0, n, 8 * n), device=device)
        c = t(rng.standard_normal(8 * n))
        obj = lambda x: (-torch.sum((x[idx] - c) ** 2) + 0.1 * torch.sum(torch.tanh(x))  # noqa
                         - 0.1 * torch.sum(torch.log1p(x * x)))
    else:
        raise AssertionError(kind)
    return obj, vgf, scale * rng.standard_normal((OBJECTIVE_LANES, n))


def transformed_density(tt, kind, n, rng, t):
    """A transformed density of known mode at width n: a Gaussian around an
    interior point of an Interval block and a Dirichlet on a Simplex; a
    Gaussian around an increasing vector of an Ordered block and around the
    packed factor of a CovCholesky; a Gaussian around the packed factor of
    a CorrCholesky (each target the forward map of a random z)."""
    if kind == "interval and simplex":
        a = n // 2
        blocks = [tt.Interval(a, lo=-1.0, hi=3.0), tt.Simplex(n - a + 1)]
        c, alpha = t(rng.uniform(-0.5, 2.5, a)), t(1.0 + 3.0 * rng.random(n - a + 1))

        def density(x):
            return -0.5 * torch.sum((x[:a] - c) ** 2) + torch.sum((alpha - 1.0) * torch.log(x[a:]))
    else:
        if kind == "ordered and cov cholesky":
            d = 6
            blocks = [tt.Ordered(n - d * (d + 1) // 2), tt.CovCholesky(d)]
        else:
            d = int(round((1 + math.sqrt(1 + 8 * n)) / 2))
            blocks = [tt.CorrCholesky(d)]
        block = tt.BlockTransform(blocks)
        target = t(block.forward(torch.tensor(rng.standard_normal(n))).numpy())

        def density(x):
            return -0.5 * torch.sum((x - target) ** 2)
    block = tt.BlockTransform(blocks)
    check(block.unconstrained_size == n, f"{kind}: n = {block.unconstrained_size}, not {n}")
    return tt.transform_objective(density, block)


def ulp_starts(X):
    """``X`` one ulp up and one ulp down."""
    return {"1 ulp up": torch.nextafter(X, torch.full_like(X, float("inf"))),
            "1 ulp down": torch.nextafter(X, torch.full_like(X, float("-inf")))}


def traced_parity(qt, traced, X, tol, label, cpu_traced, cpu_whole=True, chaotic=False,
                  walls=None):
    """B3 on ``traced`` against its plain version (the fleet engine with the
    plain update on the user's functions) on the fleet ``X``, phase 9's
    method: over caps 0, 1 and 5 every counter equal on every lane and x,
    grad and B normwise within EXACT_RTOL or, where more, ROUNDING_FACTOR
    times what a change of rounding alone moves the plain version: its run
    on the CPU (``cpu_traced``, the same objective there), measured on the
    lanes where that run's own counters equal the plain run's (a lane that
    takes another line-search decision there moves by a step, not by
    rounding). Over whole solves the lanes whose status differs from the
    plain run's are at most ROUNDING_FACTOR times as many as a change of
    rounding gives the plain version (started one ulp up, one ulp down,
    and with ``cpu_whole`` on the CPU). With ``chaotic`` (an objective on
    which rounding alone changes lanes' counters within the caps: phase
    23's hierarchical model), the caps take the whole solves' witnesses
    too: the plain version on the CPU and started one ulp up and down; B3
    may have other counters on at most ROUNDING_FACTOR times as many lanes
    as the witness with the most (none where no witness has any), and its
    floats, on the lanes where its counters are the plain run's, are held
    to ROUNDING_FACTOR times the largest witness's movement. With ``walls``
    (a dict), the plain version's whole solve is timed by CUDA events into
    ``walls["plain"]`` (ms). Returns (summary, max abs error at the caps,
    failures)."""
    from quasinewtonmethods_jl_tpu_torch.resident_solve import optimize_batched_resident_reference

    ls, stall = qt.BackTracking(), qt.STALL_LIMIT_DEFAULT

    def plain_run(x0, cap, objective=traced):
        return plain_reference(x0, ls, tol, cap, True, stall, objective)

    worst_abs, failures, same_runs, per_cap = 0.0, [], 0, []
    for cap in SHORT_CAPS:
        kern = qt.optimize_batched_resident(traced, X, ls=ls, tol=tol, max_iterations=cap,
                                            kernel="cuda")
        plain = plain_run(X, cap)
        kept_by_kernel = counters_equal(kern, plain)
        same = bool(kept_by_kernel.all())
        other = int((~kept_by_kernel).sum())
        limit, moved, kept, allowed, witness = EXACT_RTOL[X.dtype], 0.0, X.shape[0], 0, ""
        err_abs, err_rel = state_err(kern, plain, kept_by_kernel if chaotic else None)
        # the witnesses only raise the limits above EXACT_RTOL and no other
        # counters: a cap within them needs none
        needed = cap > 0 and not (same and err_rel <= limit)
        if needed:
            witnesses = {"CPU": plain_run(X.cpu(), cap, cpu_traced)}
            if chaotic:
                witnesses.update({k: plain_run(x0, cap) for k, x0 in ulp_starts(X).items()})
            moves = {}
            for key, run in witnesses.items():
                followed = counters_equal(run, plain)
                moves[key] = (state_err(run, plain, followed)[1], int(followed.sum()))
            moved, kept = moves["CPU"]
            if chaotic:
                moved = max(m for m, _ in moves.values())
                allowed = ROUNDING_FACTOR * max(X.shape[0] - k for _, k in moves.values())
                witness = "; the witnesses " + ", ".join(
                    f"{k} moves it {m:.3e} and keeps its counters on {n} lanes"
                    for k, (m, n) in moves.items())
            limit = max(limit, ROUNDING_FACTOR * moved)
        same_runs += same
        worst_abs = max(worst_abs, err_abs)
        per_cap.append(f"cap {cap} {err_rel:.3e} (limit {limit:.3e}" + (
            witness + ")" if chaotic and needed else
            f"; the CPU's run moves the plain version {moved:.3e} on its {kept} lanes with the "
            f"plain run's counters)" if needed else "; within it, no witness run)" if cap > 0
            else ")")
            + (f" with other counters on {other} lanes" + (f" (allowed {allowed})" if chaotic
                                                           else "") if other else ""))
        if not ((same or other <= allowed) and err_rel <= limit):
            failures.append(f"{label} cap={cap}: counters equal {same} (other on {other} lanes, "
                            f"allowed {allowed}), normwise {err_rel:.3e} (limit {limit:.3e}"
                            + (witness if chaotic else
                               f": the CPU's run moves the plain version {moved:.3e} on its "
                               f"{kept} lanes with the plain run's counters") + ")")
    kern = qt.optimize_batched_resident(traced, X, ls=ls, tol=tol, max_iterations=MAX_ITERS,
                                        kernel="cuda")
    ulps = ulp_starts(X)

    def whole(x0):
        return plain_run(x0, MAX_ITERS)

    if walls is None:  # the plain run and its two one-ulp witnesses as one fleet
        plain, *ulp_runs = stacked_runs(whole, X, *ulps.values())
    else:  # the plain run alone, timed (never one made ahead); its witnesses, where needed,
        walls["plain"] = time_calls(lambda: walls.update(  # as one fleet
            run=optimize_batched_resident_reference(X, ls, tol, MAX_ITERS, True, stall, traced)),
            (), calls=1)
        plain, ulp_runs = walls.pop("run"), None
    flips = int((kern.status != plain.status).sum())
    witness_flips = {}
    if flips:
        ulp_runs = ulp_runs or stacked_runs(whole, *ulps.values())
        others = dict(zip(ulps, ulp_runs))
        if cpu_whole:
            others["CPU"] = plain_run(X.cpu(), MAX_ITERS, cpu_traced)
        for key, other in others.items():
            witness_flips[key] = int((other.status.to(X.device) != plain.status).sum())
    ok = kern.status == qt.Status.CONVERGED
    gmax = float(kern.grad[ok].abs().max()) if bool(ok.any()) else 0.0
    if flips > ROUNDING_FACTOR * max(witness_flips.values(), default=0) or gmax >= tol:
        failures.append(f"{label} cap={MAX_ITERS}: {flips} lanes with another status than the "
                        f"plain run's (rounding witnesses {witness_flips}), max|grad| of the "
                        f"converged {gmax:.3e} (tol {tol})")
    lanes = int((~counters_equal(kern, plain)).sum())
    summary = (f"{label}: caps {SHORT_CAPS} {same_runs}/{len(SHORT_CAPS)} runs with every counter "
               f"equal on every lane, normwise " + ", ".join(per_cap)
               + f", max abs {worst_abs:.3e}; "
               f"cap {MAX_ITERS}: converged {int(ok.sum())}/{X.shape[0]} (plain "
               f"{int(plain.converged.sum())}), lanes with another status {flips}"
               + (f" (witnesses {witness_flips})" if flips else "")
               + f", with other counters {lanes}")
    return summary, worst_abs, failures


def ptxas_spills(log):
    """(registers, spill store bytes, spill load bytes) of the traced
    kernel's entry in nvcc's -Xptxas -v output."""
    regs = spill_st = spill_ld = None
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "resident_solve_kernel" in line:
            for follow in lines[i + 1:i + 4]:
                if "spill stores" in follow:
                    words = follow.replace(",", "").split()
                    spill_st = int(words[words.index("spill") - 2])
                    spill_ld = int(words[words.index("loads") - 3])
                if "Used" in follow and "registers" in follow:
                    words = follow.replace(",", "").split()
                    regs = int(words[words.index("registers") - 1])
    return regs, spill_st, spill_ld


def traced_fleets(device):
    """The four full-width fleets (see phase 22 above): {name: (objective,
    float32 starts, tol, hand-written instantiation or None, what a value
    and gradient and a trial need: `objective_ops` of the hand-written
    twin, `dense_quadratic_ops` of the dense quadratic)}."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        GaussianMixture,
        LogisticRegressionMAP,
        rosenbrock_logdensity,
    )

    f32 = torch.float32
    fleets = {"rosenbrock": (lambda x: rosenbrock_logdensity(x), bench_fleet(device), TOL,
                             rosenbrock_logdensity, objective_ops(N, 4))}
    Xd, yd, starts = logistic_data(np.random.default_rng(BENCH_SEED))
    logistic = LogisticRegressionMAP(LOGISTIC_N, LOGISTIC_OBS, prior_scale=LOGISTIC_PRIOR, X=Xd,
                                     y=yd, dtype=f32, device=device)
    fleets["logistic"] = (logistic.logdensity, torch.tensor(starts, dtype=f32, device=device),
                          LOGISTIC_TOL, logistic, objective_ops(LOGISTIC_N, 4, logistic))
    Q, b, starts = dense_quadratic_data(np.random.default_rng(BENCH_SEED))
    fleets["dense quadratic"] = (dense_quadratic(Q, b, f32, device),
                                 torch.tensor(starts, dtype=f32, device=device), TOL, None,
                                 dense_quadratic_ops(DENSE_QUAD_N, 4))
    data = fixture_data("mixture")
    mixture = GaussianMixture(data["means"], sigmas=MIXTURE_SIGMA, dtype=f32, device=device)
    fleets["mixture"] = (mixture.logdensity, torch.tensor(data["starts"], dtype=f32, device=device),
                         TRACED_FLEETS["mixture"][1], mixture,
                         objective_ops(MIXTURE_N, 4, mixture))
    return fleets


def traced_cases(qt, device, table):
    """The parity cases of ``table`` (kind, n, dtypes), traced: (label,
    trace, X, tol, its recipe)."""
    cases = []
    for kind, n, dtypes in table:
        for dtype in dtypes:
            obj, vgf, starts = traced_case(kind, n, dtype, device)
            X = torch.tensor(starts, dtype=dtype, device=device)
            cases.append((f"{kind} {OBJECTIVE_LANES}x{n} {str(dtype).replace('torch.', '')}",
                          qt.trace_objective(obj, vgf, X), X, TOL if dtype == torch.float32
                          else 1e-6, (kind, n, dtype)))
    return cases


def parity_failures(qt, cases):
    """`traced_parity` of each of ``cases`` against its plain version
    (rows on stderr; the hierarchical model's with ``chaotic``, its whole
    solves held to the two one-ulp witnesses, not to a run of hundreds of
    iterations on the CPU): the failures."""
    failures = []
    for label, trace, X, tol, (kind, n, dtype) in cases:
        obj, vgf, _ = traced_case(kind, n, dtype, torch.device("cpu"))
        cpu_traced = qt.trace_objective(obj, vgf, X.cpu())
        chaotic = kind.startswith("hierarchical")
        summary, _, bad = traced_parity(qt, trace, X, tol, label, cpu_traced,
                                        cpu_whole=not chaotic, chaotic=chaotic)
        print(f"  B3 vs plain {summary}", file=sys.stderr)
        failures += bad
    return failures


def ptxas_report(libs):
    reports = [ptxas_spills(lib.log) for lib in libs if lib.log]
    if not reports:
        return "no source was built anew (no ptxas report)"
    regs_f, st_f, ld_f = zip(*reports)
    return (f"ptxas: registers {min(regs_f)}-{max(regs_f)}, spill stores {max(st_f)} and "
            f"loads {max(ld_f)} bytes at most")


def first_call_ms(qt, fn):
    """ms of one call of ``fn`` by CUDA events, with the entry point's kept
    traces cleared first (so that it traces again)."""
    from quasinewtonmethods_jl_tpu_torch import resident_solve

    resident_solve._TRACES.clear()
    return time_calls(fn, (), calls=1)


def host_trace_ms(qt, obj, X):
    """The host's ms to trace ``obj`` on ``X`` and to generate its CUDA,
    measured once more where no build runs beside it."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_codegen import generate

    t0 = time.perf_counter()
    trace = qt.trace_objective(obj, None, X)
    t1 = time.perf_counter()
    generate(trace)
    return 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1)


def traced_objectives(qt, device):
    """Phase 22's objectives, traced: the parity cases (label, trace, X,
    tol, its recipe), the full-width fleets (`traced_fleets`) and their
    traces; "all": every trace; "sources": every trace's generated CUDA."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_codegen import generate

    cases = traced_cases(qt, device, TRACED_PARITY)
    fleets = traced_fleets(device)
    traced = {name: qt.trace_objective(obj, None, X) for name, (obj, X, *_) in fleets.items()}
    everything = [c[1] for c in cases] + list(traced.values())
    return {"cases": cases, "fleets": fleets, "traced": traced, "all": everything,
            "sources": [generate(t) for t in everything]}


def traced_phase(qt, device, smi, objectives, build):
    """B3 on traced objectives (see phase 22 above): ``objectives`` from
    `traced_objectives`, ``build`` their build's report from `build_phase`.
    Returns each full-width fleet's record: (launches, max abs error, (ms,
    plain ms, bound ms, bound kind, library ms))."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels import _build
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_trace import lane_fits
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import (
        resident_feasible,
        resident_occupancy,
    )

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    cases, fleets, traced = objectives["cases"], objectives["fleets"], objectives["traced"]
    everything = objectives["all"]
    host_ms = {name: host_trace_ms(qt, obj, X) for name, (obj, X, *_) in
               objectives["fleets"].items()}
    libs, cold = build
    t0 = time.perf_counter()
    _build.load_generated(*objectives["sources"])
    warm = time.perf_counter() - t0
    _build._GENERATED.clear()  # the on-disk cache alone
    t0 = time.perf_counter()
    _build.load_generated(*objectives["sources"])
    disk = time.perf_counter() - t0
    sources = len({lib.path for lib in libs})
    ptxas = ptxas_report(libs)
    log(f"[traced] {len(everything)} objectives traced and generated ({sources} sources, one "
        f"nvcc each in parallel, beside the kernel library's): build {cold:.1f} s cold, "
        f"{1e3 * warm:.1f} ms loaded in the process, {1e3 * disk:.1f} ms from the disk cache; "
        f"{ptxas}; host per call at full width: "
        + ", ".join(f"{k} trace {t:.1f} ms + codegen {g:.1f} ms"
                    for k, (t, g) in host_ms.items()))

    # B3 against its plain version on every parity objective
    failures = parity_failures(qt, cases)
    log(f"[traced] B3 vs plain (the fleet engine with the plain update on the user's functions) "
        f"on {len(cases)} traced objectives of {OBJECTIVE_LANES} lanes (rows on stderr): "
        f"{len(cases) - len({f.split(' cap=')[0] for f in failures})}/{len(cases)} pass")
    check(not failures, f"B3 and its plain version differ on traced objectives: {failures}")

    # the slice's main path: the four full-width fleets, each at full width
    # against its plain version, then through the entry points, counted
    main_summary, main_err = {}, {}
    for (name, (obj, X, tol, *_)), (cpu_obj, cpu_X, *_) in zip(fleets.items(),
                                                           traced_fleets(cpu).values()):
        main_summary[name], main_err[name], bad = traced_parity(
            qt, traced[name], X, tol, f"{name} {X.shape[0]}x{X.shape[1]} f32 tol {tol}",
            qt.trace_objective(cpu_obj, None, cpu_X), cpu_whole=False)
        print(f"  B3 vs plain {main_summary[name]}", file=sys.stderr)
        failures += bad
    check(not failures, f"B3 and its plain version differ on the full-width fleets: {failures}")
    n_q = DENSE_QUAD_N
    # one slot per op, the layout of the fleet's trace (beyond it the trace reuses
    # slots, objective_trace._pack, and B3 holds a few more n)
    wider = qt.trace_objective(dense_quadratic(np.eye(n_q + 1), np.ones(n_q + 1), torch.float32,
                                               device), None, torch.zeros((1, n_q + 1),
                                                                          device=device))
    feasible = (resident_feasible(n_q, 4, traced["dense quadratic"]),
                lane_fits(n_q + 1, 4, wider.one_slot_values))
    check(feasible == (True, False), f"n = {n_q} is not the largest n B3 holds for the dense "
          f"quadratic with one slot per op in float32: feasible at n, n + 1 = {feasible}")
    torch.cuda.synchronize()
    reset_counters(qt)
    resident, fleet, lines, launched, b1_ms = {}, {}, [], {}, {}
    for name, (obj, X, tol, *_) in fleets.items():
        before = counted_kernels()["B3"].objective_launches["traced"]
        res, flagged, wall = resident_run(qt, obj, X, tol)
        launched[name] = counted_kernels()["B3"].objective_launches["traced"] - before
        check(flagged == 0, f"{name}: {flagged} host synchronisations inside the resident solve")
        resident[name] = res
        # the counted B1 run is the one timed (CUDA events around the call)
        b1_ms[name] = time_calls(lambda: fleet.update({name: qt.optimize_batched(
            obj, X, tol=tol, max_iterations=MAX_ITERS)}), (), calls=1)
    c = read_counters(qt)
    launches = dict(counted_kernels()["B3"].objective_launches)
    check(launches == {**dict.fromkeys(launches, 0), "traced": 4} and c["B3"] == 4
          and c["B2a"] == c["B2b"] == 0 and c["B1"] == c["bodies"] > 0,
          f"launches {launches}, {c}")
    for name, (_, X, tol, *_) in fleets.items():
        jax_conv, jax_med, jax_max = TRACED_FLEETS[name][2:]
        for engine, res in (("B3", resident[name]), ("B1", fleet[name])):
            conv, med, itmax, gmax = fleet_line(qt, res)
            lines.append(f"{name} {X.shape[0]}x{X.shape[1]} through {engine}: converged "
                         f"{conv}/{X.shape[0]}, iterations median {med:g} max {itmax} (JAX "
                         f"{jax_med} / {jax_max}), max|grad| {gmax:.3e}")
            check(conv == X.shape[0] == jax_conv and gmax < tol,
                  f"{name} through {engine}: {conv}/{X.shape[0]} converged, max|grad| {gmax}")
            check(abs(med - jax_med) <= 0.1 * jax_med,
                  f"{name} through {engine}: median {med} not within 10% of {jax_med}")
    log(f"[traced] full-width fleets on {device}: optimize_batched_resident launches B3 "
        f"{c['B3']} (traced {launches['traced']}), host synchronisations 0 in each; "
        f"optimize_batched B1 {c['B1']} = loop bodies {c['bodies']}; the dense quadratic at "
        f"n = {n_q}, the largest n B3 holds for it in float32 (n + 1 does not fit); "
        f"at full width: " + "; ".join(main_summary.values()) + "; " + "; ".join(lines))

    records, timings = {}, []
    for name, (obj, X, tol, hand, needs) in fleets.items():
        trace = traced[name]
        fns = {
            "B3 traced": lambda: qt.optimize_batched_resident(trace, X, tol=tol,
                                                              max_iterations=MAX_ITERS),
            "B3 on the function": lambda: qt.optimize_batched_resident(obj, X, tol=tol,
                                                                       max_iterations=MAX_ITERS),
        }
        if hand is not None:
            fns["B3 hand-written"] = lambda: qt.optimize_batched_resident(
                hand, X, tol=tol, max_iterations=MAX_ITERS)
        first = first_call_ms(qt, fns["B3 on the function"])
        ms = per_call_ms(fns, (), rounds=2, calls=1)
        # the fleet engine takes seconds a solve: B1's counted run, and one plain call
        ms.update(per_call_ms({
            "plain": lambda: qt.optimize_batched(obj, X, tol=tol, max_iterations=MAX_ITERS,
                                                 kernel="torch"),
        }, (), rounds=1, calls=1, warmup=False), B1=b1_ms[name])
        n = X.shape[1]
        b = b3_bound(resident[name], n, 4, True, ops=needs)
        graph = b3_bound(resident[name], n, 4, True,
                         ops=(trace.ops_vag + n, trace.ops_value + 2 * n, trace.const_bytes))
        occ = resident_occupancy(n, 4, trace)
        timings.append(
            f"{name} {X.shape[0]}x{n}: B3 traced {ms['B3 traced']:.4f} ms "
            f"({1e3 * X.shape[0] / ms['B3 traced']:.1f} solves/s), through the entry point on "
            f"the function itself: the first call (it traces) {first:.4f} ms, a second call "
            f"(the kept trace) {ms['B3 on the function']:.4f} ms"
            + (f", B3 hand-written {ms['B3 hand-written']:.4f} ms (traced / hand-written "
               f"{ms['B3 traced'] / ms['B3 hand-written']:.2f})" if hand is not None else "")
            + f", fleet engine with B1 {ms['B1']:.4f} ms, with the plain update "
            f"{ms['plain']:.4f} ms; B3 traced's bound {b[0]:.4f} ms ({b[1]}; the function "
            f"needs {needs[0]} operations per value and gradient, {needs[1]} per trial, "
            f"{needs[2]} data bytes), at {100 * b[0] / ms['B3 traced']:.1f} % (its graph "
            f"counts {trace.ops_vag} and {trace.ops_value}, {trace.const_bytes} constant "
            f"bytes, which would give {graph[0]:.4f} ms); {trace.extra_values} scratch values "
            f"per lane; launch {shape_line(occ)}")
        records[f"traced:{name.replace(' ', '_')}"] = (
            launched[name], main_err[name], (ms["B3 traced"], ms["plain"], *b, None))
    log(f"[time] traced fleets per solve (CUDA events; B3 median of 2 in turns, the fleet "
        f"engine one call each): "
        + "; ".join(timings) + f" on {smi}; phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return records


def hierarchical_objectives(qt, device):
    """Phase 23's objectives, traced: the parity cases (`traced_cases`), the
    full-width fleet (the objective, its float32 starts, its trace);
    "sources": every trace's generated CUDA."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_codegen import generate

    cases = traced_cases(qt, device, HIER_PARITY)
    fleets = {}
    for dtype in (torch.float32, torch.float64):
        obj, starts = hierarchical_objective(np.random.default_rng(BENCH_SEED), HIER_Q, dtype,
                                             device, HIER_BATCH)
        X = torch.tensor(starts, dtype=dtype, device=device)
        fleets[dtype] = (obj, X, qt.trace_objective(obj, None, X))
    everything = [c[1] for c in cases] + [f[2] for f in fleets.values()]
    return {"cases": cases, "fleets": fleets, "sources": [generate(t) for t in everything]}


def hierarchical_phase(qt, device, smi, objectives, build):
    """B3 on the transformed hierarchical model (see phase 23 above):
    ``objectives`` from `hierarchical_objectives`, ``build`` their build's
    report. Returns the full-width fleet's record: (launches, max abs
    error, (ms, plain ms, bound ms, bound kind, library ms))."""
    from quasinewtonmethods_jl_tpu_torch import resident_solve
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import resident_occupancy

    t_phase = time.perf_counter()
    libs, cold = build
    cases, fleets = objectives["cases"], objectives["fleets"]
    obj, X, trace = fleets[torch.float32]
    trace_ms, gen_ms = host_trace_ms(qt, obj, X)
    log(f"[hierarchical] {len(cases) + 2} objectives traced and generated "
        f"({len({lib.path for lib in libs})} sources, built beside phase 22's in {cold:.1f} s "
        f"cold); {ptxas_report(libs)}; at full width in float32 the trace {trace_ms:.1f} ms "
        f"and codegen {gen_ms:.1f} ms of host time, {trace.extra_values} scratch values per lane, "
        f"{len(trace.consts)} constants and {len(trace.tables)} int32 index tables "
        f"({trace.const_bytes} bytes)")
    failures = parity_failures(qt, cases)
    log(f"[hierarchical] B3 vs plain (the fleet engine with the plain update on the user's "
        f"functions) on {len(cases)} objectives of {OBJECTIVE_LANES} lanes, one per op group "
        f"the transforms add and the transformed model at q = 2 and 3 (rows on stderr): "
        f"{len(cases) - len({f.split(' cap=')[0] for f in failures})}/{len(cases)} pass, "
        f"{time.perf_counter() - t_phase:.1f} s into the phase")
    check(not failures, f"B3 and its plain version differ on phase 23's objectives: {failures}")

    # the full-width fleets against their plain version, then through the entry points, counted
    n = X.shape[1]
    # the float64 plain run's whole solve is timed alone (the kernels line's
    # plain_ms); float32's, whose record is not kept, runs stacked with its
    # one-ulp witnesses, which its other statuses need
    parity, plain_walls = {}, {torch.float64: {}}
    for dtype, (_, f_X, f_trace) in fleets.items():
        label = f"hierarchical {HIER_BATCH}x{n} {str(dtype).replace('torch.', '')} tol {TOL}"
        cpu_obj, cpu_starts = hierarchical_objective(np.random.default_rng(BENCH_SEED), HIER_Q,
                                                     dtype, torch.device("cpu"), HIER_BATCH)
        summary, err, bad = traced_parity(
            qt, f_trace, f_X, TOL, label,
            qt.trace_objective(cpu_obj, None, torch.tensor(cpu_starts, dtype=dtype)),
            cpu_whole=False, chaotic=True, walls=plain_walls.get(dtype))
        print(f"  B3 vs plain {summary} ({time.perf_counter() - t_phase:.1f} s into phase 23)",
              file=sys.stderr)
        check(not bad, f"B3 and its plain version differ on the hierarchical fleet: {bad}")
        parity[dtype] = (summary, err)
    resident_solve._TRACES.clear()  # the runs below trace, as a first call does
    torch.cuda.synchronize()
    reset_counters(qt)
    runs, flagged, b1_ms = {}, {}, {}
    for dtype, (f_obj, f_X, _) in fleets.items():
        res, flagged[dtype], _ = resident_run(qt, f_obj, f_X, TOL)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        runs[dtype] = (res, qt.optimize_batched(f_obj, f_X, tol=TOL, max_iterations=MAX_ITERS))
        end.record()
        torch.cuda.synchronize()
        b1_ms[dtype] = start.elapsed_time(end)  # host-bound, ~10 s: this call is its time
    c = read_counters(qt)
    launches = dict(counted_kernels()["B3"].objective_launches)
    check(launches == {**dict.fromkeys(launches, 0), "traced": 2} and c["B3"] == 2
          and c["B2a"] == c["B2b"] == 0 and c["B1"] == c["bodies"] > 0,
          f"launches {launches}, {c}")
    check(not any(flagged.values()), f"host synchronisations inside the resident solves: {flagged}")
    lines = []
    for dtype, pair in runs.items():
        jax_conv, jax_med, jax_max = JAX_HIER[dtype]
        name = str(dtype).replace("torch.", "")
        # float32 stops most lanes on its floor, where rounding decides the iteration
        # count: its median is shown, not held (the rounding witnesses hold it above)
        held = dtype == torch.float64
        for engine, r in zip(("B3", "B1"), pair):
            status = r.status
            conv, med, itmax, _ = fleet_line(qt, r)
            ok = status == qt.Status.CONVERGED
            gmax = float(r.grad[ok].abs().max()) if bool(ok.any()) else 0.0
            p = fewer_converged_p(conv, jax_conv, HIER_BATCH)
            kinds = {int(k): int((status == k).sum()) for k in torch.unique(status).tolist()}
            f_obj = fleets[dtype][0]
            beta = f_obj.constrain(r.x)[:, :HIER_P]  # the model's own check: beta near the truth
            err_beta = float((beta - f_obj._obj.beta_true).abs().max(dim=1).values.median())
            lines.append(f"{name} through {engine}: converged {conv}/{HIER_BATCH} (JAX "
                         f"{jax_conv}; one-sided Fisher p {p:.3g}), statuses {kinds}, iterations "
                         f"median {med:g} max {itmax} (JAX {jax_med} / {jax_max}"
                         + ("" if held else "; on the floor, not held") + "), max|grad| of "
                         f"the converged {gmax:.3e}, median lane's max|beta - beta_true| "
                         f"{err_beta:.3f}")
            label_e = f"hierarchical {name} through {engine}"
            check(bool(torch.isfinite(r.x).all()) and r.x.shape == fleets[dtype][1].shape,
                  f"{label_e}: non-finite or misshapen iterates")
            check(set(kinds) <= {int(qt.Status.CONVERGED), int(qt.Status.LINESEARCH_FAILURE)},
                  f"{label_e}: statuses {kinds}")
            check(p >= 0.01 and gmax < TOL, f"{label_e}: {conv} converged against JAX's "
                  f"{jax_conv} (p {p:.3g}), max|grad| {gmax}")
            check(err_beta < 0.3, f"{label_e}: beta {err_beta} from the truth")
            check(not held or abs(med - jax_med) <= 0.1 * jax_med,
                  f"{label_e}: median {med} not within 10% of {jax_med}")
    log(f"[hierarchical] {HIER_BATCH}x{n} f32 and f64 tol {TOL} on {device}: "
        f"optimize_batched_resident launches B3 {c['B3']} (traced {launches['traced']}, one "
        f"per dtype), host synchronisations 0; optimize_batched B1 {c['B1']} = loop bodies "
        f"{c['bodies']}; at full width against the plain version: "
        + "; ".join(summary for summary, _ in parity.values()) + "; "
        + "; ".join(lines) + f"; {time.perf_counter() - t_phase:.1f} s into the phase")

    first = first_call_ms(qt, lambda: qt.optimize_batched_resident(obj, X, tol=TOL,
                                                                   max_iterations=MAX_ITERS))
    ms = per_call_ms({
        "B3 traced": lambda: qt.optimize_batched_resident(trace, X, tol=TOL,
                                                          max_iterations=MAX_ITERS),
        "B3 on the function": lambda: qt.optimize_batched_resident(obj, X, tol=TOL,
                                                                   max_iterations=MAX_ITERS),
    }, (), rounds=2, calls=1)
    needs = hierarchical_ops(n)
    b = b3_bound(runs[torch.float32][0], n, 4, True, ops=needs)
    graph = b3_bound(runs[torch.float32][0], n, 4, True,
                     ops=(trace.ops_vag + n, trace.ops_value + 2 * n, trace.const_bytes))
    occ = resident_occupancy(n, 4, trace)
    # the kernels line's record: the float64 fleet, where every lane converges in both
    # packages, so that its time is not decided by where float32's floor stops lanes
    _, X64, trace64 = fleets[torch.float64]
    ms64 = per_call_ms({"B3 traced": lambda: qt.optimize_batched_resident(
        trace64, X64, tol=TOL, max_iterations=MAX_ITERS)}, (), rounds=2, calls=1)["B3 traced"]
    plain64 = plain_walls[torch.float64]["plain"]  # its whole solve in the parity above
    needs64 = hierarchical_ops(n, itemsize=8)
    b64 = b3_bound(runs[torch.float64][0], n, 8, True, ops=needs64)
    occ64 = resident_occupancy(n, 8, trace64)
    log(f"[time] hierarchical {HIER_BATCH}x{n} per solve (CUDA events, median of 2 in turns): "
        f"float64 (the kernels line's record): B3 traced {ms64:.4f} ms "
        f"({1e3 * HIER_BATCH / ms64:.1f} solves/s), fleet engine (one call each: B1's the main "
        f"path's) with B1 {b1_ms[torch.float64]:.4f} ms, with the plain update {plain64:.4f} ms "
        f"(the parity's whole solve); "
        f"bound {b64[0]:.4f} ms ({b64[1]}; the function needs {needs64[0]} operations per value "
        f"and gradient, {needs64[1]} per trial, {needs64[2]} data bytes), at "
        f"{100 * b64[0] / ms64:.1f} %, launch {shape_line(occ64)}; float32: B3 traced "
        f"{ms['B3 traced']:.4f} ms ({1e3 * HIER_BATCH / ms['B3 traced']:.1f} solves/s), "
        f"through the entry point on the function itself: the first call (it traces) "
        f"{first:.4f} ms, a second call (the kept trace) {ms['B3 on the function']:.4f} ms; "
        f"fleet engine with B1 {b1_ms[torch.float32]:.4f} ms; bound {b[0]:.4f} ms ({b[1]}; "
        f"{needs[0]} and {needs[1]} operations, {needs[2]} data bytes), at "
        f"{100 * b[0] / ms['B3 traced']:.1f} % (its graph counts {trace.ops_vag} and "
        f"{trace.ops_value}, {trace.const_bytes} constant and table bytes, which would give "
        f"{graph[0]:.4f} ms); launch {shape_line(occ)}; on {smi}; phase 23 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"traced:hierarchical": (c["B3"], parity[torch.float64][1],
                                    (ms64, plain64, *b64, None))}


def lm_fleet_data(device):
    """bench_full.py config 8's fleet (scripts/jax_engines_reference.py
    draws the same): 4096 exponential fits of 40 points, f32, starts (1, 0)."""
    rng = np.random.default_rng(BENCH_SEED)
    t = np.linspace(0.0, 1.0, LM_M, dtype=np.float32)
    amp = rng.uniform(0.5, 3.0, LM_BATCH).astype(np.float32)
    rate = rng.uniform(-2.5, -0.5, LM_BATCH).astype(np.float32)
    y = amp[:, None] * np.exp(rate[:, None] * t[None, :])
    X = np.tile(np.array([1.0, 0.0], np.float32), (LM_BATCH, 1))
    data = (torch.tensor(np.tile(t, (LM_BATCH, 1)), device=device), torch.tensor(y, device=device))
    return torch.tensor(X, device=device), data


def resid8(p, d):
    tt, yy = d
    return p[..., 0:1] * torch.exp(p[..., 1:2] * tt) - yy


def tr_fleet_data(device):
    """bench_full.py config 9's fleet: 1024 starts on a 256-d quadratic of
    condition 1e4 (Q from a QR of a normal matrix), f32; returns (X, the
    objective)."""
    rng = np.random.default_rng(BENCH_SEED)
    Q, _ = np.linalg.qr(rng.standard_normal((TR_N, TR_N)))
    A = torch.tensor(((Q * np.geomspace(1.0, 1e4, TR_N)) @ Q.T).astype(np.float32), device=device)
    b = torch.tensor(rng.standard_normal(TR_N).astype(np.float32), device=device)
    X = torch.tensor(rng.standard_normal((TR_BATCH, TR_N)).astype(np.float32), device=device)

    def quad9(x):
        return -0.5 * x @ (A @ x) + b @ x

    return X, quad9


def disk14(x):
    return 30.0 - torch.sum(x * x)


def solve_auglag(qt, X, engine, **kw):
    """bench_full.py config 14's call: the split Rosenbrock (autodiff) on
    the disk x·x <= 30, tol = ctol = 1e-3, at most 2000 inner iterations."""
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity

    kw = {"tol": AUG_TOL, "ctol": AUG_TOL, "max_iterations": AUG_MAX_ITERS, **kw}
    return qt.optimize_auglag(rosenbrock_logdensity, X, ineq=disk14, engine=engine, **kw)


AUGLAG_COUNTERS = ("status", "n_outer", "iterations", "n_fev", "inner_status")


def auglag_diff(a, b):
    """(lanes whose counters differ, max normwise difference of x, lam, mu,
    rho, viol, max abs difference of x) of two auglag fleet results."""
    same = torch.ones(a.status.shape, dtype=torch.bool)
    for name in AUGLAG_COUNTERS:
        same &= getattr(a, name).cpu() == getattr(b, name).cpu()
    errs = [normwise_err(getattr(a, f).to(getattr(b, f).device), getattr(b, f))
            for f in ("x", "lam", "mu", "rho", "viol")]
    return int((~same).sum()), max(e[1] for e in errs), errs[0][0]


def auglag_b1_parity(qt, device):
    """Phase 24 (a): the auglag BFGS fleet with B1 against the plain update
    over 64 lanes of the disk-constrained Rosenbrock in f64 and f32: at
    max_outer 1 and 2 and inner caps 0, 1, 5 every counter equal and the
    floats within EXACT_RTOL or ROUNDING_FACTOR times what the plain
    version moves on the CPU; B1 once per inner loop body; over whole
    solves the lanes with another status at most ROUNDING_FACTOR times the
    worst rounding witness (the plain version 1 ulp up, down, on the CPU).
    Returns (summary, max abs error of x at the caps)."""
    X32 = bench_fleet(device)[:AUG_PARITY_LANES]
    worst_abs, lines, failures = 0.0, [], []
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, AUG_TOL)):
        X = X32.to(dtype)
        kw = {"tol": tol, "ctol": tol}
        same_runs = worst = 0
        for max_outer in (1, 2):
            for cap in SHORT_CAPS:
                run = dict(kw, max_outer=max_outer, max_iterations=cap)
                reset_counters(qt)
                kern = solve_auglag(qt, X, "bfgs", kernel="cuda", **run)
                c = read_counters(qt)
                plain = solve_auglag(qt, X, "bfgs", kernel="torch", **run)
                cpu = solve_auglag(qt, X.cpu(), "bfgs", kernel="torch", **run)
                lanes, err, err_abs = auglag_diff(kern, plain)
                limit = max(EXACT_RTOL[dtype], ROUNDING_FACTOR * auglag_diff(cpu, plain)[1])
                worst, worst_abs = max(worst, err), max(worst_abs, err_abs)
                same_runs += lanes == 0
                if lanes or err > limit or c["B1"] != c["auglag_inner_bodies"]:
                    failures.append(f"{dtype} max_outer={max_outer} cap={cap}: {lanes} lanes with "
                                    f"other counters, normwise {err:.3e} (limit {limit:.3e}), B1 "
                                    f"{c['B1']} launches for {c['auglag_inner_bodies']} bodies")
        kern = solve_auglag(qt, X, "bfgs", kernel="cuda", **kw)
        plain = solve_auglag(qt, X, "bfgs", kernel="torch", **kw)
        flips = int((kern.status != plain.status).sum())
        witness = {}
        if flips:
            for key, x0 in (*ulp_starts(X).items(), ("CPU", X.cpu())):
                w = solve_auglag(qt, x0, "bfgs", kernel="torch", **kw)
                witness[key] = int((w.status.to(device) != plain.status).sum())
        if flips > ROUNDING_FACTOR * max(witness.values(), default=0):
            failures.append(f"{dtype} whole solves: {flips} lanes with another status "
                            f"(witnesses {witness})")
        conv = int((kern.status == qt.Status.CONVERGED).sum())
        lines.append(f"{dtype} (tol {tol}): caps {same_runs}/{2 * len(SHORT_CAPS)} runs with every "
                     f"counter equal, max normwise {worst:.3e}; whole solves converged {conv}/"
                     f"{X.shape[0]} (plain {int((plain.status == qt.Status.CONVERGED).sum())}), "
                     f"another status on {flips} lanes"
                     + (f" (witnesses {witness})" if flips else ""))
    check(not failures, f"B1 under auglag differs from the plain update: {failures}")
    return "; ".join(lines), worst_abs


def fleet_gate(qt, res, label, jax, medians):
    """The full-width gates against the JAX package's counts ``jax`` (see
    phase 24 above): every lane converged where JAX converges every lane,
    else the count not below JAX's by more than chance; the median of
    each field of ``medians`` within 10 % of JAX's. Returns a summary."""
    lanes = res.status.shape[0]
    conv = int((res.status == qt.Status.CONVERGED).sum())
    if jax["converged"] == jax["lanes"]:
        check(conv == lanes, f"{label}: only {conv}/{lanes} lanes converged (JAX: every lane)")
        p = None
    else:
        p = fewer_converged_p(conv, jax["converged"], lanes)
        check(p >= 0.01, f"{label}: {conv}/{lanes} converged against JAX's {jax['converged']} "
                         f"(one-sided Fisher p = {p:.2e})")
    parts = [f"converged {conv}/{lanes} (JAX {jax['converged']}"
             + ("" if p is None else f", Fisher p {p:.3f}") + ")"]
    for field in medians:
        med = float(getattr(res, field).float().median())
        check(abs(med - jax[field]) <= 0.1 * jax[field],
              f"{label}: median {field} {med} not within 10% of JAX's {jax[field]}")
        parts.append(f"median {field} {med:g} (JAX {jax[field]:g})")
    statuses = torch.bincount(res.status.cpu().long(), minlength=5).tolist()
    return ", ".join(parts) + f", statuses {statuses}"


def fleet_time(fn, lanes):
    """Seconds of one call of ``fn`` (warm), ended by a synchronize, and the
    solves/s it gives."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, lanes / wall


def engines_phase(qt, device, smi):
    """The minimization front door (see phase 24 above). Returns the auglag
    BFGS fleet's B1 launches and the caps' max abs error of x."""
    t_phase = time.perf_counter()
    summary, b1_err = auglag_b1_parity(qt, device)
    log(f"[engines] B1 under optimize_auglag(engine='bfgs') against the plain update, "
        f"{AUG_PARITY_LANES} lanes of the disk-constrained Rosenbrock n={N}: {summary} "
        f"({time.perf_counter() - t_phase:.1f} s into phase 24)")

    # LM, config 8
    X, data = lm_fleet_data(device)
    res, c, flagged, _ = counted_run(
        qt, lambda: qt.least_squares(resid8, X, data=data, tol=AUG_TOL), "lm_syncs")
    peak = torch.cuda.max_memory_allocated(device)
    gate = fleet_gate(qt, res, "LM", JAX_ENGINES["lm"], ("iterations",))
    check(res.x.dtype == torch.float32 and bool(torch.isfinite(res.x).all()), "LM: result values")
    wall, rate = fleet_time(lambda: qt.least_squares(resid8, X, data=data, tol=AUG_TOL), LM_BATCH)
    part = qt.least_squares(resid8, X, data=data, tol=AUG_TOL, max_iterations=2)
    resumed = qt.least_squares_from_state(resid8, qt.lm_state_to_numpy(part.state), data=data,
                                          tol=AUG_TOL)
    check(resumed.x.device.type == "cuda" and resumed.x.dtype == torch.float32
          and bool(resumed.converged.all()), "LM: the numpy state did not resume to convergence")
    log(f"[engines] least_squares {LM_BATCH} exponential fits (n=2, m={LM_M}) f32, tol {AUG_TOL}: "
        f"{gate}; {c['lm_bodies']} loop bodies and {c['lm_syncs']} host syncs per solve (all "
        f"{flagged} flagged counted), no kernel launched, peak {peak / 2**20:.1f} MiB; "
        f"{rate:.1f} solves/s ({wall:.4f} s a call) on {smi}; resumed from a 2-iteration state "
        f"saved as numpy: converged {int(resumed.converged.sum())}/{LM_BATCH}")
    del X, data, res, part, resumed

    # TR, config 9, and minimize(method="tr") on the negated function
    X, quad9 = tr_fleet_data(device)

    def tr_call():
        return qt.optimize_tr(quad9, X, tol=AUG_TOL, max_cg=TR_N)

    # host-bound at ~10 s a call: one call is counted and timed
    res, c, flagged, wall = counted_run(qt, tr_call, "tr_syncs")
    peak = torch.cuda.max_memory_allocated(device)
    rate = TR_BATCH / wall
    gate = fleet_gate(qt, res, "TR", JAX_ENGINES["tr"], ("iterations", "n_hev"))
    # resumed from 5 iterations saved as numpy to a lifetime cap of 10: a
    # lane the one-leg run ended by then ends the same, the others run on;
    # the 5-iteration call is the profiled one (a whole call's ~2.4 x 10^5
    # device events take seconds to read)
    parts = {}
    reset_counters(qt)
    prof = device_profile(lambda: parts.update(part=qt.optimize_tr(
        quad9, X, tol=AUG_TOL, max_cg=TR_N, max_iterations=5)))
    part, prof_bodies = parts["part"], read_counters(qt)["tr_cg_bodies"]
    busy = None if prof[1] is None else prof[1] / prof[0]
    resumed = qt.optimize_tr_from_state(quad9, qt.tr_state_to_numpy(part.state), tol=AUG_TOL,
                                        max_cg=TR_N, max_iterations=TR_RESUME_CAP)
    ended = res.iterations <= TR_RESUME_CAP
    expect = torch.where(ended, res.status, int(qt.Status.MAX_ITERATIONS))
    differ = int(((resumed.status != expect)
                  | (resumed.iterations != torch.clamp_max(res.iterations, TR_RESUME_CAP))).sum())
    check(resumed.x.device.type == "cuda" and resumed.x.dtype == torch.float32 and differ == 0,
          f"TR: the numpy state resumed to another status or count on {differ} lanes")
    # minimize on the negated function over the whole fleet for 5 iterations,
    # against the profiled 5-iteration run (the whole solve took ~15 s more)
    mini, ref = qt.minimize(lambda x: -quad9(x), X, method="tr", tol=AUG_TOL, max_cg=TR_N,
                            max_iterations=5), part
    same = all(torch.equal(getattr(mini, f), getattr(ref, f))
               for f in ("status", "iterations", "n_fev", "n_hev"))
    flip_err = max(normwise_err(mini.x, ref.x)[1], normwise_err(-mini.fun, ref.fun)[1],
                   normwise_err(-mini.grad, ref.grad)[1])
    check(same and flip_err <= EXACT_RTOL[torch.float32],
          f"TR: minimize on the negated function differs from optimize_tr (counters equal {same}, "
          f"normwise {flip_err:.3e})")
    log(f"[engines] optimize_tr {TR_BATCH}x{TR_N} f32 quadratic (condition 1e4), tol {AUG_TOL}, "
        f"max_cg {TR_N}: {gate}; {c['tr_bodies']} outer and {c['tr_cg_bodies']} Steihaug bodies, "
        f"{c['tr_syncs']} host syncs per solve (all {flagged} flagged counted), no kernel launched, "
        f"peak {peak / 2**20:.1f} MiB; {rate:.1f} solves/s ({wall:.4f} s, the counted call), "
        f"device busy over a call's first 5 iterations (the resumed leg's first call) "
        + ("not measured (no device events)" if busy is None else f"{100 * busy:.1f} %")
        + f" on {smi}; resumed from a 5-iteration state saved as numpy to {TR_RESUME_CAP} "
        f"iterations: statuses and counts as the one-leg run's on every lane ({int(ended.sum())} "
        f"ended by then); minimize(method='tr', max_iterations=5) on the negated function over "
        f"the {TR_BATCH} lanes: counters equal to the 5-iteration run's, normwise "
        f"{flip_err:.1e} after the sign flip")
    log(profile_line(f"TR fleet {TR_BATCH}x{TR_N} f32, its first 5 iterations", *prof,
                     prof_bodies))
    del X, res, part, resumed, mini, ref

    # auglag, config 14: the CG fleet (no kernel), the BFGS fleet (B1), and
    # the constrained minimize (B1)
    X = bench_fleet(device)
    out = {}
    for engine in ("cg", "bfgs"):
        label = f"auglag {engine}"
        res, c, flagged, wall = counted_run(qt, lambda: solve_auglag(qt, X, engine),
                                            "auglag_syncs", kernels=engine == "bfgs")
        peak = torch.cuda.max_memory_allocated(device)
        gate = fleet_gate(qt, res, label, JAX_ENGINES[f"auglag_{engine}"],
                          ("iterations", "n_outer"))
        ok = res.status == qt.Status.CONVERGED
        viol = float(res.viol[ok].max())
        check(viol <= AUG_TOL, f"{label}: max viol {viol} over ctol on a converged lane")
        if engine == "bfgs":
            check(c["B1"] == c["auglag_inner_bodies"] > 0 and c["B2a"] == c["B3"] == 0,
                  f"{label}: B1 not launched once per inner loop body: {c}")
            out["launches"] = c["B1"]
        else:
            check(no_kernel_launched(c), f"{label}: a kernel launched: {c}")
        # host-bound at several s a call: the counted call is the one timed
        timed = "the counted call"
        busy_text = ""
        if engine == "bfgs":
            reset_counters(qt)
            prof = device_profile(lambda: solve_auglag(qt, X, engine))
            prof_bodies = engines(qt)["auglag"].inner_bodies
            busy = None if prof[1] is None else prof[1] / prof[0]
            busy_text = ", device busy " + ("not measured (no device events)" if busy is None
                                            else f"{100 * busy:.1f} %")
        rate = AUG_BATCH / wall
        log(f"[engines] optimize_auglag(engine='{engine}') {AUG_BATCH}x{N} f32 on the disk x·x <= "
            f"30, tol = ctol = {AUG_TOL}: {gate}, max viol of the converged {viol:.3e}; "
            f"{c['auglag_rounds']} outer rounds, {c['auglag_inner_bodies']} inner loop bodies and "
            f"{c['auglag_syncs']} host syncs per solve (all {flagged} flagged counted), B1 "
            f"{c['B1']} launches, peak {peak / 2**20:.1f} MiB; {rate:.1f} solves/s ({wall:.4f} s, "
            f"{timed}){busy_text} on {smi}")
        if engine == "bfgs":
            log(profile_line(f"auglag BFGS fleet {AUG_BATCH}x{N} f32", *prof, prof_bodies))
        del res

    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity

    sub = X[:AUG_MIN_LANES]
    mini, c, flagged, _ = counted_run(
        qt, lambda: qt.minimize(lambda x: -rosenbrock_logdensity(x), sub, ineq=disk14,
                                method="bfgs", tol=AUG_TOL, ctol=AUG_TOL,
                                max_iterations=AUG_MAX_ITERS), "auglag_syncs", kernels=True)
    ref = solve_auglag(qt, sub, "bfgs")
    gate = fleet_gate(qt, mini, "minimize", JAX_ENGINES["minimize_bfgs"], ("iterations", "n_outer"))
    lanes, err, _ = auglag_diff(ref, mini)
    flip_err = max(normwise_err(-mini.fun, ref.fun)[1], normwise_err(-mini.grad, ref.grad)[1])
    check(lanes == 0 and max(err, flip_err) <= EXACT_RTOL[torch.float32]
          and c["B1"] == c["auglag_inner_bodies"] > 0,
          f"minimize with ineq differs from optimize_auglag: {lanes} lanes with other counters, "
          f"normwise {err:.3e} / {flip_err:.3e}, B1 {c['B1']} for {c['auglag_inner_bodies']} bodies")
    log(f"[engines] minimize(ineq=..., method='bfgs') over {AUG_MIN_LANES} lanes: {gate}; equal "
        f"to optimize_auglag after the sign flip (counters on every lane, normwise "
        f"{max(err, flip_err):.1e}), B1 {c['B1']} launches, {c['auglag_syncs']} host syncs (all "
        f"{flagged} flagged counted); phase 24 took {time.perf_counter() - t_phase:.1f} s")
    out["err"] = b1_err
    return out


def map_multistart(qt, device):
    """Phase 25 (a): the multistart fleet through B1, then a generator's
    starts. Returns (the fleet's result, B1's launches, its summary)."""
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity

    X = bench_fleet(device)
    torch.cuda.synchronize()
    reset_counters(qt)
    t0 = time.perf_counter()
    ms = qt.optimize_multistart(rosenbrock_logdensity, None, BATCH, N, x0s=X, tol=TOL,
                                max_iterations=MAX_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counters(qt)
    fleet = ms.fleet
    check(c["B1"] == c["bodies"] > 0 and c["B2a"] == c["B2b"] == c["B3"] == 0,
          f"multistart: B1 not launched once per loop body: {c}")
    check(fleet.x.device.type == "cuda" and fleet.x.dtype == torch.float32
          and bool(torch.isfinite(fleet.x).all()), "multistart: fleet values")
    conv = int(ms.n_converged)
    med = float(np.median(fleet.iterations.cpu().numpy()))
    check(conv == JAX_MAP["multistart_converged"] == BATCH,
          f"multistart: {conv}/{BATCH} converged (JAX {JAX_MAP['multistart_converged']})")
    check(abs(med - JAX_MAP["multistart_median"]) <= 0.1 * JAX_MAP["multistart_median"],
          f"multistart: median iterations {med} not within 10% of {JAX_MAP['multistart_median']}")
    check(bool(torch.isfinite(ms.fun)) and float((ms.x - 1.0).abs().max()) < 0.05,
          "multistart: the best mode is not the Rosenbrock's")
    gen = torch.Generator(device=device).manual_seed(7)
    drawn = qt.optimize_multistart(rosenbrock_logdensity, gen, BATCH, N, tol=TOL,
                                   max_iterations=MAX_ITERS)
    dconv = int(drawn.n_converged)
    check(drawn.fleet.x.device.type == "cuda" and drawn.fleet.x.dtype == torch.float32,
          "multistart: a CUDA generator's starts were not drawn on the card in float32")
    check(dconv == BATCH, f"multistart from a CUDA generator: {dconv}/{BATCH} converged")
    text = (f"optimize_multistart {BATCH}x{N} f32 (autodiff, tol {TOL}): converged {conv}/{BATCH} "
            f"(JAX {JAX_MAP['multistart_converged']}), median iterations {med:g} (JAX "
            f"{JAX_MAP['multistart_median']:g}), best lane {int(ms.best_index)} at fun "
            f"{float(ms.fun):.3e}, B1 {c['B1']} launches = loop bodies, {wall:.3f} s (first call); "
            f"from torch.Generator('cuda') seed 7: starts on {drawn.fleet.x.device} "
            f"{str(drawn.fleet.x.dtype).replace('torch.', '')}, converged {dconv}/{BATCH}")
    return fleet, c["B1"], text


def map_polish_and_evidence(qt, fleet, device):
    """Phase 25 (b) and (c): the f64 Newton polish of the fleet and the
    Laplace evidence, exact on the polished modes and from the fleet's B.
    Returns the summary."""
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pol = qt.polish_newton(rosenbrock_logdensity, fleet, steps=3, dtype=torch.float64)
    torch.cuda.synchronize()
    polish_s = time.perf_counter() - t0
    check(pol.x.device.type == "cuda" and pol.x.dtype == torch.float64, "polish: x device/dtype")
    check(bool((pol.grad_norm_after <= pol.grad_norm_before).all()),
          "polish: a lane's max|grad| grew")
    improved = int(pol.improved.sum())
    after = pol.grad_norm_after.cpu().numpy()
    after_med, after_max = float(np.median(after)), float(after.max())
    check(improved == JAX_MAP["polish_improved"],
          f"polish: {improved} lanes improved, JAX {JAX_MAP['polish_improved']}")
    check(after_max <= 10.0 * JAX_MAP["polish_after_max"],
          f"polish: max|grad| after {after_max:.3e} over 10 x JAX's {JAX_MAP['polish_after_max']}")
    t0 = time.perf_counter()
    lz = qt.laplace_evidence(pol, obj=rosenbrock_logdensity)
    lz_b = qt.laplace_evidence(fleet)
    torch.cuda.synchronize()
    laplace_s = time.perf_counter() - t0
    check(lz.dtype == torch.float64 and lz.device.type == "cuda" and lz.shape == (BATCH,)
          and bool(torch.isfinite(lz).all()), "laplace: exact evidence values")
    check(lz_b.dtype == torch.float32 and lz_b.shape == (BATCH,), "laplace: B-path values")
    med = float(np.median(lz.cpu().numpy()))
    rel = abs(med - JAX_MAP["laplace_exact_median"]) / abs(JAX_MAP["laplace_exact_median"])
    check(rel <= MAP_RTOL, f"laplace: exact median {med!r} is {rel:.2e} from JAX's "
                           f"{JAX_MAP['laplace_exact_median']!r}")
    gap = (lz - lz_b.double()).abs().cpu().numpy()
    return (f"polish_newton(steps=3, float64) on the {BATCH} lanes: {polish_s:.3f} s, improved "
            f"{improved} (JAX {JAX_MAP['polish_improved']}), max|grad| after median {after_med:.3e} "
            f"max {after_max:.3e} (JAX {JAX_MAP['polish_after_median']:.3e} / "
            f"{JAX_MAP['polish_after_max']:.3e}), none grew; laplace_evidence exact (f64) median "
            f"{med!r} (JAX {JAX_MAP['laplace_exact_median']!r}, rel {rel:.2e}), B path (f32) gap "
            f"|exact - B| median {float(np.median(gap)):.4f} max {float(gap.max()):.4f} (JAX "
            f"{JAX_MAP['laplace_gap_median']:.4f} / {JAX_MAP['laplace_gap_max']:.4f}), {laplace_s:.3f} s")


def map_checkpoint(qt, device):
    """Phase 25 (d): a checkpoint of the bench fleet at 20 iterations,
    reloaded and resumed, against an uninterrupted run."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )
    from quasinewtonmethods_jl_tpu_torch.utils.checkpoint import load_state, save_state

    X = bench_fleet(device)
    kw = {"tol": TOL, "value_and_grad_fn": rosenbrock_value_and_grad}
    part = qt.optimize_batched_fused(rosenbrock_logdensity, X, max_iterations=CHECKPOINT_CAP, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fleet")
        save_state(path, part.state)
        size = os.path.getsize(path + ".npz")
        loaded = load_state(path, qt.BFGSState)
    for field, a, b in zip(qt.BFGSState._fields, loaded, part.state):
        check(a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b),
              f"checkpoint: leaf {field} did not reload bit for bit on the card")
    resumed = qt.optimize_batched_fused_from_state(rosenbrock_logdensity, loaded,
                                                   max_iterations=MAX_ITERS, **kw)
    whole = qt.optimize_batched_fused(rosenbrock_logdensity, X, max_iterations=MAX_ITERS, **kw)
    differ = {name: int((getattr(resumed, name) != getattr(whole, name)).sum())
              for name in ("status", "iterations", "n_fev", "n_gev", "n_resets")}
    dx = float((resumed.x - whole.x).abs().max())
    check(not any(differ.values()), f"checkpoint: the resumed fleet differs from an "
                                    f"uninterrupted run on {differ} lanes")
    return (f"checkpoint of the fleet at {CHECKPOINT_CAP} iterations ({size / 2**20:.1f} MiB .npz): "
            f"every leaf reloaded bit for bit on the card; resumed through "
            f"optimize_batched_fused_from_state: statuses and counters equal to an uninterrupted "
            f"run's on every lane, max|dx| {dx:.3e}")


def map_pytree(qt, device):
    """Phase 25 (e): the fleet over {'b': X[:, 30:], 'a': X[:, :30]}
    against the flat solve."""
    from quasinewtonmethods_jl_tpu_torch.models import rosenbrock_logdensity

    X = bench_fleet(device)
    tree = {"b": X[:, N // 2:], "a": X[:, :N // 2]}

    def tree_rosenbrock(t):
        return rosenbrock_logdensity(torch.cat([t["a"], t["b"]]))

    kw = {"tol": TOL, "max_iterations": MAX_ITERS}
    reset_counters(qt)
    params, res = qt.optimize_batched_pytree(tree_rosenbrock, tree, **kw)
    c_tree = read_counters(qt)
    reset_counters(qt)
    flat = qt.optimize_batched(rosenbrock_logdensity, X, **kw)
    c_flat = read_counters(qt)
    same = all(torch.equal(getattr(res, f), getattr(flat, f))
               for f in ("x", "status", "iterations", "n_fev", "n_gev", "n_resets"))
    check(same and list(params) == ["b", "a"] and torch.equal(params["a"], flat.x[:, :N // 2])
          and torch.equal(params["b"], flat.x[:, N // 2:]),
          "pytree: the fleet over the insertion-ordered dict differs from the flat solve")
    check(c_tree["B1"] == c_flat["B1"] == c_flat["bodies"] > 0,
          f"pytree: B1 launches {c_tree['B1']} against the flat solve's {c_flat['B1']}")
    return (f"optimize_batched_pytree on {{'b': X[:, {N // 2}:], 'a': X[:, :{N // 2}]}}: x, statuses "
            f"and counters equal to the flat solve's on every lane, B1 {c_tree['B1']} launches "
            f"(flat {c_flat['B1']}), params back as b, a")


def map_implicit(qt, device):
    """Phase 25 (f): the implicit gradient of one f64 logistic MAP solve in
    its prior's log scale."""
    Xd, yd, _starts = logistic_data(np.random.default_rng(BENCH_SEED))
    Xt = torch.tensor(Xd, device=device)
    yt = torch.tensor(yd, device=device)

    def obj(w, log_s):
        logits = Xt @ w
        ls = torch.nn.functional.logsigmoid
        loglik = torch.sum(yt * ls(logits) + (1.0 - yt) * ls(-logits))
        return loglik - 0.5 * torch.sum(w * w) * torch.exp(-2.0 * log_s) - LOGISTIC_N * log_s

    x0 = torch.zeros(LOGISTIC_N, dtype=torch.float64, device=device)
    p = torch.tensor(MAP_LOG_S, dtype=torch.float64, device=device, requires_grad=True)
    t0 = time.perf_counter()
    x_star, fun = qt.optimize_implicit(obj, x0, p)
    dfun, = torch.autograd.grad(fun, p, retain_graph=True)
    dsum, = torch.autograd.grad(x_star.sum(), p)
    seconds = time.perf_counter() - t0
    fun = fun.detach()
    check(x_star.device.type == "cuda" and bool(torch.isfinite(fun)),
          f"implicit: the solve did not converge (fun {float(fun)})")

    def solve_at(log_s):
        s = torch.tensor(log_s, dtype=torch.float64, device=device)
        r = qt.optimize(lambda w: obj(w, s), x0)
        return float(r.last_value), float(r.x.sum())

    (f_hi, x_hi), (f_lo, x_lo) = solve_at(MAP_LOG_S + MAP_FD_STEP), solve_at(MAP_LOG_S - MAP_FD_STEP)
    fd, fd_sum = (f_hi - f_lo) / (2 * MAP_FD_STEP), (x_hi - x_lo) / (2 * MAP_FD_STEP)
    dfun, dsum = float(dfun), float(dsum)
    rel_fd = abs(dfun - fd) / abs(fd)
    rel_jax = abs(dfun - JAX_MAP["implicit_dfun"]) / abs(JAX_MAP["implicit_dfun"])
    rel_sum = abs(dsum - JAX_MAP["implicit_dsum_x"]) / abs(JAX_MAP["implicit_dsum_x"])
    check(rel_fd <= MAP_FD_RTOL, f"implicit: d fun/d log_s {dfun!r} is {rel_fd:.2e} from the "
                                 f"finite difference {fd!r}")
    check(rel_jax <= MAP_RTOL, f"implicit: d fun/d log_s {dfun!r} is {rel_jax:.2e} from JAX's "
                               f"{JAX_MAP['implicit_dfun']!r}")
    check(rel_sum <= MAP_FD_RTOL, f"implicit: d sum(x*)/d log_s {dsum!r} is {rel_sum:.2e} from "
                                  f"JAX's {JAX_MAP['implicit_dsum_x']!r}")
    return (f"optimize_implicit, logistic MAP n={LOGISTIC_N} (config 3's data) f64 at log_s "
            f"{MAP_LOG_S}: fun {float(fun)!r} (JAX {JAX_MAP['implicit_fun']!r}), d fun/d log_s "
            f"{dfun!r} (finite difference {fd!r}, rel {rel_fd:.2e}; JAX rel {rel_jax:.2e}), "
            f"d sum(x*)/d log_s {dsum!r} (JAX rel {rel_sum:.2e}, finite difference {fd_sum!r}), "
            f"{seconds:.3f} s for the solve and both gradients")


def ar1_chains():
    """Phase 25 (g)'s draws: AR(1) chains from numpy seed BENCH_SEED, as
    scripts/jax_map_backend_reference.py draws them."""
    eps = np.random.default_rng(BENCH_SEED).standard_normal((DIAG_DRAWS, DIAG_CHAINS, N))
    x = np.empty_like(eps)
    x[0] = eps[0] / np.sqrt(1.0 - DIAG_PHI * DIAG_PHI)
    for t in range(1, DIAG_DRAWS):
        x[t] = DIAG_PHI * x[t - 1] + eps[t]
    return x


def map_diagnostics(qt, device):
    """Phase 25 (g): every device statistic against the port's numpy
    version, per element, and JAX's summaries."""
    x = ar1_chains()
    energies = 0.5 * np.sum(x * x, axis=-1)
    xt, et = torch.tensor(x, device=device), torch.tensor(energies, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diag = qt.diagnose_chains_device(xt, rank=True)
    device_out = {"split_rhat": qt.split_rhat_device(xt), "ess": qt.ess_device(xt),
                  "rank_normalized_rhat": qt.rank_normalized_rhat_device(xt),
                  "tail_ess": qt.tail_ess_device(xt), "mean": diag.mean, "std": diag.std,
                  "energy_bfmi": qt.energy_bfmi_device(et)}
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    host = qt.diagnose_chains(x, rank=True)
    host_out = {"split_rhat": host.rhat, "ess": host.ess, "rank_normalized_rhat": host.rhat_rank,
                "tail_ess": host.ess_tail, "mean": host.mean, "std": host.std,
                "energy_bfmi": qt.energy_bfmi(energies)}
    check(torch.equal(diag.rhat, device_out["split_rhat"]) and torch.equal(diag.ess,
                                                                          device_out["ess"]),
          "diagnostics: diagnose_chains_device differs from its parts")
    worst = {}
    for name, value in device_out.items():
        check(value.device.type == "cuda" and value.dtype == torch.float64, f"{name}: device/dtype")
        v = value.cpu().numpy()
        rel_host = float(np.max(np.abs(v - host_out[name]) / np.maximum(np.abs(host_out[name]),
                                                                        1e-300)))
        ref = JAX_DIAGNOSTICS[name]
        mine = [float(v.sum()), float(v.min()), float(v.max()), float(v.reshape(-1)[0])]
        rel_jax = max(abs(a - b) / abs(b) for a, b in zip(mine, ref))
        worst[name] = (rel_host, rel_jax)
        check(rel_host <= MAP_RTOL and rel_jax <= MAP_RTOL,
              f"diagnostics: {name} is {rel_host:.2e} from the numpy version and {rel_jax:.2e} "
              f"from JAX's summaries")
    return (f"diagnostics on AR(1) chains {DIAG_DRAWS}x{DIAG_CHAINS}x{N} f64 (phi {DIAG_PHI}) on the "
            f"card in {device_s:.3f} s: max rel err against numpy / JAX "
            + ", ".join(f"{k} {a:.1e}/{b:.1e}" for k, (a, b) in worst.items()))


def map_backend_phase(qt, device, smi):
    """The MAP back end (see phase 25 above). Returns the multistart
    fleet's B1 launches."""
    t_phase = time.perf_counter()
    fleet, launches, text = map_multistart(qt, device)
    log(f"[map] {text} on {smi}")
    log(f"[map] {map_polish_and_evidence(qt, fleet, device)} on {smi}")
    del fleet
    log(f"[map] {map_checkpoint(qt, device)}")
    log(f"[map] {map_pytree(qt, device)}")
    log(f"[map] {map_implicit(qt, device)} on {smi}")
    log(f"[map] {map_diagnostics(qt, device)} on {smi}; phase 25 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 26, the samplers: config 3's logistic MAP fleet hands over to HMC and
# ChEES at full width (4096 chains, n = 100, float32). JAX's numbers come
# from scripts/jax_sampling_reference.py (the card's machine has no JAX),
# which writes the JSON file beside it.
SAMPLING_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                            "jax_sampling_reference.json")
# 500 draws, not JAX's default 1000: the whole script's wall on the
# slower hosts (the time limit); the warmup and every chain stay
SAMPLING_JITTER, SAMPLING_DRAWS, SAMPLING_WARMUP, HMC_LEAPFROG = 0.05, 500, 500, 16
# ChEES's draws, cut from 500 for phase 31 (its gates are MCSE-scaled; at 500
# draws its R-hat was 1.0023 against the limit 1.01)
CHEES_DRAWS = 250
CHEES_TARGET = 0.75  # chees_sample's default target_accept
# (d)'s short plan, long and chunked: resuming (b)'s whole warmup costs ~20
# s of the script's time limit and checks the same save, load and resume
# (40 and 20 until phase 31 came)
RESUME_WARMUP, RESUME_DRAWS = 20, 10
MASS_DIAG_RTOL = 1e-2  # the handed-over mass's diagonal against JAX's
ACCEPT_ATOL = 0.05
MOMENT_Z = 5.0  # |mean - JAX's| within 5 combined MCSEs
SD_RATIO = (0.9, 1.1)
# max split R-hat; where JAX's own reference run exceeds it, JAX's value
# + 0.01 (its HMC: 1.0204 over 512 chains)
RHAT_LIMIT, RHAT_MARGIN = 1.01, 0.01
# the busy share's steady-state window (20 until phase 32 was added)
PROFILED_TRANSITIONS = 10


def chain_moments(qt, samples):
    """Per coordinate, in float64 on the card: the pooled mean and sd and
    the MCSE sd / sqrt(ESS) from the ported `ess_device`; and the largest
    split R-hat."""
    s = samples.double()
    pooled = s.reshape(-1, s.shape[-1])
    sd = pooled.std(dim=0, correction=0)
    mcse = sd / torch.sqrt(qt.ess_device(s))
    return pooled.mean(dim=0), sd, mcse, float(qt.split_rhat_device(s).max())


def moment_gates(qt, label, res, ref, accept="accept_rate"):
    """The moment, R-hat and NaN gates of one run against JAX's numbers
    ``ref`` (``accept``: the result's acceptance field, NUTS's
    ``accept_prob``). Returns its mean acceptance and summary."""
    check(bool(torch.isfinite(res.samples).all()), f"{label}: NaN or inf in the samples")
    mean, sd, mcse, rhat = chain_moments(qt, res.samples)
    limit = RHAT_LIMIT if ref["rhat_max"] < RHAT_LIMIT else ref["rhat_max"] + RHAT_MARGIN
    check(rhat < limit, f"{label}: max split R-hat {rhat:.4f} (limit {limit:.4f}; JAX "
                        f"{ref['rhat_max']:.4f})")
    moments = mcse_gates(label, mean, sd, mcse, ref)
    bfmi = qt.energy_bfmi_device(res.energies.double())
    acc = float(getattr(res, accept).double().mean())
    divs = int(res.divergences.sum())
    return acc, (f"max split R-hat {rhat:.4f} (limit {limit:.4f}, JAX {ref['rhat_max']:.4f}), "
                 f"{moments}; mean accept {acc:.4f} (JAX {ref['accept_mean']:.4f}); divergences "
                 f"{divs} (JAX {ref['divergences']} over {ref['chains']} chains); E-BFMI median "
                 f"{float(bfmi.median()):.3f} min {float(bfmi.min()):.3f} (JAX "
                 f"{ref['ebfmi_median']:.3f} / {ref['ebfmi_min']:.3f})")


def mcse_gates(label, mean, sd, mcse, ref):
    """Per coordinate |mean - JAX's| within MOMENT_Z combined MCSEs and the
    sd within SD_RATIO of JAX's; returns the summary."""
    ref_mean, ref_sd, ref_mcse = (torch.tensor(ref[k], dtype=torch.float64, device=mean.device)
                                  for k in ("mean", "sd", "mcse"))
    z = float(((mean - ref_mean).abs() / torch.sqrt(mcse ** 2 + ref_mcse ** 2)).max())
    ratio = sd / ref_sd
    lo, hi = float(ratio.min()), float(ratio.max())
    check(z <= MOMENT_Z, f"{label}: a posterior mean is {z:.2f} combined MCSEs from JAX's "
                         f"(limit {MOMENT_Z})")
    check(SD_RATIO[0] <= lo and hi <= SD_RATIO[1],
          f"{label}: posterior sd ratio to JAX's in [{lo:.3f}, {hi:.3f}] (limits {SD_RATIO})")
    return (f"means within {z:.2f} combined MCSEs of JAX's (max), sd ratio to JAX's [{lo:.3f}, "
            f"{hi:.3f}], median MCSE {float(mcse.median()):.2e} (JAX "
            f"{float(ref_mcse.median()):.2e} over {ref['chains']} chains)")


def sampler_run(qt, engine, fn):
    """``fn()`` with the engine's counters at 0, the peak memory reset and
    torch's sync debug mode on: (result, wall s, host syncs, gradient
    evaluations or, for a gradient-free engine, value sweeps, peak bytes). Every synchronisation flagged must be one of
    the engine's counted reads (an engine of None counts none: nothing
    may be flagged), and no BFGS kernel may launch."""
    if engine is None:
        engine = types.SimpleNamespace()
    engine.host_syncs = engine.gradient_evals = 0
    if hasattr(engine, "value_evals"):  # a gradient-free engine counts its value sweeps
        engine.value_evals = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(qt)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flagged = sum("synchroniz" in str(w.message) for w in caught)
    check(flagged == engine.host_syncs, f"{flagged} synchronisations flagged, "
                                        f"{engine.host_syncs} counted")
    check(no_kernel_launched(read_counters(qt)), "a BFGS kernel launched inside a sampler")
    evals = getattr(engine, "value_evals", engine.gradient_evals)
    return res, wall, engine.host_syncs, evals, torch.cuda.max_memory_allocated()


def rate_line(chains, draws, wall, syncs, grads, peak):
    return (f"{wall:.2f} s a call, {chains * draws / wall:.0f} draws/s, "
            f"{chains * grads / wall:.3e} gradient evaluations/s ({grads} fleet-wide), {syncs} "
            f"host syncs, peak {peak / 2**20:.0f} MiB")


def logistic_map_fleet(qt, device, label):
    """Phases 26 (a) and 27 (a): config 3's logistic model on the card
    (data and 4096 starts drawn as in phase 20) and its MAP fleet through
    `optimize_batched(tol=3e-3)`, B1 once per loop body, every lane
    converged and the median within 10 % of JAX's 11. Returns (model,
    fleet, B1 launches, (converged, median, max iterations))."""
    from quasinewtonmethods_jl_tpu_torch.models import LogisticRegressionMAP

    Xd, yd, starts = logistic_data(np.random.default_rng(BENCH_SEED))
    model = LogisticRegressionMAP(LOGISTIC_N, LOGISTIC_OBS, prior_scale=LOGISTIC_PRIOR, X=Xd,
                                  y=yd, dtype=torch.float32, device=device)
    starts = torch.tensor(starts, dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    reset_counters(qt)
    fleet = qt.optimize_batched(model, starts, tol=LOGISTIC_TOL)
    torch.cuda.synchronize()
    c = read_counters(qt)
    check(c["B1"] == c["bodies"] > 0 and c["B2a"] == c["B2b"] == c["B3"] == 0,
          f"{label}: B1 not launched once per loop body: {c}")
    converged, med, itmax, gmax = fleet_line(qt, fleet)
    check(converged == BATCH and gmax < LOGISTIC_TOL,
          f"{label}: {converged}/{BATCH} converged, max|grad| {gmax}")
    check(abs(med - JAX_LOGISTIC_MEDIAN) <= 0.1 * JAX_LOGISTIC_MEDIAN,
          f"{label}: median {med} not within 10% of {JAX_LOGISTIC_MEDIAN}")
    return model, fleet, c["B1"], (converged, med, itmax)


def sampling_b1(qt, device, n=LOGISTIC_N, queued=False):
    """B1 at the sampling fleet's shape (4096 x ``n`` f32, n = 100 by
    default; every lane active and not fresh) against its plain version:
    (max abs err, ms per launch,
    plain ms per call, (bound ms, bound kind)). Both times by CUDA events
    over back-to-back calls (median of 3 x 20, in turns): at this shape a
    launch's device time (~0.12 ms) exceeds the wrapper's host time, and
    late in the script torch.profiler has been seen to record no kernel."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.bfgs_kernel import (
        fused_bfgs_update_batched,
        fused_bfgs_update_reference,
    )

    args, _ = kernel_inputs(BENCH_SEED + n, n, BATCH, torch.float32, device, kinds=False)
    kern = fused_bfgs_update_batched(*(a.clone() for a in args))
    plain = fused_bfgs_update_reference(*(a.clone() for a in args))
    err = 0.0
    for name, a, b in zip(("B", "d", "m"), kern[:3], plain[:3]):
        rel = float((a - b).abs().max() / b.abs().max())
        check(rel <= KERNEL_RTOL[torch.float32], f"B1 at {BATCH}x{n}: {name} rel err {rel:.3e}")
        err = max(err, float((a - b).abs().max()))
    lanes_reset = int(plain[3].sum())
    ms = per_call_ms({"cuda": fused_bfgs_update_batched, "plain": fused_bfgs_update_reference},
                     args, rounds=3, calls=20, queued=queued)
    return (err, ms["cuda"], ms["plain"], b1_bound(BATCH, n, 4, BATCH, lanes_reset))


def through_file(state, tmp, name):
    """``state`` through `save_state` / `load_state` (the entry points'
    device rule: the card, the key on the CPU), every leaf checked bit for
    bit; returns the loaded state."""
    from quasinewtonmethods_jl_tpu_torch.utils.checkpoint import load_state, save_state

    path = os.path.join(tmp, name)
    save_state(path, state)
    loaded = load_state(path, type(state))
    for field, a, b in zip(state._fields, loaded, state):
        check((a is None) == (b is None), f"resume: leaf {field} lost")
        if a is not None:
            where = "cpu" if field == "key" else "cuda"
            check(a.device.type == where and a.dtype == b.dtype
                  and torch.equal(a, b.to(a.device)),
                  f"resume: leaf {field} did not reload bit for bit")
    return loaded


def sampling_resume(qt, model, x0s, mass):
    """Phase 26 (d): HMC's and ChEES's short plans (RESUME_WARMUP warmup
    steps, RESUME_DRAWS draws) long and chunked through checkpoints on the
    card, on all chains: HMC's warmup whole, ChEES's in two halves; the
    draws and every state leaf bit for bit. Returns the summary."""
    half = RESUME_WARMUP // 2
    hmc_kw = {"n_leapfrog": HMC_LEAPFROG}
    hmc = qt.hmc_sample(model, BENCH_SEED, x0s, mass, n_samples=RESUME_DRAWS,
                        n_warmup=RESUME_WARMUP, **hmc_kw)
    chees = qt.chees_sample(model, BENCH_SEED, x0s, n_samples=RESUME_DRAWS,
                            n_warmup=RESUME_WARMUP)
    with tempfile.TemporaryDirectory() as tmp:
        warm = qt.hmc_sample(model, BENCH_SEED, x0s, mass, n_samples=0,
                             n_warmup=RESUME_WARMUP, **hmc_kw)
        part = qt.hmc_sample_from_state(model, through_file(warm.state, tmp, "hmc"), mass,
                                        n_samples=RESUME_DRAWS, **hmc_kw)
        c1 = qt.chees_sample(model, BENCH_SEED, x0s, n_samples=0, n_warmup=half,
                             total_warmup=RESUME_WARMUP)
        c2 = qt.chees_sample_from_state(model, through_file(c1.state, tmp, "chees1"),
                                        n_warmup=RESUME_WARMUP - half)
        c3 = qt.chees_sample_from_state(model, through_file(c2.state, tmp, "chees2"),
                                        n_samples=RESUME_DRAWS)
    for label, long, chunked in (("HMC", hmc, part), ("ChEES", chees, c3)):
        check(torch.equal(long.samples, chunked.samples),
              f"resume: {label}'s resumed draws differ from the long run's")
        for field, a, b in zip(long.state._fields, long.state, chunked.state):
            check((a is None) == (b is None) and (a is None or torch.equal(a, b.to(a.device))),
                  f"resume: {label}'s state leaf {field} differs from the long run's")
    return (f"resume on the card: hmc_sample and chees_sample ({RESUME_WARMUP} warmup steps, "
            f"{RESUME_DRAWS} draws) against HMC's warmup and ChEES's {half} + "
            f"{RESUME_WARMUP - half} (total_warmup {RESUME_WARMUP}), each through save_state / "
            f"load_state (every leaf bit for bit, the key on the CPU), then {RESUME_DRAWS} draws, "
            f"on all {x0s.shape[0]} chains: the draws and every state leaf bit for bit")


def sampling_phase(qt, device, smi):
    """The samplers the MAP fleet hands over to (see phase 26 above).
    Returns B1's [sampling] record: (launches, max abs error, (ms, plain
    ms, bound ms, bound kind, library ms))."""
    t_phase = time.perf_counter()
    with open(SAMPLING_REF) as fh:
        ref = json.load(fh)
    # (a) the MAP fleet through B1, and the handoff
    model, fleet, launches, (converged, med, itmax) = logistic_map_fleet(
        qt, device, "sampling MAP fleet")
    x0s, mass = qt.chain_init_from_map(fleet, jitter=SAMPLING_JITTER, key=BENCH_SEED)
    info = torch.linalg.cholesky_ex(mass)[1]
    diag = torch.diagonal(mass).double().cpu().numpy()
    ref_diag = np.asarray(ref["map"]["mass_diag"])
    diag_rel = float(np.max(np.abs(diag - ref_diag) / np.abs(ref_diag)))
    check(int(info) == 0, "handoff: the mass's Cholesky failed")
    check(diag_rel <= MASS_DIAG_RTOL, f"handoff: mass diagonal {diag_rel:.3e} from JAX's")
    check(x0s.device.type == "cuda" and x0s.dtype == torch.float32 and mass.shape == (100, 100),
          "handoff: x0s / mass device, dtype or shape")
    err, b1_ms, plain_ms, (bound_ms, bound_by) = sampling_b1(qt, device)
    log(f"[sampling] MAP fleet: optimize_batched on config 3's logistic (n={LOGISTIC_N}, "
        f"{LOGISTIC_OBS} observations) {BATCH} starts f32 tol {LOGISTIC_TOL}: converged "
        f"{converged}/{BATCH}, iterations median {med:g} max {itmax} (JAX median "
        f"{ref['map']['median_iterations']:g}, {ref['map']['converged']} converged), B1 "
        f"{launches} launches = loop bodies; chain_init_from_map(jitter={SAMPLING_JITTER}): "
        f"dense mass, Cholesky ok, diagonal max rel {diag_rel:.2e} from JAX's on the same "
        f"starts; B1 at {BATCH}x{LOGISTIC_N} f32 against its plain version max abs err "
        f"{err:.3e}, {b1_ms:.4f} ms a launch (CUDA events), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), B1 at {100 * bound_ms / b1_ms:.1f} % of it on {smi}")
    del fleet

    # (b) HMC, JAX's defaults, on all chains
    chains = x0s.shape[0]
    hmc, wall, syncs, grads, peak = sampler_run(qt, qt.hmc_sample, lambda: qt.hmc_sample(
        model, BENCH_SEED, x0s, mass, n_samples=SAMPLING_DRAWS, n_warmup=SAMPLING_WARMUP,
        n_leapfrog=HMC_LEAPFROG))
    check(syncs == 0, f"HMC: {syncs} host reads in its loop")
    acc, summary = moment_gates(qt, "HMC", hmc, ref["hmc"])
    step = float(hmc.step_size.double().median())
    check(abs(acc - ref["hmc"]["accept_mean"]) <= ACCEPT_ATOL,
          f"HMC: mean accept {acc:.4f}, JAX {ref['hmc']['accept_mean']:.4f}")
    check(abs(step - ref["hmc"]["step_size_median"]) <= 0.1 * ref["hmc"]["step_size_median"],
          f"HMC: median step size {step:.4f} not within 10% of JAX's "
          f"{ref['hmc']['step_size_median']:.4f}")
    log(f"[sampling] hmc_sample {chains} chains x n={LOGISTIC_N} f32, {SAMPLING_WARMUP} warmup + "
        f"{SAMPLING_DRAWS} draws, {HMC_LEAPFROG} leapfrog steps, the handed-over dense mass: "
        f"{summary}; median step size {step:.4f} (JAX {ref['hmc']['step_size_median']:.4f}); "
        f"{rate_line(chains, SAMPLING_DRAWS, wall, syncs, grads, peak)} on {smi}")

    # (c) ChEES, the workflow's route: no mass, the fleet adapts its diagonal
    chees, wall_c, syncs_c, grads_c, peak_c = sampler_run(
        qt, qt.chees_sample, lambda: qt.chees_sample(model, BENCH_SEED, x0s,
                                                     n_samples=CHEES_DRAWS,
                                                     n_warmup=SAMPLING_WARMUP))
    rounds = SAMPLING_WARMUP + CHEES_DRAWS
    check(syncs_c == rounds, f"ChEES: {syncs_c} host reads for {rounds} rounds")
    acc_c, summary_c = moment_gates(qt, "ChEES", chees, ref["chees"])
    check(abs(acc_c - CHEES_TARGET) <= ACCEPT_ATOL,
          f"ChEES: mean accept {acc_c:.4f}, target {CHEES_TARGET}")
    log(f"[sampling] chees_sample {chains} chains x n={LOGISTIC_N} f32, {SAMPLING_WARMUP} warmup "
        f"+ {CHEES_DRAWS} draws, diagonal mass adapted by the fleet: {summary_c}; step size "
        f"{float(chees.step_size):.4f}, trajectory length {float(chees.traj_length):.4f} (JAX "
        f"on {ref['chees']['chains']} chains: {ref['chees']['step_size']:.4f} / "
        f"{ref['chees']['traj_length']:.4f}, fleet-size dependent, not gated), "
        f"{grads_c / rounds:.1f} leapfrog gradients a round; "
        f"{rate_line(chains, CHEES_DRAWS, wall_c, syncs_c, grads_c, peak_c)} on {smi}")

    # (d) resume through checkpoints, and the profiled steady state
    hmc_warm, chees_warm = hmc.state, chees.state  # warm: the profiled steady state's start
    del hmc, chees
    log(f"[sampling] {sampling_resume(qt, model, x0s, mass)}")
    for label, engine, fn in (
            ("HMC", qt.hmc_sample, lambda: qt.hmc_sample_from_state(
                model, hmc_warm, mass, n_samples=PROFILED_TRANSITIONS, n_leapfrog=HMC_LEAPFROG)),
            ("ChEES", qt.chees_sample, lambda: qt.chees_sample_from_state(
                model, chees_warm, n_samples=PROFILED_TRANSITIONS))):
        engine.gradient_evals = 0
        prof = device_profile(fn)
        log(profile_line(f"{label} {chains}x{LOGISTIC_N} f32, {PROFILED_TRANSITIONS} transitions "
                         f"from the warm state", *prof, engine.gradient_evals))
    log(f"[sampling] phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return launches, err, (b1_ms, plain_ms, bound_ms, bound_by, None)


# Phase 27, NUTS and depth-sorted NUTS: the workflow's sampler="nuts" and
# depth_sort=True routes on config 3's logistic posterior at full width
# (4096 chains, n = 100, float32). JAX's numbers come from
# scripts/jax_nuts_reference.py (512 chains; the same warmup, max_depth and
# groups, and more draws: 250 plain, 100 sorted).
NUTS_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "jax_nuts_reference.json")
# cut for the phase's 120 s and the script's time limit, in this order:
# (c)'s and (e)'s draws, then (b)'s, then the warmup (JAX's default 500;
# 500 warmup rounds and 250, 50, 100 and 10 draws took 166.7 s on one
# H100, and 500 with 100, 20, 20 and 5 left the whole script at 887.7 s;
# 250 rounds took 40.9 s of a whole script of 710.1 s with phase 29, so
# 150); every chain, the dimension, each check and gate stay
NUTS_WARMUP, NUTS_DRAWS, NUTS_MAX_DEPTH = 150, 50, 8
NUTS_DEFAULT_SORT_DRAWS, NUTS_FORCED_DRAWS, NUTS_FORCED_GROUPS = 10, 10, 4
NUTS_SORTED_RESUME_DRAWS = 5
NUTS_SHORT_WARMUP, NUTS_SHORT_DRAWS = 20, 10  # (d)'s plan, chunked at 10 + 10
NUTS_PROFILED_DRAWS = 3
NUTS_STEP_RTOL, NUTS_DEPTH_ATOL = 0.1, 0.5


def depth_histogram(mean_tree_depth):
    """Fractions of chains whose mean depth lies in [0, 0.5), [0.5, 1), ...
    (scripts/jax_nuts_reference.py's bins)."""
    d = mean_tree_depth.double().cpu().numpy()
    counts, _ = np.histogram(d, bins=np.arange(0.0, NUTS_MAX_DEPTH + 1.0, 0.5))
    return counts / counts.sum()


def histogram_text(port, jax):
    """The non-empty bins of both histograms, as 'lo-hi: port (JAX)'."""
    return ", ".join(f"{0.5 * k:g}-{0.5 * k + 0.5:g}: {p:.3f} ({j:.3f})"
                     for k, (p, j) in enumerate(zip(port, jax)) if p or j)


def nuts_short_resume(qt, model, x0s):
    """Phase 27 (d): the short plan long and chunked through two
    checkpoints, on all chains; samples, warm_dsum and every state leaf
    bit for bit."""
    kw = {"max_depth": NUTS_MAX_DEPTH}
    half = NUTS_SHORT_WARMUP // 2
    long = qt.nuts_sample(model, BENCH_SEED, x0s, n_samples=NUTS_SHORT_DRAWS,
                          n_warmup=NUTS_SHORT_WARMUP, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        c1 = qt.nuts_sample(model, BENCH_SEED, x0s, n_samples=0, n_warmup=half,
                            total_warmup=NUTS_SHORT_WARMUP, **kw)
        c2 = qt.nuts_sample_from_state(model, through_file(c1.state, tmp, "nuts1"),
                                       n_warmup=NUTS_SHORT_WARMUP - half, **kw)
        c3 = qt.nuts_sample_from_state(model, through_file(c2.state, tmp, "nuts2"),
                                       n_samples=NUTS_SHORT_DRAWS, **kw)
    check(torch.equal(long.samples, c3.samples), "NUTS resume: chunked draws differ from the "
                                                 "long run's")
    for field, a, b in zip(qt.NUTSState._fields, long.state, c3.state):
        check((a is None) == (b is None) and (a is None or torch.equal(a, b.to(a.device))),
              f"NUTS resume: state leaf {field} differs from the long run's")
    return (f"resume on the card: nuts_sample({NUTS_SHORT_WARMUP} warmup, {NUTS_SHORT_DRAWS} "
            f"draws) against {half} + {NUTS_SHORT_WARMUP - half} warmup rounds and "
            f"{NUTS_SHORT_DRAWS} draws through two save_state / load_state checkpoints on all "
            f"{x0s.shape[0]} chains: samples, warm_dsum and every state leaf bit for bit")


def nuts_phase(qt, device, smi):
    """NUTS and depth-sorted NUTS (see phase 27 above). Returns B1's [nuts]
    record: (launches, max abs error, (ms, plain ms, bound ms, bound kind,
    library ms))."""
    t_phase = time.perf_counter()
    with open(NUTS_REF) as fh:
        ref = json.load(fh)
    plan = ref["plan"]
    check((plan["warmup"], plan["max_depth"], plan["forced_groups"])
          == (NUTS_WARMUP, NUTS_MAX_DEPTH, NUTS_FORCED_GROUPS)
          and plan["draws"] >= NUTS_DRAWS and plan["forced_draws"] >= NUTS_FORCED_DRAWS,
          f"NUTS: scripts/jax_nuts_reference.json ran another plan: {plan}")
    kw = {"max_depth": NUTS_MAX_DEPTH}

    # (a) the MAP fleet through B1, and the handoff the workflow makes
    model, fleet, launches, (converged, med, itmax) = logistic_map_fleet(
        qt, device, "NUTS MAP fleet")
    x0s, _mass = qt.chain_init_from_map(fleet, jitter=SAMPLING_JITTER, key=BENCH_SEED)
    del fleet, _mass
    check(x0s.device.type == "cuda" and x0s.dtype == torch.float32
          and x0s.shape == (BATCH, LOGISTIC_N), "NUTS handoff: x0s device, dtype or shape")
    err, b1_ms, plain_ms, (bound_ms, bound_by) = sampling_b1(qt, device)
    chains = x0s.shape[0]
    log(f"[nuts] MAP fleet: optimize_batched on config 3's logistic {BATCH} starts f32 tol "
        f"{LOGISTIC_TOL}: converged {converged}/{BATCH}, iterations median {med:g} max {itmax} "
        f"(JAX median {ref['map']['median_iterations']:g}, {ref['map']['converged']} "
        f"converged), B1 {launches} launches = loop bodies; chain_init_from_map(jitter="
        f"{SAMPLING_JITTER}); B1 at {BATCH}x{LOGISTIC_N} f32 against its plain version max abs "
        f"err {err:.3e}, {b1_ms:.4f} ms a launch (CUDA events), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}) on {smi}")

    # (b) the depth-sort route: warmup alone, a checkpoint, then the draws
    warm_res, wall_w, syncs_w, grads_w, peak_w = sampler_run(
        qt, qt.nuts_sample, lambda: qt.nuts_sample(model, BENCH_SEED, x0s, n_samples=0,
                                                   n_warmup=NUTS_WARMUP,
                                                   total_warmup=NUTS_WARMUP, **kw))
    with tempfile.TemporaryDirectory() as tmp:
        warm = through_file(warm_res.state, tmp, "nuts_warm")
    del warm_res
    nuts, wall, syncs, grads, peak = sampler_run(
        qt, qt.nuts_sample, lambda: qt.nuts_sample_from_state(model, warm,
                                                              n_samples=NUTS_DRAWS, **kw))
    r = ref["nuts"]
    acc, summary = moment_gates(qt, "NUTS", nuts, r, accept="accept_prob")
    step = float(nuts.step_size.double().median())
    depth = float(nuts.mean_tree_depth.double().mean())
    check(abs(acc - r["accept_mean"]) <= ACCEPT_ATOL,
          f"NUTS: mean accept {acc:.4f}, JAX {r['accept_mean']:.4f}")
    check(abs(step - r["step_size_median"]) <= NUTS_STEP_RTOL * r["step_size_median"],
          f"NUTS: median step size {step:.4f} not within 10% of JAX's "
          f"{r['step_size_median']:.4f}")
    check(abs(depth - r["mean_depth"]) <= NUTS_DEPTH_ATOL,
          f"NUTS: mean tree depth {depth:.3f}, JAX {r['mean_depth']:.3f}")
    hist = histogram_text(depth_histogram(nuts.mean_tree_depth), r["depth_histogram"])
    log(f"[nuts] nuts_sample {chains} chains x n={LOGISTIC_N} f32, no mass (the fleet adapts "
        f"its diagonal), max_depth {NUTS_MAX_DEPTH}: {NUTS_WARMUP} warmup rounds in "
        f"{wall_w:.2f} s ({syncs_w} host reads, {grads_w} fleet-wide gradients, "
        f"{syncs_w / NUTS_WARMUP:.1f} reads and {grads_w / NUTS_WARMUP:.1f} gradients a round), "
        f"the state through save_state / load_state bit for bit, then nuts_sample_from_state "
        f"{NUTS_DRAWS} draws (JAX {plan['draws']}): {summary}; median step size {step:.4f} (JAX "
        f"{r['step_size_median']:.4f}); mean tree depth {depth:.3f} (JAX {r['mean_depth']:.3f}), "
        f"chains' mean depths port (JAX) {hist}; {syncs / NUTS_DRAWS:.1f} host reads and "
        f"{grads / NUTS_DRAWS:.1f} fleet-wide gradients a draw (JAX: none, its loops stay on the "
        f"device; a chain's tree of depth d takes 2^d to 2^(d+1) - 1 leaves); "
        f"{rate_line(chains, NUTS_DRAWS, wall, syncs, grads, peak)} on {smi}")

    # (c) depth-sorted: the default decision, then the sorted path forced
    (res_d, info_d), wall_d, syncs_d, _g, _p = sampler_run(
        qt, qt.nuts_sample, lambda: qt.nuts_sample_depth_sorted(
            model, warm, NUTS_DEFAULT_SORT_DRAWS, **kw))
    jd = ref["default_sort"]
    if info_d.sorted:
        _acc, text_d = moment_gates(qt, "NUTS depth-sorted (default)", res_d, r,
                                    accept="accept_prob")
    else:
        check(torch.equal(res_d.samples, nuts.samples[:NUTS_DEFAULT_SORT_DRAWS]),
              "NUTS depth-sorted fallback: draws differ from the plain run's first "
              f"{NUTS_DEFAULT_SORT_DRAWS}")
        text_d = (f"its draws equal the first {NUTS_DEFAULT_SORT_DRAWS} of (b)'s bit for bit "
                  f"(the fallback)")
    log(f"[nuts] nuts_sample_depth_sorted(warm, {NUTS_DEFAULT_SORT_DRAWS}) with its defaults: "
        f"sorted {info_d.sorted}, persistence {info_d.persistence:.4f}, depth spread "
        f"{info_d.depth_spread:.4f} (JAX on {r['chains']} chains: sorted {jd['sorted']}, "
        f"persistence {jd['persistence']:.4f}, spread {jd['depth_spread']:.4f}; not gated); "
        f"{text_d}; {wall_d:.2f} s, {syncs_d} host reads on {smi}")
    del res_d
    (forced, info_f), wall_f, syncs_f, grads_f, _p = sampler_run(
        qt, qt.nuts_sample, lambda: qt.nuts_sample_depth_sorted(
            model, warm, NUTS_FORCED_DRAWS, groups=NUTS_FORCED_GROUPS, min_persistence=-1.0,
            min_depth_spread=0.0, **kw))
    jf = ref["forced_sort"]
    check(info_f.sorted, f"NUTS forced sort: did not sort ({info_f})")
    check(sum(info_f.group_sizes) == chains and len(info_f.group_sizes) == NUTS_FORCED_GROUPS,
          f"NUTS forced sort: group sizes {info_f.group_sizes}")
    _acc_f, text_f = moment_gates(qt, "NUTS forced sort", forced, jf, accept="accept_prob")
    check(torch.equal(forced.final_x, forced.state.x),
          "NUTS forced sort: final_x is not the merged state's x")
    cont = qt.nuts_sample_from_state(model, forced.state, n_samples=NUTS_SORTED_RESUME_DRAWS, **kw)
    check(cont.samples.shape == (NUTS_SORTED_RESUME_DRAWS, chains, LOGISTIC_N)
          and bool(torch.isfinite(cont.samples).all()),
          "NUTS forced sort: the merged state does not resume")
    del cont
    log(f"[nuts] nuts_sample_depth_sorted(warm, {NUTS_FORCED_DRAWS}, groups="
        f"{NUTS_FORCED_GROUPS}, min_persistence=-1, min_depth_spread=0): sorted, groups "
        f"{info_f.group_sizes}, their mean depths "
        f"{', '.join(f'{v:.3f}' for v in info_f.group_mean_depths)} (JAX on {jf['chains']} "
        f"chains and {jf['draws']} draws: "
        f"{', '.join(f'{v:.3f}' for v in jf['group_mean_depths'])}); {text_f}; "
        f"final_x = the merged state's x, which resumes for {NUTS_SORTED_RESUME_DRAWS} draws; "
        f"{wall_f / NUTS_FORCED_DRAWS:.4f} s a draw over the {NUTS_FORCED_GROUPS} sub-fleets in "
        f"turn ({grads_f / NUTS_FORCED_DRAWS:.1f} sub-fleet gradients a draw, {syncs_f} host "
        f"reads) against (b)'s {wall / NUTS_DRAWS:.4f} s a draw (not gated) on {smi}")
    del forced, nuts

    # (d) the short plan through checkpoints
    log(f"[nuts] {nuts_short_resume(qt, model, x0s)}")

    # (e) the profiled steady state
    qt.nuts_sample.gradient_evals = 0
    prof = device_profile(lambda: qt.nuts_sample_from_state(
        model, warm, n_samples=NUTS_PROFILED_DRAWS, **kw))
    log(profile_line(f"NUTS {chains}x{LOGISTIC_N} f32, {NUTS_PROFILED_DRAWS} draws from the warm "
                     f"state, per leaf, on {smi}", *prof, qt.nuts_sample.gradient_evals))
    log(f"[nuts] phase 27 took {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches, err, (b1_ms, plain_ms, bound_ms, bound_by, None)


# Phase 28, the workflow's other two initializers and PSIS: Pathfinder, SVGD,
# and PSIS-LOO / WAIC on config 3's logistic posterior at full width (4096
# draws, particles and chains, n = 100, float32). JAX's numbers come from
# scripts/jax_pathfinder_reference.py (10 keys for (a), six one-ulp
# witnesses for (b), 6 keys for (c): its docstring says why more than 3, 1
# and 2).
PATHFINDER_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                              "jax_pathfinder_reference.json")
PF_DRAWS, PF_INIT_SCALE = 4096, 1.0
PF_CHEES_WARMUP, PF_CHEES_DRAWS = 150, 50  # the ChEES handoff's short plan
BAND_WIDEN = 0.5  # a JAX band widened by half its width on each side
MOMENT_SPREAD = 1.5  # the draws' moments: JAX's leave-one-key-out distance, widened by half
SVGD_WITNESS_FACTOR = 2.0
LOO_SPREAD_FACTOR = 2.0
# the card's float32 LOO / WAIC against the float64 oracle on the CPU: the
# sums over 4096 draws and 500 observations in float32, and k-hat's fit on
# float32 exceedances (PERF.md §6 has the measured differences)
LOO_F32_RTOL, LOO_KHAT_ATOL = 1e-5, 1e-3


def band_check(label, value, values):
    """``value`` inside [min, max] of ``values`` widened by BAND_WIDEN of
    its width on each side; returns the text of the check."""
    lo, hi = min(values), max(values)
    pad = BAND_WIDEN * (hi - lo)
    check(lo - pad <= value <= hi + pad,
          f"{label} {value:.4f} outside JAX's band [{lo:.4f}, {hi:.4f}] widened to "
          f"[{lo - pad:.4f}, {hi + pad:.4f}]")
    return f"{label} {value:.4f} (JAX [{lo:.4f}, {hi:.4f}] over {len(values)} keys)"


def moment_distance(mean, sd, ref_means, ref_sds):
    """Distances of one run's per-coordinate draw mean and sd from JAX's
    key means: (max over coordinates of |mean - JAX mean| / JAX sd, max of
    |log sd - JAX mean log sd|), and JAX's own largest leave-one-key-out
    distances for each."""
    ref_means, ref_sds = np.asarray(ref_means), np.asarray(ref_sds)
    scale = ref_sds.mean(axis=0)

    def dist(m, s, means, sds):
        return (float(np.max(np.abs(m - means.mean(axis=0)) / scale)),
                float(np.max(np.abs(np.log(s) - np.log(sds).mean(axis=0)))))

    own = [dist(ref_means[k], ref_sds[k], np.delete(ref_means, k, 0), np.delete(ref_sds, k, 0))
           for k in range(len(ref_means))]
    return dist(mean, sd, ref_means, ref_sds), (max(d[0] for d in own), max(d[1] for d in own))


def pathfinder_leg(qt, device, smi, ref, model):
    """Phase 28 (a): the init="pathfinder" route and its ChEES handoff."""
    runs = ref["runs"]
    x0 = torch.zeros(LOGISTIC_N, dtype=torch.float32, device=device)

    def call():
        return qt.pathfinder(model, BENCH_SEED, x0, n_draws=PF_DRAWS, init_scale=PF_INIT_SCALE)

    pf, wall, syncs, evals, peak = sampler_run(qt, qt.pathfinder, call)
    check(bool(torch.isfinite(pf.draws).all()), "pathfinder: NaN or inf in the draws")
    check(pf.draws.shape == (PF_DRAWS, LOGISTIC_N) and pf.pool.shape == (8 * 2048, LOGISTIC_N),
          f"pathfinder: draws {tuple(pf.draws.shape)}, pool {tuple(pf.pool.shape)}")
    status = pf.status.cpu().numpy()
    elbo = pf.elbo.double().cpu().numpy()
    jax_finite = all(all(r["elbo_finite"]) for r in runs)
    jax_nonfinite = any(int(qt.Status.NONFINITE_VALUE) in r["status"] for r in runs)
    check(not jax_finite or bool(np.isfinite(elbo).all()),
          f"pathfinder: a path's ELBO is not finite where JAX's are: {elbo}")
    check(jax_nonfinite or int(qt.Status.NONFINITE_VALUE) not in status,
          f"pathfinder: a NONFINITE_VALUE status where JAX has none: {status}")
    texts = [band_check("median path ELBO", float(np.median(elbo)),
                        [r["median_elbo"] for r in runs]),
             band_check("khat", float(pf.khat), [r["khat"] for r in runs])]
    d = pf.draws.double()
    (dm, ds), (own_m, own_s) = moment_distance(
        d.mean(dim=0).cpu().numpy(), d.std(dim=0, correction=0).cpu().numpy(),
        [r["mean"] for r in runs], [r["sd"] for r in runs])
    check(dm <= MOMENT_SPREAD * own_m and ds <= MOMENT_SPREAD * own_s,
          f"pathfinder: draws' moments {dm:.4f} sd / {ds:.4f} log-sd from JAX's key means, "
          f"limits {MOMENT_SPREAD} x JAX's own {own_m:.4f} / {own_s:.4f}")
    n_fev, n_gev = pf.n_fev.cpu().numpy(), pf.n_gev.cpu().numpy()
    jr = runs[0]
    log(f"[init] pathfinder(model, key, zeros({LOGISTIC_N}), n_draws={PF_DRAWS}, init_scale="
        f"{PF_INIT_SCALE}) on config 3's logistic f32, 8 paths x 2048 (pool 16384), 64 "
        f"iterations, 16 ELBO draws: {'; '.join(texts)}; draws' means {dm:.4f} sd and sds "
        f"{ds:.4f} log-sd from JAX's key means (JAX's own leave-one-out {own_m:.4f} / "
        f"{own_s:.4f}); statuses {status.tolist()} (JAX key {jr['key']}: {jr['status']}), "
        f"iterations {pf.iterations.tolist()} (JAX {jr['iterations']}), best_iter "
        f"{pf.best_iter.tolist()} (JAX {jr['best_iter']}), n_fev {n_fev.tolist()} (JAX "
        f"{jr['n_fev']}), n_gev {n_gev.tolist()} (JAX {jr['n_gev']}); {wall:.2f} s a call (JAX "
        f"on a CPU {jr['cpu_seconds']} s), {int(n_fev.sum()) / wall:.3e} objective evaluations/s "
        f"({evals} fleet-wide calls), {syncs} host syncs (every flagged one counted), peak "
        f"{peak / 2**20:.0f} MiB on {smi}")
    mass = pf.mass()
    chees, wall_c, syncs_c, grads_c, peak_c = sampler_run(
        qt, qt.chees_sample, lambda: qt.chees_sample(model, BENCH_SEED, pf.draws, mass=mass,
                                                     n_samples=PF_CHEES_DRAWS,
                                                     n_warmup=PF_CHEES_WARMUP))
    check(bool(torch.isfinite(chees.samples).all()), "pathfinder -> ChEES: NaN in the samples")
    acc = float(chees.accept_rate.double().mean())
    check(abs(acc - CHEES_TARGET) <= ACCEPT_ATOL,
          f"pathfinder -> ChEES: mean accept {acc:.4f}, target {CHEES_TARGET}")
    log(f"[init] the handoff: chees_sample(model, key, pf.draws, mass=pf.mass()) {PF_DRAWS} chains "
        f"({PF_CHEES_WARMUP} warmup, {PF_CHEES_DRAWS} draws), the LowRankMass of the best path "
        f"(rank {mass.Q.shape[1]}): mean accept {acc:.4f} (target {CHEES_TARGET}), step "
        f"{float(chees.step_size):.4f}, trajectory length {float(chees.traj_length):.4f}; "
        f"{rate_line(PF_DRAWS, PF_CHEES_DRAWS, wall_c, syncs_c, grads_c, peak_c)} on {smi}")
    del chees, mass
    qt.pathfinder.gradient_evals = 0
    prof = device_profile(call)
    log(profile_line(f"pathfinder 8 paths x n={LOGISTIC_N} f32, one call, per loop body", *prof,
                     64))
    return wall


def svgd_leg(qt, device, smi, ref, model, starts):
    """Phase 28 (b): the init="svgd" route, its witness gates and its
    chunked resume."""
    X0 = torch.tensor(starts, dtype=torch.float32, device=device)
    res, wall, syncs, _e, peak = sampler_run(qt, None, lambda: qt.svgd_sample(model, X0))
    check(syncs == 0, "svgd: a host read in its loop")
    base, witnesses = ref["base"], ref["witnesses"].values()
    p = res.particles.double()
    port = {"bandwidth": np.asarray([float(res.bandwidth)]),
            "mean": p.mean(dim=0).cpu().numpy(), "sd": p.std(dim=0, correction=0).cpu().numpy(),
            "rows": p[::ref["plan"]["row_stride"]].cpu().numpy()}
    texts = []
    for name, mine in port.items():
        jb = np.atleast_1d(np.asarray(base[name]))
        err = float(np.max(np.abs(mine - jb)))
        spread = max(float(np.max(np.abs(np.atleast_1d(np.asarray(w[name])) - jb)))
                     for w in witnesses)
        check(err <= SVGD_WITNESS_FACTOR * spread,
              f"svgd: {name} {err:.3e} from JAX's, limit {SVGD_WITNESS_FACTOR} x JAX's one-ulp "
              f"spread {spread:.3e}")
        texts.append(f"{name} {err:.3e} (JAX's one-ulp spread {spread:.3e})")
    check(bool(torch.isfinite(res.logp).all()), "svgd: a particle's log-density is not finite")
    with tempfile.TemporaryDirectory() as tmp:
        half = qt.svgd_sample(model, X0, n_steps=250)
        rest = qt.svgd_sample_from_state(model, through_file(half.state, tmp, "svgd"),
                                         n_steps=250)
    for field, a, b in zip(qt.SVGDState._fields, rest.state, res.state):
        check(torch.equal(a, b), f"svgd resume: state leaf {field} differs from the long run's")
    check(torch.equal(rest.bandwidth, res.bandwidth), "svgd resume: the bandwidth differs")
    log(f"[init] svgd_sample(model, {BATCH} particles) 500 steps f32 (x0 = 0 plus phase 20's "
        f"numpy starts): bandwidth {float(res.bandwidth):.6f} (JAX {base['bandwidth']:.6f}); max "
        f"abs differences from JAX's run: {', '.join(texts)}; 250 + save_state / load_state + "
        f"250 steps equal to 500 bit for bit; {wall:.2f} s a call (JAX on a CPU "
        f"{base['cpu_seconds']} s), {BATCH * 501 / wall:.3e} objective evaluations/s, {syncs} host "
        f"syncs, peak {peak / 2**20:.0f} MiB on {smi}")
    del half, rest
    prof = device_profile(lambda: qt.svgd_sample(model, X0))
    log(profile_line(f"svgd {BATCH} x n={LOGISTIC_N} f32, one call (500 steps), per step", *prof,
                     500))
    return wall


def pointwise_loglik(X, y, draws):
    """The (S, N) Bernoulli log-likelihood log p(y_i | w_s) of config 3."""
    logits = draws @ X.T
    return (y * torch.nn.functional.logsigmoid(logits)
            + (1.0 - y) * torch.nn.functional.logsigmoid(-logits))


def loo_leg(qt, device, smi, ref):
    """Phase 28 (c): LOO and WAIC on HMC draws from the B1 MAP fleet.
    Returns B1's [loo] record and what phase 30 takes over: (model, the MAP
    fleet, the HMC run's EVIDENCE_DRAWS draws)."""
    plan = ref["plan"]
    model, fleet, launches, (converged, med, itmax) = logistic_map_fleet(qt, device,
                                                                         "LOO MAP fleet")
    x0s, mass = qt.chain_init_from_map(fleet, jitter=plan["jitter"], key=BENCH_SEED)
    err, b1_ms, plain_ms, (bound_ms, bound_by) = sampling_b1(qt, device)
    t0 = time.perf_counter()
    # a draw's noise depends on (key, phase, step) only, so the first of
    # EVIDENCE_DRAWS draws is the draw of JAX's LOO plan of plan["draws"]
    hmc = qt.hmc_sample(model, BENCH_SEED, x0s, mass, n_samples=EVIDENCE_DRAWS,
                        n_warmup=plan["warmup"], n_leapfrog=plan["leapfrog"])
    torch.cuda.synchronize()
    wall_h = time.perf_counter() - t0
    check(bool(torch.isfinite(hmc.samples).all()), "LOO: NaN in the HMC draws")
    draws = hmc.samples
    ll = pointwise_loglik(model.X, model.y, draws[:plan["draws"]].reshape(-1, LOGISTIC_N))
    del hmc, x0s, mass
    check(ll.shape == (BATCH, LOGISTIC_OBS) and ll.device.type == device.type,
          f"LOO: pointwise log-likelihood {tuple(ll.shape)} on {ll.device}")
    (lo, w), wall_l, syncs_l, _e, peak_l = sampler_run(qt, None,
                                                        lambda: (qt.loo_psis(ll), qt.waic(ll)))
    oracle_l, oracle_w = qt.loo_psis(ll.double().cpu()), qt.waic(ll.double().cpu())
    rel = {}
    for name, a, b in (("elpd_loo", lo.elpd, oracle_l.elpd), ("se_loo", lo.se, oracle_l.se),
                       ("p_loo", lo.p_loo, oracle_l.p_loo), ("elpd_waic", w.elpd, oracle_w.elpd),
                       ("se_waic", w.se, oracle_w.se), ("p_waic", w.p_waic, oracle_w.p_waic)):
        rel[name] = abs(float(a) - float(b)) / abs(float(b))
        check(rel[name] <= LOO_F32_RTOL, f"LOO: {name} {float(a):.6f} on the card, "
                                         f"{float(b):.6f} in float64 on the CPU")
    khat, khat64 = lo.khat.double().cpu(), oracle_l.khat
    check(bool(torch.equal(torch.isfinite(khat), torch.isfinite(khat64))),
          "LOO: a khat finite on one side only")
    fin = torch.isfinite(khat64)
    khat_err = float((khat[fin] - khat64[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(khat_err <= LOO_KHAT_ATOL, f"LOO: khat {khat_err:.3e} from the float64 oracle")
    texts = []
    for name, value in (("elpd_loo", float(lo.elpd)), ("elpd_waic", float(w.elpd))):
        vals = [r[name] for r in ref["runs"]]
        centre, spread = float(np.mean(vals)), max(vals) - min(vals)
        check(abs(value - centre) <= LOO_SPREAD_FACTOR * spread,
              f"LOO: {name} {value:.4f} is {abs(value - centre):.4f} from JAX's mean {centre:.4f}, "
              f"limit {LOO_SPREAD_FACTOR} x JAX's key-to-key spread {spread:.4f}")
        texts.append(f"{name} {value:.4f} (JAX {centre:.4f}, spread {spread:.4f} over "
                     f"{len(vals)} keys)")
    over = int((khat > 0.7).sum())
    log(f"[init] LOO MAP fleet: optimize_batched on config 3's logistic {BATCH} starts f32 tol "
        f"{LOGISTIC_TOL}: converged {converged}/{BATCH}, iterations median {med:g} max {itmax} "
        f"(JAX median {ref['map']['median_iterations']:g}), B1 {launches} launches = loop "
        f"bodies; chain_init_from_map(jitter={plan['jitter']}), hmc_sample {plan['warmup']} "
        f"warmup + {EVIDENCE_DRAWS} draws x {BATCH} chains ({plan['leapfrog']} leapfrog steps; "
        f"the first draw for LOO, all {EVIDENCE_DRAWS} for phase 30) in {wall_h:.2f} s; "
        f"loo_psis + waic on the ({BATCH}, {LOGISTIC_OBS}) pointwise "
        f"log-likelihood on the card in {wall_l:.4f} s ({syncs_l} host syncs, peak "
        f"{peak_l / 2**20:.0f} MiB): {', '.join(texts)}; se {float(lo.se):.4f}, p_loo "
        f"{float(lo.p_loo):.4f}, p_waic {float(w.p_waic):.4f}, khat max {float(khat.max()):.4f}, "
        f"{over} over 0.7 (JAX {ref['runs'][0]['khat_over_07']}); against the float64 oracle "
        f"on the CPU: max rel {max(rel.values()):.2e} (limit {LOO_F32_RTOL}), khat max abs "
        f"{khat_err:.2e} (limit {LOO_KHAT_ATOL}); B1 at {BATCH}x{LOGISTIC_N} f32 against its "
        f"plain version max abs err {err:.3e}, {b1_ms:.4f} ms a launch (CUDA events), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) on {smi}")
    return (launches, err, (b1_ms, plain_ms, bound_ms, bound_by, None)), (model, fleet, draws)


def initializers_phase(qt, device, smi):
    """The workflow's other two initializers and PSIS (see phase 28 above).
    Returns B1's [loo] record and (c)'s handoff to phase 30."""
    from quasinewtonmethods_jl_tpu_torch.models import LogisticRegressionMAP

    t_phase = time.perf_counter()
    with open(PATHFINDER_REF) as fh:
        ref = json.load(fh)
    check(ref["pathfinder"]["plan"] == {"n_draws": PF_DRAWS, "init_scale": PF_INIT_SCALE,
                                        "keys": len(ref["pathfinder"]["runs"])}
          and ref["svgd"]["plan"]["particles"] == BATCH and ref["svgd"]["plan"]["n_steps"] == 500,
          "initializers: scripts/jax_pathfinder_reference.json ran another plan")
    Xd, yd, starts = logistic_data(np.random.default_rng(BENCH_SEED))
    model = LogisticRegressionMAP(LOGISTIC_N, LOGISTIC_OBS, prior_scale=LOGISTIC_PRIOR, X=Xd,
                                  y=yd, dtype=torch.float32, device=device)
    walls = [pathfinder_leg(qt, device, smi, ref["pathfinder"], model),
             svgd_leg(qt, device, smi, ref["svgd"], model, starts)]
    record, handoff = loo_leg(qt, device, smi, ref["loo"])
    log(f"[init] phase 28 took {time.perf_counter() - t_phase:.1f} s (pathfinder {walls[0]:.2f} "
        f"s, svgd {walls[1]:.2f} s a call) on {smi}")
    return record, handoff


# Phase 29, the other three samplers: MCLMC, the affine-invariant ensemble and
# replica-exchange HMC, the workflow's sampler="mclmc" / "ensemble" / "pt"
# routes on config 3's logistic posterior at full width (4096 chains, n =
# 100, float32), and replica exchange on the bimodal mixture it exists for.
# JAX's numbers come from scripts/jax_tempering_reference.py (512 chains for
# MCLMC and PT on the same plans; the ensemble and the mixture at full width
# under 10 keys: its docstring says why more than 3).
TEMPERING_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                             "jax_tempering_reference.json")
MCLMC_WARMUP, MCLMC_DRAWS, MCLMC_TARGET = 200, 200, 5e-4
ENSEMBLE_WARMUP, ENSEMBLE_DRAWS = 300, 200
PT_WARMUP, PT_DRAWS, PT_TEMPS = 80, 80, 8
BIMODAL_TEMPS, BIMODAL_BETA_MIN, BIMODAL_LEAPFROG = 6, 0.05, 8
BIMODAL_WARMUP, BIMODAL_DRAWS = 100, 150
ENERGY_VAR_BAND = (0.5, 2.0)  # energy_var over desired_energy_var
STEP_RTOL = 0.1  # step size and L against JAX's
MODE_ATOL = 0.05  # the mixture's mode weights against [0.75, 0.25]
# the autocorrelation time's host FFTs over this many walkers (all 4096: ~12 s)
TAU_WALKERS = 512
# steps or rounds profiled (mclmc and ensemble 20 until phase 32 was added)
SAMPLERS_PROFILED = {"mclmc": 10, "ensemble": 10, "pt": 3}
# (f)'s short plans, long and through a checkpoint: (warmup, draws)
SAMPLERS_RESUME = {"mclmc": (20, 10), "ensemble": (20, 10), "pt": (6, 4)}


def within(label, value, ref, rtol):
    check(abs(value - ref) <= rtol * abs(ref), f"{label} {value:.4f} not within "
                                               f"{100 * rtol:.0f} % of JAX's {ref:.4f}")
    return f"{label} {value:.4f} (JAX {ref:.4f})"


def mclmc_leg(qt, smi, ref, model, x0s, mass):
    """Phase 29 (b): the sampler="mclmc" route."""
    chains, steps = x0s.shape[0], MCLMC_WARMUP + MCLMC_DRAWS
    res, wall, syncs, grads, peak = sampler_run(qt, qt.mclmc_sample, lambda: qt.mclmc_sample(
        model, BENCH_SEED, x0s, mass, n_samples=MCLMC_DRAWS, n_warmup=MCLMC_WARMUP))
    check(bool(torch.isfinite(res.samples).all()), "mclmc: NaN or inf in the samples")
    check(syncs == 0, f"mclmc: {syncs} host reads in its loop")
    check(grads == 2 * steps + 1, f"mclmc: {grads} fleet-wide gradients for {steps} steps")
    divs = int(res.divergences.sum())
    check(ref["divergences"] > 0 or divs == 0, f"mclmc: {divs} divergences, JAX none")
    ev = float(res.energy_var)
    check(ENERGY_VAR_BAND[0] * MCLMC_TARGET <= ev <= ENERGY_VAR_BAND[1] * MCLMC_TARGET,
          f"mclmc: energy_var {ev:.3e} outside {ENERGY_VAR_BAND} x {MCLMC_TARGET}")
    texts = [within("step size", float(res.step_size), ref["step_size"], STEP_RTOL),
             within("L", float(res.L), ref["L"], STEP_RTOL)]
    mean, sd, mcse, _rhat = chain_moments(qt, res.samples)
    summary = mcse_gates("mclmc", mean, sd, mcse, ref)
    log(f"[samplers] mclmc_sample {chains} chains x n={LOGISTIC_N} f32, {MCLMC_WARMUP} warmup + "
        f"{MCLMC_DRAWS} draws, the handed-over dense B (its diagonal): {summary}; "
        f"{', '.join(texts)}; energy_var {ev:.3e} (target {MCLMC_TARGET}, JAX "
        f"{ref['energy_var']:.3e}); divergences {divs} (JAX {ref['divergences']}); "
        f"{rate_line(chains, MCLMC_DRAWS, wall, syncs, grads, peak)} on {smi}")
    return res.state, wall


def ensemble_leg(qt, smi, ref, model, x0s, partner):
    """Phase 29 (c): the sampler="ensemble" route with one partner rule."""
    walkers, steps = x0s.shape[0], ENSEMBLE_WARMUP + ENSEMBLE_DRAWS
    autograd = []
    real_grad, real_backward = torch.autograd.grad, torch.autograd.backward

    def spy(real):
        def wrapped(*args, **kwargs):
            autograd.append(real)
            return real(*args, **kwargs)
        return wrapped

    torch.autograd.grad, torch.autograd.backward = spy(real_grad), spy(real_backward)
    try:
        res, wall, syncs, evals, peak = sampler_run(
            qt, qt.ensemble_sample, lambda: qt.ensemble_sample(
                model, BENCH_SEED, x0s, n_samples=ENSEMBLE_DRAWS, n_warmup=ENSEMBLE_WARMUP,
                partner=partner))
    finally:
        torch.autograd.grad, torch.autograd.backward = real_grad, real_backward
    label = f"ensemble[{partner}]"
    check(bool(torch.isfinite(res.samples).all()), f"{label}: NaN or inf in the samples")
    check(not autograd and res.samples.grad_fn is None and res.state.f.grad_fn is None,
          f"{label}: a gradient was evaluated ({len(autograd)} autograd passes)")
    check(evals == 2 * steps + 1, f"{label}: {evals} value sweeps for {steps} steps")
    check(syncs == 0, f"{label}: {syncs} host reads in its loop")
    runs = ref[partner]
    acc = float(res.accept_rate.double().mean())
    texts = [band_check("mean accept", acc, [r["accept_mean"] for r in runs])]
    d = res.samples.double().reshape(-1, LOGISTIC_N)
    (dm, ds), (own_m, own_s) = moment_distance(
        d.mean(dim=0).cpu().numpy(), d.std(dim=0, correction=0).cpu().numpy(),
        [r["mean"] for r in runs], [r["sd"] for r in runs])
    check(dm <= MOMENT_SPREAD * own_m and ds <= MOMENT_SPREAD * own_s,
          f"{label}: draws' moments {dm:.4f} sd / {ds:.4f} log-sd from JAX's key means, limits "
          f"{MOMENT_SPREAD} x JAX's own {own_m:.4f} / {own_s:.4f}")
    tau, _rel = qt.ensemble_autocorr_time(res.samples[:, :TAU_WALKERS])
    log(f"[samplers] ensemble_sample(partner={partner!r}) {walkers} walkers x n={LOGISTIC_N} "
        f"f32 from the jittered MAP starts, {ENSEMBLE_WARMUP} warmup + {ENSEMBLE_DRAWS} draws: "
        f"{texts[0]}; draws' means {dm:.4f} sd and sds {ds:.4f} log-sd from JAX's key means "
        f"(JAX's own leave-one-out {own_m:.4f} / {own_s:.4f}); autocorrelation time over the "
        f"first {TAU_WALKERS} walkers median "
        f"{float(np.median(tau)):.2f} max {float(np.max(tau)):.2f} (JAX "
        f"{runs[0]['tau_median']:.2f} / {runs[0]['tau_max']:.2f}); no autograd pass; "
        f"{wall:.2f} s a call, {walkers * ENSEMBLE_DRAWS / wall:.0f} draws/s, "
        f"{walkers / 2 * evals / wall:.3e} walker evaluations/s ({evals} half-fleet sweeps), "
        f"{syncs} host syncs, peak {peak / 2**20:.0f} MiB on {smi}")
    return res.state, wall


def pt_leg(qt, smi, ref, model, x0s, mass):
    """Phase 29 (d): the sampler="pt" route, the defaults on every chain."""
    chains = x0s.shape[0]
    res, wall, syncs, grads, peak = sampler_run(qt, qt.pt_sample, lambda: qt.pt_sample(
        model, BENCH_SEED, x0s, mass, n_samples=PT_DRAWS, n_warmup=PT_WARMUP))
    rounds = PT_WARMUP + PT_DRAWS
    check(bool(torch.isfinite(res.samples).all()) and bool(torch.isfinite(res.final_x).all()),
          "pt: NaN or inf in the replicas")
    check(syncs == 0, f"pt: {syncs} host reads in its loop")
    check(res.state.x.shape == (PT_TEMPS, chains, LOGISTIC_N) and grads == 17 * rounds,
          f"pt: replicas {tuple(res.state.x.shape)}, {grads} fleet-wide gradients")
    mean, sd, mcse, _rhat = chain_moments(qt, res.samples)
    summary = mcse_gates("pt cold row", mean, sd, mcse, ref)
    acc = res.accept_rate.double().cpu().numpy()
    step = res.step_size.double().cpu().numpy()
    swap = res.swap_rate.double().cpu().numpy()
    acc_err = float(np.max(np.abs(acc - np.asarray(ref["accept_rate"]))))
    step_err = float(np.max(np.abs(step / np.asarray(ref["step_size"]) - 1.0)))
    swap_err = float(np.max(np.abs(swap - np.asarray(ref["swap_rate"]))))
    check(acc_err <= ACCEPT_ATOL, f"pt: per-temperature accept {acc} against JAX's "
                                  f"{ref['accept_rate']}")
    check(step_err <= STEP_RTOL, f"pt: per-temperature step size {step} against JAX's "
                                 f"{ref['step_size']}")
    check(swap_err <= ACCEPT_ATOL, f"pt: swap rates {swap} against JAX's {ref['swap_rate']}")
    log(f"[samplers] pt_sample {PT_TEMPS} temperatures x {chains} chains ({PT_TEMPS * chains} "
        f"replicas) x n={LOGISTIC_N} f32, {PT_WARMUP} warmup + {PT_DRAWS} draws, 16 leapfrog "
        f"steps, the handed-over dense B: cold row {summary}; accept per temperature "
        f"{np.round(acc, 4).tolist()} (max {acc_err:.4f} from JAX's), step sizes max "
        f"{100 * step_err:.1f} % from JAX's, swap rates {np.round(swap, 4).tolist()} (max "
        f"{swap_err:.4f} from JAX's), round trips {int(res.round_trips.sum())} (JAX "
        f"{ref['round_trips']} over {ref['chains']} chains), divergences "
        f"{int(res.divergences.sum())} (JAX {ref['divergences']}); "
        f"{rate_line(PT_TEMPS * chains, PT_DRAWS, wall, syncs, grads, peak)} (replicas) on {smi}")
    return res.state, wall


def bimodal_leg(qt, device, smi, runs):
    """Phase 29 (e): the bimodal mixture replica exchange exists for."""
    from quasinewtonmethods_jl_tpu_torch.models import GaussianMixture

    mix = GaussianMixture(means=[[4.0, 4.0], [-4.0, -4.0]], weights=[0.75, 0.25], sigmas=1.0,
                          dtype=torch.float32, device=device)
    noise = np.random.default_rng(BENCH_SEED + 2).standard_normal((BATCH, 2))
    starts = torch.tensor(np.asarray([4.0, 4.0]) + 0.1 * noise, dtype=torch.float32,
                          device=device)
    res, wall, syncs, grads, peak = sampler_run(qt, qt.pt_sample, lambda: qt.pt_sample(
        mix.logdensity, BENCH_SEED, starts, n_temps=BIMODAL_TEMPS, beta_min=BIMODAL_BETA_MIN,
        n_samples=BIMODAL_DRAWS, n_warmup=BIMODAL_WARMUP, n_leapfrog=BIMODAL_LEAPFROG))
    check(syncs == 0 and bool(torch.isfinite(res.samples).all()),
          f"bimodal: {syncs} host reads, or NaN in the samples")
    w = mix.mode_weights(res.samples).double().cpu().numpy()
    check(float(np.max(np.abs(w - np.asarray([0.75, 0.25])))) <= MODE_ATOL,
          f"bimodal: cold mode weights {w} not within {MODE_ATOL} of [0.75, 0.25]")
    band = band_check("light-mode weight", float(w[1]), [r["mode_weights"][1] for r in runs])
    swap = res.swap_rate.double().cpu().numpy()
    trips = int(res.round_trips.sum())
    check(bool(np.all(swap > 0.2)), f"bimodal: a swap rate at or below 0.2: {swap}")
    check(trips > BATCH, f"bimodal: {trips} round trips over {BATCH} chains")
    jax_trips = [r["round_trips"] for r in runs]
    log(f"[samplers] bimodal mixture (modes ±4 in n = 2, weights 0.75 / 0.25) pt_sample "
        f"{BIMODAL_TEMPS} temperatures beta_min {BIMODAL_BETA_MIN} x {BATCH} chains from the "
        f"heavy mode, {BIMODAL_WARMUP} warmup + {BIMODAL_DRAWS} draws, {BIMODAL_LEAPFROG} "
        f"leapfrog steps: cold mode weights {np.round(w, 4).tolist()}, {band}; swap rates "
        f"{np.round(swap, 4).tolist()} (JAX min {min(min(r['swap_rate']) for r in runs):.4f}), "
        f"round trips {trips} (JAX {min(jax_trips)}-{max(jax_trips)}); {wall:.2f} s a call, "
        f"{grads} fleet-wide gradients, peak {peak / 2**20:.0f} MiB on {smi}")


def samplers_resume(qt, model, x0s, mass):
    """Phase 29 (f): each sampler's short plan whole and through
    `save_state` / `load_state` on the card (MCLMC through its announced
    warmup plan, the ensemble through its warmup -> sampling transition,
    PT mid-warmup); the draws and every state leaf bit for bit."""
    def runs(tmp):
        w, d = SAMPLERS_RESUME["mclmc"]
        yield ("mclmc", qt.mclmc_sample(model, BENCH_SEED, x0s, mass, n_samples=d, n_warmup=w),
               qt.mclmc_sample_from_state(model, through_file(qt.mclmc_sample(
                   model, BENCH_SEED, x0s, mass, n_samples=0, n_warmup=w // 2,
                   total_warmup=w).state, tmp, "mclmc"), mass, n_samples=d,
                   n_warmup=w - w // 2))
        w, d = SAMPLERS_RESUME["ensemble"]
        yield ("ensemble", qt.ensemble_sample(model, BENCH_SEED, x0s, n_samples=d, n_warmup=w),
               qt.ensemble_sample_from_state(model, through_file(qt.ensemble_sample(
                   model, BENCH_SEED, x0s, n_samples=0, n_warmup=w).state, tmp, "ensemble"),
                   n_samples=d))
        w, d = SAMPLERS_RESUME["pt"]
        yield ("pt", qt.pt_sample(model, BENCH_SEED, x0s, mass, n_samples=d, n_warmup=w),
               qt.pt_sample_from_state(model, through_file(qt.pt_sample(
                   model, BENCH_SEED, x0s, mass, n_samples=0, n_warmup=w // 2).state, tmp,
                   "pt"), mass, n_samples=d, n_warmup=w - w // 2))

    with tempfile.TemporaryDirectory() as tmp:
        for label, long, chunked in runs(tmp):
            check(torch.equal(long.samples, chunked.samples),
                  f"resume: {label}'s resumed draws differ from the long run's")
            for field, a, b in zip(long.state._fields, long.state, chunked.state):
                check(torch.equal(a, b.to(a.device)),
                      f"resume: {label}'s state leaf {field} differs from the long run's")
    plans = ", ".join(f"{k} {w} + {d}" for k, (w, d) in SAMPLERS_RESUME.items())
    return (f"resume on the card (warmup + draws: {plans}), each long and through save_state / "
            f"load_state (MCLMC at half its announced warmup, the ensemble at the end of its "
            f"warmup, PT mid-warmup) on all {x0s.shape[0]} chains: the draws and every state "
            f"leaf bit for bit")


def samplers_phase(qt, device, smi):
    """The other three samplers (see phase 29 above). Returns B1's [pt]
    record: (launches, max abs error, (ms, plain ms, bound ms, bound kind,
    library ms))."""
    t_phase = time.perf_counter()
    with open(TEMPERING_REF) as fh:
        ref = json.load(fh)
    check(ref["plan"] == {"chains": 512, "keys": 10, "tau_walkers": TAU_WALKERS,
                          "mclmc": [MCLMC_WARMUP, MCLMC_DRAWS],
                          "ensemble": [ENSEMBLE_WARMUP, ENSEMBLE_DRAWS],
                          "pt": [PT_WARMUP, PT_DRAWS],
                          "bimodal": [BIMODAL_TEMPS, BIMODAL_BETA_MIN, BIMODAL_LEAPFROG,
                                      BIMODAL_WARMUP, BIMODAL_DRAWS]},
          "samplers: scripts/jax_tempering_reference.json ran another plan")
    # (a) the MAP fleet through B1, and the handoff
    model, fleet, launches, (converged, med, itmax) = logistic_map_fleet(
        qt, device, "samplers MAP fleet")
    x0s, mass = qt.chain_init_from_map(fleet, jitter=SAMPLING_JITTER, key=BENCH_SEED)
    del fleet
    check(int(torch.linalg.cholesky_ex(mass)[1]) == 0 and mass.shape == (LOGISTIC_N, LOGISTIC_N),
          "samplers handoff: the dense B is not positive definite")
    err, b1_ms, plain_ms, (bound_ms, bound_by) = sampling_b1(qt, device)
    log(f"[samplers] MAP fleet: optimize_batched on config 3's logistic {BATCH} starts f32 tol "
        f"{LOGISTIC_TOL}: converged {converged}/{BATCH}, iterations median {med:g} max {itmax} "
        f"(JAX median {ref['map']['median_iterations']:g}), B1 {launches} launches = loop "
        f"bodies; chain_init_from_map(jitter={SAMPLING_JITTER}): the dense B; B1 at "
        f"{BATCH}x{LOGISTIC_N} f32 against its plain version max abs err {err:.3e}, "
        f"{b1_ms:.4f} ms a launch (CUDA events), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}) on {smi}")
    # (b)-(d) the three routes, (e) the mixture, (f) resume
    walls, legs = {}, [f"map {time.perf_counter() - t_phase:.1f}"]

    def leg(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        legs.append(f"{label} {time.perf_counter() - t0:.1f}")
        return out

    mclmc_state, walls["mclmc"] = leg("mclmc", mclmc_leg, qt, smi, ref["mclmc"], model, x0s,
                                      mass)
    for partner in ("gather", "shift"):
        ens_state, walls[f"ensemble[{partner}]"] = leg(
            f"ensemble[{partner}]", ensemble_leg, qt, smi, ref["ensemble"], model, x0s, partner)
    pt_state, walls["pt"] = leg("pt", pt_leg, qt, smi, ref["pt"], model, x0s, mass)
    leg("bimodal", bimodal_leg, qt, device, smi, ref["bimodal"])
    log(f"[samplers] {leg('resume', samplers_resume, qt, model, x0s, mass)}")
    t_prof = time.perf_counter()
    # (g) the busy share over a few steps from each warm state
    for label, engine, steps, fn, evals in (
            ("mclmc", qt.mclmc_sample, SAMPLERS_PROFILED["mclmc"],
             lambda: qt.mclmc_sample_from_state(model, mclmc_state, mass,
                                                n_samples=SAMPLERS_PROFILED["mclmc"]), "gradient"),
            ("ensemble[shift]", qt.ensemble_sample, SAMPLERS_PROFILED["ensemble"],
             lambda: qt.ensemble_sample_from_state(model, ens_state,
                                                   n_samples=SAMPLERS_PROFILED["ensemble"],
                                                   partner="shift"), "value"),
            ("pt", qt.pt_sample, SAMPLERS_PROFILED["pt"],
             lambda: qt.pt_sample_from_state(model, pt_state, mass,
                                             n_samples=SAMPLERS_PROFILED["pt"]), "gradient")):
        prof = device_profile(fn)
        log(profile_line(f"{label} {x0s.shape[0]}x{LOGISTIC_N} f32, {steps} steps from the warm "
                         f"state ({evals} sweeps)", *prof, steps))
    legs.append(f"profiles {time.perf_counter() - t_prof:.1f}")
    log(f"[samplers] phase 29 took {time.perf_counter() - t_phase:.1f} s ({', '.join(legs)} s; "
        f"mclmc {walls['mclmc']:.2f}, ensemble {walls['ensemble[gather]']:.2f} / "
        f"{walls['ensemble[shift]']:.2f}, pt {walls['pt']:.2f} s a call) on {smi}")
    return launches, err, (b1_ms, plain_ms, bound_ms, bound_by, None)


# Phase 30, evidence by sampling: annealed importance sampling with adaptive
# tempered SMC and bridge sampling, the workflow's compute_evidence="ais" /
# "bridge" legs, on config 3's logistic posterior at full width (n = 100,
# float32) from phase 28 (c)'s B1 MAP fleet and HMC draws. JAX's numbers come
# from scripts/jax_evidence_reference.py (the same data, fleet and plans
# under 6 keys).
EVIDENCE_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                            "jax_evidence_reference.json")
EVIDENCE_DRAWS = 16  # phase 28 (c)'s HMC draws a chain: 16 x 4096 = 65536 for the bridge
AIS_PARTICLES, AIS_RUNGS, AIS_LEAPFROG, AIS_STEP = 4096, 64, 8, 0.2
EVIDENCE_SPREAD = 2.0  # a logZ within 2 x JAX's key-to-key spread of JAX's mean
# the least spread a gate uses: a logZ near -130 in float32 is summed from
# 4096 weights, ~1e-3 of rounding, so JAX's keys cannot certify closer
EVIDENCE_SPREAD_FLOOR = 0.01
AIS_ACCEPT_ATOL, AIS_STEP_RTOL = 0.05, 0.1
AIS_PROFILED_RUNGS = 4  # the busy share's short anneals


def spread_gate(label, value, values):
    """``value`` within EVIDENCE_SPREAD x the spread of JAX's ``values``
    (at least EVIDENCE_SPREAD_FLOOR) of their mean; returns the text."""
    centre, spread = float(np.mean(values)), max(values) - min(values)
    limit = EVIDENCE_SPREAD * max(spread, EVIDENCE_SPREAD_FLOOR)
    check(math.isfinite(value) and abs(value - centre) <= limit,
          f"evidence: {label} {value:.4f} is {abs(value - centre):.4f} from JAX's mean "
          f"{centre:.4f}, limit {limit:.4f} ({EVIDENCE_SPREAD} x JAX's spread {spread:.4f} over "
          f"{len(values)} keys, floor {EVIDENCE_SPREAD_FLOOR})")
    return f"{label} {value:.4f} (JAX {centre:.4f}, spread {spread:.4f})"


def count_band(label, value, values):
    """An integer count inside JAX's range over its keys, widened by half
    that range on each side and by at least 1 (a count of a handful of
    rungs moves by one between keys)."""
    lo, hi = min(values), max(values)
    pad = max(BAND_WIDEN * (hi - lo), 1)
    check(lo - pad <= value <= hi + pad,
          f"evidence: {label} {value} outside JAX's [{lo}, {hi}] widened to "
          f"[{lo - pad}, {hi + pad}]")
    return f"{label} {value} (JAX {lo}-{hi})"


def bridge_reads(n_iter, max_iter=200):
    """`bridge_evidence`'s reads of its stop test: before bodies 0, 8, 16,
    ... up to the first after the n_iter - 1 bodies that moved r."""
    from quasinewtonmethods_jl_tpu_torch.bridge import _READ_INTERVAL

    reads = 0
    for body in range(0, max_iter - 1, _READ_INTERVAL):
        reads += 1
        if body >= n_iter - 1:
            break
    return reads


def ais_gates(label, res, runs, plan_rungs):
    """Finite results, logZ against JAX's keys, the mean acceptance over the
    rungs run within AIS_ACCEPT_ATOL of JAX's mean, and the adapted step
    within AIS_STEP_RTOL of it on the fixed ladder; the adaptive anneal's
    step, adapted over its 11-17 rungs, moves ±7 % between JAX's keys, so
    it is held to their band widened by half (`band_check`). Returns the
    texts."""
    rungs = int(res.n_rungs)
    for name in ("logZ", "ess", "step_size"):
        check(math.isfinite(float(getattr(res, name))), f"evidence: {label} {name} not finite")
    acc = float(res.accept_rate[:rungs].double().mean())
    step = float(res.step_size)
    acc_ref = float(np.mean([r["accept_mean"] for r in runs]))
    check(abs(acc - acc_ref) <= AIS_ACCEPT_ATOL,
          f"evidence: {label} mean acceptance {acc:.4f}, JAX's {acc_ref:.4f}")
    steps = [r["step_size"] for r in runs]
    if rungs == plan_rungs and all(r["n_rungs"] == plan_rungs for r in runs):
        step_text = within(f"{label} step", step, float(np.mean(steps)), AIS_STEP_RTOL)
    else:
        step_text = band_check(f"{label} step", step, steps)
    return [spread_gate("logZ", float(res.logZ), [r["logZ"] for r in runs]),
            f"ess {float(res.ess):.1f} of {AIS_PARTICLES} (JAX "
            f"{min(r['ess'] for r in runs):.1f}-{max(r['ess'] for r in runs):.1f})",
            f"mean accept {acc:.4f} (JAX {acc_ref:.4f})", step_text,
            f"rungs {rungs} of {plan_rungs}, resamples {int(res.n_resamples)}"]


def evidence_phase(qt, device, smi, handoff):
    """Evidence by sampling (see phase 30 above) on phase 28 (c)'s handoff:
    (model, its B1 MAP fleet, its HMC draws)."""
    t_phase = time.perf_counter()
    with open(EVIDENCE_REF) as fh:
        ref = json.load(fh)
    with open(PATHFINDER_REF) as fh:
        loo_plan = json.load(fh)["loo"]["plan"]
    check(ref["plan"] == {"particles": AIS_PARTICLES, "rungs": AIS_RUNGS,
                          "leapfrog": AIS_LEAPFROG, "step_size": AIS_STEP,
                          "keys": len(ref["runs"]),
                          "hmc": {"jitter": loo_plan["jitter"], "warmup": loo_plan["warmup"],
                                  "leapfrog": loo_plan["leapfrog"], "draws": EVIDENCE_DRAWS}},
          "evidence: scripts/jax_evidence_reference.json ran another plan")
    model, fleet, draws = handoff
    check(tuple(draws.shape) == (EVIDENCE_DRAWS, BATCH, LOGISTIC_N),
          f"evidence: phase 28 handed over draws of shape {tuple(draws.shape)}")
    runs = ref["runs"]
    common = {"n_particles": AIS_PARTICLES, "n_steps": AIS_RUNGS, "n_leapfrog": AIS_LEAPFROG,
              "step_size": AIS_STEP}
    lines = {}

    # (b) AIS from the fleet result itself: the linear ladder, then adaptive
    # tempered SMC with resampling
    for label, kw in (("ais", {}), ("adaptive", {"schedule": "adaptive", "resample": True})):
        res, wall, syncs, grads, peak = sampler_run(qt, qt.ais_evidence, lambda: qt.ais_evidence(
            model, BENCH_SEED, fleet, **common, **kw))
        rungs = int(res.n_rungs)
        # the fleet's any-converged test, and the adaptive anneal's b < 1
        reads = 1 + (rungs - 1 + (rungs < AIS_RUNGS) if kw else 0)
        check(syncs == reads and grads == rungs * (AIS_LEAPFROG + 1),
              f"evidence: {label} {syncs} host reads (expected {reads}), {grads} fleet-wide "
              f"gradients over {rungs} rungs")
        texts = ais_gates(label, res, [r[label] for r in runs], AIS_RUNGS)
        if kw:
            texts.append(count_band("n_rungs", rungs, [r[label]["n_rungs"] for r in runs]))
            texts.append(count_band("n_resamples", int(res.n_resamples),
                                    [r[label]["n_resamples"] for r in runs]))
        lines[label] = (res, texts, f"{wall:.2f} s a call, {AIS_PARTICLES * grads / wall:.3e} "
                                    f"particle gradients/s ({grads} fleet-wide, "
                                    f"{grads / wall:.0f} a second), {syncs} host syncs, peak "
                                    f"{peak / 2**20:.0f} MiB")

    # (c) the bridge on the handed-over draws against the same base
    br, wall_b, syncs_b, evals_b, peak_b = sampler_run(
        qt, qt.bridge_evidence, lambda: qt.bridge_evidence(model, BENCH_SEED, draws, fleet))
    n_iter = int(br.n_iter)
    check(evals_b == 2 and syncs_b == 1 + bridge_reads(n_iter),
          f"evidence: bridge {evals_b} logdensity sweeps, {syncs_b} host reads (expected "
          f"{1 + bridge_reads(n_iter)})")
    check(math.isfinite(float(br.logZ)) and math.isfinite(float(br.re2)),
          f"evidence: bridge logZ {float(br.logZ)} re2 {float(br.re2)}")
    bridge_text = spread_gate("logZ", float(br.logZ), [r["bridge"]["logZ"] for r in runs])
    # the bridge against AIS: JAX's own gap between their means, widened by
    # twice both spreads
    jb = [r["bridge"]["logZ"] for r in runs]
    ja = [r["ais"]["logZ"] for r in runs]
    gap_ref = abs(float(np.mean(jb)) - float(np.mean(ja)))
    gap_tol = gap_ref + EVIDENCE_SPREAD * (max(max(jb) - min(jb), EVIDENCE_SPREAD_FLOOR)
                                           + max(max(ja) - min(ja), EVIDENCE_SPREAD_FLOOR))
    gap = abs(float(br.logZ) - float(lines["ais"][0].logZ))
    check(gap <= gap_tol, f"evidence: bridge {float(br.logZ):.4f} and AIS "
                          f"{float(lines['ais'][0].logZ):.4f} differ by {gap:.4f}, limit "
                          f"{gap_tol:.4f} (JAX's gap {gap_ref:.4f} + {EVIDENCE_SPREAD} x both "
                          f"spreads)")
    # Laplace with the exact Hessian at the same mode (the best converged lane)
    ok = fleet.status == qt.Status.CONVERGED
    best = torch.argmax(torch.where(ok, fleet.fun, torch.full_like(fleet.fun, -math.inf)))
    mode = types.SimpleNamespace(x=fleet.x[best], fun=fleet.fun[best], state=None)
    laplace = float(qt.laplace_evidence(mode, obj=model))

    # (d) the busy share over a few rungs and over the bridge, from the same
    # base as an explicit pair (no read of the fleet)
    base = (mode.x, qt.chain_init_from_map(fleet)[1])
    short = {**common, "n_steps": AIS_PROFILED_RUNGS}
    profiles = []
    for label, fn, shape, bodies in (
            ("ais", lambda: qt.ais_evidence(model, BENCH_SEED, base, **short),
             AIS_PARTICLES, AIS_PROFILED_RUNGS),
            ("adaptive", lambda: qt.ais_evidence(model, BENCH_SEED, base, schedule="adaptive",
                                                 resample=True, **short),
             AIS_PARTICLES, AIS_PROFILED_RUNGS),
            ("bridge", lambda: qt.bridge_evidence(model, BENCH_SEED, draws, base),
             BATCH * EVIDENCE_DRAWS, n_iter)):
        unit = "fixed-point iterations" if label == "bridge" else "rungs"
        profiles.append(profile_line(f"evidence {label} {shape}x{LOGISTIC_N} f32, {bodies} "
                                     f"{unit}", *device_profile(fn), bodies))
    for label in ("ais", "adaptive"):
        res, texts, rate = lines[label]
        plan = "the linear ladder" if label == "ais" else "schedule='adaptive', resample=True"
        log(f"[evidence] ais_evidence from the MAP fleet ({AIS_PARTICLES} particles x n="
            f"{LOGISTIC_N} f32, {AIS_RUNGS} rungs{' (the cap)' if label != 'ais' else ''}, "
            f"{AIS_LEAPFROG} leapfrog steps, step {AIS_STEP}, {plan}): {', '.join(texts)}; "
            f"{rate} on {smi}")
    log(f"[evidence] bridge_evidence on phase 28's {EVIDENCE_DRAWS} x {BATCH} HMC draws, the "
        f"MAP fleet's Gaussian as proposal ({BATCH * EVIDENCE_DRAWS} proposal draws): "
        f"{bridge_text}, n_iter {n_iter} (JAX {min(r['bridge']['n_iter'] for r in runs)}-"
        f"{max(r['bridge']['n_iter'] for r in runs)}), delta {float(br.delta):.3e}, re2 "
        f"{float(br.re2):.4f} (JAX {float(np.mean([r['bridge']['re2'] for r in runs])):.4f}); "
        f"bridge - AIS {float(br.logZ) - float(lines['ais'][0].logZ):+.4f} (limit {gap_tol:.4f}); "
        f"laplace_evidence at the same mode (exact Hessian) {laplace:.4f} (JAX "
        f"{ref['laplace']:.4f}); {wall_b:.3f} s a call, {syncs_b} host syncs, peak "
        f"{peak_b / 2**20:.0f} MiB on {smi}")
    for line in profiles:
        log(line)
    log(f"[evidence] phase 30 took {time.perf_counter() - t_phase:.1f} s on {smi}")


# Phase 31, the one-call pipeline: map_then_sample at full width on config
# 3's logistic posterior (4096 chains, n = 100, float32), its MAP fleet
# through B1, HMC on phase 28 (c)'s plan from the fleet's dense B, the device
# diagnostics and the bridge, inside utils.trace; then map_then_sample_pytree.
# JAX's numbers: scripts/jax_workflow_reference.py (its map_then_sample on
# the same data and starts in float32 on the CPU, ~35 s).
JAX_WORKFLOW = {"converged": 4096, "median_iterations": 11.0, "max_iterations": 13,
                "rhat_max": 1.2853347063064575, "bridge_logZ": -131.64190673828125}
WORKFLOW_GLUE_READS = 1  # map_then_sample's own: the fleet's statuses
PYTREE_BLOCKS = {"bias": (4, 5), "weights": (LOGISTIC_N - 20,)}  # dict keys in JAX's order
PYTREE_WARMUP, PYTREE_DRAWS, PYTREE_LEAPFROG = 20, 4, 4
WORKFLOW_TRACE_TOP = 6


def workflow_engines(qt):
    """The pipeline and the engines phase 31 drives, each counting its own
    host reads."""
    return {"glue": qt.map_then_sample, "fleet": qt.optimize_batched_fused,
            "hmc": qt.hmc_sample, "bridge": qt.bridge_evidence}


def workflow_run(qt, fn):
    """``fn()`` with every counter at 0 and torch's sync debug mode on:
    (result, wall s, each engine's counted reads, synchronisations flagged,
    the kernel counters, peak bytes)."""
    for engine in workflow_engines(qt).values():
        engine.host_syncs = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(qt)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads = {name: engine.host_syncs for name, engine in workflow_engines(qt).items()}
    flagged = sum("synchroniz" in str(w.message) for w in caught)
    check(flagged == sum(reads.values()),
          f"workflow: {flagged} synchronisations flagged, {reads} counted")
    return res, wall, reads, flagged, read_counters(qt), torch.cuda.max_memory_allocated()


def workflow_pytree_leg(qt, device, smi, model):
    """Phase 31 (b): map_then_sample_pytree over a dict of two blocks."""
    sizes = [math.prod(shape) for shape in PYTREE_BLOCKS.values()]

    def logd(tree):
        return model.logdensity(torch.cat([tree[k].reshape(-1) for k in PYTREE_BLOCKS]))

    tree0 = {k: torch.zeros(shape, dtype=torch.float32, device=device)
             for k, shape in PYTREE_BLOCKS.items()}
    out, wall, reads, flagged, c, _peak = workflow_run(qt, lambda: qt.map_then_sample_pytree(
        logd, BENCH_SEED + 31, tree0, n_chains=BATCH, map_tol=LOGISTIC_TOL, sampler="hmc",
        n_warmup=PYTREE_WARMUP, n_samples=PYTREE_DRAWS, n_leapfrog=PYTREE_LEAPFROG))
    flat = out.flat
    for k, shape in PYTREE_BLOCKS.items():
        want = (PYTREE_DRAWS, BATCH, *shape)
        check(tuple(out.samples[k].shape) == want and out.samples[k].device.type == "cuda",
              f"workflow pytree: leaf {k} {tuple(out.samples[k].shape)} on "
              f"{out.samples[k].device}, expected {want} on the card")
    pieces = torch.split(flat.x_map, sizes)
    check(all(torch.equal(out.x_map[k], piece.reshape(shape))
              for (k, shape), piece in zip(PYTREE_BLOCKS.items(), pieces)),
          "workflow pytree: x_map is not the unravel of flat.x_map")
    check(torch.equal(out.samples["weights"], flat.samples[..., sizes[0]:]),
          "workflow pytree: the draws are not the unravel of flat.samples")
    check(len(out.names) == LOGISTIC_N and out.names[0] == "bias[0,0]",
          f"workflow pytree: names {out.names[:2]}... ({len(out.names)})")
    check(bool(torch.isfinite(flat.samples).all()), "workflow pytree: NaN in the draws")
    converged = int((flat.map_result.status == qt.Status.CONVERGED).sum())
    check(converged == BATCH and c["B1"] == c["bodies"] > 0,
          f"workflow pytree: {converged}/{BATCH} converged, counters {c}")
    diag = flat.diagnostics
    check(isinstance(diag.rhat, np.ndarray) and np.isnan(diag.rhat).all()
          and np.isfinite(diag.mean).all(),
          "workflow pytree: fewer than 8 draws must give numpy moments and NaN R-hat")
    check(reads["glue"] == 2, f"workflow pytree: {reads['glue']} glue reads, expected 2 (the "
                              f"statuses and the draws)")
    return (f"[workflow] (b) map_then_sample_pytree over {{{', '.join(f'{k}: {v}' for k, v in PYTREE_BLOCKS.items())}}} "
            f"from an (n,) center, {BATCH} chains, {PYTREE_WARMUP} warmup + {PYTREE_DRAWS} draws "
            f"({PYTREE_LEAPFROG} leapfrog steps): leaves {[tuple(out.samples[k].shape) for k in PYTREE_BLOCKS]}, "
            f"x_map the unravel of flat.x_map, {converged}/{BATCH} converged, B1 {c['B1']} "
            f"launches, numpy moments below 8 draws; {wall:.2f} s, reads {reads} ({flagged} "
            f"flagged) on {smi}")


def workflow_phase(qt, device, smi):
    """The one-call pipeline (see phase 31 above). Returns B1's [workflow]
    record: (launches, max abs error, (ms, plain ms, bound ms, bound kind,
    library ms))."""
    from quasinewtonmethods_jl_tpu_torch.models import LogisticRegressionMAP

    t_phase = time.perf_counter()
    with open(EVIDENCE_REF) as fh:
        ref = json.load(fh)
    plan = ref["plan"]["hmc"]
    Xd, yd, starts = logistic_data(np.random.default_rng(BENCH_SEED))
    model = LogisticRegressionMAP(LOGISTIC_N, LOGISTIC_OBS, prior_scale=LOGISTIC_PRIOR, X=Xd,
                                  y=yd, dtype=torch.float32, device=device)
    x0s = torch.tensor(starts, dtype=torch.float32, device=device)

    # (a) the whole pipeline under utils.trace
    with tempfile.TemporaryDirectory() as log_dir:
        t0 = time.perf_counter()
        with qt.utils.trace(log_dir):
            out, wall, reads, flagged, c, peak = workflow_run(qt, lambda: qt.map_then_sample(
                model, BENCH_SEED, x0s, map_engine="bfgs", map_tol=LOGISTIC_TOL, sampler="hmc",
                jitter=plan["jitter"], n_warmup=plan["warmup"], n_samples=plan["draws"],
                n_leapfrog=plan["leapfrog"], compute_evidence="bridge"))
        trace_s = time.perf_counter() - t0 - wall  # starting, stopping and writing the trace
        t0 = time.perf_counter()
        rows = qt.utils.summarize_trace(log_dir, top=WORKFLOW_TRACE_TOP)
        summarize_s = time.perf_counter() - t0
        trace_bytes = sum(os.path.getsize(os.path.join(d, f))
                          for d, _, files in os.walk(log_dir) for f in files)
    fleet = out.map_result
    converged, med, itmax, gmax = fleet_line(qt, fleet)
    check(converged == BATCH and gmax < LOGISTIC_TOL,
          f"workflow: {converged}/{BATCH} MAP lanes converged, max|grad| {gmax}")
    jax_med = JAX_WORKFLOW["median_iterations"]
    check(abs(med - jax_med) <= 0.1 * jax_med,
          f"workflow: MAP median {med} not within 10% of JAX's {jax_med}")
    check(c["B1"] == c["bodies"] > 0 and c["B2a"] == c["B2b"] == c["B3"] == 0,
          f"workflow: B1 not launched once per MAP loop body: {c}")
    check(reads["glue"] == WORKFLOW_GLUE_READS and reads["hmc"] == 0,
          f"workflow: reads {reads}, expected {WORKFLOW_GLUE_READS} of the glue and none of HMC")
    samples = out.samples
    check(tuple(samples.shape) == (plan["draws"], BATCH, LOGISTIC_N)
          and samples.device.type == "cuda" and samples.dtype == torch.float32
          and bool(torch.isfinite(samples).all()),
          f"workflow: draws {tuple(samples.shape)} {samples.dtype} on {samples.device}")
    rhat = out.diagnostics.rhat
    check(isinstance(rhat, torch.Tensor) and rhat.device.type == "cuda"
          and bool(torch.isfinite(rhat).all()), "workflow: a split R-hat is not finite")
    rhat_max = float(rhat.max())
    check(isinstance(out.evidence_extra, qt.BridgeResult), "workflow: no bridge result")
    bridge_text = spread_gate("logZ", float(out.log_evidence),
                              [r["bridge"]["logZ"] for r in ref["runs"]])
    err, b1_ms, plain_ms, (bound_ms, bound_by) = sampling_b1(qt, device)
    top = "; ".join(f"{name[:50]} {secs:.4f} s x{count}" for name, secs, count in rows)
    log(f"[workflow] (a) map_then_sample on config 3's logistic (n={LOGISTIC_N}, {LOGISTIC_OBS} "
        f"observations) from {BATCH} starts f32: MAP through optimize_batched (map_tol "
        f"{LOGISTIC_TOL}) converged {converged}/{BATCH}, iterations median {med:g} max {itmax} "
        f"(JAX's map_then_sample {jax_med:g} / {JAX_WORKFLOW['max_iterations']}), B1 {c['B1']} "
        f"launches = loop bodies; hmc_sample {plan['warmup']} warmup + {plan['draws']} draws "
        f"({plan['leapfrog']} leapfrog steps) from the dense B, device diagnostics: max split "
        f"R-hat {rhat_max:.4f} (JAX's run {JAX_WORKFLOW['rhat_max']:.4f}, {plan['draws']} "
        f"draws); bridge {bridge_text}, n_iter {int(out.evidence_extra.n_iter)}, re2 "
        f"{float(out.evidence_extra.re2):.4f} (JAX's run {JAX_WORKFLOW['bridge_logZ']:.4f}); "
        f"{wall:.2f} s under utils.trace, reads {reads} ({flagged} flagged, glue "
        f"{reads['glue']} as its code predicts), peak {peak / 2**20:.0f} MiB; the trace "
        f"{trace_bytes / 2**20:.1f} MiB gzipped, started, stopped and written in {trace_s:.1f} s, "
        f"summarized in {summarize_s:.1f} s, top by "
        f"time: {top}; B1 at {BATCH}x{LOGISTIC_N} f32 against its plain version max abs err "
        f"{err:.3e}, {b1_ms:.4f} ms a launch (CUDA events), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), B1 at {100 * bound_ms / b1_ms:.1f} % of it on {smi}")
    launches = c["B1"]
    del out, fleet, samples
    log(workflow_pytree_leg(qt, device, smi, model))
    log(f"[workflow] phase 31 took {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches, err, (b1_ms, plain_ms, bound_ms, bound_by, None)

# Phase 32, the device mesh: parallel/mesh.py on torch.distributed. (a) runs
# in this process as one rank over NCCL; (b) as two ranks over gloo in
# processes of their own on the same card (NCCL refuses two ranks on one
# GPU: "Duplicate GPU detected"), which load the kernel library this
# process built and write their gathered results to files held to (a).
MESH_N = 1 << 20  # the parameter-sharded solves' n
MESH_TOL = 1e-3  # their certificate, the f32 throughput mode's
MESH_CHEES = (50, 20)  # sample_sharded ChEES: warmup rounds, draws
MESH_PIPE_HMC = (10, 10, 4)  # the pipeline's HMC: warmup, draws, leapfrog steps
MESH_RANKS = 2  # (b)'s ranks
MESH_RANK_TIMEOUT = 400  # seconds (b) may take before its ranks are stopped
MESH_X_ATOL = 1e-6  # a fleet's x against the same lanes run elsewhere: f32 rounding
# (b)'s ChEES against (a)'s: each rank's GEMM and per-chain sums run at 2048
# rows, which the card sums in another order than at 4096; after 70
# adaptive rounds that moved the step size 1.5e-4 (relative) and the mean
# acceptance 5.8e-5, the same in two calls (a one-ulp change of the data
# moves them 4.2e-6 / 2.5e-5; on the CPU, one summation order, sharded =
# unsharded to 1e-13 over 700 rounds, tests/test_torch_mesh_sampling.py)
MESH_CHEES_TOL = 1e-3


def mesh_quadratic(device):
    """The geometric quadratic of JAX's
    test_optimize_cg_model_sharded_matches_unsharded, widened to n =
    MESH_N: -1/2 sum d x², d = geomspace(1, 100, n), f32, and its start
    (N(0, 1), the bench seed)."""
    d = torch.tensor(np.geomspace(1.0, 100.0, MESH_N), dtype=torch.float32, device=device)
    x0 = torch.tensor(np.random.default_rng(BENCH_SEED).standard_normal(MESH_N),
                      dtype=torch.float32, device=device)

    def logd(x):
        return -0.5 * torch.sum(d * x * x)

    return logd, x0


def mesh_leg(qt, fn):
    """``fn()`` with every counter at 0: (result, wall s, counters)."""
    torch.cuda.synchronize()
    reset_counters(qt)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_counters(qt)


def mesh_legs(qt, device, data, model, chees_x0s=None):
    """Phase 32's legs on the ranks' meshes ``data`` ({'data': k}) and
    ``model`` ({'model': k}): {leg: (result, wall s, counters)} and the
    inputs (the logistic model, ChEES's starts, the quadratic and its
    start, the fleet's starts). ChEES starts from the pipeline's handoff,
    or from ``chees_x0s`` where given ((b): (a)'s, so that both runs start
    alike)."""
    from quasinewtonmethods_jl_tpu_torch import parallel as P
    from quasinewtonmethods_jl_tpu_torch.models import (
        LogisticRegressionMAP,
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )

    X = bench_fleet(device)
    logd, x0 = mesh_quadratic(device)
    Xd, yd, starts = logistic_data(np.random.default_rng(BENCH_SEED))
    logistic = LogisticRegressionMAP(LOGISTIC_N, LOGISTIC_OBS, prior_scale=LOGISTIC_PRIOR, X=Xd,
                                     y=yd, dtype=torch.float32, device=device)
    starts = torch.tensor(starts, dtype=torch.float32, device=device)
    warm, draws, leapfrog = MESH_PIPE_HMC
    legs = {
        "fleet": mesh_leg(qt, lambda: P.optimize_batched_sharded(
            rosenbrock_logdensity, X, data, tol=TOL, max_iterations=MAX_ITERS,
            value_and_grad_fn=rosenbrock_value_and_grad)),
        "lbfgs": mesh_leg(qt, lambda: P.optimize_lbfgs_sharded(logd, x0, model, tol=MESH_TOL)),
        "cg": mesh_leg(qt, lambda: P.optimize_cg_model_sharded(logd, x0, model, tol=MESH_TOL)),
        "pipeline": mesh_leg(qt, lambda: qt.map_then_sample(
            logistic, BENCH_SEED, starts, mesh=data, map_engine="bfgs", map_tol=LOGISTIC_TOL,
            sampler="hmc", n_warmup=warm, n_samples=draws, n_leapfrog=leapfrog)),
    }
    x0s = chees_x0s
    if x0s is None:
        x0s, _ = qt.chain_init_from_map(legs["pipeline"][0].map_result, jitter=SAMPLING_JITTER,
                                        key=BENCH_SEED)
    warm, draws = MESH_CHEES
    legs["chees"] = mesh_leg(qt, lambda: P.sample_sharded(
        logistic, BENCH_SEED, x0s, data, sampler="chees", n_warmup=warm, n_samples=draws))
    return legs, (logistic, x0s, logd, x0, X)


def mesh_summary(legs):
    """The legs' results as host arrays: what (b) hands back and (a) is
    held to."""
    fleet, lbfgs, cg, pipe, chees = (legs[k][0] for k in ("fleet", "lbfgs", "cg", "pipeline",
                                                          "chees"))
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731

    def solve(r):
        return {"status": int(r.status), "iterations": int(r.iterations), "x": host(r.x),
                "gmax": float(r.grad.abs().max())}

    return {
        "fleet": {"status": host(fleet.status), "iterations": host(fleet.iterations),
                  "x": host(fleet.x)},
        "lbfgs": solve(lbfgs), "cg": solve(cg),
        "pipeline": {"status": host(pipe.map_result.status),
                     "iterations": host(pipe.map_result.iterations),
                     "samples": host(pipe.samples)},
        "chees": {"step_size": float(chees.step_size), "accept": host(chees.accept_rate),
                  "samples": host(chees.samples)},
        "walls": {k: v[1] for k, v in legs.items()},
        "counters": {k: v[2] for k, v in legs.items()},
    }


def mesh_b1_counted(label, c):
    check(c["B1"] == c["bodies"] > 0 and c["B2a"] == c["B2b"] == c["B3"] == 0,
          f"mesh {label}: B1 not launched once per loop body: {c}")


def mesh_rank(qt, device, rank, store, path, chees_path):
    """Phase 32 (b): one of MESH_RANKS ranks over gloo on this card, ChEES
    from the starts saved at ``chees_path``; the legs' gathered results go
    to ``path``."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels._build import load_library
    from quasinewtonmethods_jl_tpu_torch.parallel import distributed, make_mesh

    lib = load_library()
    check(lib.build_seconds == 0.0, f"mesh rank {rank}: the kernel library was built again")
    distributed.initialize(store, MESH_RANKS, int(rank), backend="gloo")
    try:
        t0 = time.perf_counter()
        legs, _ = mesh_legs(qt, device, make_mesh({"data": MESH_RANKS}),
                            make_mesh({"model": MESH_RANKS}),
                            torch.load(chees_path, map_location=device))
        for leg in ("fleet", "pipeline"):
            mesh_b1_counted(f"(b) rank {rank} {leg}", legs[leg][2])
        torch.save(mesh_summary(legs), path)
        log(f"[mesh] (b) rank {rank} of {MESH_RANKS} over gloo on {device} "
            f"({torch.cuda.get_device_name(device)}), the library {lib.path.name} loaded: legs "
            f"in {time.perf_counter() - t0:.1f} s, "
            + ", ".join(f"{k} {v[1]:.2f} s" for k, v in legs.items())
            + f"; B1 {legs['fleet'][2]['B1']} + {legs['pipeline'][2]['B1']} launches")
    finally:
        torch.distributed.destroy_process_group()


def mesh_ranks(qt, chees_x0s):
    """Phase 32 (b): start the ranks, wait for them (stopping them all if
    one fails or they overrun MESH_RANK_TIMEOUT) and read their results."""
    tmp = tempfile.mkdtemp()
    paths = [os.path.join(tmp, f"rank{r}.pt") for r in range(MESH_RANKS)]
    chees_path = os.path.join(tmp, "chees_x0s.pt")
    torch.save(chees_x0s.cpu(), chees_path)
    handles = [start_helper("mesh_rank", str(r), f"file://{tmp}/store", paths[r], chees_path)
               for r in range(MESH_RANKS)]
    try:
        deadline = time.perf_counter() + MESH_RANK_TIMEOUT
        while any(h["proc"].poll() is None for h in handles):
            failed = [h for h in handles if h["proc"].poll() not in (None, 0)]
            if failed or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
        for h in handles:
            if h["proc"].poll() is None:
                os.killpg(h["proc"].pid, 9)
        # a rank that failed first, then those stopped for it
        for h in sorted(handles, key=lambda h: h["proc"].returncode == -9):
            finish_helper(h)
        return [torch.load(p, weights_only=False) for p in paths]
    finally:
        for h in handles:
            stop_build(h)
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_same_solve(qt, label, a, b, iter_slack):
    """A parameter-sharded solve ``a`` against ``b``: both certified, the
    iterations within ``iter_slack`` of b's, the same optimum."""
    check(a["status"] == b["status"] == int(qt.Status.CONVERGED) and a["gmax"] < MESH_TOL,
          f"mesh {label}: statuses {a['status']} / {b['status']}, max|grad| {a['gmax']}")
    check(abs(a["iterations"] - b["iterations"]) <= iter_slack,
          f"mesh {label}: {a['iterations']} iterations against {b['iterations']}")
    dx = float(np.abs(a["x"] - b["x"]).max())
    check(dx <= 2 * MESH_TOL, f"mesh {label}: optima {dx:.3e} apart")
    return dx


def mesh_chees_apart(a, b):
    """How far ChEES run ``a`` is from ``b``: (step size relative, the
    mean acceptance, the largest draw difference)."""
    return (abs(a["step_size"] - b["step_size"]) / b["step_size"],
            abs(float(a["accept"].mean()) - float(b["accept"].mean())),
            float(np.abs(a["samples"] - b["samples"]).max()))


def mesh_chees_run(res):
    return {"step_size": float(res.step_size), "accept": res.accept_rate.cpu().numpy(),
            "samples": res.samples.cpu().numpy()}


def mesh_phase(qt, device, smi):
    """The device mesh (see phase 32 above). Returns B1's [mesh] record:
    (launches, max abs error, (ms, plain ms, bound ms, bound kind, library
    ms))."""
    from quasinewtonmethods_jl_tpu_torch.models import (
        LogisticRegressionMAP,
        rosenbrock_logdensity,
        rosenbrock_value_and_grad,
    )
    from quasinewtonmethods_jl_tpu_torch.parallel import distributed, make_mesh

    t_phase = time.perf_counter()
    # (a) one rank over NCCL
    tmp = tempfile.mkdtemp()
    distributed.initialize(f"file://{tmp}/store", 1, 0)
    try:
        check(torch.distributed.get_backend() == "nccl", "mesh (a): not on NCCL")
        data, model = make_mesh({"data": 1}), make_mesh({"model": 1})
        legs, (logistic, x0s, logd, x0, X) = mesh_legs(qt, device, data, model)
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    a = mesh_summary(legs)
    fleet_c, pipe_c = legs["fleet"][2], legs["pipeline"][2]
    mesh_b1_counted("(a) fleet", fleet_c)
    mesh_b1_counted("(a) pipeline", pipe_c)
    check(no_kernel_launched(legs["chees"][2]) and no_kernel_launched(legs["lbfgs"][2])
          and no_kernel_launched(legs["cg"][2]), "mesh (a): a kernel launched in a torch-op leg")
    launches = fleet_c["B1"]
    pipe = legs["pipeline"][0]
    del legs

    # the unsharded runs on the card, the same inputs
    walls_un = {}
    t0 = time.perf_counter()
    un = qt.optimize_batched_fused(rosenbrock_logdensity, X, tol=TOL, max_iterations=MAX_ITERS,
                                   value_and_grad_fn=rosenbrock_value_and_grad)
    torch.cuda.synchronize()
    walls_un["fleet"] = time.perf_counter() - t0
    check(bool((un.status == qt.Status.CONVERGED).all()), "mesh (a): the unsharded fleet failed")
    check(np.array_equal(a["fleet"]["status"], un.status.cpu().numpy())
          and np.array_equal(a["fleet"]["iterations"], un.iterations.cpu().numpy()),
          "mesh (a): sharded fleet's statuses or iterations differ from the unsharded engine's")
    dx_fleet = float(np.abs(a["fleet"]["x"] - un.x.cpu().numpy()).max())
    check(dx_fleet <= MESH_X_ATOL, f"mesh (a): fleet x {dx_fleet:.2e} from the unsharded run")
    t0 = time.perf_counter()
    un_lbfgs = qt.optimize_lbfgs(logd, x0, tol=MESH_TOL, direction_method="two_loop")
    torch.cuda.synchronize()
    walls_un["lbfgs"] = time.perf_counter() - t0
    un_cg = qt.optimize_cg(logd, x0, tol=MESH_TOL)
    torch.cuda.synchronize()
    walls_un["cg"] = time.perf_counter() - t0 - walls_un["lbfgs"]
    plain = {k: {"status": int(r.status), "iterations": int(r.iterations),
                 "x": r.x.cpu().numpy(), "gmax": float(r.grad.abs().max())}
             for k, r in (("lbfgs", un_lbfgs), ("cg", un_cg))}
    dx_lbfgs = mesh_same_solve(qt, "(a) L-BFGS", a["lbfgs"], plain["lbfgs"], 2)
    dx_cg = mesh_same_solve(qt, "(a) CG", a["cg"], plain["cg"], 0.15 * plain["cg"]["iterations"])
    converged, med, itmax, gmax = fleet_line(qt, pipe.map_result)
    jax_med = JAX_WORKFLOW["median_iterations"]
    check(converged == BATCH and gmax < LOGISTIC_TOL and abs(med - jax_med) <= 0.1 * jax_med,
          f"mesh (a) pipeline: {converged}/{BATCH} converged, median {med} (JAX {jax_med})")
    check(bool(torch.isfinite(pipe.samples).all()) and tuple(pipe.samples.shape)
          == (MESH_PIPE_HMC[1], BATCH, LOGISTIC_N), "mesh (a) pipeline: draws")
    warm, draws = MESH_CHEES
    t0 = time.perf_counter()
    un_chees = mesh_chees_run(qt.chees_sample(logistic, BENCH_SEED, x0s, n_warmup=warm,
                                              n_samples=draws))
    walls_un["chees"] = time.perf_counter() - t0
    d_chees = mesh_chees_apart(a["chees"], un_chees)
    acc = float(a["chees"]["accept"].mean())
    check(d_chees == (0.0, 0.0, 0.0) and abs(acc - CHEES_TARGET) <= ACCEPT_ATOL,
          f"mesh (a): ChEES {d_chees} from the unsharded run, mean accept {acc:.4f}")
    # a one-ulp witness: the same run on the model whose data X moved one
    # float32 ulp, so that every gradient rounds otherwise, as (b)'s GEMM
    # over 2048 chains may: the distance rounding alone makes over 70
    # adaptive rounds
    Xd, yd, _ = logistic_data(np.random.default_rng(BENCH_SEED))
    Xw = np.nextafter(Xd.astype(np.float32), np.float32(np.inf))
    witness_model = LogisticRegressionMAP(LOGISTIC_N, LOGISTIC_OBS, prior_scale=LOGISTIC_PRIOR,
                                          X=Xw, y=yd, dtype=torch.float32, device=device)
    witness = mesh_chees_apart(mesh_chees_run(qt.chees_sample(
        witness_model, BENCH_SEED, x0s, n_warmup=warm, n_samples=draws)), un_chees)
    del witness_model
    chees_x0s = x0s
    del un, un_lbfgs, un_cg, pipe, logistic, logd, x0, X
    # queued: at 4096 x 60 a launch's host time exceeds its kernel's, so
    # back-to-back calls alone would time the dispatch (0.05-0.10 ms)
    err, b1_ms, plain_ms, (bound_ms, bound_by) = sampling_b1(qt, device, n=N, queued=True)
    w = a["walls"]
    log(f"[mesh] (a) one rank over NCCL on {device}: optimize_batched_sharded on the phase-4 "
        f"fleet {BATCH}x{N} f32 {w['fleet']:.2f} s (unsharded {walls_un['fleet']:.2f} s), "
        f"statuses and iterations equal to the unsharded engine's, x within {dx_fleet:.1e}, B1 "
        f"{launches} launches = loop bodies; optimize_lbfgs_sharded n={MESH_N} f32 tol "
        f"{MESH_TOL}: {a['lbfgs']['iterations']} iterations (unsharded two-loop "
        f"{plain['lbfgs']['iterations']}), optima {dx_lbfgs:.1e} apart, {w['lbfgs']:.2f} s "
        f"(unsharded {walls_un['lbfgs']:.2f} s); optimize_cg_model_sharded: "
        f"{a['cg']['iterations']} iterations (unsharded {plain['cg']['iterations']}), optima "
        f"{dx_cg:.1e} apart, {w['cg']:.2f} s (unsharded {walls_un['cg']:.2f} s); "
        f"map_then_sample(mesh=) on config 3 from {BATCH} starts: {converged}/{BATCH} "
        f"converged, median {med:g} max {itmax} (JAX {jax_med:g}), B1 {pipe_c['B1']} launches "
        f"= loop bodies, HMC {MESH_PIPE_HMC[0]} + {MESH_PIPE_HMC[1]}, {w['pipeline']:.2f} s; "
        f"sample_sharded ChEES {warm} + {draws} from its handoff: step size "
        f"{a['chees']['step_size']:.4f}, mean accept {acc:.4f}, equal to the unsharded run bit "
        f"for bit, {w['chees']:.2f} s (unsharded {walls_un['chees']:.2f} s); the run on the "
        f"data moved one ulp: step rel {witness[0]:.1e}, mean accept {witness[1]:.1e}, draws "
        f"{witness[2]:.1e} apart; B1 at {BATCH}x{N} f32 against its plain version max abs err "
        f"{err:.3e}, {b1_ms:.4f} ms a launch (CUDA events behind a held stream), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), B1 at "
        f"{100 * bound_ms / b1_ms:.1f} % of it on {smi}")

    # (b) two ranks over gloo on the one card, held to (a)
    t0 = time.perf_counter()
    ranks = mesh_ranks(qt, chees_x0s)
    del chees_x0s
    rank_s = time.perf_counter() - t0
    for r, other in enumerate(ranks[1:], 1):
        for leg in ("fleet", "lbfgs", "cg", "pipeline", "chees"):
            for key, value in other[leg].items():
                check(np.array_equal(value, ranks[0][leg][key]),
                      f"mesh (b): rank {r}'s {leg} {key} differs from rank 0's")
    b = ranks[0]
    check(np.array_equal(b["fleet"]["status"], a["fleet"]["status"])
          and np.array_equal(b["fleet"]["iterations"], a["fleet"]["iterations"]),
          "mesh (b): the fleet's statuses or iterations differ from (a)'s lane for lane")
    dx_b = float(np.abs(b["fleet"]["x"] - a["fleet"]["x"]).max())
    check(dx_b <= MESH_X_ATOL, f"mesh (b): fleet x {dx_b:.2e} from (a)'s")
    dx_lb = mesh_same_solve(qt, "(b) L-BFGS", b["lbfgs"], a["lbfgs"], 2)
    dx_cgb = mesh_same_solve(qt, "(b) CG", b["cg"], a["cg"], 0.15 * a["cg"]["iterations"])
    # the logistic's gradient is a GEMM over each rank's chains, which
    # cuBLAS may round otherwise at 2048 rows than at 4096: the pipeline's
    # lanes are held to the gates (a)'s are, ChEES to MESH_CHEES_TOL
    iters_b = b["pipeline"]["iterations"]
    med_b = float(np.median(iters_b))
    check(np.array_equal(b["pipeline"]["status"], a["pipeline"]["status"])
          and abs(med_b - jax_med) <= 0.1 * jax_med,
          f"mesh (b): the pipeline's MAP statuses differ from (a)'s or its median {med_b} is "
          f"not within 10% of JAX's {jax_med}")
    lanes_apart = int((iters_b != a["pipeline"]["iterations"]).sum())
    d_pipe = float(np.abs(b["pipeline"]["samples"] - a["pipeline"]["samples"]).max())
    d_chees_b = mesh_chees_apart(b["chees"], a["chees"])
    acc_b = float(b["chees"]["accept"].mean())
    check(d_chees_b[0] <= MESH_CHEES_TOL and d_chees_b[1] <= MESH_CHEES_TOL
          and abs(acc_b - CHEES_TARGET) <= ACCEPT_ATOL and np.isfinite(b["chees"]["samples"]).all(),
          f"mesh (b): ChEES step rel {d_chees_b[0]:.2e}, mean accept {d_chees_b[1]:.2e} from "
          f"(a)'s (limit {MESH_CHEES_TOL}; the one-ulp witness {witness[0]:.2e} / "
          f"{witness[1]:.2e}), mean accept {acc_b:.4f} (target {CHEES_TARGET})")
    wb = b["walls"]
    log(f"[mesh] (b) {MESH_RANKS} ranks over gloo on the one card, {rank_s:.1f} s with their "
        f"start: the fleet lane for lane (x within {dx_b:.1e}, {wb['fleet']:.2f} s), L-BFGS "
        f"{b['lbfgs']['iterations']} iterations (optima {dx_lb:.1e} apart, {wb['lbfgs']:.2f} s), "
        f"CG {b['cg']['iterations']} ({dx_cgb:.1e}, {wb['cg']:.2f} s), the pipeline's MAP "
        f"statuses equal, median {med_b:g}, {lanes_apart} lanes' iterations apart from (a)'s, "
        f"draws within {d_pipe:.1e} ({wb['pipeline']:.2f} s), ChEES from (a)'s starts: step "
        f"rel {d_chees_b[0]:.1e}, mean accept {d_chees_b[1]:.1e}, draws {d_chees_b[2]:.1e} "
        f"from (a)'s ({wb['chees']:.2f} s); both ranks the same whole result")
    log(f"[mesh] phase 32 took {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches, err, (b1_ms, plain_ms, bound_ms, bound_by, None)


# Phase 33: B3 on the trace's newer ops (ops/kernels/objective_trace.py,
# objective_codegen.py and csrc/resident_linalg.cuh): comparisons and masks, sqrt, abs,
# softplus, sin, clamp and maximum, mean and vector norms, and per lane the Cholesky
# factorization, triangular solves, logdet / slogdet and solve. The full-width fleets,
# each drawn with numpy from a fresh generator seeded BENCH_SEED (`ops_data`), at most
# 3000 iterations: pseudo-Huber regression -m·mean(sqrt(1 + r²) - 1) - |w|²/(2·10²) with
# r = y - X w on BASELINE config 3's widths (n = 100, 500 observations, X = N(0, 1)/10,
# y = X w_true + 0.5·t3 noise, 4096 N(0, 1) starts, float32, tol 3e-3); a Poisson GLM
# with a softplus link on the same widths (y ~ Poisson(softplus(X w_true))); a bounded
# log-density on the bench fleet's 4096 x 60 float32 starts (tol 1e-3), per entry -d·(z
# - c)²/2 with z = clamp(x, -4, 4) and curvatures d from 10^-0.5 to 10, less x² - 16
# beyond the support test x² < 16, plus 0.2·sin z - 0.1·|x - 6| - max(x - 5, 0), less |x
# - c2|/2 (the 2-norm); and Gaussian-process hyperparameter MAP (log amplitude, log
# lengthscale, log noise under N(0, 1) priors) on GP_M = 32 points in the plane,
# float64, tol 1e-6, 4096 N(0, 1) starts, in its Cholesky form (cholesky,
# solve_triangular, the log of L's diagonal) and its logdet + solve form (LU:
# _linalg_slogdet, _linalg_solve_ex). m = 32 fits one lane in float64
# (`resident_feasible`: 23864 scratch values in the Cholesky form, 19580 in the logdet
# form, of the 29056 a block holds), uncut. The JAX package on the same data (`python
# scripts/jax_traced_ops_reference.py`, its fleet engine on the CPU): (converged,
# median, max) robust (4094, 11, 15; 2 LINESEARCH_FAILURE), softplus Poisson (4096, 11,
# 16), bounded (4021, 28, 49; 75 LINESEARCH_FAILURE on float32's floor), GP Cholesky
# (4059, 14, 29) and logdet (4055, 14, 29), the rest LINESEARCH_FAILURE on float64's
# floor near the modes.
OPS_BATCH = 4096
GP_M, GP_JITTER = 32, 1e-6
BOUNDED_CURVATURES = np.logspace(-0.5, 1.0, N)  # the bounded fleet's, condition ~32
OPS_FLEETS = {  # fleet: (dtype, tol, JAX converged, median, max)
    "robust": (torch.float32, LOGISTIC_TOL, 4094, 11.0, 15),
    "softplus poisson": (torch.float32, LOGISTIC_TOL, 4096, 11.0, 16),
    "bounded": (torch.float32, TOL, 4021, 28.0, 49),
    "gp cholesky": (torch.float64, 1e-6, 4059, 14.0, 29),
    "gp logdet": (torch.float64, 1e-6, 4055, 14.0, 29),
}
# The parity objectives (OBJECTIVE_LANES lanes, seed BENCH_SEED + n as in phase
# 22): one per group of ops (the twins of tests/test_torch_resident_ops.py's),
# the two GP forms at m = 8, and two lanes of two warps (n = 70): one factorizes,
# solves and takes a slogdet of an SPD matrix, the other takes LU's slogdet and
# solve of a non-symmetric m = 16 matrix whose partial pivoting swaps rows on
# every column but the last (`pivoting_matrix`). (kind, n, dtypes)
OPS_PARITY = (
    ("comparisons and masks", 60, (torch.float64, torch.float32)),
    ("elementwise functions", 60, (torch.float64, torch.float32)),
    ("mean and norms", 100, (torch.float64,)),
    ("gp cholesky", 3, (torch.float64, torch.float32)),
    ("gp lu", 3, (torch.float64,)),
    ("linalg across two warps", 70, (torch.float64,)),
    ("lu pivoting across two warps", 70, (torch.float64,)),
)


def gp_points(rng, m):
    """GP data: m points uniform on [-3, 3]², their squared distances, and
    targets sin(p0)·cos(p1) + 0.1·N(0, 1)."""
    P = rng.uniform(-3.0, 3.0, (m, 2))
    y = np.sin(P[:, 0]) * np.cos(P[:, 1]) + 0.1 * rng.standard_normal(m)
    return ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1), y


def pivoting_matrix(rng, m):
    """A non-symmetric m x m matrix whose LU with partial pivoting swaps rows
    on every column but the last: a diagonal from 3 to 5 plus 0.3·N(0, 1)/√m
    off it, its rows shifted down by one, so that column j's largest entry
    lies one row below the diagonal."""
    M = np.diag(np.linspace(3.0, 5.0, m)) + 0.3 * rng.standard_normal((m, m)) / np.sqrt(m)
    return np.roll(M, 1, axis=0)


def ops_data(name):
    """Phase 33's fleet ``name``: its data and its starts, float64 numpy,
    from a fresh generator seeded BENCH_SEED, in the order
    scripts/jax_traced_ops_reference.py takes them."""
    rng = np.random.default_rng(BENCH_SEED)
    if name in ("robust", "softplus poisson"):
        X = rng.standard_normal((LOGISTIC_OBS, LOGISTIC_N)) / np.sqrt(LOGISTIC_N)
        z = X @ rng.standard_normal(LOGISTIC_N)
        y = (z + 0.5 * rng.standard_t(3, LOGISTIC_OBS) if name == "robust"
             else rng.poisson(np.logaddexp(0.0, z)).astype(np.float64))
        return {"X": X, "y": y, "starts": rng.standard_normal((OPS_BATCH, LOGISTIC_N))}
    if name == "bounded":
        starts = rng.standard_normal((BATCH, N))  # the bench fleet's
        return {"c": 0.5 * rng.standard_normal(N), "c2": rng.standard_normal(N),
                "starts": starts}
    d2, y = gp_points(rng, GP_M)
    return {"d2": d2, "y": y, "starts": rng.standard_normal((OPS_BATCH, 3))}


def gp_objective(d2, y, form, t):
    """The GP's log marginal likelihood plus N(0, 1) log priors on (log
    amplitude, log lengthscale, log noise): in its Cholesky form, or with
    logdet (``form`` "logdet") or slogdet ("lu") and solve."""
    m = y.shape[0]
    eye = t(np.eye(m))

    def K(th):
        return (torch.exp(th[0]) * torch.exp(-0.5 * d2 * torch.exp(-2.0 * th[1]))
                + (torch.exp(th[2]) + GP_JITTER) * eye)

    if form == "cholesky":
        def gp(th):
            L = torch.linalg.cholesky(K(th))
            a = torch.linalg.solve_triangular(L, y[:, None], upper=False)
            return (-0.5 * torch.sum(a * a) - torch.sum(torch.log(torch.diagonal(L)))
                    - 0.5 * torch.sum(th * th))
    else:
        def gp(th):
            Kt = K(th)
            logdet = torch.logdet(Kt) if form == "logdet" else torch.linalg.slogdet(Kt)[1]
            return -0.5 * y @ torch.linalg.solve(Kt, y) - 0.5 * logdet - 0.5 * torch.sum(th * th)
    return gp


def ops_objective(name, data, dtype, device):
    """The torch log-density of phase 33's fleet ``name`` on ``data``, its
    tensors on ``device`` in ``dtype``."""
    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    if name.startswith("gp"):
        return gp_objective(t(data["d2"]), t(data["y"]), name.split()[1], t)
    if name == "bounded":
        c, c2, d = t(data["c"]), t(data["c2"]), t(BOUNDED_CURVATURES)

        def bounded(x):
            z = torch.clamp(x, -4.0, 4.0)
            r2 = x * x
            q = -0.5 * d * (z - c) ** 2
            body = torch.where(r2 < 16.0, q, q - (r2 - 16.0))
            return (torch.sum(body) + 0.2 * torch.sum(torch.sin(z))
                    - 0.1 * torch.sum(torch.abs(x - 6.0))
                    - torch.sum(torch.maximum(x - 5.0, torch.zeros_like(x)))
                    - 0.5 * torch.linalg.vector_norm(x - c2))
        return bounded
    X, y = t(data["X"]), t(data["y"])
    m, p2 = X.shape[0], LOGISTIC_PRIOR ** 2
    if name == "robust":
        def robust(w):
            r = y - X @ w
            return -m * torch.mean(torch.sqrt(1.0 + r * r) - 1.0) - 0.5 * torch.sum(w * w) / p2
        return robust

    def poisson(w):
        rate = torch.nn.functional.softplus(X @ w)
        return torch.sum(y * torch.log(rate) - rate) - 0.5 * torch.sum(w * w) / p2
    return poisson


def ops_case(kind, n, dtype, device):
    """(objective, None, numpy starts) of phase 33's parity case ``kind`` at
    width n, its data drawn with numpy from seed BENCH_SEED + n."""
    rng = np.random.default_rng(BENCH_SEED + n)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    scale = 1.0
    if kind == "comparisons and masks":
        c = t(0.5 * rng.standard_normal(n))

        def obj(x):
            r = x - c
            inside = ((x * x < 4.0) & torch.logical_not(x >= 3.0) & (x < c + 3.0)
                      & (x >= c - 3.0))
            far = torch.logical_or(x <= -5.0, x > 5.0) & (x != 6.0) & (x != c + 7.0)
            v = torch.where(inside, -r * r, -r * r - (x * x - 4.0))
            r2 = torch.sum(x * x)
            return torch.sum(v.masked_fill(far, -30.0)) + torch.where(r2 < 50.0 * n, 0.0, -r2)
        scale = 1.5
    elif kind == "elementwise functions":
        c = t(0.5 * rng.standard_normal(n))

        def obj(x):
            M = (torch.clamp(x, -4.0, 4.0) - c).reshape(n // 3, 3).transpose(0, 1)
            s = torch.nn.functional.softplus(x) + torch.nn.functional.softplus(
                x - c, beta=2.0, threshold=10.0)
            return (-torch.sum(torch.sqrt(1.0 + M * M)) + 0.1 * torch.sum(torch.sin(x))
                    - 0.3 * torch.sum(torch.abs(x - 5.0)) - 0.05 * torch.sum(s)
                    - torch.sum(torch.maximum(x - 3.0, torch.zeros_like(x)))
                    - torch.sum(torch.minimum(x + 3.0, torch.zeros_like(x)) ** 2)
                    - 0.1 * torch.sum(x * x))
    elif kind == "mean and norms":  # pseudo-Huber regression, 5n observations
        A = rng.standard_normal((5 * n, n)) / np.sqrt(n)
        y = t(A @ rng.standard_normal(n) + 0.3 * rng.standard_t(3, 5 * n))
        A = t(A)

        def obj(w):
            r = y - A @ w
            return (-5 * n * torch.mean(torch.sqrt(1.0 + r * r) - 1.0)
                    - 0.05 * torch.linalg.vector_norm(w - 0.1) ** 2
                    - torch.sum(torch.mean(w.reshape(-1, 2), dim=1) ** 2))
    elif kind.startswith("gp"):
        d2, y = gp_points(rng, 8)
        obj = gp_objective(t(d2), t(y), kind.split()[1], t)
        scale = 0.5
    elif kind == "linalg across two warps":
        m = 6
        B, y = rng.standard_normal((m, m)), t(rng.standard_normal(m))
        K0 = t(B @ B.T / m)

        def obj(x):
            K = K0 + torch.diag(torch.exp(x[:m])) + 0.1 * torch.outer(x[m:2 * m], x[m:2 * m])
            L = torch.linalg.cholesky(K)
            a = torch.linalg.solve_triangular(L, y[:, None], upper=False)
            _, logdet = torch.linalg.slogdet(K)
            return (-0.5 * torch.sum(a * a) - torch.sum(torch.log(torch.diagonal(L)))
                    - 0.5 * torch.sum(x * x) - 0.01 * logdet
                    + 0.01 * (y @ torch.linalg.solve(K, y)))
        scale = 0.3
    elif kind == "lu pivoting across two warps":
        m = 16
        A0, y = t(pivoting_matrix(rng, m)), t(rng.standard_normal(m))

        def matrix(x):
            return A0 + torch.diag(x[:m]) + 0.1 * torch.outer(x[m:2 * m], x[2 * m:3 * m])

        def obj(x):
            K = matrix(x)
            return (-0.5 * torch.sum(x * x) - torch.linalg.slogdet(K)[1]
                    + 2.0 * (y @ torch.linalg.solve(K, y)))
        obj.matrix = matrix  # for the test that its pivoting swaps rows
        scale = 0.3
    else:
        raise AssertionError(kind)
    return obj, None, scale * rng.standard_normal((OBJECTIVE_LANES, n))


def ops_fleets(device):
    """Phase 33's full-width fleets: {name: (objective, starts, tol)}."""
    out = {}
    for name, (dtype, tol, *_) in OPS_FLEETS.items():
        data = ops_data(name)
        out[name] = (ops_objective(name, data, dtype, device),
                     torch.tensor(data["starts"], dtype=dtype, device=device), tol)
    return out


def ops_objectives(qt, device):
    """Phase 33's objectives, traced (`traced_group`)."""
    return traced_group(qt, device, OPS_PARITY, ops_case, ops_fleets, phase="33", tag="ops",
                        jax=OPS_FLEETS, needs=ops_needs, chaotic=("gp cholesky", "gp logdet"))


def traced_group(qt, device, parity, case, fleets_on, f32_tol=TOL, **spec):
    """The objectives of a phase of traced ops (33-35), traced: the parity
    cases of ``parity`` (label, trace, X, tol, its recipe; ``case(kind, n,
    dtype, device)`` makes each, float32 at ``f32_tol``, float64 at 1e-6), the
    full-width fleets (``fleets_on(device)``)
    and their traces; "sources": every trace's generated CUDA; and the
    phase's ``spec`` for `ops_phase`: its number and log tag, the JAX
    package's counts, the function's needs (`ops_needs`), the chaotic
    fleets."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.objective_codegen import generate

    cases = []
    for kind, n, dtypes in parity:
        for dtype in dtypes:
            obj, _, starts = case(kind, n, dtype, device)
            X = torch.tensor(starts, dtype=dtype, device=device)
            cases.append((f"{kind} {OBJECTIVE_LANES}x{n} {str(dtype).replace('torch.', '')}",
                          qt.trace_objective(obj, None, X), X,
                          f32_tol if dtype == torch.float32 else 1e-6, (kind, n, dtype)))
    fleets = fleets_on(device)
    traced = {name: qt.trace_objective(obj, None, X) for name, (obj, X, _) in fleets.items()}
    everything = [c[1] for c in cases] + list(traced.values())
    return {"cases": cases, "fleets": fleets, "traced": traced,
            "sources": [generate(t) for t in everything], "case": case, "fleets_on": fleets_on,
            **spec}


def ops_needs(name, n, itemsize, trace=None):
    """`objective_ops` of phase 33's fleet ``name``: what the function needs
    per value and gradient (the tolerance test n among it) and per trial (x +
    αd 2n among it), and its data bytes, as phase 22 counts its fleets. Not
    the traced graph's count: the logdet form's graph factorizes K once for
    slogdet and once for solve, and its gradient once more for each solve.
    Pseudo-Huber (m observations): Xw 2mn, per observation y - Xw, r², 1 +
    r², the root, - 1 and the sum, 4 scalars; the gradient r/s and its
    scale per observation and Xᵀu 2mn; the prior w², its sum, w/p² and the
    gradient's sum per entry. Softplus Poisson: Xw 2mn, per observation the
    softplus (exp, log1p), its log, y·log, - rate and the sum; the gradient
    y/rate - 1, the sigmoid and their product per observation, Xᵀu 2mn; the
    prior as above. Bounded: per entry 22 for the value (the clamp, x², z -
    c, its square, the products by d and -0.5, the support test, r² - 16,
    the difference, the select and the sum; sin and its sum; x - 6, |.| and
    the sum; x - 5, the max and the sum; x - c2, its square and the sum)
    and 8 scalars; the gradient per entry 19 (-d(z - c) 2, the clamp's mask
    and select, the support branch's -2x 2, 0.2 cos z 2, 0.1 sgn(x - 6) 2,
    the max's step, (x - c2)/|x - c2|/2 2, the five sums, the tolerance
    test) and 2 scalars. The GP on m points: K per entry d2·s, exp and ·amp
    (3m²), the noise on its diagonal (m), 5 scalars; the Cholesky form
    factorizes K (m³/3), solves L a = y (m²) and sums a·a and log diag L
    (4m); its gradient solves Lᵀα = a (m²), inverts K from L (2m³/3), forms
    G = ααᵀ - K⁻¹ (2m²), P = G∘K_se (m²), the amplitude's Σ P (m²), the
    lengthscale's Σ P∘(d2·s) (2m²), the noise's trace of G (m) and 5
    scalars. The logdet form factorizes K by LU (2m³/3), sums the log of U's
    diagonal (2m), solves K α = y (2m², the two substitutions) and takes
    y·α (2m); its gradient inverts K from the factors (4m³/3) and forms G,
    P and the three sums as above. Both: the prior 2n, its gradient 2n,
    2 scalars."""
    if name in ("robust", "softplus poisson"):
        m = LOGISTIC_OBS
        per_obs = 8 if name == "robust" else 10
        return (4 * m * n + per_obs * m + 5 * n + 4, 2 * m * n + 6 * m + 4 * n + 4,
                (m * n + m) * itemsize)
    if name == "bounded":
        return 41 * n + 10, 24 * n + 8, 3 * n * itemsize
    m = GP_M
    factor, inverse, solve = ((m ** 3 / 3, 2 * m ** 3 / 3, m * m) if name == "gp cholesky"
                              else (2 * m ** 3 / 3, 4 * m ** 3 / 3, 2 * m * m))
    trial = factor + 3 * m * m + solve + 5 * m + 4 * n + 7
    return trial + inverse + 7 * m * m + m + n + 5, trial, (m * m + m) * itemsize


def ops_phase(qt, device, smi, objectives, build):
    """B3 on the trace's newer ops (phases 33-35, see above):
    ``objectives`` from `traced_group`, ``build`` their build's report.
    Returns each full-width fleet's record: (launches, max abs error, (ms,
    plain ms, bound ms, bound kind, library ms))."""
    from quasinewtonmethods_jl_tpu_torch.ops.kernels.resident_kernel import (
        resident_feasible,
        resident_occupancy,
    )

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    cases, fleets, traced = objectives["cases"], objectives["fleets"], objectives["traced"]
    phase, tag, case = objectives["phase"], objectives["tag"], objectives["case"]
    libs, cold = build
    log(f"[{tag}] {len(cases) + len(fleets)} objectives traced and generated, built beside the "
        f"kernel library in {cold:.1f} s; {ptxas_report(libs)}")

    # B3 against its plain version on every parity objective
    failures = []
    for label, trace, X, tol, (kind, n, dtype) in cases:
        cpu_traced = qt.trace_objective(case(kind, n, dtype, cpu)[0], None, X.cpu())
        summary, _, bad = traced_parity(qt, trace, X, tol, label, cpu_traced)
        print(f"  B3 vs plain {summary}", file=sys.stderr)
        failures += bad
    log(f"[{tag}] B3 vs plain on {len(cases)} objectives of {OBJECTIVE_LANES} lanes (rows on "
        f"stderr): {len(cases) - len({f.split(' cap=')[0] for f in failures})}/{len(cases)} pass "
        f"({time.perf_counter() - t_phase:.1f} s into phase {phase})")
    check(not failures, f"B3 and its plain version differ on phase {phase}'s objectives: "
                        f"{failures}")

    # the slice's main path: each full-width fleet against its plain version (the
    # plain whole solve timed alone), then through the entry point, counted
    records, lines, timings = {}, [], []
    cpu_fleets = objectives["fleets_on"](cpu)
    for name, (obj, X, tol) in fleets.items():
        trace, dtype = traced[name], X.dtype
        label = f"{name} {X.shape[0]}x{X.shape[1]} {str(dtype).replace('torch.', '')} tol {tol}"
        cpu_obj, cpu_X, _ = cpu_fleets[name]
        walls, t_fleet = {}, time.perf_counter()
        # the GP is chaotic at m = 32: rounding alone (the CPU's run, a start one
        # ulp away) changes lanes' counters within five iterations, as phase 23's
        # model does, so its caps are held to the witnesses by phase 23's rule
        summary, err, bad = traced_parity(qt, trace, X, tol, label,
                                          qt.trace_objective(cpu_obj, None, cpu_X),
                                          cpu_whole=False, chaotic=name in objectives["chaotic"],
                                          walls=walls)
        print(f"  B3 vs plain {summary}", file=sys.stderr)
        check(not bad, f"B3 and its plain version differ on {label}: {bad}")
        # the entry point traces the function first (a trace's constants reach the
        # card by copies from the host: D.StudentT's inner Chi2 makes a 0.5 with
        # torch.tensor), so that the counted solve is the launch alone
        qt.optimize_batched_resident(obj, X, tol=tol, max_iterations=0)
        torch.cuda.synchronize()
        reset_counters(qt)
        res, flagged, _ = resident_run(qt, obj, X, tol)
        c = read_counters(qt)
        launched = counted_kernels()["B3"].objective_launches["traced"]
        check(flagged == 0, f"{name}: {flagged} host synchronisations inside the resident solve")
        check(launched == 1 and c["B3"] == 1 and c["B1"] == c["B2a"] == c["B2b"] == 0,
              f"{name}: launches {dict(counted_kernels()['B3'].objective_launches)}, {c}")
        jax_conv, jax_med, jax_max = objectives["jax"][name][2:]
        conv, med, itmax, gmax = fleet_line(qt, res)
        ok = res.status == qt.Status.CONVERGED
        gmax = float(res.grad[ok].abs().max()) if bool(ok.any()) else 0.0
        ends = int(((res.status == qt.Status.CONVERGED)
                    | (res.status == qt.Status.LINESEARCH_FAILURE)).sum())
        p = fewer_converged_p(conv, jax_conv, X.shape[0])
        # where float32's floor stops more than a tenth of JAX's lanes, the floor of
        # the reference's float32 math (XLA's on the CPU) shapes its iteration counts,
        # not the engine: the median is shown, not held (phase 23's rule; the plain
        # version's rounding witnesses hold B3 above, the Fisher test the count)
        held = 10 * (X.shape[0] - jax_conv) <= X.shape[0]
        lines.append(f"{name} {X.shape[0]}x{X.shape[1]} through B3: converged {conv}/"
                     f"{X.shape[0]} (JAX {jax_conv}, one-sided Fisher p {p:.3g}), iterations "
                     f"median {med:g} max {itmax} (JAX {jax_med} / {jax_max}"
                     + ("" if held else "; on the floor, not held") + "), max|grad| of the "
                     f"converged {gmax:.3e}")
        check(ends == X.shape[0] and gmax < tol and bool(torch.isfinite(res.x).all()),
              f"{name}: statuses {torch.bincount(res.status.long().cpu()).tolist()}, max|grad| "
              f"{gmax}")
        check(conv == X.shape[0] if jax_conv == X.shape[0] else p >= 0.01,
              f"{name}: {conv} converged against JAX's {jax_conv} (p {p:.3g})")
        check(not held or abs(med - jax_med) <= 0.1 * jax_med,
              f"{name}: median {med} not within 10% of JAX's {jax_med}")
        ms = per_call_ms({"B3": lambda: qt.optimize_batched_resident(
            trace, X, tol=tol, max_iterations=MAX_ITERS)}, (), rounds=2, calls=1)["B3"]
        n, itemsize = X.shape[1], X.element_size()
        needs = objectives["needs"](name, n, itemsize, trace)
        b = b3_bound(res, n, itemsize, True, ops=needs)
        graph = b3_bound(res, n, itemsize, True,
                         ops=(trace.ops_vag + n, trace.ops_value + 2 * n, trace.const_bytes))
        occ = resident_occupancy(n, itemsize, trace)
        feasible = resident_feasible(n, itemsize, trace)
        timings.append(
            f"{name} {X.shape[0]}x{n}: B3 {ms:.4f} ms ({1e3 * X.shape[0] / ms:.1f} solves/s), "
            f"plain version {walls['plain']:.1f} ms; bound {b[0]:.4f} ms ({b[1]}; the function "
            f"needs {needs[0]:.0f} operations per value and gradient, {needs[1]:.0f} per "
            f"trial, {needs[2]} data bytes), at {100 * b[0] / ms:.2f} % (its graph counts "
            f"{trace.ops_vag} and {trace.ops_value}, {trace.const_bytes} constant bytes, which "
            f"would give {graph[0]:.4f} ms); {trace.extra_values} scratch values per lane "
            f"(feasible {feasible}); launch {shape_line(occ)}; "
            f"{time.perf_counter() - t_fleet:.1f} s in all")
        print(f"  [{tag}] {timings[-1]}", file=sys.stderr)
        records[f"{tag}:{name.replace(' ', '_')}"] = (launched, err,
                                                     (ms, walls["plain"], *b, None))
    log(f"[{tag}] full-width fleets on {device}: one launch of B3 each, no host "
        f"synchronisation; " + "; ".join(lines))
    log(f"[time] phase {phase} per solve (CUDA events; B3 the median of 2, the plain version one "
        f"call): " + "; ".join(timings) + f" on {smi}; phase {phase} took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return records


# Phase 34: B3 on the log-densities of torch.distributions (objective_trace.py,
# objective_codegen.py): lgamma and its backward digamma, xlogy, erf / erfc /
# log_ndtr, expm1, reciprocal, rsqrt, atan2, pow with a tensor exponent, max / min
# (amax / amin, max.dim / min.dim), casts of truth values and BCE with logits, written
# with torch.distributions (argument validation off: it is a data-dependent branch, see
# main). The full-width fleets, each drawn with numpy from a fresh generator seeded
# BENCH_SEED (`dists_data`), at most 3000 iterations, 4096 N(0, 1) starts: a negative
# binomial regression with an unknown dispersion (D.NegativeBinomial, total count
# exp(s), logits 1 + X w - s, so that the mean is exp(1 + X w); N(0, 10²) on w, N(0, 1)
# on s; n = 101) on BASELINE config 3's widths (500 observations, X = N(0, 1)/10, y ~
# NB(5, mean exp(1 + X w_true))), float32 and once in float64, tol 3e-3; probit
# regression through torch.special.log_ndtr on the same widths
# (y ~ Bernoulli(Φ(X w_true)), n = 100), float32; and the distributions mix on the bench
# fleet's 4096 x 60 float32 starts, tol 1e-2 (as phase 21's Poisson fleet: at 1e-3
# float32's floor stops four lanes in five, at 3e-3 two in five, of JAX's), each
# positive parameter exp(x/2), x
# clamped to [-20, 20] (in float32 a far line-search trial overflows exp otherwise): the
# log-probabilities of D.Gamma (5 + 5 shapes and rates, 10 x 5 draws), D.Beta (one
# pair of scalar parameters over 10 x 5 draws: torch's Beta of vectors is a Dirichlet
# of rank 3 per lane),
# D.Poisson (10 rates, 10 x 10), D.Dirichlet (10 concentrations, 10 points of the
# 10-simplex), D.Weibull (5 + 5 scales and concentrations, 10 x 5), D.Uniform (bounds
# -0.5 - exp(x/2) and 0.5 + exp(x/2) around 4 x 2 draws in [-0.5, 0.5]: its support
# mask cast to float) and D.Bernoulli(logits = Z x) (30 labels, 6 coefficients), plus
# -0.1·Σ expm1(0.2 x) over the Gamma's x, 0.1·Σ rsqrt(1 + x²) over the Beta's, 0.05·Σ
# atan2(x, h) over the Weibull's and 0.1·amax(x + shift) over the Poisson's (shift 0
# then -20: one element far above the rest), and N(0, 1) priors. (name: (dtype, tol, JAX
# converged, median, max)); the JAX package's counts on the same data (`python
# scripts/jax_traced_dists_reference.py`, its fleet engine on the CPU): negative
# binomial f32 6 converged, median 61, max 169, the rest LINESEARCH_FAILURE on float32's
# floor (lgamma's and digamma's differences over 500 observations); f64 4096, 58, 68;
# probit 4094, 14, 20; the mix 3966, 20, 273 (130 on the floor). D.StudentT traces,
# generates and holds against JAX's resident engine on the CPU
# (tests/test_torch_resident_dists.py) but runs no fleet here: at these widths its
# plain version's whole solves and their witnesses took 100-180 s of the script, and one
# lane of 4096 ended LINESEARCH_FAILURE in every plain run where B3 (and JAX) converged
# it, which the whole-solve rule counts against B3.
DISTS_FLEETS = {
    "negbin": (torch.float32, LOGISTIC_TOL, 6, 61.0, 169),
    "negbin f64": (torch.float64, LOGISTIC_TOL, 4096, 58.0, 68),
    "probit": (torch.float32, LOGISTIC_TOL, 4094, 14.0, 20),
    "mix": (torch.float32, 1e-2, 3966, 20.0, 273),
}
# The parity objectives of the five groups of ops (`dists_case`: the gamma family, the
# normal CDF family, the other elementwise functions, max and min over a lane of two
# warps, the loss and the casts) run as tests/test_torch_kernels_cuda.py's cases, not
# here: their generated units would lengthen the build that phases 2-9 wait for. The
# fleets hold every op against its plain version at full width, in float32 and float64.
DISTS_PARITY = ()
MIX_BLOCKS = {"gamma": 0, "beta": 10, "poisson": 20, "dirichlet": 30, "weibull": 40,
              "uniform": 50, "bernoulli": 54}  # where each block of the mix's 60 starts
MIX_DRAWS = 10  # draws of each of the mix's families


def dists_data(name):
    """Phase 34's fleet ``name``: its data and its starts, float64 numpy,
    from a fresh generator seeded BENCH_SEED, in the order
    scripts/jax_traced_dists_reference.py takes them."""
    rng = np.random.default_rng(BENCH_SEED)
    kind = name.split()[0]
    if kind == "mix":
        starts = rng.standard_normal((BATCH, N))  # the bench fleet's
        Z = rng.standard_normal((30, 6))
        c = (Z @ rng.standard_normal(6) + rng.logistic(size=30) > 0).astype(np.float64)
        return {"starts": starts, "gamma": rng.gamma(2.0, 1.0 / 1.5, (MIX_DRAWS, 5)),
                "beta": rng.beta(2.0, 3.0, (MIX_DRAWS, 5)),
                "poisson": rng.poisson(3.0, (MIX_DRAWS, 10)).astype(np.float64),
                "dirichlet": rng.dirichlet(np.full(10, 2.0), MIX_DRAWS),
                "weibull": 2.0 * rng.weibull(1.5, (MIX_DRAWS, 5)),
                "uniform": rng.uniform(-0.5, 0.5, (4, 2)), "Z": Z, "c": c,
                "h": 1.0 + rng.uniform(size=10),
                "shift": np.concatenate([[0.0], np.full(9, -20.0)])}
    X = rng.standard_normal((LOGISTIC_OBS, LOGISTIC_N)) / np.sqrt(LOGISTIC_N)
    z = X @ rng.standard_normal(LOGISTIC_N)
    if kind == "negbin":
        mean, r = np.exp(1.0 + z), 5.0
        y = rng.negative_binomial(r, r / (r + mean)).astype(np.float64)
    else:  # probit
        y = (z + rng.standard_normal(LOGISTIC_OBS) > 0).astype(np.float64)
    width = LOGISTIC_N + (kind == "negbin")
    return {"X": X, "y": y, "starts": rng.standard_normal((OPS_BATCH, width))}


def mix_objective(data, t):
    """The distributions mix (see phase 34 above) on ``data``, ``t`` making
    its tensors."""
    import torch.distributions as D

    g, b, k, p = t(data["gamma"]), t(data["beta"]), t(data["poisson"]), t(data["dirichlet"])
    wd, u, Z, c = t(data["weibull"]), t(data["uniform"]), t(data["Z"]), t(data["c"])
    h, shift = t(data["h"]), t(data["shift"])
    at = MIX_BLOCKS

    def mix(x):
        def block(name, size, skip=0):  # a block's positive parameters, exp(x/2)
            return torch.exp(0.5 * torch.clamp(x[at[name] + skip: at[name] + skip + size],
                                               -20.0, 20.0))

        lp = D.Gamma(block("gamma", 5), block("gamma", 5, 5)).log_prob(g).sum()
        # torch's Beta of vectors is a Dirichlet of rank 3 per lane: one Beta, scalar
        lp = lp + D.Beta(block("beta", 1), block("beta", 1, 1)).log_prob(b.reshape(-1)).sum()
        lp = lp + D.Poisson(block("poisson", 10)).log_prob(k).sum()
        lp = lp + D.Dirichlet(block("dirichlet", 10)).log_prob(p).sum()
        lp = lp + D.Weibull(block("weibull", 5), block("weibull", 5, 5)).log_prob(wd).sum()
        lp = lp + D.Uniform(-0.5 - block("uniform", 2),
                            0.5 + block("uniform", 2, 2)).log_prob(u).sum()
        lp = lp + D.Bernoulli(logits=Z @ x[at["bernoulli"]:]).log_prob(c).sum()
        xs = {name: x[at[name]: at[name] + 10] for name in ("gamma", "beta", "poisson", "weibull")}
        return (lp - 0.1 * torch.sum(torch.expm1(0.2 * xs["gamma"]))
                + 0.1 * torch.sum(torch.rsqrt(1.0 + xs["beta"] ** 2))
                + 0.05 * torch.sum(torch.atan2(xs["weibull"], h))
                + 0.1 * torch.amax(xs["poisson"] + shift) - 0.5 * torch.sum(x * x))
    return mix


def dists_objective(name, data, dtype, device):
    """The torch log-density of phase 34's fleet ``name`` on ``data``, its
    tensors on ``device`` in ``dtype``."""
    import torch.distributions as D

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    kind = name.split()[0]
    if kind == "mix":
        return mix_objective(data, t)
    X, y, p2 = t(data["X"]), t(data["y"]), LOGISTIC_PRIOR ** 2
    m = X.shape[1]
    if kind == "negbin":
        def negbin(th):
            w, s = th[:m], th[m]
            lp = D.NegativeBinomial(torch.exp(s), logits=X @ w + 1.0 - s).log_prob(y)
            return lp.sum() - 0.5 * torch.sum(w * w) / p2 - 0.5 * s * s
        return negbin
    sign = t(2.0 * data["y"] - 1.0)

    def probit(w):
        return (torch.sum(torch.special.log_ndtr(sign * (X @ w)))
                - 0.5 * torch.sum(w * w) / p2)
    return probit


def dists_case(kind, n, dtype, device):
    """(objective, None, numpy starts) of phase 34's parity case ``kind`` at
    width n, its data drawn with numpy from seed BENCH_SEED + n."""
    import torch.distributions as D

    rng = np.random.default_rng(BENCH_SEED + n)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    scale = 1.0
    if kind == "gamma family":  # lgamma (digamma its backward), xlogy's three forms
        c = t(np.abs(rng.standard_normal(n)) + 0.5)

        def obj(x):
            a = torch.exp(0.5 * x)
            return (torch.sum(torch.xlogy(a - 1.0, c) - c - torch.lgamma(a))
                    - 0.3 * torch.sum(torch.special.xlogy(2.0, 1.0 + x * x))
                    - 0.1 * torch.sum(torch.xlogy(x * x, 3.0)) - 0.5 * torch.sum(x * x))
    elif kind == "normal cdf":  # erf, erfc, log_ndtr (both of its branches), ndtr
        c = t(rng.standard_normal(n))

        def obj(x):
            return (torch.sum(torch.special.log_ndtr(2.0 * (x - c)))
                    + 0.2 * torch.sum(torch.erf(0.5 * x)) - 0.1 * torch.sum(torch.erfc(x - c))
                    + torch.sum(torch.log(torch.special.ndtr(x + 2.0))) - 0.5 * torch.sum(x * x))
    elif kind == "elementwise functions":  # expm1, reciprocal, rsqrt, atan2, the pows
        c = t(rng.standard_normal(n))
        base = t(1.5 + rng.standard_normal(n) ** 2)

        def obj(x):
            return (-0.1 * torch.sum(torch.expm1(0.5 * x)) + 0.3 * torch.sum(torch.rsqrt(1.0 + x * x))
                    + 0.2 * torch.sum(torch.reciprocal(2.0 + x * x))
                    + 0.1 * torch.sum(torch.atan2(x, c + 3.0))
                    - 0.1 * torch.sum(base ** (0.2 * x)) - 0.1 * torch.sum(2.0 ** (0.3 * x))
                    - 0.05 * torch.sum((2.0 + x * x) ** (1.0 + 0.1 * c * c))
                    - 0.5 * torch.sum(x * x))
    elif kind == "max and min":  # each extreme one element clear of the rest, two warps
        rows = n // 10
        lift = np.zeros(n)
        lift[rng.integers(0, n)] = 6.0
        grid = np.zeros((rows, 10))
        grid[np.arange(rows), rng.integers(0, 10, rows)] = 6.0
        lift, grid = t(lift), t(grid)

        def obj(x):
            M = x.reshape(rows, 10)
            return (0.3 * torch.max(x + lift) - 0.2 * torch.min(x - lift)
                    + 0.1 * torch.amax(x + lift) - 0.1 * torch.amin(x - lift)
                    + 0.2 * torch.sum(torch.amax(M + grid, dim=1))
                    + 0.1 * torch.sum(torch.max(M + grid, 1).values)
                    - 0.1 * torch.sum(torch.min(M.T - grid.T, 1)[0])
                    - 0.5 * torch.sum(x * x) - 0.05 * torch.sum(x ** 4))
    elif kind == "losses and casts":  # BCE with logits, the Uniform's mask, clone
        Z = t(rng.standard_normal((40, n)) / np.sqrt(n))
        yb = t(rng.integers(0, 2, 40).astype(np.float64))
        weight, u = t(rng.uniform(0.5, 1.5, 40)), t(rng.uniform(-0.5, 0.5, (3, 5)))
        bce = torch.nn.functional.binary_cross_entropy_with_logits

        def obj(x):
            z = Z @ x
            box = D.Uniform(-0.5 - torch.exp(x[:5]), 0.5 + torch.exp(x[5:10]),
                            validate_args=False)
            return (-bce(z, yb, weight=weight, reduction="sum") - 20.0 * bce(0.5 * z, yb)
                    - 0.1 * torch.sum(bce(z, yb, reduction="none")) + box.log_prob(u).sum()
                    + 0.1 * torch.sum(x.clone() * Z[0]) - 0.5 * torch.sum(x * x))
    else:
        raise AssertionError(kind)
    return obj, None, scale * rng.standard_normal((OBJECTIVE_LANES, n))


def dists_fleets(device):
    """Phase 34's full-width fleets: {name: (objective, starts, tol)}."""
    out = {}
    for name, (dtype, tol, *_) in DISTS_FLEETS.items():
        data = dists_data(name)
        out[name] = (dists_objective(name, data, dtype, device),
                     torch.tensor(data["starts"], dtype=dtype, device=device), tol)
    return out


def dists_objectives(qt, device):
    """Phase 34's objectives, traced (`traced_group`)."""
    return traced_group(qt, device, DISTS_PARITY, dists_case, dists_fleets, phase="34",
                        tag="dists", jax=DISTS_FLEETS, needs=dists_needs, chaotic=())


def dists_needs(name, n, itemsize, trace):
    """`objective_ops` of phase 34's fleet ``name``: what the function needs
    per value and gradient (the tolerance test n among it) and per trial (x +
    αd 2n among it), and its data bytes, as `ops_needs` counts phase 33's,
    with `graph_ops`'s costs of the functions (lgamma 1, digamma 20,
    log_ndtr 5, a log-sigmoid 5, a sigmoid 3). On m observations and p = 100
    coefficients, Xw and Xᵀu 2mp each. Negative binomial (r = exp(s)): per
    observation the logit 2, log σ(l) and log σ(-l) 10, r·, y·, lgamma(r +
    y) and the sums 6, 20 in all; the gradient σ(l) 3, y - (y + r)·σ(l) 3,
    digamma(r + y) 20 and s's terms 3, 29; the prior 3p + 2, its gradient
    2p + 1, lgamma(r) and digamma(r) 21. Probit: per observation the sign's product,
    log_ndtr and the sum, 7; the gradient φ/Φ = exp(-t²/2 - log_ndtr) / √2π
    and its sign and scale, 7; the prior 3p, its gradient 2p. The mix's
    per-draw work is its seven families' formulas, which its traced graphs
    hold with nothing repeated: its needs are their count (`graph_ops`)."""
    if name == "mix":
        return trace.ops_vag + n, trace.ops_value + 2 * n, trace.const_bytes
    m, p = LOGISTIC_OBS, LOGISTIC_N
    data = (m * p + m) * itemsize
    if name.startswith("negbin"):
        return 4 * m * p + 49 * m + 5 * p + 27 + n, 2 * m * p + 20 * m + 3 * p + 4 + 2 * n, data
    return 4 * m * p + 14 * m + 5 * p + n, 2 * m * p + 7 * m + 3 * p + 2 * n, data


# Phase 35: B3 on softmax and log-softmax, gathers and scatter_adds at constant indices,
# the factories that read only a lane value's shape (full_like, new_ones, new_full, full),
# prod / cumprod, erfinv, and per-lane values of rank 3 (bmm and the per-lane linear
# algebra over a leading batch dim) (objective_trace.py, objective_codegen.py). Three
# parity groups at OBJECTIVE_LANES lanes (`softmax_case`), then the full-width fleets,
# each drawn with numpy from a fresh generator seeded BENCH_SEED (`softmax_data`), at
# most 3000 iterations, 4096 N(0, 1) starts: softmax regression (D.Categorical(logits =
# X W), a N(0, 1) prior on W) on BASELINE config 3's widths (500 observations, 25
# features x 4 classes, n = 100), float32, tol 3e-3; a multivariate normal with unknown
# mean and Cholesky factor (D.MultivariateNormal(mu, scale_tril = diag(exp(d)) + a
# strictly lower triangle from the point), d = 6, 200 observations, n = 27; N(0, 10²) on
# mu, N(0, 1) on the factor's parameters), float64, tol MVN_TOL (at 1e-6 a lane in 16
# stalls on float64's floor; the median, ~170, is the same); and a K = 4 mixture of
# normals on 500 points with its stick-breaking twin in one objective
# (D.MixtureSameFamily(D.Categorical(logits = a), D.Normal(mu, exp(s))), weights from a
# cumprod of 1 - sigmoid(b), a D.Gumbel(m, 2) prior on both blocks' means and a
# D.InverseGamma(2, exp(c)) prior on their variances, log-sds 15·tanh(x/15), n = 25),
# float64, tol MIX_TOL (in float32 JAX converged 4086 lanes and B3 4056, the rest
# LINESEARCH_FAILURE on float32's floor, and below tol 0.1 JAX's float32 fleet is on the
# floor: 1430 lanes at 1e-2); its caps are held by phase 23's rule (`traced_parity`'s
# ``chaotic``): on a few of its lanes a last-bit difference grows a millionfold within
# five iterations, so its one-ulp starts, not the CPU's run, show what rounding alone
# moves. (name: (dtype, tol, JAX converged, median, max)); the JAX
# package's counts on the same data (`python scripts/jax_traced_softmax_reference.py`,
# its fleet engine on the CPU).
MIX_K, MIX_OBS, MIX_TOL = 4, 500, 1e-1
MVN_D, MVN_OBS, MVN_TOL = 6, 200, 1e-5
SOFTMAX_FEATURES, SOFTMAX_CLASSES = 25, 4
SOFTMAX_FLEETS = {
    "regression": (torch.float32, LOGISTIC_TOL, 4044, 9.0, 54),
    "mvn": (torch.float64, MVN_TOL, 4096, 166.0, 1725),
    "mixture": (torch.float64, MIX_TOL, 4096, 83.0, 320),
}
# The parity objectives (OBJECTIVE_LANES lanes, seed BENCH_SEED + n as in phase 22), one
# per group of ops (`softmax_case`; float32 at 3e-3, as tests/test_torch_kernels_cuda.py's
# phase-34 cases: at 1e-3 float32's floor decides lanes' statuses). (kind, n, dtypes)
SOFTMAX_PARITY = (
    ("softmax and gathers", 60, (torch.float64, torch.float32)),
    ("products and erfinv", 60, (torch.float64, torch.float32)),
    ("rank 3", 70, (torch.float64,)),
)


def softmax_data(name):
    """Phase 35's fleet ``name``: its data and its starts, float64 numpy,
    from a fresh generator seeded BENCH_SEED, in the order
    scripts/jax_traced_softmax_reference.py takes them."""
    rng = np.random.default_rng(BENCH_SEED)
    if name == "regression":
        p, k = SOFTMAX_FEATURES, SOFTMAX_CLASSES
        X = rng.standard_normal((LOGISTIC_OBS, p)) / np.sqrt(p)
        logits = X @ rng.standard_normal((p, k))
        y = np.argmax(logits + rng.gumbel(size=logits.shape), axis=1)  # categorical draws
        return {"X": X, "y": y, "starts": rng.standard_normal((OPS_BATCH, p * k))}
    if name == "mvn":
        d = MVN_D
        L = np.diag(np.exp(0.3 * rng.standard_normal(d))) + np.tril(
            0.5 * rng.standard_normal((d, d)), -1)
        V = rng.standard_normal(d) + rng.standard_normal((MVN_OBS, d)) @ L.T
        return {"V": V, "starts": rng.standard_normal((OPS_BATCH, 2 * d + d * (d - 1) // 2))}
    weights, means, sds = [0.4, 0.3, 0.2, 0.1], [-2.5, -0.5, 1.0, 3.0], [0.5, 0.7, 0.4, 0.8]
    comp = rng.choice(MIX_K, size=MIX_OBS, p=weights)
    v = np.asarray(means)[comp] + np.asarray(sds)[comp] * rng.standard_normal(MIX_OBS)
    return {"v": v, "starts": rng.standard_normal((OPS_BATCH, 6 * MIX_K + 1))}


def softmax_objective(name, data, dtype, device):
    """The torch log-density of phase 35's fleet ``name`` on ``data``, its
    tensors on ``device`` in ``dtype``."""
    import torch.distributions as D

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    if name == "regression":
        X, y = t(data["X"]), torch.tensor(data["y"], device=device)
        shape = (SOFTMAX_FEATURES, SOFTMAX_CLASSES)

        def regression(th):
            return (D.Categorical(logits=X @ th.reshape(shape)).log_prob(y).sum()
                    - 0.5 * torch.sum(th * th))
        return regression
    if name == "mvn":
        d, V = MVN_D, t(data["V"])
        rows, cols = torch.tril_indices(d, d, -1, device=device)

        def mvn(th):
            mu, logd, lower = th[:d], th[d:2 * d], th[2 * d:]
            L = torch.diag_embed(torch.exp(logd)) + torch.zeros(
                (d, d), dtype=th.dtype, device=th.device).index_put((rows, cols), lower)
            return (D.MultivariateNormal(mu, scale_tril=L).log_prob(V).sum()
                    - 0.005 * torch.sum(mu * mu) - 0.5 * torch.sum(th[d:] * th[d:]))
        return mvn
    v, K = t(data["v"]), MIX_K

    def mixture(th):
        a, mu, b, nu = th[:K], th[K:2 * K], th[3 * K:4 * K - 1], th[4 * K - 1:5 * K - 1]
        # log-sds within ±15 (in float32 a far trial makes torch's InverseGamma +inf),
        # smoothly: a clamp's flat directions make B's updates rounding's choice
        s = 15.0 * torch.tanh(th[2 * K:3 * K] / 15.0)
        r = 15.0 * torch.tanh(th[5 * K - 1:6 * K - 1] / 15.0)
        m, c = th[6 * K - 1], th[6 * K]
        lp = D.MixtureSameFamily(D.Categorical(logits=a),
                                 D.Normal(mu, torch.exp(s))).log_prob(v).sum()
        u = torch.sigmoid(b)  # stick-breaking: w_k = u_k ∏_{j<k} (1 - u_j)
        one = torch.ones_like(u[:1])
        w = torch.cat([u, one]) * torch.cat([one, torch.cumprod(1.0 - u, 0)])
        lp = lp + torch.logsumexp(torch.log(w) + D.Normal(nu, torch.exp(r)).log_prob(v[:, None]),
                                  1).sum()
        for loc, logsd in ((mu, s), (nu, r)):
            lp = lp + D.Gumbel(m.expand(K), 2.0).log_prob(loc).sum()
            lp = lp + (D.InverseGamma(2.0, torch.exp(c)).log_prob(torch.exp(2.0 * logsd))
                       + 2.0 * logsd).sum()
        return lp - 0.5 * (torch.sum(a * a) + torch.sum(b * b) + m * m + c * c)
    return mixture


def softmax_case(kind, n, dtype, device):
    """(objective, None, numpy starts) of phase 35's parity case ``kind`` at
    width n, its data drawn with numpy from seed BENCH_SEED + n."""
    import torch.distributions as D

    rng = np.random.default_rng(BENCH_SEED + n)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    def index(a):
        return torch.tensor(a, dtype=torch.int64, device=device)

    scale = 1.0
    if kind == "softmax and gathers":  # n = 60: W 6 x 10 on 30 observations
        A, C = t(rng.standard_normal((30, 6)) / np.sqrt(6)), t(rng.standard_normal((30, 10)))
        y, rows = index(rng.integers(0, 10, 30)), index(rng.integers(0, 30, (3, 10)))
        cls, y5 = index(rng.integers(0, 10, n // 3)), index(rng.integers(0, 4, 5))

        def obj(x):
            Z = A @ x.reshape(6, 10)
            lp = torch.log_softmax(Z, 1).gather(1, y[:, None]).sum()  # a gather along dim 1
            lp = lp + 0.3 * torch.sum(torch.softmax(Z, 0) * C)  # softmax along dim 0
            lp = lp + 0.2 * torch.sum(torch.gather(Z, 0, rows))  # a gather along dim 0
            lp = lp + D.Categorical(logits=Z[:5, :4]).log_prob(y5).sum()
            spread = torch.zeros(10, dtype=x.dtype, device=x.device).scatter_add(
                0, cls, x[:n // 3])  # repeated destinations, in index order
            lp = lp - 0.1 * torch.sum(spread * spread)
            lp = lp - 0.05 * torch.sum((x - torch.full_like(x, 0.5)) ** 2 * x.new_ones(n))
            lp = lp + 0.1 * torch.sum(x.new_full((n,), 2.0) * torch.tanh(x)) \
                - 0.1 * torch.sum(torch.full((n,), 0.3, dtype=x.dtype, device=x.device) * x)
            return lp - 0.5 * torch.sum(x * x)
    elif kind == "products and erfinv":  # n = 60
        c = t(0.5 * rng.standard_normal(n))

        def obj(x):
            M = x.reshape(6, 10)
            lp = 0.2 * torch.log(torch.prod(1.0 + 0.1 * x[:10] * x[:10]))
            lp = lp + 0.1 * torch.sum(torch.log(torch.prod(1.5 + torch.tanh(M), 1)))
            lp = lp + 0.1 * torch.sum(torch.log(torch.prod(1.5 + torch.tanh(M), 0, keepdim=True)))
            lp = lp - 0.05 * torch.sum(torch.cumprod(1.0 + 0.1 * torch.tanh(M), 1))
            lp = lp - 0.05 * torch.sum(torch.cumprod(1.0 + 0.1 * torch.tanh(M.T), 1))
            e = torch.erfinv(0.9 * torch.tanh(x - c))
            return lp - 0.1 * torch.sum(e * e) - 0.5 * torch.sum(x * x)
    elif kind == "rank 3":  # n = 70, two warps: a batch of two of each
        B = t(rng.standard_normal((2, 6, 3)) / np.sqrt(6))
        G = rng.standard_normal((2, 4, 4))
        K0, yb = t(G @ G.transpose(0, 2, 1) / 4 + np.eye(4)), t(rng.standard_normal((2, 4, 1)))

        def obj(x):
            T = x[:48].reshape(2, 4, 6)
            P = torch.bmm(T, B)
            lp = -0.1 * torch.sum(P * P) + 0.1 * torch.sum(torch.logsumexp(T, 1))
            lp = lp - 0.05 * torch.sum(torch.sum(T, 0) ** 2) + 0.1 * torch.sum(torch.amax(T, 2)) \
                - 0.05 * torch.sum(torch.mean(T, (0, 2)) ** 2) \
                - 0.02 * torch.sum(torch.cumsum(T, 2) ** 2) \
                + 0.1 * torch.sum(torch.tril(T[:, :, :4]) * torch.triu(T[:, :, 2:]))
            K = K0 + 0.1 * torch.diag_embed(torch.exp(x[48:56].reshape(2, 4)))
            L = torch.linalg.cholesky(K)
            a = torch.linalg.solve_triangular(L, yb * (1.0 + 0.1 * x[56:64].reshape(2, 4, 1)),
                                              upper=False)
            lp = lp - 0.5 * torch.sum(a * a) - torch.sum(torch.log(torch.diagonal(L, 0, 1, 2)))
            shift = 0.1 * x[64:68].reshape(2, 2)
            lp = lp - 0.1 * torch.sum(torch.linalg.slogdet(K)[1]) \
                + 0.05 * torch.sum(torch.linalg.solve(K, yb[..., 0] + torch.cat([shift, shift], 1))
                                   ** 2)
            return lp - 0.5 * torch.sum(x * x)
        scale = 0.5
    else:
        raise AssertionError(kind)
    return obj, None, scale * rng.standard_normal((OBJECTIVE_LANES, n))


def softmax_fleets(device):
    """Phase 35's full-width fleets: {name: (objective, starts, tol)}."""
    out = {}
    for name, (dtype, tol, *_) in SOFTMAX_FLEETS.items():
        data = softmax_data(name)
        out[name] = (softmax_objective(name, data, dtype, device),
                     torch.tensor(data["starts"], dtype=dtype, device=device), tol)
    return out


def softmax_objectives(qt, device):
    """Phase 35's objectives, traced (`traced_group`)."""
    return traced_group(qt, device, SOFTMAX_PARITY, softmax_case, softmax_fleets, phase="35",
                        tag="softmax", jax=SOFTMAX_FLEETS, needs=softmax_needs,
                        chaotic=("mixture",), f32_tol=3e-3)


def softmax_needs(name, n, itemsize, trace):
    """`objective_ops` of phase 35's fleet ``name``: what the function needs
    per value and gradient (the tolerance test n among it) and per trial (x +
    αd 2n among it), and its data bytes, as `dists_needs` counts phase 34's.
    Softmax regression, m observations, p features, k classes: X W 2mpk, per
    logit the shift by the max, exp and the sum 3mk, per observation the log,
    the max and the picked logit's difference 3m; the gradient softmax minus
    the one-hot 2mk, Xᵀ G 2mpk; the prior 3pk, its gradient 2pk. The
    multivariate normal (d, m observations): L from the point d (the exps
    of its diagonal; the lower triangle is the point's entries, placed),
    the solve L⁻¹(v - mu) md² + md, the squares and sums 2md, log diag L
    2d, 4 scalars; the gradient: the second solve L⁻ᵀ md², the sum over
    observations of the outer products on L's lower triangle, the d(d +
    1)/2 parameters', md(d + 1), Σ over observations for mu md, diag 2d;
    the priors 3n, their gradient 2n. The mixture (K components, m
    observations, two mixtures): per observation and mixture, each
    component's log-density (v - mu)·(1/σ), its square, ·-0.5 and + c_k 5,
    the logsumexp over K 4K + 2, the sum 1; its gradient the
    responsibilities (a reciprocal, K products) and their sums Σr, Σr·z,
    Σr·z² (5K); per component the log-sd's 15·tanh(x/15) 3, σ and 1/σ 2, c_k
    = log w_k - s_k - ½log 2π 2 (14K), the log-softmax 5K + 1, the
    stick-breaking weights (sigmoid 3, 1 - u, the cumprod, the product
    and its log) 7K - 5, the Gumbel prior 6 per mean (12K), the
    inverse-gamma prior 7 per variance (14K) and 3 scalars, the N(0, 1)
    priors 4K + 4; their gradients: the means' and log-sds' 6 per
    component (12K), the log-softmax's 3K, the stick-breaking's 6K, the
    Gumbel's 4 per mean (8K), the inverse-gamma's 6 per variance (12K),
    the N(0, 1) priors' 2n."""
    if name == "mixture":
        K, m = MIX_K, MIX_OBS
        trial = 2 * m * (9 * K + 3) + 56 * K + 3 + 2 * n
        return trial + 2 * m * (6 * K + 1) + 41 * K + 2 * n - n, trial, m * itemsize
    if name == "regression":
        m, p, k = LOGISTIC_OBS, SOFTMAX_FEATURES, SOFTMAX_CLASSES
        trial = 2 * m * p * k + 3 * m * k + 3 * m + 3 * p * k + 2 * n
        return trial + 2 * m * k + 2 * m * p * k + 2 * p * k - n, trial, (m * p + m) * itemsize
    d, m = MVN_D, MVN_OBS
    trial = d + m * d * d + m * d + 2 * m * d + 2 * d + 4 + 3 * n + 2 * n
    return (trial + m * d * d + m * d * (d + 1) + m * d + 2 * d + 2 * n - n, trial,
            m * d * itemsize)


# erfinv's grids: (dtype, the largest |y|) where the card's erfinv (CUDA's, which B3's
# generated objective calls as torch's CUDA kernel does) is held to torch's on the CPU
ERFINV_EDGES = ((torch.float64, 0.99), (torch.float64, 1.0 - 1e-6), (torch.float32, 0.99),
                (torch.float32, 1.0 - 1e-6))


def erfinv_spread(device):
    """How far torch's erfinv on the card and on the CPU part, value and
    derivative (√π/2·exp(erfinv(y)²)), over 200001 points of [-edge, edge]
    for each of ERFINV_EDGES: {(dtype, edge): (max relative difference of
    the value, of the derivative)}. A measurement, not a gate: phase 35's
    parity groups hold B3's erfinv to the plain version's on the card."""
    out = {}
    for dtype, edge in ERFINV_EDGES:
        y = torch.linspace(-edge, edge, 200001, dtype=torch.float64).to(dtype)
        spread = []
        for fn in (torch.erfinv, lambda z: torch.func.vmap(torch.func.grad(torch.erfinv))(z)):
            cpu, card = fn(y).double(), fn(y.to(device)).double().cpu()
            spread.append(float(((card - cpu).abs() / cpu.abs().clamp_min(1e-30)).max()))
        out[(str(dtype).replace("torch.", ""), edge)] = tuple(spread)
    return out


def softmax_phase(qt, device, smi, objectives, build):
    """Phase 35: erfinv's spread between the card and the CPU
    (`erfinv_spread`), then `ops_phase` on the phase's objectives."""
    spread = erfinv_spread(device)
    log("[softmax] torch's erfinv on the card against the CPU, max relative difference of the "
        "value and the derivative: " + "; ".join(
            f"{dtype} |y| <= {edge:.6g}: {v:.3e}, {g:.3e}" for (dtype, edge), (v, g)
            in spread.items()))
    return ops_phase(qt, device, smi, objectives, build)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import quasinewtonmethods_jl_tpu_torch as qt

    # phase 34's log-densities use torch.distributions, whose validation of its
    # arguments is a data-dependent branch: neither B3's trace nor the fleet
    # engine's torch.func takes it (as a user of these models turns it off)
    torch.distributions.Distribution.set_default_validate_args(False)

    device = torch.device("cuda", 0)
    t_start, stamps = time.perf_counter(), []

    def timed(label, fn, *args):
        """``fn(*args)``, its seconds kept for the [timing] line."""
        t0 = time.perf_counter()
        out = fn(*args)
        stamps.append(f"{label} {time.perf_counter() - t0:.1f}")
        return out

    name, smi = timed("1", device_phase)
    # the kernel library builds beside the traces, phase 16's float32 starts
    # and phase 9's plain runs (processes of their own) and the plain runs
    # made ahead here, none of which launches a hand-written kernel or times
    # anything
    ahead_dir = tempfile.mkdtemp()
    ahead_file = os.path.join(ahead_dir, "phase9.pt")
    helpers = [start_helper("scalar_f32_starts"), start_helper("resident_plain_ahead", ahead_file)]
    builds = [start_build()]
    try:
        phase22 = timed("22 trace", traced_objectives, qt, device)
        phase23 = timed("23 trace", hierarchical_objectives, qt, device)
        phase33 = timed("33 trace", ops_objectives, qt, device)
        phase34 = timed("34 trace", dists_objectives, qt, device)
        phase35 = timed("35 trace", softmax_objectives, qt, device)
        sources = (phase22["sources"] + phase23["sources"] + phase33["sources"]
                   + phase34["sources"] + phase35["sources"])
        builds.append(start_build(sources))
        ahead = timed("ahead", prefetch_plain, qt, device, phase22, phase23,
                      (phase33, phase34, phase35), helpers + builds)
        log(f"[ahead] {ahead}")
        for label, handle in zip(("16 starts", "9 ahead"), helpers):
            timed(label, finish_helper, handle)
        load_ahead(ahead_file)
        libs, build_s = timed("2", build_phase, sources, builds)
    finally:
        for handle in helpers + builds:
            stop_build(handle)
        shutil.rmtree(ahead_dir, ignore_errors=True)
    split = len(phase22["sources"])
    split33 = split + len(phase23["sources"])
    split34 = split33 + len(phase33["sources"])
    split35 = split34 + len(phase34["sources"])
    max_abs_err = timed("3", kernel_phase, device)
    reset_counters(qt)
    launches, _ = timed("4", main_path_phase, qt, device)
    timed("5", parity_phase, qt, device)
    kernel_ms, plain_ms, b1_bound_ms = timed("6", timing_phase, qt, device, smi)
    blocked_err = timed("7", blocked_kernel_phase, device)
    large = timed("8", large_n_phase, qt, device)
    resident_err = timed("9", resident_parity_phase, qt, device)
    resident, b3_bounds = timed("10", resident_path_phase, qt, device)
    times = timed("11", blocked_and_resident_timing_phase, qt, device, smi, b3_bounds)
    cg = timed("12", cg_phase, qt, device, smi)
    timed("13", wolfe_phase, qt, device, smi, cg["n_fev"], cg["fold"])
    timed("14", compacted_phase, qt, device, smi)
    timed("15", repair_phase, qt)
    timed("16", scalar_phase, qt, device)
    timed("17", lbfgs_scalar_phase, qt, device)
    timed("18 fleets", lbfgs_fleet_phase, qt, device, smi)
    timed("18 ring", ring_phase, qt, device, smi)
    timed("19", vmap_phase, qt, device)
    objectives = timed("20", objective_phase, qt, device, smi)
    objectives.update(timed("21", fixture_phase, qt, device, smi))
    traced = timed("22", traced_phase, qt, device, smi, phase22, (libs[:split], build_s))
    traced.update(timed("23", hierarchical_phase, qt, device, smi, phase23,
                        (libs[split:split33], build_s)))
    auglag = timed("24", engines_phase, qt, device, smi)
    multistart = timed("25", map_backend_phase, qt, device, smi)
    sampling_rec = timed("26", sampling_phase, qt, device, smi)
    nuts_rec = timed("27", nuts_phase, qt, device, smi)
    loo_rec, evidence_handoff = timed("28", initializers_phase, qt, device, smi)
    pt_rec = timed("29", samplers_phase, qt, device, smi)
    timed("30", evidence_phase, qt, device, smi, evidence_handoff)
    del evidence_handoff
    workflow_rec = timed("31", workflow_phase, qt, device, smi)
    mesh_rec = timed("32", mesh_phase, qt, device, smi)
    ops_rec = timed("33", ops_phase, qt, device, smi, phase33, (libs[split33:split34], build_s))
    dists_rec = timed("34", ops_phase, qt, device, smi, phase34, (libs[split34:split35], build_s))
    softmax_rec = timed("35", softmax_phase, qt, device, smi, phase35, (libs[split35:], build_s))
    log(f"[timing] seconds per phase: {', '.join(stamps)}; "
        f"{time.perf_counter() - t_start:.1f} s in all on {smi}; plain runs made ahead and not "
        f"taken: {len(AHEAD)}")

    def record(name, source, replaces, launches, err, ms):
        kernel_ms, plain_ms, bound_ms, bound_by, library_ms = ms
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}

    print(json.dumps({"kernels": [
        record("fused_bfgs_update_batched", KERNEL_SOURCE, KERNEL_REPLACES, launches,
               max_abs_err, (kernel_ms, plain_ms, *b1_bound_ms, None)),
        record("fused_bfgs_update_batched[auglag]", KERNEL_SOURCE, KERNEL_REPLACES,
               auglag["launches"], auglag["err"], (kernel_ms, plain_ms, *b1_bound_ms, None)),
        record("fused_bfgs_update_batched[multistart]", KERNEL_SOURCE, KERNEL_REPLACES,
               multistart, max_abs_err, (kernel_ms, plain_ms, *b1_bound_ms, None)),
        record("fused_bfgs_update_batched[sampling]", KERNEL_SOURCE, KERNEL_REPLACES,
               *sampling_rec),
        record("fused_bfgs_update_batched[nuts]", KERNEL_SOURCE, KERNEL_REPLACES, *nuts_rec),
        record("fused_bfgs_update_batched[loo]", KERNEL_SOURCE, KERNEL_REPLACES, *loo_rec),
        record("fused_bfgs_update_batched[pt]", KERNEL_SOURCE, KERNEL_REPLACES, *pt_rec),
        record("fused_bfgs_update_batched[workflow]", KERNEL_SOURCE, KERNEL_REPLACES,
               *workflow_rec),
        record("fused_bfgs_update_batched[mesh]", KERNEL_SOURCE, KERNEL_REPLACES, *mesh_rec),
        record("blocked_matvec", BLOCKED_SOURCE, MATVEC_REPLACES, large["B2a"],
               blocked_err["B2a"], times["B2a"]),
        record("blocked_update", BLOCKED_SOURCE, UPDATE_REPLACES, large["B2b"],
               blocked_err["B2b"], times["B2b"]),
        record("resident_bfgs_solve", RESIDENT_SOURCE, RESIDENT_REPLACES, resident["B3"],
               resident_err, times["B3"]),
    ] + [
        record(f"resident_bfgs_solve[{kind}]", RESIDENT_SOURCE, RESIDENT_REPLACES, launches, err,
               ms)
        for kind, (launches, err, ms) in objectives.items()
    ] + [
        record(f"resident_bfgs_solve[{kind}]", TRACED_SOURCE, RESIDENT_REPLACES, launches, err, ms)
        for kind, (launches, err, ms) in traced.items()
    ] + [
        record(f"resident_bfgs_solve[{kind}]", LINALG_SOURCE if kind.startswith("ops:gp")
               else TRACED_SOURCE, RESIDENT_REPLACES, launches, err, ms)
        for kind, (launches, err, ms) in ops_rec.items()
    ] + [
        record(f"resident_bfgs_solve[{kind}]", TRACED_SOURCE, RESIDENT_REPLACES, launches, err, ms)
        for kind, (launches, err, ms) in dists_rec.items()
    ] + [
        record(f"resident_bfgs_solve[{kind}]", LINALG_SOURCE if kind == "softmax:mvn"
               else TRACED_SOURCE, RESIDENT_REPLACES, launches, err, ms)
        for kind, (launches, err, ms) in softmax_rec.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
