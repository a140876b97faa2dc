// Whole-solve resident BFGS engine, for Hopper (sm_90a), in float and double:
// one launch runs every lane's entire solve, one thread block (a lane group
// of bfgs_common.cuh: one warp up to n = 64) per lane, with the lane's B and
// vectors in shared memory from the first iteration to the last.
//
// Replaces the TPU kernel quasinewtonmethods_jl_tpu/resident_solve.py ::
// _optimize_batched_resident_jit (pl.pallas_call at :465, kernel body from
// _make_kernel :123-378). Semantics are lane for lane those of the fleet
// engine batched_solve.py :: optimize_batched_fused with BackTracking
// (fold_eval=False), whose plain-update run is this kernel's plain twin
// (ops/kernels/resident_kernel.py :: optimize_batched_resident_reference).
// Per lane:
//
//   loop while status == RUNNING and k < max_iterations:
//     f0, g = value and gradient at X
//     status_pre: non-finite f0 > max|g| < tol > stall_limit non-improving
//       iterations (0 turns the stall test off) > RUNNING; active = RUNNING
//     k = 0 (the peel): d = g, m = gᵀg, reset counts 1
//     k > 0: the update algebra of bfgs_common.cuh on B in place, giving d, m
//     masked Armijo backtracking (order 2, or order 3's cubic after the first
//       round) within ls.iterations + finite_halving_limit rounds; a
//       non-finite m or f0 never enters the loop; alpha = 0 is the failure
//       sentinel, and a failed lane takes no step
//     counters iterations, n_fev, n_gev, n_resets, fresh and stall as the
//       fleet engine's _body
//   a lane still RUNNING at the cap ends MAX_ITERATIONS.
// Each block loops until its own lane finishes, and the SM's scheduler
// gives a finished lane's slot to the next block at once; the fleet
// engine's bodies after a lane finished are masked no-ops, so the
// trajectory is the same.
//
// The objective is evaluated on the card: the split Rosenbrock of
// models/rosenbrock.py with its odd-n tail term, its value-and-gradient as
// rosenbrock_value_and_grad computes it and the line search's trials as
// rosenbrock_logdensity does. Terms are summed by the lane group's
// deterministic sums, so repeated runs give identical results.
//
// What bounds it: per iteration a lane does ~12 n² flops on B in shared
// memory (the matvecs and the update) and a few lane sums, so the issue
// rate of its instructions and their latency bound it, not device memory:
// B crosses device memory once per solve, at the end. The design cuts what
// the lane waits on. At n <= 64 a lane is one warp, so its sums are five
// shuffles each and it never waits at a __syncthreads; the top of an
// iteration takes the objective, the status test's sums and the update's
// first sums in one lane sum; B is read and written once per iteration: the
// rank-2 change that iteration k - 1 decided is applied in the same pass
// over B that takes iteration k's matvecs (each element rounds as before;
// the last change is applied after the loop). The passes go in batches of
// rows with every load issued before the batch's stores. Small blocks (32
// threads, B and seven vectors in shared memory) let 13 lanes share an SM
// at n = 60 in float, against 4 blocks of 128 threads before. Every thread
// computes the per-lane scalars (statuses, line-search proposals)
// identically from the sums' totals, so control flow is uniform across the
// lane.
//
// This file is built with -fmad=false: each product and sum then rounds as
// the plain twin's separate tensor ops do, and only the order of the sums
// differs from it. NaN/inf are part of the contract: no --use_fast_math,
// no -ftz; nanmin/nanmax below are written as comparisons with the
// reference's semantics (prefer the non-NaN argument).

#include "bfgs_common.cuh"

namespace {

using qnm::kRedValues;
using qnm::LaneGroup;

// state.py :: Status
constexpr int kRunning = 0;
constexpr int kConverged = 1;
constexpr int kMaxIterations = 2;
constexpr int kLinesearchFailure = 3;
constexpr int kNonfiniteValue = 4;

template <typename T>
struct Params {
  T tol, c1, rho_hi, rho_lo, eps, sqrttol;
  int budget;  // line-search rounds: ls.iterations + finite_halving_limit
  int max_iterations, stall_limit, order, h0_scale;
};

// Dynamic shared memory a block asks for. The lane uses B (n·n), G, d, y,
// STEP and u twice (n each), then the reduction scratch (kRedValues):
// n² + 7n + kRedValues values. The count keeps the n² + 9n +
// kRedValues of the earlier block-per-lane layout, so that
// ops/kernels/resident_kernel.py :: resident_feasible, which repeats it,
// admits exactly the n it did (n <= 236 in float, <= 165 in double); at
// n = 60 in float the slack costs no block per SM (13 either way).
size_t smem_bytes(int n, size_t itemsize) {
  return (size_t(n) * n + 9 * size_t(n) + size_t(kRedValues)) * itemsize;
}

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// utils/scalars.py: a < b ? a : (isnan(b) ? a : b) and a < b ? b : (isnan(a) ? b : a)
template <typename T>
__device__ __forceinline__ T nanmin(T a, T b) {
  return a < b ? a : (isnan(b) ? a : b);
}
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  return a < b ? b : (isnan(a) ? b : a);
}

// ops/linesearch.py :: _cubic_proposal
template <typename T>
__device__ T cubic_proposal(T m, T a1, T a2, T fx0, T fx1, T f0, T eps, T sqrttol) {
  const T denom = T(1) / (a1 * a1 * a2 * a2 * (a2 - a1));
  const T r1 = fx1 - f0 - m * a2;
  const T r0 = fx0 - f0 - m * a1;
  const T a = (a1 * a1 * r1 - a2 * a2 * r0) * denom;
  const T b = (-a1 * a1 * a1 * r1 + a2 * a2 * a2 * r0) * denom;
  const bool degenerate = fabs(a) <= eps + sqrttol * fabs(a);
  const T disc = nanmax(b * b - T(3) * a * m, T(0));
  const T root = (sqrt(disc) + b) / (T(-3) * a);
  return degenerate ? m / (T(2) * b) : root;
}

// The vector entries a thread owns: the Rosenbrock pair (i, half + i) for
// i = threadIdx.x < n/2, and thread 0 also the odd-n tail n - 1 (n/2 never
// exceeds the lane's threads, so a thread owns at most one pair). X, G,
// G_old, STEP and d of those entries live in the owner's registers; G,
// STEP, y and d also go to shared memory where the matvecs and the update
// read them.
constexpr int kOwned = 3;

struct Owned {
  int idx[kOwned];
  bool has[kOwned];
  __device__ __forceinline__ explicit Owned(int n) {
    const int half = n >> 1;
    const int t = threadIdx.x;
    has[0] = has[1] = t < half;
    idx[0] = t;
    idx[1] = half + t;
    has[2] = (n & 1) && t == 0;
    idx[2] = n - 1;
  }
};

template <typename T, bool kOneWarp>
__global__ void __launch_bounds__(qnm::kMaxLaneWarps * 32)
    resident_solve_kernel(const T* __restrict__ X0, T* __restrict__ X_out,
                          T* __restrict__ G_out, T* __restrict__ G_old_out,
                          T* __restrict__ step_out, T* __restrict__ B_out,
                          T* __restrict__ fun_out, int* __restrict__ status_out,
                          int* __restrict__ iterations_out, int* __restrict__ n_fev_out,
                          int* __restrict__ n_gev_out, int* __restrict__ n_resets_out,
                          uint8_t* __restrict__ fresh_out, int* __restrict__ stall_out, int n,
                          Params<T> p) {
  const int b = blockIdx.x;
  const size_t vo = size_t(b) * n;
  const bool odd = n & 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);
  T* sG = sB + size_t(n) * n;
  T* sD = sG + n;
  T* sY = sD + n;
  // STEP and u in two buffers each, by the parity of k: the change of B
  // that iteration k decides uses the step of iteration k - 1 and its u,
  // and stays pending until the pass over B of iteration k + 1.
  // (Picked by a select, not from an array of pointers, so that the
  // compiler still knows them for shared memory.)
  T* const sS0 = sY + n;
  T* const sS1 = sY + 2 * n;
  T* const sU0 = sY + 3 * n;
  T* const sU1 = sY + 4 * n;
  LaneGroup<T, kOneWarp> grp{sY + 5 * n};
  const qnm::Columns cols(n);
  const Owned own(n);

  // the fresh carry of batched_solve.py :: _fresh_bfgs_carry; B = I by columns
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (!cols.own[c]) continue;
    for (int r = 0; r < n; ++r) sB[r * n + cols.j[c]] = r == cols.j[c] ? T(1) : T(0);
  }
  T x[kOwned], g[kOwned], g_old[kOwned], st[kOwned], d[kOwned];
#pragma unroll
  for (int e = 0; e < kOwned; ++e) {
    x[e] = own.has[e] ? X0[vo + own.idx[e]] : T(0);
    g[e] = g_old[e] = st[e] = d[e] = T(0);
  }
  qnm::Change<T> pending;  // B's change not yet applied
  pending.s = pending.u = sB;
  T fun = quiet_nan<T>();
  T fprev = quiet_nan<T>();
  int k = 0, status = kRunning, iterations = 0, n_fev = 0, n_gev = 0, n_resets = 0, stall = 0;
  bool fresh = true;

  // rosenbrock_logdensity at x + alpha·d (the line search's trial point)
  auto value_along = [&](T alpha) {
    T v[2] = {T(0), T(0)};  // the pairs' terms, the tail's
    if (own.has[0]) {
      const T a = x[0] + alpha * d[0];
      const T r = (x[1] + alpha * d[1]) - a * a;
      const T oma = T(1) - a;
      v[0] = T(100) * (r * r) + oma * oma;
    }
    if (own.has[2]) {
      const T delta = T(1) - (x[2] + alpha * d[2]);
      v[1] = delta * delta;
    }
    grp.sum(v);
    T f = -v[0];
    if (odd) f = f - v[1];
    return f;
  };

  while (status == kRunning && k < p.max_iterations) {
    // rosenbrock_value_and_grad at X: -Σ 100 r² + (1 - a)², r = b - a², and
    // -(1 - x[n-1])² for odd n; fused with the status test's sums and the
    // update's first ones into one lane sum. Only thread 0 adds the tail's
    // square, so its sum is exact.
    T q[7] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
    // Σ terms, #entries with !(|g_i| < tol) (NaN counts), gᵀg, sᵀy, yᵀy, sᵀg, tail²
    if (own.has[0]) {
      const T a = x[0];
      const T r = x[1] - a * a;
      const T oma = T(1) - a;
      q[0] = T(100) * r * r + oma * oma;
      g[0] = T(400) * r * a + T(2) * oma;
      g[1] = T(-200) * r;
    }
    if (own.has[2]) {
      const T delta = T(1) - x[2];
      q[6] = delta * delta;
      g[2] = T(2) * delta;
    }
#pragma unroll
    for (int e = 0; e < kOwned; ++e) {
      if (!own.has[e]) continue;
      const T gi = g[e];
      const T yi = g_old[e] - gi;
      sG[own.idx[e]] = gi;
      sY[own.idx[e]] = yi;
      q[1] += fabs(gi) < p.tol ? T(0) : T(1);
      q[2] += gi * gi;
      q[3] += st[e] * yi;
      q[4] += yi * yi;
      q[5] += st[e] * gi;
    }
    grp.sum(q);  // also publishes G and y
    T f0 = -q[0];
    if (odd) f0 = f0 - q[6];
    const bool improved = isnan(fprev) || f0 > fprev;
    const int stall_n = improved ? 0 : stall + 1;
    int status_pre = kRunning;  // highest priority last
    if (p.stall_limit && stall_n >= p.stall_limit) status_pre = kLinesearchFailure;
    if (q[1] == T(0)) status_pre = kConverged;
    if (!isfinite(f0)) status_pre = kNonfiniteValue;
    const bool active = status_pre == kRunning;

    T m = T(1);
    bool reset = false;
    T alpha = T(0);
    int ls_rounds = 0;
    if (active) {
      if (k == 0) {  // the peel: steepest ascent
#pragma unroll
        for (int e = 0; e < kOwned; ++e) d[e] = g[e];
        m = q[2];
        reset = true;
      } else {
        // one pass over B: the pending change, then Bᵀy and Bᵀg
        T By[2], Bg[2];
        qnm::column_pass<T, true>(sB, n, cols, pending, sY, sG, By, Bg);
        const qnm::LaneUpdate<T> upd = qnm::update_algebra(
            grp, cols, By, Bg, (k & 1) ? sS0 : sS1, sG, sY, (k & 1) ? sU1 : sU0, q[3], q[4],
            q[5], q[2], p.h0_scale && fresh, sD);
        m = upd.m;
        reset = upd.reset;
        pending = upd.b;
        grp.sync();  // publishes d
#pragma unroll
        for (int e = 0; e < kOwned; ++e) d[e] = own.has[e] ? sD[own.idx[e]] : T(0);
      }

      // batched_solve.py :: _batched_linesearch for one lane
      T fx1 = value_along(T(1));
      const bool doomed = !(isfinite(m) && isfinite(f0));
      T a1 = T(1), a2 = T(1), fx0 = f0;
      while (!doomed && !(fx1 >= f0 + a2 * p.c1 * m) && ls_rounds < p.budget) {
        ++ls_rounds;
        T at = -(m * a2 * a2) / (T(2) * (fx1 - f0 - m * a2));
        if (p.order == 3 && ls_rounds != 1) {
          at = cubic_proposal(m, a1, a2, fx0, fx1, f0, p.eps, p.sqrttol);
        }
        at = nanmin(at, a2 * p.rho_hi);
        a1 = a2;
        a2 = nanmax(at, a2 * p.rho_lo);
        fx0 = fx1;
        fx1 = value_along(a2);
      }
      if (fx1 >= f0 + a2 * p.c1 * m) alpha = a2;
    }
    const bool failed = active && alpha == T(0);
    const bool take = active && !failed;
    // The next iteration's first lane sum publishes STEP before the update
    // reads it; STEP's buffer of this parity was last read by the pass over
    // B at the top of this iteration.
#pragma unroll
    for (int e = 0; e < kOwned; ++e) {
      if (!own.has[e]) continue;
      const T step = take ? alpha * d[e] : T(0);
      x[e] = x[e] + step;
      if (active) {
        st[e] = step;
        ((k & 1) ? sS1 : sS0)[own.idx[e]] = step;
        g_old[e] = g[e];
      }
    }

    fun = f0;
    fprev = f0;
    status = failed ? kLinesearchFailure : status_pre;
    iterations += active ? 1 : 0;
    n_fev += 1 + (active ? 1 + ls_rounds : 0);
    n_gev += 1;
    n_resets += reset ? 1 : 0;
    if (active) fresh = reset;
    stall = stall_n;
    ++k;
  }

#pragma unroll
  for (int e = 0; e < kOwned; ++e) {
    if (!own.has[e]) continue;
    const size_t i = vo + own.idx[e];
    X_out[i] = x[e];
    G_out[i] = g[e];
    G_old_out[i] = g_old[e];
    step_out[i] = st[e];
  }
  {  // the last change of B
    T By[2], Bg[2];
    qnm::column_pass<T, false>(sB, n, cols, pending, sY, sG, By, Bg);
  }
  T* Bl = B_out + size_t(b) * n * n;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (!cols.own[c]) continue;
    for (int r = 0; r < n; ++r) Bl[r * n + cols.j[c]] = sB[r * n + cols.j[c]];
  }
  if (threadIdx.x == 0) {
    fun_out[b] = fun;
    status_out[b] = status == kRunning ? kMaxIterations : status;
    iterations_out[b] = iterations;
    n_fev_out[b] = n_fev;
    n_gev_out[b] = n_gev;
    n_resets_out[b] = n_resets;
    fresh_out[b] = fresh ? 1 : 0;
    stall_out[b] = stall;
  }
}

template <typename T>
auto launch_for(int n) {
  return qnm::lane_launch(n, &resident_solve_kernel<T, true>, &resident_solve_kernel<T, false>,
                          smem_bytes(n, sizeof(T)));
}

template <typename T>
int launch(const void* X0, void* X, void* G, void* G_old, void* step, void* B, void* fun,
           void* status, void* iterations, void* n_fev, void* n_gev, void* n_resets,
           void* fresh, void* stall, int batch, int n, const Params<T>& p, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const auto l = launch_for<T>(n);
  if (l.err != cudaSuccess) return int(l.err);
  l.kernel<<<batch, l.threads, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X0), static_cast<T*>(X), static_cast<T*>(G),
      static_cast<T*>(G_old), static_cast<T*>(step), static_cast<T*>(B), static_cast<T*>(fun),
      static_cast<int*>(status), static_cast<int*>(iterations), static_cast<int*>(n_fev),
      static_cast<int*>(n_gev), static_cast<int*>(n_resets), static_cast<uint8_t*>(fresh),
      static_cast<int*>(stall), n, p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block of the solve asks for, in bytes.
size_t qnm_resident_smem_bytes(int n, int itemsize) { return smem_bytes(n, size_t(itemsize)); }

// The solve's launch at n: registers per thread, threads per block and
// blocks per SM (the occupancy calculator's, with the attributes a launch
// sets). Returns a CUDA error code (0 = success).
int qnm_resident_occupancy(int n, int itemsize, int* regs, int* threads, int* blocks_per_sm) {
  return itemsize == 4 ? qnm::lane_occupancy(launch_for<float>(n), regs, threads, blocks_per_sm)
                       : qnm::lane_occupancy(launch_for<double>(n), regs, threads, blocks_per_sm);
}

// Both return cudaGetLastError() after the launch (0 = launched).
int qnm_resident_solve_f32(const void* X0, void* X, void* G, void* G_old, void* step, void* B,
                           void* fun, void* status, void* iterations, void* n_fev,
                           void* n_gev, void* n_resets, void* fresh, void* stall, int batch,
                           int n, float tol, float c1, float rho_hi, float rho_lo, float eps,
                           float sqrttol, int budget, int max_iterations, int stall_limit,
                           int order, int h0_scale, void* stream) {
  const Params<float> p{tol, c1, rho_hi, rho_lo, eps, sqrttol,
                        budget, max_iterations, stall_limit, order, h0_scale};
  return launch<float>(X0, X, G, G_old, step, B, fun, status, iterations, n_fev, n_gev,
                       n_resets, fresh, stall, batch, n, p, stream);
}

int qnm_resident_solve_f64(const void* X0, void* X, void* G, void* G_old, void* step, void* B,
                           void* fun, void* status, void* iterations, void* n_fev,
                           void* n_gev, void* n_resets, void* fresh, void* stall, int batch,
                           int n, double tol, double c1, double rho_hi, double rho_lo,
                           double eps, double sqrttol, int budget, int max_iterations,
                           int stall_limit, int order, int h0_scale, void* stream) {
  const Params<double> p{tol, c1, rho_hi, rho_lo, eps, sqrttol,
                         budget, max_iterations, stall_limit, order, h0_scale};
  return launch<double>(X0, X, G, G_old, step, B, fun, status, iterations, n_fev, n_gev,
                        n_resets, fresh, stall, batch, n, p, stream);
}

}  // extern "C"
