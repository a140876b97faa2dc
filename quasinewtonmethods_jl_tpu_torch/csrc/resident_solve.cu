// Whole-solve resident BFGS engine, for Hopper (sm_90a), in float and double:
// one launch runs every lane's entire solve, one thread block per lane, with
// the lane's B and vectors in shared memory from the first iteration to the
// last.
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
// Each block loops until its own lane finishes; the fleet engine's bodies
// after a lane finished are masked no-ops, so the trajectory is the same.
//
// The objective is evaluated on the card: the split Rosenbrock of
// models/rosenbrock.py with its odd-n tail term, block-cooperatively, its
// value-and-gradient as rosenbrock_value_and_grad computes it and the line
// search's trials as rosenbrock_logdensity does. Terms are summed with the
// deterministic block reduction, so repeated runs give identical results.
//
// What bounds it: per iteration a lane does O(n²) flops on B in shared
// memory and a few block reductions (each two barriers), so latency and
// shared-memory bandwidth bound it, not device memory: B crosses device
// memory once per solve, at the end. Every thread computes the per-lane
// scalars (statuses, line-search proposals) identically from the block
// reductions' totals, so control flow is uniform across the block and the
// result does not depend on the block size.
//
// This file is built with -fmad=false: each product and sum then rounds as
// the plain twin's separate tensor ops do, and only the order of the sums
// differs from it. NaN/inf are part of the contract: no --use_fast_math,
// no -ftz; nanmin/nanmax below are written as comparisons with the
// reference's semantics (prefer the non-NaN argument).

#include "bfgs_common.cuh"

namespace {

using qnm::block_sum;
using qnm::kMaxSums;
using qnm::kMaxWarps;

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

// Dynamic shared memory, in this order: B (n·n), X, G, G_old, STEP, d, and
// the update's scratch y, By, Bg, u (n each), the block reduction's per-warp
// partials (kMaxSums·kMaxWarps). ops/kernels/resident_kernel.py ::
// resident_feasible repeats this count.
size_t smem_bytes(int n, size_t itemsize) {
  return (size_t(n) * n + 9 * size_t(n) + size_t(kMaxSums) * kMaxWarps) * itemsize;
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

// rosenbrock_value_and_grad at x (shared): pairs (x[i], x[half + i]),
//   -Σ 100 r² + (1 - a)², r = b - a², and -(1 - x[n-1])² for odd n;
// writes grad (shared), published by block_sum's barriers.
template <typename T>
__device__ T rosenbrock_value_and_grad(const T* x, T* grad, int n, T* red) {
  const int half = n >> 1;
  T acc[1] = {T(0)};
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const T a = x[i];
    const T r = x[half + i] - a * a;
    const T oma = T(1) - a;
    acc[0] += T(100) * r * r + oma * oma;
    grad[i] = T(400) * r * a + T(2) * oma;
    grad[half + i] = T(-200) * r;
  }
  const T delta = T(1) - x[n - 1];
  if ((n & 1) && threadIdx.x == 0) grad[n - 1] = T(2) * delta;
  block_sum(acc, red);
  T s = -acc[0];
  if (n & 1) s = s - delta * delta;
  return s;
}

// rosenbrock_logdensity at x + alpha·d (the line search's trial point).
template <typename T>
__device__ T rosenbrock_value_along(const T* x, const T* d, T alpha, int n, T* red) {
  const int half = n >> 1;
  T acc[1] = {T(0)};
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const T a = x[i] + alpha * d[i];
    const T r = (x[half + i] + alpha * d[half + i]) - a * a;
    const T oma = T(1) - a;
    acc[0] += T(100) * (r * r) + oma * oma;
  }
  const T delta = T(1) - (x[n - 1] + alpha * d[n - 1]);
  block_sum(acc, red);
  T s = -acc[0];
  if (n & 1) s = s - delta * delta;
  return s;
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

template <typename T>
__global__ void resident_solve_kernel(const T* __restrict__ X0, T* __restrict__ X_out,
                                      T* __restrict__ G_out, T* __restrict__ G_old_out,
                                      T* __restrict__ step_out, T* __restrict__ B_out,
                                      T* __restrict__ fun_out, int* __restrict__ status_out,
                                      int* __restrict__ iterations_out,
                                      int* __restrict__ n_fev_out, int* __restrict__ n_gev_out,
                                      int* __restrict__ n_resets_out,
                                      uint8_t* __restrict__ fresh_out,
                                      int* __restrict__ stall_out, int n, Params<T> p) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t vo = size_t(b) * n;
  const int nn = n * n;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);
  T* sX = sB + size_t(n) * n;
  T* sG = sX + n;
  T* sG_old = sG + n;
  T* sS = sG_old + n;
  T* sD = sS + n;
  T* sY = sD + n;
  T* sBy = sY + n;
  T* sBg = sBy + n;
  T* sU = sBg + n;
  T* red = sU + n;

  // the fresh carry of batched_solve.py :: _fresh_bfgs_carry
  for (int idx = tid; idx < nn; idx += nt) {
    const int i = idx / n;
    sB[idx] = i == idx - i * n ? T(1) : T(0);
  }
  for (int i = tid; i < n; i += nt) {
    sX[i] = X0[vo + i];
    sG[i] = T(0);
    sG_old[i] = T(0);
    sS[i] = T(0);
  }
  __syncthreads();
  T fun = quiet_nan<T>();
  T fprev = quiet_nan<T>();
  int k = 0, status = kRunning, iterations = 0, n_fev = 0, n_gev = 0, n_resets = 0, stall = 0;
  bool fresh = true;

  while (status == kRunning && k < p.max_iterations) {
    const T f0 = rosenbrock_value_and_grad(sX, sG, n, red);
    T q[2] = {T(0), T(0)};  // entries with !(|g_i| < tol) (NaN counts), gᵀg
    for (int i = tid; i < n; i += nt) {
      const T gi = sG[i];
      q[0] += fabs(gi) < p.tol ? T(0) : T(1);
      q[1] += gi * gi;
    }
    block_sum(q, red);
    const bool improved = isnan(fprev) || f0 > fprev;
    const int stall_n = improved ? 0 : stall + 1;
    int status_pre = kRunning;  // highest priority last
    if (p.stall_limit && stall_n >= p.stall_limit) status_pre = kLinesearchFailure;
    if (q[0] == T(0)) status_pre = kConverged;
    if (!isfinite(f0)) status_pre = kNonfiniteValue;
    const bool active = status_pre == kRunning;

    T m = T(1);
    bool reset = false;
    T alpha = T(0);
    int ls_rounds = 0;
    if (active) {
      if (k == 0) {  // the peel: steepest ascent
        for (int i = tid; i < n; i += nt) sD[i] = sG[i];
        m = q[1];
        reset = true;
      } else {
        const qnm::LaneUpdate<T> upd = qnm::bfgs_update_lane<T>(
            sB, sB, sS, sG, sG_old, sY, sBy, sBg, sU, red, n, p.h0_scale && fresh, sD);
        m = upd.m;
        reset = upd.reset;
      }
      __syncthreads();  // publishes d and B; the update's reads of STEP are done

      // batched_solve.py :: _batched_linesearch for one lane
      T fx1 = rosenbrock_value_along(sX, sD, T(1), n, red);
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
        fx1 = rosenbrock_value_along(sX, sD, a2, n, red);
      }
      if (fx1 >= f0 + a2 * p.c1 * m) alpha = a2;
    }
    const bool failed = active && alpha == T(0);
    const bool take = active && !failed;
    for (int i = tid; i < n; i += nt) {
      const T step = take ? alpha * sD[i] : T(0);
      sX[i] = sX[i] + step;
      if (active) {
        sS[i] = step;
        sG_old[i] = sG[i];
      }
    }
    __syncthreads();

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

  for (int i = tid; i < n; i += nt) {
    X_out[vo + i] = sX[i];
    G_out[vo + i] = sG[i];
    G_old_out[vo + i] = sG_old[i];
    step_out[vo + i] = sS[i];
  }
  T* Bl = B_out + size_t(b) * nn;
  for (int idx = tid; idx < nn; idx += nt) Bl[idx] = sB[idx];
  if (tid == 0) {
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
int launch(const void* X0, void* X, void* G, void* G_old, void* step, void* B, void* fun,
           void* status, void* iterations, void* n_fev, void* n_gev, void* n_resets,
           void* fresh, void* stall, int batch, int n, const Params<T>& p, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const size_t smem = smem_bytes(n, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resident_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  resident_solve_kernel<T>
      <<<batch, qnm::threads_for(n), smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(X0), static_cast<T*>(X), static_cast<T*>(G),
          static_cast<T*>(G_old), static_cast<T*>(step), static_cast<T*>(B),
          static_cast<T*>(fun), static_cast<int*>(status), static_cast<int*>(iterations),
          static_cast<int*>(n_fev), static_cast<int*>(n_gev), static_cast<int*>(n_resets),
          static_cast<uint8_t*>(fresh), static_cast<int*>(stall), n, p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block of the solve asks for, in bytes.
size_t qnm_resident_smem_bytes(int n, int itemsize) { return smem_bytes(n, size_t(itemsize)); }

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
