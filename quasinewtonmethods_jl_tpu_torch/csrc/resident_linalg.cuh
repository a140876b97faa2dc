// Dense linear algebra on one lane's matrix, for the objectives that
// ops/kernels/objective_codegen.py generates into B3 (resident_solve.cuh):
// the Cholesky factorization, the triangular solve, and LU with partial
// pivoting for slogdet and solve, in float and double. The matrix (m x m)
// and the right-hand sides (m x k) lie row-major in the lane's shared
// scratch, where the generated code has copied them; each function runs on
// every thread of the lane group (bfgs_common.cuh: one warp up to n = 64),
// which split its work by column, with the group's barrier between steps,
// and ends on a barrier. JAX's resident kernel lowers jnp.linalg's
// cholesky, solve_triangular, slogdet and solve inside its body
// (quasinewtonmethods_jl_tpu/resident_solve.py :: _make_kernel); these are
// the port's, written by hand: no library call.
//
// A failed factorization gives NaN in every element of its result, on its
// lane only: a Cholesky pivot that is not > 0 (LAPACK's potrf info != 0,
// where JAX's cholesky returns NaN) or an LU pivot of 0. Every thread takes
// the same branch (the pivots are read from shared memory after a barrier,
// or reduced by butterflies that give every thread the same result), so
// the barriers stay uniform. Built like the rest of B3 (-fmad=false, no fast
// math): each product and difference rounds on its own; only the order of
// the sums differs from LAPACK's.

#pragma once

#include "bfgs_common.cuh"
#include "resident_objectives.cuh"  // log_of

namespace qnm {

template <typename T>
__device__ __forceinline__ T lane_nan();
template <>
__device__ __forceinline__ float lane_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double lane_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename Grp, typename T>
__device__ __forceinline__ void lane_fill_nan(Grp& grp, int count, T* __restrict__ x) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) x[e] = lane_nan<T>();
  grp.sync();
}

// L (m x m) holds A's lower triangle and zeros above it; on return its lower
// Cholesky factor (right-looking: per column j the diagonal's square root,
// the column below it scaled, then the rank-1 update of the trailing lower
// block, one column of it per thread), or NaN everywhere if a pivot is not
// > 0.
template <typename Grp, typename T>
__device__ void lane_cholesky(Grp& grp, int m, T* __restrict__ L) {
  const int t = threadIdx.x, threads = blockDim.x;
  for (int j = 0; j < m; ++j) {
    const T d = L[j * m + j];
    if (!(d > T(0))) {  // the same value on every thread: a uniform exit
      grp.sync();       // every thread has read d before the NaNs are written
      lane_fill_nan(grp, m * m, L);
      return;
    }
    const T r = sqrt(d);
    for (int i = j + 1 + t; i < m; i += threads) L[i * m + j] = L[i * m + j] / r;
    grp.sync();  // the column, and every thread's read of d
    if (t == 0) L[j * m + j] = r;
    for (int c = j + 1 + t; c < m; c += threads) {
      const T lc = L[c * m + j];
      for (int i = c; i < m; ++i) L[i * m + c] = L[i * m + c] - L[i * m + j] * lc;
    }
    grp.sync();
  }
}

// X (m x k) holds B; on return A⁻¹ B, A lower (kUpper false) or upper
// triangular, its element (i, j) at a[i * as0 + j * as1] (a view: a
// transposed factor is read in place), kUnit: a unit diagonal. One
// right-hand side per thread, substituted row by row.
template <bool kUpper, bool kUnit, typename Grp, typename T>
__device__ void lane_trsm(Grp& grp, int m, int k, const T* __restrict__ a, int as0, int as1,
                          T* __restrict__ X) {
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    for (int r = 0; r < m; ++r) {
      const int i = kUpper ? m - 1 - r : r;
      T acc = X[i * k + c];
      if (kUpper) {
        for (int j = i + 1; j < m; ++j) acc = acc - a[i * as0 + j * as1] * X[j * k + c];
      } else {
        for (int j = 0; j < i; ++j) acc = acc - a[i * as0 + j * as1] * X[j * k + c];
      }
      X[i * k + c] = kUnit ? acc : acc / a[i * as0 + i * as1];
    }
  }
  grp.sync();
}

// The pivot of column j: the row r >= j with the largest |W[r][j]|, the
// first of equal ones (LAPACK's idamax), and its |value|; a NaN is never
// taken (row m where every candidate is NaN). Each warp reduces all the
// candidates by butterflies, so every thread of the lane gets the same row.
template <typename T>
__device__ __forceinline__ int lane_pivot(const T* __restrict__ W, int m, int j, T& size) {
  T best = T(-1);
  int row = m;
  for (int r = j + (threadIdx.x & 31); r < m; r += 32) {
    const T v = fabs(W[r * m + j]);
    if (v > best) {
      best = v;
      row = r;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T other = __shfl_xor_sync(0xffffffffu, best, off);
    const int other_row = __shfl_xor_sync(0xffffffffu, row, off);
    if (other > best || (other == best && other_row < row)) {
      best = other;
      row = other_row;
    }
  }
  size = best;
  return row;
}

// Gaussian elimination with partial pivoting of W (m x m, a work copy of A):
// on return its unit-lower L below the diagonal and U on and above it
// (P A = L U), with the same row swaps and eliminations applied to X (m x
// k), which then holds L⁻¹ P B. Returns false at a pivot of 0 (W and X then
// partly eliminated); `swaps` counts the row swaps.
template <typename Grp, typename T>
__device__ bool lane_lu(Grp& grp, int m, T* __restrict__ W, int k, T* __restrict__ X,
                        int& swaps) {
  const int t = threadIdx.x, threads = blockDim.x;
  swaps = 0;
  for (int j = 0; j < m; ++j) {
    T size;
    const int p = lane_pivot(W, m, j, size);
    // every warp has read column j before any thread swaps or scales it (a
    // lane of two warps searches it twice)
    grp.sync();
    if (!(size > T(0))) return false;  // the same on every thread
    if (p != j) {
      ++swaps;
      for (int c = t; c < m; c += threads) {
        const T w = W[j * m + c];
        W[j * m + c] = W[p * m + c];
        W[p * m + c] = w;
      }
      for (int c = t; c < k; c += threads) {
        const T x = X[j * k + c];
        X[j * k + c] = X[p * k + c];
        X[p * k + c] = x;
      }
      grp.sync();
    }
    const T d = W[j * m + j];
    for (int i = j + 1 + t; i < m; i += threads) W[i * m + j] = W[i * m + j] / d;
    grp.sync();
    for (int c = j + 1 + t; c < m; c += threads) {
      const T u = W[j * m + c];
      for (int i = j + 1; i < m; ++i) W[i * m + c] = W[i * m + c] - W[i * m + j] * u;
    }
    for (int c = t; c < k; c += threads) {
      const T u = X[j * k + c];
      for (int i = j + 1; i < m; ++i) X[i * k + c] = X[i * k + c] - W[i * m + j] * u;
    }
    grp.sync();
  }
  return true;
}

// out[0] = the sign of det A, out[1] = log|det A| (torch's slogdet), W a
// work copy of A; NaN in both at a pivot of 0.
template <typename Grp, typename T>
__device__ void lane_slogdet(Grp& grp, int m, T* __restrict__ W, T* __restrict__ out) {
  int swaps;
  if (!lane_lu(grp, m, W, 0, static_cast<T*>(nullptr), swaps)) {
    grp.sync();
    lane_fill_nan(grp, 2, out);
    return;
  }
  if (threadIdx.x == 0) {
    T sign = (swaps & 1) ? T(-1) : T(1);
    T logabs = T(0);
    for (int j = 0; j < m; ++j) {
      const T u = W[j * m + j];
      sign = u < T(0) ? -sign : sign;
      logabs = logabs + log_of(fabs(u));
    }
    out[0] = sign;
    out[1] = logabs;
  }
  grp.sync();
}

// X (m x k) holds B; on return A⁻¹ B (LU with partial pivoting of W, a work
// copy of A, then back substitution, one right-hand side per thread); NaN
// everywhere at a pivot of 0.
template <typename Grp, typename T>
__device__ void lane_solve(Grp& grp, int m, int k, T* __restrict__ W, T* __restrict__ X) {
  int swaps;
  if (!lane_lu(grp, m, W, k, X, swaps)) {
    grp.sync();
    lane_fill_nan(grp, m * k, X);
    return;
  }
  lane_trsm<true, false>(grp, m, k, W, m, 1, X);
}

}  // namespace qnm
