// Device code shared by the port's kernels: the deterministic block
// reduction, the block-size rule, and the per-lane inverse-BFGS update
// algebra. The fused update B1 (bfgs_update.cu) runs the algebra once per
// call, on B staged from device memory; the resident solver B3
// (resident_solve.cu) runs it every iteration, in place in shared memory.
//
// NaN/inf are part of the contract: build without --use_fast_math or -ftz.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace qnm {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSums = 4;  // quantities summed together by one block_sum

// Threads per block: one per matvec output (By and Bg, 2n), at least two
// warps, at most kMaxThreads (the loops below stride when 2n exceeds it).
inline int threads_for(int n) {
  int t = ((2 * n + 31) / 32) * 32;
  if (t < 64) t = 64;
  if (t > kMaxThreads) t = kMaxThreads;
  return t;
}

// Sums each of v[0..K) over the block; every thread gets the totals. The
// per-warp partials are added in warp order by every thread, so all threads
// see bit-identical sums. ``red`` holds kMaxSums·kMaxWarps values. Its two
// barriers also publish every shared-memory write made before the call.
template <typename T, int K>
__device__ __forceinline__ void block_sum(T (&v)[K], T* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[k * kMaxWarps + warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T acc = T(0);
    for (int w = 0; w < nwarps; ++w) acc += red[k * kMaxWarps + w];
    v[k] = acc;
  }
  __syncthreads();  // red is reused by the next call
}

template <typename T>
struct LaneUpdate {
  T m;         // gᵀ B_new g, or gᵀg on reset
  bool reset;  // m_pre <= 0 (false for NaN): B became the identity
};

// One active lane's fused inverse-BFGS update and next direction, by the
// whole block:
//
//   y = g_old - g;  sᵀy, yᵀy, sᵀg, gᵀg
//   scale = clip(sᵀy/yᵀy, 1e-3, 1e3) where fresh and sᵀy > 0, else 1
//   By = scale·Bᵀy,  Bg = scale·Bᵀg  (B's columns, as the JAX einsum reads)
//   u = By/sᵀy;  yᵀBy, uᵀg, gᵀBg;  c1 = (1 + yᵀBy/sᵀy)/sᵀy
//   m_pre = gᵀBg + c1 (sᵀg)² - 2 (sᵀg)(uᵀg)          (= gᵀ B_new g)
//   d     = Bg + c1 (sᵀg) s - (sᵀg) u - (uᵀg) s        (= B_new g)
//   reset = m_pre <= 0 (false for NaN)
//   B_out = scale·B + c1 s sᵀ - u sᵀ - s uᵀ, or I on reset;  d = g, m = gᵀg on reset
//
// sB is the lane's B (n·n, row-major) in shared memory; B_out may be sB
// itself (in place) or device memory. s and g are in shared memory, g_old
// anywhere; entry i of each must be visible to thread i mod blockDim (its
// own write, or one before a barrier). y, By, Bg, u (n each) and red are
// shared scratch. d may be shared or device memory. On return every thread
// holds the same result; B_out and d are not yet published to other threads.
//
// The clip is written with comparisons so that a NaN ratio stays NaN
// (fminf/fmaxf would drop it), and 1/sᵀy is IEEE (inf for sᵀy = 0).
template <typename T>
__device__ __forceinline__ LaneUpdate<T> bfgs_update_lane(const T* sB, T* B_out, const T* s,
                                                          const T* g, const T* g_old, T* y,
                                                          T* By, T* Bg, T* u, T* red, int n,
                                                          bool fresh, T* d) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  T p1[4] = {T(0), T(0), T(0), T(0)};  // sᵀy, yᵀy, sᵀg, gᵀg
  for (int i = tid; i < n; i += nt) {
    const T si = s[i];
    const T gi = g[i];
    const T yi = g_old[i] - gi;
    y[i] = yi;
    p1[0] += si * yi;
    p1[1] += yi * yi;
    p1[2] += si * gi;
    p1[3] += gi * gi;
  }
  block_sum(p1, red);  // its barriers also publish sB, s, g, y
  const T sty = p1[0];
  const T yty = p1[1];
  const T w = p1[2];
  const T gg = p1[3];
  const T rho = T(1) / sty;
  T gamma = sty / yty;
  gamma = gamma < T(1e-3) ? T(1e-3) : (gamma > T(1e3) ? T(1e3) : gamma);
  const T scale = (fresh && sty > T(0)) ? gamma : T(1);

  // By[j] = Σ_r B[r, j] y[r] and Bg[j] = Σ_r B[r, j] g[r]: thread t < n owns
  // column t of By, thread n + t column t of Bg; neighbouring threads read
  // neighbouring shared addresses.
  for (int t = tid; t < 2 * n; t += nt) {
    const bool first = t < n;
    const int j = first ? t : t - n;
    const T* vec = first ? y : g;
    T acc = T(0);
    for (int r = 0; r < n; ++r) acc += sB[r * n + j] * vec[r];
    acc *= scale;
    if (first) {
      By[j] = acc;
    } else {
      Bg[j] = acc;
    }
  }
  __syncthreads();

  T p2[3] = {T(0), T(0), T(0)};  // yᵀBy, uᵀg, gᵀBg
  for (int i = tid; i < n; i += nt) {
    const T ui = By[i] * rho;
    u[i] = ui;
    p2[0] += By[i] * y[i];
    p2[1] += ui * g[i];
    p2[2] += Bg[i] * g[i];
  }
  block_sum(p2, red);  // its barriers also publish u
  const T ytBy = p2[0];
  const T v = p2[1];
  const T gBg = p2[2];
  const T c1 = (T(1) + ytBy * rho) * rho;
  const T m_pre = gBg + c1 * w * w - T(2) * w * v;
  const bool rst = m_pre <= T(0);

  for (int i = tid; i < n; i += nt) {
    d[i] = rst ? g[i] : Bg[i] + (c1 * w) * s[i] - w * u[i] - v * s[i];
  }
  // Each element is read and written by one thread, and every other read of
  // sB (the matvecs) finished before the barriers above: B_out may be sB.
  const int nn = n * n;
  for (int idx = tid; idx < nn; idx += nt) {
    const int i = idx / n;
    const int j = idx - i * n;
    T out;
    if (rst) {
      out = i == j ? T(1) : T(0);
    } else {
      out = scale * sB[idx] + c1 * (s[i] * s[j]) - u[i] * s[j] - s[i] * u[j];
    }
    B_out[idx] = out;
  }
  return LaneUpdate<T>{rst ? gg : m_pre, rst};
}

}  // namespace qnm
