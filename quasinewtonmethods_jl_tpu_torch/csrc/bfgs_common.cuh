// Device code shared by the port's kernels: the lane group (the warps that
// run one lane), its deterministic reductions, and the per-lane
// inverse-BFGS update algebra. The fused update B1 (bfgs_update.cu) runs
// the algebra once per call, on B staged from device memory; the resident
// solver B3 (resident_solve.cu) runs it every iteration, in place in shared
// memory.
//
// A lane is one thread block of W = lane_warps(n) warps: one warp up to
// n = 64, which covers the benchmark fleet's n = 60. Thread t owns B's
// columns t and t + 32W (those below n). Bᵀy[j] and Bᵀg[j] are then sums
// over the thread's own column, against y[r] and g[r] that every thread of
// the warp reads at the same shared address (a broadcast); B[r, j] for a
// fixed r lies on consecutive addresses across the warp, so no access has
// a bank conflict. The rank-2 change of a column needs s[r] and u[r]
// (broadcast) and the thread's own s[j] and u[j]. Only a column's owner
// writes it, and no thread reads another's column to use it: a pass over
// B needs no barrier. A pass goes down the rows in batches, each batch's
// loads issued before its stores, so that one warp keeps several loads in
// flight.
//
// Dot products are butterfly reductions (__shfl_xor_sync): every thread
// ends with the same bits, so control flow stays uniform. For one warp that
// needs no shared scratch and no __syncthreads, only __syncwarp; for W > 1
// the warps' totals meet in shared memory behind one __syncthreads. Every
// sum is taken in a fixed order, so results repeat run to run.
//
// NaN/inf are part of the contract: build without --use_fast_math or -ftz.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace qnm {

constexpr int kMaxLaneWarps = 4;  // lanes up to n = 256 (both kernels stop at 237)
constexpr int kMaxSums = 8;       // quantities summed together by one LaneGroup::sum
// Scratch of the multi-warp sum: two buffers (used in turn, so that one
// barrier per sum suffices) of kMaxSums x kMaxLaneWarps partials.
constexpr int kRedValues = 2 * kMaxSums * kMaxLaneWarps;

// Warps per lane: one for n <= 64, so that a thread owns at most two
// columns of B at any n.
inline int lane_warps(int n) { return n <= 64 ? 1 : (n + 63) / 64; }

template <typename T, bool kOneWarp>
struct LaneGroup {
  T* red;          // kRedValues values of shared scratch (unused by one warp)
  int parity = 0;  // the scratch buffer the next multi-warp sum writes

  // Publishes the shared writes made before it to the whole lane.
  __device__ __forceinline__ void sync() {
    if constexpr (kOneWarp) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }

  // Sums each of v[0..K) over the lane; every thread gets the same totals.
  // Also publishes the shared writes made before the call.
  template <int K>
  __device__ __forceinline__ void sum(T (&v)[K]) {
    static_assert(K <= kMaxSums, "raise kMaxSums");
    if constexpr (kOneWarp) __syncwarp();
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    }
    if constexpr (!kOneWarp) {
      const int nw = blockDim.x >> 5;
      T* buf = red + parity * (kMaxSums * kMaxLaneWarps);
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) buf[k * kMaxLaneWarps + (threadIdx.x >> 5)] = v[k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        T acc = buf[k * kMaxLaneWarps];
        for (int w = 1; w < nw; ++w) acc += buf[k * kMaxLaneWarps + w];
        v[k] = acc;
      }
      parity ^= 1;
    }
  }
};

// The thread's columns of B: j[c] is clamped to a real column, so that a
// thread without one computes a duplicate (no divergence) and writes
// nothing (own[c] false).
struct Columns {
  int j[2];
  bool own[2];
  __device__ __forceinline__ explicit Columns(int n) {
    const int t = threadIdx.x;
    const int t2 = t + blockDim.x;
    own[0] = t < n;
    own[1] = t2 < n;
    j[0] = own[0] ? t : n - 1;
    j[1] = own[1] ? t2 : n - 1;
  }
};

// A change of B that the update algebra decided: B = scale·B + c1 s sᵀ -
// u sᵀ - s uᵀ (scale 1 skips its product, which is exact), or B = I. B1
// applies it at once; B3 keeps it pending and applies it in the next pass
// over B, the one that takes the next iteration's matvecs, so that B is
// read and written once per iteration.
enum ChangeKind { kKeep = 0, kRank2 = 1, kRank2Unscaled = 2, kIdentity = 3 };

template <typename T>
struct Change {
  int kind = kKeep;
  T scale = T(1), c1 = T(0);
  const T* s = nullptr;  // shared s and u of the rank-2 change
  const T* u = nullptr;
  T sj[2] = {T(0), T(0)};  // the thread's own entries s[j], u[j]
  T uj[2] = {T(0), T(0)};
};

// One batch of R rows of a pass over the thread's columns: first every
// load, so that their latency overlaps; then per element the change (the
// expression and its order are those of the plain version) and, with
// kMatvec, the matvecs' terms, summed over rows in order. There is no
// branch: a thread without a column computes a duplicate and stores
// nothing.
template <typename T, int C, int R, int kKind, bool kMatvec>
__device__ __forceinline__ void pass_rows(T* __restrict__ sB, int n, int r0, const Columns& cols,
                                          const Change<T>& ch, const T* __restrict__ y,
                                          const T* __restrict__ g, T (&ay)[C], T (&ag)[C]) {
  constexpr bool kRank = kKind == kRank2 || kKind == kRank2Unscaled;
  T b[R][C], sr[R], ur[R], yr[R], gr[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if constexpr (kRank) {
      sr[q] = ch.s[r0 + q];
      ur[q] = ch.u[r0 + q];
    }
    if constexpr (kMatvec) {
      yr[q] = y[r0 + q];
      gr[q] = g[r0 + q];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (kKind != kIdentity) b[q][c] = sB[(r0 + q) * n + cols.j[c]];
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T e;
      if constexpr (kKind == kRank2) {
        e = ch.scale * b[q][c] + ch.c1 * (sr[q] * ch.sj[c]) - ur[q] * ch.sj[c] - sr[q] * ch.uj[c];
      } else if constexpr (kKind == kRank2Unscaled) {
        e = b[q][c] + ch.c1 * (sr[q] * ch.sj[c]) - ur[q] * ch.sj[c] - sr[q] * ch.uj[c];
      } else if constexpr (kKind == kIdentity) {
        e = r0 + q == cols.j[c] ? T(1) : T(0);
      } else {
        e = b[q][c];
      }
      if constexpr (kKind != kKeep) {
        if (cols.own[c]) sB[(r0 + q) * n + cols.j[c]] = e;
      }
      if constexpr (kMatvec) {
        ay[c] += e * yr[q];
        ag[c] += e * gr[q];
      }
    }
  }
}

constexpr int kRows = 4;  // rows per batch

template <typename T, int C, int kKind, bool kMatvec>
__device__ __forceinline__ void pass_columns(T* sB, int n, const Columns& cols,
                                             const Change<T>& ch, const T* y, const T* g,
                                             T (&By)[2], T (&Bg)[2]) {
  T ay[C], ag[C];
#pragma unroll
  for (int c = 0; c < C; ++c) ay[c] = ag[c] = T(0);
  int r = 0;
  for (; r + kRows <= n; r += kRows) {
    pass_rows<T, C, kRows, kKind, kMatvec>(sB, n, r, cols, ch, y, g, ay, ag);
  }
  for (; r < n; ++r) pass_rows<T, C, 1, kKind, kMatvec>(sB, n, r, cols, ch, y, g, ay, ag);
  By[0] = ay[0];
  Bg[0] = ag[0];
  By[1] = C > 1 ? ay[C - 1] : T(0);
  Bg[1] = C > 1 ? ag[C - 1] : T(0);
}

template <typename T, int C, bool kMatvec>
__device__ __forceinline__ void pass_kind(T* sB, int n, const Columns& cols, const Change<T>& ch,
                                          const T* y, const T* g, T (&By)[2], T (&Bg)[2]) {
  switch (ch.kind) {
    case kRank2:
      pass_columns<T, C, kRank2, kMatvec>(sB, n, cols, ch, y, g, By, Bg);
      break;
    case kRank2Unscaled:
      pass_columns<T, C, kRank2Unscaled, kMatvec>(sB, n, cols, ch, y, g, By, Bg);
      break;
    case kIdentity:
      pass_columns<T, C, kIdentity, kMatvec>(sB, n, cols, ch, y, g, By, Bg);
      break;
    default:
      pass_columns<T, C, kKeep, kMatvec>(sB, n, cols, ch, y, g, By, Bg);
  }
}

// One pass over the thread's columns of B (sB, n·n row-major, in shared
// memory): applies ``ch`` in place and, with kMatvec, returns By[c] =
// Σ_r B[r, j] y[r] and Bg[c] = Σ_r B[r, j] g[r] of the changed B (B's
// columns, as the JAX einsum reads them).
template <typename T, bool kMatvec>
__device__ __forceinline__ void column_pass(T* sB, int n, const Columns& cols, const Change<T>& ch,
                                            const T* y, const T* g, T (&By)[2], T (&Bg)[2]) {
  if (int(blockDim.x) < n) {  // some thread owns a second column
    pass_kind<T, 2, kMatvec>(sB, n, cols, ch, y, g, By, Bg);
  } else {
    pass_kind<T, 1, kMatvec>(sB, n, cols, ch, y, g, By, Bg);
  }
}

template <typename T>
struct LaneUpdate {
  T m;          // gᵀ B_new g, or gᵀg on reset
  bool reset;   // m_pre <= 0 (false for NaN): B becomes the identity
  Change<T> b;  // the change of B
};

// One active lane's inverse-BFGS update algebra and next direction, by the
// whole lane group, from B's matvecs (By = Bᵀy, Bg = Bᵀg unscaled, the
// thread's columns) and the sums that need no B:
//
//   y = g_old - g;  sᵀy, yᵀy, w = sᵀg, gᵀg           (the caller's)
//   scale = clip(sᵀy/yᵀy, 1e-3, 1e3) where fresh and sᵀy > 0, else 1
//   By = scale·Bᵀy,  Bg = scale·Bᵀg
//   u = By/sᵀy;  yᵀBy, v = uᵀg, gᵀBg;  c1 = (1 + yᵀBy/sᵀy)/sᵀy
//   m_pre = gᵀBg + c1 w² - 2 w v                      (= gᵀ B_new g)
//   d     = Bg + c1 w s - w u - v s                   (= B_new g)
//   reset = m_pre <= 0 (false for NaN)
//   B_new = scale·B + c1 s sᵀ - u sᵀ - s uᵀ, or I on reset;  d = g, m = gᵀg on reset
//
// s, g, y (shared, n each) must be visible to the whole lane; u is shared
// scratch (n) that holds u afterwards. d[j] is written by column j's owner,
// to shared or device memory. Returns m, reset and B's change; every thread
// holds the same result, and d is not yet published to other threads.
//
// The clip is written with comparisons so that a NaN ratio stays NaN
// (fminf/fmaxf would drop it), and 1/sᵀy is IEEE (inf for sᵀy = 0).
template <typename T, bool kOneWarp>
__device__ __forceinline__ LaneUpdate<T> update_algebra(LaneGroup<T, kOneWarp>& grp,
                                                        const Columns& cols, T (&By)[2],
                                                        T (&Bg)[2], const T* s, const T* g,
                                                        const T* y, T* u, T sty, T yty, T w,
                                                        T gg, bool fresh, T* d) {
  const T rho = T(1) / sty;
  T gamma = sty / yty;
  gamma = gamma < T(1e-3) ? T(1e-3) : (gamma > T(1e3) ? T(1e3) : gamma);
  const T scale = (fresh && sty > T(0)) ? gamma : T(1);

  Change<T> ch;
  T p2[3] = {T(0), T(0), T(0)};  // yᵀBy, uᵀg, gᵀBg
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = cols.j[c];
    By[c] *= scale;
    Bg[c] *= scale;
    ch.uj[c] = By[c] * rho;
    ch.sj[c] = s[j];
    if (cols.own[c]) {
      u[j] = ch.uj[c];
      p2[0] += By[c] * y[j];
      p2[1] += ch.uj[c] * g[j];
      p2[2] += Bg[c] * g[j];
    }
  }
  grp.sum(p2);  // also publishes u
  const T ytBy = p2[0];
  const T v = p2[1];
  const T gBg = p2[2];
  const T c1 = (T(1) + ytBy * rho) * rho;
  const T m_pre = gBg + c1 * w * w - T(2) * w * v;
  const bool rst = m_pre <= T(0);

#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = cols.j[c];
    if (cols.own[c]) d[j] = rst ? g[j] : Bg[c] + (c1 * w) * ch.sj[c] - w * ch.uj[c] - v * ch.sj[c];
  }
  ch.kind = rst ? kIdentity : (scale == T(1) ? kRank2Unscaled : kRank2);
  ch.scale = scale;
  ch.c1 = c1;
  ch.s = s;
  ch.u = u;
  return LaneUpdate<T>{rst ? gg : m_pre, rst, ch};
}

// The whole update of one lane at once (B1): the matvecs, the algebra, and
// the change of B in place.
template <typename T, bool kOneWarp>
__device__ __forceinline__ LaneUpdate<T> bfgs_update_lane(LaneGroup<T, kOneWarp>& grp, T* sB,
                                                          const T* s, const T* g, const T* y,
                                                          T* u, int n, T sty, T yty, T w, T gg,
                                                          bool fresh, T* d) {
  const Columns cols(n);
  T By[2], Bg[2];
  column_pass<T, true>(sB, n, cols, Change<T>{}, y, g, By, Bg);
  const LaneUpdate<T> upd =
      update_algebra(grp, cols, By, Bg, s, g, y, u, sty, yty, w, gg, fresh, d);
  column_pass<T, false>(sB, n, cols, upd.b, y, g, By, Bg);
  return upd;
}

// Host side. The launch of a lane-group kernel at n: its variant (one warp
// or several), threads per block and dynamic shared memory, and the error
// of choosing and preparing it.
template <typename Kernel>
struct LaneLaunch {
  Kernel kernel = nullptr;
  int threads = 0;
  size_t smem = 0;
  cudaError_t err = cudaSuccess;
};

// Picks the variant for n and prepares it: dynamic shared memory above
// 48 KB, and the SM's carveout to shared memory's maximum, since shared
// memory, not registers, bounds its blocks per SM.
template <typename Kernel>
LaneLaunch<Kernel> lane_launch(int n, Kernel one_warp, Kernel several_warps, size_t smem) {
  LaneLaunch<Kernel> l;
  const int warps = lane_warps(n);
  if (warps > kMaxLaneWarps) {
    l.err = cudaErrorInvalidValue;
    return l;
  }
  l.kernel = warps == 1 ? one_warp : several_warps;
  l.threads = 32 * warps;
  l.smem = smem;
  l.err = cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (l.err == cudaSuccess) {
    l.err = cudaFuncSetAttribute(l.kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 int(cudaSharedmemCarveoutMaxShared));
  }
  return l;
}

// A launch's registers per thread, threads per block and blocks per SM
// (the occupancy calculator's, with the attributes lane_launch set).
// Returns a CUDA error code (0 = success).
template <typename Kernel>
int lane_occupancy(const LaneLaunch<Kernel>& l, int* regs, int* threads, int* blocks_per_sm) {
  if (l.err != cudaSuccess) return int(l.err);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, l.kernel);
  if (err != cudaSuccess) return int(err);
  *regs = attr.numRegs;
  *threads = l.threads;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, l.kernel, l.threads,
                                                           l.smem));
}

}  // namespace qnm
