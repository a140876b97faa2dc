// Two-pass batched inverse-BFGS update, for n whose B does not fit one
// block's shared memory, for Hopper (sm_90a), in float and double.
//
// Replaces the two TPU kernels of
// quasinewtonmethods_jl_tpu/ops/pallas/bfgs_blocked.py ::
// fused_bfgs_update_blocked:
//   B2a  _matvec_kernel (:112-134, pl.pallas_call at :236): By = Bᵀy and
//        Bg = Bᵀg in one read of B;
//   B2b  _update_kernel (:137-170, pl.pallas_call at :288): the rank-2
//        update of B in place, with identity reset and frozen-lane select.
// Between the passes the wrapper (ops/kernels/bfgs_blocked.py) runs the
// O(n·batch) algebra as plain tensor ops, as the JAX wrapper does
// (:265-285). Plain twins: ops/kernels/bfgs_kernel.py ::
// blocked_matvec_reference and blocked_update_reference.
//
// Layout is lane-major: B is (batch, n, n) contiguous, vectors (batch, n),
// per-lane scalars and masks (batch,).
//
// What bounds it: device-memory bytes, about 2 flops per byte of B. The
// floor of an update that cannot keep B on chip is three passes of B per
// call: B2a reads it once, B2b reads it once and writes it once, that is
// 3·n²·itemsize·batch bytes (3.2 GB, about 1.0 ms at the published
// 3.35 TB/s, for 1024 lanes at n = 512 in float). Both kernels move exactly
// that, with every access coalesced: in B2a each thread owns one column and
// walks the rows, so a warp reads 32 neighbouring elements of a row; in B2b
// each thread walks along rows. Reset lanes write B without reading it, and
// frozen lanes (neither update nor reset) are not touched at all.
//
// B2a sums over rows in ascending order, so its result is deterministic.
// This file is built with -fmad=false: B2b then rounds each product and sum
// as the plain version's separate tensor ops do, and matches it bit for bit.
// NaN/inf are part of the contract: no --use_fast_math, no -ftz.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMatvecThreads = 128;
constexpr int kUpdateThreads = 256;
constexpr int kUpdateElemsPerThread = 8;

int round_up_warp(int n) { return ((n + 31) / 32) * 32; }

// Grid (batch, ceil(n / blockDim)): thread c of the lane owns column c.
template <typename T>
__global__ void blocked_matvec_kernel(const T* __restrict__ B, const T* __restrict__ y,
                                      const T* __restrict__ g, T* __restrict__ By,
                                      T* __restrict__ Bg, int n) {
  const int b = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const T* Bl = B + size_t(b) * n * n;
  const T* yl = y + size_t(b) * n;
  const T* gl = g + size_t(b) * n;
  T acc_y = T(0);
  T acc_g = T(0);
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    const T v = Bl[size_t(r) * n + c];
    acc_y += v * __ldg(yl + r);
    acc_g += v * __ldg(gl + r);
  }
  By[size_t(b) * n + c] = acc_y;
  Bg[size_t(b) * n + c] = acc_g;
}

// Grid (batch, row blocks): block y walks rows y, y + gridDim.y, ... of its
// lane, its threads along each row.
//   B[r, c] = do_upd ? scale·B + c1·s[r]s[c] - u[r]s[c] - s[r]u[c]
//           : reset  ? I[r, c]
//           : B      (frozen lane: no access)
template <typename T>
__global__ void blocked_update_kernel(T* __restrict__ B, const T* __restrict__ s,
                                      const T* __restrict__ u, const T* __restrict__ c1,
                                      const T* __restrict__ scale,
                                      const uint8_t* __restrict__ do_upd,
                                      const uint8_t* __restrict__ reset, int n) {
  const int b = blockIdx.x;
  const bool upd = do_upd[b] != 0;
  if (!upd && !reset[b]) return;
  T* Bl = B + size_t(b) * n * n;
  const T* sl = s + size_t(b) * n;
  const T* ul = u + size_t(b) * n;
  const T sc = scale[b];
  const T cc = c1[b];
  for (int r = blockIdx.y; r < n; r += gridDim.y) {
    T* row = Bl + size_t(r) * n;
    if (upd) {
      const T sr = sl[r];
      const T ur = ul[r];
      for (int c = threadIdx.x; c < n; c += blockDim.x) {
        const T scol = sl[c];
        row[c] = sc * row[c] + cc * (sr * scol) - ur * scol - sr * ul[c];
      }
    } else {
      for (int c = threadIdx.x; c < n; c += blockDim.x) row[c] = r == c ? T(1) : T(0);
    }
  }
}

template <typename T>
int launch_matvec(const void* B, const void* y, const void* g, void* By, void* Bg, int batch,
                  int n, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int threads = n < kMatvecThreads ? round_up_warp(n) : kMatvecThreads;
  const dim3 grid(batch, (n + threads - 1) / threads);
  blocked_matvec_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(B), static_cast<const T*>(y), static_cast<const T*>(g),
      static_cast<T*>(By), static_cast<T*>(Bg), n);
  return int(cudaGetLastError());
}

template <typename T>
int launch_update(void* B, const void* s, const void* u, const void* c1, const void* scale,
                  const void* do_upd, const void* reset, int batch, int n, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int threads = n < kUpdateThreads ? round_up_warp(n) : kUpdateThreads;
  // about kUpdateElemsPerThread elements per thread, at most one block per row
  const long long per_block = (long long)threads * kUpdateElemsPerThread;
  long long rows = ((long long)n * n + per_block - 1) / per_block;
  if (rows > n) rows = n;
  if (rows > 65535) rows = 65535;
  const dim3 grid(batch, int(rows));
  blocked_update_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(B), static_cast<const T*>(s), static_cast<const T*>(u),
      static_cast<const T*>(c1), static_cast<const T*>(scale),
      static_cast<const uint8_t*>(do_upd), static_cast<const uint8_t*>(reset), n);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// All return cudaGetLastError() after the launch (0 = launched).
int qnm_blocked_matvec_f32(const void* B, const void* y, const void* g, void* By, void* Bg,
                           int batch, int n, void* stream) {
  return launch_matvec<float>(B, y, g, By, Bg, batch, n, stream);
}

int qnm_blocked_matvec_f64(const void* B, const void* y, const void* g, void* By, void* Bg,
                           int batch, int n, void* stream) {
  return launch_matvec<double>(B, y, g, By, Bg, batch, n, stream);
}

int qnm_blocked_update_f32(void* B, const void* s, const void* u, const void* c1,
                           const void* scale, const void* do_upd, const void* reset, int batch,
                           int n, void* stream) {
  return launch_update<float>(B, s, u, c1, scale, do_upd, reset, batch, n, stream);
}

int qnm_blocked_update_f64(void* B, const void* s, const void* u, const void* c1,
                           const void* scale, const void* do_upd, const void* reset, int batch,
                           int n, void* stream) {
  return launch_update<double>(B, s, u, c1, scale, do_upd, reset, batch, n, stream);
}

}  // extern "C"
