// Fused batched inverse-BFGS update plus next search direction, for Hopper
// (sm_90a), in float and double.
//
// Replaces the TPU kernel quasinewtonmethods_jl_tpu/ops/pallas/bfgs_kernel.py
// :: fused_bfgs_update_batched (pl.pallas_call at :234, kernel body _kernel
// :135-193). Semantics are those of its plain twin, here
// quasinewtonmethods_jl_tpu_torch/ops/kernels/bfgs_kernel.py ::
// fused_bfgs_update_reference, per lane b:
//
//   y = g_old - g;  sᵀy, yᵀy, sᵀg, gᵀg
//   scale = clip(sᵀy/yᵀy, 1e-3, 1e3) on fresh lanes with sᵀy > 0, else 1
//   By = scale·Bᵀy,  Bg = scale·Bᵀg  (B's columns, as the JAX einsum reads)
//   u = By/sᵀy;  yᵀBy, uᵀg, gᵀBg;  c1 = (1 + yᵀBy/sᵀy)/sᵀy
//   m_pre = gᵀBg + c1 (sᵀg)² - 2 (sᵀg)(uᵀg)          (= gᵀ B_new g)
//   d     = Bg + c1 (sᵀg) s - (sᵀg) u - (uᵀg) s        (= B_new g)
//   reset = m_pre <= 0 (false for NaN)
//   B <- scale·B + c1 s sᵀ - u sᵀ - s uᵀ, or I on reset;  d = g, m = gᵀg on reset
//   frozen lanes (active = 0): B untouched, d = 0, m = 1, reset = 0.
//
// The update is IN PLACE: B_out overwrites B, as the TPU kernel's donated
// buffer (input_output_aliases={0: 0}) did.
//
// What bounds it: device-memory bytes. The algorithm is O(n²) flops on O(n²)
// bytes per lane (about 10 flops per element of B), so its floor is one read
// and one write of B: 2·n²·itemsize bytes per lane per call (118 MB for the
// 4096 x 60 x 60 float fleet). The design keeps it there: one thread block
// per lane copies the lane's contiguous B into shared memory once (coalesced),
// takes both matvecs and all seven dot products from that copy, and writes
// the updated B from it. Frozen lanes return before touching B at all.
//
// NaN/inf are part of the contract: build without --use_fast_math or -ftz.
// The clip is written with comparisons so that a NaN ratio stays NaN
// (fminf/fmaxf would drop it), and 1/sᵀy is IEEE (inf for sᵀy = 0).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSums = 4;  // quantities summed together by one block_sum

// Threads per block: one per matvec output (By and Bg, 2n), at least two
// warps, at most kMaxThreads (the loops below stride when 2n exceeds it).
int threads_for(int n) {
  int t = ((2 * n + 31) / 32) * 32;
  if (t < 64) t = 64;
  if (t > kMaxThreads) t = kMaxThreads;
  return t;
}

// Dynamic shared memory, in this order: B (n·n), s, g, y, By, Bg, u (n
// each), the block reduction's per-warp partials (kMaxSums·kMaxWarps).
size_t smem_bytes(int n, size_t itemsize) {
  return (size_t(n) * n + 6 * size_t(n) + size_t(kMaxSums) * kMaxWarps) * itemsize;
}

// Sums each of v[0..K) over the block; every thread gets the totals. The
// per-warp partials are added in warp order by every thread, so all threads
// see bit-identical sums.
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
__global__ void bfgs_update_kernel(T* __restrict__ B, const T* __restrict__ step,
                                   const T* __restrict__ g, const T* __restrict__ g_old,
                                   const uint8_t* __restrict__ active,
                                   const uint8_t* __restrict__ fresh, T* __restrict__ d,
                                   T* __restrict__ m, uint8_t* __restrict__ reset, int n) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t vo = size_t(b) * n;

  if (!active[b]) {
    for (int i = tid; i < n; i += nt) d[vo + i] = T(0);
    if (tid == 0) {
      m[b] = T(1);
      reset[b] = 0;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);
  T* ss = sB + size_t(n) * n;
  T* sg = ss + n;
  T* sy = sg + n;
  T* sBy = sy + n;
  T* sBg = sBy + n;
  T* su = sBg + n;
  T* red = su + n;

  T* Bl = B + size_t(b) * n * n;
  const int nn = n * n;
  for (int i = tid; i < nn; i += nt) sB[i] = Bl[i];

  T p1[4] = {T(0), T(0), T(0), T(0)};  // sᵀy, yᵀy, sᵀg, gᵀg
  for (int i = tid; i < n; i += nt) {
    const T si = step[vo + i];
    const T gi = g[vo + i];
    const T yi = g_old[vo + i] - gi;
    ss[i] = si;
    sg[i] = gi;
    sy[i] = yi;
    p1[0] += si * yi;
    p1[1] += yi * yi;
    p1[2] += si * gi;
    p1[3] += gi * gi;
  }
  block_sum(p1, red);  // its barriers also publish sB, ss, sg, sy
  const T sty = p1[0];
  const T yty = p1[1];
  const T w = p1[2];
  const T gg = p1[3];
  const T rho = T(1) / sty;
  T gamma = sty / yty;
  gamma = gamma < T(1e-3) ? T(1e-3) : (gamma > T(1e3) ? T(1e3) : gamma);
  const T scale = (fresh[b] && sty > T(0)) ? gamma : T(1);

  // By[j] = Σ_r B[r, j] y[r] and Bg[j] = Σ_r B[r, j] g[r]: thread t < n owns
  // column t of By, thread n + t column t of Bg; neighbouring threads read
  // neighbouring shared addresses.
  for (int t = tid; t < 2 * n; t += nt) {
    const bool first = t < n;
    const int j = first ? t : t - n;
    const T* vec = first ? sy : sg;
    T acc = T(0);
    for (int r = 0; r < n; ++r) acc += sB[r * n + j] * vec[r];
    acc *= scale;
    if (first) {
      sBy[j] = acc;
    } else {
      sBg[j] = acc;
    }
  }
  __syncthreads();

  T p2[3] = {T(0), T(0), T(0)};  // yᵀBy, uᵀg, gᵀBg
  for (int i = tid; i < n; i += nt) {
    const T ui = sBy[i] * rho;
    su[i] = ui;
    p2[0] += sBy[i] * sy[i];
    p2[1] += ui * sg[i];
    p2[2] += sBg[i] * sg[i];
  }
  block_sum(p2, red);  // its barriers also publish su
  const T ytBy = p2[0];
  const T v = p2[1];
  const T gBg = p2[2];
  const T c1 = (T(1) + ytBy * rho) * rho;
  const T m_pre = gBg + c1 * w * w - T(2) * w * v;
  const bool rst = m_pre <= T(0);

  for (int i = tid; i < n; i += nt) {
    d[vo + i] = rst ? sg[i] : sBg[i] + (c1 * w) * ss[i] - w * su[i] - v * ss[i];
  }
  if (tid == 0) {
    m[b] = rst ? gg : m_pre;
    reset[b] = rst ? 1 : 0;
  }
  for (int idx = tid; idx < nn; idx += nt) {
    const int i = idx / n;
    const int j = idx - i * n;
    T out;
    if (rst) {
      out = i == j ? T(1) : T(0);
    } else {
      out = scale * sB[idx] + c1 * (ss[i] * ss[j]) - su[i] * ss[j] - ss[i] * su[j];
    }
    Bl[idx] = out;
  }
}

template <typename T>
int launch(void* B, const void* step, const void* g, const void* g_old, const void* active,
           const void* fresh, void* d, void* m, void* reset, int batch, int n, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const size_t smem = smem_bytes(n, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bfgs_update_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  bfgs_update_kernel<T><<<batch, threads_for(n), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(B), static_cast<const T*>(step), static_cast<const T*>(g),
      static_cast<const T*>(g_old), static_cast<const uint8_t*>(active),
      static_cast<const uint8_t*>(fresh), static_cast<T*>(d), static_cast<T*>(m),
      static_cast<uint8_t*>(reset), n);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block of the update asks for, in bytes.
size_t qnm_bfgs_update_smem_bytes(int n, int itemsize) {
  return smem_bytes(n, size_t(itemsize));
}

// Both return cudaGetLastError() after the launch (0 = launched).
int qnm_bfgs_update_f32(void* B, const void* step, const void* g, const void* g_old,
                        const void* active, const void* fresh, void* d, void* m,
                        void* reset, int batch, int n, void* stream) {
  return launch<float>(B, step, g, g_old, active, fresh, d, m, reset, batch, n, stream);
}

int qnm_bfgs_update_f64(void* B, const void* step, const void* g, const void* g_old,
                        const void* active, const void* fresh, void* d, void* m,
                        void* reset, int batch, int n, void* stream) {
  return launch<double>(B, step, g, g_old, active, fresh, d, m, reset, batch, n, stream);
}

const char* qnm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
