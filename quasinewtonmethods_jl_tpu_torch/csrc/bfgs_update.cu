// Fused batched inverse-BFGS update plus next search direction, for Hopper
// (sm_90a), in float and double.
//
// Replaces the TPU kernel quasinewtonmethods_jl_tpu/ops/pallas/bfgs_kernel.py
// :: fused_bfgs_update_batched (pl.pallas_call at :234, kernel body _kernel
// :135-193). Semantics are those of its plain twin, here
// quasinewtonmethods_jl_tpu_torch/ops/kernels/bfgs_kernel.py ::
// fused_bfgs_update_reference: each active lane runs the update algebra of
// bfgs_common.cuh :: bfgs_update_lane (written out there); frozen lanes
// (active = 0) leave B untouched and get d = 0, m = 1, reset = 0.
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
// the updated B from it. Frozen lanes return before touching B at all. An n
// whose B does not fit one block's shared memory takes the two-pass kernel
// (bfgs_blocked.cu).
//
// NaN/inf are part of the contract: build without --use_fast_math or -ftz.

#include "bfgs_common.cuh"

namespace {

using qnm::kMaxSums;
using qnm::kMaxWarps;

// Dynamic shared memory, in this order: B (n·n), s, g, y, By, Bg, u (n
// each), the block reduction's per-warp partials (kMaxSums·kMaxWarps).
// ops/kernels/bfgs_kernel.py :: fused_update_fits repeats this count.
size_t smem_bytes(int n, size_t itemsize) {
  return (size_t(n) * n + 6 * size_t(n) + size_t(kMaxSums) * kMaxWarps) * itemsize;
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
  // The same index partition as bfgs_update_lane's first loop, which reads
  // these entries in the same thread before any barrier.
  for (int i = tid; i < n; i += nt) {
    ss[i] = step[vo + i];
    sg[i] = g[vo + i];
  }
  const qnm::LaneUpdate<T> out = qnm::bfgs_update_lane<T>(
      sB, Bl, ss, sg, g_old + vo, sy, sBy, sBg, su, red, n, fresh[b] != 0, d + vo);
  if (tid == 0) {
    m[b] = out.m;
    reset[b] = out.reset ? 1 : 0;
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
  bfgs_update_kernel<T><<<batch, qnm::threads_for(n), smem, static_cast<cudaStream_t>(stream)>>>(
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
