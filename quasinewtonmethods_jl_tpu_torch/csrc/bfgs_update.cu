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
// bytes per lane (about 12 flops per element of B), so its floor is one read
// and one write of B: 2·n²·itemsize bytes per lane per call (118 MB for the
// 4096 x 60 x 60 float fleet). One lane group of bfgs_common.cuh (one warp
// up to n = 64) per lane, as a block of its own, so that many lanes' copies
// are in flight on each SM:
//   - one thread asks the Tensor Memory Accelerator for the lane's whole
//     contiguous B in one bulk copy (cp.async.bulk, completion on an
//     mbarrier); where the lane's B does not start or end on 16 bytes
//     (n·n·itemsize or the lane offset not a multiple of 16, e.g. n = 7 or
//     61), the copy takes the aligned middle and threads load the few
//     elements at either end, so B is placed in shared memory at the same
//     address modulo 16 as in device memory;
//   - while the copy is in flight the lane loads step, g and g_old and takes
//     y and the four sums that need no B (sᵀy, yᵀy, sᵀg, gᵀg);
//   - the algebra updates B in place in shared memory, and the lane writes
//     it back with 16-byte stores (the ends element by element);
//   - frozen lanes return before touching B at all.
// An n whose B does not fit one block's shared memory takes the two-pass
// kernel (bfgs_blocked.cu).
//
// NaN/inf are part of the contract: build without --use_fast_math or -ftz.

#include "bfgs_common.cuh"

namespace {

using qnm::kRedValues;
using qnm::LaneGroup;

// Dynamic shared memory a block asks for. The lane uses, in this order, up
// to 16/itemsize - 1 values of padding, B (n·n), s, g, y, u (n each) and,
// above n = 64, the reduction scratch (kRedValues): at most n² + 4n + 3 +
// kRedValues values. The count keeps the n² + 6n + kRedValues of the
// earlier block-per-lane layout, so that ops/kernels/bfgs_kernel.py ::
// fused_update_fits, which repeats it, admits exactly the n it did (n <= 237
// in float, <= 167 in double).
size_t smem_bytes(int n, size_t itemsize) {
  return (size_t(n) * n + 6 * size_t(n) + size_t(kRedValues)) * itemsize;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T, bool kOneWarp>
__global__ void __launch_bounds__(qnm::kMaxLaneWarps * 32)
    bfgs_update_kernel(T* __restrict__ B, const T* __restrict__ step, const T* __restrict__ g,
                       const T* __restrict__ g_old, const uint8_t* __restrict__ active,
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
  __shared__ __align__(8) uint64_t bar;  // completes when the bulk load has landed
  constexpr int kVec = 16 / int(sizeof(T));  // elements per 16 bytes
  T* Bl = B + size_t(b) * n * n;
  const int nn = n * n;
  // B's elements [0, head) and [head + body, nn) go by threads, the 16-byte
  // aligned [head, head + body) by bulk copies; sB[i] sits at the same
  // address modulo 16 as Bl[i].
  const int mis = int((reinterpret_cast<uintptr_t>(Bl) % 16) / sizeof(T));
  const int head = mis == 0 ? 0 : (kVec - mis < nn ? kVec - mis : nn);
  const int body = (nn - head) / kVec * kVec;
  const uint32_t body_bytes = uint32_t(body) * sizeof(T);
  T* sB = reinterpret_cast<T*>(smem_raw) + mis;
  T* ss = reinterpret_cast<T*>(smem_raw) + (kVec - 1) + nn;
  T* sg = ss + n;
  T* sy = sg + n;
  T* su = sy + n;
  LaneGroup<T, kOneWarp> grp{su + n};

  if (tid == 0 && body_bytes > 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&bar)), "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_addr(&bar)), "r"(body_bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(sB + head)), "l"(Bl + head), "r"(body_bytes), "r"(smem_addr(&bar))
        : "memory");
  }
  for (int i = tid; i < nn - body; i += nt) {
    const int e = i < head ? i : i + body;
    sB[e] = Bl[e];
  }

  // Meanwhile the sums that need no B.
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
  grp.sum(p1);  // also publishes s, g, y, B's ends and the mbarrier's init
  if (body_bytes > 0) {
    uint32_t landed = 0;
    while (!landed) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(landed)
          : "r"(smem_addr(&bar))
          : "memory");
    }
  }

  const qnm::LaneUpdate<T> out = qnm::bfgs_update_lane<T, kOneWarp>(
      grp, sB, ss, sg, sy, su, n, p1[0], p1[1], p1[2], p1[3], fresh[b] != 0, d + vo);

  // Write B back with 16-byte stores (the ends element by element). Plain
  // stores, not a bulk copy: the block then need not wait for the copy to
  // finish reading shared memory before it exits and frees its slot.
  grp.sync();
  {
    const uint4* src = reinterpret_cast<const uint4*>(sB + head);
    uint4* dst = reinterpret_cast<uint4*>(Bl + head);
    for (int i = tid; i < body / kVec; i += nt) dst[i] = src[i];
  }
  for (int i = tid; i < nn - body; i += nt) {
    const int e = i < head ? i : i + body;
    Bl[e] = sB[e];
  }
  if (tid == 0) {
    m[b] = out.m;
    reset[b] = out.reset ? 1 : 0;
  }
}

template <typename T>
auto launch_for(int n) {
  return qnm::lane_launch(n, &bfgs_update_kernel<T, true>, &bfgs_update_kernel<T, false>,
                          smem_bytes(n, sizeof(T)));
}

template <typename T>
int launch(void* B, const void* step, const void* g, const void* g_old, const void* active,
           const void* fresh, void* d, void* m, void* reset, int batch, int n, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const auto l = launch_for<T>(n);
  if (l.err != cudaSuccess) return int(l.err);
  l.kernel<<<batch, l.threads, l.smem, static_cast<cudaStream_t>(stream)>>>(
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

// The update's launch at n: registers per thread, threads per block and
// blocks per SM (the occupancy calculator's, with the attributes a launch
// sets). Returns a CUDA error code (0 = success).
int qnm_bfgs_update_occupancy(int n, int itemsize, int* regs, int* threads, int* blocks_per_sm) {
  return itemsize == 4 ? qnm::lane_occupancy(launch_for<float>(n), regs, threads, blocks_per_sm)
                       : qnm::lane_occupancy(launch_for<double>(n), regs, threads, blocks_per_sm);
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
