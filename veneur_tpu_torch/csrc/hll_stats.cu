// HLL estimate reduction for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel veneur_tpu/kernels/hll_stats.py:hll_stats
// (body _stats_kernel). Per row of a u8[K, m] register bank it computes
// the two statistics the LogLog-Beta estimator needs:
//   ez   = #(register == 0)   (an integer count, returned as f32)
//   zsum = sum(2^-register)   (f32)
// 2^-r is built exactly from the exponent bits, __int_as_float((127 - r)
// << 23), valid for r <= 126 (HLL registers are <= 64 - p + 1).
//
// What bounds it on the H100: bytes — one read of K*m bytes (64 MiB at
// [4096, 16384], ~20 us at 3.35 TB/s) and two f32 writes per row. The
// design streams the bank once: one CTA per row, 16-byte loads with
// neighbouring threads on neighbouring addresses, per-thread partials in
// registers, then a reduction in a fixed order (a warp shuffle tree,
// then the warps' partials summed in warp order by one thread), so the
// result does not vary from run to run. Rows whose width or address is
// not a multiple of 16 bytes take a byte-wise loop; any m works.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void add_byte(uint32_t r, int& ez, float& zs) {
  ez += r == 0u;
  zs += __int_as_float((127 - (int)r) << 23);
}

__device__ __forceinline__ void add_word(uint32_t w, int& ez, float& zs) {
  add_byte(w & 0xFFu, ez, zs);
  add_byte((w >> 8) & 0xFFu, ez, zs);
  add_byte((w >> 16) & 0xFFu, ez, zs);
  add_byte(w >> 24, ez, zs);
}

__global__ void __launch_bounds__(kThreads)
hll_stats_kernel(const uint8_t* __restrict__ regs, float* __restrict__ ez,
                 float* __restrict__ zsum, int m) {
  __shared__ int s_ez[kWarps];
  __shared__ float s_zs[kWarps];
  const uint8_t* r = regs + (size_t)blockIdx.x * m;
  const int tid = threadIdx.x;
  int cnt = 0;
  float acc = 0.0f;
  if ((m & 15) == 0 && (reinterpret_cast<uintptr_t>(r) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(r);
    for (int i = tid; i < (m >> 4); i += kThreads) {
      uint4 q = v[i];
      add_word(q.x, cnt, acc);
      add_word(q.y, cnt, acc);
      add_word(q.z, cnt, acc);
      add_word(q.w, cnt, acc);
    }
  } else {
    for (int i = tid; i < m; i += kThreads) add_byte(r[i], cnt, acc);
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
    acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
  }
  if ((tid & 31) == 0) {
    s_ez[tid >> 5] = cnt;
    s_zs[tid >> 5] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    float a = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      c += s_ez[w];
      a += s_zs[w];
    }
    ez[blockIdx.x] = (float)c;
    zsum[blockIdx.x] = a;
  }
}

}  // namespace

extern "C" {

// One launch over K rows on `stream` of `device`; returns
// cudaGetLastError().
int vt_hll_stats(const uint8_t* regs, float* ez, float* zsum, int K, int m,
                 int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  hll_stats_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(regs, ez,
                                                             zsum, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
