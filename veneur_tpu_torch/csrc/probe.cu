// Availability probe for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas probe veneur_tpu/kernels/__init__.py:probe_interpret:
// out = x + 1 over a small f32 tensor. It computes nothing of the
// system; a caller launches it before the real kernels to learn whether
// the built library loads and runs on this card. One thread per element;
// bound by launch latency (8 KiB moved at [8, 128]).

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

__global__ void probe_kernel(const float* __restrict__ x,
                             float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" {

// One launch over n elements on `stream` of `device`; returns
// cudaGetLastError().
int vt_probe(const float* x, float* out, int n, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
