// UltraLogLog scatter-join insert for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel veneur_tpu/kernels/ull_insert.py:fused_insert
// (body _insert_kernel). For each update i of a batch it joins vals[i]
// into the register byte registers[slots[i], idx[i]] of a u8[K, m] bank,
// in place; the join is the ULL lattice join of
// veneur_tpu/sketches/ull.py:_join_i32. As in the JAX insert, an update
// is keyed by the uint32 flat index (uint32(slot) * m + uint32(idx)) mod
// 2^32 of the row-major bank and is live iff slot >= 0 and the index is
// below K*m: slot -1 is padding, and an index outside [0, m) lands in a
// neighbouring row's register while that is inside the bank. The wrapper
// refuses a bank of 2^32 registers or more, which that key cannot name.
//
// Design: one thread per update in a grid-stride loop. The byte address
// is the flat index, widened to 64 bits for the pointer arithmetic.
// A byte has no atomic of its own, so the thread runs an atomicCAS loop
// on the aligned 32-bit word that holds it: take the byte lane, join,
// stop when the join equals the current byte (the join is idempotent, so
// nothing needs writing), else CAS the word with the lane replaced and
// retry on the value the CAS returns. The join is associative,
// commutative and idempotent, so whatever order the updates land in, the
// bytes equal the plain version's (exact, not up to rounding). The
// wrapper guarantees a 4-byte aligned base and m % 4 == 0, so a word
// never straddles two rows or the end of the bank.
//
// What bounds it on the H100: latency, not bytes. The bytes that must
// move are the update arrays (9 bytes an update) and the touched words
// (read and written, 8 bytes at most an update): ~2.2 MB for the
// engine's landing of 131072 updates, ~0.7 us at 3.35 TB/s, below one
// launch. The engine lands set updates in batches of up to 131072
// (models/pipeline.py:_SetLanding), so few launches carry many updates.
// Contention (one hot register, or neighbouring registers of one word)
// makes the CAS retry; it costs time, never correctness. A hot member
// repeats one value, which the loop absorbs without writing. A variant
// that pre-joins a warp's updates on one word before one CAS loop a word
// (variants/ull_insert_fold.cu) wins only where many distinct values
// crowd one word, and is slower on random, hashed and hot-member
// batches; ull_insert_fold.py times both.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

// does register x (max q) prove an event at level k >= 1?
__device__ __forceinline__ bool proves(uint32_t x, int q, int k) {
  return q >= 1 && k >= 1 &&
         (q == k || (q == k + 1 && ((x >> 1) & 1u)) ||
          (q == k + 2 && (x & 1u)));
}

__device__ __forceinline__ uint32_t ull_join(uint32_t u, uint32_t v) {
  const int qu = (int)(u >> 2), qv = (int)(v >> 2);
  const int qm = qu > qv ? qu : qv;
  if (qm == 0) return 0u;
  const uint32_t b1 = proves(u, qu, qm - 1) || proves(v, qv, qm - 1);
  const uint32_t b2 = proves(u, qu, qm - 2) || proves(v, qv, qm - 2);
  return ((uint32_t)qm << 2) | (b1 << 1) | b2;
}

__global__ void __launch_bounds__(kThreads)
ull_insert_kernel(uint8_t* __restrict__ regs,
                  const int32_t* __restrict__ slots,
                  const int32_t* __restrict__ idx,
                  const uint8_t* __restrict__ vals, int n, int K, int m) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int s = slots[i];
    if (s < 0) continue;
    const uint32_t flat = (uint32_t)s * (uint32_t)m + (uint32_t)idx[i];
    if ((uint64_t)flat >= (uint64_t)K * (uint64_t)m) continue;
    const size_t addr = flat;
    unsigned int* word =
        reinterpret_cast<unsigned int*>(regs + (addr & ~(size_t)3));
    const int shift = (int)(addr & 3) * 8;
    const uint32_t v = vals[i];
    unsigned int old = *reinterpret_cast<volatile unsigned int*>(word);
    while (true) {
      const uint32_t cur = (old >> shift) & 0xFFu;
      const uint32_t j = ull_join(cur, v);
      if (j == cur) break;
      const unsigned int upd = (old & ~(0xFFu << shift)) | (j << shift);
      const unsigned int prev = atomicCAS(word, old, upd);
      if (prev == old) break;
      old = prev;
    }
  }
}

}  // namespace

extern "C" {

// One launch over a batch of n updates on `stream` of `device`; returns
// cudaGetLastError().
int vt_ull_insert(uint8_t* regs, const int32_t* slots, const int32_t* idx,
                  const uint8_t* vals, int n, int K, int m, int device,
                  void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  ull_insert_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      regs, slots, idx, vals, n, K, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
