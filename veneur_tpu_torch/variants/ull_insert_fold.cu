// UltraLogLog scatter-join insert with a warp-level pre-join: a variant
// of csrc/ull_insert.cu, kept to be timed against it, not built into the
// kernel library. `python3 ull_insert_fold.py` builds both and compares
// their device times and bytes on the same batches.
//
// It computes what csrc/ull_insert.cu computes (see there for the key
// and the join), with the same C entry vt_ull_insert. Where csrc's
// kernel runs one CAS loop per update, this one folds the updates of a
// warp that land on one 32-bit word into one 4-byte image first and runs
// one CAS loop a word. On the H100 that wins only where many distinct
// values crowd one word; on random, hashed and hot-member batches the
// vote, the match and the fold cost more than the CAS loops they save.
//
// What bounds it on the H100: latency, not bytes. The bytes that must
// move are the update arrays (9 bytes an update) and the touched words
// (read and written, 8 bytes at most an update): ~2.2 MB for a landing
// of 131072 updates, ~0.7 us at 3.35 TB/s, below one launch. What costs
// time is each update's dependent chain (load the update, load its
// word, compare-and-swap the word) and, where updates share a word, the
// CAS retries that serialise them at L2. The design:
//
// - One update a thread, in a grid-stride loop over the SMs' resident
//   CTAs, so that every update's chain runs beside the others'. (Four
//   updates a thread, with 16-byte loads and every word read and first
//   CAS in flight before any retry, measured slower on the H100 on
//   random batches, where updates rarely share a word.)
// - One CAS loop per distinct word of a warp where a warp's lanes crowd
//   one word. A shuffle compares each lane's word with its neighbour's;
//   where no neighbours match (the rule for random traffic) every live
//   lane joins its own byte. Otherwise the warp groups its lanes by word
//   (__match_any_sync), and the live lanes whose word another lane also
//   holds fold, in one round per distinct register among them (a second
//   match finds each register's lowest lane): full-warp reductions over
//   a predicate give the closed form of the join of the register's
//   values (qm = the largest q, b1 / b2 = whether any value proves qm-1 /
//   qm-2, as the plain version `_insert_impl` computes it), and the lanes
//   of its word OR that byte into a 4-byte image with a mask of the bytes
//   present, so the four bytes of one word may come from four registers.
//   A round is a shuffle and three reductions and waits on no other
//   round. The word's lowest lane then joins the image into the word,
//   byte by byte, so a run of updates on one word costs one CAS loop a
//   warp instead of one an update (on the H100, one CAS loop an update
//   measured an order of magnitude slower on 131072 updates on one
//   word).
// - Each CAS loop stops without writing when the word already absorbs
//   the image. Every lane calls each warp intrinsic with the full mask
//   (the loop bound is uniform over the CTA, and no intrinsic sits
//   behind a condition that differs between lanes); an update that is
//   not live, or past n, carries the key 0xFFFFFFFF, which no live word
//   (< 2^30) or register (flat < K*m <= 2^32 - 1) has.
//
// The join is associative and commutative over all 256 byte values, so
// the fold, the order of the groups and the order of the CAS loops leave
// the bytes of the plain version (exact, not up to rounding). A stale
// read of a word only costs a retry: memory moves only by joins, so a
// byte that already absorbs the image in a stale value absorbs it in the
// current one. Its caller guarantees a 4-byte aligned base and m % 4
// == 0 (as kernels/ull_insert.py does for csrc's kernel), so a word
// never straddles two rows or the end of the bank.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kDead = 0xFFFFFFFFu;

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

// The word with the bytes of `image` named by `present` joined in.
__device__ __forceinline__ unsigned int joined(unsigned int old,
                                               uint32_t image,
                                               uint32_t present) {
  unsigned int upd = old;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int sh = 8 * b;
    if ((present >> sh) & 0xFFu) {
      const uint32_t j = ull_join((old >> sh) & 0xFFu, (image >> sh) & 0xFFu);
      upd = (upd & ~(0xFFu << sh)) | (j << sh);
    }
  }
  return upd;
}

__global__ void __launch_bounds__(kThreads)
ull_insert_kernel(uint8_t* __restrict__ regs,
                  const int32_t* __restrict__ slots,
                  const int32_t* __restrict__ idx,
                  const uint8_t* __restrict__ vals, int n, uint32_t total,
                  uint32_t m) {
  const int lane = threadIdx.x & 31;
  for (long long base = (long long)blockIdx.x * kThreads; base < n;
       base += (long long)gridDim.x * kThreads) {
    const long long i = base + threadIdx.x;
    const int s = i < n ? slots[i] : -1;
    const uint32_t c = i < n ? (uint32_t)idx[i] : 0u;
    const uint32_t v = i < n ? vals[i] : 0u;
    const uint32_t flat = (uint32_t)s * m + c;
    const bool live = s >= 0 && flat < total;
    const int sh = (int)(flat & 3u) * 8;
    const uint32_t wkey = live ? flat >> 2 : kDead;

    // group by word only where a lane's neighbour holds its word
    const uint32_t next = __shfl_sync(kFull, wkey, (lane + 1) & 31);
    const unsigned wpeers = __any_sync(kFull, live && wkey == next)
                                ? __match_any_sync(kFull, wkey)
                                : 1u << lane;
    // live lanes whose word another lane of the warp also holds
    const unsigned shared = __ballot_sync(kFull, live && __popc(wpeers) > 1);
    uint32_t image = v << sh, present = 0xFFu << sh;
    if (shared) {  // warp-uniform: every lane runs the reductions below
      const bool mine = (shared >> lane) & 1u;
      const unsigned rpeers = __match_any_sync(kFull, mine ? flat : kDead);
      const int q = (int)(v >> 2);
      if (mine) image = present = 0u;
      // one round per distinct register among the sharing lanes, led by
      // its lowest lane: the closed form of the join of its values
      for (unsigned heads =
               __ballot_sync(kFull, mine && __ffs(rpeers) - 1 == lane);
           heads; heads &= heads - 1) {
        const uint32_t key = __shfl_sync(kFull, flat, __ffs(heads) - 1);
        const bool in = mine && flat == key;
        const int qm = (int)__reduce_max_sync(kFull, in ? (unsigned)q : 0u);
        const unsigned b1 = __reduce_or_sync(kFull, in && proves(v, q, qm - 1));
        const unsigned b2 = __reduce_or_sync(kFull, in && proves(v, q, qm - 2));
        if (mine && (flat >> 2) == (key >> 2)) {
          const int ksh = (int)(key & 3u) * 8;
          image |= (qm > 0 ? ((uint32_t)qm << 2) | (b1 << 1) | b2 : 0u)
                   << ksh;
          present |= 0xFFu << ksh;
        }
      }
    }
    if (!live || __ffs(wpeers) - 1 != lane) continue;

    unsigned int* word =
        reinterpret_cast<unsigned int*>(regs + (size_t)(flat >> 2) * 4);
    unsigned int old = *reinterpret_cast<volatile unsigned int*>(word);
    while (true) {
      const unsigned int upd = joined(old, image, present);
      if (upd == old) break;
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
  if (n <= 0) return (int)cudaSuccess;
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ull_insert_kernel, kThreads, 0);
  if (occ != cudaSuccess) return (int)occ;
  const long long tiles = ((long long)n + kThreads - 1) / kThreads;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(tiles < most ? tiles : most);
  ull_insert_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      regs, slots, idx, vals, n, (uint32_t)((uint64_t)K * (uint64_t)m),
      (uint32_t)m);
  return (int)cudaGetLastError();
}

}  // extern "C"
