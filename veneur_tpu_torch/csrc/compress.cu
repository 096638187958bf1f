// Fused t-digest compress for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel veneur_tpu/kernels/compress.py:fused_compress
// (body _compress_kernel, networks _bitonic_sort / _bitonic_merge /
// _cmp_swap, numeric tail ops/tdigest.py:_cluster_tail). Per row of
// [K, C] centroids plus a [K, B] sample buffer it computes:
//   1. canonical u32 keys (+-0 folded, empties keyed +inf with weight 0);
//   2. a sort of the buffer run by (key, lane);
//   3. the bitonic rank-merge of veneur_tpu/ops/tdigest.py
//      _merge_sorted_runs over [prefix | pads | reversed buffer];
//   4. cumulative weight and weighted value in float64, in the blocked
//      order that ops/tdigest.py:_blocked_cumsum defines;
//   5. k1 in float64 (rounded to f32) and the greedy boundary recurrence;
//   6. cluster ids clipped to C-1, upper-bound searches for the cluster
//      ends, cumsum-diff segment sums, means, and the running-max clamp
//      that keeps the output an ordered run.
// The plain torch version is veneur_tpu_torch/ops/tdigest.py
// compress_plain; both evaluate the same float64 operations in the same
// order, so they agree bit for bit (build with -fmad=false so no
// multiply-add is contracted).
//
// What bounds it on the H100: by bytes, one read of (C+B)*2*4 B and one
// write of C*2*4 B per row (~60 us for 32768 rows at C=B=256 and 3.35
// TB/s); by operations, the float64 share (the sums, two k1 asin per
// element, the cluster tail) at the 34 TFLOP/s float64 rate plus the sort
// and merge at the f32 rate, which together weigh more than the bytes
// (chip_smoke.py compress_bound_ms counts both). In practice a row is a
// chain of dependent steps (loads, sort and merge stages, scans, the
// recurrence), so the design shortens the chain and keeps 8 rows in
// flight on each SM (8 x 256 threads, all the SM holds; 32 registers a
// thread) to hide what is left.
//
// Design: one CTA of 256 threads per row, the whole row in ~22 KB of
// shared memory (no intermediate touches device memory), and no phase
// walked by one thread:
//   - Sort and merge move one packed 64-bit word (key << 32 | tag) per
//     element; a single 64-bit compare is the lexicographic (key, tag)
//     order, and the values and weights are fetched by tag afterwards.
//     The buffer is tagged C + lane (the plain version tags C + sorted
//     position; the two agree on every comparison, since the buffer run
//     is sorted by (key, lane)).
//   - The buffer sort: every word is distinct, so any sort gives the
//     plain version's order. Each warp loads, keys and sorts runs of 32
//     words in registers (a bitonic network over shuffles); then each
//     merge level puts every word at its index in its run plus the count
//     of smaller words in the partner run (a binary search),
//     log2(B / 32) levels with one barrier each. The last level writes
//     the run reversed at the tail of the merge array, which is the order
//     the merge wants.
//   - The merge network is the plain version's, stage for stage (a prefix
//     that breaks the ordering invariant, as a NaN-poisoned row's can, is
//     merged as the network merges it). Stages of distance >= 64 run in
//     shared memory with a barrier each; those of distance <= 32 pair
//     words inside one 64-word block, so each warp takes whole blocks
//     into registers (lane l holds positions l and l + 32) and runs them
//     with shuffles.
//   - The sums: the warp that ends the merge of a block forms the float64
//     terms of its 64 lanes; 8 of its lanes sum the block's 4 chunks of
//     16 lanes of each quantity sequentially (the arrays are padded one
//     slot a chunk so those lanes hit distinct banks); one thread in each
//     of two warps scans the chunk totals (32 at M = 512); the offsets are
//     added chunk by chunk. That is the order of
//     ops/tdigest.py:_blocked_cumsum: cum stays non-decreasing for
//     non-negative weights, and the row total is the last offset.
//   - The greedy recurrence: lane j opens a cluster iff it is live and
//     kr[j] - ks > 1, and then ks = kl[j]. Once j is a boundary, what
//     follows in its 32-lane window no longer depends on ks, so each
//     warp first finds, for every live lane j of its windows, the next
//     lane of the window that would open a cluster after j (a shuffle
//     search), and from those links the chain of boundaries that follows
//     j (5 rounds of pointer doubling into a 32-bit mask). One warp then
//     walks the windows carrying ks: a ballot of (live && kr - ks > 1)
//     gives the window's first boundary, its chain mask gives all the
//     others, and ks takes kl of the mask's highest lane. That is the
//     sequential recurrence step for step, with no assumption on kr or on
//     where the dead lanes lie, in one ballot per window instead of one
//     step per lane, and it stops after the last window with a live lane.
//     Cluster ids come from the window masks and their running counts
//     (integer, exact).
//   - k1 runs in float64 at both edges of every live lane, but a lane's
//     left edge cum - w is as a rule the previous lane's cum, the same
//     double; there its k1 is the previous lane's kr and is not evaluated
//     again, which halves the asin work.
//   - The running max: a block scan whose combine is torch.cummax's step
//     (a NaN wins and sticks, so the last NaN's payload survives; a later
//     element equal to the running max replaces it, so +-0 keep
//     torch.cummax's bits). Folding a segment after a prefix equals one
//     combine of the prefix with the segment's own fold, so any scan tree
//     gives the sequential result.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows resident on one SM: 8 x 256 threads is the SM's 2048
constexpr int kMinBlocks = 8;
// lanes per chunk of the blocked float64 sums (ops/tdigest.py SUM_CHUNK)
constexpr int kSumChunk = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr double kPi = 3.14159265358979323846;
// k1 multiplies by 1/pi (the plain version's _INV_PI, the same double)
constexpr double kInvPi = 1.0 / kPi;

__device__ __forceinline__ uint32_t canon_key(float x) {
  if (x == 0.0f) x = 0.0f;
  uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ u64 pack(uint32_t key, uint32_t tag) {
  return ((u64)key << 32) | tag;
}

// the merge word at position t < P - B, below the buffer run: prefix lane
// t, then pads keyed above every real key and tagged past every real tag
__device__ __forceinline__ u64 below_run(const float* sv, int t, int C,
                                         int M) {
  return t < C ? pack(canon_key(sv[t]), t) : pack(0xFFFFFFFFu, M + (t - C));
}

__device__ __forceinline__ double k1(double q, double compression) {
  q = q < 0.0 ? 0.0 : (q > 1.0 ? 1.0 : q);
  return compression * (asin(2.0 * q - 1.0) + kPi / 2.0) * kInvPi;
}

// one step of torch.cummax: fold x into the running max
__device__ __forceinline__ float cummax_step(float run, float x) {
  return (isnan(x) || (!isnan(run) && x >= run)) ? x : run;
}

// Index of lane e in the per-lane arrays (ws, cum, cwv): one slot of
// padding after every chunk, so the lanes that sum neighbouring chunks
// hit distinct banks.
__host__ __device__ __forceinline__ int padded(int e) {
  return e + e / kSumChunk;
}

__host__ __device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// compare-exchange with the lane j away: take the partner's word where it
// is the larger and this lane keeps the larger, or it is not and this lane
// keeps the smaller
__device__ __forceinline__ u64 exchange(u64 v, int j, bool keep_max) {
  const u64 o = __shfl_xor_sync(kFull, v, j);
  return (o > v) == keep_max ? o : v;
}

// the 32 words of a warp (one a lane) sorted ascending across the lanes
__device__ __forceinline__ u64 warp_sort(u64 x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j >= 1; j >>= 1)
      x = exchange(x, j, ((lane & j) != 0) == ((lane & k) == 0));
  }
  return x;
}

// how many of the n ascending words a[0..n) (n a power of two) are below x
__device__ __forceinline__ int count_below(const u64* a, int n, u64 x) {
  int pos = 0;
  for (int step = n >> 1; step > 0; step >>= 1)
    if (a[pos + step - 1] < x) pos += step;
  return pos + (a[pos] < x ? 1 : 0);
}

// Stages j = jtop..1 (jtop <= 32) of the ascending merge network on one
// 64-word block in registers: v0 at position base + lane, v1 at base +
// lane + 32. A stage of distance 32 pairs a lane's own two words.
__device__ __forceinline__ void merge_stages(u64& v0, u64& v1, int lane,
                                             int jtop) {
#pragma unroll
  for (int j = 32; j >= 1; j >>= 1) {
    if (j > jtop) continue;
    if (j == 32) {
      const u64 lo = v0 < v1 ? v0 : v1;
      v1 = v0 < v1 ? v1 : v0;
      v0 = lo;
    } else {
      const bool upper = (lane & j) != 0;
      v0 = exchange(v0, j, upper);
      v1 = exchange(v1, j, upper);
    }
  }
}

// One shared-memory stage of distance j of the ascending merge network
// over n words.
__device__ __forceinline__ void merge_stage(u64* a, int n, int j, int tid) {
  for (int p = tid; p < (n >> 1); p += kThreads) {
    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const u64 x = a[i], y = a[i + j];
    if (x > y) {
      a[i] = y;
      a[i + j] = x;
    }
  }
}

// Byte offsets of one row's shared arrays. The buffer sort's two runs
// share the region of the sums, which are written after it; the merge
// words are dead once the sums have read their tags, and the values and
// weights by concatenation index once the sums have gathered them, so
// kl/kr reuse the words and the boundary chains, cluster ids and ends
// reuse the values and weights.
struct Layout {
  size_t cum, cwv, off, tot, run_a, run_b, words, kl, kr, sv, sw, chain,
      cluster, ends, ws, winmask, winbase, warp, wc, mc, bytes;

  __host__ __device__ Layout(int C, int B) {
    const int M = C + B, P = next_pow2(M), Pb = next_pow2(B);
    const int L = (M + kSumChunk - 1) / kSumChunk, W = (M + 31) / 32;
    const size_t Mp = (size_t)padded(M - 1) + 1;
    size_t o = 0;
    cum = o;      o += Mp * 8;
    // cwv's chunks start 8 banks after cum's
    cwv = (o + 127) / 128 * 128 + 32;
    o = cwv + Mp * 8;
    off = o;      o += (size_t)(L + 1) * 2 * 8;
    tot = o;      o += (size_t)L * 2 * 8;
    run_a = 0;
    run_b = (size_t)Pb * 8;
    if (o < 2 * run_b) o = 2 * run_b;
    words = o;    o += (size_t)P * 8;
    kl = words;  // k1 left edge at each chain's last boundary
    kr = words + (size_t)M * 4;
    sv = o;       o += (size_t)M * 4;
    sw = o;       o += (size_t)M * 4;
    chain = sv;
    cluster = sv;
    ends = sw;
    ws = o;       o += Mp * 4;
    winmask = o;  o += (size_t)W * 4;
    winbase = o;  o += (size_t)W * 4;
    warp = o;     o += (size_t)kWarps * 4;
    wc = o;       o += (size_t)C * 4;
    mc = o;       o += (size_t)C * 4;
    bytes = o;
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
compress_kernel(const float* __restrict__ mean,
                const float* __restrict__ weight,
                const float* __restrict__ buf_value,
                const float* __restrict__ buf_weight,
                float* __restrict__ out_mean, float* __restrict__ out_weight,
                int C, int B, double compression) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = C + B, P = next_pow2(M), Pb = next_pow2(B);
  const int L = (M + kSumChunk - 1) / kSumChunk;
  const Layout lay(C, B);
  double* cum = reinterpret_cast<double*>(smem + lay.cum);
  double* cwv = reinterpret_cast<double*>(smem + lay.cwv);
  double* off_w = reinterpret_cast<double*>(smem + lay.off);
  double* off_wv = off_w + (L + 1);
  double* tot_w = reinterpret_cast<double*>(smem + lay.tot);
  double* tot_wv = tot_w + L;
  u64* run_a = reinterpret_cast<u64*>(smem + lay.run_a);
  u64* run_b = reinterpret_cast<u64*>(smem + lay.run_b);
  u64* words = reinterpret_cast<u64*>(smem + lay.words);
  float* kl = reinterpret_cast<float*>(smem + lay.kl);
  float* kr = reinterpret_cast<float*>(smem + lay.kr);
  float* sv = reinterpret_cast<float*>(smem + lay.sv);
  float* sw = reinterpret_cast<float*>(smem + lay.sw);
  unsigned* chain = reinterpret_cast<unsigned*>(smem + lay.chain);
  int* cluster = reinterpret_cast<int*>(smem + lay.cluster);
  int* ends = reinterpret_cast<int*>(smem + lay.ends);
  float* ws = reinterpret_cast<float*>(smem + lay.ws);
  unsigned* winmask = reinterpret_cast<unsigned*>(smem + lay.winmask);
  int* winbase = reinterpret_cast<int*>(smem + lay.winbase);
  float* warp_run = reinterpret_cast<float*>(smem + lay.warp);
  float* wc = reinterpret_cast<float*>(smem + lay.wc);
  float* mc = reinterpret_cast<float*>(smem + lay.mc);
  __shared__ uint32_t last_tag;
  __shared__ float kl0;
  __shared__ int live_windows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float inf = __int_as_float(0x7f800000);

  // 1. load the prefix: values (empties +inf) and weights by
  //    concatenation index t. Both loads of a lane are issued before
  //    either is used.
  if (tid == 0) live_windows = 0;
  for (int t = tid; t < C; t += kThreads) {
    const float w = weight[row * C + t];
    const float m = mean[row * C + t];
    sv[t] = w > 0.0f ? m : inf;
    sw[t] = w;
  }

  // 2. the buffer run: each warp loads runs of 32 lanes (buffer lane j ->
  //    concatenation index C + j), keys them (pads above every real key)
  //    and sorts each run in registers. After a barrier [prefix | pads] is
  //    laid out below the run, and each merge level puts every word at its
  //    index in its run plus the count of smaller words in the partner
  //    run; the last level writes the run descending into
  //    words[P - Pb, P), where a run of at most 32 goes directly
  for (int r = warp; r < (Pb + 31) / 32; r += kWarps) {
    const int j = 32 * r + lane;
    u64 x = ~0ull;
    if (j < B) {
      const float w = buf_weight[row * B + j];
      const float value = buf_value[row * B + j];
      const float v = w > 0.0f ? value : inf;
      sv[C + j] = v;
      sw[C + j] = w;
      x = pack(canon_key(v), C + j);
    } else if (j < Pb) {
      x = pack(0xFFFFFFFFu, C + j);
    }
    x = warp_sort(x, lane);
    if (j < Pb) {
      if (Pb <= 32)
        words[P - 1 - j] = x;
      else
        run_a[j] = x;
    }
  }
  __syncthreads();
  for (int t = tid; t < P - Pb; t += kThreads)
    words[t] = below_run(sv, t, C, M);
  {
    const u64* src = run_a;
    u64* dst = run_b;
    for (int w = 32; w < Pb; w <<= 1) {
      for (int i = tid; i < Pb; i += kThreads) {
        const u64 x = src[i];
        const int base = i & ~(2 * w - 1);
        const int partner = base + ((i & w) ? 0 : w);
        const int pos =
            base + (i & (w - 1)) + count_below(src + partner, w, x);
        if (2 * w == Pb)
          words[P - 1 - pos] = x;
        else
          dst[pos] = x;
      }
      __syncthreads();
      const u64* t = src;
      src = dst;
      dst = const_cast<u64*>(t);
    }
    if (Pb <= 32) __syncthreads();
  }

  // 3. the merge network over [prefix | pads | reversed buffer run], once
  //    the words below the run are laid over its own pads (the sort leaves
  //    those ahead of its real words, where P - Pb < C puts prefix lanes).
  //    A prefix that breaks the ordering invariant (a NaN-poisoned row)
  //    can leave a pad among the first M lanes; the plain version then
  //    reads the largest buffer element there, whose tag is kept here
  if (tid == 0) last_tag = (uint32_t)words[P - B];
  if (Pb != B) {
    for (int t = P - Pb + tid; t < P - B; t += kThreads)
      words[t] = below_run(sv, t, C, M);
    __syncthreads();
  }
  for (int j = P >> 1; j >= 64; j >>= 1) {
    merge_stage(words, P, j, tid);
    __syncthreads();
  }

  // 4. the merge's last stages in registers, a warp a 64-word block; the
  //    float64 terms of the block's lanes; then lanes 0-3 sum the block's
  //    four chunks of weight terms in place and lanes 4-7 those of
  //    weighted values. One thread a quantity then scans the chunk totals;
  //    the offsets are added in 5
  {
    const int jtop = (P >> 1) < 32 ? (P >> 1) : 32;
    for (int b = warp; b < (P + 63) / 64; b += kWarps) {
      const int e0 = 64 * b + lane;
      u64 v[2] = {e0 < P ? words[e0] : ~0ull,
                  e0 + 32 < P ? words[e0 + 32] : ~0ull};
      merge_stages(v[0], v[1], lane, jtop);
      for (int s = 0; s < 2; ++s) {
        const int e = e0 + 32 * s;
        if (e < M) {
          uint32_t t = (uint32_t)v[s];
          if (t >= (uint32_t)M) t = last_tag;
          const float w = sw[t];
          const float x = sv[t];
          const double w64 = (double)w;
          ws[padded(e)] = w;
          cum[padded(e)] = w64;
          cwv[padded(e)] = w64 * (w > 0.0f ? (double)x : 0.0);
        }
      }
      __syncwarp();
      if (lane < 8) {
        const int lo = 64 * b + kSumChunk * (lane & 3);
        double* a = (lane < 4 ? cum : cwv) + padded(lo);
        const int n = M - lo;
        double run = 0.0;
#pragma unroll
        for (int i = 0; i < kSumChunk; ++i) {
          if (i < n) {
            run = run + a[i];
            a[i] = run;
          }
        }
        if (n > 0) (lane < 4 ? tot_w : tot_wv)[lo / kSumChunk] = run;
      }
    }
  }
  __syncthreads();
  if (tid == 0 || tid == 32) {
    const double* tot = tid == 0 ? tot_w : tot_wv;
    double* off = tid == 0 ? off_w : off_wv;
    double o = 0.0;
    off[0] = o;
    for (int j = 0; j < L; j += 4) {
      double t4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) t4[u] = j + u < L ? tot[j + u] : 0.0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j + u < L) {
          o = o + t4[u];
          off[j + u + 1] = o;
        }
      }
    }
  }
  __syncthreads();

  // 5. the offsets, and k1 at each lane's right edge (float64, then
  //    rounded; needed at live lanes and at lane 0)
  const double total = off_w[L];  // = cum[M - 1]
  const double safe = total > 0.0 ? total : 1.0;
  for (int e = tid; e < M; e += kThreads) {
    const int c = e / kSumChunk, pe = padded(e);
    const double ce = off_w[c] + cum[pe];
    cum[pe] = ce;
    cwv[pe] = off_wv[c] + cwv[pe];
    kr[e] = ws[pe] > 0.0f || e == 0 ? (float)k1(ce / safe, compression)
                                    : 0.0f;
  }
  __syncthreads();

  //    per 32-lane window: k1 at each live lane's left edge, each live
  //    lane's link to the next lane that would open a cluster after it,
  //    and the chain of boundaries that follows it. Where cum - w is the
  //    previous lane's cum exactly (the usual case: a float64 sum of f32
  //    weights rounds nowhere), the left edge is the same double as that
  //    lane's right edge, so its k1 is that lane's kr; only the other
  //    lanes evaluate k1 again
  {
    for (int b = warp; b < (M + 63) / 64; b += kWarps) {
      for (int s = 0; s < 2; ++s) {
        const int e = 64 * b + 32 * s + lane;
        bool live = false;
        float kre = 0.0f, kle = 0.0f;
        if (e < M) {
          const int pe = padded(e);
          const float w = ws[pe];
          live = w > 0.0f;
          kre = kr[e];
          if (live || e == 0) {
            const double left = cum[pe] - (double)w;
            const int pp = padded(e - 1);
            if (e > 0 && (ws[pp] > 0.0f || e == 1) && left == cum[pp])
              kle = kr[e - 1];
            else
              kle = (float)k1(left / safe, compression);
          }
        }
        // live lanes after this one, lowest first (none for a dead lane)
        const unsigned livem = __ballot_sync(kFull, live);
        if (lane == 0 && livem) atomicMax(&live_windows, 2 * b + s + 1);
        const unsigned after = live ? (livem >> lane) >> 1 : 0u;
        int next = 32;
        for (int d = 1; d < 32; ++d) {
          const float krd = __shfl_down_sync(kFull, kre, d);
          if (next == 32 && ((after >> (d - 1)) & 1u) && krd - kle > 1.0f)
            next = lane + d;
          if (__all_sync(kFull, next < 32 || (after >> d) == 0u)) break;
        }
        unsigned mask = live ? 1u << lane : 0u;
        int p = live ? next : 32;
        for (int r = 0; r < 5; ++r) {
          const unsigned mp = __shfl_sync(kFull, mask, p & 31);
          const int pp = __shfl_sync(kFull, p, p & 31);
          if (p < 32) {
            mask |= mp;
            p = pp;
          }
        }
        // kl at the chain's last boundary: ks after the window when the
        // chain is the one ks enters
        const float exit_kl =
            __shfl_sync(kFull, kle, mask ? 31 - __clz(mask) : lane);
        if (e == 0) kl0 = kle;
        if (e < M) {
          kl[e] = exit_kl;
          chain[e] = mask;
        }
      }
    }
  }
  __syncthreads();

  //    the walk: one warp, one ballot a window (a live lane's chain holds
  //    its own bit, so chain != 0 is the live test); the entry lane's
  //    chain is the window's boundaries and its exit kl the next ks
  if (warp == 0) {
    float ks = kl0 - 2.0f;
    int run = 0;
    float kr_n = lane < M ? kr[lane] : 0.0f;
    float kl_n = lane < M ? kl[lane] : 0.0f;
    unsigned ch_n = lane < M ? chain[lane] : 0u;
    const int nw = live_windows;  // the walk stops after the last live lane
    for (int w = 0; w < nw; ++w) {
      const float kri = kr_n, kli = kl_n;
      const unsigned ch = ch_n;
      const int i = 32 * (w + 1) + lane;
      kr_n = i < M ? kr[i] : 0.0f;
      kl_n = i < M ? kl[i] : 0.0f;
      ch_n = i < M ? chain[i] : 0u;
      const unsigned first =
          __ballot_sync(kFull, ch != 0u && kri - ks > 1.0f);
      unsigned found = 0u;
      if (first != 0u) {
        const int entry = __ffs(first) - 1;
        found = __shfl_sync(kFull, ch, entry);
        ks = __shfl_sync(kFull, kli, entry);
      }
      if (lane == 0) {
        winmask[w] = found;
        winbase[w] = run;
      }
      run += __popc(found);
    }
  }
  __syncthreads();
  for (int i = tid; i < M; i += kThreads) {
    int c = C - 1;
    if (ws[padded(i)] > 0.0f) {
      const int w = i >> 5;
      c = winbase[w] + __popc(winmask[w] & ((2u << (i & 31)) - 1u)) - 1;
      c = c < 0 ? 0 : (c > C - 1 ? C - 1 : c);
    }
    cluster[i] = c;
  }
  __syncthreads();

  // 6. cluster ends: upper bound of each id in the id row (the binary
  //    search of torch.searchsorted, which the plain version calls)
  for (int t = tid; t < C; t += kThreads) {
    int lo = 0, hi = M;
    while (lo < hi) {
      int mid = lo + ((hi - lo) >> 1);
      if (!(cluster[mid] > t)) lo = mid + 1; else hi = mid;
    }
    ends[t] = lo;
  }
  __syncthreads();
  for (int t = tid; t < C; t += kThreads) {
    int e = ends[t], ep = t > 0 ? ends[t - 1] : 0;
    double w_up = e > 0 ? cum[padded(e - 1)] : 0.0;
    double w_prev = ep > 0 ? cum[padded(ep - 1)] : 0.0;
    double wv_up = e > 0 ? cwv[padded(e - 1)] : 0.0;
    double wv_prev = ep > 0 ? cwv[padded(ep - 1)] : 0.0;
    double w64 = w_up - w_prev;
    double wv64 = wv_up - wv_prev;
    float w = (float)w64;
    double m64 = wv64 / (w64 > 0.0 ? w64 : 1.0);
    wc[t] = w;
    mc[t] = w > 0.0f ? (float)m64 : 0.0f;
    out_weight[row * C + t] = w;
  }
  __syncthreads();

  //    running max over the positive-weight means: a block scan of
  //    cummax_step in tiles of kThreads lanes, carried across tiles
  float carry = -inf;
  for (int base = 0; base < C; base += kThreads) {
    const int t = base + tid;
    const bool pos = t < C && wc[t] > 0.0f;
    float x = pos ? mc[t] : -inf;
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = cummax_step(y, x);
    }
    if (lane == 31) warp_run[warp] = x;
    __syncthreads();
    float pre = carry;
    for (int w = 0; w < warp; ++w) pre = cummax_step(pre, warp_run[w]);
    x = cummax_step(pre, x);
    if (t < C) out_mean[row * C + t] = pos ? x : 0.0f;
    for (int w = 0; w < kWarps; ++w) carry = cummax_step(carry, warp_run[w]);
    __syncthreads();
  }
}

// The kernel's attributes for `smem` bytes of dynamic shared memory a
// CTA: the opt-in above 48 KB, and the largest shared-memory carveout, so
// that a launch gets the CTAs per SM the occupancy calculator reports.
cudaError_t set_attributes(size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        compress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  return cudaFuncSetAttribute(compress_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

// Shared memory one row needs, in bytes (the wrapper checks it against
// the card's per-block limit).
size_t vt_compress_smem_bytes(int C, int B) { return Layout(C, B).bytes; }

// Rows of C + B lanes that one SM of `device` holds at once (CTAs per SM
// at this shared-memory size), or a negative CUDA error.
int vt_compress_blocks_per_sm(int C, int B, int device) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return -(int)guard.error();
  const size_t smem = Layout(C, B).bytes;
  const cudaError_t set = set_attributes(smem);
  if (set != cudaSuccess) return -(int)set;
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, compress_kernel, kThreads, smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

// One launch over K rows (a CTA a row) on `stream` of `device`; returns
// cudaGetLastError().
int vt_compress(const float* mean, const float* weight,
                const float* buf_value, const float* buf_weight,
                float* out_mean, float* out_weight, int K, int C, int B,
                double compression, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const size_t smem = Layout(C, B).bytes;
  const cudaError_t set = set_attributes(smem);
  if (set != cudaSuccess) return (int)set;
  compress_kernel<<<K, kThreads, smem, (cudaStream_t)stream>>>(
      mean, weight, buf_value, buf_weight, out_mean, out_weight, C, B,
      compression);
  return (int)cudaGetLastError();
}

}  // extern "C"
