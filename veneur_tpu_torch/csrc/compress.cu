// Fused t-digest compress for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel veneur_tpu/kernels/compress.py:fused_compress
// (body _compress_kernel, networks _bitonic_sort / _bitonic_merge /
// _cmp_swap, numeric tail ops/tdigest.py:_cluster_tail). Per row of
// [K, C] centroids plus a [K, B] sample buffer it computes:
//   1. canonical u32 keys (+-0 folded, empties keyed +inf with weight 0);
//   2. a bitonic sort of the buffer run by (key, lane);
//   3. the bitonic rank-merge of veneur_tpu/ops/tdigest.py
//      _merge_sorted_runs over [prefix | pads | reversed buffer], carrying
//      the payloads — every (key, tag) pair is distinct, so the order is
//      the unique one the plain version's stable sort gives;
//   4. cumulative weight and weighted value in float64, in lane order;
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
// write of C*2*4 B per row (~6 KiB a row at C=B=256, ~60 us for 32768
// rows at 3.35 TB/s). This first design is far from that: one CTA per
// row keeps the whole row in shared memory (no intermediate touches
// device memory, as on the TPU), the two networks run on all 256
// threads, but the prefix sums, the greedy recurrence and the running
// max are walked by one thread, which serialises ~3*M dependent steps
// per row. Making those steps parallel (a block scan for the sums, a
// warp-level formulation of the recurrence) is the route to the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr double kPi = 3.14159265358979323846;
// k1 multiplies by 1/pi (the plain version's _INV_PI, the same double)
constexpr double kInvPi = 1.0 / kPi;

__device__ __forceinline__ uint32_t canon_key(float x) {
  if (x == 0.0f) x = 0.0f;
  uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ bool greater(uint32_t ka, uint32_t ta,
                                        uint32_t kb, uint32_t tb) {
  return ka > kb || (ka == kb && ta > tb);
}

__device__ __forceinline__ void swap_lanes(uint32_t* key, uint32_t* tag,
                                           float* val, float* wt, int a,
                                           int b) {
  uint32_t k = key[a]; key[a] = key[b]; key[b] = k;
  uint32_t t = tag[a]; tag[a] = tag[b]; tag[b] = t;
  float v = val[a]; val[a] = val[b]; val[b] = v;
  float w = wt[a]; wt[a] = wt[b]; wt[b] = w;
}

__device__ __forceinline__ double k1(double q, double compression) {
  q = q < 0.0 ? 0.0 : (q > 1.0 ? 1.0 : q);
  return compression * (asin(2.0 * q - 1.0) + kPi / 2.0) * kInvPi;
}

__host__ __device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int C, int B) {
  int M = C + B, P = next_pow2(M), Pb = next_pow2(B);
  return (size_t)M * 2 * sizeof(double)       // cum, cwv
         + (size_t)P * 16 + (size_t)Pb * 16    // merge + buffer-sort lanes
         + (size_t)M * 2 * sizeof(float)       // k_left, k_right
         + (size_t)M * sizeof(int)             // cluster ids
         + (size_t)C * (sizeof(int) + 2 * sizeof(float));  // ends, w, mean
}

__global__ void __launch_bounds__(kThreads)
compress_kernel(const float* __restrict__ mean,
                const float* __restrict__ weight,
                const float* __restrict__ buf_value,
                const float* __restrict__ buf_weight,
                float* __restrict__ out_mean, float* __restrict__ out_weight,
                int C, int B, double compression) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = C + B, P = next_pow2(M), Pb = next_pow2(B), pad = P - M;
  double* cum = reinterpret_cast<double*>(smem);
  double* cwv = cum + M;
  uint32_t* key = reinterpret_cast<uint32_t*>(cwv + M);
  uint32_t* tag = key + P;
  float* val = reinterpret_cast<float*>(tag + P);
  float* wt = val + P;
  uint32_t* bkey = reinterpret_cast<uint32_t*>(wt + P);
  uint32_t* btag = bkey + Pb;
  float* bval = reinterpret_cast<float*>(btag + Pb);
  float* bwt = bval + Pb;
  float* kl = bwt + Pb;
  float* kr = kl + M;
  int* cluster = reinterpret_cast<int*>(kr + M);
  int* ends = cluster + M;
  float* wc = reinterpret_cast<float*>(ends + C);
  float* mc = wc + C;

  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const float inf = __int_as_float(0x7f800000);

  // 1. load: prefix lanes straight into the merge layout, buffer lanes
  //    into the sort workspace; empties are keyed +inf
  for (int i = tid; i < C; i += kThreads) {
    float w = weight[row * C + i];
    float v = w > 0.0f ? mean[row * C + i] : inf;
    key[i] = canon_key(v); tag[i] = i; val[i] = v; wt[i] = w;
  }
  for (int i = tid; i < pad; i += kThreads) {
    key[C + i] = 0xFFFFFFFFu; tag[C + i] = M + i; val[C + i] = 0.0f;
    wt[C + i] = 0.0f;
  }
  for (int j = tid; j < Pb; j += kThreads) {
    if (j < B) {
      float w = buf_weight[row * B + j];
      float v = w > 0.0f ? buf_value[row * B + j] : inf;
      bkey[j] = canon_key(v); btag[j] = j; bval[j] = v; bwt[j] = w;
    } else {  // pads: strictly largest (key, tag), sink to the tail
      bkey[j] = 0xFFFFFFFFu; btag[j] = j; bval[j] = 0.0f; bwt[j] = 0.0f;
    }
  }
  __syncthreads();

  // 2. bitonic sort of the buffer run by (key, lane)
  for (int k = 2; k <= Pb; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < Pb; i += kThreads) {
        int ixj = i ^ j;
        if (ixj > i) {
          bool asc = (i & k) == 0;
          if (greater(bkey[i], btag[i], bkey[ixj], btag[ixj]) == asc)
            swap_lanes(bkey, btag, bval, bwt, i, ixj);
        }
      }
      __syncthreads();
    }
  }

  // 3. the sorted buffer, reversed, closes the bitonic sequence; its
  //    tags are C + sorted position, as in _merge_sorted_runs
  for (int r = tid; r < B; r += kThreads) {
    int dst = P - 1 - r;
    key[dst] = bkey[r]; tag[dst] = C + r; val[dst] = bval[r];
    wt[dst] = bwt[r];
  }
  __syncthreads();
  for (int stride = P >> 1; stride >= 1; stride >>= 1) {
    for (int i = tid; i < P; i += kThreads) {
      if ((i & stride) == 0) {
        int hi = i + stride;
        if (greater(key[i], tag[i], key[hi], tag[hi]))
          swap_lanes(key, tag, val, wt, i, hi);
      }
    }
    __syncthreads();
  }

  // 4. float64 prefix sums in lane order (the plain version's order)
  if (tid == 0) {
    double c = 0.0, cv = 0.0;
    for (int i = 0; i < M; ++i) {
      double w = (double)wt[i];
      c = c + w;
      cum[i] = c;
      cv = cv + w * (wt[i] > 0.0f ? (double)val[i] : 0.0);
      cwv[i] = cv;
    }
  }
  __syncthreads();

  // 5. k1 at both edges of every element, float64 then rounded
  {
    double total = cum[M - 1];
    double safe = total > 0.0 ? total : 1.0;
    for (int i = tid; i < M; i += kThreads) {
      kr[i] = (float)k1(cum[i] / safe, compression);
      kl[i] = (float)k1((cum[i] - (double)wt[i]) / safe, compression);
    }
  }
  __syncthreads();

  // greedy boundaries and cluster ids (sequential carry)
  if (tid == 0) {
    float ks = kl[0] - 2.0f;
    int run = 0;
    for (int i = 0; i < M; ++i) {
      bool live = wt[i] > 0.0f;
      if ((kr[i] - ks > 1.0f) && live) {
        ks = kl[i];
        ++run;
      }
      int c = live ? run - 1 : C - 1;
      cluster[i] = c < 0 ? 0 : (c > C - 1 ? C - 1 : c);
    }
  }
  __syncthreads();

  // 6. cluster ends: upper bound of each id in the id row
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
    double w_up = e > 0 ? cum[e - 1] : 0.0;
    double w_prev = ep > 0 ? cum[ep - 1] : 0.0;
    double wv_up = e > 0 ? cwv[e - 1] : 0.0;
    double wv_prev = ep > 0 ? cwv[ep - 1] : 0.0;
    double w64 = w_up - w_prev;
    double wv64 = wv_up - wv_prev;
    float w = (float)w64;
    double m64 = wv64 / (w64 > 0.0 ? w64 : 1.0);
    wc[t] = w;
    mc[t] = w > 0.0f ? (float)m64 : 0.0f;
    out_weight[row * C + t] = w;
  }
  __syncthreads();

  // running max over the positive-weight means (NaN propagates, as in
  // torch.cummax)
  if (tid == 0) {
    float run = wc[0] > 0.0f ? mc[0] : -inf;
    for (int t = 0; t < C; ++t) {
      float x = wc[t] > 0.0f ? mc[t] : -inf;
      if (isnan(x) || (!isnan(run) && x >= run)) run = x;
      out_mean[row * C + t] = wc[t] > 0.0f ? run : 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one row needs, in bytes (the wrapper checks it against
// the card's per-block limit).
size_t vt_compress_smem_bytes(int C, int B) { return smem_bytes(C, B); }

// One launch over K rows on `stream` of `device`; returns
// cudaGetLastError().
int vt_compress(const float* mean, const float* weight,
                const float* buf_value, const float* buf_weight,
                float* out_mean, float* out_weight, int K, int C, int B,
                double compression, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem = smem_bytes(C, B);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        compress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  compress_kernel<<<K, kThreads, smem, (cudaStream_t)stream>>>(
      mean, weight, buf_value, buf_weight, out_mean, out_weight, C, B,
      compression);
  return (int)cudaGetLastError();
}

}  // extern "C"
