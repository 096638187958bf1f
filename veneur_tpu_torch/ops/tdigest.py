"""Batched merging t-digest bank — counterpart of veneur_tpu/ops/tdigest.py.

The reference keeps one `tdigest.MergingDigest` per histogram/timer key
(tdigest/merging_digest.go sym: MergingDigest.Add / .mergeAllTemps /
.Quantile). Here K digests live in fixed-shape tensors and every
operation is batched over K: sample adds append to per-row buffers, and a
compress merges each row's buffer into its cluster-ordered centroid list
under the k1 scale function k(q) = delta * (asin(2q-1) + pi/2) / pi.

ORDERING INVARIANT (load-bearing): `mean`/`weight` rows stay exactly as
the compress emits them — positive-weight means non-decreasing, then
zero-weight empties. The compress consumes the centroid prefix as an
already-sorted run (only the buffer is sorted, then the two runs are
rank-merged), and quantile() interpolates without re-sorting.

State layout (per bank), identical leaf names and shapes to the JAX bank:
  mean, weight : f32[K, C]   merged centroids (weight 0 == empty slot)
  buf_value, buf_weight : f32[K, B]  unmerged sample buffer
  buf_n  : i32[K]            fill level of each buffer row
  vmin, vmax : f32[K]        exact extremes (+inf / -inf when empty)
  vsum, count, recip : f32[K]  weighted sum / count / sum(w/v)
  vsum_lo, count_lo, recip_lo : f32[K]  2Sum compensation terms

The compress is one function with two implementations: the CUDA kernel
(kernels/compress.py, csrc/compress.cu) for tensors on the card, and the
plain torch version here (`compress_plain`, built from
`_canonical_sort_key`, `_stable_sort_perm`, `_merge_sorted_runs` and
`_cluster_core`/`_cluster_tail`) for tensors on the CPU. Both accumulate
the cumulative weights and weighted values in float64 in lane order and
evaluate k1 in float64 before rounding to f32, so they agree without a
summation-order gap.

In-place updates: `add_batch_impl` and `merge_centroids` write the sample
buffers (`buf_value`, `buf_weight`) of the bank they are given in place
and return it with the other leaves replaced; callers rebind the bank and
never read the old one. Every other function returns new tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import scatter
from .scalar import _two_sum

_INF = float("inf")
_KEY_MAX = 0xFFFFFFFF
# 1/pi as one double: k1 multiplies by it rather than dividing by pi,
# because a CUDA tensor divided by a Python scalar is computed as a
# multiplication by the scalar's reciprocal — the compress kernel uses
# the same constant so both versions round alike
_INV_PI = 1.0 / math.pi


class TDigestBank(NamedTuple):
    mean: torch.Tensor        # f32[K, C]
    weight: torch.Tensor      # f32[K, C]
    buf_value: torch.Tensor   # f32[K, B]
    buf_weight: torch.Tensor  # f32[K, B]
    buf_n: torch.Tensor       # i32[K]
    vmin: torch.Tensor        # f32[K]
    vmax: torch.Tensor        # f32[K]
    vsum: torch.Tensor        # f32[K]
    count: torch.Tensor       # f32[K]
    recip: torch.Tensor       # f32[K]
    vsum_lo: torch.Tensor     # f32[K]
    count_lo: torch.Tensor    # f32[K]
    recip_lo: torch.Tensor    # f32[K]

    @property
    def num_slots(self):
        return self.mean.shape[0]

    @property
    def num_centroids(self):
        return self.mean.shape[1]

    @property
    def buf_size(self):
        return self.buf_value.shape[1]


def init(num_slots: int, compression: float = 100.0, buf_size: int = 256,
         *, device) -> TDigestBank:
    """Fresh bank of `num_slots` empty digests on `device`. Centroid
    lanes per row: >= 2*compression + 8 (the greedy k1 merge makes at
    most ~2*compression clusters), padded to a multiple of 128 like the
    JAX bank so the two packages' shapes agree."""
    c = int(math.ceil((2.0 * compression + 8) / 128.0) * 128)
    k = num_slots

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return TDigestBank(
        mean=z(k, c), weight=z(k, c),
        buf_value=z(k, buf_size), buf_weight=z(k, buf_size),
        buf_n=torch.zeros(k, dtype=torch.int32, device=device),
        vmin=torch.full((k,), _INF, dtype=torch.float32, device=device),
        vmax=torch.full((k,), -_INF, dtype=torch.float32, device=device),
        vsum=z(k), count=z(k), recip=z(k),
        vsum_lo=z(k), count_lo=z(k), recip_lo=z(k))


def _k1(q, compression):
    """The k1 scale function of the reference merging digest, evaluated
    in float64 (q is float64). Callers round the result to f32."""
    q = q.clamp(0.0, 1.0)
    return compression * (torch.asin(2.0 * q - 1.0) + math.pi / 2.0) \
        * _INV_PI


# ------------------------------------------------------------- compress

def _canonical_sort_key(x):
    """f32 -> monotone 32-bit key (held in int64): -0.0 is folded onto
    +0.0, then the sign-magnitude -> biased bit twiddle, so integer order
    of the keys is the float comparator order. int64 because torch has no
    shifts on uint32 on the CPU; the CUDA kernel computes the same key
    in uint32."""
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    bits = x.view(torch.int32).long() & _KEY_MAX
    neg = bits >= 0x80000000
    return torch.where(neg, (~bits) & _KEY_MAX, bits | 0x80000000)


def _stable_sort_perm(key):
    """Stable ascending row-sort of 32-bit keys [K, B] -> (sorted_key,
    perm), perm the original lane of each sorted position. One sort of a
    packed (key << 16 | lane) int64 word: the lane makes every word
    distinct, so the order is the stable one."""
    B = key.shape[1]
    if B > (1 << 16):
        raise ValueError(f"row width {B} exceeds the 16-bit lane pack")
    lane = torch.arange(B, dtype=torch.int64, device=key.device)
    packed = torch.sort((key << 16) | lane, dim=1).values
    return packed >> 16, packed & 0xFFFF


def _merge_sorted_runs(akey, bkey, S: int, M: int):
    """Exact rank-merge of two row-sorted key runs — akey [K, S] (the
    cluster-ordered centroid prefix) and bkey [K, M-S] (the sorted
    buffer) — returning the merged CONCATENATION-ORDER TAGS [K, M] (int64):
    tag t < S is prefix lane t, tag >= S is sorted-buffer position t-S.

    A bitonic merge network over [prefix | pads | reversed buffer], each
    exchange comparing lexicographic (key, tag): the tag makes every
    element distinct, so the network yields the one total order, which
    is the stable sort of the whole row (prefix lanes before buffer lanes
    at equal keys). Pads sit between the runs keyed above every real key
    and tagged past every real tag, so they sink to the tail."""
    K = akey.shape[0]
    dev = akey.device
    P = 1 << (M - 1).bit_length()
    pad = P - M
    key = torch.cat([akey, torch.full((K, pad), _KEY_MAX, dtype=torch.int64,
                                      device=dev), bkey.flip(1)], dim=1)
    tag1 = torch.cat([
        torch.arange(S, dtype=torch.int64, device=dev),
        torch.arange(pad, dtype=torch.int64, device=dev) + M,
        (torch.arange(M - S, dtype=torch.int64, device=dev) + S).flip(0)])
    tag = tag1.expand(K, P)
    stride = P // 2
    while stride >= 1:
        shape = (K, P // (2 * stride), 2, stride)
        k4 = key.reshape(shape)
        t4 = tag.reshape(shape)
        klo, khi = k4[:, :, 0, :], k4[:, :, 1, :]
        tlo, thi = t4[:, :, 0, :], t4[:, :, 1, :]
        swap = (klo > khi) | ((klo == khi) & (tlo > thi))
        key = torch.stack([torch.where(swap, khi, klo),
                           torch.where(swap, klo, khi)], dim=2).reshape(K, P)
        tag = torch.stack([torch.where(swap, thi, tlo),
                           torch.where(swap, tlo, thi)], dim=2).reshape(K, P)
        stride //= 2
    return tag[:, :M]


def _cluster_core(vals, wts, compression: float, C: int, sorted_prefix: int):
    """Greedy k1 clustering of [K, M] (value, weight) rows into at most C
    centroids per row. Zero-weight entries are padding. `sorted_prefix=S`
    asserts vals[:, :S] is cluster-ordered (the module invariant); only
    vals[:, S:] is sorted, then the runs are rank-merged. S == M means the
    whole row is one ordered run."""
    K, M = vals.shape
    S = sorted_prefix
    if not 0 < S <= M:
        raise ValueError(f"sorted_prefix {S} outside (0, {M}]")
    vals = torch.where(wts > 0, vals, _INF)
    if S < M:
        akey = _canonical_sort_key(vals[:, :S])
        bkey, perm = _stable_sort_perm(_canonical_sort_key(vals[:, S:]))
        tags = _merge_sorted_runs(akey, bkey, S, M)
        src = torch.where(
            tags < S, tags,
            S + torch.gather(perm, 1, (tags - S).clamp(0, M - S - 1)))
        vals = torch.gather(vals, 1, src)
        wts = torch.gather(wts, 1, src)
    return _cluster_tail(vals, wts, compression, C)


def _cluster_tail(vals, wts, compression: float, C: int):
    """The numeric tail on SORTED rows (empties +inf-keyed, weight 0):
    cumulative sums, k1, the greedy boundary recurrence, cluster ids,
    cumsum-diff segment sums, means and the ordering clamp.

    The cumulative weight and weighted value run in float64, column by
    column in lane order — the order the CUDA kernel's single thread
    walks — so both implementations produce the same float64 sums.
    `total` is the last cumulative weight. k1 is evaluated in float64
    and rounded to f32; the greedy recurrence then compares in f32 like
    the JAX package."""
    K, M = vals.shape
    dev = vals.device
    w64 = wts.double()
    wv64 = w64 * torch.where(wts > 0, vals, 0.0).double()
    both = torch.stack([w64, wv64], dim=1)              # [K, 2, M]
    cums = torch.empty_like(both)
    run = torch.zeros(K, 2, dtype=torch.float64, device=dev)
    for j in range(M):
        run = run + both[:, :, j]
        cums[:, :, j] = run
    cum, cwv = cums[:, 0], cums[:, 1]

    total = cum[:, -1:]
    safe_total = torch.where(total > 0, total, torch.ones_like(total))
    k_right = _k1(cum / safe_total, compression).float()
    k_left = _k1((cum - w64) / safe_total, compression).float()

    is_new = torch.empty(K, M, dtype=torch.bool, device=dev)
    k_start = k_left[:, 0] - 2.0
    live = wts > 0
    for j in range(M):
        new = (k_right[:, j] - k_start > 1.0) & live[:, j]
        k_start = torch.where(new, k_left[:, j], k_start)
        is_new[:, j] = new

    cluster = torch.cumsum(is_new.int(), dim=1) - 1
    cluster = torch.where(live, cluster, C - 1).clamp(0, C - 1)
    targets = torch.arange(C, dtype=cluster.dtype, device=dev).expand(K, C)
    ends = torch.searchsorted(cluster.contiguous(), targets.contiguous(),
                              right=True)                # [K, C] in [0, M]

    zero = torch.zeros(K, 1, dtype=torch.float64, device=dev)
    w_upto = torch.gather(torch.cat([zero, cum], dim=1), 1, ends)
    wv_upto = torch.gather(torch.cat([zero, cwv], dim=1), 1, ends)
    w_c64 = torch.diff(w_upto, dim=1, prepend=zero)
    wv_c64 = torch.diff(wv_upto, dim=1, prepend=zero)

    w_c = w_c64.float()
    mean64 = wv_c64 / torch.where(w_c64 > 0, w_c64, torch.ones_like(w_c64))
    pos = w_c > 0
    new_mean = torch.where(pos, mean64.float(), torch.zeros_like(w_c))
    # SR02 clamp: consecutive clusters partition a sorted row, so exact
    # means are non-decreasing; a running max pins the rounded means to
    # that order so the next compress can consume them as a sorted run
    clamped = torch.cummax(
        torch.where(pos, new_mean, torch.full_like(new_mean, -_INF)),
        dim=1).values
    new_mean = torch.where(pos, clamped, torch.zeros_like(new_mean))
    return new_mean, w_c


def compress_plain(mean, weight, buf_value, buf_weight, compression: float):
    """The plain torch version of the compress kernel: [K, C] centroids
    + [K, B] buffers -> (new_mean, new_weight) [K, C]."""
    C = mean.shape[1]
    vals = torch.cat([mean, buf_value], dim=1)
    wts = torch.cat([weight, buf_weight], dim=1)
    return _cluster_core(vals, wts, compression, C, sorted_prefix=C)


def _compress_impl(bank: TDigestBank, compression: float) -> TDigestBank:
    """Merge every row's buffer into its centroid list (batched
    MergingDigest.mergeAllTemps). On the card this launches the compress
    kernel; on the CPU it runs `compress_plain`."""
    from ..kernels import compress as kcompress
    mean, weight = kcompress.fused_compress(
        bank.mean, bank.weight, bank.buf_value, bank.buf_weight,
        compression)
    return bank._replace(
        mean=mean, weight=weight,
        buf_value=torch.zeros_like(bank.buf_value),
        buf_weight=torch.zeros_like(bank.buf_weight),
        buf_n=torch.zeros_like(bank.buf_n))


# ---------------------------------------------------------------- ingest

def _scalar_fold(bank: TDigestBank, s, valid, dsum, dcount, drecip,
                 vmins, vmaxs) -> TDigestBank:
    """Fold one batch's per-slot deltas into the exact-scalar leaves:
    2Sum-compensated sums and min/max scatters (order-free)."""
    K = bank.num_slots
    vsum, vsum_lo = _two_sum(bank.vsum, dsum + bank.vsum_lo)
    count, count_lo = _two_sum(bank.count, dcount + bank.count_lo)
    recip, recip_lo = _two_sum(bank.recip, drecip + bank.recip_lo)
    row = scatter.drop_index(s, K, valid)
    vmin = torch.cat([bank.vmin, bank.vmin.new_full((1,), _INF)])
    vmin.scatter_reduce_(0, row, vmins, reduce="amin")
    vmax = torch.cat([bank.vmax, bank.vmax.new_full((1,), -_INF)])
    vmax.scatter_reduce_(0, row, vmaxs, reduce="amax")
    return bank._replace(
        vmin=vmin[:K], vmax=vmax[:K], vsum=vsum, count=count, recip=recip,
        vsum_lo=vsum_lo, count_lo=count_lo, recip_lo=recip_lo)


def _write_buffers(bank: TDigestBank, s, pos, v, w, can):
    """Write the `can` samples at (slot, pos) of the sample buffers, in
    place. Positions are distinct per slot (ranks), so the write is
    unique."""
    rows = s[can].long()
    cols = pos[can].long()
    bank.buf_value[rows, cols] = v[can]
    bank.buf_weight[rows, cols] = w[can]


def _add_batch_impl(bank: TDigestBank, slots, values, weights,
                    compression: float = 100.0) -> TDigestBank:
    """Scatter a batch of (slot, value, weight) samples into the bank
    (batched Histo.Sample). Samples append to per-slot buffers; when a
    slot's buffer would overflow, the bank is compressed and the leftover
    samples are written in another pass, until the batch is absorbed.
    slot == -1 marks padding. The JAX `lax.while_loop` is a Python loop
    here with one host sync per pass."""
    K = bank.num_slots
    B = bank.buf_size

    s, v, w = scatter.sort_by_slot(slots, values, weights, num_slots=K)
    rank = scatter.run_ranks(s)
    valid = (s >= 0) & (s < K)
    sc = s.clamp(0, K - 1).long()

    recip_terms = torch.where(
        v != 0, w / torch.where(v != 0, v, torch.ones_like(v)),
        torch.zeros_like(v))
    bank = _scalar_fold(
        bank, s, valid,
        scatter.segment_sum_f64(s, w * v, K, valid),
        scatter.segment_sum_f64(s, w, K, valid),
        scatter.segment_sum_f64(s, recip_terms, K, valid),
        torch.where(valid, v, _INF), torch.where(valid, v, -_INF))

    batch_per_slot = scatter.segment_count(s, valid, K)
    if not bool((bank.buf_n + batch_per_slot > B).any()):
        # fast path: every valid sample fits its slot's buffer
        _write_buffers(bank, s, bank.buf_n[sc] + rank, v, w, valid)
        return bank._replace(buf_n=bank.buf_n + batch_per_slot)

    written = torch.zeros_like(valid)
    while True:
        done = scatter.segment_count(s, written & valid, K)
        pos = bank.buf_n[sc] + rank - done[sc]
        can = valid & ~written & (pos < B)
        _write_buffers(bank, s, pos, v, w, can)
        bank = bank._replace(
            buf_n=bank.buf_n + scatter.segment_count(s, can, K))
        written = written | can
        if not bool((valid & ~written).any()):
            return bank
        bank = _compress_impl(bank, compression)


def merge_centroids(bank: TDigestBank, slots, means, weights) -> TDigestBank:
    """Append weighted points (e.g. pre-clustered hot-slot samples) into
    per-slot buffers, to be absorbed by the next compress. Points that do
    not fit are dropped; callers compress first for headroom. Zero-weight
    padding never consumes a buffer position."""
    K, B = bank.num_slots, bank.buf_size
    slots = torch.where(weights > 0, slots, torch.full_like(slots, -1))
    s, v, w = scatter.sort_by_slot(slots, means, weights, num_slots=K)
    rank = scatter.run_ranks(s)
    valid = (s >= 0) & (s < K) & (w > 0)
    pos = bank.buf_n[s.clamp(0, K - 1).long()] + rank
    can = valid & (pos < B)
    _write_buffers(bank, s, pos, v, w, can)
    return bank._replace(
        buf_n=bank.buf_n + scatter.segment_count(s, can, K))


def merge_scalars(bank: TDigestBank, slots, vmins, vmaxs, vsums, counts,
                  recips) -> TDigestBank:
    """Merge exact per-slot scalar stats (min/max/sum/count/recip)."""
    K = bank.num_slots
    valid = (slots >= 0) & (slots < K)
    zero = torch.zeros_like(vsums)
    return _scalar_fold(
        bank, slots, valid,
        scatter.segment_sum_f64(slots, torch.where(valid, vsums, zero), K,
                                valid),
        scatter.segment_sum_f64(slots, torch.where(valid, counts, zero), K,
                                valid),
        scatter.segment_sum_f64(slots, torch.where(valid, recips, zero), K,
                                valid),
        torch.where(valid, vmins, _INF), torch.where(valid, vmaxs, -_INF))


# ----------------------------------------------------------------- flush

def quantile(bank: TDigestBank, qs) -> torch.Tensor:
    """Batched MergingDigest.Quantile: [K] digests x [P] quantiles ->
    [K, P]. Requires compressed, cluster-ordered state. Centroid i's
    mass is centred at quantile (cum_i - w_i/2) / W; linear interpolation
    between adjacent centroid means, with (0 -> vmin) and (1 -> vmax)
    knots at the ends."""
    K, C = bank.mean.shape
    means, w = bank.mean, bank.weight
    total = w.sum(dim=1, keepdim=True)
    safe_total = torch.where(total > 0, total, torch.ones_like(total))
    cum = torch.cumsum(w, dim=1)
    mid_q = (cum - w / 2.0) / safe_total
    mid_q = torch.where(w > 0, mid_q, torch.ones_like(mid_q))
    ones = torch.ones(K, 1, dtype=mid_q.dtype, device=mid_q.device)
    knot_q = torch.cat([torch.zeros_like(ones), mid_q, ones], dim=1)
    vmin = torch.where(torch.isfinite(bank.vmin), bank.vmin,
                       torch.zeros_like(bank.vmin))[:, None]
    vmax = torch.where(torch.isfinite(bank.vmax), bank.vmax,
                       torch.zeros_like(bank.vmax))[:, None]
    knot_v = torch.cat([vmin, torch.where(w > 0, means, vmax), vmax], dim=1)
    out = _interp_knots(knot_q, knot_v, qs)
    return torch.where(total > 0, out, torch.zeros_like(out))


def _interp_knots(knot_q, knot_v, qs):
    """Row-wise linear interpolation at qs over ascending knots —
    [K, M] x [P] -> [K, P]. knot_q is ascending per row, so `knot_q < q`
    is a prefix mask whose last-True / first-False positions bracket q."""
    K = knot_q.shape[0]
    if qs.shape[0] == 0:
        return knot_q.new_zeros(K, 0)
    zero = torch.zeros((), dtype=knot_q.dtype, device=knot_q.device)
    cols = []
    for p in range(qs.shape[0]):
        q = qs[p]
        mask = knot_q < q
        nxt = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], dim=1)
        lo_b = mask & ~nxt
        prv = torch.cat([torch.ones_like(mask[:, :1]), mask[:, :-1]], dim=1)
        hi_b = (~mask) & prv
        q_lo = torch.where(lo_b, knot_q, zero).sum(dim=1)
        v_lo = torch.where(lo_b, knot_v, zero).sum(dim=1)
        q_hi = torch.where(hi_b, knot_q, zero).sum(dim=1)
        v_hi = torch.where(hi_b, knot_v, zero).sum(dim=1)
        denom = q_hi - q_lo
        t = torch.where(denom > 0,
                        (q - q_lo) / torch.where(denom > 0, denom,
                                                 torch.ones_like(denom)),
                        zero)
        out = v_lo + t * (v_hi - v_lo)
        cols.append(torch.where(mask.any(dim=1), out, knot_v[:, 0]))
    return torch.stack(cols, dim=1)


def aggregates(bank: TDigestBank) -> dict:
    """The non-percentile flush aggregates of samplers.Histo: max, min,
    sum, avg, count, hmean (each hi + lo folded once, in f32)."""
    cnt = bank.count + bank.count_lo
    vsum = bank.vsum + bank.vsum_lo
    recip = bank.recip + bank.recip_lo
    zero = torch.zeros_like(cnt)
    safe = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
    return {
        "min": torch.where(cnt > 0, bank.vmin, zero),
        "max": torch.where(cnt > 0, bank.vmax, zero),
        "sum": vsum,
        "count": cnt,
        "avg": torch.where(cnt > 0, vsum / safe, zero),
        "hmean": torch.where(
            recip > 0,
            cnt / torch.where(recip > 0, recip, torch.ones_like(recip)),
            zero),
    }
