"""Relative-error quantile engine (veneur_tpu/sketches/req.py's port).

Per slot, a hierarchy of L fixed-capacity compactors holds actual sample
values as weighted items. When a level's fill crosses its lazy trigger
TRIG = C - (C-P)/2, the highest P = 5C/8 items are kept verbatim (the
tail percentiles live there) and the lowest section collapses pairwise
into one item per pair at the pair's weighted geometric mean
(arithmetic for non-positive values) carrying the pair's summed weight,
so total weight is conserved exactly; the survivors promote one level
up (the top level into itself). Count/sum/min/max/avg/hmean are exact
through the same 2Sum scalar leaves as the t-digest bank, and the same
functions fold them (ops/tdigest.py: add_scalar_stats, merge_scalars,
aggregates, merge_scalar_banks).

Bank layout ([K] slots, L levels x C capacity, T = L*C; default L=2,
C=256), identical leaf names, shapes and dtypes to the JAX bank:
  value, weight : f32[K, T]   level l occupies columns [l*C, (l+1)*C);
                              live items are a dense prefix per level,
                              weight 0 == empty
  n             : i32[K, L]   per-level fill
  ncomp         : i32[K]      compaction counter (merges by SUM)
  vmin/vmax/vsum/count/recip (+ _lo twins) : the shared exact scalars

REQ has no Pallas kernel: the JAX package runs the compaction cascade as
an XLA program, and it is eager torch here. The `lax.while_loop` of the
item write becomes a Python loop with one host sync per pass, as the
port's t-digest `_add_batch_impl` does. `_add_items_impl` (and so
`add_batch` and `merge_centroids`) writes the item columns of the bank
it is given in place and returns it with `n` replaced; the compaction
returns new tensors.

Every op is row-independent and a fresh row (n = 0) is a compress fixed
point, so the incremental flush's [D, ·] evaluation is exact.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops import scatter
from ..ops import tdigest as _td

_INF = float("inf")


class REQBank(NamedTuple):
    value: torch.Tensor      # f32[K, T]
    weight: torch.Tensor     # f32[K, T]
    n: torch.Tensor          # i32[K, L]
    ncomp: torch.Tensor      # i32[K]
    vmin: torch.Tensor       # f32[K]
    vmax: torch.Tensor       # f32[K]
    vsum: torch.Tensor       # f32[K]
    count: torch.Tensor      # f32[K]
    recip: torch.Tensor      # f32[K]
    vsum_lo: torch.Tensor    # f32[K]
    count_lo: torch.Tensor   # f32[K]
    recip_lo: torch.Tensor   # f32[K]

    @property
    def num_slots(self):
        return self.value.shape[0]

    @property
    def num_levels(self):
        return self.n.shape[1]

    @property
    def capacity(self):
        return self.value.shape[1] // self.n.shape[1]

    @property
    def buf_size(self):
        # the hot-slot sidestep's per-landing headroom = one level
        return self.capacity

    @property
    def num_centroids(self):
        # total item budget (the role C plays for the t-digest bank)
        return self.value.shape[1]


def init(num_slots: int, levels: int = 2, capacity: int = 256, *,
         device) -> REQBank:
    k, t = num_slots, levels * capacity

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return REQBank(
        value=z(k, t), weight=z(k, t),
        n=torch.zeros((k, levels), dtype=torch.int32, device=device),
        ncomp=torch.zeros(k, dtype=torch.int32, device=device),
        vmin=torch.full((k,), _INF, dtype=torch.float32, device=device),
        vmax=torch.full((k,), -_INF, dtype=torch.float32, device=device),
        vsum=z(k), count=z(k), recip=z(k),
        vsum_lo=z(k), count_lo=z(k), recip_lo=z(k))


def _sort_items(v, w):
    """Row-wise ascending sort of items by (value, weight) with empties
    (weight 0) keyed +inf — the two-key `lax.sort` of the JAX package, as
    a stable sort by weight and then a stable sort by key. Items tied on
    both keys carry the same value, so the order is the JAX one."""
    kv = torch.where(w > 0, v, _INF)
    o1 = torch.sort(w, dim=1, stable=True).indices
    o2 = torch.sort(kv.gather(1, o1), dim=1, stable=True).indices
    order = o1.gather(1, o2)
    return v.gather(1, order), w.gather(1, order)


def _compact_level(bank: REQBank, lev: int) -> REQBank:
    """One level's compaction, batched over K. The level is re-sorted
    into canonical order; when its fill crosses TRIG the top P = 5C/8
    items stay verbatim and the rest collapse pairwise into weighted
    geometric (or arithmetic) means, which promote to level lev+1 (the
    top level promotes into itself). A level starts each cascade below
    TRIG and gets at most (C-P)/2 promotions, so the promotion never
    spills past the level (the bound check on it is a safety net)."""
    K, T = bank.value.shape
    L, C = bank.num_levels, bank.capacity
    dev = bank.value.device
    a = lev * C
    seg_w = bank.weight[:, a:a + C]
    v_s, w_s = _sort_items(bank.value[:, a:a + C], seg_w)
    nl = (seg_w > 0).sum(dim=1)                               # [K]
    P = (5 * C) // 8
    trig = C - (C - P) // 2
    nb = torch.where(nl >= trig, (nl - P).clamp(0, C), torch.zeros_like(nl))
    nb = nb - (nb & 1)                                        # even
    cols = torch.arange(C, device=dev)[None, :]

    # survivors of the compacted section: pair (2j, 2j+1) -> one item at
    # the pair's weighted geometric mean when both members are positive,
    # else the weighted arithmetic mean, carrying the summed weight
    ev_v, od_v = v_s[:, 0::2], v_s[:, 1::2]
    ev_w, od_w = w_s[:, 0::2], w_s[:, 1::2]
    pw = ev_w + od_w
    safe = torch.where(pw > 0, pw, torch.ones_like(pw))
    pv_arith = (ev_w * ev_v + od_w * od_v) / safe             # [K, C/2]
    both_pos = (ev_v > 0) & (od_v > 0)
    lv_e = torch.log(torch.where(ev_v > 0, ev_v, torch.ones_like(ev_v)))
    lv_o = torch.log(torch.where(od_v > 0, od_v, torch.ones_like(od_v)))
    pv_geo = torch.exp((ev_w * lv_e + od_w * lv_o) / safe)
    pv = torch.where(both_pos, pv_geo, pv_arith)
    pj = torch.arange(C // 2, device=dev)[None, :]
    p_ok = pj < (nb // 2)[:, None]

    # kept items (everything at/after nb) shift to the level's front
    idx = (cols + nb[:, None]).clamp(max=C - 1)
    keepm = cols < (nl - nb)[:, None]
    zero = torch.zeros((), dtype=v_s.dtype, device=dev)
    # new [K, T+1] item tensors; column T is the drop column of the
    # promotion scatter below, sliced off at the end
    pad = torch.zeros(K, 1, dtype=bank.value.dtype, device=dev)
    value = torch.cat([bank.value, pad], dim=1)
    weight = torch.cat([bank.weight, pad], dim=1)
    value[:, a:a + C] = torch.where(keepm, v_s.gather(1, idx), zero)
    weight[:, a:a + C] = torch.where(keepm, w_s.gather(1, idx), zero)
    n = bank.n.clone()
    n[:, lev] = (nl - nb).to(n.dtype)

    tgt = min(lev + 1, L - 1)
    # for the self-promoting top level n[:, tgt] is the keep count just
    # set, so this reads correctly in both cases
    bbase = n[:, tgt].long()
    p_ok = p_ok & (bbase[:, None] + pj < C)
    gcol = torch.where(p_ok, tgt * C + bbase[:, None] + pj, T)
    value.scatter_(1, gcol, torch.where(p_ok, pv, zero))
    weight.scatter_(1, gcol, torch.where(p_ok, pw, zero))
    n[:, tgt] += p_ok.sum(dim=1).to(n.dtype)
    return bank._replace(value=value[:, :T].contiguous(),
                         weight=weight[:, :T].contiguous(), n=n,
                         ncomp=bank.ncomp + (nb > 0).to(bank.ncomp.dtype))


def _compress_impl(bank: REQBank, levels: int, capacity: int) -> REQBank:
    """The full compaction cascade, bottom-up — after it, a full level 0
    holds <= P items, so the add loop always makes progress."""
    for lev in range(levels):
        bank = _compact_level(bank, lev)
    return bank


def _write_items(bank: REQBank, s, pos, v, w, can):
    """Write the `can` items at (slot, level-0 column pos), in place.
    Positions are distinct per slot (ranks), so the write is unique."""
    rows = s[can].long()
    cols = pos[can].long()
    bank.value[rows, cols] = v[can]
    bank.weight[rows, cols] = w[can]


def _add_level0(n, counts):
    n = n.clone()
    n[:, 0] += counts
    return n


def _add_items_impl(bank: REQBank, slots, values, weights,
                    levels: int, capacity: int) -> REQBank:
    """Scatter weighted items into level-0 buffers, compacting on
    overflow (the merge_centroids path: scalars are not touched).
    slot -1 and weight <= 0 mark padding."""
    K = bank.num_slots
    C = capacity
    values = torch.where(values == 0.0, torch.zeros_like(values),
                         values)                          # -0.0 -> +0.0
    slots = torch.where(weights > 0, slots, torch.full_like(slots, -1))
    s, v, w = scatter.sort_by_slot(slots, values, weights, num_slots=K)
    rank = scatter.run_ranks(s)
    valid = (s >= 0) & (s < K)
    sc = s.clamp(0, K - 1).long()

    batch_per_slot = scatter.segment_count(s, valid, K)
    if not bool((bank.n[:, 0] + batch_per_slot > C).any()):
        # fast path: every item fits its slot's level 0
        _write_items(bank, s, bank.n[sc, 0] + rank, v, w, valid)
        return bank._replace(n=_add_level0(bank.n, batch_per_slot))

    written = torch.zeros_like(valid)
    while True:
        done = scatter.segment_count(s, written & valid, K)
        pos = bank.n[sc, 0] + rank - done[sc]
        can = valid & ~written & (pos < C)
        _write_items(bank, s, pos, v, w, can)
        bank = bank._replace(n=_add_level0(
            bank.n, scatter.segment_count(s, can, K)))
        written = written | can
        if not bool((valid & ~written).any()):
            return bank
        bank = _compress_impl(bank, levels, capacity)


def _add_batch_impl(bank: REQBank, slots, values, weights,
                    levels: int, capacity: int) -> REQBank:
    """Histo.Sample equivalent: exact scalar stats + weighted items."""
    K = bank.num_slots
    valid = (slots >= 0) & (slots < K)
    bank = _td.add_scalar_stats(bank, slots, valid, values, weights)
    return _add_items_impl(bank, slots, values, weights, levels, capacity)


def _quantile_impl(bank: REQBank, qs) -> torch.Tensor:
    """Batched quantiles over the retained weighted items: per row, sort
    the T items, place item i's mass centre at (cum_i - w_i/2)/W and
    interpolate (the t-digest quantile's knot scheme, with exact min/max
    endpoints). Strictly positive rows interpolate in log space, matching
    the geometric pair survivors of the compactor."""
    K = bank.num_slots
    qs = qs.to(bank.value.dtype)
    v, w = _sort_items(bank.value, bank.weight)
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
    knot_v = torch.cat([vmin, torch.where(w > 0, v, vmax), vmax], dim=1)
    out = _td._interp_knots(knot_q, knot_v, qs)
    pos = (bank.vmin > 0) & torch.isfinite(bank.vmin)
    log_knots = torch.log(knot_v.clamp(min=1e-37))
    out_log = torch.exp(_td._interp_knots(knot_q, log_knots, qs))
    out = torch.where(pos[:, None], out_log, out)
    return torch.where(total > 0, out, torch.zeros_like(out))


@dataclass(frozen=True)
class REQEngine:
    levels: int = 2
    capacity: int = 256

    id = "req"
    wire_version = 1
    import_strategy = "direct"    # forwarded items re-insert as points
    # the durability leaf order: n and ncomp are i32, as in the JAX
    # package's bank, so a checkpoint crosses between the two
    bank_leaves = ("value", "weight", "n", "ncomp",
                   "vmin", "vmax", "vsum", "count", "recip", "vsum_lo",
                   "count_lo", "recip_lo")
    error_contract = ("~1% relative value error at p99.9 (protected "
                      "tail items are exact samples); mid-range "
                      "distribution-dependent; exact count/sum/min/max")

    def init(self, num_slots: int, device):
        return init(num_slots, self.levels, self.capacity, device=device)

    def add_batch(self, bank, slots, values, weights):
        return _add_batch_impl(bank, slots, values, weights, self.levels,
                               self.capacity)

    def compress(self, bank):
        return _compress_impl(bank, self.levels, self.capacity)

    def merge_centroids(self, bank, slots, means, weights):
        return _add_items_impl(bank, slots, means, weights, self.levels,
                               self.capacity)

    def merge_scalars(self, bank, slots, vmins, vmaxs, vsums, counts,
                      recips):
        return _td.merge_scalars(bank, slots, vmins, vmaxs, vsums, counts,
                                 recips)

    def quantile(self, bank, qs):
        return _quantile_impl(bank, qs)

    def aggregates(self, bank):
        return _td.aggregates(bank)

    def forward_leaves(self, bank) -> dict:
        """The flush outputs a forwarding engine exports: the retained
        items as weighted points, and the exact scalars."""
        return dict(
            h_mean=bank.value, h_weight=bank.weight,
            h_min=bank.vmin, h_max=bank.vmax,
            h_sum=bank.vsum, h_sum_lo=bank.vsum_lo,
            h_count=bank.count, h_count_lo=bank.count_lo,
            h_recip=bank.recip, h_recip_lo=bank.recip_lo)

    def merge_banks(self, a, b):
        """Bit-commutative union: the canonical sort of the two item sets
        is order-independent, ncomp merges by SUM, and the exact scalars
        merge in float64 — merge(a, b) == merge(b, a) bit for bit."""
        K, T = a.value.shape
        vals, wts = _sort_items(torch.cat([a.value, b.value], dim=1),
                                torch.cat([a.weight, b.weight], dim=1))
        out = self.init(K, a.value.device)._replace(
            ncomp=a.ncomp + b.ncomp, **_td.merge_scalar_banks(a, b))
        C = self.capacity
        slots_flat = torch.arange(K, dtype=torch.int32,
                                  device=a.value.device).repeat_interleave(C)
        for c0 in range(0, 2 * T, C):
            out = _add_items_impl(out, slots_flat,
                                  vals[:, c0:c0 + C].reshape(-1),
                                  wts[:, c0:c0 + C].reshape(-1),
                                  self.levels, self.capacity)
        return out

    def state_bytes(self, num_slots: int = 1) -> int:
        bank = init(1, self.levels, self.capacity, device="cpu")
        per = sum(leaf.numel() * leaf.element_size() for leaf in bank)
        return per * num_slots
