"""MeshEngine: the whole aggregation step over a ("dp", "shard") device grid.

Counterpart of veneur_tpu/parallel/mesh.py. State layout: instance
(d, s) of the grid — dp replica d of shard column s — keeps its own
port banks of K/S slots on its device (`MeshBanks`: `banks.histo[d][s]`
is a TDigestBank, and so on). Sample batches are routed on the host
(global slot id -> owning shard column; any stream can feed any dp row),
as veneur's digest sharding keeps the hot path synchronization-free
(server.go: `Workers[Digest % len(Workers)]`).

ingest: each instance lands its own [N] segment of a [D, S*N] batch with
the single-device ops (`tdigest._add_batch_impl`, whose buffer overflow
runs the compress kernel; `scalar.counter_add`, `scalar.gauge_set`,
`hll.insert`). No cross-device traffic, by construction.

flush_device: per shard column, in the JAX package's order — compress
each dp replica's bank (the kernel); gather the replicas' centroids onto
the column's owner (its dp-0 device) as the buffer of an empty-prefix bank,
replica 0 first (the tiled `all_gather(axis=1)`); min/max of the
extremes (pmin/pmax); the 2Sum pairs and counter halves added component
by component in float32 (psum); gauges by the largest sequence; the
register max; the merged bank compressed (the kernel, at B = D*C);
then quantiles, aggregates and the HLL estimate (the hll_stats kernel).
A 1 x 1 grid runs the single-device flush body. The columns' outputs
are concatenated on the grid's first device, as a fetch of a sharded
array gathers its shards.

On several cards the gathers are copies between cards; a device that
stands in the grid more than once (one card holding a whole grid) makes
them copies within its memory.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.pipeline import require_device
from ..ops import hll, scalar, tdigest
from ..ops.tdigest import TDigestBank

_INF = float("inf")


class Mesh:
    """A D x S grid of torch devices with the JAX mesh's axis names:
    `devices[d][s]` runs dp replica d of shard column s."""

    def __init__(self, devices):
        self.devices = [[torch.device(x) for x in row] for row in devices]
        if not self.devices or not self.devices[0] \
                or len({len(row) for row in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty D x S grid of devices")
        self.shape = {"dp": len(self.devices),
                      "shard": len(self.devices[0])}

    def distinct(self) -> list:
        """The grid's devices, each once, in grid order."""
        out = []
        for row in self.devices:
            for dev in row:
                if dev not in out:
                    out.append(dev)
        return out


def make_mesh(n_dp: int = 1, n_shard: int | None = None,
              devices=None) -> Mesh:
    """The first n_dp * n_shard of `devices` (default: every CUDA card),
    row-major into a D x S grid. A device may repeat in the list."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "pass devices=['cpu', ...]")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_shard is None:
        n_shard = len(devices) // n_dp
    if n_dp < 1 or n_shard < 1 or len(devices) < n_dp * n_shard:
        raise ValueError(f"make_mesh: {len(devices)} devices cannot make "
                         f"a {n_dp} x {n_shard} grid")
    return Mesh([devices[d * n_shard:(d + 1) * n_shard]
                 for d in range(n_dp)])


def shard_devices(device, n: int) -> list:
    """The devices of `n` logical shards: "cpu" for each on the CPU, and
    on the card shard i on cuda:(i mod the number of cards)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


class MeshBanks(NamedTuple):
    histo: list     # [D][S] TDigestBank of K/S slots
    counter: list   # [D][S] CounterBank
    gauge: list     # [D][S] GaugeBank
    sets: list      # [D][S] HLLBank


class MeshEngine:
    """Owns the grid's banks, the routed ingest and the merged flush."""

    def __init__(self, mesh: Mesh, histogram_slots=1024, counter_slots=512,
                 gauge_slots=512, set_slots=256, compression=100.0,
                 buf_size=128, hll_precision=12,
                 percentiles=(0.5, 0.75, 0.99)):
        self.mesh = mesh
        self.D = mesh.shape["dp"]
        self.S = mesh.shape["shard"]
        if histogram_slots % self.S or counter_slots % self.S \
                or gauge_slots % self.S or set_slots % self.S:
            raise ValueError("slot counts must divide the shard axis")
        self.histogram_slots = histogram_slots
        self.counter_slots = counter_slots
        self.gauge_slots = gauge_slots
        self.set_slots = set_slots
        self.compression = compression
        self.buf_size = buf_size
        self.hll_precision = hll_precision
        self._single = self.D * self.S == 1
        self.device = mesh.devices[0][0]
        for dev in mesh.distinct():
            require_device(dev, "MeshEngine")
        self._qs = {dev: torch.tensor(percentiles, dtype=torch.float32,
                                      device=dev)
                    for dev in mesh.distinct()}
        self.banks = self.fresh_banks()

    # -------------- state --------------

    def _shard_banks(self, dev):
        """One instance's fresh banks (K/S slots each) on `dev`."""
        S = self.S
        return (tdigest.init(self.histogram_slots // S, self.compression,
                             self.buf_size, device=dev),
                scalar.init_counters(self.counter_slots // S, dev),
                scalar.init_gauges(self.gauge_slots // S, dev),
                hll.init(self.set_slots // S, self.hll_precision,
                         device=dev))

    def fresh_banks(self) -> MeshBanks:
        """Fresh interval state for every instance (the gauge seq
        sentinel -1, "never written")."""
        grid = [[self._shard_banks(dev) for dev in row]
                for row in self.mesh.devices]
        return MeshBanks(*([[inst[i] for inst in row] for row in grid]
                           for i in range(4)))

    # -------------- ingest --------------

    def _segments(self, slots, *arrays):
        """(d, s, slot tensor, tensors...) for each instance whose
        [N] segment of the [D, S*N] arrays holds a sample (slot >= 0);
        instances with only padding are skipped (their ops would change
        nothing)."""
        slots = np.asarray(slots)
        n = slots.shape[1] // self.S
        for d in range(self.D):
            for s in range(self.S):
                seg = slice(s * n, (s + 1) * n)
                if not (slots[d, seg] >= 0).any():
                    continue
                dev = self.mesh.devices[d][s]
                yield (d, s,
                       *(torch.as_tensor(np.ascontiguousarray(a[d, seg]),
                                         device=dev)
                         for a in (slots, *map(np.asarray, arrays))))

    def ingest(self, h_slots=None, h_vals=None, h_wts=None, c_slots=None,
               c_vals=None, c_wts=None, g_slots=None, g_vals=None,
               g_seqs=None, s_slots=None, s_idx=None, s_rho=None):
        """Sample arrays are [D, S*N]: row d feeds dp replica d; columns
        are S per-shard segments of N, each holding LOCAL slot ids (-1
        padding). A bank whose slot array is None is not touched."""
        b = self.banks
        if h_slots is not None:
            for d, s, hs, hv, hw in self._segments(h_slots, h_vals,
                                                        h_wts):
                b.histo[d][s] = tdigest._add_batch_impl(
                    b.histo[d][s], hs, hv, hw, self.compression)
        if c_slots is not None:
            for d, s, cs, cv, cw in self._segments(c_slots, c_vals,
                                                        c_wts):
                b.counter[d][s] = scalar.counter_add(b.counter[d][s], cs,
                                                     cv, cw)
        if g_slots is not None:
            for d, s, gs, gv, gq in self._segments(g_slots, g_vals,
                                                        g_seqs):
                b.gauge[d][s] = scalar.gauge_set(b.gauge[d][s], gs, gv, gq)
        if s_slots is not None:
            for d, s, ss, si, sr in self._segments(s_slots, s_idx,
                                                        s_rho):
                b.sets[d][s] = hll.insert(b.sets[d][s], ss, si, sr)

    def merge_set_rows(self, slots, registers):
        """Union forwarded HLL register rows into the sharded set bank
        (the global tier's Set.Combine): slots i32[D, S*N] (shard-local
        ids, -1 padding), registers u8[D, S*N, m]."""
        b = self.banks
        for d, s, rs, regs in self._segments(slots, registers):
            b.sets[d][s] = hll.merge_rows(b.sets[d][s], rs, regs)

    def merge_histo_scalars(self, slots, dmin, dmax, dsum, dcnt, drcp):
        """Routed fold of exact per-slot scalar deltas into the t-digest
        bank's 2Sum pairs (the global tier's exact-stats correction; the
        min/max arrays accept +/-inf to change nothing)."""
        b = self.banks
        for d, s, *cols in self._segments(slots, dmin, dmax, dsum,
                                                dcnt, drcp):
            b.histo[d][s] = tdigest.merge_scalars(b.histo[d][s], *cols)

    def warm(self, widths, rows_for_sets: int = 0):
        """The device's first use of the ingest ops (and, with
        `rows_for_sets`, of the global tier's row and scalar merges) at
        each of `widths`, on scratch banks of one instance's size on
        every distinct device. At most one row a slot, so no buffer
        overflows and no compress runs; the live banks are not touched."""
        for dev in self.mesh.distinct():
            hb, cb, gb, sb = self._shard_banks(dev)
            kh, kc, kg, ks = (hb.num_slots, cb.num_slots, gb.num_slots,
                              sb.num_slots)
            for w in widths:
                idx = torch.arange(w, dtype=torch.int32, device=dev)
                ones = torch.ones(w, dtype=torch.float32, device=dev)

                def rows(k):
                    return torch.where(idx < k, idx, torch.full_like(idx, -1))
                hb = tdigest._add_batch_impl(hb, rows(kh), ones, ones,
                                             self.compression)
                cb = scalar.counter_add(cb, rows(kc), ones, ones)
                gb = scalar.gauge_set(gb, rows(kg), ones, idx + 1)
                sb = hll.insert(sb, rows(ks), idx % 64,
                                torch.ones(w, dtype=torch.uint8, device=dev))
                if rows_for_sets:
                    inf = torch.full_like(ones, _INF)
                    hb = tdigest.merge_scalars(hb, rows(kh), inf, -inf,
                                               ones, ones, ones)
            if rows_for_sets:
                n = min(rows_for_sets, ks)
                sb = hll.merge_rows(
                    sb, torch.arange(n, dtype=torch.int32, device=dev),
                    torch.ones((n, sb.num_registers), dtype=torch.uint8,
                               device=dev))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -------------- merged flush --------------

    def _merge_column(self, banks: MeshBanks, s: int) -> dict:
        """One shard column's merged flush outputs, on its owner device."""
        own = self.mesh.devices[0][s]
        comp = self.compression
        D = self.D
        hbs = [tdigest._compress_impl(banks.histo[d][s], comp)
               for d in range(D)]
        cbs = [banks.counter[d][s] for d in range(D)]
        gbs = [banks.gauge[d][s] for d in range(D)]
        regs_d = [banks.sets[d][s].registers for d in range(D)]
        if self._single:
            hb, cb, gb = hbs[0], cbs[0], gbs[0]
            c_hi, c_lo, g_seq = cb.hi, cb.lo, gb.seq
            g_val = torch.where(gb.seq >= 0, gb.value,
                                torch.full_like(gb.value, -_INF))
            regs = regs_d[0]
        else:
            def on(ts):
                return [t.to(own) for t in ts]

            def fold(fn, ts):
                ts = on(ts)
                acc = ts[0]
                for t in ts[1:]:
                    acc = fn(acc, t)
                return acc
            h0 = hbs[0]

            def psum(name):
                return fold(torch.add, [getattr(h, name) for h in hbs])
            # the gathered centroids ride in the BUFFER of an empty-prefix
            # bank; compress sorts them itself
            # vlint: disable=SR02 reason=mean/weight are all-zero rows
            # (trivially cluster-ordered: no positive-weight entries),
            # so the sorted-prefix invariant the merge-path compress
            # depends on holds
            hb = TDigestBank(
                mean=torch.zeros_like(h0.mean, device=own),
                weight=torch.zeros_like(h0.weight, device=own),
                buf_value=torch.cat(on([h.mean for h in hbs]), dim=1),
                buf_weight=torch.cat(on([h.weight for h in hbs]), dim=1),
                buf_n=torch.zeros_like(h0.buf_n, device=own),
                vmin=fold(torch.minimum, [h.vmin for h in hbs]),
                vmax=fold(torch.maximum, [h.vmax for h in hbs]),
                vsum=psum("vsum"), count=psum("count"), recip=psum("recip"),
                # the compensation terms add independently: D small terms
                # cannot bring back a meaningful rounding error
                vsum_lo=psum("vsum_lo"), count_lo=psum("count_lo"),
                recip_lo=psum("recip_lo"))
            hb = tdigest._compress_impl(hb, comp)
            c_hi = fold(torch.add, [c.hi for c in cbs])
            c_lo = fold(torch.add, [c.lo for c in cbs])
            g_seq = fold(torch.maximum, [g.seq for g in gbs])
            g_val = fold(torch.maximum, [
                torch.where((q == g_seq) & (g_seq >= 0), v,
                            torch.full_like(v, -_INF))
                for q, v in zip(on([g.seq for g in gbs]),
                                on([g.value for g in gbs]))])
            regs = fold(torch.maximum, regs_d)
        return {
            "quantiles": tdigest.quantile(hb, self._qs[own]),
            "agg": tdigest.aggregates(hb),
            "c_hi": c_hi, "c_lo": c_lo,
            "gauge_seq": g_seq, "gauge_val": g_val,
            "set_est": hll.estimate(hll.HLLBank(regs)),
            "cnt_hi": hb.count, "cnt_lo": hb.count_lo,
            "sum_hi": hb.vsum, "sum_lo": hb.vsum_lo,
        }

    def flush_device(self, banks: MeshBanks) -> dict:
        """The merged flush of `banks`, as full-K tensors on the grid's
        first device (callers fetch them). `counters` folds the 2Sum pair
        for compatibility; `c_hi`/`c_lo` carry the exact halves."""
        cols = [self._merge_column(banks, s) for s in range(self.S)]
        dev = self.device

        def cat(parts):
            return parts[0] if len(parts) == 1 else torch.cat(
                [p.to(dev) for p in parts])
        out = {k: cat([c[k] for c in cols]) for k in cols[0]
               if k != "agg"}
        out["agg"] = {k: cat([c["agg"][k] for c in cols])
                      for k in cols[0]["agg"]}
        out["counters"] = out["c_hi"] + out["c_lo"]
        return out

    def flush_merged(self) -> dict:
        """Run the merged flush, reset the state, return full-K host
        arrays."""
        out = self.flush_device(self.banks)
        self.banks = self.fresh_banks()
        return {k: ({a: t.cpu().numpy() for a, t in v.items()}
                    if isinstance(v, dict) else v.cpu().numpy())
                for k, v in out.items()}

    # -------------- host-side batch routing helper --------------

    def route_batch(self, slots, *arrays, slots_per_shard, n_per_segment,
                    dp_row=0, n_dp=None, fill=0.0):
        """Pack a host batch with GLOBAL slot ids into the [D, S*N]
        layout ingest() expects: segment s holds the samples owned by
        shard s with slot ids rebased to the shard-local range.

        One vectorized pass (stable sort by shard + rank-within-run),
        not one scan per shard. Returns (out_slots, *outs, n_overflow):
        samples beyond a shard's segment capacity are NOT packed —
        callers must re-route them in the next batch (or size
        n_per_segment for the worst case); the count is returned so
        drops are never silent. Byte for byte the JAX package's."""
        n_dp = n_dp or self.D
        slots = np.asarray(slots)
        out_slots = np.full((n_dp, self.S * n_per_segment), -1, np.int32)
        outs = [np.full((n_dp, self.S * n_per_segment), fill,
                        np.asarray(a).dtype) for a in arrays]
        valid = np.nonzero(slots >= 0)[0]
        if valid.size == 0:
            return (out_slots, *outs, 0)
        shard = slots[valid] // slots_per_shard
        order = np.argsort(shard, kind="stable")
        vidx = valid[order]
        shard = shard[order]
        # rank of each sample within its shard run: position minus the
        # run's start offset (runs are contiguous after the stable sort)
        starts = np.searchsorted(shard, np.arange(self.S), side="left")
        pos = np.arange(len(shard)) - starts[shard]
        keep = pos < n_per_segment
        overflow = int((~keep).sum())
        vidx, shard, pos = vidx[keep], shard[keep], pos[keep]
        dest = shard * n_per_segment + pos
        out_slots[dp_row, dest] = (slots[vidx] % slots_per_shard)
        for o, a in zip(outs, arrays):
            o[dp_row, dest] = np.asarray(a)[vidx]
        return (out_slots, *outs, overflow)
