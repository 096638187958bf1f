"""MeshAggregationEngine: the serving engine over a device grid.

Counterpart of veneur_tpu/parallel/engine.py, the `tpu_num_devices > 1`
serving path (SURVEY §7 step 7): one engine whose banks are sharded over
a ("dp", "shard") grid of devices (parallel/mesh.py), fed by the same
staging and interning as the single-device engine. The host keeps GLOBAL
slot ids (slot g lives on shard g // slots_per_shard); each staged batch
is routed into the [D, S*N] segment layout in one vectorized pass and
landed by the MeshEngine's per-instance ops on dp row 0; the flush is the
MeshEngine's merge followed by the shared host assembly.

Parity: this subsumes the reference's in-process worker sharding
(`Workers[Digest % len(Workers)]`, server.go) — the hash space is
partitioned over devices instead of goroutines — while the cluster tier
(forwardrpc) stays above it, unchanged.

The mesh engine also serves as the GLOBAL tier (is_global): forwarded
digests merge through the same routed ingest — centroids are weighted
samples, and the exact forwarded min/max ride as ZERO-WEIGHT samples
(they update the extremes but add nothing to sum/count/recip), and the
exact sum/count/recip deltas fold in through merge_histo_scalars;
forwarded HLL registers union through the row merge, 64 rows a landing;
counters and gauges accumulate on host and land through the routed scalar
ingest. Only upstream forwarding from a mesh engine is refused (a
multi-device pod is a root of the aggregation tree; pods chain via the
cluster tier's import server).

The flush is never incremental and never double-buffered: the sharded
banks carry no dirty bitmaps, and everything staged lands in the live
banks under the lock before the swap (the base engine's flush ordering
for `_double_buffer_capable = False`).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..models.pipeline import (_WARM_WIDTHS, AggregationEngine,
                               EngineConfig, _precluster_k1)
from .mesh import MeshEngine, make_mesh

logger = logging.getLogger(__name__)

# imported HLL register rows landed together
SET_ROWS_CHUNK = 64


class MeshAggregationEngine(AggregationEngine):
    _incremental_capable = False
    _double_buffer_capable = False

    def __init__(self, config: EngineConfig, devices=None, n_dp: int = 1,
                 mesh=None):
        """`devices`: the grid's devices, row-major, repeats allowed (an
        n_dp x len(devices)/n_dp grid); default every CUDA card, which
        raises without one. `mesh` (a parallel.mesh.Mesh) replaces
        both."""
        if config.forward_enabled:
            raise ValueError(
                "mesh engine cannot forward upstream; point local "
                "veneurs at this server's import listener instead")
        if config.histogram_backend != "tdigest" \
                or config.set_backend != "hll":
            raise ValueError(
                "mesh engine supports only the default sketch "
                "backends (its sharded banks are built directly on "
                "the t-digest/HLL ops)")
        if config.flush_fetch_f16:
            raise ValueError("flush_fetch_f16 is not supported on the "
                             "mesh engine (its flush program has its own "
                             "wire layout)")
        self._mesh_cfg = (mesh, devices, n_dp)
        self._import_h_points = 0
        self._import_h_deltas: dict = {}
        super().__init__(config)

    # ---------------- device setup ----------------

    def _setup_device(self, device):
        cfg = self.cfg
        mesh, devices, n_dp = self._mesh_cfg
        if mesh is None:
            mesh = make_mesh(n_dp, devices=devices)
        S = mesh.shape["shard"]

        def pad_to(total):
            return -(-total // S) * S

        self.me = MeshEngine(
            mesh,
            histogram_slots=pad_to(cfg.histogram_slots),
            counter_slots=pad_to(cfg.counter_slots),
            gauge_slots=pad_to(cfg.gauge_slots),
            set_slots=pad_to(cfg.set_slots),
            compression=cfg.compression,
            buf_size=cfg.buffer_depth,
            hll_precision=cfg.hll_precision,
            percentiles=tuple(cfg.percentiles)
            + ((0.5,) if "median" in cfg.aggregates else ()))
        self.S = S
        self.device = self.me.device

    def _setup_fetch(self):
        super()._setup_fetch()
        if self._fetch_mode == "host":
            logger.warning("flush_fetch=host is not supported on the mesh "
                           "engine; using staged")
            self._fetch_mode = "staged"

    # ---------------- ingest ----------------
    # Staged batches carry GLOBAL slot ids straight from the interners;
    # each dispatch routes one bank's batch into the segment layout and
    # lands it on dp row 0.

    def _route(self, per_shard, slots, *arrays, fill=0.0):
        out = self.me.route_batch(
            slots, *arrays, slots_per_shard=per_shard,
            n_per_segment=len(np.asarray(slots)), fill=fill)
        assert out[-1] == 0  # segments are batch-sized: cannot overflow
        return out[:-1]

    def _add_histos(self, slots, values, weights):
        # Hot-slot sidestep, mesh flavour: a batch overfilling one slot's
        # buffer would loop whole-shard compresses in the ingest. Hot
        # slots are pre-clustered on host to <= B weighted points
        # (k1-spaced, with the true min/max kept as singletons so the
        # exact extremes survive) and go through the SAME routed ingest
        # as ordinary weighted samples — sum/count are exactly preserved
        # by the weights; only recip/hmean degrades to the digest's own
        # approximation class for the hot batch.
        slots = np.asarray(slots)
        B = self.cfg.buffer_depth
        valid = slots >= 0
        uniq, cnt = (np.unique(slots[valid], return_counts=True)
                     if valid.any() else (np.array([]), np.array([])))
        if cnt.size and cnt.max() > B:
            values = np.asarray(values, np.float32)
            weights = np.asarray(weights, np.float32)
            hot = uniq[cnt > B]
            # cold rows + (<= B points per hot slot, each of which had
            # > B raw samples) always fit the batch's own width
            cold_m = valid & ~np.isin(slots, hot)
            out_s = [slots[cold_m].astype(np.int32)]
            out_v, out_w = [values[cold_m]], [weights[cold_m]]
            for s in hot.tolist():
                m = (slots == s) & valid
                cm, cw = _precluster_k1(
                    values[m].astype(np.float64),
                    weights[m].astype(np.float64), B,
                    keep_extremes=True)
                out_s.append(np.full(len(cm), s, np.int32))
                out_v.append(cm.astype(np.float32))
                out_w.append(cw.astype(np.float32))
            n = len(slots)
            fs = np.concatenate(out_s)
            slots = np.full(n, -1, np.int32)
            values = np.zeros(n, np.float32)
            weights = np.zeros(n, np.float32)
            slots[:len(fs)] = fs
            values[:len(fs)] = np.concatenate(out_v)
            weights[:len(fs)] = np.concatenate(out_w)
        hs, hv, hw = self._route(
            self.me.histogram_slots // self.S, slots, values, weights)
        self.me.ingest(h_slots=hs, h_vals=hv, h_wts=hw)

    def _add_counters(self, slots, values, weights):
        cs, cv, cw = self._route(self.me.counter_slots // self.S, slots,
                                 values, weights)
        self.me.ingest(c_slots=cs, c_vals=cv, c_wts=cw)

    def _add_gauges(self, slots, values, seqs):
        gs, gv, gq = self._route(self.me.gauge_slots // self.S, slots,
                                 values, seqs)
        self.me.ingest(g_slots=gs, g_vals=gv, g_seqs=gq)

    def _add_sets(self, slots, reg_idx, rho):
        ss, si, sr = self._route(self.me.set_slots // self.S, slots,
                                 reg_idx, rho, fill=0)
        self.me.ingest(s_slots=ss, s_idx=si, s_rho=sr)

    def _dispatch_histos(self):
        a = self._histo_stage.drain()
        self._add_histos(a["slots"], a["values"], a["weights"])

    def _dispatch_counters(self):
        a = self._counter_stage.drain()
        self._add_counters(a["slots"], a["values"], a["weights"])

    def _dispatch_gauges(self):
        a = self._gauge_stage.drain()
        self._add_gauges(a["slots"], a["values"], a["seqs"])

    def _dispatch_sets(self):
        a = self._set_stage.drain()
        self._add_sets(a["slots"], a["reg_idx"], a["rho"])

    def drain_all(self):
        """Land every staged sample in the live banks (set updates land
        batch by batch: the mesh keeps no landing buffer)."""
        for st, fn in ((self._histo_stage, self._dispatch_histos),
                       (self._counter_stage, self._dispatch_counters),
                       (self._gauge_stage, self._dispatch_gauges),
                       (self._set_stage, self._dispatch_sets)):
            if st.n:
                fn()

    def ingest_histo_batch(self, slots, values, weights, count=None,
                           mark=None):
        self._ingest_batch(slots, count, mark, lambda n: self._add_histos(
            slots, values, weights))

    def ingest_counter_batch(self, slots, values, weights, count=None,
                             mark=None):
        self._ingest_batch(slots, count, mark, lambda n: self._add_counters(
            slots, values, weights))

    def ingest_gauge_batch(self, slots, values, count=None, mark=None):
        def apply(n):
            seqs = np.arange(1, len(slots) + 1, dtype=np.int32) \
                + self._gauge_seq
            self._gauge_seq += n
            self._add_gauges(slots, values, seqs)
        self._ingest_batch(slots, count, mark, apply)

    def ingest_set_batch(self, slots, reg_idx, rho, count=None, mark=None):
        self._ingest_batch(slots, count, mark, lambda n: self._add_sets(
            slots, reg_idx, rho))

    def warm_ingest_kernels(self, b: int):
        """The device's first use of the ingest ops at the segment width
        `b` (a routed batch's segments are batch-wide) and the shorter
        widths of _WARM_WIDTHS, on scratch banks of one instance's size
        on each distinct device (MeshEngine.warm); on a global, the row
        and scalar merges of the import landing too."""
        self.me.warm(sorted({min(b, w) for w in _WARM_WIDTHS} | {b}),
                     SET_ROWS_CHUNK if self.cfg.is_global else 0)

    def warmup(self):
        """The ingest ops (warm_ingest_kernels) and the merged flush over
        fresh banks, before serving: the mesh's hot-slot sidestep is host
        work feeding the same ingest. The live banks are not touched."""
        self.warm_ingest_kernels(self.cfg.batch_size)
        self._flush_device(self.me.fresh_banks(), [])
        self._sync()

    def _sync(self):
        for dev in self.me.mesh.distinct():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # ---------------- flush ----------------

    def _swap_banks(self):
        snap = self.me.banks
        self.me.banks = self.me.fresh_banks()
        return snap

    def _flush_device(self, snap, phases, dirty=None) -> dict:
        """The merged flush, mapped onto the host contract the shared
        assembly consumes, and fetched under the flush_fetch mode.
        `phases` and `dirty` (always None: no per-slot bitmaps) are taken
        for the base engine's signature; as in the JAX package, the merge
        and its fetch stamp no phases of their own (the caller's merge_ns
        covers them)."""
        self._last_flush_info = {"path": "full"}
        dev = self.me.flush_device(snap)
        agg = dev["agg"]
        out = {
            "q": dev["quantiles"],
            "c_hi": dev["c_hi"], "c_lo": dev["c_lo"],
            "g_value": dev["gauge_val"], "g_seq": dev["gauge_seq"],
            "s_est": dev["set_est"],
        }
        cols = []
        for a in self._agg_emit:
            if a == "count":
                cols.append(dev["cnt_hi"])
                out["lo_count"] = dev["cnt_lo"]
            elif a == "sum":
                cols.append(dev["sum_hi"])
                out["lo_sum"] = dev["sum_lo"]
            else:
                cols.append(agg[a])
        if cols:
            out["aggcols"] = torch.stack(cols, dim=1)
        if "count" not in self._agg_emit:
            out["cnt"] = agg["count"]
        return self._fetch(out)

    # ---------------- import (the global tier's Combine path) ---------
    # Everything lands through the routed ingest instead of the base
    # engine's clustered landing (see the module docstring).

    def _import_histogram_locked(self, key, means, weights, vmin, vmax,
                                 vsum, count, recip=0.0):
        slot = self._import_slot(self.histo_keys, key)
        if slot < 0:
            return
        means = np.asarray(means, np.float64)
        weights = np.asarray(weights, np.float64)
        # cap at B-2 so item + extreme riders never exceed B: a landing
        # round gives one slot at most one item, so no scatter overflows
        # a buffer and the hot-slot pre-cluster (whose recip is
        # approximate) stays off this path
        B = self.cfg.buffer_depth - 2
        if len(means) > B:
            means, weights = _precluster_k1(means, weights, B)
        self._import_centroids.append(
            (slot, means, weights, float(vmin), float(vmax)))
        self._import_h_points += len(means) + 2
        # The staged centroids land through the ingest, so they ADD an
        # approximate vsum/count/recip; the exact-minus-staged delta per
        # slot (f64 host math, replicating the device's f32 per-term
        # arithmetic so it cancels the staged contribution to rounding
        # level) folds in through merge_histo_scalars, making the flushed
        # sum/count/hmean the forwarded exact values.
        m32 = means.astype(np.float32)
        w32 = weights.astype(np.float32)
        staged_sum = float((m32 * w32).astype(np.float64).sum())
        staged_cnt = float(w32.astype(np.float64).sum())
        nz = m32 != 0
        staged_rcp = float((w32[nz] / m32[nz]).astype(np.float64).sum())
        d = self._import_h_deltas.setdefault(slot, [0.0, 0.0, 0.0])
        d[0] += float(vsum) - staged_sum
        d[1] += float(count) - staged_cnt
        d[2] += float(recip) - staged_rcp
        if self._import_h_points >= self.cfg.batch_size:
            self._flush_import_centroids()

    def _import_set_locked(self, key, registers, engine_id=None):
        # the mesh engine is HLL-only (constructor check): a wire row of
        # another engine rejects THIS metric
        if engine_id is not None and engine_id != "hll":
            raise ValueError(
                f"set sketch engine mismatch: payload {engine_id!r}, "
                "mesh banks run 'hll'")
        regs = np.asarray(registers, np.uint8)
        if regs.shape[-1] != 1 << self.cfg.hll_precision:
            raise ValueError(
                f"set register width {regs.shape[-1]} != bank width "
                f"{1 << self.cfg.hll_precision}")
        slot = self._import_slot(self.set_keys, key)
        if slot < 0:
            return
        self._import_sets.append((slot, regs))
        if len(self._import_sets) >= SET_ROWS_CHUNK:
            self._flush_import_sets()

    # import_counter / import_gauge: the base engine's host accumulation;
    # only the landing (_flush_import_scalars) goes through the routed
    # scalar ingest.

    def _flush_import_centroids(self):
        if not self._import_centroids:
            return
        items, self._import_centroids = self._import_centroids, []
        self._import_h_points = 0
        # each slot gives one item (<= buffer_depth points) per landing
        # round: the recip sums see the staged points verbatim and the
        # exact-stats deltas cancel to rounding level
        by_slot: dict = {}
        for item in items:
            by_slot.setdefault(item[0], []).append(item)
        while by_slot:
            round_items = []
            for slot in list(by_slot):
                round_items.append(by_slot[slot].pop(0))
                if not by_slot[slot]:
                    del by_slot[slot]
            slots, vals, wts = [], [], []
            for slot, means, weights, vmin, vmax in round_items:
                slots.append(np.full(len(means) + 2, slot, np.int32))
                vals.append(np.concatenate(
                    [means, [vmin, vmax]]).astype(np.float32))
                # exact extremes as zero-weight samples: they update the
                # min/max, add nothing to sum/count/recip
                wts.append(np.concatenate(
                    [weights, [0.0, 0.0]]).astype(np.float32))
            for cs, (cv, cw) in self._batched(np.concatenate(slots),
                                              np.concatenate(vals),
                                              np.concatenate(wts)):
                self._add_histos(cs, cv, cw)
        deltas, self._import_h_deltas = self._import_h_deltas, {}
        if deltas:
            dslots = np.fromiter(deltas.keys(), np.int32, len(deltas))
            arr = np.array(list(deltas.values()), np.float64)
            per_shard = self.me.histogram_slots // self.S
            inf = np.float32(np.inf)
            for cs, (dsum, dcnt, drcp) in self._batched(
                    dslots, arr[:, 0].astype(np.float32),
                    arr[:, 1].astype(np.float32),
                    arr[:, 2].astype(np.float32)):
                rs, rsum, rcnt, rrcp = self._route(
                    per_shard, cs, dsum, dcnt, drcp)
                self.me.merge_histo_scalars(
                    rs, np.full_like(rsum, inf), np.full_like(rsum, -inf),
                    rsum, rcnt, rrcp)

    def _flush_import_sets(self):
        if not self._import_sets:
            return
        items, self._import_sets = self._import_sets, []
        m = 1 << self.cfg.hll_precision
        per_shard = self.me.set_slots // self.S
        nrow = SET_ROWS_CHUNK
        for i in range(0, len(items), nrow):
            chunk = items[i:i + nrow]
            slots = np.array([s for s, _ in chunk], np.int32)
            regs = np.stack([r for _, r in chunk])
            out_s = np.full((self.me.D, self.S * nrow), -1, np.int32)
            out_r = np.zeros((self.me.D, self.S * nrow, m), np.uint8)
            shard = slots // per_shard
            order = np.argsort(shard, kind="stable")
            starts = np.searchsorted(shard[order], np.arange(self.S))
            pos = np.arange(len(order)) - starts[shard[order]]
            dest = shard[order] * nrow + pos
            out_s[0, dest] = slots[order] % per_shard
            out_r[0, dest] = regs[order]
            self.me.merge_set_rows(out_s, out_r)

    def _batched(self, flat_slots, *flat_cols):
        """(slots, cols) batch_size-padded chunks of flat per-sample
        arrays (-1 slot padding): the shared pad idiom of every import
        landing, at the ingest's batch width."""
        n = self.cfg.batch_size
        for i in range(0, len(flat_slots), n):
            seg = slice(i, min(len(flat_slots), i + n))
            m = seg.stop - seg.start
            cs = np.full(n, -1, np.int32)
            cs[:m] = flat_slots[seg]
            cols = []
            for c in flat_cols:
                buf = np.zeros(n, c.dtype)
                buf[:m] = c[seg]
                cols.append(buf)
            yield cs, cols

    def _flush_import_scalars(self):
        if self._import_counter_acc:
            acc, self._import_counter_acc = self._import_counter_acc, {}
            slots = np.fromiter(acc.keys(), np.int32, len(acc))
            vals = np.fromiter(acc.values(), np.float32, len(acc))
            for cs, (cv,) in self._batched(slots, vals):
                self._add_counters(cs, cv, np.ones(len(cs), np.float32))
        if self._import_gauge_acc:
            acc, self._import_gauge_acc = self._import_gauge_acc, {}
            slots = np.fromiter(acc.keys(), np.int32, len(acc))
            vals = np.fromiter(acc.values(), np.float32, len(acc))
            for cs, (cv,) in self._batched(slots, vals):
                n = len(cs)
                seqs = np.arange(1, n + 1, dtype=np.int32) \
                    + self._gauge_seq
                self._gauge_seq += n
                self._add_gauges(cs, cv, seqs)

    def checkpoint_state(self) -> dict:
        raise NotImplementedError(
            "the mesh engine keeps no dirty bitmaps and takes no engine "
            "checkpoint (the server disables durability_engine_snapshot "
            "with a mesh, as the JAX package's does)")
