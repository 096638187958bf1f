"""AggregationEngine — banks, staging and the interval flush.

Counterpart of veneur_tpu/models/pipeline.py, the replacement for the
reference's hot path from Worker.ProcessMetric down through Server.Flush
(worker.go, flusher.go):

  ingest:  parsed UDPMetric -> host staging buffers (numpy, fixed batch
           width) -> one batch of tensor ops per full batch
  flush:   the retiring interval's banks -> compress + quantiles +
           aggregates + the device half of the set estimate +
           counter/gauge finalization -> one fetch to host -> the host
           half of the set estimate -> a columnar MetricFrame

The sketch pair comes from the engine registry (sketches/): t-digest or
REQ for histograms, HLL or ULL for sets. On the card the t-digest
compress, the HLL estimate reduction and the ULL insert are hand-written
CUDA kernels (kernels/); REQ and the ULL value histogram are eager torch.

Set updates do not land batch by batch: they are appended to a host
landing buffer (`_SetLanding`, `SET_LANDING_BATCHES` batches deep) and
land in one insert when it would overflow, at `drain_all()` and, for the
retiring interval, in the flush. Both set inserts (HLL's scatter-max,
ULL's lattice join) are order-free, so where a batch lands changes no
byte.

PyTorch runs eagerly, so the JAX package's cached executables, output
shardings and buffer donation have no counterpart here: every op is a
plain function on tensors, and the flush "program" is a Python function
over the four banks. The sketch ingest ops update their bank's sample
buffers, items or registers in place (see ops/tdigest.py, ops/hll.py,
sketches/req.py, sketches/ull.py); the banks they write are always the
engine's own live or retired banks.

The flush is incremental and double-buffered, as in the JAX package:
under the lock the tick only swaps the stage buffers, banks and dirty-
slot bitmaps against fresh ones; the retired stages land, and the flush
runs, outside the lock. When at most `flush_incremental_threshold` of
the histogram slots are dirty, only the dirty rows are gathered and
flushed, and the host overlays them on the baseline row of an empty
flush — bit-identical to flushing every row, because every op of the
flush is row-local and a fresh row is a fixed point of the compress.

This port is local-only so far: forwarding, the global tier's imports,
checkpoints, admission control and the relayed-backend fetch modes are
refused by EngineConfig (ROADMAP queue A names where each will be
ported).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import sketches
from ..ingest.parser import UDPMetric
from ..kernels import probe as kprobe
from ..metrics import InterMetric, MetricFrame, MetricType
from ..ops import scalar
from ..utils import hashing
from .worker import KeyInterner


def _precluster_k1(v, w, n_points):
    """Sort one hot slot's (value, weight) samples and cluster them into
    <= n_points weighted points over k1-spaced (tail-dense) bucket edges.
    Weighted sum and count are exactly preserved. Returns (means f64[n],
    weights f64[n])."""
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    nb = max(1, n_points)
    qi = (np.sin(np.pi * np.arange(nb + 1) / nb - np.pi / 2) + 1.0) / 2.0
    edges = np.unique(np.floor(qi * len(v)).astype(np.int64))
    edges = edges[edges < len(v)]
    wsum = np.add.reduceat(w, edges)
    vsum = np.add.reduceat(v * w, edges)
    keep = wsum > 0
    return vsum[keep] / wsum[keep], wsum[keep]


def _flush_program_body(heng, seng, agg_emit):
    """The flush computation — compress + quantiles + the configured
    aggregates + counter/gauge/set finalization — as a function of
    (hb, cb, gb, sb, qs). The full path and the incremental path run this
    same function and differ only in which rows they hand it.

    Output (all f32 unless noted):
      q        [K, P']   quantile matrix (P' includes a median column
                         when configured)
      aggcols  [K, A]    one column per configured aggregate, in
                         `agg_emit` order; `count`/`sum` columns carry
                         the 2Sum hi term only
      lo_count/lo_sum [K]  the matching lo terms (only when configured):
                         exact value = f64(hi) + f64(lo) on host
      cnt      [K]       folded count for liveness (only when `count` is
                         not a configured aggregate)
      c_hi/c_lo [Kc], g_value [Kg], g_seq i32[Kg]
      s_est [Ks] (HLL) or s_counts i32[Ks, 256] (ULL; the host half
                         of the estimate turns it into s_est)
    """
    def program(hb, cb, gb, sb, qs):
        hb = heng.compress(hb)
        agg = heng.aggregates(hb)
        out = {"q": heng.quantile(hb, qs),
               "c_hi": cb.hi, "c_lo": cb.lo,
               "g_value": gb.value, "g_seq": gb.seq}
        # the device half of the set estimate; the host half
        # (estimate_finalize) runs on the fetched arrays
        out.update(seng.estimate_device(sb))
        cols = []
        for a in agg_emit:
            if a == "count":
                out["lo_count"] = hb.count_lo
                cols.append(hb.count)
            elif a == "sum":
                out["lo_sum"] = hb.vsum_lo
                cols.append(hb.vsum)
            else:
                cols.append(agg[a])
        if cols:
            out["aggcols"] = torch.stack(cols, dim=1)
        if "count" not in agg_emit:
            out["cnt"] = agg["count"]
        return out

    return program


def _inc_bucket(n: int, num_slots: int) -> int:
    """Padded work-set width for `n` dirty slots of a `num_slots` bank:
    powers of two up to 4096, then 4096-aligned; never below 64 and never
    above the bank itself. The same ladder as the JAX package, so both
    packages flush the same work-set shapes."""
    b = 64
    while b < n and b < 4096:
        b *= 2
    if n > 4096:
        b = -(-n // 4096) * 4096
    return min(b, num_slots)


def pad_dirty_ids(ids, num_slots: int):
    """One bank's dirty-id vector padded to its _inc_bucket width with
    index 0 (padding rows duplicate row 0's work; consumers read only the
    true-D prefix)."""
    b = _inc_bucket(max(ids.size, 1), num_slots)
    pad = np.zeros(b, np.int64)
    pad[:ids.size] = ids
    return pad


def _out_bank_kind(key: str) -> int:
    """Which bank's dirty-index vector an incremental output key is
    scattered under: 0=histogram, 1=counter, 2=gauge, 3=set."""
    if key.startswith("c_"):
        return 1
    if key.startswith("g_"):
        return 2
    if key.startswith("s_"):
        return 3
    return 0


def _not_ported(feature: str, item: str):
    return NotImplementedError(
        f"{feature} is not ported to veneur_tpu_torch yet "
        f"(ROADMAP queue A, {item})")


@dataclass
class EngineConfig:
    histogram_slots: int = 1 << 15
    counter_slots: int = 1 << 14
    gauge_slots: int = 1 << 14
    set_slots: int = 1 << 12
    compression: float = 100.0
    buffer_depth: int = 256
    hll_precision: int = 14
    histogram_backend: str = "tdigest"
    set_backend: str = "hll"
    ull_precision: int = 13
    req_levels: int = 2
    req_capacity: int = 256
    batch_size: int = 8192
    percentiles: tuple = (0.5, 0.75, 0.99)
    aggregates: tuple = ("min", "max", "count")
    idle_ttl_intervals: int = 16
    forward_enabled: bool = False
    is_global: bool = False
    hostname: str = ""
    flush_fetch: str = "sync"
    flush_fetch_f16: bool = False
    flush_incremental: bool = True
    flush_incremental_threshold: float = 0.75

    def __post_init__(self):
        if self.forward_enabled:
            raise _not_ported("forward_enabled", "item 10, global tier")
        if self.is_global:
            raise _not_ported("is_global", "item 8.3, import landing")
        if self.flush_fetch != "sync" or self.flush_fetch_f16:
            raise _not_ported(
                f"flush_fetch={self.flush_fetch!r} "
                f"flush_fetch_f16={self.flush_fetch_f16!r}",
                "item 16, flush fetch modes")
        if self.histogram_backend not in sketches.HISTOGRAM_BACKENDS:
            raise ValueError(
                f"histogram_backend must be one of "
                f"{', '.join(sketches.HISTOGRAM_BACKENDS)}, got "
                f"{self.histogram_backend!r}")
        if self.set_backend not in sketches.SET_BACKENDS:
            raise ValueError(
                f"set_backend must be one of "
                f"{', '.join(sketches.SET_BACKENDS)}, got "
                f"{self.set_backend!r}")
        if not (4 <= self.ull_precision <= 16):
            raise ValueError("ull_precision must be in [4, 16]")
        if self.req_levels < 1 or self.req_capacity < 32 \
                or self.req_capacity % 8:
            raise ValueError(
                "req_levels must be >= 1 and req_capacity a multiple of 8 "
                ">= 32 (the compactor's protect/trigger sections need the "
                "room)")
        if self.buffer_depth < 8:
            raise ValueError("buffer_depth must be >= 8 (hot-slot "
                             "pre-clustering needs usable bucket room)")
        if not (0.0 < self.flush_incremental_threshold <= 1.0):
            raise ValueError(
                "flush_incremental_threshold must be in (0, 1]: it is the "
                "dirty fraction above which every row is flushed, got "
                f"{self.flush_incremental_threshold!r}")


class FlushResult:
    """Flush output: the columnar MetricFrame, the status-check metrics
    and per-flush stats. `metrics` materializes the InterMetric list
    lazily."""

    __slots__ = ("frame", "stats", "_metrics", "status_metrics")

    def __init__(self, frame=None, stats=None, status_metrics=None):
        self.frame = frame
        self.stats = stats if stats is not None else {}
        self._metrics = None
        self.status_metrics = status_metrics or []

    @property
    def metrics(self) -> list:
        if self._metrics is None:
            self._metrics = ((self.frame.to_list() if self.frame else [])
                             + self.status_metrics)
        return self._metrics


class _Stage:
    """Fixed-shape numpy staging buffer feeding one bank's batch op."""

    def __init__(self, batch_size, fields):
        self.n = 0
        self.batch_size = batch_size
        self.arrays = {
            name: np.full(batch_size, fill, dtype)
            for name, (dtype, fill) in fields.items()}

    def full(self):
        return self.n >= self.batch_size

    def put(self, **vals):
        i = self.n
        for k, v in vals.items():
            self.arrays[k][i] = v
        self.n = i + 1

    def drain(self):
        """Return padded arrays and reset. Rows past self.n keep their
        fill value (slot -1 => dropped by the ops)."""
        out = {k: a.copy() for k, a in self.arrays.items()}
        n = self.n
        if n < self.batch_size:
            out["slots"][n:] = -1
        self.n = 0
        return out


# depth of the set landing buffer, in batches of `batch_size` updates
SET_LANDING_BATCHES = 16


class _SetLanding:
    """Host landing buffer of set updates (slots i32, reg_idx i32, vals
    u8): batches are appended at ingest and land in the set bank together,
    with one host-to-device copy of each array and one insert. Rows with
    slot -1 are padding, dropped by the insert."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.n = 0
        self.slots = np.empty(capacity, np.int32)
        self.reg_idx = np.empty(capacity, np.int32)
        self.vals = np.empty(capacity, np.uint8)

    def fits(self, k: int) -> bool:
        return self.n + k <= self.capacity

    def append(self, slots, reg_idx, vals):
        i, k = self.n, len(slots)
        self.slots[i:i + k] = slots
        self.reg_idx[i:i + k] = reg_idx
        self.vals[i:i + k] = vals
        self.n = i + k

    def take(self, extra=None) -> tuple:
        """The buffered updates, followed by `extra` (slots, reg_idx,
        vals) if given, and reset. Without `extra` the arrays are views of
        the buffer, valid until the next append."""
        n, self.n = self.n, 0
        out = (self.slots[:n], self.reg_idx[:n], self.vals[:n])
        if extra is not None:
            out = tuple(np.concatenate([a, np.asarray(b, a.dtype)])
                        for a, b in zip(out, extra))
        return out


class AggregationEngine:
    def __init__(self, config: EngineConfig | None = None, device=None):
        """`device` defaults to "cuda"; with no card present that raises —
        the engine never carries on on the CPU unless asked to. On the
        card the kernel library is built (on first use) and the probe
        kernel must run before any bank is made."""
        self.cfg = cfg = config or EngineConfig()
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "AggregationEngine: no CUDA device is available; pass "
                    "device='cpu' to run on the CPU")
            if not kprobe.probe(self.device):
                raise RuntimeError(
                    f"AggregationEngine: the probe kernel gave a wrong "
                    f"result on {self.device}")
        # One ingest thread owns process(); flush() may run from another
        # thread. Ingest holds the lock per item; flush holds it only
        # across the swap and the bookkeeping.
        self.lock = threading.Lock()
        self._heng = sketches.histogram_engine(cfg)
        self._seng = sketches.set_engine(cfg)
        (self.histo_bank, self.counter_bank,
         self.gauge_bank, self.set_bank) = self._fresh_banks()

        self.histo_keys = KeyInterner(cfg.histogram_slots,
                                      cfg.idle_ttl_intervals)
        self.counter_keys = KeyInterner(cfg.counter_slots,
                                        cfg.idle_ttl_intervals)
        self.gauge_keys = KeyInterner(cfg.gauge_slots,
                                      cfg.idle_ttl_intervals)
        self.set_keys = KeyInterner(cfg.set_slots, cfg.idle_ttl_intervals)

        b = cfg.batch_size
        f32, i32 = (np.float32, 0.0), (np.int32, 0)
        self._histo_stage = _Stage(b, {"slots": (np.int32, -1),
                                       "values": f32, "weights": f32})
        self._counter_stage = _Stage(b, {"slots": (np.int32, -1),
                                         "values": f32, "weights": f32})
        self._gauge_stage = _Stage(b, {"slots": (np.int32, -1),
                                       "values": f32, "seqs": i32})
        self._set_stage = _Stage(b, {"slots": (np.int32, -1),
                                     "reg_idx": i32, "rho": (np.uint8, 0)})
        self._set_landing = _SetLanding(SET_LANDING_BATCHES * b)
        self._gauge_seq = 0
        # quantiles: the configured percentiles, plus 0.5 when the
        # `median` aggregate is requested (veneur's median is quantile 0.5)
        qs = list(cfg.percentiles)
        self._median_idx = None
        if "median" in cfg.aggregates:
            self._median_idx = len(qs)
            qs.append(0.5)
        self._qs = torch.tensor(qs, dtype=torch.float32, device=self.device)
        # %g formatting matches veneur's suffixes ("99percentile",
        # "99.9percentile")
        self._pct_sufs = [f".{p * 100:g}percentile" for p in cfg.percentiles]
        if self._median_idx is not None:
            self._pct_sufs.append(".median")
        self._agg_emit = [a for a in cfg.aggregates
                          if a in ("min", "max", "sum", "count",
                                   "avg", "hmean")]
        agg_types = tuple(MetricType.COUNTER if a == "count"
                          else MetricType.GAUGE for a in self._agg_emit)
        self._histo_types = (
            (MetricType.GAUGE,) * len(self._pct_sufs) + agg_types)
        self._agg_idx = {a: i for i, a in enumerate(self._agg_emit)}
        self._program = _flush_program_body(self._heng, self._seng,
                                            tuple(self._agg_emit))
        self._tags_cache: dict[str, list] = {}
        self._pres_bound = 4 * (cfg.histogram_slots + cfg.counter_slots
                                + cfg.gauge_slots + cfg.set_slots)
        self.samples_processed = 0
        # Dirty-slot bitmaps per bank (histogram, counter, gauge, set),
        # marked at every landing and retired at the flush swap: at any
        # instant `fresh init + dirty rows` is exactly the live bank
        # state, which is what lets the incremental flush skip cold rows.
        self._use_incremental = cfg.flush_incremental
        self._dirty = None
        if self._use_incremental:
            self._dirty = [np.zeros(n, bool) for n in self._bank_sizes()]
        # per-output-key rows of an EMPTY flush, built lazily on 1-slot
        # fresh banks
        self._flush_baseline = None
        self._last_flush_info = {"path": "full"}
        # StatusCheck sampler state: last check per (name, tags) per
        # interval, flushed as status-typed InterMetrics
        self._status: dict = {}

    def _bank_sizes(self):
        cfg = self.cfg
        return (cfg.histogram_slots, cfg.counter_slots, cfg.gauge_slots,
                cfg.set_slots)

    def _fresh_banks(self):
        dev = self.device
        kh, kc, kg, ks = self._bank_sizes()
        return (self._heng.init(kh, dev), scalar.init_counters(kc, dev),
                scalar.init_gauges(kg, dev), self._seng.init(ks, dev))

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                               device=self.device)

    @property
    def engine_stamp(self) -> str:
        """The wire stamp of this engine's sketch pair (identical strings
        to the JAX package's)."""
        return sketches.engine_stamp(self._heng, self._seng)

    # ---------------- ingest ----------------

    def process(self, m: UDPMetric):
        """Route one parsed sample to its bank's staging buffer — the
        Worker.ProcessMetric equivalent. Thread-safe against flush()."""
        with self.lock:
            self._process_locked(m)

    def _process_locked(self, m: UDPMetric):
        t = m.key.type
        self.samples_processed += 1
        if t in ("timer", "histogram"):
            slot = self.histo_keys.lookup(m.key, m.scope)
            if slot < 0:
                return
            st = self._histo_stage
            st.put(slots=slot, values=m.value, weights=1.0 / m.sample_rate)
            if st.full():
                self._dispatch_histos()
        elif t == "counter":
            slot = self.counter_keys.lookup(m.key, m.scope)
            if slot < 0:
                return
            st = self._counter_stage
            st.put(slots=slot, values=m.value, weights=1.0 / m.sample_rate)
            if st.full():
                self._dispatch_counters()
        elif t == "gauge":
            slot = self.gauge_keys.lookup(m.key, m.scope)
            if slot < 0:
                return
            st = self._gauge_stage
            self._gauge_seq += 1
            st.put(slots=slot, values=m.value, seqs=self._gauge_seq)
            if st.full():
                self._dispatch_gauges()
        elif t == "set":
            slot = self.set_keys.lookup(m.key, m.scope)
            if slot < 0:
                return
            h = hashing.set_member_hash(str(m.value))
            idx, val = self._seng.hash_update(h)
            st = self._set_stage
            st.put(slots=slot, reg_idx=idx, rho=val)
            if st.full():
                self._dispatch_sets()

    def process_service_check(self, sc):
        """Aggregate one service check: last write wins per (name, tags)
        within the interval (samplers.go sym: StatusCheck.Sample)."""
        with self.lock:
            self._status[(sc.name, tuple(sc.tags))] = sc

    # ---- pre-interned batch ingest: slots come from the caller's own
    # lookups on the engine's interners; slot -1 rows are padding.

    def _ingest_batch(self, slots, count, apply):
        with self.lock:
            n = int(count if count is not None else len(slots))
            self.samples_processed += n
            apply()

    def ingest_histo_batch(self, slots, values, weights, count=None):
        def apply():
            self.histo_bank = self._land_histos(
                self.histo_bank, self._dirty, slots, values, weights)
        self._ingest_batch(slots, count, apply)

    def ingest_counter_batch(self, slots, values, weights, count=None):
        def apply():
            self.counter_bank = self._land_counters(
                self.counter_bank, self._dirty, slots, values, weights)
        self._ingest_batch(slots, count, apply)

    def ingest_gauge_batch(self, slots, values, count=None):
        # Sequence numbers are assigned here (arrival order at the
        # engine), under the same lock as the bank swap that resets them
        def apply():
            n = int(count if count is not None else len(slots))
            seqs = np.arange(1, len(slots) + 1, dtype=np.int32) \
                + self._gauge_seq
            self._gauge_seq += n
            self.gauge_bank = self._land_gauges(
                self.gauge_bank, self._dirty, slots, values, seqs)
        self._ingest_batch(slots, count, apply)

    def ingest_set_batch(self, slots, reg_idx, rho, count=None):
        def apply():
            self._buffer_sets(slots, reg_idx, rho)
        self._ingest_batch(slots, count, apply)

    def _dispatch_histos(self):
        a = self._histo_stage.drain()
        self.histo_bank = self._land_histos(
            self.histo_bank, self._dirty, a["slots"], a["values"],
            a["weights"])

    def _dispatch_counters(self):
        a = self._counter_stage.drain()
        self.counter_bank = self._land_counters(
            self.counter_bank, self._dirty, a["slots"], a["values"],
            a["weights"])

    def _dispatch_gauges(self):
        a = self._gauge_stage.drain()
        self.gauge_bank = self._land_gauges(
            self.gauge_bank, self._dirty, a["slots"], a["values"],
            a["seqs"])

    def _dispatch_sets(self):
        a = self._set_stage.drain()
        self._buffer_sets(a["slots"], a["reg_idx"], a["rho"])

    def _buffer_sets(self, slots, reg_idx, rho):
        """Mark a batch of set updates' rows dirty and append the batch to
        the live landing buffer, landing the buffer first when the batch
        would overflow it; a batch larger than the whole buffer lands on
        its own."""
        self._mark_dirty_into(self._dirty, 3, slots)
        buf = self._set_landing
        k = len(slots)
        if k > buf.capacity:
            self.set_bank = self._insert_sets(self.set_bank, slots, reg_idx,
                                              rho)
            return
        if not buf.fits(k):
            self.set_bank = self._land_set_buffer(self.set_bank, buf)
        buf.append(slots, reg_idx, rho)

    def drain_all(self):
        """Land every staged sample and the set landing buffer in the
        live banks."""
        for st, fn in ((self._histo_stage, self._dispatch_histos),
                       (self._counter_stage, self._dispatch_counters),
                       (self._gauge_stage, self._dispatch_gauges),
                       (self._set_stage, self._dispatch_sets)):
            if st.n:
                fn()
        self.set_bank = self._land_set_buffer(self.set_bank,
                                              self._set_landing)

    # ---- landing cores: take and return the bank and mark the PASSED
    # bitmap — shared by live ingest (live banks + live bitmap) and the
    # double-buffered flush's retired landing (retired banks + bitmap).

    @staticmethod
    def _mark_dirty_into(dirty, kind: int, slots):
        if dirty is None:
            return
        d = dirty[kind]
        s = np.asarray(slots)
        if s.size:
            d[s[(s >= 0) & (s < d.size)]] = True

    def _land_histos(self, bank, dirty, slots, values, weights):
        """Land one histogram batch, sidestepping the hot-slot worst case:
        add_batch's overflow loop pays a whole-bank compress per buffer
        depth's worth of samples on ONE slot. When a batch overfills any
        slot, the hot slots' samples are pre-clustered on host to <= B
        weighted points each (the same k1 two-level scheme the digest
        uses), then land with ONE compress + merge_centroids + exact
        merge_scalars."""
        slots = np.asarray(slots)
        B = bank.buf_size
        valid = slots >= 0
        vs = slots[valid]
        self._mark_dirty_into(dirty, 0, vs)
        heng = self._heng
        if vs.size <= B:
            return heng.add_batch(bank, self._tensor(slots, np.int32),
                                  self._tensor(values, np.float32),
                                  self._tensor(weights, np.float32))
        if vs.max() > 16 * vs.size:
            uniq, cnt = np.unique(vs, return_counts=True)
            hot_ids = uniq[cnt > B]
        else:
            cnt = np.bincount(vs, minlength=1)
            hot_ids = np.nonzero(cnt > B)[0]
        values = np.asarray(values)
        weights = np.asarray(weights)
        if hot_ids.size == 0:
            return heng.add_batch(bank, self._tensor(slots, np.int32),
                                  self._tensor(values, np.float32),
                                  self._tensor(weights, np.float32))
        hot_m = np.isin(slots, hot_ids) & valid
        cold_slots = np.where(hot_m, -1, slots)
        bank = heng.add_batch(bank, self._tensor(cold_slots, np.int32),
                              self._tensor(values, np.float32),
                              self._tensor(weights, np.float32))

        out_s, out_m, out_w = [], [], []
        sc = {k: [] for k in ("min", "max", "sum", "cnt", "rcp")}
        for s in hot_ids.tolist():
            m = (slots == s) & valid
            v = values[m].astype(np.float64)
            w = weights[m].astype(np.float64)
            cm, cw = _precluster_k1(v, w, B)
            out_s.append(np.full(len(cm), s, np.int32))
            out_m.append(cm)
            out_w.append(cw)
            nz = v != 0
            sc["min"].append(v.min())
            sc["max"].append(v.max())
            sc["sum"].append((v * w).sum())
            sc["cnt"].append(w.sum())
            sc["rcp"].append((w[nz] / v[nz]).sum())
        f32 = np.float32
        # compress first so merge_centroids has a whole buffer of headroom
        bank = heng.compress(bank)
        bank = heng.merge_centroids(
            bank, self._tensor(np.concatenate(out_s), np.int32),
            self._tensor(np.concatenate(out_m), f32),
            self._tensor(np.concatenate(out_w), f32))
        return heng.merge_scalars(
            bank, self._tensor(hot_ids, np.int32),
            *(self._tensor(sc[k], f32)
              for k in ("min", "max", "sum", "cnt", "rcp")))

    def _land_counters(self, bank, dirty, slots, values, weights):
        self._mark_dirty_into(dirty, 1, slots)
        return scalar.counter_add(bank, self._tensor(slots, np.int32),
                                  self._tensor(values, np.float32),
                                  self._tensor(weights, np.float32))

    def _land_gauges(self, bank, dirty, slots, values, seqs):
        self._mark_dirty_into(dirty, 2, slots)
        return scalar.gauge_set(bank, self._tensor(slots, np.int32),
                                self._tensor(values, np.float32),
                                self._tensor(seqs, np.int32))

    def _insert_sets(self, bank, slots, reg_idx, rho):
        return self._seng.insert(bank, self._tensor(slots, np.int32),
                                 self._tensor(reg_idx, np.int32),
                                 self._tensor(rho, np.uint8))

    def _land_set_buffer(self, bank, buf, extra=None):
        """Land a landing buffer's updates, and `extra` (slots, reg_idx,
        vals) with them, in one insert into `bank`. The copies to the
        card are synchronous (pageable memory), so the buffer may be
        refilled as soon as this returns."""
        slots, reg_idx, rho = buf.take(extra)
        if not len(slots):
            return bank
        return self._insert_sets(bank, slots, reg_idx, rho)

    # ---------------- flush ----------------

    def _swap_banks(self):
        """Under the lock: return the interval's banks and hand ingest
        fresh ones (the Worker.Flush map swap)."""
        snap = (self.histo_bank, self.counter_bank,
                self.gauge_bank, self.set_bank)
        (self.histo_bank, self.counter_bank,
         self.gauge_bank, self.set_bank) = self._fresh_banks()
        return snap

    def _retire_dirty(self):
        """Under the lock, with the bank swap: hand the retiring
        interval's dirty bitmaps to the flush and install fresh zero
        bitmaps for the fresh banks."""
        retired = self._dirty
        if retired is not None:
            self._dirty = [np.zeros_like(d) for d in retired]
        return retired

    def _fetch(self, out: dict) -> dict:
        """The flush's one device-to-host transfer, then the host half of
        the set estimate (ULL's ML solve; nothing for HLL). Every fetch
        of flush outputs — full, compact and the baseline rows — goes
        through here, so all three carry the same keys."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        self._seng.estimate_finalize(host)
        return host

    def _flush_device(self, snap, dirty=None) -> dict:
        """Run the flush body on the retired banks and fetch the host
        arrays. With the retired dirty bitmaps (and incremental flush
        on), only the touched rows run, unless the histogram bank's
        dirty fraction is above the threshold."""
        if dirty is not None and self._use_incremental:
            host = self._flush_device_incremental(snap, dirty)
            if host is not None:
                return host
        self._last_flush_info = {"path": "full"}
        return self._fetch(self._program(*snap, self._qs))

    def _flush_baseline_rows(self) -> dict:
        """Per-output-key row of an EMPTY flush — what every cold row
        materializes to — from the same flush body on 1-slot fresh
        banks (fresh rows are identical whatever the bank size)."""
        if self._flush_baseline is None:
            dev = self.device
            fresh = (self._heng.init(1, dev), scalar.init_counters(1, dev),
                     scalar.init_gauges(1, dev), self._seng.init(1, dev))
            host = self._fetch(self._program(*fresh, self._qs))
            self._flush_baseline = {k: v[0] for k, v in host.items()
                                    if v.ndim}
        return self._flush_baseline

    def _flush_device_incremental(self, snap, dirty):
        """Gather only the dirty rows into a [D, ·] work set, run the
        flush body over it, and overlay the results on the baseline rows
        on host. None when the histogram bank's dirty fraction exceeds
        flush_incremental_threshold (the caller then flushes every
        row)."""
        ids = [np.nonzero(d)[0] for d in dirty]
        if ids[0].size > (self.cfg.flush_incremental_threshold
                          * dirty[0].size):
            return None
        base = self._flush_baseline_rows()
        self._last_flush_info = {
            "path": "incremental",
            "dirty": [int(i.size) for i in ids],
            "piles": [int(d.size) for d in dirty],
        }
        if all(i.size == 0 for i in ids):
            # an idle interval: every output is the baseline
            return self._scatter_host({}, ids, dirty, base)
        idx = [torch.as_tensor(pad_dirty_ids(i, d.size), device=self.device)
               for d, i in zip(dirty, ids)]
        self._last_flush_info["buckets"] = [int(p.numel()) for p in idx]
        work = [type(bank)(*(leaf.index_select(0, ix) for leaf in bank))
                for bank, ix in zip(snap, idx)]
        host_c = self._fetch(self._program(*work, self._qs))
        return self._scatter_host(host_c, ids, dirty, base)

    @staticmethod
    def _scatter_host(host_c, ids, dirty, base) -> dict:
        """Rebuild the full-[K] flush arrays from a compact [D, ·] fetch:
        each per-slot output starts as its baseline row broadcast over
        the bank and the dirty rows overlay it."""
        out = {}
        for k, row in base.items():
            kind = _out_bank_kind(k)
            full = np.empty((dirty[kind].size,) + row.shape, row.dtype)
            full[...] = row
            n = ids[kind].size
            v = host_c.get(k)
            if v is not None and n:
                full[ids[kind]] = v[:n]
            out[k] = full
        return out

    def _flush_bookkeeping(self) -> tuple:
        """Under the lock, at the tick boundary: snapshot the active key
        sets and per-interval counters, reset them, and advance the
        interner intervals."""
        active = {
            "histo": self.histo_keys.active_items(),
            "counter": self.counter_keys.active_items(),
            "gauge": self.gauge_keys.active_items(),
            "set": self.set_keys.active_items(),
        }
        status, self._status = self._status, {}
        samples, self.samples_processed = self.samples_processed, 0
        dropped = 0
        interners = (self.histo_keys, self.counter_keys,
                     self.gauge_keys, self.set_keys)
        for ki in interners:
            dropped += ki.dropped_no_slot
            ki.dropped_no_slot = 0
        histo_key_count = len(self.histo_keys)
        for ki in interners:
            ki.advance_interval()
        return active, status, samples, dropped, histo_key_count

    def _land_retired(self, snap, dirty, stages, set_landing) -> tuple:
        """Outside the lock (double-buffered flush): drain the retired
        interval's stage buffers into the retired banks, marking the
        retired bitmaps; the set stage lands together with the retired
        set landing buffer, in one insert."""
        hb, cb, gb, sb = snap
        a = stages.get("histo")
        if a is not None:
            hb = self._land_histos(hb, dirty, a["slots"], a["values"],
                                   a["weights"])
        a = stages.get("counter")
        if a is not None:
            cb = self._land_counters(cb, dirty, a["slots"], a["values"],
                                     a["weights"])
        a = stages.get("gauge")
        if a is not None:
            gb = self._land_gauges(gb, dirty, a["slots"], a["values"],
                                   a["seqs"])
        a = stages.get("set")
        extra = None
        if a is not None:
            self._mark_dirty_into(dirty, 3, a["slots"])
            extra = (a["slots"], a["reg_idx"], a["rho"])
        sb = self._land_set_buffer(sb, set_landing, extra)
        return hb, cb, gb, sb

    def flush(self, timestamp: int | None = None) -> FlushResult:
        """The Server.Flush equivalent: retire the interval's banks, run
        the flush body, assemble the MetricFrame and status checks.

        Double-buffered: the lock is held only across the swap of stage
        buffers, banks and dirty bitmaps; draining the retired stages,
        the flush body and host assembly run outside it."""
        ts = int(timestamp if timestamp is not None else time.time())
        cfg = self.cfg
        t_start = time.monotonic_ns()
        with self.lock:
            stages = {name: st.drain()
                      for name, st in (("histo", self._histo_stage),
                                       ("counter", self._counter_stage),
                                       ("gauge", self._gauge_stage),
                                       ("set", self._set_stage))
                      if st.n}
            self._gauge_seq = 0
            set_landing = self._set_landing
            self._set_landing = _SetLanding(set_landing.capacity)
            snap = self._swap_banks()
            dirty = self._retire_dirty()
            active, status, samples, dropped, histo_key_count = \
                self._flush_bookkeeping()
        t_swap = time.monotonic_ns()
        snap = self._land_retired(snap, dirty, stages, set_landing)
        host = self._flush_device(snap, dirty=dirty)
        t_device = time.monotonic_ns()

        frame = MetricFrame(ts, cfg.hostname)
        self._assemble_histos(frame, host, active["histo"])
        self._assemble_scalars(frame, host, active)
        status_metrics = [
            InterMetric(
                name=sc.name,
                timestamp=int(sc.timestamp or ts),
                value=float(sc.status),
                tags=list(sc.tags),
                type=MetricType.STATUS,
                message=sc.message,
                hostname=sc.hostname or cfg.hostname)
            for sc in status.values()]
        t_end = time.monotonic_ns()
        stats = {
            "samples": samples,
            "histo_keys": histo_key_count,
            "dropped_no_slot": dropped,
            # swap_ns is the lock-held window; merge_ns covers the
            # retired drain, the flush body and the fetch
            "swap_ns": t_swap - t_start,
            "merge_ns": t_device - t_swap,
            "assembly_ns": t_end - t_device,
            "flush_path": dict(self._last_flush_info),
        }
        return FlushResult(frame=frame, stats=stats,
                           status_metrics=status_metrics)

    def _assemble_histos(self, frame, host, infos):
        if not infos:
            return
        # aggregate matrix in f64 with the 2Sum lo terms folded back in:
        # count/sum are exact past 2^24 here
        qmat = np.asarray(host["q"], np.float64)
        if self._agg_emit:
            aggmat = host["aggcols"].astype(np.float64)
            ci = self._agg_idx.get("count")
            if ci is not None:
                aggmat[:, ci] += host["lo_count"].astype(np.float64)
            si = self._agg_idx.get("sum")
            if si is not None:
                aggmat[:, si] += host["lo_sum"].astype(np.float64)
        else:
            aggmat = np.zeros((qmat.shape[0], 0), np.float64)
        ci = self._agg_idx.get("count")
        live_cnt = (aggmat[:, ci] if ci is not None
                    else host["cnt"].astype(np.float64))
        slots = np.fromiter((t[1] for t in infos), np.int64, len(infos))
        idx = np.nonzero(live_cnt[slots] > 0)[0].tolist()
        if idx:
            pres = [self._histo_pres_of(infos[i]) for i in idx]
            rows = slots[idx]
            frame.add_block(
                [p[0] for p in pres], [p[1] for p in pres],
                np.concatenate([qmat[rows], aggmat[rows]], axis=1),
                self._histo_types)

    def _assemble_scalars(self, frame, host, active):
        """Counters (f64(hi) + f64(lo) totals), gauges (written this
        interval) and set estimates, one block each."""
        for name, mtype in (("counter", MetricType.COUNTER),
                            ("gauge", MetricType.GAUGE),
                            ("set", MetricType.GAUGE)):
            infos = active[name]
            if not infos:
                continue
            slots = np.fromiter((t[1] for t in infos), np.int64, len(infos))
            if name == "counter":
                vals = (host["c_hi"].astype(np.float64)
                        + host["c_lo"].astype(np.float64))[slots]
                keep = list(range(len(infos)))
            elif name == "gauge":
                vals = host["g_value"].astype(np.float64)[slots]
                keep = np.nonzero(host["g_seq"][slots] >= 0)[0].tolist()
            else:
                vals = host["s_est"].astype(np.float64)[slots]
                keep = list(range(len(infos)))
            if keep:
                frame.add_block(
                    [infos[i][0].name for i in keep],
                    [self._scalar_tags_of(infos[i]) for i in keep],
                    vals[keep], (mtype,))

    # ---- presentation caches (names/tags reused across flushes), kept
    # on the interner's per-key SlotInfo holder

    def _tags_of(self, joined: str) -> list:
        tl = self._tags_cache.get(joined)
        if tl is None:
            if len(self._tags_cache) > self._pres_bound:
                self._tags_cache.clear()
            tl = joined.split(",") if joined else []
            self._tags_cache[joined] = tl
        return tl

    def _scalar_tags_of(self, info) -> list:
        holder = info[3]
        if holder.pres is None:
            holder.pres = self._tags_of(info[0].joined_tags)
        return holder.pres

    def _histo_pres_of(self, info) -> tuple:
        holder = info[3]
        if holder.pres is None:
            key = info[0]
            nm = key.name
            names = tuple([nm + s for s in self._pct_sufs]
                          + [f"{nm}.{a}" for a in self._agg_emit])
            holder.pres = (names, self._tags_of(key.joined_tags))
        return holder.pres
