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

Two tiers, as in the JAX package (flusher.go semantics):
  * a local engine with `forward_enabled` routes by scope: mixed-scope
    histograms/timers emit the configured local aggregates and forward
    their digest (percentiles are computed globally), mixed sets
    forward their registers, `veneurlocalonly` keys flush fully
    locally and `veneurglobalonly` keys only forward; counters and
    gauges stay local unless global-only. `flush(forward_kind=...)`
    returns the forwarded state as `FlushResult.export` (a
    ForwardExport; cluster/wire.py turns it into metricpb bytes), full
    or, from the retired dirty bitmap, delta.
  * a global engine (`is_global`) takes forwarded metrics through
    `import_list` / `import_*`: counters and gauges accumulate on host,
    set registers join their rows, and digests are staged and land in
    batches — each slot's pile clustered by the histogram engine's
    `cluster_rows` (eager torch), then merged and compressed (the
    compress kernel on the card) — at a staging bound, and for the
    retiring interval outside the lock in the flush.
A durable global checkpoints its engines at each flush boundary
(`checkpoint_state`: the live banks' dirty rows, gathered on the device)
and a restarted one rebuilds them (`restore_checkpoint`); the records'
bytes are the JAX package's (durability/records.py). The server's
admission controller attaches through `attach_admission`.

The flush's fetch takes one of the JAX package's four modes
(`flush_fetch`, fetch_flush_outputs): "sync" (`.cpu()` a leaf at a
time), "staged" (a copy on the device first), "host" (non-blocking copies
into pinned host buffers kept per shape, one synchronize; "staged" on a
CPU engine) and "async" (the same into fresh pinned buffers), each
optionally compact (`flush_fetch_f16`: quantiles and inexact aggregates
as f16, the f32 twins and 2Sum lo terms fetched only when a sentinel asks).
The multi-device engine (parallel/engine.py) subclasses this one.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from .. import kernels, sketches
from ..ingest.parser import GLOBAL_ONLY, LOCAL_ONLY, MetricKey, UDPMetric
from ..kernels import probe as kprobe
from ..metrics import InterMetric, MetricFrame, MetricType
from ..ops import scalar
from ..utils import hashing
from .worker import FOLD_SLOT, KeyInterner

logger = logging.getLogger(__name__)

_INF_F = float("inf")

# Widest per-slot centroid pile the import landing hands to one
# cluster_rows call; wider (untrusted) forwarded piles are clustered in
# chunks of this size first.
_IMPORT_W_CAP = 4096

# Forwarded digests are staged until this many centroids (or digests)
# are pending, then land in one batched round.
_IMPORT_STAGE_CENTROIDS = 1 << 20
_IMPORT_STAGE_DIGESTS = 8192

# staged imported set rows that land together
_IMPORT_STAGE_SETS = 256


def _precluster_k1(v, w, n_points, keep_extremes=False):
    """Sort one hot slot's (value, weight) samples and cluster them into
    <= n_points weighted points over k1-spaced (tail-dense) bucket edges.
    Weighted sum and count are exactly preserved; with `keep_extremes`
    the true min and max survive as singleton points (the mesh engine's
    sidestep, which has no separate exact-stats merge). Returns (means
    f64[n], weights f64[n])."""
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    if keep_extremes:
        if len(v) <= 2 or n_points <= 3:
            return v, w  # nothing (or no room) to cluster between ends
        nb = n_points - 2
        qi = (np.sin(np.pi * np.arange(nb + 1) / nb - np.pi / 2)
              + 1.0) / 2.0
        edges = np.unique(
            np.floor(1 + qi * (len(v) - 2)).astype(np.int64))
        edges = edges[(edges >= 1) & (edges < len(v) - 1)]
        if edges.size == 0:
            edges = np.array([1], np.int64)
        wsum = np.add.reduceat(w[1:-1], edges - 1)
        vsum = np.add.reduceat((v * w)[1:-1], edges - 1)
        keep = wsum > 0
        return (np.concatenate([[v[0]], vsum[keep] / wsum[keep],
                                [v[-1]]]),
                np.concatenate([[w[0]], wsum[keep], [w[-1]]]))
    nb = max(1, n_points)
    qi = (np.sin(np.pi * np.arange(nb + 1) / nb - np.pi / 2) + 1.0) / 2.0
    edges = np.unique(np.floor(qi * len(v)).astype(np.int64))
    edges = edges[edges < len(v)]
    wsum = np.add.reduceat(w, edges)
    vsum = np.add.reduceat(v * w, edges)
    keep = wsum > 0
    return vsum[keep] / wsum[keep], wsum[keep]


def _absmax(t):
    """max |t| as a 0-d f32 tensor (0 for an empty tensor)."""
    if t.numel() == 0:
        return t.new_zeros((), dtype=torch.float32)
    return t.abs().max().float()


def _flush_program_body(heng, seng, agg_emit, fwd_out=False, compact=False):
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
      h_* / s_regs       the raw forward-export state (fwd_out only): the
                         engine's forward leaves and the set registers

    `compact=True` (flush_fetch_f16) replaces `q` and `aggcols` with the
    JAX package's half-width wire encoding:
      q16/lp16 f16        the quantiles and the inexact aggregate columns
      aggcols_hp          the count/sum hi columns, f32 (exactness)
      overflow_mag        max |value| under q16/lp16: the host fetches
                          the f32 twins when it reaches f16's saturation
      tiny_mag            the least nonzero |value|: the twins are
                          fetched too when it is below f16's min normal
      lo_mag              max |2Sum lo|: lo_count/lo_sum are fetched only
                          when it is nonzero
      q32/lp32, lo_*      the full-precision twins, left on the device
                          unless a sentinel asks for them
                          (fetch_flush_outputs)
    """
    def program(hb, cb, gb, sb, qs):
        hb = heng.compress(hb)
        agg = heng.aggregates(hb)
        q = heng.quantile(hb, qs)
        out = {"c_hi": cb.hi, "c_lo": cb.lo,
               "g_value": gb.value, "g_seq": gb.seq}
        # the device half of the set estimate; the host half
        # (estimate_finalize) runs on the fetched arrays
        out.update(seng.estimate_device(sb))
        cols, hp_cols, lp_cols, lo_terms = [], [], [], []
        for a in agg_emit:
            if a == "count":
                out["lo_count"] = hb.count_lo
                hp_cols.append(hb.count)
                lo_terms.append(hb.count_lo)
                cols.append(hb.count)
            elif a == "sum":
                out["lo_sum"] = hb.vsum_lo
                hp_cols.append(hb.vsum)
                lo_terms.append(hb.vsum_lo)
                cols.append(hb.vsum)
            else:
                lp_cols.append(agg[a])
                cols.append(agg[a])
        if compact:
            out["q16"] = q.half()
            out["q32"] = q
            srcs = [q]
            if hp_cols:
                out["aggcols_hp"] = torch.stack(hp_cols, dim=1)
            if lp_cols:
                lp = torch.stack(lp_cols, dim=1)
                out["lp16"] = lp.half()
                out["lp32"] = lp
                srcs.append(lp)
            out["overflow_mag"] = torch.stack(
                [_absmax(t) for t in srcs]).max()
            # the least nonzero magnitude: below f16's min normal a value
            # loses relative precision on the wire
            out["tiny_mag"] = torch.stack([
                torch.where(t == 0, torch.full_like(t, _INF_F),
                            t.abs()).min() if t.numel()
                else t.new_full((), _INF_F)
                for t in srcs]).min()
            out["lo_mag"] = (torch.stack([_absmax(t) for t in lo_terms])
                             .max() if lo_terms
                             else q.new_zeros((), dtype=torch.float32))
        else:
            out["q"] = q
            if cols:
                out["aggcols"] = torch.stack(cols, dim=1)
        if "count" not in agg_emit:
            out["cnt"] = agg["count"]
        if fwd_out:
            out.update(heng.forward_leaves(hb))
            out["s_regs"] = sb.registers
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


# the flush_fetch modes (EngineConfig.flush_fetch)
FETCH_MODES = ("sync", "staged", "host", "async")

# compact-mode outputs that stay on the device unless their sentinel asks
# for them: the full-precision twins and the 2Sum lo terms
_LAZY_KEYS = ("q32", "lp32", "lo_count", "lo_sum")
_F16_SAT = 61440.0      # |x| from here on rounds into f16's overflow zone
_F16_TINY = 2.0 ** -14  # f16's min normal: below it values are subnormal


def _fetch_leaves(out: dict, mode: str, pinned: dict | None) -> dict:
    """Move a flat dict of tensors to host numpy arrays under one fetch
    mode. "sync": `.cpu()` a leaf at a time. "staged": copy the leaves on
    the device first, then fetch the copies. "host": a non-blocking copy
    of each leaf into a pinned host buffer kept in `pinned` (one per key
    and shape), then one synchronize; the arrays returned are copied out
    of the buffers, which the next fetch overwrites. "async": the same
    into fresh pinned buffers. A leaf on the CPU is taken as it is under
    every mode (there is no transfer to stage)."""
    if mode == "staged":
        out = {k: v.clone() for k, v in out.items()}
    if mode in ("sync", "staged"):
        return {k: v.cpu().numpy() for k, v in out.items()}
    host, bufs, devices = {}, {}, set()
    for k, v in out.items():
        if v.is_cpu:
            host[k] = v.numpy()
            continue
        if mode == "host":
            key = (k, tuple(v.shape), v.dtype)
            buf = pinned.get(key)
            if buf is None:
                buf = pinned[key] = torch.empty(
                    v.shape, dtype=v.dtype, pin_memory=True)
        else:
            buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        buf.copy_(v, non_blocking=True)
        bufs[k] = buf
        devices.add(v.device)
    for dev in devices:
        torch.cuda.synchronize(dev)
    for k, buf in bufs.items():
        host[k] = buf.numpy().copy() if mode == "host" else buf.numpy()
    return host


def fetch_flush_outputs(out: dict, mode: str, pinned: dict | None = None):
    """The flush outputs on the host under a flush_fetch mode — the one
    definition every engine's fetch goes through. A compact (f16) output
    set leaves its full-precision twins and 2Sum lo terms on the device
    and fetches them in a second, plain transfer only when its sentinel
    scalars ask: nonzero lo terms, or a value in f16's saturation zone or
    below its min normal."""
    lazy = {}
    if "lo_mag" in out:
        lazy = {k: out[k] for k in _LAZY_KEYS if k in out}
        out = {k: v for k, v in out.items() if k not in lazy}
    host = _fetch_leaves(out, mode, pinned)
    if lazy:
        need = []
        if float(host["lo_mag"]) != 0.0:
            need += [k for k in ("lo_count", "lo_sum") if k in lazy]
        if (float(host["overflow_mag"]) >= _F16_SAT
                or float(host["tiny_mag"]) < _F16_TINY):
            need += [k for k in ("q32", "lp32") if k in lazy]
        if need:
            host.update(_fetch_leaves({k: lazy[k] for k in need}, "sync",
                                      None))
    return host


def decompact_flush_host(host: dict, agg_emit: tuple) -> dict:
    """Rebuild the standard host contract (q [K, P], aggcols [K, A],
    lo_*) from a compact (f16) fetch, so that assembly is one
    implementation for both wire modes; a standard fetch passes through
    unchanged."""
    if "lo_mag" not in host:
        return host
    q = host.pop("q32", None)
    q16 = host.pop("q16")
    host["q"] = (np.asarray(q16, np.float32) if q is None
                 else np.asarray(q))
    lp = host.pop("lp32", None)
    lp16 = host.pop("lp16", None)
    if lp is None and lp16 is not None:
        lp = np.asarray(lp16, np.float32)
    hp = host.pop("aggcols_hp", None)
    if agg_emit:
        hi = li = 0
        cols = []
        for a in agg_emit:
            if a in ("count", "sum"):
                cols.append(np.asarray(hp[:, hi], np.float32))
                hi += 1
            else:
                cols.append(np.asarray(lp[:, li], np.float32))
                li += 1
        host["aggcols"] = np.stack(cols, axis=1)
    k = host["q"].shape[0]
    if "count" in agg_emit and "lo_count" not in host:
        host["lo_count"] = np.zeros(k, np.float32)
    if "sum" in agg_emit and "lo_sum" not in host:
        host["lo_sum"] = np.zeros(k, np.float32)
    return host


class ImportFoldReroute(Exception):
    """An over-budget imported key's fold target is homed on another
    engine (overload defense, multi-worker server): raised out of the
    engine's import_* before any staging, carrying the fold key so the
    caller can re-route the aggregate to its home engine."""

    def __init__(self, key: MetricKey, digest: int):
        super().__init__(f"fold of imported key rehomes to {key.name}")
        self.key = key
        self.digest = digest


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
        if self.flush_fetch not in FETCH_MODES:
            raise ValueError(
                f"flush_fetch={self.flush_fetch!r}: must be "
                f"{'/'.join(FETCH_MODES)}")
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


@dataclass
class ForwardExport:
    """Global-scope state to send upstream, one entry per key — the
    Export()/Metric() payloads of the samplers (samplers.go sym:
    Histo.Metric, Set.Export, Counter.Export)."""
    histograms: list = dc_field(default_factory=list)
    # (key, means f32[n], weights f32[n], min, max, sum, count, recip)
    sets: list = dc_field(default_factory=list)        # (key, registers u8[m])
    counters: list = dc_field(default_factory=list)    # (key, value)
    gauges: list = dc_field(default_factory=list)      # (key, value)
    # which set engine produced `sets` (selects the register wire code);
    # histograms are engine-agnostic weighted points on the wire
    set_engine: str = "hll"
    # the admission controller's per-prefix cardinality sketches riding
    # to the global tier, [(prefix, bytes registers)]: the server fills
    # them in at forward time (advisory, merged by max at the receiver)
    prefix_sketches: list = dc_field(default_factory=list)
    # "full": every interned global counter and forwarded set ships,
    # idle ones as zero totals / empty registers (the receiver's liveness
    # refresh); "delta": only the keys the dirty bitmap saw land this
    # interval. Histograms and gauges are touched-only under either kind:
    # a zero-count histogram row is dropped by the receiver's flush, and
    # a synthetic zero gauge would overwrite its last write.
    kind: str = "full"


class FlushResult:
    """Flush output: the columnar MetricFrame, the forward export, the
    status-check metrics and per-flush stats. `metrics` materializes the
    InterMetric list lazily."""

    __slots__ = ("frame", "export", "stats", "_metrics", "status_metrics")

    def __init__(self, frame=None, export=None, stats=None,
                 status_metrics=None):
        self.frame = frame
        self.export = export if export is not None else ForwardExport()
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


# the batch widths warm_ingest_kernels lands besides the pump's own: the
# pump's batches take any width up to its own, and the device picks other
# kernels (sorts, reductions) for short batches than for long ones
_WARM_WIDTHS = (1, 32, 256, 1024, 4096)


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


def require_device(device, who: str) -> None:
    """Raise unless `device` can run the engine: a CUDA device needs a
    card, on which the kernel library is built (on first use) and the
    probe kernel must give the right result."""
    if device.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available; pass device='cpu' to "
            "run on the CPU")
    if not kprobe.probe(device):
        raise RuntimeError(
            f"{who}: the probe kernel gave a wrong result on {device}")


class AggregationEngine:
    # the mesh engine (parallel/engine.py) turns both off: its sharded
    # banks carry no dirty bitmaps, and its flush lands everything staged
    # under the lock before the swap
    _incremental_capable = True
    _double_buffer_capable = True

    def __init__(self, config: EngineConfig | None = None, device=None):
        """`device` defaults to "cuda"; with no card present that raises —
        the engine never carries on on the CPU unless asked to. On the
        card the kernel library is built (on first use) and the probe
        kernel must run before any bank is made."""
        self.cfg = cfg = config or EngineConfig()
        # One ingest thread owns process(); flush() may run from another
        # thread. Ingest holds the lock per item; flush holds it only
        # across the swap and the bookkeeping.
        self.lock = threading.Lock()
        # ns the batch landings waited to take the lock, ever (the
        # native pump reads it around each cycle)
        self.lock_wait_ns = 0
        self._heng = sketches.histogram_engine(cfg)
        self._seng = sketches.set_engine(cfg)
        self._setup_device(device)
        self._setup_fetch()

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
        self._histo_full_types = (
            (MetricType.GAUGE,) * len(self._pct_sufs) + agg_types)
        self._histo_agg_types = agg_types
        self._agg_idx = {a: i for i, a in enumerate(self._agg_emit)}
        # a forwarding local (a global never forwards): the flush body
        # also returns the forward leaves, and assembly routes by scope
        self._fwd_out = cfg.forward_enabled and not cfg.is_global
        self._program = _flush_program_body(self._heng, self._seng,
                                            tuple(self._agg_emit),
                                            self._fwd_out,
                                            cfg.flush_fetch_f16)
        self._tags_cache: dict[str, list] = {}
        self._pres_bound = 4 * (cfg.histogram_slots + cfg.counter_slots
                                + cfg.gauge_slots + cfg.set_slots)
        self.samples_processed = 0
        # overload defense (ingest/admission.py), wired by
        # attach_admission
        self._adm = None
        self._adm_index = 0
        self._adm_n = 1
        self._adm_reroute = None
        # Dirty-slot bitmaps per bank (histogram, counter, gauge, set),
        # marked at every landing and retired at the flush swap: at any
        # instant `fresh init + dirty rows` is exactly the live bank
        # state, which is what lets the incremental flush skip cold rows.
        # The checkpoint (enable_dirty_tracking, checkpoint_state) is the
        # bitmaps' second consumer: armed by the incremental flush here or
        # by the durable server; `_delta_threshold` is the dirty fraction
        # past which a checkpoint fetches whole leaves instead of a gather.
        self._use_incremental = (cfg.flush_incremental
                                 and self._incremental_capable)
        self._dirty = None
        self._delta_threshold = 0.5
        if self._use_incremental:
            self._dirty = [np.zeros(n, bool) for n in self._bank_sizes()]
        # per-output-key rows of an EMPTY flush, built lazily on 1-slot
        # fresh banks
        self._flush_baseline = None
        self._last_flush_info = {"path": "full"}
        # StatusCheck sampler state: last check per (name, tags) per
        # interval, flushed as status-typed InterMetrics
        self._status: dict = {}
        # events of the interval, handed to the server's sinks as they are
        self._pending_events: list = []
        # the global tier's staged imports (batched, so an interval's
        # forwards cost a handful of landings, not one per key) and the
        # applied-op watermark of import_list
        self._import_centroids: list = []
        self._import_centroid_total = 0
        self._import_sets: list = []          # (slot, registers u8[m])
        self._import_counter_acc: dict = {}   # slot -> host f64 sum
        self._import_gauge_acc: dict = {}     # slot -> last value
        self.last_import_op = 0

    def _setup_device(self, device):
        """Place the engine: its device and its live banks there."""
        self.device = torch.device("cuda" if device is None else device)
        require_device(self.device, "AggregationEngine")
        # vlint: disable=DS01 reason=initial fresh-bank build, not a
        # data landing: fresh rows carry nothing to mark
        (self.histo_bank, self.counter_bank,
         self.gauge_bank, self.set_bank) = self._fresh_banks()

    def _setup_fetch(self):
        """Resolve the flush_fetch mode. "host" needs pinned host memory,
        which a CPU engine has not: it logs the JAX package's warning and
        fetches "staged"."""
        self._fetch_mode = self.cfg.flush_fetch
        self._pinned: dict = {}      # "host" mode's buffers, by key+shape
        self._fetch_bytes = 0        # bytes fetched by the current flush
        if self._fetch_mode == "host" and self.device.type != "cuda":
            logger.warning("flush_fetch=host: backend lacks pinned_host "
                           "memory; using staged")
            self._fetch_mode = "staged"

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

    def engines_describe(self) -> dict:
        """JSON-ready sketch-engine description (/debug/flush): the JAX
        package's dict, with where the kernels run ("cuda", or "plain"
        for their plain versions on the CPU) and the process's launch
        counts in place of its kernel arms."""
        d = sketches.describe(self._heng, self._seng)
        d["kernels"] = {
            "route": "cuda" if self.device.type == "cuda" else "plain",
            "launches": dict(kernels.launches),
        }
        return d

    # ---------------- ingest ----------------

    def attach_admission(self, adm, *, index: int = 0, n: int = 1,
                         reroute=None):
        """Wire the Server's admission controller into this engine's
        slot minting (overload defense): each KeyInterner consults it
        before allocating, and over-budget keys' samples re-stage onto
        their prefix's `__other__` key via `_fold` instead of minting
        a bank slot. A map-hit key never touches the controller, so
        the steady-state ingest path is unchanged.

        `index`/`n`/`reroute` single-home the fold keys in a
        multi-worker server: a fold rewrite whose digest routes to a
        DIFFERENT engine is handed back to the server's router
        (`reroute`) instead of minting a local slot, so one flush
        never emits the same `__other__` series from two engines."""
        self._adm = adm
        self._adm_index = index
        self._adm_n = n
        self._adm_reroute = reroute
        for ki in (self.histo_keys, self.counter_keys,
                   self.gauge_keys, self.set_keys):
            ki.admission = adm

    def _fold(self, interner, m: UDPMetric):
        """Resolve an over-budget sample (lookup returned FOLD_SLOT)
        into (fold-rewritten metric, slot), or (None, -1) when the
        sample left this engine: sampled out (admission counts it —
        and it must then not count as processed either, the accounting
        identity `received == applied + counted_degraded` is exact),
        re-routed to the fold key's home engine (counted as folded
        here; the home engine processes it as an ordinary sample), or
        refused by the full bank (the interner's dropped_no_slot
        accounting, exactly like any over-full sample — NOT counted
        as a fold)."""
        fm = self._adm.fold_metric(m, self._fwd_out)
        if fm is None:
            self.samples_processed -= 1
            return None, -1
        if self._adm_n > 1 and fm.digest % self._adm_n != self._adm_index:
            self.samples_processed -= 1      # the home engine counts it
            self._adm.count_folded()
            self._adm_reroute(fm)
            return None, -1
        slot = interner.lookup(fm.key, fm.scope)
        if slot < 0:
            return None, -1
        self._adm.count_folded()
        return fm, slot

    def _fold_import_slot(self, interner, key: MetricKey) -> int:
        """Import-path fold (the global tier's Combine): an over-budget
        forwarded key's aggregate lands in its prefix's `__other__` slot
        through the same merge (no sampling: a forwarded digest is an
        interval aggregate, not a sample). A fold key homed on another
        engine raises ImportFoldReroute."""
        if self._adm is None:
            return -1
        fk, digest = self._adm.fold_key(key)
        if self._adm_n > 1 and digest % self._adm_n != self._adm_index:
            self._adm.count_folded()
            raise ImportFoldReroute(fk, digest)
        slot = interner.lookup(fk, GLOBAL_ONLY)
        if slot >= 0:
            self._adm.count_folded()
        return slot

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
                if slot != FOLD_SLOT:
                    return
                m, slot = self._fold(self.histo_keys, m)
                if m is None:
                    return
            st = self._histo_stage
            st.put(slots=slot, values=m.value, weights=1.0 / m.sample_rate)
            if st.full():
                self._dispatch_histos()
        elif t == "counter":
            slot = self.counter_keys.lookup(m.key, m.scope)
            if slot < 0:
                if slot != FOLD_SLOT:
                    return
                m, slot = self._fold(self.counter_keys, m)
                if m is None:
                    return
            st = self._counter_stage
            st.put(slots=slot, values=m.value, weights=1.0 / m.sample_rate)
            if st.full():
                self._dispatch_counters()
        elif t == "gauge":
            slot = self.gauge_keys.lookup(m.key, m.scope)
            if slot < 0:
                if slot != FOLD_SLOT:
                    return
                m, slot = self._fold(self.gauge_keys, m)
                if m is None:
                    return
            st = self._gauge_stage
            self._gauge_seq += 1
            st.put(slots=slot, values=m.value, seqs=self._gauge_seq)
            if st.full():
                self._dispatch_gauges()
        elif t == "set":
            slot = self.set_keys.lookup(m.key, m.scope)
            if slot < 0:
                if slot != FOLD_SLOT:
                    return
                m, slot = self._fold(self.set_keys, m)
                if m is None:
                    return
            h = hashing.set_member_hash(str(m.value))
            idx, val = self._seng.hash_update(h)
            st = self._set_stage
            st.put(slots=slot, reg_idx=idx, rho=val)
            if st.full():
                self._dispatch_sets()

    def process_event(self, ev):
        with self.lock:
            self._pending_events.append(ev)

    def process_service_check(self, sc):
        """Aggregate one service check: last write wins per (name, tags)
        within the interval (samplers.go sym: StatusCheck.Sample)."""
        with self.lock:
            self._status[(sc.name, tuple(sc.tags))] = sc

    def drain_events(self):
        """The events received since the last call, and no service
        checks: those flush as status rows (the JAX package's pair)."""
        with self.lock:
            evs, self._pending_events = self._pending_events, []
        return evs, []

    # ---- pre-interned batch ingest: slots come from the caller's own
    # lookups on the engine's interners, or from the native bridge's
    # interner; slot -1 rows are padding. `mark` (if given) runs under
    # the engine lock before the landing, with the batch's slots[:count],
    # so the caller's touched set agrees with the bank the samples land
    # in across a concurrent flush swap. Callers must not mutate the
    # arrays they pass: on the CPU the engine's tensors alias them.

    def _ingest_batch(self, slots, count, mark, apply):
        t0 = time.monotonic_ns()
        with self.lock:
            self.lock_wait_ns += time.monotonic_ns() - t0
            n = int(count if count is not None else len(slots))
            if mark is not None:
                mark(slots[:n])
            self.samples_processed += n
            apply(n)

    def ingest_histo_batch(self, slots, values, weights, count=None,
                           mark=None):
        def apply(n):
            self.histo_bank = self._land_histos(
                self.histo_bank, self._dirty, slots, values, weights)
        self._ingest_batch(slots, count, mark, apply)

    def ingest_counter_batch(self, slots, values, weights, count=None,
                             mark=None):
        def apply(n):
            self.counter_bank = self._land_counters(
                self.counter_bank, self._dirty, slots, values, weights)
        self._ingest_batch(slots, count, mark, apply)

    def ingest_gauge_batch(self, slots, values, count=None, mark=None):
        # Sequence numbers are assigned here (arrival order at the
        # engine), under the same lock as the bank swap that resets them
        def apply(n):
            seqs = np.arange(1, len(slots) + 1, dtype=np.int32) \
                + self._gauge_seq
            self._gauge_seq += n
            self.gauge_bank = self._land_gauges(
                self.gauge_bank, self._dirty, slots, values, seqs)
        self._ingest_batch(slots, count, mark, apply)

    def ingest_set_batch(self, slots, reg_idx, rho, count=None, mark=None):
        def apply(n):
            self._buffer_sets(slots, reg_idx, rho)
        self._ingest_batch(slots, count, mark, apply)

    def warm_ingest_kernels(self, b: int):
        """Run the four batch-ingest landings once at width `b` on scratch
        banks of the live banks' sizes, so the device's first use of
        their ops at these shapes (the lazy loading of the kernels each
        shape picks, the allocator's first blocks) is paid here and not
        by the first landing under the engine lock; and at the shorter
        widths of _WARM_WIDTHS, whose ops pick other kernels. The rows are
        real (padding alone leaves the masked ops on empty tensors, which
        launch nothing), one a slot in turn, so no buffer overflows and
        no compress runs; the live banks are not touched. The native
        pump's server calls it at the pump's width before the pump
        starts."""
        kh, kc, kg, ks = self._bank_sizes()
        hb, cb, gb, sb = self._fresh_banks()
        for w in sorted({min(b, w) for w in _WARM_WIDTHS} | {b}):
            ones = np.ones(w, np.float32)
            idx = np.arange(w, dtype=np.int32)
            hb = self._land_histos(hb, None, idx % kh, ones, ones)
            cb = self._land_counters(cb, None, idx % kc, ones, ones)
            gb = self._land_gauges(gb, None, idx % kg, ones, idx + 1)
            sb = self._insert_sets(sb, idx % ks, idx % 64,
                                   np.ones(w, np.uint8))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self):
        """Run every device path of serving once on scratch banks, so the
        device's first use of their ops (the lazy loading of the kernels
        each op and shape picks, the allocator's first blocks) is paid
        here and not by the first landing under the engine lock or by
        the first flush: the ingest landings at `batch_size` and the
        shorter widths (warm_ingest_kernels); the hot-slot sidestep on a
        one-row histogram bank, its one slot over its buffer depth (the
        compress, merge_centroids and merge_scalars); and the flush body
        over fresh banks, through _flush_device with one dirty slot a
        bank when the incremental flush is on (the baseline rows and a
        one-row work set), over every row when it is off. The sidestep
        and the flush run the same ops, and on the card the same kernels,
        on a few rows as on the whole bank, which the plain versions on
        the CPU would pay for by the row. The live banks, the dirty
        bitmaps, the interners and the counters are not touched; the
        cached baseline rows and the last flush's path are put back as
        they were. The counterpart of the JAX package's
        AggregationEngine.warmup, which compiles the same programs."""
        self.warm_ingest_kernels(self.cfg.batch_size)
        baseline, info = self._flush_baseline, self._last_flush_info
        hb = self._heng.init(1, self.device)
        B = hb.buf_size
        w = max(self.cfg.batch_size, B + 1)
        slots = np.full(w, -1, np.int32)
        slots[:B + 1] = 0
        values = np.zeros(w, np.float32)
        values[:B + 1] = np.arange(1, B + 2)
        self._land_histos(hb, None, slots, values, np.ones(w, np.float32))
        del hb
        dirty = None
        if self._use_incremental:
            dirty = [np.zeros(n, bool) for n in self._bank_sizes()]
            for d in dirty:
                d[0] = True
        self._flush_device(self._fresh_banks(), [], dirty=dirty)
        self._flush_baseline, self._last_flush_info = baseline, info
        self._sync()

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
        # vlint: disable=DS01 reason=lands the set landing buffer,
        # whose rows _buffer_sets marked as it appended them; the
        # staged dispatches above mark in their landing cores
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

    # ---------------- import (the global tier's Combine path) --------

    def _import_slot(self, interner, key: MetricKey) -> int:
        slot = interner.lookup(key, GLOBAL_ONLY)
        if slot == FOLD_SLOT:
            slot = self._fold_import_slot(interner, key)
        return slot

    def import_histogram(self, key: MetricKey, means, weights, vmin, vmax,
                         vsum, count, recip=0.0):
        """Stage a forwarded digest for merging — Histo.Combine
        (worker.go sym: Worker.ImportMetricGRPC)."""
        with self.lock:
            self._import_histogram_locked(key, means, weights, vmin,
                                          vmax, vsum, count, recip)

    def _import_histogram_locked(self, key, means, weights, vmin, vmax,
                                 vsum, count, recip=0.0):
        slot = self._import_slot(self.histo_keys, key)
        if slot < 0:
            return
        means = np.asarray(means, np.float32)
        self._import_centroids.append(
            (slot, means, np.asarray(weights, np.float32),
             float(vmin), float(vmax), float(vsum), float(count),
             float(recip)))
        self._import_centroid_total += len(means)
        if (len(self._import_centroids) >= _IMPORT_STAGE_DIGESTS
                or self._import_centroid_total
                >= _IMPORT_STAGE_CENTROIDS):
            self._flush_import_centroids()

    def import_set(self, key: MetricKey, registers, engine_id=None):
        with self.lock:
            self._import_set_locked(key, registers, engine_id)

    def _import_set_locked(self, key, registers, engine_id=None):
        # a register row of another engine or width rejects this metric,
        # never joins a bank whose update rule it does not share
        if engine_id is not None and engine_id != self._seng.id:
            raise ValueError(
                f"set sketch engine mismatch: payload {engine_id!r}, "
                f"bank runs {self._seng.id!r}")
        regs = np.asarray(registers, np.uint8)
        if regs.shape[-1] != self.set_bank.num_registers:
            raise ValueError(
                f"set register width {regs.shape[-1]} != bank width "
                f"{self.set_bank.num_registers}")
        slot = self._import_slot(self.set_keys, key)
        if slot < 0:
            return
        self._import_sets.append((slot, regs))
        if len(self._import_sets) >= _IMPORT_STAGE_SETS:
            self._flush_import_sets()

    def import_counter(self, key: MetricKey, value: float):
        with self.lock:
            self._import_counter_locked(key, value)

    def _import_counter_locked(self, key, value):
        slot = self._import_slot(self.counter_keys, key)
        if slot < 0:
            return
        # summed on host in float64, landed once per flush
        self._import_counter_acc[slot] = (
            self._import_counter_acc.get(slot, 0.0) + float(value))

    def import_gauge(self, key: MetricKey, value: float):
        with self.lock:
            self._import_gauge_locked(key, value)

    def _import_gauge_locked(self, key, value):
        slot = self._import_slot(self.gauge_keys, key)
        if slot < 0:
            return
        self._import_gauge_acc[slot] = float(value)   # last write wins

    def import_list(self, op_id: int, pbs) -> tuple:
        """Apply one import op's metricpb.Metric messages under ONE lock
        hold, advancing the applied-op watermark `last_import_op` in the
        same critical section. Returns (rerouted, rejected): fold keys
        homed on other engines as (ImportFoldReroute, pb) pairs, and
        per-metric failures as (pb, exception) pairs — one corrupt
        metric rejects itself, not the op."""
        from ..cluster import wire
        rerouted, rejected = [], []
        with self.lock:
            for pb in pbs:
                try:
                    wire.apply_metric_to_engine_locked(self, pb)
                except ImportFoldReroute as fr:
                    rerouted.append((fr, pb))
                except Exception as e:
                    rejected.append((pb, e))
            if op_id > self.last_import_op:
                self.last_import_op = op_id
        return rerouted, rejected

    def _flush_import_sets(self):
        items, self._import_sets = self._import_sets, []
        self.set_bank = self._land_import_sets(self.set_bank, items,
                                               self._dirty)

    def _land_import_sets(self, bank, items, dirty):
        if not items:
            return bank
        slots = np.array([s for s, _ in items], np.int32)
        self._mark_dirty_into(dirty, 3, slots)
        return self._seng.merge_rows(
            bank, self._tensor(slots, np.int32),
            self._tensor(np.stack([r for _, r in items]), np.uint8))

    def _flush_import_scalars(self):
        """Land the accumulated imported counters and gauges in the live
        banks (the flush ordering without the double buffer)."""
        counters, self._import_counter_acc = self._import_counter_acc, {}
        gauges, self._import_gauge_acc = self._import_gauge_acc, {}
        self.counter_bank, self.gauge_bank, self._gauge_seq = \
            self._land_import_scalars(self.counter_bank, self.gauge_bank,
                                      counters, gauges, self._dirty,
                                      self._gauge_seq)

    def _land_import_scalars(self, cbank, gbank, counters, gauges, dirty,
                             gauge_seq):
        """Land the accumulated counter sums (one float64 value a slot)
        and the last gauge values, the gauges sequenced after every
        gauge the interval ingested."""
        if counters:
            slots = np.fromiter(counters.keys(), np.int32, len(counters))
            self._mark_dirty_into(dirty, 1, slots)
            cbank = scalar.counter_merge(
                cbank, self._tensor(slots, np.int32),
                self._tensor(np.fromiter(counters.values(), np.float64,
                                         len(counters)), np.float64))
        if gauges:
            slots = np.fromiter(gauges.keys(), np.int32, len(gauges))
            self._mark_dirty_into(dirty, 2, slots)
            seqs = np.arange(len(gauges), dtype=np.int32) + gauge_seq + 1
            gauge_seq += len(gauges)
            gbank = scalar.gauge_set(
                gbank, self._tensor(slots, np.int32),
                self._tensor(np.fromiter(gauges.values(), np.float32,
                                         len(gauges)), np.float32),
                self._tensor(seqs, np.int32))
        return cbank, gbank, gauge_seq

    def _flush_import_centroids(self):
        items = self._import_centroids
        self._import_centroids = []
        self._import_centroid_total = 0
        self.histo_bank = self._land_import_centroids(
            self.histo_bank, items, self._dirty)

    def _land_import_centroids(self, bank, items, dirty):
        """Land staged forwarded digests into `bank` under the histogram
        engine's import strategy: "cluster" (t-digest: each slot's pile
        clustered to <= C centroids by one batched `cluster_rows`, then
        merged through the sample buffers, a compress per buffer depth
        of columns and a final compress) or "direct" (REQ: the points
        re-insert through the engine's own compaction)."""
        if not items:
            return bank
        heng = self._heng
        if heng.import_strategy == "direct":
            return self._land_imports_direct(bank, items, dirty)
        C = bank.num_centroids
        by_slot: dict[int, list] = {}
        for s, means, weights, *_ in items:
            by_slot.setdefault(s, []).append((means, weights))

        # Forwarded payloads are untrusted: an oversized pile must not
        # size the [S, W] matrix. It is clustered in chunks of `cap`
        # centroids first; each pass turns a chunk into C centroids, so
        # with cap >= 2C the loop shrinks the pile. Pass 1 sorts whole
        # rows (foreign rows are unordered); later passes re-cluster our
        # own cluster_rows outputs, pile-aligned, so each chunk's first C
        # lanes are an ordered run and take sorted_prefix=C.
        cap = max(_IMPORT_W_CAP, 2 * C)
        trusted: set = set()
        while True:
            oversized = [s for s, piles in by_slot.items()
                         if sum(len(m) for m, _ in piles) > cap]
            if not oversized:
                break
            batches = {0: ([], [], []), C: ([], [], [])}
            piles_per_chunk = cap // C
            for s in oversized:
                piles = by_slot[s]
                if s in trusted:
                    owners, chunks_v, chunks_w = batches[C]
                    for i in range(0, len(piles), piles_per_chunk):
                        cv = np.zeros(piles_per_chunk * C, np.float32)
                        cw = np.zeros(piles_per_chunk * C, np.float32)
                        for g, (m, w) in enumerate(
                                piles[i:i + piles_per_chunk]):
                            cv[g * C:g * C + len(m)] = m
                            cw[g * C:g * C + len(m)] = w
                        owners.append(s)
                        chunks_v.append(cv)
                        chunks_w.append(cw)
                else:
                    owners, chunks_v, chunks_w = batches[0]
                    m = np.concatenate([p[0] for p in piles])
                    w = np.concatenate([p[1] for p in piles])
                    for i in range(0, len(m), cap):
                        cv = np.zeros(cap, np.float32)
                        cw = np.zeros(cap, np.float32)
                        n = min(len(m), i + cap) - i
                        cv[:n] = m[i:i + n]
                        cw[:n] = w[i:i + n]
                        owners.append(s)
                        chunks_v.append(cv)
                        chunks_w.append(cw)
                by_slot[s] = []
            for prefix, (owners, chunks_v, chunks_w) in batches.items():
                if not owners:
                    continue
                cm, cw = heng.cluster_rows(
                    self._tensor(np.stack(chunks_v), np.float32),
                    self._tensor(np.stack(chunks_w), np.float32),
                    num_centroids=C, sorted_prefix=prefix)
                cm, cw = cm.cpu().numpy(), cw.cpu().numpy()
                for row, s in enumerate(owners):
                    by_slot[s].append((cm[row], cw[row]))
            trusted.update(oversized)

        slot_ids = np.fromiter(by_slot.keys(), np.int32, len(by_slot))
        self._mark_dirty_into(dirty, 0, slot_ids)
        widths = [sum(len(m) for m, _ in piles)
                  for piles in by_slot.values()]
        W = max(128, int(np.ceil(max(widths) / 128.0) * 128))
        vals = np.zeros((len(slot_ids), W), np.float32)
        wts = np.zeros((len(slot_ids), W), np.float32)
        for row, piles in enumerate(by_slot.values()):
            off = 0
            for m, w in piles:
                vals[row, off:off + len(m)] = m
                wts[row, off:off + len(m)] = w
                off += len(m)
        cmeans, cwts = heng.cluster_rows(
            self._tensor(vals, np.float32), self._tensor(wts, np.float32),
            num_centroids=C)
        # merge_centroids drops what overflows a buffer, so the C columns
        # land a buffer depth at a time, each after a compress (one round
        # at the default C = B)
        B = bank.buf_size
        slots_t = self._tensor(slot_ids, np.int32)
        for c0 in range(0, C, B):
            width = min(C, c0 + B) - c0
            bank = heng.compress(bank)
            bank = heng.merge_centroids(
                bank, slots_t.repeat_interleave(width),
                cmeans[:, c0:c0 + width].reshape(-1),
                cwts[:, c0:c0 + width].reshape(-1))
        bank = heng.compress(bank)
        return self._merge_import_scalars(bank, items)

    def _merge_import_scalars(self, bank, items):
        """The digests' exact min/max/sum/count/recip, merged by slot."""
        cols = np.array([it[3:8] for it in items], np.float32)
        # vlint: disable=DS01 reason=a helper of _land_import_centroids
        # and _land_imports_direct, which mark these slots (kind 0)
        # before they call it
        return self._heng.merge_scalars(
            bank, self._tensor([it[0] for it in items], np.int32),
            *(self._tensor(cols[:, j], np.float32) for j in range(5)))

    # fixed flat-batch width of the direct import landing
    _DIRECT_LAND_WIDTH = 4096

    def _land_imports_direct(self, bank, items, dirty):
        """The "direct" import strategy (REQ): every forwarded weighted
        point re-inserts through the engine's merge_centroids, whose
        compaction bounds memory, in fixed-width padded batches."""
        W = self._DIRECT_LAND_WIDTH
        slots = np.concatenate([
            np.full(len(it[1]), it[0], np.int32) for it in items])
        means = np.concatenate([it[1] for it in items])
        wts = np.concatenate([it[2] for it in items])
        self._mark_dirty_into(dirty, 0, np.unique(slots))
        for i in range(0, len(slots), W):
            n = min(len(slots), i + W) - i
            ps = np.full(W, -1, np.int32)
            pm = np.zeros(W, np.float32)
            pw = np.zeros(W, np.float32)
            ps[:n] = slots[i:i + n]
            pm[:n] = means[i:i + n]
            pw[:n] = wts[i:i + n]
            bank = self._heng.merge_centroids(
                bank, self._tensor(ps, np.int32),
                self._tensor(pm, np.float32), self._tensor(pw, np.float32))
        return self._merge_import_scalars(bank, items)

    # ---------------- flush ----------------

    def _swap_banks(self):
        """Under the lock: return the interval's banks and hand ingest
        fresh ones (the Worker.Flush map swap)."""
        snap = (self.histo_bank, self.counter_bank,
                self.gauge_bank, self.set_bank)
        # vlint: disable=DS01 reason=the fresh-bank swap, not a data
        # landing; _retire_dirty hands the bitmaps over with it
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

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fetch(self, out: dict) -> dict:
        """The flush's device-to-host transfer under the flush_fetch mode
        (fetch_flush_outputs), the compact encoding undone, then the host
        half of the set estimate (ULL's ML solve; nothing for HLL). Every
        fetch of flush outputs — full, incremental and the baseline rows
        — goes through here, so all three carry the same keys."""
        host = fetch_flush_outputs(out, self._fetch_mode, self._pinned)
        self._fetch_bytes += sum(a.nbytes for a in host.values())
        host = decompact_flush_host(host, tuple(self._agg_emit))
        self._seng.estimate_finalize(host)
        return host

    def _timed_fetch(self, out, t0, t1, phases) -> dict:
        """Fetch the flush body's outputs, stamping the JAX package's
        sync-mode phases: device.dispatch (t0-t1, the body's host calls),
        device.exec (until the card is done) and device.fetch. Every fetch
        mode stamps all three (the JAX package folds exec and fetch into
        one `device` phase outside sync mode, where a host sync could cost
        a relayed backend its executable; a card has no such cost)."""
        self._sync()
        t2 = time.monotonic_ns()
        host = self._fetch(out)
        t3 = time.monotonic_ns()
        phases.append(("device.dispatch", t0, t1))
        phases.append(("device.exec", t1, t2))
        phases.append(("device.fetch", t2, t3))
        return host

    def _flush_device(self, snap, phases, dirty=None) -> dict:
        """Run the flush body on the retired banks and fetch the host
        arrays, appending the phase stamps to `phases`. With the retired
        dirty bitmaps (and incremental flush on), only the touched rows
        run, unless the histogram bank's dirty fraction is above the
        threshold."""
        if dirty is not None and self._use_incremental:
            host = self._flush_device_incremental(snap, phases, dirty)
            if host is not None:
                return host
        self._last_flush_info = {"path": "full"}
        t0 = time.monotonic_ns()
        out = self._program(*snap, self._qs)
        return self._timed_fetch(out, t0, time.monotonic_ns(), phases)

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

    def _flush_device_incremental(self, snap, phases, dirty):
        """Gather only the dirty rows into a [D, ·] work set, run the
        flush body over it, and overlay the results on the baseline rows
        on host. None when the histogram bank's dirty fraction exceeds
        flush_incremental_threshold (the caller then flushes every
        row). Phases: `gather` (dirty ids, the baseline rows, the row
        gather), the device phases, `scatter` (the host overlay)."""
        t0 = time.monotonic_ns()
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
            host = self._scatter_host({}, ids, dirty, base)
            phases.append(("gather", t0, time.monotonic_ns()))
            return host
        idx = [torch.as_tensor(pad_dirty_ids(i, d.size), device=self.device)
               for d, i in zip(dirty, ids)]
        self._last_flush_info["buckets"] = [int(p.numel()) for p in idx]
        work = [type(bank)(*(leaf.index_select(0, ix) for leaf in bank))
                for bank, ix in zip(snap, idx)]
        t1 = time.monotonic_ns()
        phases.append(("gather", t0, t1))
        out = self._program(*work, self._qs)
        host_c = self._timed_fetch(out, t1, time.monotonic_ns(), phases)
        t4 = time.monotonic_ns()
        host = self._scatter_host(host_c, ids, dirty, base)
        phases.append(("scatter", t4, time.monotonic_ns()))
        return host

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

    def _flush_bookkeeping(self, full_export: bool = False) -> tuple:
        """Under the lock, at the tick boundary: snapshot the active key
        sets and per-interval counters, reset them, and advance the
        interner intervals. A full forward export (`full_export`) also
        snapshots the counter and set interners' whole tables, in the
        same lock hold as the bank swap, so the export and the banks
        describe one instant."""
        active = {
            "histo": self.histo_keys.active_items(),
            "counter": self.counter_keys.active_items(),
            "gauge": self.gauge_keys.active_items(),
            "set": self.set_keys.active_items(),
        }
        if full_export:
            active["counter_all"] = self.counter_keys.all_items()
            active["set_all"] = self.set_keys.all_items()
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

    def _land_retired(self, snap, dirty, stages, set_landing, imports,
                      gauge_seq) -> tuple:
        """Outside the lock (double-buffered flush): drain the retired
        interval's stage buffers into the retired banks, then land its
        staged imports, marking the retired bitmaps; the set stage lands
        together with the retired set landing buffer, in one insert."""
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
        centroids, sets, counters, gauges = imports
        hb = self._land_import_centroids(hb, centroids, dirty)
        sb = self._land_import_sets(sb, sets, dirty)
        cb, gb, _seq = self._land_import_scalars(cb, gb, counters, gauges,
                                                 dirty, gauge_seq)
        return hb, cb, gb, sb

    def flush(self, timestamp: int | None = None,
              forward_kind: str = "full") -> FlushResult:
        """The Server.Flush equivalent: retire the interval's banks and
        staged imports, run the flush body, assemble the MetricFrame,
        the forward export and the status checks.

        `forward_kind="delta"` builds the export from the retired dirty
        bitmap: only the counters and sets that landed this interval
        ship. It degrades to "full" without a bitmap (incremental flush
        off) or on an engine that does not forward; `export.kind` and
        `stats["forward_kind"]` say what was built. The local frame is
        never filtered by the kind.

        Double-buffered: the lock is held only across the swap of stage
        buffers, staged imports, banks and dirty bitmaps; draining the
        retired stages, landing the retired imports, the flush body and
        host assembly run outside it."""
        ts = int(timestamp if timestamp is not None else time.time())
        cfg = self.cfg
        fwd_out = self._fwd_out
        full_export = fwd_out and forward_kind != "delta"
        t_start = time.monotonic_ns()
        double = self._double_buffer_capable
        with self.lock:
            if double:
                stages = {name: st.drain()
                          for name, st in (("histo", self._histo_stage),
                                           ("counter", self._counter_stage),
                                           ("gauge", self._gauge_stage),
                                           ("set", self._set_stage))
                          if st.n}
                imports = (self._import_centroids, self._import_sets,
                           self._import_counter_acc,
                           self._import_gauge_acc)
                self._import_centroids = []
                self._import_centroid_total = 0
                self._import_sets = []
                self._import_counter_acc = {}
                self._import_gauge_acc = {}
                retired_seq, self._gauge_seq = self._gauge_seq, 0
                set_landing = self._set_landing
                self._set_landing = _SetLanding(set_landing.capacity)
            else:
                # the mesh engine's ordering: everything staged lands in
                # the live banks before they are swapped out
                self.drain_all()
                self._flush_import_centroids()
                self._flush_import_sets()
                self._flush_import_scalars()
                self._gauge_seq = 0
            snap = self._swap_banks()
            dirty = self._retire_dirty()
            # the applied-op watermark at the swap: every op up to it is
            # in the retiring banks, every later one in the fresh banks
            retired_wm = self.last_import_op
            active, status, samples, dropped, histo_key_count = \
                self._flush_bookkeeping(full_export)
        t_swap = time.monotonic_ns()
        # flight-recorder stamps (name, t0_ns, t1_ns) on the monotonic_ns
        # clock, returned in stats["phases"] for the server's phase tree
        if double:
            phases = [("swap", t_start, t_swap)]
            snap = self._land_retired(snap, dirty, stages, set_landing,
                                      imports, retired_seq)
            phases.append(("drain", t_swap, time.monotonic_ns()))
        else:
            phases = [("drain", t_start, t_swap)]
        self._fetch_bytes = 0
        host = self._flush_device(snap, phases, dirty=dirty)
        t_device = time.monotonic_ns()

        want_delta = (forward_kind == "delta" and fwd_out
                      and dirty is not None)
        frame = MetricFrame(ts, cfg.hostname)
        export = ForwardExport(set_engine=self._seng.id,
                               kind="delta" if want_delta else "full")
        self._assemble_histos(frame, host, active["histo"], export)
        self._assemble_scalars(frame, host, active, export,
                               dirty if want_delta else None)
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
        phases.append(("materialize", t_device, t_end))
        stats = {
            "samples": samples,
            "histo_keys": histo_key_count,
            "dropped_no_slot": dropped,
            # swap_ns is the lock-held window; merge_ns covers the
            # retired drain and import landing, the flush body and the
            # fetch
            "swap_ns": t_swap - t_start,
            "merge_ns": t_device - t_swap,
            "assembly_ns": t_end - t_device,
            "phases": phases,
            "flush_path": dict(self._last_flush_info),
            # device-to-host bytes of the flush's fetches
            "fetch_bytes": self._fetch_bytes,
            # what the export build shipped (a delta request degrades
            # to full without a bitmap or on a non-forwarding engine)
            "forward_kind": export.kind,
            # the applied-op watermark at the swap
            "retired_import_op": retired_wm,
        }
        return FlushResult(frame=frame, export=export, stats=stats,
                           status_metrics=status_metrics)

    def _assemble_histos(self, frame, host, infos, export):
        """Histogram rows, routed by scope on a forwarding engine: a
        local-only key flushes its percentiles and aggregates, a mixed
        key its aggregates alone, and both mixed and global-only keys
        ship their digest in `export`. Without forwarding every live key
        flushes fully."""
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
        n = len(infos)
        slots = np.fromiter((t[1] for t in infos), np.int64, n)
        live = live_cnt[slots] > 0
        aggonly_m = None
        if self._fwd_out:
            scopes = np.fromiter((t[2] for t in infos), np.int64, n)
            exp_m = live & (scopes != LOCAL_ONLY)
            full_m = live & (scopes == LOCAL_ONLY)
            aggonly_m = exp_m & (scopes != GLOBAL_ONLY)
            self._export_histos(export, host, infos, exp_m)
        else:
            full_m = live
        idx = np.nonzero(full_m)[0].tolist()
        if idx:
            pres = [self._histo_pres_of(infos[i]) for i in idx]
            rows = slots[idx]
            frame.add_block(
                [p[0] for p in pres], [p[2] for p in pres],
                np.concatenate([qmat[rows], aggmat[rows]], axis=1),
                self._histo_full_types)
        if aggonly_m is not None and self._agg_emit:
            idx = np.nonzero(aggonly_m)[0].tolist()
            if idx:
                pres = [self._histo_pres_of(infos[i]) for i in idx]
                frame.add_block(
                    [p[1] for p in pres], [p[2] for p in pres],
                    aggmat[slots[idx]], self._histo_agg_types)

    @staticmethod
    def _export_histos(export, host, infos, exp_m):
        """One (key, means, weights, min, max, sum, count, recip) entry
        per exported key: its positive-weight points and its exact
        scalars, each 2Sum pair read as f64(hi) + f64(lo)."""
        exact = {k: (host[f"h_{k}"].astype(np.float64)
                     + host[f"h_{k}_lo"].astype(np.float64))
                 for k in ("sum", "count", "recip")}
        h_mean, h_weight = host["h_mean"], host["h_weight"]
        for i in np.nonzero(exp_m)[0].tolist():
            key, slot = infos[i][0], infos[i][1]
            w = h_weight[slot]
            nz = w > 0
            export.histograms.append((
                key, h_mean[slot][nz], w[nz],
                float(host["h_min"][slot]), float(host["h_max"][slot]),
                float(exact["sum"][slot]), float(exact["count"][slot]),
                float(exact["recip"][slot])))

    def _assemble_scalars(self, frame, host, active, export, delta_dirty):
        """Counters (f64(hi) + f64(lo) totals), gauges (written this
        interval) and set estimates, one block each. On a forwarding
        engine global-only counters and gauges and non-local sets go to
        `export` instead of the frame. Gauges ship when written; counters
        and sets ship, on a delta export (`delta_dirty`, the retired
        bitmaps), when their bit is set, and on a full export from the
        interner's whole table, idle ones as zeros / empty registers."""
        totals = (host["c_hi"].astype(np.float64)
                  + host["c_lo"].astype(np.float64))
        gauges = host["g_value"].astype(np.float64)
        for name, kind, mtype, vals, wire in (
                ("counter", 1, MetricType.COUNTER, totals, totals),
                ("gauge", 2, MetricType.GAUGE, gauges, gauges),
                ("set", 3, MetricType.GAUGE,
                 host["s_est"].astype(np.float64), host.get("s_regs"))):
            infos = active[name]
            slots = np.fromiter((t[1] for t in infos), np.int64, len(infos))
            keep = (host["g_seq"][slots] >= 0 if name == "gauge"
                    else np.ones(len(infos), bool))
            if self._fwd_out:
                # sets forward unless local-only; counters and gauges
                # only when global-only
                def forwarded(scope, name=name):
                    return (scope != LOCAL_ONLY if name == "set"
                            else scope == GLOBAL_ONLY)
                fwd = forwarded(np.fromiter((t[2] for t in infos),
                                            np.int64, len(infos)))
                table = active.get(name + "_all")
                if name == "gauge":
                    sent = keep & fwd
                elif delta_dirty is not None:
                    sent = fwd & delta_dirty[kind][slots]
                elif table is None:
                    sent = fwd
                else:
                    sent = None
                    table = [t for t in table if forwarded(t[2])]
                if sent is not None:
                    table = [infos[i] for i in np.nonzero(sent)[0].tolist()]
                if name == "set":
                    export.sets.extend((t[0], wire[t[1]]) for t in table)
                else:
                    out = (export.counters if name == "counter"
                           else export.gauges)
                    out.extend((t[0], float(wire[t[1]])) for t in table)
                keep = keep & ~fwd
            keep = np.nonzero(keep)[0].tolist()
            if keep:
                frame.add_block(
                    [infos[i][0].name for i in keep],
                    [self._scalar_tags_of(infos[i]) for i in keep],
                    vals[slots[keep]], (mtype,))

    # ---------------- engine checkpoint/restore (durability) ----------
    # The byte encoding lives in durability/records.py: these methods
    # move numpy arrays of the JAX package's leaf dtypes (f32, i32, u8),
    # never raw bytes, so a checkpoint crosses between the two packages.

    def _bank_table(self):
        """(kind, bank attr name, interner) rows in the fixed record
        order durability/records.py's BANK_* constants name."""
        return ((0, "histo_bank", self.histo_keys),
                (1, "counter_bank", self.counter_keys),
                (2, "gauge_bank", self.gauge_keys),
                (3, "set_bank", self.set_keys))

    def bank_leaf_names(self, kind: int) -> tuple:
        """The durability leaf order for one bank kind: the selected
        engines' for the histogram and set banks, the fixed one for the
        counter and gauge banks."""
        if kind == 0:
            return self._heng.bank_leaves
        if kind == 3:
            return self._seng.bank_leaves
        from ..durability import records as drecords
        return drecords.BANK_LEAVES[kind]

    def enable_dirty_tracking(self, delta_threshold: float = 0.5):
        """Arm the per-bank dirty bitmaps for the checkpoint consumer
        (the server calls this when engine checkpointing is on). The
        incremental flush arms the same bitmaps at construction; marks
        already made are kept. `delta_threshold` is the dirty fraction
        past which checkpoint_state fetches whole leaves and slices them
        on the host instead of gathering rows on the device."""
        with self.lock:
            self._delta_threshold = float(delta_threshold)
            if self._dirty is None:
                self._dirty = [np.zeros(n, bool)
                               for n in self._bank_sizes()]

    def checkpoint_state(self) -> dict:
        """One engine's checkpoint, taken under the ingest lock so it is
        a consistent cut: the live banks' dirty rows (banks are
        interval-scoped, so fresh init + these rows is the state), the
        full interner tables, the staged-but-unlanded import
        accumulators, the gauge sequence and the applied-op watermark,
        as numpy arrays. The rows come off the device in one
        `index_select` a leaf, or, past `_delta_threshold`, as whole
        leaves sliced on the host. The set landing buffer lands first,
        so its updates (already marked dirty) are in the rows."""
        from ..durability import records as drecords
        with self.lock:
            # vlint: disable=DS01 reason=lands the set landing buffer, whose
            # rows _buffer_sets marked as it appended them, before the cut
            self.set_bank = self._land_set_buffer(self.set_bank,
                                                  self._set_landing)
            banks: dict = {}
            piles_total = piles_dirty = 0
            for kind, attr, _ki in self._bank_table():
                bank = getattr(self, attr)
                d = self._dirty[kind]
                ids = np.nonzero(d)[0].astype(np.int32)
                piles_total += d.size
                piles_dirty += ids.size
                leaves: dict = {}
                if ids.size:
                    gather = ids.size < self._delta_threshold * d.size
                    idx = (torch.as_tensor(ids, dtype=torch.long,
                                           device=self.device)
                           if gather else None)
                    for name in self.bank_leaf_names(kind):
                        leaf = getattr(bank, name)
                        if gather:
                            leaves[name] = leaf.index_select(0, idx) \
                                .cpu().numpy()
                        else:
                            leaves[name] = leaf.cpu().numpy()[ids]
                banks[kind] = (ids, leaves)
            interner = {
                kind: (ki.interval, ki.snapshot_entries())
                for kind, _attr, ki in self._bank_table()}
            staged = {
                "centroids": list(self._import_centroids),
                "sets": list(self._import_sets),
                "counters": list(self._import_counter_acc.items()),
                "gauges": list(self._import_gauge_acc.items()),
            }
            return {
                "fingerprint": drecords.engine_fingerprint(
                    self.cfg, self.histo_bank.num_centroids),
                "gauge_seq": self._gauge_seq,
                "last_import_op": self.last_import_op,
                "interner": interner,
                "banks": banks,
                "staged": staged,
                "leaf_names": {
                    kind: self.bank_leaf_names(kind)
                    for kind, _attr, _ki in self._bank_table()},
                "piles_total": piles_total,
                "piles_dirty": piles_dirty,
            }

    def restore_checkpoint(self, fingerprint, gauge_seq: int,
                           watermark: int, interner: dict, banks: dict,
                           staged: dict):
        """Rebuild this freshly constructed engine from a decoded
        checkpoint group: each leaf is composed on the host from the
        fresh-init baseline with the journaled rows laid over it, then
        copied to the engine's device once. The restored rows are marked
        dirty again (the next checkpoint must carry them). Raises
        ValueError on a fingerprint mismatch: rows are never scattered
        into an engine of another shape or another sketch pair."""
        from ..durability import records as drecords
        want = drecords.engine_fingerprint(self.cfg,
                                           self.histo_bank.num_centroids)
        if tuple(fingerprint) != want:
            raise ValueError(
                f"engine checkpoint fingerprint {tuple(fingerprint)} "
                f"does not match this engine's shape {want}")
        no_rows = (np.zeros(0, np.int32), {})
        with self.lock:
            for kind, attr, _ki in self._bank_table():
                ids, leaves = banks.get(kind, no_rows)
                if len(ids) == 0:
                    continue             # fresh rows, already right
                bank = getattr(self, attr)
                host = {}
                for name in self.bank_leaf_names(kind):
                    full = getattr(bank, name).cpu().numpy().copy()
                    full[ids] = leaves[name]
                    host[name] = torch.from_numpy(full).to(self.device)
                setattr(self, attr, type(bank)(**host))
            for kind, _attr, ki in self._bank_table():
                interval, entries = interner.get(kind, (0, []))
                ki.restore(interval, entries)
                ids, _leaves = banks.get(kind, no_rows)
                if self._dirty is not None and len(ids):
                    self._dirty[kind][ids] = True
            self._import_centroids = [
                (int(s), np.asarray(m, np.float32),
                 np.asarray(w, np.float32), float(a), float(b),
                 float(c), float(d), float(e))
                for s, m, w, a, b, c, d, e in staged.get("centroids", [])]
            self._import_centroid_total = sum(
                len(m) for _s, m, *_rest in self._import_centroids)
            self._import_sets = [(int(s), np.asarray(r, np.uint8))
                                 for s, r in staged.get("sets", [])]
            self._import_counter_acc = {
                int(s): float(v) for s, v in staged.get("counters", [])}
            self._import_gauge_acc = {
                int(s): float(v) for s, v in staged.get("gauges", [])}
            self._gauge_seq = int(gauge_seq)
            self.last_import_op = int(watermark)

    def dirty_stats(self) -> tuple:
        """(dirty piles, total piles) across the four banks: the
        veneur.durability.engine_snapshot_piles_* gauges."""
        if self._dirty is None:
            return (0, 0)
        with self.lock:
            return (sum(int(d.sum()) for d in self._dirty),
                    sum(d.size for d in self._dirty))

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
        """(all row names, the aggregate row names, tags) of a key."""
        holder = info[3]
        if holder.pres is None:
            key = info[0]
            nm = key.name
            full = tuple([nm + s for s in self._pct_sufs]
                         + [f"{nm}.{a}" for a in self._agg_emit])
            holder.pres = (full, full[len(self._pct_sufs):],
                           self._tags_of(key.joined_tags))
        return holder.pres
