"""The typed record layer over the journal framing — the port's copy
of veneur_tpu/durability/records.py: the same record bytes, so a
journal written by either package restores in the other.

Sketch payloads reuse the cluster wire codecs (`cluster/wire.py`): a
parked interval's `ForwardExport` serializes as a `forwardrpc.
MetricList` — the exact bytes the forwarder would put on the wire —
plus a side channel of exact f64 counter values (the wire rounds
counters to int64; the journal must hand back exactly what was parked
so a recovered replay is bit-identical to the send the crash
interrupted). t-digest centroids, HLL registers, gauges, and the
min/max/sum/count/reciprocal_sum scalars are all lossless in the
MetricList itself.

Record kinds (sender-side "forward" journal — an op log whose replay
reconstructs the `ResilientForwarder` ladder + spill tier exactly):

    META         sender_id + next interval_seq (identity; a recovered
                 sender MUST resume under its original sender_id or the
                 receiver's dedupe ledger cannot see its replays)
    BEGIN        a send attempt entered the ladder: seq, chunk
                 progress, age, and the full export payload (write-
                 ahead: appended BEFORE any wire traffic, so a crash
                 mid-ladder cannot lose the interval)
    DONE         seq delivered — the entry leaves the ladder
    UPDATE       partial delivery / spill re-merge changed an entry's
                 export or chunk progress
    AGE          one failed-flush aging pass over the ladder
    DEMOTE       the oldest entry overflowed into the merged spill tier
    SPILL_MERGE  the spill tier drained into the current interval
    SPILL_STATE  full spill-tier contents (snapshot compaction only)

Receiver-side "dedupe" journal:

    WATERMARKS   the per-sender max admitted interval_seq at a flush
                 boundary — a restarted global restores these so an
                 ancient replay (already flushed downstream before the
                 crash) is dropped, not re-admitted

Receiver-side "engine" journal (global-tier checkpoint):

    ENGINE_IMPORT  write-ahead op log: one admitted import request's
                   metrics as forwardrpc.MetricList bytes (the wire
                   codec, reused verbatim) under a monotone op id,
                   appended BEFORE the worker queues see the metrics
                   and before the sender's ack — an admitted-and-acked
                   interval can no longer die with the process
    ENGINE_META    one engine's checkpoint header at a flush boundary:
                   shape fingerprint (a restore against a differently-
                   configured engine must refuse loudly, not scatter
                   rows into the wrong slots), the applied-op
                   watermark (ops <= it are inside the checkpoint; ops
                   above it replay on top), and the gauge sequence
    ENGINE_KEYS    one bank's full interner table (slot -> key/scope/
                   last-interval) + the interner's interval counter
    ENGINE_BANK    one bank's DIRTY rows: banks are interval-scoped
                   (the flush swap re-zeroes every row), so "fresh
                   init + the rows touched since the swap" IS the full
                   bank state — a checkpoint is self-contained and a
                   steady-state tick serializes only touched piles.
                   Leaves ride as raw little-endian numpy bytes:
                   recovery must hand back BIT-EXACT f32/u8 rows (the
                   wire's centroid list drops zero-weight entries and
                   re-orders — fine for forwarding, fatal for a
                   restore that must flush bit-identically). This
                   module is the ONLY home of bank-leaf tobytes()/
                   frombuffer.
    ENGINE_STAGED  one engine's staged-but-unlanded import
                   accumulators (centroid piles, HLL rows, exact-f64
                   counter sums, last-write-wins gauges) — applied ops
                   whose data has not reached the device yet live
                   here, so the watermark stays honest
    ENGINE_COMMIT  group-completeness marker, LAST record of each
                   engine's checkpoint group. The group's records are
                   separate journal frames, so a crash mid-append can
                   leave META on disk without its KEYS/BANK/STAGED —
                   recovery only accepts a group whose COMMIT arrived,
                   falling back to the engine's previous complete
                   group otherwise (a torn META whose watermark still
                   suppressed op replay would be silent data loss)
"""

from __future__ import annotations

import struct

import numpy as np

from ..models.pipeline import ForwardExport

REC_META = 1
REC_BEGIN = 2
REC_DONE = 3
REC_UPDATE = 4
REC_AGE = 5
REC_DEMOTE = 6
REC_SPILL_MERGE = 7
REC_SPILL_STATE = 8
REC_WATERMARKS = 9
REC_ENGINE_IMPORT = 10
REC_ENGINE_META = 11
REC_ENGINE_KEYS = 12
REC_ENGINE_BANK = 13
REC_ENGINE_STAGED = 14
REC_ENGINE_COMMIT = 15
# time-travel history tier (durability/history.py):
#   HISTORY_META   first record of a history SEGMENT file — one closed
#                  flush interval's identity: generation id, the
#                  interval-close wall time, the previous boundary's
#                  close time (the interval's open edge), the
#                  per-engine RETIRE watermarks (the op ids the flush
#                  swap actually carried — the exact per-engine upper
#                  replay cut for this interval), and the op-id range
#                  the segment retains. The rest of the segment is the
#                  previous boundary's checkpoint groups (REC_ENGINE_*
#                  records, reused verbatim — the interval's baseline)
#                  followed by the interval's write-ahead import ops.
#   HISTORY_INDEX  one manifest row per COMMITTED generation: id,
#                  close/open times, segment byte size. The manifest
#                  is rewritten atomically; a generation absent from
#                  it is not committed, whatever files exist.
REC_HISTORY_META = 16
REC_HISTORY_INDEX = 17

# engine bank kinds (the order pipeline.AggregationEngine owns them in)
BANK_HISTO = 0
BANK_COUNTER = 1
BANK_GAUGE = 2
BANK_SET = 3

# leaf order per bank kind — load-bearing: encode and decode walk the
# same tuple, and a new leaf added to a bank NamedTuple must be added
# here (the fingerprint's shape fields catch width drift, this catches
# leaf drift)
HISTO_LEAVES = ("mean", "weight", "buf_value", "buf_weight", "buf_n",
                "vmin", "vmax", "vsum", "count", "recip", "vsum_lo",
                "count_lo", "recip_lo")
COUNTER_LEAVES = ("hi", "lo")
GAUGE_LEAVES = ("value", "seq")
SET_LEAVES = ("registers",)
BANK_LEAVES = {BANK_HISTO: HISTO_LEAVES, BANK_COUNTER: COUNTER_LEAVES,
               BANK_GAUGE: GAUGE_LEAVES, BANK_SET: SET_LEAVES}

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_F64 = struct.Struct("<d")
_BEGIN_HEAD = struct.Struct("<QIII")    # seq, chunk_offset, chunk_count, age
_UPDATE_HEAD = struct.Struct("<QII")    # seq, chunk_offset, chunk_count


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _U32.pack(len(b)) + b


def _unpack_str(data: bytes, off: int):
    (n,) = _U32.unpack_from(data, off)
    off += _U32.size
    return data[off:off + n].decode("utf-8"), off + n


# ------------------------------------------------------------- exports

def encode_export(export: ForwardExport) -> bytes:
    """ForwardExport -> MetricList bytes + exact f64 counter values."""
    from ..cluster import wire
    from ..cluster.protos import forward_pb2
    blob = forward_pb2.MetricList(
        metrics=wire.export_to_metrics(export)).SerializeToString()
    exact = b"".join(_F64.pack(float(v)) for _k, v in export.counters)
    return _U32.pack(len(blob)) + blob + exact


def decode_export(data: bytes, off: int = 0):
    """-> (ForwardExport, next_offset). Inverse of encode_export; the
    exact counter side channel overwrites the wire's int64 rounding."""
    from ..cluster import wire
    from ..cluster.protos import forward_pb2
    (n,) = _U32.unpack_from(data, off)
    off += _U32.size
    ml = forward_pb2.MetricList.FromString(data[off:off + n])
    off += n
    export = wire.export_from_metrics(ml.metrics)
    for i in range(len(export.counters)):
        key, _v = export.counters[i]
        (v,) = _F64.unpack_from(data, off)
        off += _F64.size
        export.counters[i] = (key, v)
    return export, off


# ------------------------------------------------- sender (forward) ops

def encode_meta(sender_id: str, next_seq: int) -> bytes:
    return _pack_str(sender_id) + _U64.pack(next_seq)


def decode_meta(data: bytes):
    sender_id, off = _unpack_str(data, 0)
    (next_seq,) = _U64.unpack_from(data, off)
    return sender_id, next_seq


def encode_begin(seq: int, chunk_offset: int, chunk_count: int,
                 age: int, export: ForwardExport,
                 kind: str = "full") -> bytes:
    """The kind byte (0 = full, 1 = delta) trails the export payload:
    a parked interval replays under its ORIGINAL full/delta marker
    after a crash (a recovered delta re-stamped full would silently
    reset the receiver's gap baseline). Trailing keeps pre-delta
    journals decodable — an absent byte reads as "full", which every
    pre-delta interval was."""
    return _BEGIN_HEAD.pack(seq, chunk_offset, chunk_count, age) \
        + encode_export(export) \
        + (b"\x01" if kind == "delta" else b"\x00")


def decode_begin(data: bytes):
    seq, chunk_offset, chunk_count, age = _BEGIN_HEAD.unpack_from(data, 0)
    export, off = decode_export(data, _BEGIN_HEAD.size)
    kind = "delta" if (off < len(data) and data[off] == 1) else "full"
    return seq, chunk_offset, chunk_count, age, export, kind


def encode_done(seq: int) -> bytes:
    return _U64.pack(seq)


def decode_done(data: bytes) -> int:
    return _U64.unpack_from(data, 0)[0]


def encode_update(seq: int, chunk_offset: int, chunk_count: int,
                  export: ForwardExport) -> bytes:
    return _UPDATE_HEAD.pack(seq, chunk_offset, chunk_count) \
        + encode_export(export)


def decode_update(data: bytes):
    seq, chunk_offset, chunk_count = _UPDATE_HEAD.unpack_from(data, 0)
    export, _ = decode_export(data, _UPDATE_HEAD.size)
    return seq, chunk_offset, chunk_count, export


# ------------------------------------------------------ spill snapshot

def encode_spill_state(spill) -> bytes:
    """Full spill-tier contents for snapshot compaction: the sketch
    dicts ride as one export payload (same wire codecs), gauge ages and
    the remembered merge ages ride as side lists keyed by position/key.
    """
    export = ForwardExport(
        # the engine tag rides the wire row (byte 0): without it a ULL
        # server's spilled registers would journal under the HLL code
        # and silently max-join after a cross-engine restore
        set_engine=getattr(spill, "set_engine", "hll"))
    export.histograms.extend(
        (key, h[0], h[1], h[2], h[3], h[4], h[5], h[6])
        for key, h in spill._histos.items())
    export.sets.extend(spill._sets.items())
    export.counters.extend(spill._counters.items())
    export.gauges.extend((key, v) for key, (v, _a)
                         in spill._gauges.items())
    out = [encode_export(export)]
    ages = [a for _v, a in spill._gauges.values()]
    out.append(_U32.pack(len(ages)))
    out.extend(_U32.pack(a) for a in ages)
    out.append(_U32.pack(len(spill._merged_gauge_ages)))
    for key, age in spill._merged_gauge_ages.items():
        out.append(_pack_str(key.name) + _pack_str(key.type)
                   + _pack_str(key.joined_tags) + _U32.pack(age))
    return b"".join(out)


def decode_spill_state(data: bytes, spill) -> None:
    """Restore `spill` (a fresh SpillBuffer) from encode_spill_state
    bytes."""
    import numpy as np

    from ..ingest.parser import MetricKey
    export, off = decode_export(data, 0)
    # restore the engine the registers were tagged with, so later
    # same-key spills join under the right semantics and re-forwards
    # carry the original code (a backend-switched restart then fails
    # LOUDLY at the receiver's belt check, never silently merges)
    spill.set_engine = export.set_engine
    for key, means, weights, vmin, vmax, vsum, cnt, recip in (
            export.histograms):
        spill._histos[key] = [np.asarray(means, np.float32),
                              np.asarray(weights, np.float32),
                              float(vmin), float(vmax), float(vsum),
                              float(cnt), float(recip)]
    for key, regs in export.sets:
        spill._sets[key] = np.asarray(regs, np.uint8)
    for key, value in export.counters:
        spill._counters[key] = float(value)
    (n_ages,) = _U32.unpack_from(data, off)
    off += _U32.size
    ages = []
    for _ in range(n_ages):
        (a,) = _U32.unpack_from(data, off)
        off += _U32.size
        ages.append(a)
    for (key, value), age in zip(export.gauges, ages):
        spill._gauges[key] = [float(value), age]
    (n_merged,) = _U32.unpack_from(data, off)
    off += _U32.size
    for _ in range(n_merged):
        name, off = _unpack_str(data, off)
        mtype, off = _unpack_str(data, off)
        tags, off = _unpack_str(data, off)
        (age,) = _U32.unpack_from(data, off)
        off += _U32.size
        spill._merged_gauge_ages[MetricKey(name, mtype, tags)] = age


# --------------------------------------------- receiver (dedupe) marks

def encode_watermarks(marks: dict) -> bytes:
    out = [_U32.pack(len(marks))]
    for sender_id, seq in marks.items():
        out.append(_pack_str(sender_id) + _U64.pack(int(seq)))
    return b"".join(out)


def decode_watermarks(data: bytes) -> dict:
    (n,) = _U32.unpack_from(data, 0)
    off = _U32.size
    marks = {}
    for _ in range(n):
        sender_id, off = _unpack_str(data, off)
        (seq,) = _U64.unpack_from(data, off)
        off += _U64.size
        marks[sender_id] = seq
    return marks


# ---------------------------------------- engine checkpoint (global tier)
#
# The serialization home for engine state: bank leaves
# cross into and out of the journal ONLY here, as raw little-endian
# numpy buffers — bit-exact by construction, no float formatting, no
# zero-weight dropping, no re-ordering.

_ENG_META = struct.Struct("<IIQQ")      # engine_idx, n_engines, watermark,
                                        # gauge_seq
_ENG_FPR = struct.Struct("<IIIIIIId")   # histo K, C, B, counter K, gauge K,
                                        # set K, hll m, compression
_ENG_KEYS_HEAD = struct.Struct("<IBII")  # engine_idx, bank_kind, interval, n
_ENG_KEY_ENTRY = struct.Struct("<IiI")   # slot, scope, last_interval
_ENG_BANK_HEAD = struct.Struct("<IBI")   # engine_idx, bank_kind, n_rows
_ENG_LEAF_HEAD = struct.Struct("<BI")    # dtype code, row width (0 = 1-D)

_DTYPE_CODES = {0: np.float32, 1: np.int32, 2: np.uint8, 3: np.int64}
_CODE_OF_DTYPE = {np.dtype(v): k for k, v in _DTYPE_CODES.items()}


def _engine_descs(cfg) -> tuple | None:
    """Engine-identity strings appended to the fingerprint when the
    config selects NON-DEFAULT sketch backends: a restore
    into a different backend — or the same backend at different
    accuracy params — must refuse loudly, not scatter one engine's
    leaf bytes into another's banks. None for the default pair, so
    default-engine fingerprints (and every pre-registry journal) keep
    their original 8-tuple shape byte-for-byte."""
    hb = getattr(cfg, "histogram_backend", "tdigest")
    sb = getattr(cfg, "set_backend", "hll")
    if hb == "tdigest" and sb == "hll":
        return None
    if hb == "tdigest":
        hd = "tdigest/1"
    else:
        hd = (f"req/1:levels={int(getattr(cfg, 'req_levels', 2))},"
              f"capacity={int(getattr(cfg, 'req_capacity', 256))}")
    if sb == "hll":
        sd = "hll/1"
    else:
        sd = f"ull/1:p={int(getattr(cfg, 'ull_precision', 13))}"
    return hd, sd


def engine_fingerprint(cfg, num_centroids: int) -> tuple:
    """The shape identity a checkpoint was taken under. A restore into
    an engine with a different fingerprint must refuse whole (rows would
    scatter into the wrong slots / wrong widths). With non-default
    sketch backends the tuple grows two engine-identity strings (see
    _engine_descs) — a checkpoint written under `ull`+`req` can never
    silently restore into a default-engine server or vice versa."""
    sb = getattr(cfg, "set_backend", "hll")
    m = (1 << int(getattr(cfg, "ull_precision", 13))) if sb == "ull" \
        else (1 << int(cfg.hll_precision))
    base = (int(cfg.histogram_slots), int(num_centroids),
            int(cfg.buffer_depth), int(cfg.counter_slots),
            int(cfg.gauge_slots), int(cfg.set_slots),
            m, float(cfg.compression))
    descs = _engine_descs(cfg)
    return base if descs is None else base + descs


def encode_engine_import(op_id: int, metrics, envelope=None) -> bytes:
    """One admitted import request: its metricpb.Metric list as
    forwardrpc.MetricList bytes (the forward wire codec, reused) under
    a monotone op id, plus the request's idempotency envelope
    (sender_id, interval_seq, chunk_index, chunk_count) when it
    carried one. The envelope is LOAD-BEARING for recovery: restoring
    admitted-and-merged state without also restoring the dedupe
    ledger's memory of its envelope would let the sender's ambiguous-
    failure replay of that same interval re-admit and DOUBLE-COUNT —
    the exact bug the one-tick-behind watermark journal was allowed to
    tolerate only while admitted state died with the process.
    Protobuf roundtrips its f32/f64 fields exactly, so replaying the
    decoded metrics is bit-identical to applying the originals."""
    from ..cluster.protos import forward_pb2
    blob = forward_pb2.MetricList(metrics=list(metrics)) \
        .SerializeToString()
    head = _U64.pack(op_id)
    if envelope is None:
        return head + b"\x00" + blob
    sender_id, seq, chunk_index, chunk_count = envelope
    return (head + b"\x01" + _pack_str(str(sender_id))
            + _U64.pack(int(seq))
            + _U32.pack(int(chunk_index)) + _U32.pack(int(chunk_count))
            + blob)


def decode_engine_import(data: bytes):
    """-> (op_id, [metricpb.Metric], envelope tuple or None)."""
    from ..cluster.protos import forward_pb2
    (op_id,) = _U64.unpack_from(data, 0)
    off = _U64.size
    has_env = data[off]
    off += 1
    envelope = None
    if has_env:
        sender_id, off = _unpack_str(data, off)
        (seq,) = _U64.unpack_from(data, off)
        off += _U64.size
        chunk_index, chunk_count = struct.unpack_from("<II", data, off)
        off += 8
        envelope = (sender_id, seq, chunk_index, chunk_count)
    ml = forward_pb2.MetricList.FromString(data[off:])
    return op_id, list(ml.metrics), envelope


def encode_engine_meta(engine_idx: int, n_engines: int, watermark: int,
                       gauge_seq: int, fingerprint: tuple) -> bytes:
    out = _ENG_META.pack(engine_idx, n_engines, watermark,
                         int(gauge_seq)) \
        + _ENG_FPR.pack(*fingerprint[:8])
    # non-default backends append their engine-identity strings; the
    # default pair stays byte-identical to the pre-registry record
    for desc in fingerprint[8:]:
        out += _pack_str(str(desc))
    return out


def decode_engine_meta(data: bytes):
    engine_idx, n_engines, watermark, gauge_seq = \
        _ENG_META.unpack_from(data, 0)
    fpr = list(_ENG_FPR.unpack_from(data, _ENG_META.size))
    off = _ENG_META.size + _ENG_FPR.size
    while off < len(data):
        desc, off = _unpack_str(data, off)
        fpr.append(desc)
    return engine_idx, n_engines, watermark, gauge_seq, tuple(fpr)


def encode_engine_keys(engine_idx: int, bank_kind: int, interval: int,
                       entries) -> bytes:
    """One bank's interner table: [(slot, scope, last_interval, name,
    type, joined_tags)] + the interner's interval counter."""
    entries = list(entries)
    out = [_ENG_KEYS_HEAD.pack(engine_idx, bank_kind, interval,
                               len(entries))]
    for slot, scope, last_interval, name, mtype, tags in entries:
        out.append(_ENG_KEY_ENTRY.pack(slot, scope, last_interval))
        out.append(_pack_str(name))
        out.append(_pack_str(mtype))
        out.append(_pack_str(tags))
    return b"".join(out)


def decode_engine_keys(data: bytes):
    engine_idx, bank_kind, interval, n = _ENG_KEYS_HEAD.unpack_from(data, 0)
    off = _ENG_KEYS_HEAD.size
    entries = []
    for _ in range(n):
        slot, scope, last_interval = _ENG_KEY_ENTRY.unpack_from(data, off)
        off += _ENG_KEY_ENTRY.size
        name, off = _unpack_str(data, off)
        mtype, off = _unpack_str(data, off)
        tags, off = _unpack_str(data, off)
        entries.append((slot, scope, last_interval, name, mtype, tags))
    return engine_idx, bank_kind, interval, entries


def _encode_leaf(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    width = arr.shape[1] if arr.ndim == 2 else 0
    return _ENG_LEAF_HEAD.pack(_CODE_OF_DTYPE[arr.dtype], width) \
        + arr.tobytes()


def _decode_leaf(data: bytes, off: int, n_rows: int):
    code, width = _ENG_LEAF_HEAD.unpack_from(data, off)
    off += _ENG_LEAF_HEAD.size
    dtype = np.dtype(_DTYPE_CODES[code])
    count = n_rows * (width or 1)
    nbytes = count * dtype.itemsize
    arr = np.frombuffer(data, dtype, count, off).copy()
    if width:
        arr = arr.reshape(n_rows, width)
    return arr, off + nbytes


def encode_engine_bank(engine_idx: int, bank_kind: int,
                       slot_ids: np.ndarray, leaves: dict,
                       leaf_names: tuple | None = None) -> bytes:
    """One bank's dirty rows: slot ids + every leaf's rows at those
    ids, in a fixed leaf order, as raw little-endian bytes.
    `leaf_names` defaults to the default engines' BANK_LEAVES order;
    non-default sketch backends pass their own (the fingerprint's
    engine descs guarantee encode and decode agree on it)."""
    slot_ids = np.ascontiguousarray(slot_ids, np.int32)
    out = [_ENG_BANK_HEAD.pack(engine_idx, bank_kind, len(slot_ids)),
           slot_ids.tobytes()]
    for name in (leaf_names or BANK_LEAVES[bank_kind]):
        out.append(_encode_leaf(leaves[name]))
    return b"".join(out)


def decode_engine_bank(data: bytes, leaf_names_of=None):
    """`leaf_names_of(bank_kind)` (optional) supplies the decode-side
    leaf order for non-default engines; default is BANK_LEAVES."""
    engine_idx, bank_kind, n = _ENG_BANK_HEAD.unpack_from(data, 0)
    off = _ENG_BANK_HEAD.size
    slot_ids = np.frombuffer(data, np.int32, n, off).copy()
    off += n * 4
    names = (leaf_names_of(bank_kind) if leaf_names_of is not None
             else BANK_LEAVES[bank_kind])
    leaves = {}
    for name in names:
        leaves[name], off = _decode_leaf(data, off, n)
    return engine_idx, bank_kind, slot_ids, leaves


def encode_engine_staged(engine_idx: int, staged: dict) -> bytes:
    """Staged-but-unlanded import accumulators, order-preserving (the
    landing order feeds the k1 clustering and the gauge sequence, both
    order-sensitive):
      centroids   [(slot, means f32[w], weights f32[w], min, max, sum,
                    count, recip)]
      sets        [(slot, registers u8[m])]
      counters    [(slot, exact f64 sum)]   (dict insertion order)
      gauges      [(slot, f64 value)]       (dict insertion order)
    """
    out = [_U32.pack(engine_idx)]
    cents = staged.get("centroids", [])
    out.append(_U32.pack(len(cents)))
    for slot, means, weights, vmin, vmax, vsum, cnt, recip in cents:
        means = np.ascontiguousarray(means, np.float32)
        weights = np.ascontiguousarray(weights, np.float32)
        out.append(_U32.pack(int(slot)) + _U32.pack(len(means)))
        out.append(means.tobytes())
        out.append(weights.tobytes())
        out.append(struct.pack("<5d", vmin, vmax, vsum, cnt, recip))
    sets = staged.get("sets", [])
    out.append(_U32.pack(len(sets)))
    for slot, regs in sets:
        regs = np.ascontiguousarray(regs, np.uint8)
        out.append(_U32.pack(int(slot)) + _U32.pack(len(regs)))
        out.append(regs.tobytes())
    for field in ("counters", "gauges"):
        items = staged.get(field, [])
        out.append(_U32.pack(len(items)))
        for slot, value in items:
            out.append(_U32.pack(int(slot)) + _F64.pack(float(value)))
    return b"".join(out)


def decode_engine_staged(data: bytes):
    (engine_idx,) = _U32.unpack_from(data, 0)
    off = _U32.size
    staged = {"centroids": [], "sets": [], "counters": [], "gauges": []}
    (n,) = _U32.unpack_from(data, off)
    off += _U32.size
    for _ in range(n):
        slot, w = struct.unpack_from("<II", data, off)
        off += 8
        means = np.frombuffer(data, np.float32, w, off).copy()
        off += 4 * w
        weights = np.frombuffer(data, np.float32, w, off).copy()
        off += 4 * w
        scalars = struct.unpack_from("<5d", data, off)
        off += 40
        staged["centroids"].append((slot, means, weights) + scalars)
    (n,) = _U32.unpack_from(data, off)
    off += _U32.size
    for _ in range(n):
        slot, m = struct.unpack_from("<II", data, off)
        off += 8
        regs = np.frombuffer(data, np.uint8, m, off).copy()
        off += m
        staged["sets"].append((slot, regs))
    for field in ("counters", "gauges"):
        (n,) = _U32.unpack_from(data, off)
        off += _U32.size
        for _ in range(n):
            (slot,) = _U32.unpack_from(data, off)
            off += _U32.size
            (value,) = _F64.unpack_from(data, off)
            off += _F64.size
            staged[field].append((slot, value))
    return engine_idx, staged


# ------------------------------------------------------ history tier

_HIST_META = struct.Struct("<QQQI")   # gen, close_ns, prev_close_ns,
#                                       n_engines
_HIST_IDX = struct.Struct("<QQQQ")    # gen, close_ns, prev_close_ns,
#                                       segment bytes


def encode_history_meta(gen: int, close_ns: int, prev_close_ns: int,
                        retire_wms, op_lo: int, op_hi: int) -> bytes:
    """One history segment's identity record (see the kind table)."""
    retire_wms = [int(w) for w in retire_wms]
    out = [_HIST_META.pack(int(gen), int(close_ns), int(prev_close_ns),
                           len(retire_wms))]
    out.extend(_U64.pack(w) for w in retire_wms)
    out.append(_U64.pack(int(op_lo)))
    out.append(_U64.pack(int(op_hi)))
    return b"".join(out)


def decode_history_meta(data: bytes):
    """-> (gen, close_ns, prev_close_ns, [retire_wm per engine],
    op_lo, op_hi)."""
    gen, close_ns, prev_close_ns, n = _HIST_META.unpack_from(data, 0)
    off = _HIST_META.size
    wms = []
    for _ in range(n):
        (w,) = _U64.unpack_from(data, off)
        off += _U64.size
        wms.append(w)
    (op_lo,) = _U64.unpack_from(data, off)
    off += _U64.size
    (op_hi,) = _U64.unpack_from(data, off)
    return gen, close_ns, prev_close_ns, wms, op_lo, op_hi


def encode_history_index(gen: int, close_ns: int, prev_close_ns: int,
                         nbytes: int) -> bytes:
    return _HIST_IDX.pack(int(gen), int(close_ns), int(prev_close_ns),
                          int(nbytes))


def decode_history_index(data: bytes):
    """-> (gen, close_ns, prev_close_ns, nbytes)."""
    return _HIST_IDX.unpack_from(data, 0)


def encode_engine_checkpoint(engine_idx: int, n_engines: int,
                             snap: dict) -> list:
    """One engine's flush-boundary checkpoint as a typed-record list
    (the unit the server appends per tick and hands to snapshot
    compaction — self-contained: fresh banks + these records IS the
    engine's state at the boundary)."""
    recs = [(REC_ENGINE_META, encode_engine_meta(
        engine_idx, n_engines, snap["last_import_op"],
        snap["gauge_seq"], snap["fingerprint"]))]
    for kind, (interval, entries) in snap["interner"].items():
        recs.append((REC_ENGINE_KEYS, encode_engine_keys(
            engine_idx, kind, interval, entries)))
    leaf_names = snap.get("leaf_names", {})
    for kind, (slot_ids, leaves) in snap["banks"].items():
        if len(slot_ids) == 0:
            continue              # fresh rows need no record
        recs.append((REC_ENGINE_BANK, encode_engine_bank(
            engine_idx, kind, slot_ids, leaves,
            leaf_names=leaf_names.get(kind))))
    staged = snap["staged"]
    if any(staged.get(f) for f in ("centroids", "sets", "counters",
                                   "gauges")):
        recs.append((REC_ENGINE_STAGED,
                     encode_engine_staged(engine_idx, staged)))
    # completeness marker LAST: recovery only trusts committed groups
    recs.append((REC_ENGINE_COMMIT, _U32.pack(engine_idx)))
    return recs


def decode_engine_commit(data: bytes) -> int:
    return _U32.unpack_from(data, 0)[0]
