"""Conversions between engine exports and the metricpb wire format —
counterpart of veneur_tpu/cluster/wire.py, byte for byte.

Parity: the samplers' Metric()/Export() (local side, producing
metricpb.Metric) and Combine() (global side, consuming it) —
samplers/samplers.go, worker.go (sym: Worker.ImportMetricGRPC).

This module and the generated `protos/*_pb2.py` are the port's only
module-level importers of google.protobuf; the engine imports this
module inside `import_list`.
"""

from __future__ import annotations

import base64
import json
import struct

import numpy as np

from .. import sketches
from ..ingest.parser import MetricKey
from ..models.pipeline import ForwardExport
from .protos import forward_pb2, metric_pb2

HLL_VERSION = 1

# ---- sketch-engine/wire-format stamp (mixed-fleet safety) ----
#
# Every forward request declares which sketch engines produced its
# payloads: "h=<engine>/<wire_ver>,s=<engine>/<wire_ver>" (strings
# minted by sketches.engine_stamp). Carriers: MetricList.sketch_engines
# (field 4) on the forwardrpc arm, the metadata key below on the
# SendMetricsV2 stream, and the header below on jsonmetric-v1. An
# ABSENT stamp means a legacy peer running the default pair; a PRESENT
# stamp that does not match the receiver's engines is rejected loudly
# (counted + per-sender at /debug/fleet) — incompatible register banks
# must never merge silently. Like the envelope/trace codecs, the
# field<->header mapping lives ONLY here; the stamp string format
# itself lives in sketches/.

SKETCH_HEADER = "X-Veneur-Sketch-Engines"
SKETCH_METADATA_KEY = "veneur-sketch-engines"

# per-prefix Huffman-Bucket cardinality sketches riding to the global
# tier (overload-defense satellite): MetricList.prefix_sketches rows on
# the forwardrpc arm, one base64(json) header on jsonmetric-v1 (capped
# by the SENDER to its top prefixes — headers have practical size
# limits; the pb arm carries the full set)
PREFIX_SKETCH_HEADER = "X-Veneur-Prefix-Sketches"


def sketch_stamp_from_headers(headers) -> str | None:
    v = _header_get(headers, SKETCH_HEADER)
    return str(v) if v else None


def sketch_stamp_from_metric_list(ml) -> str | None:
    return ml.sketch_engines or None


def sketch_stamp_from_metadata(metadata) -> str | None:
    for key, value in metadata or ():
        if key == SKETCH_METADATA_KEY:
            v = value.decode() if isinstance(value, bytes) else value
            return v or None
    return None


def encode_prefix_sketches_header(items) -> str:
    """[(prefix, registers bytes)] -> one base64(json) header value."""
    payload = [[p, base64.b64encode(bytes(r)).decode("ascii")]
               for p, r in items]
    return base64.b64encode(
        json.dumps(payload, separators=(",", ":")).encode()).decode(
        "ascii")


def decode_prefix_sketches_header(value) -> list:
    """Inverse of encode_prefix_sketches_header; tolerant — a malformed
    advisory header decodes to [] (cardinality telemetry must never
    cost an interval), like the trace-context decoders."""
    try:
        payload = json.loads(base64.b64decode(value))
        return [(str(p), base64.b64decode(r)) for p, r in payload]
    except Exception:
        return []


def prefix_sketches_to_pb(ml, items) -> None:
    """Attach [(prefix, registers bytes)] rows to a MetricList."""
    for p, r in items:
        ml.prefix_sketches.add(prefix=str(p), registers=bytes(r))


def prefix_sketches_from_pb(ml) -> list:
    return [(ps.prefix, bytes(ps.registers))
            for ps in ml.prefix_sketches]

# ---- idempotency envelope (exactly-once forward) ----
#
# Every forwarded chunk carries (sender_id, interval_seq, chunk_index,
# chunk_count) so the receiving global tier can drop replays: the
# forwardrpc contract embeds a forwardrpc.Envelope (SendMetrics) or a
# binary metadata header (SendMetricsV2, streaming — there is no
# request message to hang it on); the jsonmetric-v1 contract carries
# the same four fields as HTTP headers. The encode helpers here are
# the ONLY place the field<->header mapping lives; the import server
# and the HTTP /import handler decode through the matching helpers so
# the two directions cannot drift (pinned bytes and headers:
# tests/test_torch_wire.py).

ENVELOPE_METADATA_KEY = "veneur-envelope-bin"   # gRPC metadata, serialized Envelope
ENVELOPE_SENDER_HEADER = "X-Veneur-Sender-Id"
ENVELOPE_SEQ_HEADER = "X-Veneur-Interval-Seq"
ENVELOPE_CHUNK_HEADER = "X-Veneur-Chunk"        # "<index>/<count>"

# ---- fleet-tracing context (cross-tier span propagation) ----
#
# The sender's flush-tick trace identity (trace_id + root span id) and
# interval-close wall time ride ALONGSIDE the envelope on both forward
# contracts: as Envelope fields 5-7 on the forwardrpc arm (and inside
# the serialized `veneur-envelope-bin` metadata of SendMetricsV2), as
# the two headers below on jsonmetric-v1. Observability only — the
# dedupe/apply path never reads them, a legacy peer ignores them, and
# decode is TOLERANT (malformed trace context degrades to None; it
# must never 400 a request whose envelope is fine). Like the envelope
# codecs, the field<->header mapping lives ONLY here.

TRACE_HEADER = "X-Veneur-Trace-Id"              # "<trace_id>:<span_id>"
TRACE_CLOSE_HEADER = "X-Veneur-Interval-Close-Ns"


def envelope_pb(sender_id: str, interval_seq: int, chunk_index: int,
                chunk_count: int, trace_id: int = 0, span_id: int = 0,
                close_ns: int = 0, kind: str = "full"):
    return forward_pb2.Envelope(
        sender_id=sender_id, interval_seq=int(interval_seq),
        chunk_index=int(chunk_index), chunk_count=int(chunk_count),
        trace_id=int(trace_id), span_id=int(span_id),
        interval_close_ns=int(close_ns),
        forward_kind=_KIND_TO_PB.get(kind, 0))


def envelope_headers(sender_id: str, interval_seq: int, chunk_index: int,
                     chunk_count: int, trace_id: int = 0,
                     span_id: int = 0, close_ns: int = 0,
                     kind: str = "full") -> dict:
    """The jsonmetric-v1 header encoding of one chunk's envelope (plus
    its trace context, when the sender has one — zero trace_id emits
    no trace headers, and a full-kind chunk emits no kind header,
    keeping legacy header sets byte-identical)."""
    out = {ENVELOPE_SENDER_HEADER: sender_id,
           ENVELOPE_SEQ_HEADER: str(int(interval_seq)),
           ENVELOPE_CHUNK_HEADER:
               f"{int(chunk_index)}/{int(chunk_count)}"}
    if kind == KIND_DELTA:
        out[FORWARD_KIND_HEADER] = KIND_DELTA
    if trace_id:
        out[TRACE_HEADER] = f"{int(trace_id)}:{int(span_id)}"
        if close_ns:
            out[TRACE_CLOSE_HEADER] = str(int(close_ns))
    return out


def _header_get(headers, name):
    v = headers.get(name)
    # urllib's Request stores header keys str.capitalize()d;
    # http.server's Message is case-insensitive already
    return v if v is not None else headers.get(name.capitalize())


def trace_from_headers(headers) -> tuple | None:
    """(trace_id, span_id, close_ns) from jsonmetric-v1 headers, or
    None. Tolerant: a malformed trace context is dropped (None), never
    an error — trace loss must not cost an interval."""
    raw = _header_get(headers, TRACE_HEADER)
    if not raw:
        return None
    try:
        tid, _, sid = str(raw).partition(":")
        if not int(tid):
            # zero trace_id means "no context" on every arm (the pb
            # and metadata decoders skip it the same way) — a peer
            # that stamps headers unconditionally must not produce a
            # dangling-parent span tree here
            return None
        close = _header_get(headers, TRACE_CLOSE_HEADER)
        return (int(tid), int(sid or 0), int(close or 0))
    except ValueError:
        return None


def trace_from_metric_list(ml) -> tuple | None:
    """Trace context of a forwardrpc.MetricList's envelope, or None."""
    if not ml.HasField("envelope") or not ml.envelope.trace_id:
        return None
    e = ml.envelope
    return (e.trace_id, e.span_id, e.interval_close_ns)


def trace_from_metadata(metadata) -> tuple | None:
    """Trace context of a SendMetricsV2 stream's invocation metadata,
    or None (shares the envelope's serialized-Envelope carrier)."""
    for key, value in metadata or ():
        if key == ENVELOPE_METADATA_KEY:
            try:
                e = forward_pb2.Envelope.FromString(value)
            except Exception:
                return None
            if e.trace_id:
                return (e.trace_id, e.span_id, e.interval_close_ns)
            return None
    return None


def envelope_from_headers(headers) -> tuple | None:
    """Decode (sender_id, interval_seq, chunk_index, chunk_count) from a
    mapping with .get (http.server headers, a plain dict). Returns None
    when no envelope was sent (legacy senders — dedupe is skipped);
    raises ValueError on a malformed one (the receiver 400s rather than
    mis-applying it)."""
    sender = _header_get(headers, ENVELOPE_SENDER_HEADER)
    seq = _header_get(headers, ENVELOPE_SEQ_HEADER)
    chunk = _header_get(headers, ENVELOPE_CHUNK_HEADER)
    if sender is None and seq is None and chunk is None:
        return None
    if not sender or seq is None:
        raise ValueError("incomplete forward envelope headers")
    try:
        idx, _, cnt = (chunk or "0/1").partition("/")
        return (sender, int(seq), int(idx), int(cnt or 1))
    except ValueError:
        raise ValueError(f"malformed forward envelope: seq={seq!r} "
                         f"chunk={chunk!r}") from None


def envelope_from_metric_list(ml) -> tuple | None:
    """Envelope of a forwardrpc.MetricList, or None (legacy sender)."""
    if not ml.HasField("envelope"):
        return None
    e = ml.envelope
    return (e.sender_id, e.interval_seq, e.chunk_index, e.chunk_count)


def envelope_from_metadata(metadata) -> tuple | None:
    """Envelope of a SendMetricsV2 stream's invocation metadata
    (an iterable of (key, value) pairs), or None."""
    for key, value in metadata or ():
        if key == ENVELOPE_METADATA_KEY:
            e = forward_pb2.Envelope.FromString(value)
            return (e.sender_id, e.interval_seq, e.chunk_index,
                    e.chunk_count)
    return None

# ---- forward kind: full | delta (delta forwarding) ----
#
# Every enveloped chunk declares whether its payload is a FULL export
# (the sender's complete active sketch set — and the gap-baseline
# reset) or a DELTA (only the sketches the dirty-slot bitmap saw
# touched this interval). Carriers: Envelope.forward_kind (field 8;
# 0 = full and every legacy chunk, 1 = delta) on the forwardrpc arm
# and inside the serialized `veneur-envelope-bin` SendMetricsV2
# metadata, and the header below on jsonmetric-v1 — emitted ONLY for
# deltas, so full/legacy header sets stay byte-identical. Decode is
# tolerant: an unknown kind reads as "full" (full skips the gap check
# and merge-applies, which is always sound; a delta misread as full
# can never corrupt state, only skip a belt-check). The field<->header
# mapping lives ONLY here, as the envelope/trace codecs' do.

FORWARD_KIND_HEADER = "X-Veneur-Forward-Kind"
KIND_FULL = "full"
KIND_DELTA = "delta"
_KIND_TO_PB = {KIND_FULL: 0, KIND_DELTA: 1}

# the wire marker of a delta-over-gap refusal — the receiver puts it
# in the FAILED_PRECONDITION details (gRPC) and the 409 body's
# "error" field (HTTP); the sender-side leaf forwarders match on it
# to translate the refusal into DeltaGapRefusedError. One spelling,
# here, like every other wire literal in this module.
DELTA_GAP_DETAIL = "delta-over-gap"


def forward_kind_from_headers(headers) -> str:
    v = _header_get(headers, FORWARD_KIND_HEADER)
    return KIND_DELTA if v == KIND_DELTA else KIND_FULL


def forward_kind_from_metric_list(ml) -> str:
    if ml.HasField("envelope") and ml.envelope.forward_kind == 1:
        return KIND_DELTA
    return KIND_FULL


def forward_kind_from_metadata(metadata) -> str:
    for key, value in metadata or ():
        if key == ENVELOPE_METADATA_KEY:
            try:
                e = forward_pb2.Envelope.FromString(value)
            except Exception:
                return KIND_FULL
            return KIND_DELTA if e.forward_kind == 1 else KIND_FULL
    return KIND_FULL


_TYPE_TO_PB = {
    "counter": metric_pb2.Counter,
    "gauge": metric_pb2.Gauge,
    "histogram": metric_pb2.Histogram,
    "timer": metric_pb2.Timer,
    "set": metric_pb2.Set,
}
_PB_TO_TYPE = {v: k for k, v in _TYPE_TO_PB.items()}
_PB_TO_TYPE[metric_pb2.Timer] = "timer"


def encode_hll(registers: np.ndarray) -> bytes:
    """The HLL register wire row (code byte 1 — unchanged since the
    pre-registry tree). The engine-tagged codec lives in sketches/;
    this name is kept for the HLL arm's callers and golden tests."""
    return sketches.encode_set_registers("hll", registers)


def decode_hll(data: bytes) -> np.ndarray:
    engine_id, regs = sketches.decode_set_registers(data)
    if engine_id != "hll":
        raise ValueError("bad HLL payload")
    return regs


def encode_set_payload(engine_id: str, registers) -> bytes:
    """Engine-tagged set-register wire row (byte 0 selects the engine:
    1 = HLL, 2 = ULL — see sketches.encode_set_registers)."""
    return sketches.encode_set_registers(engine_id, registers)


def decode_set_payload(data: bytes) -> tuple:
    """-> (engine_id, registers u8[m]); ValueError on unknown codes."""
    return sketches.decode_set_registers(data)


# ---- quantized-centroid wire row ----
#
# The q16 codec: one histogram's centroid list packed as
#
#     u32 n | f32 lo | f32 hi | n x u16 q_mean | n x varint q_weight
#
# (little-endian). Means are affine-quantized onto a per-list 16-bit
# grid between lo = min(means) and hi = max(means): the endpoints are
# exact, interior points carry <= (hi-lo)/65535/2 absolute error — the
# bounded mean-perturbation t-digest quantile bounds tolerate (arxiv
# 1902.04023; the exact count/sum/min/max ride the untouched TDigest
# scalar fields either way). Weights are 1/8-fixed-point varints,
# floored at 1/8 so a live centroid can never quantize to dead:
# q_w = max(1, round(w * 8)). -0.0 canonicalizes to +0.0 (the affine
# grid has one zero); non-finite means REFUSE (ValueError) and the
# caller falls back to the lossless row for that metric — quantization
# is a bytes optimization, never a correctness gamble. The math lives
# ONLY here, and
# the JSON carrier key is "centroids_q16" (base64 of this row).

Q16_JSON_KEY = "centroids_q16"
_Q16_GRID = 65535
_Q16_WSCALE = 8.0
_Q16_HEAD = struct.Struct("<Iff")


def _varint(n: int) -> bytes:
    """Scalar reference encoder — kept as the golden twin the
    vectorized block below is regression-pinned against."""
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


# varint byte-length thresholds: a value v needs 1 + #(thresholds <= v)
# bytes; 9 thresholds (2^7 .. 2^63) cover the full u64 range (10 bytes
# max — the q16 encoder refuses weights >= 2^63 anyway)
_VARINT_THRESHOLDS = (np.uint64(1) << (np.uint64(7) * np.arange(
    1, 10, dtype=np.uint64)))


def _varint_block(vals: np.ndarray) -> bytes:
    """Varint-encode a u64 vector in one numpy pass — BYTE-IDENTICAL
    to b"".join(_varint(int(v)) for v in vals), pinned by
    tests/test_torch_wire.py. The scalar join is a Python loop per
    element (an iteration, an int() unbox and a bytearray grow); here the
    byte count, the 7-bit chunks, and the continuation bits all
    compute columnwise and the row materializes with one tobytes()."""
    v = np.ascontiguousarray(vals, np.uint64)
    if v.size == 0:
        return b""
    nbytes = 1 + (v[:, None] >= _VARINT_THRESHOLDS[None, :]).sum(
        axis=1)
    total = int(nbytes.sum())
    ends = np.cumsum(nbytes)
    idx = np.repeat(np.arange(v.size), nbytes)        # value per byte
    pos = (np.arange(total)
           - np.repeat(ends - nbytes, nbytes)).astype(np.uint64)
    chunk = (v[idx] >> (np.uint64(7) * pos)) & np.uint64(0x7F)
    cont = (np.arange(total) + 1) != np.repeat(ends, nbytes)
    out = (chunk | (cont.astype(np.uint64) << np.uint64(7))) \
        .astype(np.uint8)
    # vlint: disable=DR02 reason=the q16 varint WIRE block (weight
    # fixed-point bytes, not a bank leaf); single-homed here per WC01
    return out.tobytes()


def _read_varint(data: bytes, off: int):
    shift = result = 0
    while True:
        if off >= len(data):
            raise ValueError("truncated q16 varint")
        b = data[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, off
        shift += 7
        if shift > 63:
            raise ValueError("oversized q16 varint")


def encode_q16_centroids(means, weights) -> bytes:
    """Pack (means, weights) into the q16 row. Zero/negative-weight
    entries are dropped (mirroring the lossless row); non-finite means
    raise ValueError (caller falls back to lossless for that metric)."""
    means = np.asarray(means, np.float64)
    weights = np.asarray(weights, np.float64)
    live = weights > 0
    means, weights = means[live], weights[live]
    if means.size and not np.isfinite(means).all():
        raise ValueError("non-finite centroid mean refuses q16")
    if weights.size and (not np.isfinite(weights).all()
                         or float(weights.max()) * _Q16_WSCALE >= 2**63):
        # an inf/NaN (or varint-overflowing) weight would cast to 0 in
        # the fixed-point step and silently DELETE a live centroid —
        # refuse instead, like non-finite means (caller falls back to
        # the lossless row for this metric)
        raise ValueError("non-finite/oversized centroid weight "
                         "refuses q16")
    n = int(means.size)
    if n == 0:
        return _Q16_HEAD.pack(0, 0.0, 0.0)
    # + 0.0 canonicalizes -0.0 endpoints (one zero on the grid)
    lo = float(means.min()) + 0.0
    hi = float(means.max()) + 0.0
    span = hi - lo
    if span > 0:
        q = np.rint((means - lo) * (_Q16_GRID / span))
        q = np.clip(q, 0, _Q16_GRID).astype(np.uint16)
    else:
        q = np.zeros(n, np.uint16)
    qw = np.maximum(1, np.rint(weights * _Q16_WSCALE)).astype(np.uint64)
    return (_Q16_HEAD.pack(n, lo, hi)
            # vlint: disable=DR02 reason=the q16 centroid WIRE row
            # (deliberately lossy quantized means, not a bank leaf);
            # single-homed here per WC01
            + q.astype("<u2").tobytes()
            + _varint_block(qw))


def decode_q16_centroids(data: bytes):
    """Inverse of encode_q16_centroids -> (means f32[n], weights
    f32[n]); ValueError on truncation (poison-pill reject path)."""
    if len(data) < _Q16_HEAD.size:
        raise ValueError("truncated q16 centroid row")
    n, lo, hi = _Q16_HEAD.unpack_from(data, 0)
    off = _Q16_HEAD.size
    if len(data) < off + 2 * n:
        raise ValueError("truncated q16 mean block")
    # vlint: disable=DR02 reason=inverse of the q16 wire row above —
    # same single-homed wire codec, not a bank-leaf byte move
    q = np.frombuffer(data, "<u2", n, off).astype(np.float64)
    off += 2 * n
    weights = np.empty(n, np.float64)
    for i in range(n):
        w, off = _read_varint(data, off)
        weights[i] = w / _Q16_WSCALE
    span = float(hi) - float(lo)
    if span > 0:
        means = lo + q * (span / _Q16_GRID)
    else:
        means = np.full(n, float(lo), np.float64)
    return means.astype(np.float32), weights.astype(np.float32)


def histogram_wire_fragment(means, weights, codec: str = "lossless"):
    """The jsonmetric-v1 centroid carrier for one histogram: the
    lossless [[mean, weight], ...] list under "centroids", or the q16
    row base64'd under "centroids_q16" (falling back to lossless for a
    list the codec refuses). Single home of both JSON spellings."""
    if codec == "q16":
        try:
            return {Q16_JSON_KEY: base64.b64encode(
                encode_q16_centroids(means, weights)).decode("ascii")}
        except ValueError:
            pass
    return {"centroids": [[float(m), float(w)]
                          for m, w in zip(means, weights)]}


def histogram_centroids_from_json(h: dict):
    """-> (means, weights) from a jsonmetric-v1 histogram dict,
    whichever carrier it used. The q16 arm raises ValueError on a
    malformed row (the import path 400s the body, like any other
    decode failure)."""
    packed = h.get(Q16_JSON_KEY)
    if packed is not None:
        return decode_q16_centroids(base64.b64decode(packed))
    cents = h.get("centroids", [])
    means = np.array([c[0] for c in cents], np.float32)
    weights = np.array([c[1] for c in cents], np.float32)
    return means, weights


def td_centroids(td):
    """-> (means f32, weights f32) of a metricpb TDigest, whichever
    row it carries — the ONE decode point for both representations
    (import apply, export inversion, journal recovery)."""
    if len(td.packed_centroids):
        return decode_q16_centroids(td.packed_centroids)
    return (np.array([c.mean for c in td.centroids], np.float32),
            np.array([c.weight for c in td.centroids], np.float32))


def export_to_metrics(export: ForwardExport,
                      codec: str = "lossless") -> list:
    """ForwardExport -> [metricpb.Metric] (the flush-side
    serialization). `codec` selects the centroid row: "lossless" (the
    default — repeated Centroid messages, bit-exact) or "q16" (the
    packed quantized row above; per-metric fallback to lossless when a
    list refuses quantization)."""
    out = []
    for key, means, weights, vmin, vmax, vsum, count, recip in (
            export.histograms):
        m = metric_pb2.Metric(
            name=key.name, tags=_split_tags(key.joined_tags),
            type=_TYPE_TO_PB.get(key.type, metric_pb2.Histogram),
            scope=metric_pb2.Global)
        td = m.histogram.t_digest
        td.min, td.max, td.sum = float(vmin), float(vmax), float(vsum)
        td.count, td.reciprocal_sum = float(count), float(recip)
        packed = None
        if codec == "q16":
            try:
                packed = encode_q16_centroids(means, weights)
            except ValueError:
                packed = None
        if packed is not None:
            td.packed_centroids = packed
        else:
            for mean, w in zip(np.asarray(means), np.asarray(weights)):
                if w > 0:
                    td.centroids.add(mean=float(mean), weight=float(w))
        out.append(m)
    for key, regs in export.sets:
        m = metric_pb2.Metric(name=key.name,
                              tags=_split_tags(key.joined_tags),
                              type=metric_pb2.Set, scope=metric_pb2.Global)
        m.set.hyper_log_log = encode_set_payload(export.set_engine, regs)
        out.append(m)
    for key, value in export.counters:
        m = metric_pb2.Metric(name=key.name,
                              tags=_split_tags(key.joined_tags),
                              type=metric_pb2.Counter,
                              scope=metric_pb2.Global)
        m.counter.value = int(round(value))
        out.append(m)
    for key, value in export.gauges:
        m = metric_pb2.Metric(name=key.name,
                              tags=_split_tags(key.joined_tags),
                              type=metric_pb2.Gauge,
                              scope=metric_pb2.Global)
        m.gauge.value = float(value)
        out.append(m)
    return out


def export_from_metrics(metrics) -> ForwardExport:
    """[metricpb.Metric] -> ForwardExport — the exact inverse of
    export_to_metrics over its image (entry order preserved per type,
    so the concatenated wire order survives a roundtrip and replayed
    chunk indices keep lining up). Counter values come back as the
    wire's int64; callers that need exact floats (the durability
    journal) carry them in a side channel."""
    export = ForwardExport()
    for m in metrics:
        key = metric_key_of(m)
        which = m.WhichOneof("value")
        if which == "histogram":
            td = m.histogram.t_digest
            means, weights = td_centroids(td)
            export.histograms.append(
                (key, means, weights, td.min, td.max, td.sum, td.count,
                 td.reciprocal_sum))
        elif which == "set":
            eng_id, regs = decode_set_payload(m.set.hyper_log_log)
            export.sets.append((key, regs))
            export.set_engine = eng_id
        elif which == "counter":
            export.counters.append((key, float(m.counter.value)))
        elif which == "gauge":
            export.gauges.append((key, float(m.gauge.value)))
    return export


def metric_key_of(m) -> MetricKey:
    mtype = _PB_TO_TYPE.get(m.type, "histogram")
    return MetricKey(name=m.name, type=mtype,
                     joined_tags=",".join(sorted(m.tags)))


def apply_metric_to_engine(engine, m) -> None:
    """metricpb.Metric -> engine.import_* (the Combine dispatch)."""
    key = metric_key_of(m)
    which = m.WhichOneof("value")
    if which == "histogram":
        td = m.histogram.t_digest
        means, weights = td_centroids(td)
        engine.import_histogram(key, means, weights, td.min, td.max,
                                td.sum, td.count, td.reciprocal_sum)
    elif which == "set":
        eng_id, regs = decode_set_payload(m.set.hyper_log_log)
        engine.import_set(key, regs, eng_id)
    elif which == "counter":
        engine.import_counter(key, float(m.counter.value))
    elif which == "gauge":
        engine.import_gauge(key, m.gauge.value)


def apply_metric_to_engine_locked(engine, m) -> None:
    """The Combine dispatch for a caller already holding engine.lock —
    AggregationEngine.import_list applies a whole journaled import op
    under ONE lock hold (the durability watermark's consistent cut).
    Decode is identical to apply_metric_to_engine; only the locking
    discipline differs."""
    key = metric_key_of(m)
    which = m.WhichOneof("value")
    if which == "histogram":
        td = m.histogram.t_digest
        means, weights = td_centroids(td)
        engine._import_histogram_locked(
            key, means, weights, td.min, td.max, td.sum, td.count,
            td.reciprocal_sum)
    elif which == "set":
        eng_id, regs = decode_set_payload(m.set.hyper_log_log)
        engine._import_set_locked(key, regs, eng_id)
    elif which == "counter":
        engine._import_counter_locked(key, float(m.counter.value))
    elif which == "gauge":
        engine._import_gauge_locked(key, m.gauge.value)


def _split_tags(joined: str) -> list[str]:
    return joined.split(",") if joined else []
