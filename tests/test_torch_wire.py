"""veneur_tpu_torch/cluster/wire.py against the wire's golden bytes and
against veneur_tpu/cluster/wire.py.

The golden bytes are built by hand from the .proto field numbers with a
minimal protobuf encoder (independent of the protobuf runtime), as
tests/test_wire_golden.py builds them for the JAX package: each port
message must serialize to exactly these bytes, these bytes must parse
back to the expected values, and the JAX package's wire must produce the
same bytes from the same export. Comparison level: exact (wire bytes,
decoded values, header sets).
"""

import base64
import random
import struct

import numpy as np
import pytest

from veneur_tpu.cluster import wire as jwire
from veneur_tpu.ingest.parser import MetricKey as JMetricKey
from veneur_tpu.models.pipeline import ForwardExport as JForwardExport
from veneur_tpu_torch import sketches
from veneur_tpu_torch.cluster import wire
from veneur_tpu_torch.cluster.protos import forward_pb2, metric_pb2
from veneur_tpu_torch.ingest.parser import MetricKey
from veneur_tpu_torch.models.pipeline import ForwardExport


# --- minimal hand encoder (protobuf wire spec, nothing else) ---

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _ld(field: int, payload: bytes) -> bytes:      # length-delimited
    return _tag(field, 2) + _varint(len(payload)) + payload


def _s(field: int, text: str) -> bytes:
    return _ld(field, text.encode())


def _vi(field: int, n: int) -> bytes:              # varint scalar
    return _tag(field, 0) + _varint(n)


def _d(field: int, x: float) -> bytes:             # 64-bit double
    return _tag(field, 1) + struct.pack("<d", x)


def _both(fill, codec="lossless"):
    """Serialized metrics of one export built by `fill(export, MetricKey)`
    through the port's wire and through the JAX package's."""
    out = []
    for exp_cls, key_cls, w in ((ForwardExport, MetricKey, wire),
                                (JForwardExport, JMetricKey, jwire)):
        export = exp_cls()
        fill(export, key_cls)
        out.append([m.SerializeToString()
                    for m in w.export_to_metrics(export, codec=codec)])
    return out


def _counter(export, K):
    export.counters.append((K("c.x", "counter", "a:b,c:d"), 42.0))


def _gauge(export, K):
    export.gauges.append((K("g", "gauge", ""), -1.5))


def _histogram(export, K):
    export.histograms.append(
        (K("h", "histogram", "k:v"), np.array([1.0, 3.0]),
         np.array([2.0, 1.0]), 1.0, 3.0, 5.0, 3.0, 7.0 / 6.0))


def test_metric_counter_golden_bytes():
    port, ref = _both(_counter)
    golden = (_s(1, "c.x") + _s(2, "a:b") + _s(2, "c:d")
              # type = 3 is Counter = 0 -> omitted (proto3 default)
              + _ld(4, _vi(1, 42))      # counter = 4 { value = 1 }
              + _vi(8, 2))              # scope = 8 (Global = 2)
    assert port == ref == [golden]
    back = metric_pb2.Metric.FromString(golden)
    assert back.name == "c.x" and list(back.tags) == ["a:b", "c:d"]
    assert back.WhichOneof("value") == "counter"
    assert back.counter.value == 42 and back.scope == metric_pb2.Global


def test_metric_gauge_golden_bytes():
    port, ref = _both(_gauge)
    golden = (_s(1, "g") + _vi(3, 1)    # type = Gauge = 1
              + _ld(5, _d(1, -1.5))     # gauge = 5 { value = 1 }
              + _vi(8, 2))
    assert port == ref == [golden]
    assert metric_pb2.Metric.FromString(golden).gauge.value == -1.5


def test_metric_histogram_golden_bytes():
    port, ref = _both(_histogram)
    centroids = (_ld(1, _d(1, 1.0) + _d(2, 2.0))
                 + _ld(1, _d(1, 3.0) + _d(2, 1.0)))
    tdigest = (centroids + _d(2, 1.0) + _d(3, 3.0) + _d(4, 5.0)
               + _d(5, 3.0) + _d(6, 7.0 / 6.0))
    golden = (_s(1, "h") + _s(2, "k:v") + _vi(3, 2)
              + _ld(6, _ld(1, tdigest)) + _vi(8, 2))
    assert port == ref == [golden]
    td = metric_pb2.Metric.FromString(golden).histogram.t_digest
    assert [c.mean for c in td.centroids] == [1.0, 3.0]
    assert td.count == 3.0 and td.reciprocal_sum == 7.0 / 6.0


@pytest.mark.parametrize("engine_id,code", [("hll", 1), ("ull", 2)])
def test_metric_set_golden_bytes(engine_id, code):
    regs = np.zeros(16, np.uint8)      # precision 4
    regs[3] = 9

    def fill(export, K):
        export.set_engine = engine_id
        export.sets.append((K("s", "set", ""), regs))

    port, ref = _both(fill)
    payload = bytes([code, 4]) + regs.tobytes()
    golden = (_s(1, "s") + _vi(3, 3)   # type = Set = 3
              + _ld(7, _ld(1, payload)) + _vi(8, 2))
    assert port == ref == [golden]
    back = metric_pb2.Metric.FromString(golden)
    eng, got = wire.decode_set_payload(back.set.hyper_log_log)
    assert eng == engine_id and np.array_equal(got, regs)
    if engine_id == "hll":
        assert np.array_equal(wire.decode_hll(back.set.hyper_log_log), regs)
        assert wire.encode_hll(regs) == payload
    else:
        with pytest.raises(ValueError):
            wire.decode_hll(back.set.hyper_log_log)


def test_metric_status_check_golden_bytes():
    m = metric_pb2.Metric(name="ck", type=metric_pb2.StatusCheck)
    m.status_check.status = 2.0
    m.status_check.message = "crit"
    golden = (_s(1, "ck") + _vi(3, 4)
              + _ld(9, _d(1, 2.0) + _s(2, "crit")))
    assert m.SerializeToString() == golden
    assert metric_pb2.Metric.FromString(golden).status_check.message == \
        "crit"


def test_forwardrpc_metric_list_golden_bytes():
    def fill(export, K):
        export.counters.append((K("c", "counter", ""), 7.0))

    (port,), _ref = _both(fill)
    ml = forward_pb2.MetricList(metrics=[metric_pb2.Metric.FromString(port)])
    inner = _s(1, "c") + _ld(4, _vi(1, 7)) + _vi(8, 2)
    assert ml.SerializeToString() == _ld(1, inner)
    assert forward_pb2.MetricList.FromString(
        _ld(1, inner)).metrics[0].counter.value == 7


def _golden_envelope_bytes():
    return _s(1, "s1") + _vi(2, 7) + _vi(3, 1) + _vi(4, 3)


def test_envelope_golden_bytes_all_three_carriers():
    env = wire.envelope_pb("s1", 7, 1, 3)
    golden = _golden_envelope_bytes()
    assert env.SerializeToString() == golden == \
        jwire.envelope_pb("s1", 7, 1, 3).SerializeToString()
    back = forward_pb2.Envelope.FromString(golden)
    assert (back.sender_id, back.interval_seq, back.chunk_index,
            back.chunk_count) == ("s1", 7, 1, 3)
    ml = forward_pb2.MetricList()
    ml.envelope.CopyFrom(back)
    assert wire.envelope_from_metric_list(ml) == ("s1", 7, 1, 3)
    assert wire.envelope_from_metric_list(
        forward_pb2.MetricList()) is None
    assert wire.ENVELOPE_METADATA_KEY == "veneur-envelope-bin"
    md = [(wire.ENVELOPE_METADATA_KEY, golden)]
    assert wire.envelope_from_metadata(md) == ("s1", 7, 1, 3)


def test_jsonmetric_v1_envelope_headers_golden():
    headers = wire.envelope_headers("s1", 7, 1, 3)
    assert headers == jwire.envelope_headers("s1", 7, 1, 3) == {
        "X-Veneur-Sender-Id": "s1", "X-Veneur-Interval-Seq": "7",
        "X-Veneur-Chunk": "1/3"}
    assert wire.envelope_from_headers(headers) == ("s1", 7, 1, 3)
    assert wire.envelope_from_headers(
        {"X-Veneur-Sender-Id": "s1",
         "X-Veneur-Interval-Seq": "7"}) == ("s1", 7, 0, 1)
    assert wire.envelope_from_headers({}) is None
    with pytest.raises(ValueError):
        wire.envelope_from_headers({"X-Veneur-Interval-Seq": "7"})
    with pytest.raises(ValueError):
        wire.envelope_from_headers({"X-Veneur-Sender-Id": "s1",
                                    "X-Veneur-Interval-Seq": "x"})


@pytest.mark.parametrize("headers", [
    {}, {"X-Veneur-Trace-Id": "5:6"},
    {"X-Veneur-Trace-Id": "5:6", "X-Veneur-Interval-Close-Ns": "99"},
    {"X-Veneur-Trace-Id": "0:6"}, {"X-Veneur-Trace-Id": "bad"},
    {"X-veneur-trace-id": "5:6"}])
def test_trace_context_decodes_as_the_reference(headers):
    assert wire.trace_from_headers(headers) == \
        jwire.trace_from_headers(headers)


def test_trace_context_on_the_envelope():
    env = wire.envelope_pb("s1", 7, 0, 1, trace_id=11, span_id=12,
                           close_ns=13, kind="delta")
    assert env.SerializeToString() == jwire.envelope_pb(
        "s1", 7, 0, 1, trace_id=11, span_id=12, close_ns=13,
        kind="delta").SerializeToString()
    ml = forward_pb2.MetricList()
    ml.envelope.CopyFrom(env)
    assert wire.trace_from_metric_list(ml) == (11, 12, 13)
    md = [(wire.ENVELOPE_METADATA_KEY, env.SerializeToString())]
    assert wire.trace_from_metadata(md) == (11, 12, 13)
    assert wire.forward_kind_from_metadata(md) == "delta"
    assert wire.trace_from_metadata([(wire.ENVELOPE_METADATA_KEY,
                                      b"\xff")]) is None
    h = wire.envelope_headers("s1", 7, 0, 1, trace_id=11, span_id=12,
                              close_ns=13)
    assert h == jwire.envelope_headers("s1", 7, 0, 1, trace_id=11,
                                       span_id=12, close_ns=13)
    assert wire.trace_from_headers(h) == (11, 12, 13)


def test_sketch_stamp_and_prefix_sketch_codecs():
    from veneur_tpu import sketches as jsk
    for stamp in (sketches.DEFAULT_STAMP, "h=req/1,s=ull/1"):
        for codec in ("lossless", "q16"):
            assert sketches.stamp_with_codec(stamp, codec) == \
                jsk.stamp_with_codec(stamp, codec)
    assert sketches.stamp_with_codec("h=tdigest/1,s=hll/1", "q16") == \
        "h=tdigest/1q,s=hll/1"
    ml = forward_pb2.MetricList(sketch_engines="h=req/1,s=ull/1")
    assert wire.sketch_stamp_from_metric_list(ml) == "h=req/1,s=ull/1"
    assert wire.sketch_stamp_from_headers(
        {wire.SKETCH_HEADER: "h=x/1,s=y/1"}) == "h=x/1,s=y/1"
    assert wire.sketch_stamp_from_metadata(
        [(wire.SKETCH_METADATA_KEY, b"h=x/1,s=y/1")]) == "h=x/1,s=y/1"
    items = [("api", bytes(range(16))), ("db", b"\x00" * 16)]
    hv = wire.encode_prefix_sketches_header(items)
    assert hv == jwire.encode_prefix_sketches_header(items)
    assert wire.decode_prefix_sketches_header(hv) == items
    assert wire.decode_prefix_sketches_header("!!") == []
    wire.prefix_sketches_to_pb(ml, items)
    assert ml.SerializeToString() == (
        _ld(3, _s(1, "api") + _ld(2, bytes(range(16))))
        + _ld(3, _s(1, "db") + _ld(2, b"\x00" * 16))
        + _s(4, "h=req/1,s=ull/1"))
    assert wire.prefix_sketches_from_pb(ml) == items


# --- quantized-centroid wire row (q16) ---

def _golden_q16_row():
    return (struct.pack("<Iff", 2, 1.0, 3.0) + struct.pack("<HH", 0, 65535)
            + bytes([16]) + bytes([8]))


def test_q16_row_golden_bytes():
    row = wire.encode_q16_centroids(np.array([1.0, 3.0]),
                                    np.array([2.0, 1.0]))
    assert row == _golden_q16_row()
    means, weights = wire.decode_q16_centroids(row)
    np.testing.assert_array_equal(means, np.float32([1.0, 3.0]))
    np.testing.assert_array_equal(weights, np.float32([2.0, 1.0]))


def test_q16_metric_golden_bytes():
    port, ref = _both(_histogram, codec="q16")
    tdigest = (_d(2, 1.0) + _d(3, 3.0) + _d(4, 5.0) + _d(5, 3.0)
               + _d(6, 7.0 / 6.0) + _ld(7, _golden_q16_row()))
    golden = (_s(1, "h") + _s(2, "k:v") + _vi(3, 2)
              + _ld(6, _ld(1, tdigest)) + _vi(8, 2))
    assert port == ref == [golden]
    back = metric_pb2.Metric.FromString(golden)
    means, weights = wire.td_centroids(back.histogram.t_digest)
    np.testing.assert_array_equal(means, np.float32([1.0, 3.0]))
    np.testing.assert_array_equal(weights, np.float32([2.0, 1.0]))


def test_q16_roundtrip_within_quantization_bound():
    rng = random.Random(17)
    for _trial in range(100):
        n = rng.randrange(1, 80)
        means = np.float32([rng.uniform(-1e6, 1e6) for _ in range(n)])
        weights = np.float32(
            [rng.choice([1.0, 0.5, 3.25, 2.0, 1e5]) for _ in range(n)])
        row = wire.encode_q16_centroids(means, weights)
        assert row == jwire.encode_q16_centroids(means, weights)
        m2, w2 = wire.decode_q16_centroids(row)
        span = float(means.max() - means.min())
        assert np.abs(m2 - means).max() <= span / 65535 / 2 + abs(
            span) * 1e-6 + 1e-3
        assert np.abs(w2 - weights).max() <= 1 / 16 + 1e-6
        assert np.float32(m2.min()) == np.float32(means.min())
        assert np.float32(m2.max()) == np.float32(means.max())


def test_q16_edges_nan_negzero_empty():
    row = wire.encode_q16_centroids([], [])
    assert row == struct.pack("<Iff", 0, 0.0, 0.0)
    m, w = wire.decode_q16_centroids(row)
    assert m.size == 0 and w.size == 0
    m, w = wire.decode_q16_centroids(
        wire.encode_q16_centroids([-0.0, -0.0], [1.0, 1.0]))
    assert not np.signbit(m).any() and (m == 0.0).all()
    for means, weights in (([np.nan], [1.0]), ([np.inf, 1.0], [1.0, 1.0]),
                           ([1.0, 2.0], [np.inf, 2.0]), ([1.0], [1e19])):
        with pytest.raises(ValueError):
            wire.encode_q16_centroids(means, weights)

    def fill(export, K):
        export.histograms.append(
            (K("h", "histogram", ""), np.array([np.inf, 1.0]),
             np.array([1.0, 2.0]), 1.0, 1.0, 1.0, 3.0, 0.0))

    port, ref = _both(fill, codec="q16")
    assert port == ref
    td = metric_pb2.Metric.FromString(port[0]).histogram.t_digest
    assert len(td.packed_centroids) == 0 and len(td.centroids) == 2
    m, w = wire.decode_q16_centroids(
        wire.encode_q16_centroids([5.0, 6.0], [0.0, 2.0]))
    np.testing.assert_array_equal(m, np.float32([6.0]))
    with pytest.raises(ValueError):
        wire.decode_q16_centroids(_golden_q16_row()[:-3])


def test_q16_json_carrier_roundtrip():
    frag = wire.histogram_wire_fragment(
        np.array([1.0, 3.0]), np.array([2.0, 1.0]), codec="q16")
    assert frag == {"centroids_q16": base64.b64encode(
        _golden_q16_row()).decode("ascii")}
    m, _w = wire.histogram_centroids_from_json(frag)
    np.testing.assert_array_equal(m, np.float32([1.0, 3.0]))
    lossless = wire.histogram_wire_fragment(
        np.array([1.0, 3.0]), np.array([2.0, 1.0]))
    assert lossless == {"centroids": [[1.0, 2.0], [3.0, 1.0]]}
    _m, w = wire.histogram_centroids_from_json(lossless)
    np.testing.assert_array_equal(w, np.float32([2.0, 1.0]))


def test_envelope_forward_kind_golden_bytes():
    env = wire.envelope_pb("s1", 7, 1, 3, kind="delta")
    golden = _golden_envelope_bytes() + _vi(8, 1)
    assert env.SerializeToString() == golden
    back = forward_pb2.Envelope.FromString(golden)
    assert back.forward_kind == 1
    ml = forward_pb2.MetricList()
    ml.envelope.CopyFrom(back)
    assert wire.forward_kind_from_metric_list(ml) == "delta"
    assert wire.forward_kind_from_metric_list(
        forward_pb2.MetricList()) == "full"
    for kind in (None, "full"):
        kw = {} if kind is None else {"kind": kind}
        assert wire.envelope_pb("s1", 7, 1, 3, **kw).SerializeToString() \
            == _golden_envelope_bytes()


def test_jsonmetric_v1_forward_kind_headers_golden():
    headers = wire.envelope_headers("s1", 7, 1, 3, kind="delta")
    assert headers == {"X-Veneur-Sender-Id": "s1",
                       "X-Veneur-Interval-Seq": "7",
                       "X-Veneur-Chunk": "1/3",
                       "X-Veneur-Forward-Kind": "delta"}
    assert wire.forward_kind_from_headers(headers) == "delta"
    full = wire.envelope_headers("s1", 7, 1, 3)
    assert wire.FORWARD_KIND_HEADER not in full
    assert wire.forward_kind_from_headers(full) == "full"
    assert wire.forward_kind_from_headers(
        {"X-Veneur-Forward-Kind": "banana"}) == "full"


# --- randomized roundtrips ---

def test_export_metrics_roundtrip_random():
    rng = random.Random(5)
    tag_pool = ["env:prod", "høst:ünicøde", "emoji:\U0001f600", "empty:",
                "k:v:w", "plain"]
    for trial in range(200):
        n_cent = rng.randrange(0, 60)
        means = np.sort(np.float32(
            [rng.uniform(-1e30, 1e30) for _ in range(n_cent)]))
        weights = np.float32([rng.choice([1.0, 0.5, 3.25, 1e-3, 1e7])
                              for _ in range(n_cent)])
        tags = ",".join(sorted(rng.sample(tag_pool, rng.randrange(0, 4))))
        key = MetricKey(f"m.{trial}", "timer", tags)
        vmin = float(means.min()) if n_cent else 0.0
        vmax = float(means.max()) if n_cent else 0.0
        exp = ForwardExport(histograms=[
            (key, means, weights, vmin, vmax,
             float(np.float32(means.sum())), float(weights.sum()), 0.25)])
        data = [m.SerializeToString() for m in wire.export_to_metrics(exp)]
        jexp = JForwardExport(histograms=[
            (JMetricKey(key.name, key.type, key.joined_tags), means,
             weights, vmin, vmax, float(np.float32(means.sum())),
             float(weights.sum()), 0.25)])
        assert data == [m.SerializeToString()
                        for m in jwire.export_to_metrics(jexp)]
        (m,) = [metric_pb2.Metric.FromString(d) for d in data]
        assert wire.metric_key_of(m) == key
        back = wire.export_from_metrics([m])
        (bkey, bm, bw, bmin, bmax, _bs, bc, _br), = back.histograms
        assert bkey == key
        np.testing.assert_array_equal(bm, means)
        np.testing.assert_array_equal(bw, weights)
        assert np.float32(bmin) == np.float32(vmin)
        assert np.float32(bmax) == np.float32(vmax)
        assert np.float32(bc) == np.float32(weights.sum())


@pytest.mark.parametrize("engine_id", ["hll", "ull"])
def test_set_payload_roundtrip_random(engine_id):
    rng = np.random.default_rng(9)
    for p in (4, 10, 14):
        for _ in range(5):
            regs = rng.integers(0, 64, 1 << p).astype(np.uint8)
            data = wire.encode_set_payload(engine_id, regs)
            assert data == jwire.encode_set_payload(engine_id, regs)
            eng, got = wire.decode_set_payload(data)
            assert eng == engine_id
            np.testing.assert_array_equal(got, regs)
    with pytest.raises(ValueError):
        wire.decode_set_payload(b"\x09\x04" + bytes(16))
    with pytest.raises(ValueError):
        wire.decode_set_payload(b"\x01\x04" + bytes(15))


def test_export_from_metrics_inverts_every_type():
    export = ForwardExport(set_engine="ull")
    _histogram(export, MetricKey)
    export.sets.append((MetricKey("s", "set", "t:1"),
                        np.arange(16, dtype=np.uint8)))
    export.counters.append((MetricKey("c", "counter", ""), 9.0))
    export.gauges.append((MetricKey("g", "gauge", "x:y"), 0.25))
    metrics = wire.export_to_metrics(export)
    back = wire.export_from_metrics(
        [metric_pb2.Metric.FromString(m.SerializeToString())
         for m in metrics])
    assert back.set_engine == "ull"
    assert [k for k, *_ in back.histograms] == \
        [MetricKey("h", "histogram", "k:v")]
    assert back.counters == [(MetricKey("c", "counter", ""), 9.0)]
    assert back.gauges == [(MetricKey("g", "gauge", "x:y"), 0.25)]
    np.testing.assert_array_equal(back.sets[0][1], np.arange(16))


def test_metric_bytes_cross_between_the_packages():
    """A metric serialized by either package's pb2 classes parses in the
    other's and decodes to the same key and payload."""
    from veneur_tpu.cluster.protos import metric_pb2 as jmetric_pb2
    (port,), (ref,) = _both(_histogram)
    jm = jmetric_pb2.Metric.FromString(port)
    tm = metric_pb2.Metric.FromString(ref)
    assert jwire.metric_key_of(jm).name == wire.metric_key_of(tm).name
    np.testing.assert_array_equal(
        jwire.td_centroids(jm.histogram.t_digest)[0],
        wire.td_centroids(tm.histogram.t_digest)[0])


# --- the vectorized varint weight block ---

def test_varint_block_bit_identical_to_scalar_reference():
    edges = [0, 1, 127, 128, 255, 16383, 16384, 2**21 - 1, 2**21,
             2**28 - 1, 2**28, 2**35, 2**49, 2**62, 2**63 - 1]
    rng = np.random.default_rng(23)
    vals = np.array(
        edges + list(rng.integers(0, 2**63, 4096, dtype=np.uint64)),
        np.uint64)
    block = wire._varint_block(vals)
    assert block == b"".join(wire._varint(int(v)) for v in vals)
    assert block == jwire._varint_block(vals)
    assert wire._varint_block(np.array([], np.uint64)) == b""
    assert wire._varint_block(np.array([300], np.uint64)) == \
        wire._varint(300)


def test_q16_weight_bytes_unchanged_by_vectorization():
    rng = np.random.default_rng(29)
    means = rng.normal(50, 20, 300)
    weights = np.round(rng.uniform(0.1, 9000, 300), 3)
    row = wire.encode_q16_centroids(means, weights)
    assert row == jwire.encode_q16_centroids(means, weights)
    n, _lo, _hi = wire._Q16_HEAD.unpack_from(row, 0)
    off = wire._Q16_HEAD.size + 2 * n
    qw = np.maximum(1, np.rint(
        np.asarray(weights, np.float64) * 8.0)).astype(np.uint64)
    assert row[off:] == b"".join(wire._varint(int(w)) for w in qw)
    _m, got_w = wire.decode_q16_centroids(row)
    np.testing.assert_allclose(got_w, weights, atol=1 / 16)
