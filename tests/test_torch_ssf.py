"""The port's SSF pipeline against the reference's (ROADMAP item 9b).

The same spans and samples go through the reference functions
(`veneur_tpu.ssf`, `.ssf.framing`, `.sinks.ssfmetrics`) and the port's:
framing bytes and decode results, the sample helpers, the conversion of
samples into metrics and service checks, the indicator timer. Then the
reference's span flows (tests/test_ssf.py) against a port server: UDP,
TCP and UNIX end to end, the trace client, report_batch, a status sample,
stop() and the IPv6 listeners. Last, the gate: one span stream into a
reference server and a port server, both self-tracing, over three
flushes: equal row-key sets, values under the ROADMAP contract.
"""

import io
import random
import socket
import struct
import time

import numpy as np
import pytest

from veneur_tpu import ssf as jssf
from veneur_tpu.config import read_config as jread_config
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks import ssfmetrics as jsm
from veneur_tpu.sinks.basic import CaptureMetricSink as JCapture
from veneur_tpu.ssf import framing as jframing
from veneur_tpu_torch import ssf, trace
from veneur_tpu_torch.config import Config, read_config
from veneur_tpu_torch.ingest.parser import GLOBAL_ONLY
from veneur_tpu_torch.metrics import MetricType
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks import ssfmetrics as tsm
from veneur_tpu_torch.sinks.basic import CaptureMetricSink
from veneur_tpu_torch.ssf import framing
from veneur_tpu_torch.ssf.protos import ssf_pb2

from test_torch_server import (EXACT_SELF, _clear_process_registries,
                               _compare, _flush, _rows, _wait)

T0 = 1_700_000_000_000_000_000


def make_span(name="op", service="svc", n_samples=0, **kw):
    kw = {"start_timestamp": T0 - 1_000_000, "end_timestamp": T0, **kw}
    span = ssf_pb2.SSFSpan(version=0, trace_id=7, id=8, parent_id=0,
                           name=name, service=service, **kw)
    for i in range(n_samples):
        span.metrics.append(ssf.count(f"sample.{i}", 1.0, timestamp=T0))
    return span


# ---------------- framing ----------------

def test_enums_are_the_protos():
    S = ssf_pb2.SSFSample
    assert (ssf.COUNTER, ssf.GAUGE, ssf.HISTOGRAM, ssf.SET, ssf.STATUS) \
        == (S.COUNTER, S.GAUGE, S.HISTOGRAM, S.SET, S.STATUS)
    assert tsm._SSF_SCOPE == {S.DEFAULT: 0, S.LOCAL: tsm.LOCAL_ONLY,
                              S.GLOBAL: GLOBAL_ONLY}
    assert ssf.SSFSpan is ssf_pb2.SSFSpan
    assert ssf.SSFSample is ssf_pb2.SSFSample


@pytest.mark.parametrize("n_samples", [0, 1, 5])
def test_write_ssf_bytes_equal(n_samples):
    span = make_span(n_samples=n_samples, indicator=True)
    span.tags["k"] = "v"
    assert framing.write_ssf(span) == jframing.write_ssf(span)


_GOOD = jframing.write_ssf(make_span(n_samples=2))
_FRAMES = {
    "good": _GOOD,
    "two": _GOOD + _GOOD,
    "empty": b"",
    "truncated_payload": _GOOD[:-1],
    "truncated_header": _GOOD[:3],
    "oversized": bytes([0]) + struct.pack(
        "<I", jframing.MAX_FRAME_LENGTH + 1) + b"x" * 10,
    "bad_version": b"\x01aaaa",
    "garbage_payload": bytes([0]) + struct.pack("<I", 4) + b"\xff" * 4,
}


def _outcome(fn):
    try:
        r = fn()
    except Exception as e:    # the exception's type is the result
        return ("raises", type(e).__name__)
    return ("ok", r.SerializeToString() if hasattr(r, "SerializeToString")
            else r)


@pytest.mark.parametrize("case", sorted(_FRAMES))
def test_frame_reads_equal(case):
    data = _FRAMES[case]
    assert framing.MAX_FRAME_LENGTH == jframing.MAX_FRAME_LENGTH
    for port_fn, ref_fn in ((framing.read_ssf_frame,
                             jframing.read_ssf_frame),
                            (framing.read_ssf, jframing.read_ssf)):
        tb, jb = io.BytesIO(data), io.BytesIO(data)
        got = [_outcome(lambda: port_fn(tb)) for _ in range(3)]
        want = [_outcome(lambda: ref_fn(jb)) for _ in range(3)]
        assert got == want, case


@pytest.mark.parametrize("data", [
    make_span(n_samples=3).SerializeToString(), b"", b"garbage\xff",
    b"\xff\xff\xff\xff", _GOOD[5:]])
def test_parse_ssf_datagram_equal(data):
    assert _outcome(lambda: framing.parse_ssf_datagram(data)) == \
        _outcome(lambda: jframing.parse_ssf_datagram(data))


@pytest.mark.parametrize("span", [
    make_span(), ssf_pb2.SSFSpan(service="bare"), make_span(name=""),
    ssf_pb2.SSFSpan(id=1, start_timestamp=1, end_timestamp=2, name="x")])
def test_validate_trace_equal(span):
    assert framing.validate_trace(span) == jframing.validate_trace(span)


# ---------------- sample helpers ----------------

def _helper_calls(mod):
    kw = {"timestamp": T0}
    tags = {"route": "/x", "flag": ""}
    return [
        mod.count("reqs", 2.0, tags, **kw),
        mod.count("reqs", 3, sample_rate=0.25, **kw),
        mod.gauge("g", -1.5, tags, **kw),
        mod.histogram("h", 1.25, **kw),
        mod.timing("lat", 0.25, mod.MILLISECOND, tags, **kw),
        mod.timing("lat", 0.25, mod.SECOND, **kw),
        mod.timing("lat", 3e-6, mod.MICROSECOND, **kw),
        mod.timing("lat", 3e-6, "us", **kw),
        mod.timing("lat", 4e-9, mod.NANOSECOND, **kw),
        mod.timing("lat", 1.0, "fortnights", **kw),
        mod.set_sample("users", "u1", tags, **kw),
        mod.status("db", 2, tags, message="down", **kw),
    ]


def test_sample_helpers_equal():
    assert ssf.TIME_UNITS == jssf.TIME_UNITS
    got = [s.SerializeToString() for s in _helper_calls(ssf)]
    want = [s.SerializeToString() for s in _helper_calls(jssf)]
    assert got == want


def test_randomly_sample_equal_under_one_seed():
    r1, r2 = random.Random(5), random.Random(5)
    for i in range(200):
        rate = (0.1, 0.5, 0.9, 1.0)[i % 4]
        a = ssf.randomly_sample(rate, ssf.count("a", 1, timestamp=T0),
                                ssf.gauge("b", 2, timestamp=T0), rng=r1)
        b = jssf.randomly_sample(rate, jssf.count("a", 1, timestamp=T0),
                                 jssf.gauge("b", 2, timestamp=T0), rng=r2)
        assert [s.SerializeToString() for s in a] == \
            [s.SerializeToString() for s in b]


def test_samples_attach_equal():
    t, j = ssf.Samples(), jssf.Samples()
    t.add(*_helper_calls(ssf))
    j.add(*_helper_calls(jssf))
    ts, js = make_span(), make_span()
    t.attach(ts)
    j.attach(js)
    assert ts.SerializeToString() == js.SerializeToString()


# ---------------- ssfmetrics conversion ----------------

def _samples():
    out = _helper_calls(ssf)
    for scope in (0, 1, 2):
        s = ssf.gauge("scoped", 1.0, timestamp=T0)
        s.scope = scope
        out.append(s)
    out.append(ssf.count("", 1.0, timestamp=T0))          # no name
    out.append(ssf.status("", 1, timestamp=T0))
    out.append(ssf.status("ts", 0, timestamp=0))
    odd = ssf.count("odd", 1.0, timestamp=T0)
    odd.metric = 9                                           # unknown
    out.append(odd)
    return out


def _fields(x):
    if x is None:
        return None
    d = dict(vars(x))
    if "key" in d:
        k = d.pop("key")
        d["key"] = (k.name, k.type, k.joined_tags)
    return d


def test_sample_to_metric_and_check_equal():
    for s in _samples():
        assert _fields(tsm.sample_to_metric(s)) == \
            _fields(jsm.sample_to_metric(s)), s
        assert _fields(tsm.sample_to_check(s)) == \
            _fields(jsm.sample_to_check(s)), s


def test_timer_units_normalise_to_ms():
    a = tsm.sample_to_metric(ssf.timing("lat", 0.25, ssf.SECOND))
    b = tsm.sample_to_metric(ssf.timing("lat", 0.25, ssf.MILLISECOND))
    assert a.key == b.key and a.key.type == "timer"
    assert a.value == pytest.approx(250.0) and b.value == pytest.approx(250)


@pytest.mark.parametrize("kw,name", [
    ({"indicator": True}, "obj"), ({"indicator": True, "error": True},
                                   "obj"),
    ({}, "obj"), ({"indicator": True}, ""),
    ({"indicator": True, "end_timestamp": 0}, "obj")])
def test_indicator_timer_equal(kw, name):
    span = make_span(**kw)
    assert _fields(tsm.indicator_timer(span, name)) == \
        _fields(jsm.indicator_timer(span, name))


def test_ssfmetrics_sink_submits_what_the_references_does():
    span = make_span(n_samples=3, indicator=True)
    span.metrics.extend(_samples())
    got, want = [], []
    tsink = tsm.SSFMetricsSink(got.append, "obj.timer")
    jsink = jsm.SSFMetricsSink(want.append, "obj.timer")
    tsink.ingest(span)
    jsink.ingest(span)
    assert [_fields(x) for x in got] == [_fields(x) for x in want]
    assert tsink.samples_extracted == jsink.samples_extracted == len(got)
    assert tsink.name() == jsink.name() == "ssfmetrics"


# ---------------- end-to-end span ingest (a port server) ----------------

def ssf_server(**kw):
    cfg = Config(interval="1s", num_workers=2, percentiles=[0.5],
                 aggregates=["count"], hostname="testhost",
                 aggregation_backend="cpu", tpu_histogram_slots=512,
                 tpu_counter_slots=512, tpu_gauge_slots=512,
                 tpu_set_slots=256, tpu_batch_size=256,
                 tpu_buffer_depth=64, **kw)
    sink = CaptureMetricSink()
    return Server(cfg, sinks=[sink]), sink


def _drain_and_flush(srv, sink, n=1):
    assert srv.drain(timeout=10.0)
    srv.flush_once()
    assert sink.wait_for_flush(n)


def test_udp_ssf_end_to_end():
    srv, sink = ssf_server(ssf_listen_addresses=["udp://127.0.0.1:0"])
    srv.start()
    try:
        port = srv._ssf_udp_sock.getsockname()[1]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as out:
            out.sendto(make_span(n_samples=2).SerializeToString(),
                       ("127.0.0.1", port))
        assert _wait(lambda: srv.span_sinks[0].samples_extracted >= 2)
        _drain_and_flush(srv, sink)
        names = {m.name for m in sink.all_metrics}
        assert "sample.0" in names and "sample.1" in names
        assert any(m.name == "veneur.ssf.received_total" and m.value >= 1
                   for m in sink.all_metrics)
    finally:
        srv.stop()


def test_tcp_ssf_stream_end_to_end():
    srv, sink = ssf_server(ssf_listen_addresses=["tcp://127.0.0.1:0"])
    srv.start()
    try:
        port = srv._listen_socks[0].getsockname()[1]
        conn = socket.create_connection(("127.0.0.1", port))
        for _ in range(3):
            conn.sendall(framing.write_ssf(make_span(n_samples=1)))
        assert _wait(lambda: srv.spans_received >= 3)
        # a corrupt frame kills only this connection
        conn.sendall(b"\x07garbage")
        assert _wait(lambda: srv.ssf_errors == 1)
        conn.close()
        _drain_and_flush(srv, sink)
        rows = {m.name: m.value for m in sink.all_metrics}
        assert rows["sample.0"] == 3.0
        assert rows["veneur.ssf.error_total"] == 1
    finally:
        srv.stop()


def test_unix_ssf_stream_end_to_end(tmp_path):
    path = str(tmp_path / "ssf.sock")
    srv, sink = ssf_server(ssf_listen_addresses=[f"unix://{path}"])
    srv.start()
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.connect(path)
            c.sendall(framing.write_ssf(make_span(n_samples=2)))
        assert _wait(lambda: srv.spans_received >= 1)
        _drain_and_flush(srv, sink)
        names = {m.name for m in sink.all_metrics}
        assert {"sample.0", "sample.1"} <= names
    finally:
        srv.stop()


def test_trace_client_to_server():
    srv, sink = ssf_server(ssf_listen_addresses=["udp://127.0.0.1:0"],
                           indicator_span_timer_name="objective")
    srv.start()
    try:
        port = srv._ssf_udp_sock.getsockname()[1]
        client = trace.Client(f"udp://127.0.0.1:{port}")
        with trace.start_span(client, "parent", service="svc",
                              indicator=True) as parent:
            parent.add(ssf.count("traced.count", 5.0))
            with trace.start_span(client, "child") as child:
                assert child.trace_id == parent.trace_id
                assert child.parent_id == parent.id
                assert trace.current_span() is child
        client.flush()
        assert _wait(lambda: srv.spans_received >= 2)
        _drain_and_flush(srv, sink)
        rows = {m.name: m for m in sink.all_metrics}
        assert rows["traced.count"].value == 5.0
        assert rows["objective.count"].tags == ["error:false",
                                                "service:svc"]
        client.close()
    finally:
        srv.stop()


def test_report_batch():
    srv, sink = ssf_server(ssf_listen_addresses=["udp://127.0.0.1:0"])
    srv.start()
    try:
        port = srv._ssf_udp_sock.getsockname()[1]
        client = trace.Client(f"udp://127.0.0.1:{port}")
        batch = ssf.Samples()
        batch.add(ssf.count("batched", 2.0), ssf.gauge("g", 1.0))
        assert trace.report_batch(client, batch, service="svc")
        assert not trace.report_batch(client, ssf.Samples())
        client.flush()
        assert _wait(lambda: srv.spans_received >= 1)
        _drain_and_flush(srv, sink)
        rows = {m.name: m.value for m in sink.all_metrics}
        assert rows["batched"] == 2.0 and rows["g"] == 1.0
        client.close()
    finally:
        srv.stop()


def test_status_sample_becomes_a_service_check_row():
    srv, sink = ssf_server(ssf_listen_addresses=["udp://127.0.0.1:0"])
    srv.start()
    try:
        port = srv._ssf_udp_sock.getsockname()[1]
        span = make_span()
        span.metrics.append(ssf.status("db.health", 2, {"shard": "a"},
                                       message="down"))
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as out:
            out.sendto(span.SerializeToString(), ("127.0.0.1", port))
        assert _wait(lambda: srv.spans_received >= 1)
        _drain_and_flush(srv, sink)
        rows = [m for m in sink.all_metrics if m.name == "db.health"]
        assert len(rows) == 1
        assert rows[0].type == MetricType.STATUS and rows[0].value == 2.0
        assert rows[0].message == "down" and rows[0].tags == ["shard:a"]
    finally:
        srv.stop()


def test_server_stop_closes_stream_conns():
    srv, _ = ssf_server(ssf_listen_addresses=["tcp://127.0.0.1:0"])
    srv.start()
    port = srv._listen_socks[0].getsockname()[1]
    conn = socket.create_connection(("127.0.0.1", port))
    try:
        conn.sendall(framing.write_ssf(make_span()))
        assert _wait(lambda: srv.spans_received >= 1)
        assert _wait(lambda: len(srv._stream_conns) == 1)
        (held, reader), = srv._stream_conns.items()
        t0 = time.monotonic()
        srv.stop()
        assert time.monotonic() - t0 < 10.0
        assert held.fileno() == -1 and not reader.is_alive()
    finally:
        conn.close()


def _binds_ipv6_loopback():
    try:
        with socket.socket(socket.AF_INET6, socket.SOCK_DGRAM) as s:
            s.bind(("::1", 0))
        return True
    except OSError:
        return False


@pytest.mark.skipif(not _binds_ipv6_loopback(),
                    reason="this host cannot bind ::1")
def test_ipv6_listeners():
    srv, sink = ssf_server(statsd_listen_addresses=["udp6://[::1]:0"],
                           ssf_listen_addresses=["udp6://[::1]:0",
                                                 "tcp6://[::1]:0"])
    srv.start()
    try:
        port = srv._sockets[0].getsockname()[1]
        with socket.socket(socket.AF_INET6, socket.SOCK_DGRAM) as out:
            out.sendto(b"v6.count:1|c", ("::1", port))
            out.sendto(make_span(n_samples=1).SerializeToString(),
                       ("::1", srv._ssf_udp_sock.getsockname()[1]))
        assert _wait(lambda: srv.packets_received >= 1
                     and srv.spans_received >= 1)
        assert srv._listen_socks[0].family == socket.AF_INET6
        # the self-trace client reaches the IPv6 SSF port too
        assert srv.trace_client is not None
        _drain_and_flush(srv, sink)
        rows = {m.name: m.value for m in sink.all_metrics}
        assert rows["v6.count"] == 1.0 and rows["sample.0"] == 1.0
    finally:
        srv.stop()


def test_span_sink_failure_is_logged_and_the_others_still_ingest():
    class Broken(tsm.SpanSink):
        def name(self):
            return "broken"

        def ingest(self, span):
            raise RuntimeError("boom")

    got = []
    srv = Server(Config(aggregation_backend="cpu", tpu_histogram_slots=256,
                        tpu_counter_slots=128, tpu_gauge_slots=128,
                        tpu_set_slots=64, tpu_batch_size=256),
                 span_sinks=[Broken(), tsm.SSFMetricsSink(got.append)])
    srv.start()
    try:
        srv.handle_ssf_span(make_span(n_samples=2))
        assert srv.drain()
        assert len(got) == 2 and srv.spans_received == 1
    finally:
        srv.stop()


# ---------------- the gate: reference and port servers ----------------

GATE_YAML = """
interval: "3600s"
ssf_listen_addresses: ["udp://127.0.0.1:0"]
indicator_span_timer_name: "gate.objective"
num_workers: 2
percentiles: [0.5, 0.99]
aggregates: ["min", "max", "count", "sum"]
hostname: testhost
tpu_histogram_slots: 512
tpu_counter_slots: 512
tpu_gauge_slots: 512
tpu_set_slots: 256
tpu_batch_size: 512
tpu_buffer_depth: 128
"""


def _gate_spans(rng, n, tag):
    """n spans, each with samples of every kind on a few dozen keys
    (timers in three units), every fifth an indicator span, one with a
    status sample."""
    out = []
    for i in range(n):
        start = T0 + i * 1000
        span = ssf_pb2.SSFSpan(
            version=0, trace_id=i + 1, id=i + 1, name="gate.op",
            service=("api", "db")[i % 2], start_timestamp=start,
            end_timestamp=start + int(rng.integers(1000, 10 ** 7)),
            indicator=(i % 5 == 0), error=(i % 15 == 0))
        k = int(rng.integers(0, 30))
        unit = (ssf.MILLISECOND, ssf.SECOND, ssf.MICROSECOND)[i % 3]
        span.metrics.extend([
            ssf.timing(f"gate.lat.{k}", float(rng.lognormal(-4, 1)), unit,
                       {"run": tag}, timestamp=T0),
            ssf.histogram(f"gate.size.{k % 10}", float(rng.gamma(2, 50)),
                          timestamp=T0),
            ssf.count(f"gate.hits.{k % 20}", float(rng.integers(1, 9)),
                      sample_rate=(0.5 if k % 2 else 1.0), timestamp=T0),
            ssf.gauge(f"gate.temp.{k % 15}", float(rng.normal(50, 10)),
                      timestamp=T0),
            ssf.set_sample(f"gate.users.{k % 10}",
                           f"u{int(rng.integers(0, 300))}", timestamp=T0)])
        if i == 7:
            span.metrics.append(ssf.status("gate.check", 1, {"run": tag},
                                           message=f"ok {tag}",
                                           timestamp=T0))
        out.append(span.SerializeToString())
    return out


def test_gate_ssf_spans_flush_the_reference_rows():
    jcap, tcap = JCapture(), CaptureMetricSink()
    jsrv = JServer(jread_config(text=GATE_YAML), sinks=[jcap])
    tsrv = Server(read_config(text=GATE_YAML + "aggregation_backend: cpu\n"),
                  sinks=[tcap])
    _clear_process_registries()
    jsrv.start()
    tsrv.start()
    try:
        assert jsrv.trace_client is not None
        assert tsrv.trace_client is not None
        rng = np.random.default_rng(3)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as out:
            for n, (tag, n_spans) in enumerate((("one", 300), ("two", 200),
                                                (None, 0)), start=1):
                if n > 1:
                    # the previous tick's self-traced spans arrive first
                    assert _wait(lambda: jsrv.spans_received > 0
                                 and tsrv.spans_received > 0)
                base = [jsrv.spans_received, tsrv.spans_received]
                dgrams = _gate_spans(rng, n_spans, tag) if tag else []
                for i in range(0, len(dgrams), 20):
                    for d in dgrams[i:i + 20]:
                        for srv in (jsrv, tsrv):
                            out.sendto(d, ("127.0.0.1", srv._ssf_udp_sock
                                           .getsockname()[1]))
                    sent = min(i + 20, len(dgrams))
                    assert _wait(lambda: all(
                        srv.spans_received - b >= sent
                        for srv, b in zip((jsrv, tsrv), base)))
                ts = 2000 + 10 * n
                jrows = _rows(_flush(jsrv, jcap, ts, n))
                trows = _rows(_flush(tsrv, tcap, ts, n))
                _compare(jrows, trows, n,
                         sets=("gate.users.",))
                if tag:
                    assert trows[("gate.check", ("run:" + tag,), 5)] \
                        .value == 1.0
                    assert any(k[0] == "gate.objective.count"
                               for k in trows)
                for name in EXACT_SELF + ("veneur.ssf.error_total",):
                    assert trows[(name, (), 0)].value == \
                        jrows[(name, (), 0)].value
    finally:
        jsrv.stop()
        tsrv.stop()
