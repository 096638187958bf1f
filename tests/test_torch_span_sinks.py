"""The port's network span sinks against the reference's (ROADMAP queue A
item 9b.2): Datadog APM, Splunk HEC, LightStep, X-Ray, Kafka and the
gRPC (falconer) sink.

Parity: the same SSF spans (made from a numpy seed) go through each
reference span sink and its port counterpart, each aimed at its own
capture endpoint, and what each sends is compared: the JSON bodies
(Datadog, Splunk, LightStep), the UDP segments (X-Ray), the producer's
(topic, key, value) triples (Kafka) and the spans the gRPC capture
received (falconer). SSF timestamps are fixed in the spans, so no time
field moves between the two runs. Then the reference's own flows
(tests/test_ssf.py's splunk, xray and grpc sinks, tests/test_telemetry's
Datadog span contract, tests/test_resilience.py's Datadog requeue and
tests/test_sinks_extra.py's kafka and lightstep span cases) run against
the port, and a port server with span sinks from the config takes SSF
spans over UDP and hands each sink every span. No reference Server
starts in this file.
"""

import json
import socket
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from veneur_tpu.sinks import datadog as jdatadog
from veneur_tpu.sinks import grpsink as jgrpsink
from veneur_tpu.sinks import kafka as jkafka
from veneur_tpu.sinks import lightstep as jlightstep
from veneur_tpu.sinks import splunk as jsplunk
from veneur_tpu.sinks import xray as jxray
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.resilience import (Egress, EgressPolicy,
                                         ResilienceRegistry, RetryPolicy)
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks import datadog as tdatadog
from veneur_tpu_torch.sinks import grpsink as tgrpsink
from veneur_tpu_torch.sinks import kafka as tkafka
from veneur_tpu_torch.sinks import lightstep as tlightstep
from veneur_tpu_torch.sinks import splunk as tsplunk
from veneur_tpu_torch.sinks import xray as txray
from veneur_tpu_torch.sinks.basic import CaptureMetricSink
from veneur_tpu_torch.sinks.datadog import DatadogSpanSink
from veneur_tpu_torch.sinks.grpsink import GrpcSpanSink, serve_capture
from veneur_tpu_torch.sinks.kafka import KafkaSpanSink
from veneur_tpu_torch.sinks.lightstep import LightStepSpanSink
from veneur_tpu_torch.sinks.splunk import SplunkSpanSink
from veneur_tpu_torch.sinks.xray import XRaySpanSink
from veneur_tpu_torch.ssf.protos import ssf_pb2
from veneur_tpu_torch.utils.faults import FakeClock, ScriptedTransport


class CaptureHTTP:
    """Loopback HTTP server recording (method, path, headers, body) of
    every POST and PUT."""

    def __init__(self):
        self.requests = []
        cap = self

        class Handler(BaseHTTPRequestHandler):
            def _handle(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if self.headers.get("Content-Encoding") == "deflate":
                    body = zlib.decompress(body)
                cap.requests.append((self.command, self.path,
                                     dict(self.headers), body))
                self.send_response(200)
                self.end_headers()

            do_POST = do_PUT = _handle

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def caps():
    made = []

    def make():
        c = CaptureHTTP()
        made.append(c)
        return c
    yield make
    for c in made:
        c.close()


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _spans(seed=0, n=24):
    """n spans over a few traces: roots and children, errors, indicator
    spans, tags, a span with no parent and a metric carrier with no ids
    (the Datadog sink skips it)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        start = int(1_700_000_000_000_000_000 + rng.integers(0, 10**9))
        s = ssf_pb2.SSFSpan(
            version=0, trace_id=int(rng.integers(1, 4)) * (1 << 40) + 7,
            id=1000 + i, parent_id=0 if i % 4 == 0 else 1000 + i - 1,
            start_timestamp=start,
            end_timestamp=start + int(rng.integers(0, 5 * 10**8)),
            name=f"op{i % 5}", service=f"svc{i % 3}",
            error=bool(i % 7 == 0), indicator=bool(i % 5 == 0))
        s.tags["env"] = "prod"
        s.tags[f"k{i % 3}"] = f"v{i}"
        out.append(s)
    out.append(ssf_pb2.SSFSpan(version=0))
    return out


# ------------------------------------------------------------ parity

def test_datadog_span_sink_sends_the_references_body(caps):
    sent = []
    for mod in (jdatadog, tdatadog):
        cap = caps()
        sink = mod.DatadogSpanSink(trace_api_address=cap.url)
        for s in _spans():
            sink.ingest(s)
        sink.flush()
        sent.append((sink.flushed_total,
                     [(m, p, json.loads(b)) for m, p, _h, b in
                      cap.requests]))
    assert sent[1] == sent[0]
    assert sent[1][0] == 24


def test_splunk_sends_the_references_body(caps):
    sent = []
    for mod in (jsplunk, tsplunk):
        cap = caps()
        sink = mod.SplunkSpanSink(cap.url, token="tok", hostname="h1")
        for s in _spans():
            sink.ingest(s)
        sink.flush()
        sent.append([(p, h["Authorization"],
                      [json.loads(ln) for ln in b.decode().split("\n")])
                     for _m, p, h, b in cap.requests])
    assert sent[1] == sent[0]
    assert len(sent[1][0][2]) == 25


def test_lightstep_sends_the_references_report(caps):
    sent = []
    for mod in (jlightstep, tlightstep):
        cap = caps()
        sink = mod.LightStepSpanSink("tok", collector_url=cap.url,
                                     hostname="vh")
        for s in _spans():
            sink.ingest(s)
        sink.flush()
        sent.append([(p, json.loads(b)) for _m, p, _h, b in cap.requests])
    assert sent[1] == sent[0]


def test_xray_sends_the_references_segments():
    sent = []
    for mod in (jxray, txray):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
            rx.bind(("127.0.0.1", 0))
            rx.settimeout(5.0)
            sink = mod.XRaySpanSink(f"127.0.0.1:{rx.getsockname()[1]}")
            spans = _spans()[:-1]
            for s in spans:
                sink.ingest(s)
            got = [rx.recvfrom(65536)[0] for _ in spans]
            sink.stop()
        sent.append(sorted(got))
    assert sent[1] == sent[0]


def test_kafka_span_sink_produces_the_references_messages():
    for encoding in ("protobuf", "json"):
        sent = []
        for mod in (jkafka, tkafka):
            produced = []
            sink = mod.KafkaSpanSink(
                "broker:9092", "spans", encoding=encoding,
                producer=lambda t, k, v, out=produced: out.append(
                    (t, k, v)))
            sink.start()
            for s in _spans():
                sink.ingest(s)
            sink.flush()
            sent.append(produced)
        assert sent[1] == sent[0]
        assert len(sent[1]) == 25


def test_grpc_span_sink_delivers_the_references_spans():
    sent = []
    for mod in (jgrpsink, tgrpsink):
        server, port, captured = mod.serve_capture()
        try:
            sink = mod.GrpcSpanSink(f"127.0.0.1:{port}")
            sink.start()
            spans = _spans()
            for s in spans:
                sink.ingest(s)
            assert _wait(lambda: sink.sent_total == len(spans))
            sink.stop()
            sent.append(sorted(c.SerializeToString() for c in captured))
        finally:
            server.stop(0)
    assert sent[1] == sent[0]
    assert len(sent[1]) == 25


# -------------------------------- the reference's flows, on the port

def make_span(**kw):
    defaults = dict(version=0, trace_id=7, id=8, parent_id=3,
                    start_timestamp=1_000_000_000,
                    end_timestamp=2_000_000_000, name="op", service="svc")
    defaults.update(kw)
    return ssf_pb2.SSFSpan(**defaults)


def test_splunk_span_sink(caps):
    cap = caps()
    sink = SplunkSpanSink(cap.url, token="tok", hostname="h1")
    sink.ingest(make_span())
    sink.ingest(make_span(name="op2"))
    sink.flush()
    assert sink.flushed_total == 2
    (_m, path, headers, body), = cap.requests
    assert path == "/services/collector/event"
    assert headers["Authorization"] == "Splunk tok"
    events = [json.loads(line) for line in body.decode().split("\n")]
    assert events[0]["host"] == "h1"
    assert [e["event"]["name"] for e in events] == ["op", "op2"]


def test_splunk_unreachable_collector_drops_counted():
    sink = SplunkSpanSink("http://127.0.0.1:1", token="t", timeout_s=0.2,
                          egress_policy=EgressPolicy(
                              retry=RetryPolicy(max_attempts=1)))
    sink.ingest(make_span())
    sink.flush()
    assert sink.dropped_total == 1 and sink.flushed_total == 0


def test_xray_span_sink():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as recv:
        recv.bind(("127.0.0.1", 0))
        recv.settimeout(5.0)
        sink = XRaySpanSink(f"127.0.0.1:{recv.getsockname()[1]}")
        span = make_span()
        span.parent_id = 5
        sink.ingest(span)
        data, _ = recv.recvfrom(65536)
        sink.stop()
    header, seg = data.split(b"\n", 1)
    assert json.loads(header) == {"format": "json", "version": 1}
    seg = json.loads(seg)
    assert seg["name"] == "svc" and seg["trace_id"].startswith("1-")
    assert seg["parent_id"] == f"{5:016x}" and seg["type"] == "subsegment"
    assert seg["annotations"]["span_name"] == "op"


def test_grpc_span_sink():
    server, port, captured = serve_capture()
    try:
        sink = GrpcSpanSink(f"127.0.0.1:{port}")
        sink.start()
        sink.ingest(make_span())
        assert _wait(lambda: sink.sent_total == 1)
        assert len(captured) == 1 and captured[0].name == "op"
        sink.stop()
    finally:
        server.stop(0)


def test_grpc_span_sink_to_a_dead_endpoint_drops_counted():
    sink = GrpcSpanSink("127.0.0.1:1", timeout_s=0.2,
                        egress_policy=EgressPolicy(
                            retry=RetryPolicy(max_attempts=1)))
    sink.start()
    sink.ingest(make_span())
    assert _wait(lambda: sink.dropped_total == 1)
    sink.stop()
    assert not sink._thread.is_alive()


def test_kafka_span_sink_protobuf_roundtrip():
    produced = []
    sink = KafkaSpanSink("broker:9092", "spans",
                         producer=lambda t, k, v: produced.append((t, k, v)))
    sink.start()
    sink.ingest(make_span())
    sink.flush()
    (topic, key, value), = produced
    assert topic == "spans" and key == b"7"
    got = ssf_pb2.SSFSpan.FromString(value)
    assert got.trace_id == 7 and got.name == "op"


def test_kafka_span_sink_json_and_buffer_cap():
    produced = []
    sink = KafkaSpanSink("b:9092", "spans", encoding="json",
                         producer=lambda t, k, v: produced.append(v),
                         max_buffer=2)
    for i in range(5):
        sink.ingest(make_span(error=i == 0))
    assert sink.dropped_total == 3
    sink.flush()
    body = json.loads(produced[0])
    assert body["trace_id"] == 7 and body["error"] is True
    with pytest.raises(ValueError):
        KafkaSpanSink("b", "t", encoding="avro")


def test_kafka_span_sink_without_client_drops_counted():
    sink = KafkaSpanSink("broker:9092", "spans")
    sink.start()
    assert sink.producer is None
    sink.ingest(make_span())
    sink.flush()
    assert sink.dropped_total == 1


def test_lightstep_report_shape(caps):
    cap = caps()
    sink = LightStepSpanSink("tok", collector_url=cap.url, hostname="vh")
    sink.ingest(make_span(tags={"k": "v"}))
    sink.flush()
    (_m, path, _h, body), = cap.requests
    assert path == "/api/v0/reports"
    rep = json.loads(body)
    assert rep["auth"]["access_token"] == "tok"
    rec, = rep["span_records"]
    assert (rec["trace_guid"], rec["span_guid"]) == ("7", "8")
    assert rec["oldest_micros"] == 1_000_000
    attrs = {a["Key"]: a["Value"] for a in rec["attributes"]}
    assert attrs["parent_span_guid"] == "3" and attrs["k"] == "v"
    assert sink.flushed_total == 1
    sink.flush()                      # nothing buffered: no second post
    assert len(cap.requests) == 1


def test_lightstep_unreachable_collector_drops_counted():
    sink = LightStepSpanSink("tok", collector_url="http://127.0.0.1:1",
                             timeout_s=0.2)
    sink.ingest(make_span())
    sink.flush()
    assert sink.dropped_total == 1


def _dd_span(trace_id=7, span_id=8, parent=0, name="op", error=False):
    s = ssf_pb2.SSFSpan(version=0, trace_id=trace_id, id=span_id,
                        parent_id=parent, name=name, service="svc",
                        start_timestamp=1_000_000,
                        end_timestamp=3_500_000, error=error)
    s.tags["env"] = "prod"
    return s


def test_datadog_span_sink_contract(caps):
    cap = caps()
    sink = DatadogSpanSink(trace_api_address=cap.url)
    sink.ingest(_dd_span(trace_id=7, span_id=1))
    sink.ingest(_dd_span(trace_id=7, span_id=2, parent=1, name="child"))
    sink.ingest(_dd_span(trace_id=9, span_id=3, error=True))
    sink.ingest(ssf_pb2.SSFSpan(version=0))   # a metric carrier: skipped
    sink.flush()
    assert sink.flushed_total == 3 and sink.dropped_total == 0
    method, path, _h, body = cap.requests[0]
    assert (method, path) == ("PUT", "/v0.3/traces")
    traces = json.loads(body)
    by_trace = {t[0]["trace_id"]: t for t in traces}
    t7 = sorted(by_trace[7], key=lambda d: d["span_id"])
    assert [d["span_id"] for d in t7] == [1, 2]
    assert t7[1]["parent_id"] == 1 and t7[0]["duration"] == 2_500_000
    assert t7[0]["meta"] == {"env": "prod"}
    assert by_trace[9][0]["error"] == 1
    sink.flush()
    assert len(cap.requests) == 1


class TestDatadogSpanRequeue:
    def make_span(self, i):
        return ssf_pb2.SSFSpan(version=0, trace_id=100 + i, id=1 + i,
                               start_timestamp=1_000_000_000 + i,
                               end_timestamp=2_000_000_000,
                               name=f"op{i}", service="svc")

    def make_sink(self, schedule, buffer_size=16384):
        clock = FakeClock()
        return DatadogSpanSink(
            trace_api_address="http://agent:8126",
            buffer_size=buffer_size,
            egress=Egress("dd-traces",
                          policy=EgressPolicy(retry=RetryPolicy(
                              max_attempts=1, deadline_s=8.0)),
                          transport=ScriptedTransport(schedule, clock),
                          clock=clock, sleep=clock.sleep,
                          registry=ResilienceRegistry()))

    def test_terminal_failure_drops_instead_of_poisoning_ring(self):
        sink = self.make_sink([400, "ok"])
        for i in range(4):
            sink.ingest(self.make_span(i))
        sink.flush()
        assert sink.dropped_total == 4 and sink.requeued_total == 0
        assert sink._spans == []

    def test_failed_flush_requeues_then_delivers(self):
        sink = self.make_sink([503, "ok"])
        for i in range(5):
            sink.ingest(self.make_span(i))
        sink.flush()
        assert sink.dropped_total == 0 and sink.requeued_total == 5
        sink.flush()
        assert sink.flushed_total == 5 and sink._spans == []

    def test_requeue_evicts_only_overflow(self):
        sink = self.make_sink([503], buffer_size=3)
        real_transport = sink._egress._transport

        def ingest_during_post(req, timeout=None):
            sink.ingest(self.make_span(97))
            sink.ingest(self.make_span(98))
            return real_transport(req, timeout=timeout)

        sink._egress._transport = ingest_during_post
        for i in range(3):
            sink.ingest(self.make_span(i))
        sink.flush()
        assert sink.requeued_total == 1 and sink.dropped_total == 2
        with sink._lock:
            kept = [s.name for s in sink._spans]
        assert kept == ["op2", "op97", "op98"]


# ------------------------------------------------ the port server

def test_server_hands_every_span_to_the_config_built_span_sinks(caps):
    """SSF spans over UDP reach every network span sink the config
    builds, after the ssfmetrics bridge, and the flush delivers them."""
    dd, splunk, ls = caps(), caps(), caps()
    grpc_server, gport, captured = serve_capture()
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    produced = []
    cfg = Config(aggregation_backend="cpu", hostname="h", interval="3600s",
                 statsd_listen_addresses=[],
                 ssf_listen_addresses=["udp://127.0.0.1:0"],
                 datadog_trace_api_address=dd.url,
                 splunk_hec_address=splunk.url, splunk_hec_token="tok",
                 lightstep_access_token="tok",
                 lightstep_collector_host=ls.url,
                 xray_address=f"127.0.0.1:{rx.getsockname()[1]}",
                 falconer_address=f"127.0.0.1:{gport}",
                 kafka_broker="b:9092", kafka_span_topic="spans",
                 tpu_histogram_slots=256, tpu_counter_slots=128,
                 tpu_gauge_slots=128, tpu_set_slots=64, tpu_batch_size=256)
    srv = Server(cfg, sinks=[CaptureMetricSink()], device="cpu")
    names = [s.name() for s in srv.span_sinks]
    assert names == ["ssfmetrics", "datadog", "splunk", "xray", "grpsink",
                     "kafka", "lightstep"]
    kafka = srv.span_sinks[5]
    kafka.producer = lambda t, k, v: produced.append((t, k, v))
    spans = [make_span(trace_id=50 + i, id=500 + i, name=f"s{i}")
             for i in range(20)]
    srv.start()
    try:
        port = srv._ssf_udp_sock.getsockname()[1]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for sp in spans:
                s.sendto(sp.SerializeToString(), ("127.0.0.1", port))
        assert _wait(lambda: srv.spans_received >= len(spans))
        assert srv.drain()
        segs = [rx.recvfrom(65536)[0] for _ in spans]
        srv.flush_once(timestamp=1)
        for t in list(srv._sink_inflight.values()):
            t.join(30)
        assert _wait(lambda: len(captured) >= len(spans))
    finally:
        srv.stop()
        grpc_server.stop(0)
        rx.close()
    # the server traces its own flush through its SSF port: those
    # veneur.* spans reach the sinks too
    def mine(names):
        return sorted(n for n in names if not n.startswith("veneur."))
    want = sorted(f"s{i}" for i in range(20))
    assert mine(json.loads(seg.split(b"\n", 1)[1])["annotations"][
        "span_name"] for seg in segs) == want
    assert mine(c.name for c in captured) == want
    assert mine(ssf_pb2.SSFSpan.FromString(v).name
                for _t, _k, v in produced) == want
    traces = json.loads(dd.requests[0][3])
    assert mine(d["name"] for t in traces for d in t) == want
    assert mine(json.loads(ln)["event"]["name"] for ln in
                splunk.requests[0][3].decode().split("\n")) == want
    assert mine(r["span_name"] for r in json.loads(
        ls.requests[0][3])["span_records"]) == want
