"""The port's network metric sinks, S3 plugin and sentry client against
the reference's (ROADMAP queue A item 9b.2).

Parity: the same InterMetrics (made from a numpy seed) go through each
reference sink and its port counterpart, each aimed at its own loopback
capture endpoint, and what each sends is compared: the Datadog bodies
zlib-decoded, the SignalFx and New Relic JSON bodies, the Kafka
producer's (topic, key, value) triples, the S3 object's gunzipped TSV
and key (time pinned), and the sentry event apart from its event_id and
timestamp. Then the reference's own flows (tests/test_sinks_extra.py,
tests/test_frames.py's Datadog frame flush, tests/test_telemetry.py's
per-sink self-metrics and sentry) run against the port, the port
server's three sentry captures (a failed flush, a failed forward once
per distinct error, the watchdog's crash-only exit), and a port server
and a reference server, each with a Datadog sink, fed the same
datagrams: equal row sets, with counters, gauges, counts, min and max
equal and the rest within the comparison contract. One reference Server
starts in this file; the port runs on the CPU.
"""

import gzip
import json
import os
import socket
import subprocess
import sys
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from veneur_tpu import metrics as jmetrics
from veneur_tpu.config import Config as JConfig
from veneur_tpu.ingest import parser as jparser
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks import datadog as jdatadog
from veneur_tpu.sinks import kafka as jkafka
from veneur_tpu.sinks import newrelic as jnewrelic
from veneur_tpu.sinks import s3 as js3
from veneur_tpu.sinks import signalfx as jsignalfx
from veneur_tpu.utils import sentry as jsentry
from veneur_tpu_torch import metrics as tmetrics
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.ingest import parser as tparser
from veneur_tpu_torch.metrics import InterMetric, MetricType
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks import datadog as tdatadog
from veneur_tpu_torch.sinks import kafka as tkafka
from veneur_tpu_torch.sinks import newrelic as tnewrelic
from veneur_tpu_torch.sinks import s3 as ts3
from veneur_tpu_torch.sinks import signalfx as tsignalfx
from veneur_tpu_torch.sinks.basic import (BlackholeMetricSink,
                                          CaptureMetricSink,
                                          tsv_from_frames, tsv_line)
from veneur_tpu_torch.sinks.kafka import KafkaMetricSink
from veneur_tpu_torch.sinks.newrelic import NewRelicMetricSink
from veneur_tpu_torch.sinks.s3 import S3Plugin, object_key
from veneur_tpu_torch.utils import sentry as tsentry

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class CaptureHTTP:
    """Loopback HTTP server recording (method, path, headers, body) of
    every POST and PUT, the body zlib-decoded when it says deflate."""

    def __init__(self, status=200):
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
                self.send_response(status)
                self.end_headers()
                self.wfile.write(b"{}")

            do_POST = do_PUT = _handle

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def wait(self, n, timeout=10.0):
        deadline = time.monotonic() + timeout
        while len(self.requests) < n and time.monotonic() < deadline:
            time.sleep(0.01)
        return len(self.requests) >= n

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def caps():
    made = []

    def make(status=200):
        c = CaptureHTTP(status)
        made.append(c)
        return c
    yield make
    for c in made:
        c.close()


def _metrics(mod, seed=0, n=40):
    """n InterMetrics of each kind the flush makes (gauges, counters,
    status rows), with host:/device: magic tags among them."""
    rng = np.random.default_rng(seed)
    T = mod.MetricType
    out = []
    for i in range(n):
        tags = [f"shard:{i % 3}", f"env:{'prod' if i % 2 else 'dev'}"]
        if i % 7 == 0:
            tags.append("host:other")
        if i % 11 == 0:
            tags.append("device:sda")
        if i % 5 == 0:
            tags.append(f"team:{'db' if i % 10 == 0 else 'web'}")
        kind = (T.COUNTER, T.GAUGE, T.GAUGE, T.STATUS)[i % 4]
        value = (float(rng.integers(0, 4)) if kind == T.STATUS
                 else float(np.round(rng.lognormal(2, 1), 4)))
        out.append(mod.InterMetric(
            name=f"m.{i}", timestamp=1_700_000_000 + i % 3, value=value,
            tags=tags, type=kind, hostname="h" if i % 6 else "",
            message="ok" if kind == T.STATUS else ""))
    return out


def _events_checks(pmod):
    evs = [pmod.Event(title=f"deploy {i}", text="v2", timestamp=5 + i,
                      hostname="h", aggregation_key="k", priority="low",
                      source_type="chef", alert_type="error",
                      tags=["a:b"]) for i in range(3)]
    cks = [pmod.ServiceCheck(name=f"db{i}", status=i % 3, timestamp=9,
                             hostname="h", tags=["x:y"], message="down")
           for i in range(3)]
    return evs, cks


def _bodies(cap):
    return [(m, p, json.loads(b)) for m, p, _h, b in cap.requests]


# ------------------------------------------------------------ parity

def test_datadog_metric_sink_sends_the_references_bodies(caps):
    sent = []
    for sink_mod, met, pmod in ((jdatadog, jmetrics, jparser),
                                (tdatadog, tmetrics, tparser)):
        cap = caps()
        sink = sink_mod.DatadogMetricSink(
            api_key="key", api_url=cap.url, hostname="fallback",
            tags=["base:tag"], interval_s=10, flush_max_per_body=7)
        sink.flush(_metrics(met))
        sink.flush_other(*_events_checks(pmod))
        sent.append([(m, p, h["Content-Encoding"], b)
                     for m, p, h, b in cap.requests])
    ref, port = sent
    assert port == ref
    paths = [p for _m, p, _e, _b in port]
    assert paths.count("/api/v1/series?api_key=key") == 5   # 30 / 7
    assert paths.count("/api/v1/check_run?api_key=key") == 13
    assert paths.count("/api/v1/events?api_key=key") == 3


def test_datadog_frame_flush_sends_the_references_bodies(caps):
    sent = []
    for sink_mod, met in ((jdatadog, jmetrics), (tdatadog, tmetrics)):
        cap = caps()
        sink = sink_mod.DatadogMetricSink(
            api_key="k", api_url=cap.url, hostname="fallback",
            tags=["base:tag"], interval_s=10, flush_max_per_body=4)
        n = sink.flush_frames(_frameset(met))
        sent.append((n, _bodies(cap)))
    assert sent[1] == sent[0]


def test_signalfx_sends_the_references_bodies(caps):
    sent = []
    for sink_mod, met in ((jsignalfx, jmetrics), (tsignalfx, tmetrics)):
        cap = caps()
        sink = sink_mod.SignalFxMetricSink(
            api_key="default-token", endpoint=cap.url, hostname="h",
            tags=["global:yes"], vary_key_by="team",
            per_tag_keys={"db": "db-token"})
        sink.flush(_metrics(met))
        sent.append(sorted((p, h["X-Sf-Token"], b)
                           for _m, p, h, b in cap.requests))
    assert sent[1] == sent[0]
    assert [t for _p, t, _b in sent[1]] == ["db-token", "default-token"]


def test_newrelic_sends_the_references_bodies(caps):
    sent = []
    for sink_mod, met, pmod in ((jnewrelic, jmetrics, jparser),
                                (tnewrelic, tmetrics, tparser)):
        cap = caps()
        sink = sink_mod.NewRelicMetricSink(
            "key", account_id=42, metric_url=cap.url, event_url=cap.url,
            tags=["env:prod"], interval_s=10)
        sink.flush(_metrics(met))
        sink.flush_other(*_events_checks(pmod))
        sent.append((sink.flushed_total,
                     [(p, h["Api-Key"], json.loads(b))
                      for _m, p, h, b in cap.requests]))
    assert sent[1] == sent[0]
    assert sent[1][0] == 30


def test_kafka_metric_sink_produces_the_references_messages():
    sent = []
    for sink_mod, met in ((jkafka, jmetrics), (tkafka, tmetrics)):
        produced = []
        sink = sink_mod.KafkaMetricSink(
            "broker:9092", "metrics",
            producer=lambda t, k, v, out=produced: out.append((t, k, v)))
        sink.start()
        sink.flush(_metrics(met))
        sent.append(produced)
    assert sent[1] == sent[0]
    assert len(sent[1]) == 30          # the status rows are skipped


def test_s3_uploads_the_references_object(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_785_000_000.5)
    sent = []
    for mod, met in ((js3, jmetrics), (ts3, tmetrics)):
        uploads = []
        plugin = mod.S3Plugin("bkt", interval_s=10,
                              uploader=lambda b, k, v, out=uploads:
                              out.append((b, k, gzip.decompress(v))))
        plugin.flush(_metrics(met), "host1")
        plugin.flush_frames(_frameset(met), "host1")
        sent.append((uploads, plugin.uploaded_total))
    assert sent[1] == sent[0]
    (b, key, tsv), _ = sent[1][0]
    assert key == "host1/2026/07/25/veneur-1785000000.tsv.gz"


def _boom():
    try:
        raise RuntimeError("boom")
    except RuntimeError as e:
        return e


def test_sentry_sends_the_references_event(caps):
    exc = _boom()
    sent = []
    for mod in (jsentry, tsentry):
        cap = caps()
        c = mod.SentryClient(f"{cap.url.replace('http://', 'http://key@')}"
                             f"/42")
        c.capture(exc, "it broke", wait=True)
        c.capture(None, "bare", wait=True)
        assert c.sent == 2 and c.dropped == 0
        out = []
        for _m, path, h, body in cap.requests:
            ev = json.loads(body)
            assert len(ev.pop("event_id")) == 32
            time.strptime(ev.pop("timestamp"), "%Y-%m-%dT%H:%M:%S")
            out.append((path, h["X-Sentry-Auth"], ev))
        sent.append(sorted(out, key=lambda r: r[2]["message"]))
    assert sent[1] == sent[0]


# -------------------------------- the reference's flows, on the port

def im(name, value, mtype=MetricType.GAUGE, tags=(), host="h"):
    return InterMetric(name=name, timestamp=1000, value=value,
                       tags=list(tags), type=mtype, hostname=host)


class TestKafka:
    def test_metric_sink_produces_json(self):
        produced = []
        sink = KafkaMetricSink(
            "broker:9092", "metrics",
            producer=lambda t, k, v: produced.append((t, k, v)))
        sink.start()
        sink.flush([im("a.b", 1.5, tags=["x:1"]),
                    im("c", 2, MetricType.COUNTER)])
        assert len(produced) == 2
        topic, key, value = produced[0]
        assert topic == "metrics"
        assert key == b"a.b|x:1"
        assert json.loads(value) == {
            "name": "a.b", "timestamp": 1000, "value": 1.5,
            "tags": ["x:1"], "type": "gauge", "hostname": "h"}
        assert json.loads(produced[1][2])["type"] == "counter"

    def test_metric_sink_without_client_drops_counted(self):
        sink = KafkaMetricSink("broker:9092", "metrics")
        sink.start()        # no kafka library: the producer stays None
        assert sink.producer is None
        sink.flush([im("a", 1), im("b", 2)])
        assert sink.dropped_total == 2


class TestNewRelic:
    def test_metric_payload(self, caps):
        cap = caps()
        sink = NewRelicMetricSink("key", account_id=42,
                                  metric_url=cap.url, event_url=cap.url,
                                  tags=["env:prod"], interval_s=10)
        sink.flush([im("lat.p50", 3.5, tags=["svc:web"]),
                    im("hits", 7, MetricType.COUNTER)])
        (_m, path, headers, body), = cap.requests
        assert path == "/metric/v1"
        assert headers["Api-Key"] == "key"
        (block,) = json.loads(body)
        g, c = block["metrics"]
        assert g == {"name": "lat.p50", "value": 3.5, "timestamp": 1000,
                     "type": "gauge",
                     "attributes": {"env": "prod", "svc": "web",
                                    "hostname": "h"}}
        assert c["type"] == "count" and c["interval.ms"] == 10000
        assert sink.flushed_total == 2

    def test_events(self, caps):
        cap = caps()
        sink = NewRelicMetricSink("key", account_id=42,
                                  metric_url=cap.url, event_url=cap.url)
        sink.flush_other(
            [tparser.Event(title="deploy", text="v2", timestamp=5)],
            [tparser.ServiceCheck(name="db", status=2, message="down")])
        (_m, path, _h, body), = cap.requests
        assert path == "/v1/accounts/42/events"
        ev, chk = json.loads(body)
        assert ev["eventType"] == "VeneurEvent" and ev["title"] == "deploy"
        assert chk["eventType"] == "VeneurServiceCheck"
        assert chk["status"] == 2

    def test_events_without_account_id_are_dropped(self, caps):
        cap = caps()
        sink = NewRelicMetricSink("key", metric_url=cap.url,
                                  event_url=cap.url)
        sink.flush_other([tparser.Event(title="t", text="x")], [])
        assert cap.requests == []


class TestS3:
    def test_uploads_gzipped_tsv(self):
        uploads = []
        plugin = S3Plugin("bkt", interval_s=10,
                          uploader=lambda b, k, v: uploads.append(
                              (b, k, v)))
        plugin.flush([im("a.b", 1.5, tags=["x:1"])], "host1")
        (bucket, key, body), = uploads
        assert bucket == "bkt"
        assert key.startswith("host1/") and key.endswith(".tsv.gz")
        rows = gzip.decompress(body).decode().splitlines()
        assert rows == ["a.b\tx:1\tgauge\th\t1000\t1.5\t10"]
        assert plugin.uploaded_total == 1

    def test_no_uploader_drops_counted(self):
        plugin = S3Plugin("bkt")          # no boto3: no uploader
        assert plugin.uploader is None
        plugin.flush([im("a", 1)], "host1")
        assert plugin.dropped_total == 1

    def test_failed_upload_counted_not_raised(self):
        def boom(b, k, v):
            raise RuntimeError("nope")
        plugin = S3Plugin("bkt", uploader=boom)
        plugin.flush([im("a", 1)], "h")
        assert plugin.dropped_total == 1

    def test_object_key_layout(self):
        key = object_key("web-1", ts=time.mktime(
            (2026, 7, 29, 12, 0, 0, 0, 0, 0)))
        assert key.startswith("web-1/2026/") and key.endswith(".tsv.gz")


class TestSignalFx:
    def _make(self, caps, **kw):
        cap = caps()
        sink = tsignalfx.SignalFxMetricSink(
            api_key="default-token", endpoint=cap.url, hostname="h",
            tags=["global:yes"], **kw)
        return sink, cap

    @staticmethod
    def _posts(cap):
        return [(h["X-Sf-Token"], json.loads(b))
                for _m, _p, h, b in cap.requests]

    def test_datapoints_and_dimensions(self, caps):
        sink, cap = self._make(caps)
        sink.flush([im("req.count", 6, MetricType.COUNTER,
                       tags=["svc:web"]),
                    im("cpu", 0.5, MetricType.GAUGE)])
        (token, body), = self._posts(cap)
        assert token == "default-token"
        cnt, = body["counter"]
        assert cnt["metric"] == "req.count" and cnt["value"] == 6
        assert cnt["dimensions"] == {"host": "h", "global": "yes",
                                     "svc": "web"}
        g, = body["gauge"]
        assert g["metric"] == "cpu" and g["timestamp"] == 1000 * 1000

    def test_vary_key_by_routes_tokens(self, caps):
        sink, cap = self._make(caps, vary_key_by="team",
                               per_tag_keys={"db": "db-token"})
        sink.flush([im("a", 1, tags=["team:db"]),
                    im("b", 2, tags=["team:web"]), im("c", 3)])
        posts = self._posts(cap)
        assert sorted(t for t, _ in posts) == ["db-token", "default-token"]
        by_token = dict(posts)
        assert [d["metric"] for d in by_token["db-token"]["gauge"]] == ["a"]
        assert sorted(d["metric"] for d in
                      by_token["default-token"]["gauge"]) == ["b", "c"]

    def test_status_metrics_skipped(self, caps):
        sink, cap = self._make(caps)
        sink.flush([im("svc.check", 2, MetricType.STATUS)])
        assert cap.requests == []


class TestConfigWiring:
    def test_server_builds_new_sinks(self, tmp_path):
        cfg = Config(statsd_listen_addresses=[], interval="10s",
                     hostname="h", kafka_broker="b:9092",
                     kafka_metric_topic="m", kafka_span_topic="s",
                     newrelic_insert_key="k", newrelic_account_id=1,
                     lightstep_access_token="tok",
                     prometheus_repeater_address="127.0.0.1:0",
                     aws_s3_bucket="bkt",
                     flush_file=str(tmp_path / "x.tsv"),
                     tpu_histogram_slots=256, tpu_counter_slots=128,
                     tpu_gauge_slots=128, tpu_set_slots=64)
        srv = Server(cfg, device="cpu")
        names = sorted(s.name() for s in srv.sinks)
        assert names == ["kafka", "newrelic", "prometheus"]
        assert sorted(s.name() for s in srv.span_sinks) == [
            "kafka", "lightstep", "ssfmetrics"]
        assert sorted(p.name() for p in srv.plugins) == ["localfile", "s3"]


# ---------------------------------------- tests/test_frames.py's flush

def _frameset(met):
    """A frameset of every block shape: multi-column histogram blocks
    (shared tags, mixed gauge and counter columns), single-column scalar
    blocks, host:/device: magic tags, a loose self-metric and a status
    row."""
    T = met.MetricType
    fr = met.MetricFrame(1234, "host-a")
    tags_web = ["env:prod", "svc:web"]
    tags_magic = ["device:sda", "env:prod", "host:other-host"]
    fr.add_block(
        [("api.ms.50percentile", "api.ms.99percentile", "api.ms.count"),
         ("db.ms.50percentile", "db.ms.99percentile", "db.ms.count")],
        [tags_web, tags_magic],
        np.array([[10.5, 99.25, 400.0], [1.5, 9.75, 20.0]]),
        (T.GAUGE, T.GAUGE, T.COUNTER))
    fr.add_block(["hits", "misses"], [tags_web, []], np.array([30.0, 7.0]),
                 (T.COUNTER,))
    fr.add_block(["load"], [["role:db"]], np.array([0.75]), (T.GAUGE,))
    extra = [met.InterMetric(name="veneur.flush.total_duration_ns",
                             timestamp=1234, value=5e6, tags=[],
                             type=T.GAUGE, hostname="host-a"),
             met.InterMetric(name="svc.up", timestamp=1234, value=1.0,
                             tags=["a:b"], type=T.STATUS, message="ok")]
    return met.FrameSet([fr], extra)


def test_tsv_from_frames_byte_identical():
    fs = _frameset(tmetrics)
    legacy = "".join(tsv_line(m, "host-a", 10) for m in fs.to_list())
    assert "".join(tsv_from_frames(fs, "host-a", 10)) == legacy


def test_datadog_frame_flush_byte_identical():
    def make(bodies):
        sink = tdatadog.DatadogMetricSink(
            api_key="k", api_url="http://x", hostname="fallback",
            tags=["base:tag"], interval_s=10)
        sink._post = lambda path, body, deadline=None: bodies.append(
            (path, body))
        return sink

    fs = _frameset(tmetrics)
    legacy_bodies, native_bodies = [], []
    make(legacy_bodies).flush(fs.to_list())
    make(native_bodies).flush_frames(fs)
    assert native_bodies == legacy_bodies
    by_name = {}
    for s in native_bodies[0][1]["series"]:
        by_name.setdefault(s["metric"], s)
    assert by_name["api.ms.count"]["type"] == "rate"
    assert by_name["api.ms.count"]["points"][0][1] == 40.0
    assert by_name["db.ms.50percentile"]["host"] == "other-host"
    assert by_name["db.ms.50percentile"]["device_name"] == "sda"
    assert by_name["load"]["tags"] == ["base:tag", "role:db"]
    assert by_name["hits"]["host"] == "host-a"
    assert native_bodies[-1][0] == "/api/v1/check_run"


def test_datadog_chunking_matches():
    fs = _frameset(tmetrics)

    def make(bodies):
        sink = tdatadog.DatadogMetricSink(
            api_key="k", api_url="http://x", hostname="h", interval_s=10,
            flush_max_per_body=4)
        sink._post = lambda path, body, deadline=None: bodies.append(
            len(body.get("series", ())))
        return sink

    a, b = [], []
    make(a).flush(fs.to_list())
    make(b).flush_frames(fs)
    assert a == b and sum(a) == len(fs) - 1     # the status row: a check


def test_blackhole_counts_without_materializing():
    fs = _frameset(tmetrics)
    sink = BlackholeMetricSink()
    sink.flush_frames(fs)
    assert sink.flushed_total == len(fs) == 11
    assert fs.frames[0]._list is None


# ------------------------------------------------ the port server

def _small(**kw):
    return Config(aggregation_backend="cpu", hostname="h",
                  interval="3600s", tpu_histogram_slots=256,
                  tpu_counter_slots=128, tpu_gauge_slots=128,
                  tpu_set_slots=64, tpu_batch_size=256, **kw)


def test_per_sink_self_metrics_name_the_network_sink(caps):
    """tests/test_telemetry.py's per-sink self-metrics, with a Datadog
    sink built from the config beside a capture sink: flush 2 reports
    flush 1's rows of each sink under its own tag."""
    cap = caps()
    capture = CaptureMetricSink()
    srv = Server(_small(datadog_api_key="k", datadog_api_hostname=cap.url))
    srv.sinks.append(capture)
    srv.start()
    try:
        srv.handle_packet(b"a.b:1|c")
        assert srv.drain()
        srv.flush_once(timestamp=1)
        assert capture.wait_for_flush(1)
        for t in list(srv._sink_inflight.values()):
            t.join(10)
        srv.flush_once(timestamp=2)
        assert capture.wait_for_flush(2)
        names = {(m.name, tuple(m.tags)): m.value
                 for m in capture.flushes[1]}
        for sink in ("datadog", "capture"):
            key = ("veneur.sink.metrics_flushed_total", (f"sink:{sink}",))
            assert names[key] == len(capture.flushes[0])
            assert ("veneur.sink.flush_duration_ns",
                    (f"sink:{sink}",)) in names
        assert names[("veneur.sink.flush_errors_total",
                      ("sink:datadog",))] == 0
    finally:
        srv.stop()
    series = [s for _m, p, _h, b in cap.requests
              if p.startswith("/api/v1/series")
              for s in json.loads(b)["series"]]
    assert {(s["metric"], s["type"]) for s in series} >= {("a.b", "rate")}


def test_flush_failure_reaches_sentry(caps):
    cap = caps()
    srv = Server(_small(sentry_dsn=f"http://key@{cap.url[7:]}/42",
                        statsd_listen_addresses=[]))
    srv.cfg.interval = "0.05s"
    assert srv.cfg.interval_seconds == 0.05

    def boom(timestamp=None):
        raise RuntimeError("flush wedged")
    srv.flush_once = boom
    srv._spawn(srv._flush_loop, "flusher")
    try:
        assert cap.wait(1)
    finally:
        srv.stop()
    ev = json.loads(cap.requests[0][3])
    assert ev["message"] == "flush failed"
    assert ev["exception"]["values"][0]["value"] == "flush wedged"


def test_forward_failures_reach_sentry_once_per_distinct_error(caps):
    """A forward to a closed port fails the same way every tick: one
    event for three ticks (the reference's _last_forward_err dedupe);
    a different failure makes another, and a success resets it."""
    cap = caps()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    srv = Server(_small(sentry_dsn=f"http://key@{cap.url[7:]}/42",
                        statsd_listen_addresses=[],
                        forward_address=f"http://127.0.0.1:{closed}",
                        forward_use_grpc=False, retry_max_attempts=1))
    srv.start()
    outcomes = iter([ConnectionError("timed out"), None,
                     ConnectionError("timed out")])

    def scripted(export):
        e = next(outcomes)
        if e is not None:
            raise e
    try:
        for ts in range(1, 7):
            if ts == 4:
                srv.forwarder = scripted
            srv.handle_packet(b"g.c:1|c|#veneurglobalonly")
            assert srv.drain()
            srv.flush_once(timestamp=ts)
        assert cap.wait(3)
        time.sleep(0.2)
    finally:
        srv.stop()
    events = [json.loads(b) for _m, _p, _h, b in cap.requests]
    assert [e["message"] for e in events] == ["forward failed"] * 3
    values = [e["exception"]["values"][0]["value"] for e in events]
    assert "Connection refused" in values[0]
    assert sorted(values[1:]) == ["timed out", "timed out"]


_WATCHDOG = r"""
import sys, time
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.server import Server
cfg = Config(aggregation_backend="cpu", interval="0.2s", hostname="wd",
             flush_watchdog_missed_flushes=3, statsd_listen_addresses=[],
             sentry_dsn=sys.argv[1], tpu_histogram_slots=64,
             tpu_counter_slots=32, tpu_gauge_slots=32, tpu_set_slots=16,
             tpu_batch_size=64, tpu_buffer_depth=32)
srv = Server(cfg, sinks=[], plugins=[], span_sinks=[])
srv.flush_once = lambda *a, **k: time.sleep(3600)
srv.start()
print("started", flush=True)
time.sleep(60)
raise SystemExit(7)
"""


def test_watchdog_exit_reaches_sentry_before_the_process_dies(caps):
    cap = caps()
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _WATCHDOG, f"http://key@{cap.url[7:]}/42"],
        cwd=_REPO, env=env, capture_output=True, timeout=120, text=True)
    assert "started" in proc.stdout
    assert proc.returncode == 2, (proc.returncode, proc.stderr[-800:])
    ev, = [json.loads(b) for _m, _p, _h, b in cap.requests]
    assert ev["message"] == "flush watchdog expired; crash-only exit"
    assert "exception" not in ev


# ------------------- a port and a reference server, each with Datadog

_DD_KW = dict(interval="3600s", hostname="h", num_workers=1,
              percentiles=[0.5, 0.99], aggregates=["min", "max", "count"],
              statsd_listen_addresses=["udp://127.0.0.1:0"],
              datadog_flush_max_per_body=50,
              tpu_histogram_slots=256, tpu_counter_slots=128,
              tpu_gauge_slots=128, tpu_set_slots=64, tpu_batch_size=256,
              tpu_buffer_depth=128)


def _dd_lines(seed=3):
    rng = np.random.default_rng(seed)
    lines = []
    for k in range(12):
        lines += [f"dd.lat{k}:{v:.4f}|ms|#k:{k % 3}"
                  for v in rng.lognormal(2, 0.7, 40)]
    for k in range(20):
        lines += [f"dd.hits{k}:{int(rng.integers(1, 50))}|c"
                  for _ in range(3)]
        lines.append(f"dd.temp{k}:{rng.normal(20, 4):.3f}|g")
    for k in range(5):
        lines += [f"dd.users{k}:u{m}|s" for m in range(
            int(rng.integers(5, 60)))]
    lines.append("_sc|dd.check|1|#run:1|m:ok")
    return [ln.encode() for ln in rng.permutation(lines)]


def _dd_rows(cap):
    rows = {}
    for _m, path, _h, body in cap.requests:
        if path.startswith("/api/v1/series"):
            for s in json.loads(body)["series"]:
                if not s["metric"].startswith("veneur."):
                    key = (s["metric"], tuple(s["tags"]), s["type"],
                           s["host"])
                    assert key not in rows
                    rows[key] = s["points"][0][1]
        elif path.startswith("/api/v1/check_run"):
            b = json.loads(body)
            rows[(b["check"], tuple(b["tags"]), "check", "")] = b["status"]
    return rows


def _run_dd_server(server_cls, config_cls, url, lines, **kw):
    srv = server_cls(config_cls(datadog_api_key="key",
                                datadog_api_hostname=url, **_DD_KW), **kw)
    srv.start()
    try:
        port = srv.bound_port()
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for i in range(0, len(lines), 20):
                s.sendto(b"\n".join(lines[i:i + 20]), ("127.0.0.1", port))
        n = -(-len(lines) // 20)
        deadline = time.monotonic() + 30
        while srv.packets_received < n and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.packets_received == n
        assert srv.drain(30)
        srv.flush_once(timestamp=1_700_000_000)
        for t in list(srv._sink_inflight.values()):
            t.join(30)
    finally:
        srv.stop()


def test_port_and_reference_servers_send_datadog_equal_rows(caps):
    lines = _dd_lines()
    jcap, tcap = caps(), caps()
    _run_dd_server(JServer, JConfig, jcap.url, lines, plugins=[])
    _run_dd_server(Server, Config, tcap.url, lines, device="cpu")
    ref, port = _dd_rows(jcap), _dd_rows(tcap)
    assert set(port) == set(ref)
    # 12 timers x (2 percentiles + min, max, count), 20 counters, 20
    # gauges, 5 sets and the service check
    assert len(port) == 12 * 5 + 20 + 20 + 5 + 1
    for key, want in ref.items():
        got = port[key]
        name, tags, kind, host = key
        if ".users" in name:
            assert got == pytest.approx(want, rel=1e-5), key
        elif "percentile" in name:
            base = name.rsplit(".", 1)[0]
            spread = (ref[(base + ".max", tags, "gauge", host)]
                      - ref[(base + ".min", tags, "gauge", host)])
            assert abs(got - want) <= 0.01 * spread, key
        else:
            assert got == want, key
