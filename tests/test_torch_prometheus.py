"""The port's Prometheus sink and the veneur-prometheus repeater against
the reference's (ROADMAP queue A item 9b.2).

Parity: the same InterMetrics and telemetry registries (made from a
numpy seed) through both packages' render, render_registries, the
counter totals under series churn and the scrape endpoint give the same
exposition text; the same exposition through both repeaters'
parse_exposition and to_statsd_lines over several polls gives the same
statsd lines. Then the reference's own flows (tests/test_sinks_extra.py
TestPrometheus, tests/test_observe.py's unified scrape surface and the
repeater's self-metrics, tests/test_cli.py's repeater) run against the
port, and `python3 -m veneur_tpu_torch.cli.prometheus` relays a scrape
to a UDP socket. No reference Server starts in this file.
"""

import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from veneur_tpu import metrics as jmetrics
from veneur_tpu import observe as jobserve
from veneur_tpu.cli import prometheus as jprom_cli
from veneur_tpu.sinks import prometheus as jprom
from veneur_tpu_torch import metrics as tmetrics
from veneur_tpu_torch import observe as tobserve
from veneur_tpu_torch.cli import prometheus as prom_cli
from veneur_tpu_torch.metrics import InterMetric, MetricType
from veneur_tpu_torch.observe import SERVER_SCOPE, TelemetryRegistry
from veneur_tpu_torch.sinks import prometheus as tprom
from veneur_tpu_torch.sinks.prometheus import PrometheusMetricSink, render

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _metrics(mod, seed, n=60):
    """Gauges, counters and a status row with tags that need
    sanitizing and escaping; counter keys repeat across seeds so the
    cumulative totals accumulate."""
    rng = np.random.default_rng(seed)
    T = mod.MetricType
    out = []
    for i in range(n):
        kind = (T.COUNTER, T.GAUGE, T.COUNTER, T.STATUS)[i % 4]
        tags = [f"svc:web {i % 3}", f"a.b-{i % 2}:q\"{i % 5}\\n"]
        out.append(mod.InterMetric(
            name=f"api.req-time.{i % 17}" if i % 3 else f"9lives.{i}",
            timestamp=1000, value=float(np.round(rng.lognormal(1, 1), 3)),
            tags=tags, type=kind, hostname="h" if i % 2 else ""))
    return out


def test_render_is_the_references():
    for seed in range(3):
        j = jprom.render(_metrics(jmetrics, seed))
        assert render(_metrics(tmetrics, seed)) == j
    jt, tt = {}, {}
    for seed in range(4):
        j = jprom.render(_metrics(jmetrics, seed), jt)
        assert render(_metrics(tmetrics, seed), tt) == j
    assert tt == jt


def test_counter_totals_under_churn_are_the_references():
    jt, tt = jprom._TtlCounterTotals(5), tprom._TtlCounterTotals(5)
    for i in range(40):
        batch = [("churn", i), ("steady", 2)]
        for totals, mod, met in ((jt, jprom, jmetrics),
                                 (tt, tprom, tmetrics)):
            mod.render([met.InterMetric(
                name=f"{k}.{v}" if k == "churn" else k, timestamp=1,
                value=1.0 if k == "churn" else v,
                type=met.MetricType.COUNTER) for k, v in batch], totals)
            totals.advance()
        assert dict(tt) == dict(jt) and tt._last_seen == jt._last_seen


def _registry(obs, seed):
    rng = np.random.default_rng(seed)
    reg = obs.TelemetryRegistry()
    for i in range(8):
        reg.incr(f"dest-{i % 3}", "attempts", int(rng.integers(1, 9)))
        reg.incr(obs.SERVER_SCOPE, "packet.received",
                 int(rng.integers(1, 99)))
        reg.set_gauge(f"sink:s{i % 2}", "sink.flush_duration_ns",
                      float(rng.integers(1, 10**6)))
    reg.incr_level(obs.SERVER_SCOPE, "flush.count", 3)
    return reg


def test_render_registries_is_the_references(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    regs_j = (_registry(jobserve, 1), _registry(jobserve, 2))
    regs_t = (_registry(tobserve, 1), _registry(tobserve, 2))
    for exclude in (frozenset(), frozenset({"veneur_flush_count"})):
        assert tprom.render_registries(regs_t, exclude) == \
            jprom.render_registries(regs_j, exclude)


def _scrape(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=5) as resp:
        return resp.headers["Content-Type"], resp.read().decode()


def test_scrape_endpoint_serves_the_references_body(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    bodies = []
    for mod, met, obs in ((jprom, jmetrics, jobserve),
                          (tprom, tmetrics, tobserve)):
        sink = mod.PrometheusMetricSink(
            "127.0.0.1:0", registries=(_registry(obs, 5),))
        sink.start()
        try:
            got = []
            for seed in range(3):
                sink.flush(_metrics(met, seed))
                got.append(_scrape(sink.port))
            bodies.append(got)
        finally:
            sink.stop()
    assert bodies[1] == bodies[0]
    assert bodies[1][0][0] == "text/plain; version=0.0.4"


EXPO_1 = """\
# HELP http_requests_total Total requests.
# TYPE http_requests_total counter
http_requests_total{code="200",method="get"} 100
http_requests_total{code="500",method="get"} 3
# TYPE temp_celsius gauge
temp_celsius 21.5
# TYPE req_latency histogram
req_latency_bucket{le="0.1"} 50
req_latency_bucket{le="+Inf"} 60
req_latency_sum 12.5
req_latency_count 60
untyped_series 7
errs{path="/a}b",x="q\\"z"} 3 1700000000
# TYPE req summary
req{quantile="0.5"} 2
req_sum 10
req_count 4
bad line here
"""

EXPO_2 = EXPO_1.replace(
    'http_requests_total{code="200",method="get"} 100',
    'http_requests_total{code="200",method="get"} 140').replace(
    "temp_celsius 21.5", "temp_celsius 19.0").replace(
    'req_latency_bucket{le="+Inf"} 60', 'req_latency_bucket{le="+Inf"} 75')

EXPO_3 = EXPO_2.replace(
    'http_requests_total{code="500",method="get"} 3',
    'http_requests_total{code="500",method="get"} 1').replace(
    "req_sum 10", "req_sum 17.25").replace("req_count 4", "req_count 9")


def test_repeater_translates_as_the_reference():
    jprev, tprev = {}, {}
    for text in (EXPO_1, EXPO_2, EXPO_3, EXPO_1):
        assert prom_cli.parse_exposition(text) == \
            jprom_cli.parse_exposition(text)
        for prefix, ignored in (("", ()), ("p.", ("method",))):
            j = jprom_cli.to_statsd_lines(
                jprom_cli.parse_exposition(text), dict(jprev), prefix,
                ignored)
            t = prom_cli.to_statsd_lines(
                prom_cli.parse_exposition(text), dict(tprev), prefix,
                ignored)
            assert t == j
        j = jprom_cli.to_statsd_lines(jprom_cli.parse_exposition(text),
                                      jprev)
        assert prom_cli.to_statsd_lines(prom_cli.parse_exposition(text),
                                        tprev) == j
        assert tprev == jprev


# -------------------------------- the reference's flows, on the port

def im(name, value, mtype=MetricType.GAUGE, tags=(), host="h"):
    return InterMetric(name=name, timestamp=1000, value=value,
                       tags=list(tags), type=mtype, hostname=host)


class TestPrometheusSink:
    def test_render_text_format(self):
        text = render([im("api.req-time", 1.5, tags=["svc:a b"]),
                       im("hits", 3, MetricType.COUNTER)])
        assert "# TYPE api_req_time gauge" in text
        assert 'api_req_time{svc="a b",hostname="h"} 1.5' in text
        assert "# TYPE hits counter" in text

    def test_counter_accumulates_across_flushes(self):
        totals = {}
        render([im("hits", 3, MetricType.COUNTER, host="")], totals)
        text = render([im("hits", 4, MetricType.COUNTER, host="")], totals)
        assert "hits 7" in text

    def test_scrape_endpoint(self):
        sink = PrometheusMetricSink("127.0.0.1:0")
        sink.start()
        try:
            sink.flush([im("up.time", 9),
                        im("svc.up", 0, MetricType.STATUS)])
            _ctype, body = _scrape(sink.port)
            assert 'up_time{hostname="h"} 9' in body
            assert "svc_up" not in body
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{sink.port}/other", timeout=5) as r:
                raise AssertionError(f"served {r.status}")
        except urllib.error.HTTPError as e:
            assert e.code == 404
        finally:
            sink.stop()

    def test_counter_totals_bounded_under_series_churn(self):
        sink = PrometheusMetricSink("127.0.0.1:0", counter_idle_flushes=5)
        for i in range(200):
            sink.flush([im(f"churn.{i}", 1, MetricType.COUNTER),
                        im("steady", 2, MetricType.COUNTER)])
        assert len(sink._counter_totals) <= 8
        assert b'steady{hostname="h"} 400' in sink._body


def test_prometheus_sink_exposes_unified_registry():
    reg = TelemetryRegistry()
    reg.incr("dest", "attempts", 5)
    reg.incr_level(SERVER_SCOPE, "flush.count", 2)
    sink = PrometheusMetricSink("127.0.0.1:0", registries=(reg,))
    sink.start()
    try:
        sink.flush([InterMetric(name="api.hits", timestamp=1, value=3,
                                type=MetricType.COUNTER)])
        _ctype, text = _scrape(sink.port)
        assert "api_hits 3" in text
        assert 'veneur_resilience_attempts_total{destination="dest"} 5' \
            in text
        assert "veneur_flush_count 2" in text
        reg.drain(2)          # a drain must not zero the scrape
        _ctype, text = _scrape(sink.port)
        assert 'veneur_resilience_attempts_total{destination="dest"} 5' \
            in text
    finally:
        sink.stop()


def test_prometheus_cli_self_metrics_surface():
    reg = TelemetryRegistry()
    reg.incr(SERVER_SCOPE, "prometheus.polls", 4)
    reg.incr(SERVER_SCOPE, "prometheus.series_relayed", 17)
    sink = prom_cli.start_self_metrics_server("127.0.0.1:0", reg)
    try:
        _ctype, text = _scrape(sink.port)
        assert "veneur_prometheus_polls_total 4" in text
        assert "veneur_prometheus_series_relayed_total 17" in text
    finally:
        sink.stop()


def test_prometheus_parse():
    samples = prom_cli.parse_exposition(EXPO_1)
    byname = {(n, tuple(sorted(lab.items()))): (v, t)
              for n, lab, v, t in samples}
    v, t = byname[("http_requests_total",
                   (("code", "200"), ("method", "get")))]
    assert v == 100 and t == "counter"
    assert byname[("temp_celsius", ())] == (21.5, "gauge")
    assert byname[("req_latency_bucket", (("le", "0.1"),))][1] == \
        "histogram"
    assert byname[("untyped_series", ())][1] == "gauge"
    errs = [s for s in samples if s[0] == "errs"]
    assert errs and errs[0][1]["path"] == "/a}b"


def test_prometheus_counter_deltas():
    prev = {}
    text1 = b"\n".join(prom_cli.to_statsd_lines(
        prom_cli.parse_exposition(EXPO_1), prev))
    assert b"temp_celsius:21.5|g" in text1
    assert b"http_requests_total" not in text1
    text2 = b"\n".join(prom_cli.to_statsd_lines(
        prom_cli.parse_exposition(EXPO_2), prev))
    assert b"http_requests_total:40.0|c|#code:200,method:get" in text2
    assert b"temp_celsius:19.0|g" in text2
    assert b"code:500" not in text2
    assert b"req_latency_bucket:15.0|c|#le:+Inf" in text2
    assert b"req_latency_sum" not in text1
    assert b"req_latency_sum:" not in text2


def _serve_expo(text):
    class H(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _udp_sink():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(5.0)
    return sock, sock.getsockname()[1]


def test_poll_once_is_the_references():
    httpd = _serve_expo(EXPO_2)
    try:
        url = f"http://127.0.0.1:{httpd.server_port}/metrics"
        jprev, tprev = {}, {}
        for _ in range(2):
            assert prom_cli.poll_once(url, tprev, "x.") == \
                jprom_cli.poll_once(url, jprev, "x.")
    finally:
        httpd.shutdown()


def test_prometheus_end_to_end_poll():
    httpd = _serve_expo(EXPO_2)
    sock, port = _udp_sink()
    try:
        rc = prom_cli.main([
            "-p", f"http://127.0.0.1:{httpd.server_port}/metrics",
            "-s", f"127.0.0.1:{port}", "--once"])
        assert rc == 0
        data, _ = sock.recvfrom(65536)
        assert b"|g" in data or b"|c" in data
    finally:
        httpd.shutdown()
        sock.close()


def test_bad_statsd_address_exits_1():
    assert prom_cli.main(["-s", "nohostport", "--once"]) == 1


def test_repeater_runs_as_a_module():
    """`python3 -m veneur_tpu_torch.cli.prometheus --once` polls twice and
    relays each gauge to the statsd address over UDP; the counters of the
    second poll are deltas of the first."""
    httpd = _serve_expo(EXPO_2)
    sock, port = _udp_sink()
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    try:
        out = subprocess.run(
            [sys.executable, "-m", "veneur_tpu_torch.cli.prometheus",
             "-p", f"http://127.0.0.1:{httpd.server_port}/metrics",
             "-s", f"127.0.0.1:{port}", "--prefix", "r.", "--once"],
            cwd=_REPO, env=env, capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        got = []
        sock.settimeout(2.0)
        try:
            while True:
                got.append(sock.recvfrom(65536)[0])
        except socket.timeout:
            pass
    finally:
        httpd.shutdown()
        sock.close()
    gauges = [g for g in got if g.endswith(b"|g") or b"|g|" in g]
    # two polls of the same text: the gauges twice, no counter deltas
    want = [ln for ln in jprom_cli.to_statsd_lines(
        jprom_cli.parse_exposition(EXPO_2), {}, "r.") if b"|g" in ln]
    assert sorted(gauges) == sorted(want * 2)
    assert not [g for g in got if b"|c" in g]
    assert "relayed" in out.stderr
