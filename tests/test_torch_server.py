"""The port's Server against the reference server (ROADMAP queue A item 9).

The gate: one UDP stream goes to a reference `veneur_tpu.server.Server`
(JAX on the CPU) and to a port `veneur_tpu_torch.server.Server`
(`aggregation_backend: cpu`), both with two workers, over three flushes —
after the first traffic, after a second batch (the incremental flush) and
with no traffic. The flushed rows are compared under the contract below:
equal row-key sets from the first flush to the last, phase timers on
(both servers run the ssfmetrics span sink and time it in the fan-out),
and the read-only counters equal on the same traffic. Then the port's own
stream listeners, its stop(), drain()'s injectable clock, the profiler
capture, its device choice and the config keys it accepts and refuses.
"""

import dataclasses
import json
import os
import socket
import ssl
import threading
import time

import numpy as np
import pytest
import torch

from envprobes import needs_cryptography
from test_statsd_streams import _self_signed

from veneur_tpu import observe as jobserve
from veneur_tpu.config import read_config as jread_config
from veneur_tpu.ingest import parser as jparser
from veneur_tpu.metrics import MetricType as JMetricType
from veneur_tpu.models import pipeline as jpipe
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks.basic import CaptureMetricSink as JCapture
from veneur_tpu_torch import observe as tobserve
from veneur_tpu_torch.config import Config, read_config
from veneur_tpu_torch.ingest import parser as tparser
from veneur_tpu_torch.models import pipeline as tpipe
from veneur_tpu_torch.server import REFUSED_KEYS, Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink

GATE_YAML = """
interval: "3600s"
statsd_listen_addresses: ["udp://127.0.0.1:0"]
num_workers: 2
num_readers: 1
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

# values compared among the self-metrics; timings never are
EXACT_SELF = ("veneur.packet.received_total", "veneur.packet.error_total",
              "veneur.worker.dropped_total")


def _lines(rng, n, tag):
    """~n DogStatsD lines of every type, plus an event, a service check
    and a bad line."""
    out = []
    for i in range(n):
        k = int(rng.integers(0, 50))
        kind = i % 6
        if kind in (0, 1):
            out.append(f"gate.lat.{k}:{rng.lognormal(3, 1):.3f}|ms"
                       f"|#shard:{k % 3},env:{tag}")
        elif kind == 2:
            rate = "|@0.5" if k % 2 else ""
            out.append(f"gate.hits.{k % 40}:{int(rng.integers(1, 9))}|c"
                       f"{rate}")
        elif kind == 3:
            out.append(f"gate.temp.{k % 30}:{rng.normal(50, 10):.2f}|g")
        elif kind == 4:
            out.append(f"gate.users.{k % 10}:u{int(rng.integers(0, 300))}"
                       "|s")
        else:
            out.append(f"gate.size.{k % 20}:{rng.gamma(2, 50):.2f}|h")
    out += [f"_e{{5,4}}:title|text|#run:{tag}",
            f"_sc|gate.check|{len(tag) % 4}|#run:{tag}|m:ok {tag}",
            "not a metric line"]
    return [ln.encode() for ln in out]


def _datagrams(rng, lines):
    """Pack lines into datagrams of 1 to 20 lines (multi-line datagrams
    and single lines both)."""
    out, i = [], 0
    while i < len(lines):
        k = int(rng.integers(1, 21))
        out.append(b"\n".join(lines[i:i + k]))
        i += k
    return out


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _send(servers, dgrams):
    """Every datagram to every server, in bursts that wait for both to
    have received all sent so far (the packet counts are per interval)."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for i in range(0, len(dgrams), 20):
            for d in dgrams[i:i + 20]:
                for srv in servers:
                    s.sendto(d, ("127.0.0.1", srv.bound_port()))
            n = min(i + 20, len(dgrams))
            assert _wait(lambda: all(srv.packets_received == n
                                     for srv in servers)), \
                [srv.packets_received for srv in servers]


def _flush(srv, cap, ts, n):
    """drain, flush, wait for the sink and join the fan-out threads (so
    the sink's stats and fan-out timer are in before the next flush)."""
    assert srv.drain()
    srv.flush_once(timestamp=ts)
    assert cap.wait_for_flush(n)
    for t in list(srv._sink_inflight.values()):
        t.join(30)
        assert not t.is_alive()
    return cap.flushes[n - 1]


def _rows(metrics):
    out = {}
    for m in metrics:
        key = (m.name, tuple(sorted(m.tags)), int(m.type))
        assert key not in out, key
        out[key] = m
    return out


# the read-only counters the gate holds equal between the two servers
COUNTERS = ("packets_received", "parse_errors", "queue_drops",
            "spans_received", "ssf_errors", "flush_errors",
            "import_rejected")


def _compare(jrows, trows, label, sets=("gate.users.",)):
    """Equal row-key sets; self-metric values of EXACT_SELF exact, the
    rest of veneur.* not compared; percentiles within 1% of the key's
    spread, set estimates (names under `sets`) within rtol 1e-5, sums
    within rtol 1e-6, everything else exact."""
    assert set(jrows) == set(trows), (
        label, sorted(set(jrows) - set(trows)),
        sorted(set(trows) - set(jrows)))
    for key in sorted(jrows):
        j, t = jrows[key], trows[key]
        name = key[0]
        assert (t.hostname, t.timestamp) == (j.hostname, j.timestamp), key
        if name.startswith("veneur."):
            if name in EXACT_SELF:
                assert t.value == j.value, (label, key, t.value, j.value)
            continue
        if "percentile" in name:
            base = name.rsplit(".", 1)[0]
            lo = jrows[(base + ".min",) + key[1:]].value
            hi = jrows[(base + ".max",) + key[1:]].value
            assert abs(t.value - j.value) <= 0.01 * (hi - lo) + 1e-9, \
                (label, key, t.value, j.value)
        elif name.startswith(sets):
            assert t.value == pytest.approx(j.value, rel=1e-5), key
        elif name.endswith(".sum"):
            # f32 sums of a few dozen values (ROADMAP comparison contract,
            # fractional values within rtol 1e-6)
            assert t.value == pytest.approx(j.value, rel=1e-6), key
        else:
            # counters, gauges, count/min/max and status rows
            assert t.value == j.value, (label, key, t.value, j.value)
            if t.type == JMetricType.STATUS:
                assert t.message == j.message, key


def _clear_process_registries():
    """Drop the counters and gauges other tests of this process left in
    both packages' process-default registries (each server drains them
    into its flush)."""
    for reg in (jobserve.DEFAULT_REGISTRY, tobserve.DEFAULT_REGISTRY):
        reg.take()
        reg.take_gauges()


def test_gate_port_server_flushes_the_reference_rows():
    jcfg = jread_config(text=GATE_YAML)
    tcfg = read_config(text=GATE_YAML + "aggregation_backend: cpu\n")
    jcap, tcap = JCapture(), CaptureMetricSink()
    jsrv = JServer(jcfg, sinks=[jcap])
    tsrv = Server(tcfg, sinks=[tcap])
    assert tsrv.device.type == "cpu" and len(tsrv.engines) == 2
    _clear_process_registries()
    jsrv.start()
    tsrv.start()
    rng = np.random.default_rng(11)
    try:
        for n, (tag, n_lines) in enumerate((("one", 1200), ("two", 800),
                                            (None, 0)), start=1):
            if tag is not None:
                dgrams = _datagrams(rng, _lines(rng, n_lines, tag))
                _send((jsrv, tsrv), dgrams)
            assert jsrv.drain() and tsrv.drain()
            counts = [{c: getattr(srv, c) for c in COUNTERS}
                      for srv in (jsrv, tsrv)]
            assert counts[1] == counts[0], (n, counts)
            assert counts[1]["parse_errors"] == (1 if tag else 0)
            ts = 1000 + 10 * n
            jrows = _rows(_flush(jsrv, jcap, ts, n))
            trows = _rows(_flush(tsrv, tcap, ts, n))
            assert trows[("veneur.packet.error_total", (), 0)].value == (
                1 if tag else 0)
            if tag is not None:
                assert any(k[0].startswith("gate.lat.") for k in trows)
            _compare(jrows, trows, n)
            # the span sink's fan-out timer, from the second flush on
            assert any(k[0].startswith(
                "veneur.flush.phase.fanout.ssfmetrics.")
                for k in trows) == (n > 1)
        assert [dataclasses.astuple(e) for e in tcap.events] == \
            [dataclasses.astuple(e) for e in jcap.events]
        assert len(tcap.events) == 2
    finally:
        jsrv.stop()
        tsrv.stop()


def _stream_server(addr, tmp_path=None):
    cap = CaptureMetricSink()
    cfg = Config(statsd_listen_addresses=[addr], interval="3600s",
                 hostname="h", aggregates=["count"], percentiles=[],
                 aggregation_backend="cpu", tpu_histogram_slots=256,
                 tpu_counter_slots=128, tpu_gauge_slots=128,
                 tpu_set_slots=64, tpu_batch_size=256)
    srv = Server(cfg, sinks=[cap])
    srv.start()
    return srv, cap


def _values(srv, cap):
    rows = _flush(srv, cap, 1000, 1)
    return {m.name: m.value for m in rows if not m.name.startswith("veneur.")}


def test_tcp_stream_listener_reassembles_split_lines():
    srv, cap = _stream_server("tcp://127.0.0.1:0")
    try:
        port = srv._listen_socks[0].getsockname()[1]
        with socket.create_connection(("127.0.0.1", port), timeout=5) as c:
            c.sendall(b"tcp.count:1|c\ntcp.co")
            time.sleep(0.05)
            c.sendall(b"unt:2|c\n")
        assert _wait(lambda: srv.packets_received >= 2)
        assert _values(srv, cap)["tcp.count"] == 3.0
    finally:
        srv.stop()


@needs_cryptography
def test_tls_stream_listener(tmp_path):
    key, cert = _self_signed(tmp_path, "server")
    cap = CaptureMetricSink()
    srv = Server(_small(statsd_listen_addresses=["tcp://127.0.0.1:0"],
                        interval="3600s", tls_key=key,
                        tls_certificate=cert), sinks=[cap])
    srv.start()
    try:
        port = srv._listen_socks[0].getsockname()[1]
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(cafile=cert)
        with socket.create_connection(("127.0.0.1", port), timeout=5) as c:
            with ctx.wrap_socket(c, server_hostname="localhost") as tc:
                tc.sendall(b"tls.count:5|c\n")
        assert _wait(lambda: srv.packets_received >= 1)
        assert _values(srv, cap)["tls.count"] == 5.0
    finally:
        srv.stop()


def test_unix_stream_listener(tmp_path):
    path = str(tmp_path / "statsd.sock")
    srv, cap = _stream_server(f"unix://{path}")
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.connect(path)
            c.sendall(b"ux.g:7|g\n")
        assert _wait(lambda: srv.packets_received >= 1)
        assert _values(srv, cap)["ux.g"] == 7.0
    finally:
        srv.stop()


def test_stop_closes_every_socket_and_thread(tmp_path):
    cfg = Config(statsd_listen_addresses=[
        "udp://127.0.0.1:0", "tcp://127.0.0.1:0",
        f"unix://{tmp_path / 's.sock'}"], num_readers=2, num_workers=2,
        interval="3600s", http_address="127.0.0.1:0",
        aggregation_backend="cpu", tpu_histogram_slots=512,
        tpu_counter_slots=256, tpu_gauge_slots=256, tpu_set_slots=128,
        tpu_batch_size=256)
    srv = Server(cfg, sinks=[CaptureMetricSink()])
    before = set(threading.enumerate())
    srv.start()
    port = srv._listen_socks[0].getsockname()[1]
    held = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        held.sendall(b"held.c:1|c\n")
        assert _wait(lambda: srv.packets_received >= 1)
        with srv._conns_lock:
            readers = list(srv._stream_conns.values())
        assert len(readers) == 1
        t0 = time.monotonic()
        srv.stop()
        assert time.monotonic() - t0 < 10.0
    finally:
        held.close()
    assert len(srv._sockets) == 2
    for s in srv._sockets + srv._listen_socks:
        assert s.fileno() == -1
    alive = [t.name for t in srv._threads + readers if t.is_alive()]
    assert not alive
    assert not (set(threading.enumerate()) - before)


def test_stop_waits_for_a_fan_out_thread_registered_before_its_start():
    """The fan-out registers a sink thread before it starts it; a stop()
    that lands in between joins it once it starts (and gives up at its
    deadline if it never does) instead of raising."""
    srv = Server(_small(interval="3600s"), sinks=[CaptureMetricSink()])
    srv.start()
    late = threading.Thread(target=lambda: None, daemon=True)
    never = threading.Thread(target=lambda: None, daemon=True)
    srv._sink_inflight[("sink", "late")] = late
    srv._sink_inflight[("sink", "never")] = never
    starter = threading.Timer(0.2, late.start)
    starter.start()
    t0 = time.monotonic()
    srv.stop(timeout=2.0)
    assert time.monotonic() - t0 < 5.0
    starter.join(5)
    late.join(5)
    assert not late.is_alive() and not never.is_alive()
    assert not [t for t in srv._threads if t.is_alive()]


def test_default_backend_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(Config())


_REFUSED_VALUES = {
    "history_retention_generations": 3, "tpu_num_devices": 2,
    "tpu_flush_fetch": "staged"}


@pytest.mark.parametrize(
    "key,value,item",
    [(k, _REFUSED_VALUES.get(k, True if isinstance(getattr(Config(), k),
                                                    bool) else "x"),
      item.split(",")[0]) for k, _, item in REFUSED_KEYS]
    + [("tpu_fused_kernels", "off", "queue B")])
def test_refused_config_keys(key, value, item):
    cfg = Config(aggregation_backend="cpu")
    setattr(cfg, key, value)
    with pytest.raises(NotImplementedError, match=item) as e:
        Server(cfg)
    assert key in str(e.value) and "ROADMAP" in str(e.value)


def test_network_sink_keys_name_item_9b2():
    refused = {k: item for k, _, item in REFUSED_KEYS}
    network = ("datadog_api_key", "datadog_trace_api_address",
               "signalfx_api_key", "kafka_broker", "newrelic_insert_key",
               "prometheus_repeater_address", "aws_s3_bucket",
               "splunk_hec_address", "lightstep_access_token",
               "xray_address", "falconer_address", "sentry_dsn")
    assert all(refused[k].startswith("item 9b.2") for k in network)
    assert not {"ssf_listen_addresses", "overload_defense_enabled",
                "enable_profiling", "debug_flush_profile"} & set(refused)


@pytest.mark.parametrize("key,value", [
    ("ssf_listen_addresses", ["udp://127.0.0.1:0"]),
    ("overload_defense_enabled", True),
    ("enable_profiling", True),
    ("debug_flush_profile", True)])
def test_ported_keys_are_accepted(key, value):
    srv = Server(_small(**{key: value}))
    if key == "overload_defense_enabled":
        assert srv.admission is not None
        assert all(k.admission is srv.admission
                   for eng in srv.engines
                   for k in (eng.histo_keys, eng.counter_keys,
                             eng.gauge_keys, eng.set_keys))
    assert [s.name() for s in srv.span_sinks] == ["ssfmetrics"]


class FakeClock:
    """A clock that moves only when its sleep is called."""

    def __init__(self):
        self.t = 100.0
        self.slept = 0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt
        self.slept += 1


def test_drain_takes_an_injectable_clock():
    """drain() over a scripted clock: a span or a metric that no worker
    takes keeps it waiting until the fake deadline passes (no real
    wait); once every queue settles it returns True at once."""
    srv = Server(_small())          # not started: nothing consumes
    for q in (srv.span_queue, srv.worker_queues[0]):
        clock = FakeClock()
        q.put(object())
        t0 = time.monotonic()
        assert srv.drain(5.0, clock=clock, sleep=clock.sleep) is False
        assert time.monotonic() - t0 < 1.0
        assert clock.t >= 105.0 and 1000 <= clock.slept <= 1001
        q.get()
        q.task_done()
        clock = FakeClock()
        assert srv.drain(5.0, clock=clock, sleep=clock.sleep) is True
        assert clock.slept == 0


def test_profile_capture_writes_a_trace_of_the_next_tick(tmp_path):
    """debug_flush_profile: GET /debug/flush/profile schedules a
    torch.profiler capture; the next flush tick writes one Chrome trace
    into debug_flush_profile_dir, and a tick after it writes none."""
    import urllib.request
    d = tmp_path / "prof"
    srv = Server(_small(debug_flush_profile=True,
                        debug_flush_profile_dir=str(d),
                        http_address="127.0.0.1:0", interval="3600s"),
                 sinks=[CaptureMetricSink()])
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.http_api.port}/debug/flush/profile"
        with urllib.request.urlopen(url + "?ticks=1", timeout=10) as r:
            assert json.loads(r.read()) == {"capture_ticks": 1,
                                            "dir": str(d)}
        srv.handle_packet(b"p.t:1|ms\np.c:1|c")
        assert srv.drain()
        srv.flush_once(timestamp=1)
        traces = os.listdir(d)
        assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
        with open(d / traces[0]) as f:
            assert json.load(f)["traceEvents"]
        srv.flush_once(timestamp=2)
        assert len(os.listdir(d)) == 1
    finally:
        srv.stop()


def test_profile_trigger_needs_debug_flush_profile():
    import urllib.error
    import urllib.request
    srv = Server(_small(http_address="127.0.0.1:0"))
    srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.http_api.port}"
                                   "/debug/flush/profile", timeout=10)
        assert e.value.code == 403
    finally:
        srv.stop()


def test_enable_profiling_serves_captures_on_profile_port():
    import urllib.request
    srv = Server(_small(enable_profiling=True, profile_port=0))
    before = set(threading.enumerate())
    srv.start()
    try:
        port = srv._profile_server.port
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/profile?seconds=0.05",
                timeout=30) as r:
            assert "traceEvents" in json.loads(r.read())
    finally:
        srv.stop()
    assert not (set(threading.enumerate()) - before)


def test_double_buffer_off_is_accepted_and_flushes_the_reference_rows():
    """The port's flush is always double-buffered; with the key off the
    reference drains under the lock, and both flush the same rows:
    count/min/max exact, percentiles within 1% of the key's spread."""
    cfg = Config(aggregation_backend="cpu", tpu_flush_double_buffer=False,
                 tpu_histogram_slots=256, tpu_counter_slots=128,
                 tpu_gauge_slots=128, tpu_set_slots=64, tpu_batch_size=256)
    assert Server(cfg).engines[0].cfg.flush_incremental
    kw = dict(histogram_slots=256, counter_slots=64, gauge_slots=64,
              set_slots=32, batch_size=256, buffer_depth=32,
              percentiles=(0.5, 0.99), aggregates=("min", "max", "count"))
    jeng = jpipe.AggregationEngine(jpipe.EngineConfig(
        flush_double_buffer=False, **kw))
    teng = tpipe.AggregationEngine(tpipe.EngineConfig(**kw), device="cpu")
    for i in range(2):
        r = np.random.default_rng(100 + i)
        lines = [f"d.t{k}:{v:.3f}|ms".encode() for k in range(20)
                 for v in r.gamma(2, 20, int(r.integers(5, 60)))]
        for eng, parse in ((jeng, jparser.parse_packet),
                           (teng, tparser.parse_packet)):
            for ln in lines:
                eng.process(parse(ln))
        jrows = _rows(jeng.flush(timestamp=i).metrics)
        trows = _rows(teng.flush(timestamp=i).metrics)
        assert len(jrows) == 20 * 5
        _compare(jrows, trows, f"interval {i}")


def _small(**kw):
    return Config(aggregation_backend="cpu", hostname="h",
                  tpu_histogram_slots=256, tpu_counter_slots=128,
                  tpu_gauge_slots=128, tpu_set_slots=64, tpu_batch_size=256,
                  **kw)


def test_stats_address_ships_self_metrics_over_udp():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(10)
        cap = CaptureMetricSink()
        srv = Server(_small(stats_address=f"127.0.0.1:"
                            f"{rx.getsockname()[1]}"), sinks=[cap])
        srv.start()
        srv.handle_packet(b"s.c:2|c\nbad line")
        assert srv.drain()
        srv.flush_once(timestamp=7)
        lines = rx.recv(65536).decode().split("\n")
        srv.stop()
    assert "veneur.packet.received_total:1|c" in lines
    assert "veneur.packet.error_total:1|c" in lines
    assert any(ln.startswith("veneur.flush.swap_duration_ns:")
               and ln.endswith("|g") for ln in lines)
    # the flush itself carries no veneur.* row
    assert cap.wait_for_flush(1)
    assert [m.name for m in cap.flushes[0]] == ["s.c"]


def test_health_stalls_after_one_and_a_half_intervals():
    srv = Server(_small(interval="10s"))
    srv._started = True
    t = srv._last_flush_ok
    assert srv.health_state(now=t + 14.0)["status"] == "ok"
    st = srv.health_state(now=t + 16.0)
    assert st["status"] == "stalled" and not st["healthy"]
    assert not st["checks"]["flush"]["ok"]


def test_watchdog_counts_overdue_ticks():
    srv = Server(_small(interval="50ms"))
    srv._last_flush_ok = time.monotonic() - 1.0
    th = threading.Thread(target=srv._watchdog)
    th.start()
    try:
        assert _wait(lambda: srv.telemetry.total(
            tobserve.SERVER_SCOPE, "watchdog.stalled_ticks") >= 2, 10)
    finally:
        srv._stop.set()
        th.join(10)
    assert not th.is_alive()


@pytest.mark.parametrize("threshold,n_keys,path", [
    (0.75, 20, "incremental"), (0.01, 20, "full"), (0.75, 0, "idle")])
def test_engine_flush_phases_are_the_references(threshold, n_keys, path):
    """stats["phases"] of a flush, which the server grafts under
    engine.flush: the reference's names (its sync fetch mode), in its
    order, on each flush path."""
    kw = dict(histogram_slots=256, counter_slots=64, gauge_slots=64,
              set_slots=32, batch_size=256,
              flush_incremental_threshold=threshold)
    jeng = jpipe.AggregationEngine(jpipe.EngineConfig(**kw))
    teng = tpipe.AggregationEngine(tpipe.EngineConfig(**kw), device="cpu")
    names = []
    for eng, parse in ((jeng, jparser.parse_packet),
                       (teng, tparser.parse_packet)):
        for k in range(n_keys):
            eng.process(parse(f"p.t{k}:{k}|ms".encode()))
        stats = eng.flush(timestamp=1).stats
        names.append([p[0] for p in stats["phases"]])
        assert all(t0 <= t1 for _, t0, t1 in stats["phases"])
        assert stats["flush_path"]["path"] == (
            "full" if path == "full" else "incremental")
    assert names[1] == names[0]
    assert ("scatter" in names[1]) == (path == "incremental")
