"""A port Server with `native_ingest: true` on the CPU (ROADMAP item 13).

The C++ bridge reads the UDP traffic, parses and interns it; the pump
lands its batches in the one engine's banks. Its flushes are held to a
port Python-ingest server's and to a reference native server's on the
same datagrams (rows under the comparison contract of
test_torch_server.py, events and checks equal, and the packet, drop,
span and bank-full counters equal), and its native SSF path to the port's
Python span path. Then the warnings and refusals of the native arms.
Needs g++ (the bridge is built on first use). One reference Server start.
"""

import dataclasses
import logging
import socket
import time

import numpy as np
import pytest

from test_torch_server import (GATE_YAML, _clear_process_registries,
                               _compare, _datagrams, _flush, _lines, _rows)
from veneur_tpu.config import read_config as jread_config
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks.basic import CaptureMetricSink as JCapture
from veneur_tpu_torch import ssf
from veneur_tpu_torch.config import Config, read_config
from veneur_tpu_torch.ingest import native
from veneur_tpu_torch.metrics import MetricType
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink
from veneur_tpu_torch.ssf import framing
from veneur_tpu_torch.ssf.protos import ssf_pb2


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _received(srv):
    """Datagrams a server took: the bridge's count under native ingest
    (folded into packet.received at flush), the interval's otherwise."""
    if srv.native_bridge is not None:
        last = getattr(srv, "_last_bridge_stats", None) or {}
        return int(srv.native_bridge.stats()["packets"]) - int(
            last.get("packets", 0))
    return srv.packets_received


def _send(servers, dgrams, port=None):
    """Every datagram to every server, 20 at a time, each burst waiting
    until every server has taken all sent so far."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for i in range(0, len(dgrams), 20):
            for d in dgrams[i:i + 20]:
                for srv in servers:
                    s.sendto(d, ("127.0.0.1", port(srv) if port
                                 else srv.bound_port()))
            n = min(i + 20, len(dgrams))
            assert _wait(lambda: all(_received(srv) == n
                                     for srv in servers)), \
                [_received(srv) for srv in servers]


def _spans(rng, n, status_every=0):
    """n spans with a timing, a count, a set member and a gauge each, every
    fourth an indicator span; every `status_every`-th carries a STATUS
    sample in place of its gauge. Such a span falls back to the Python
    span path, whose landings interleave with the pump's at no fixed
    point, so it carries no gauge: a gauge's last write stays defined."""
    out = []
    for i in range(n):
        sp = ssf_pb2.SSFSpan(version=0, trace_id=i + 1, id=i + 1,
                             name="op", service="svc",
                             start_timestamp=10**18 + i,
                             end_timestamp=10**18 + i + int(
                                 rng.integers(1000, 10**7)),
                             indicator=(i % 4 == 0))
        k = int(rng.integers(0, 20))
        sp.metrics.extend([
            ssf.timing(f"sp.lat.{k}", float(rng.lognormal(3, 1)) / 1e3,
                       ssf.MILLISECOND, tags={"env": "t"}),
            ssf.count(f"sp.calls.{k % 5}", 1.0),
            ssf.set_sample(f"sp.users.{k % 3}", f"u{int(rng.integers(50))}")])
        temp = float(rng.normal(50, 5))
        if status_every and i % status_every == status_every - 1:
            sp.metrics.append(ssf.status(f"sp.check.{i}", i % 3,
                                         message="m"))
        else:
            sp.metrics.append(ssf.gauge(f"sp.temp.{k % 4}", temp))
        out.append(sp.SerializeToString())
    return out


def _small(**kw):
    base = dict(statsd_listen_addresses=["udp://127.0.0.1:0"],
                interval="3600s", hostname="h", aggregation_backend="cpu",
                tpu_histogram_slots=512, tpu_counter_slots=256,
                tpu_gauge_slots=128, tpu_set_slots=64, tpu_batch_size=256)
    base.update(kw)
    return Config(**base)


def _one_flush(srv, cap, n=1, ts=1000):
    return _rows(_flush(srv, cap, ts, n))


def _data_rows(rows):
    return {k: m for k, m in rows.items() if not k[0].startswith("veneur.")}


# ------------------------------------------------------------ the gates


def test_native_server_flushes_the_python_ingest_rows():
    """The same datagrams through a native port server and a Python-ingest
    port server: equal rows over two flushes with traffic and an empty
    one, equal events, and equal packet, error and drop counts."""
    ncfg = read_config(text=GATE_YAML + "aggregation_backend: cpu\n"
                       "native_ingest: true\n")
    pcfg = read_config(text=GATE_YAML + "aggregation_backend: cpu\n")
    ncap, pcap = CaptureMetricSink(), CaptureMetricSink()
    nsrv = Server(ncfg, sinks=[ncap])
    psrv = Server(pcfg, sinks=[pcap])
    assert len(nsrv.engines) == 1 and nsrv.native_pump is not None
    assert nsrv.engines[0].histo_keys.bridge is nsrv.native_bridge
    _clear_process_registries()
    nsrv.start()
    psrv.start()
    rng = np.random.default_rng(11)
    try:
        for n, (tag, n_lines) in enumerate((("one", 1200), ("two", 800),
                                            (None, 0)), start=1):
            if tag is not None:
                _send((nsrv, psrv), _datagrams(rng, _lines(rng, n_lines,
                                                           tag)))
            ts = 1000 + 10 * n
            prows = _rows(_flush(psrv, pcap, ts, n))
            nrows = _rows(_flush(nsrv, ncap, ts, n))
            assert nrows[("veneur.packet.error_total", (), 0)].value == (
                1 if tag else 0)
            _compare(prows, nrows, n)
        assert [dataclasses.astuple(e) for e in ncap.events] == \
            [dataclasses.astuple(e) for e in pcap.events]
        assert len(ncap.events) == 2
    finally:
        nsrv.stop()
        psrv.stop()
    assert not [t.name for t in nsrv._threads if t.is_alive()]
    assert nsrv.native_pump._thread is None


NATIVE_YAML = """
interval: "3600s"
statsd_listen_addresses: ["udp://127.0.0.1:0"]
ssf_listen_addresses: ["udp://127.0.0.1:0"]
native_ingest: true
num_readers: 1
percentiles: [0.5, 0.99]
aggregates: ["min", "max", "count", "sum"]
hostname: testhost
indicator_span_timer_name: "sp.indicator"
tpu_histogram_slots: 512
tpu_counter_slots: 128
tpu_gauge_slots: 128
tpu_set_slots: 64
tpu_batch_size: 512
tpu_buffer_depth: 128
native_pump_batch: 1024
"""

# the counters held equal between the port's and the reference's
# native servers on the same traffic
NATIVE_COUNTERS = ("veneur.packet.received_total",
                   "veneur.packet.error_total",
                   "veneur.worker.dropped_total",
                   "veneur.ssf.received_total", "veneur.ssf.error_total")


def test_native_server_flushes_the_reference_native_rows():
    """The same DogStatsD datagrams and SSF span datagrams (a STATUS span
    and a malformed datagram among them) to a reference native server and
    a port native server: rows under the contract, status rows, events
    and the packet, error, drop, span and bank-full counters equal."""
    jcfg = jread_config(text=NATIVE_YAML)
    tcfg = read_config(text=NATIVE_YAML + "aggregation_backend: cpu\n")
    jcap, tcap = JCapture(), CaptureMetricSink()
    jsrv = JServer(jcfg, sinks=[jcap])
    tsrv = Server(tcfg, sinks=[tcap])
    assert jsrv._native_ssf and tsrv._native_ssf
    _clear_process_registries()
    jsrv.start()
    tsrv.start()
    rng = np.random.default_rng(5)
    try:
        lines = _lines(rng, 1500, "n")
        # 160 more counter keys than the 128 counter slots hold, with the
        # 40 of _lines: bank-full drops, counted by the bridge
        lines += [f"drop.c{i}:1|c".encode() for i in range(160)]
        _send((jsrv, tsrv), _datagrams(rng, lines))
        spans = _spans(rng, 200, status_every=50) + [b"\xff\xff\xff\x01"]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for i in range(0, len(spans), 20):
                for d in spans[i:i + 20]:
                    for srv in (jsrv, tsrv):
                        s.sendto(d, ("127.0.0.1", srv.ssf_native_port))
                for srv in (jsrv, tsrv):
                    assert _wait(lambda srv=srv: (
                        srv.native_bridge.stats()["ssf_spans"]
                        + srv.native_bridge.stats()["ssf_fallbacks"]
                        + srv.native_bridge.stats()["ssf_errors"])
                        >= min(i + 20, len(spans)))
        jrows = _rows(_flush(jsrv, jcap, 1010, 1))
        trows = _rows(_flush(tsrv, tcap, 1010, 1))
        _compare(jrows, trows, "native", sets=("gate.users.", "sp.users."))
        for name in NATIVE_COUNTERS:
            key = (name, (), 0)
            assert trows[key].value == jrows[key].value, name
        drops = [k for k in trows if "dropped_no_slot" in k[0]]
        assert drops and all(trows[k].value == jrows[k].value
                             for k in drops)
        assert trows[drops[0]].value >= 72
        assert trows[("veneur.ssf.received_total", (), 0)].value == 200
        assert trows[("veneur.ssf.error_total", (), 0)].value == 1
        checks = {k[0] for k, m in trows.items()
                  if m.type == MetricType.STATUS}
        assert checks == {f"sp.check.{i}" for i in (49, 99, 149, 199)} | {
            "gate.check"}
        assert any(k[0].startswith("sp.indicator") for k in trows)
        assert [dataclasses.astuple(e) for e in tcap.events] == \
            [dataclasses.astuple(e) for e in jcap.events]
        for srv in (jsrv, tsrv):
            assert srv.native_bridge.stats()["ring_drops"] == 0
    finally:
        jsrv.stop()
        tsrv.stop()


def test_native_ssf_path_flushes_the_python_span_rows():
    """Spans over UDP through the C++ decoder (a port native server) and
    through the Python span path (a port server without native ingest):
    equal rows, the STATUS spans' checks included, and the same count of
    received spans."""
    rng = np.random.default_rng(9)
    spans = _spans(rng, 300, status_every=60)
    kw = dict(ssf_listen_addresses=["udp://127.0.0.1:0"],
              indicator_span_timer_name="sp.indicator",
              percentiles=[0.5], aggregates=["min", "max", "count"])
    ncap, pcap = CaptureMetricSink(), CaptureMetricSink()
    nsrv = Server(_small(native_ingest=True, **kw), sinks=[ncap])
    psrv = Server(_small(**kw), sinks=[pcap])
    nsrv.start()
    psrv.start()
    try:
        assert nsrv._native_ssf and not psrv._native_ssf
        assert nsrv._ssf_udp_sock is None and nsrv.ssf_native_port
        # the self-tracing client targets the native SSF listener
        assert nsrv.trace_client is not None
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for i, d in enumerate(spans):
                s.sendto(d, ("127.0.0.1", nsrv.ssf_native_port))
                s.sendto(d, ("127.0.0.1",
                             psrv._ssf_udp_sock.getsockname()[1]))
                if i % 25 == 24:
                    st = nsrv.native_bridge.stats
                    assert _wait(lambda: psrv.spans_received > i and (
                        st()["ssf_spans"] + st()["ssf_fallbacks"] > i))
        st = nsrv.native_bridge.stats()
        assert st["ssf_fallbacks"] == 5 and st["ssf_spans"] == 295
        nrows = _data_rows(_one_flush(nsrv, ncap))
        prows = _data_rows(_one_flush(psrv, pcap))
        _compare(prows, nrows, "ssf", sets=("sp.users.",))
        assert sum(m.type == MetricType.STATUS for m in nrows.values()) == 5
        assert ("sp.indicator.count", ("service:svc", "error:false"),
                0) in nrows or any(k[0] == "sp.indicator.count"
                                   for k in nrows)
        self_rows = _rows(ncap.flushes[0])
        assert self_rows[("veneur.ssf.received_total", (), 0)].value == 300
    finally:
        nsrv.stop()
        psrv.stop()


def test_native_ssf_stream_fallback_and_errors():
    """Framed spans over TCP ride the native decoder; a STATUS span falls
    back to the Python span path and yields its sample and its check; a
    malformed UDP datagram counts as ssf.error through the C++ reader,
    and a corrupt frame as ssf.error through the stream reader."""
    cap = CaptureMetricSink()
    srv = Server(_small(native_ingest=True, ssf_listen_addresses=[
        "tcp://127.0.0.1:0", "udp://127.0.0.1:0"]), sinks=[cap])
    srv.start()
    try:
        port = srv._listen_socks[0].getsockname()[1]

        def mk(i, status=False):
            sp = ssf_pb2.SSFSpan(version=1)
            sp.metrics.append(ssf.timing("st.lat", float(i) / 1e3,
                                         ssf.MILLISECOND))
            if status:
                sp.metrics.append(ssf.status("st.check", 1))
            return sp

        with socket.create_connection(("127.0.0.1", port)) as conn:
            for i in range(30):
                conn.sendall(framing.write_ssf(mk(i)))
            conn.sendall(framing.write_ssf(mk(99, status=True)))
            st = srv.native_bridge.stats
            assert _wait(lambda: st()["ssf_spans"] + srv.spans_received
                         >= 31)
        assert srv.spans_received == 1      # the fallback, in Python
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.sendto(b"\xff\xff\xff\xff\x01",
                     ("127.0.0.1", srv.ssf_native_port))
        assert _wait(lambda: srv.native_bridge.stats()["ssf_errors"] == 1)
        with socket.create_connection(("127.0.0.1", port)) as conn:
            conn.sendall(b"\x00\x00\x00\x00\x05\xff\xff\xff\xff\x01")
            assert _wait(lambda: srv.ssf_errors == 1)
        # read before the flush: the flush's own self-traced spans reach
        # the same native SSF listener right after it
        st = srv.native_bridge.stats()
        rows = _one_flush(srv, cap)
        assert rows[("st.lat.count", (), 0)].value == 31.0
        assert rows[("st.check", (), int(MetricType.STATUS))].value == 1.0
        assert rows[("veneur.ssf.received_total", (), 0)].value == 31
        assert rows[("veneur.ssf.error_total", (), 0)].value == 2
        assert st["ssf_spans"] == 30 and st["ssf_fallbacks"] == 1
    finally:
        srv.stop()


# ------------------------------------------------- warnings and refusals


def test_defense_journal_and_bound_warnings(tmp_path, caplog):
    caplog.set_level(logging.WARNING, logger="veneur_tpu_torch.server")
    srv = Server(_small(native_ingest=True, overload_defense_enabled=True,
                        durability_enabled=True, is_global=True,
                        durability_dir=str(tmp_path),
                        metric_max_name_length=64))
    try:
        assert srv.admission is None
        assert srv._engine_journal is None and not srv._recovering
        assert srv.engines[0].histo_keys.bridge is srv.native_bridge
        text = caplog.text
        assert "overload_defense_enabled has no effect" in text
        assert "engine checkpointing disabled" in text
        assert "metric_max_name_length/metric_max_tag_length" in text
    finally:
        srv.stop()


def test_tags_exclude_applies_in_the_cpp_parser():
    cap = CaptureMetricSink()
    srv = Server(_small(native_ingest=True, tags_exclude=["pod"]),
                 sinks=[cap])
    srv.start()
    try:
        _send((srv,), [b"m:1|c|#env:p,pod:a\nm:2|c|#env:p,pod:b",
                       b"m:4|c|#pod:c,env:p\n_sc|chk|1|#pod:x,env:p"])
        rows = _data_rows(_one_flush(srv, cap))
        assert rows[("m", ("env:p",), 0)].value == 7.0
        # a service check keeps its tags (so does the Python path's)
        assert rows[("chk", ("env:p", "pod:x"),
                     int(MetricType.STATUS))].value == 1
        assert len(rows) == 2
    finally:
        srv.stop()


def test_native_ingest_with_forwarding_is_refused():
    for kw in ({"forward_address": "127.0.0.1:1"},
               {"consul_forward_service_name": "veneur-global"}):
        with pytest.raises(NotImplementedError,
                           match="native_ingest with forwarding") as e:
            Server(_small(native_ingest=True, **kw))
        assert "ROADMAP C.11" in str(e.value)


def test_unbuildable_bridge_raises_out_of_the_server(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("VENEUR_TPU_NATIVE_LIB", raising=False)
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "lib.so"))
    with pytest.raises(native.NativeUnavailable, match="source missing"):
        Server(_small(native_ingest=True))


def test_daemon_config_serves_native_ingest():
    """The daemon's YAML turns native ingest on; the server it builds runs
    the bridge with one engine and the pump at native_pump_batch."""
    cfg = read_config(text="native_ingest: true\nnative_pump_batch: 4096\n"
                      "num_workers: 4\naggregation_backend: cpu\n"
                      "tpu_histogram_slots: 256\ntpu_counter_slots: 128\n"
                      "tpu_gauge_slots: 128\ntpu_set_slots: 64\n")
    srv = Server(cfg)
    try:
        assert cfg.native_ingest and len(srv.engines) == 1
        assert srv.native_pump.batch == 4096
        assert srv.native_bridge.capacities == {
            "histo": 256, "counter": 128, "gauge": 128, "set": 64}
    finally:
        srv.stop()
