"""A port Server over the multi-device engine (`tpu_num_devices > 1`,
ROADMAP item 14) on the CPU, against the reference's mesh server.

The reference's mesh runs on the 8 virtual XLA host devices
tests/conftest.py pins; the port's on eight "cpu" shards of one device
(Server wiring: shard i on cuda:(i mod cards), or the CPU). The gate
holds the two servers' rows under test_torch_server.py's contract over
real UDP. Then the mesh engine's fetch modes against the reference's
under the same mode, a port local forwarding over gRPC to a port mesh
global, native ingest with a mesh (served where the reference serves
it, refused where the reference's start() fails) and the engine
checkpoint refused with the reference's warning. One reference Server
start.
"""

import logging
import socket
import time

import numpy as np
import pytest

from test_torch_server import (GATE_YAML, COUNTERS,
                               _clear_process_registries, _compare,
                               _datagrams, _flush, _lines, _rows, _send)
from veneur_tpu.config import read_config as jread_config
from veneur_tpu.ingest import parser as jparser
from veneur_tpu.models.pipeline import EngineConfig as JEngineConfig
from veneur_tpu.parallel.engine import (
    MeshAggregationEngine as JMeshAggregationEngine)
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks.basic import CaptureMetricSink as JCapture
from veneur_tpu_torch.config import Config, read_config
from veneur_tpu_torch.ingest import parser as tparser
from veneur_tpu_torch.models.pipeline import EngineConfig as TEngineConfig
from veneur_tpu_torch.parallel.engine import MeshAggregationEngine
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink

MESH_YAML = GATE_YAML + "tpu_num_devices: 8\n"


def test_mesh_server_gate_flushes_the_reference_rows():
    """Two intervals of every metric type over real UDP into a reference
    mesh server and a port mesh server (1 x 8 shards each), then an empty
    one: equal read-only counters, equal row-key sets, rows under the
    gate's contract, and the events."""
    jcfg = jread_config(text=MESH_YAML)
    tcfg = read_config(text=MESH_YAML + "aggregation_backend: cpu\n")
    jcap, tcap = JCapture(), CaptureMetricSink()
    jsrv = JServer(jcfg, sinks=[jcap])
    tsrv = Server(tcfg, sinks=[tcap])
    assert type(jsrv.engines[0]).__name__ == "MeshAggregationEngine"
    assert type(tsrv.engines[0]).__name__ == "MeshAggregationEngine"
    assert len(tsrv.engines) == 1 and tsrv.device.type == "cpu"
    assert tsrv.engines[0].me.mesh.shape == {"dp": 1, "shard": 8}
    _clear_process_registries()
    jsrv.start()
    tsrv.start()
    rng = np.random.default_rng(12)
    try:
        for n, (tag, n_lines) in enumerate((("one", 1200), ("two", 800),
                                            (None, 0)), start=1):
            if tag is not None:
                _send((jsrv, tsrv), _datagrams(rng, _lines(rng, n_lines,
                                                           tag)))
            assert jsrv.drain() and tsrv.drain()
            counts = [{c: getattr(srv, c) for c in COUNTERS}
                      for srv in (jsrv, tsrv)]
            assert counts[1] == counts[0], (n, counts)
            ts = 2000 + 10 * n
            jrows = _rows(_flush(jsrv, jcap, ts, n))
            trows = _rows(_flush(tsrv, tcap, ts, n))
            if tag is not None:
                assert any(k[0].startswith("gate.lat.") for k in trows)
            _compare(jrows, trows, n)
        assert len(tcap.events) == len(jcap.events) == 2
    finally:
        jsrv.stop()
        tsrv.stop()


FETCH_CFG = dict(histogram_slots=64, counter_slots=32, gauge_slots=32,
                 set_slots=16, buffer_depth=32, batch_size=256,
                 percentiles=(0.5, 0.9), aggregates=("min", "max", "count"))


def _fetch_rows(eng, parse):
    rng = np.random.default_rng(11)
    for k in range(8):
        for x in rng.gamma(2.0, 20.0, 30):
            eng.process(parse(f"t{k}:{x:.4f}|ms".encode()))
    eng.process(parse(b"c:3|c"))
    return {m.name: m.value for m in eng.flush(timestamp=5).metrics}


@pytest.mark.parametrize("mode", ["staged", "async", "host"])
def test_mesh_flush_fetch_modes(mode):
    """The mesh flush under a non-sync fetch mode flushes the port's sync
    rows (rtol 1e-6, as the reference's test holds its own) and the
    reference's rows under the same mode (percentiles within 1% of the
    key's spread, the rest exact); "host" is "staged" on the mesh, as in
    the reference."""
    def build(m):
        eng = MeshAggregationEngine(TEngineConfig(**FETCH_CFG,
                                                  flush_fetch=m),
                                    devices=["cpu"] * 8)
        eng.warmup()
        return eng
    eng = build(mode)
    assert eng._fetch_mode == ("staged" if mode == "host" else mode)
    got = _fetch_rows(eng, tparser.parse_packet)
    ref = _fetch_rows(build("sync"), tparser.parse_packet)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    jeng = JMeshAggregationEngine(JEngineConfig(**FETCH_CFG,
                                                flush_fetch=mode),
                                  n_devices=8)
    jeng.warmup()
    want = _fetch_rows(jeng, jparser.parse_packet)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k.endswith("percentile"):
            base = k.rsplit(".", 1)[0]
            spread = want[base + ".max"] - want[base + ".min"]
            assert abs(got[k] - w) <= 0.01 * spread, k
        else:
            assert got[k] == w, k


def _cpu_server(extra, sink):
    cfg = Config(aggregation_backend="cpu", interval="3600s",
                 hostname="h", percentiles=[0.5, 0.99],
                 aggregates=["min", "max", "count"],
                 tpu_histogram_slots=512, tpu_counter_slots=512,
                 tpu_gauge_slots=512, tpu_set_slots=256,
                 tpu_batch_size=256, tpu_buffer_depth=128)
    for k, v in extra.items():
        setattr(cfg, k, v)
    return Server(cfg, sinks=[sink])


def test_two_servers_grpc_forward_to_mesh_global():
    """A port local forwards over real loopback gRPC to a port GLOBAL
    whose engine is sharded 1 x 8 (the counterpart of
    tests/test_cluster.py's mesh global): count, counter and the set
    exact, the median within the t-digest contract of numpy's."""
    gsink, lsink = CaptureMetricSink(), CaptureMetricSink()
    glob = _cpu_server({"grpc_listen_addresses": ["127.0.0.1:0"],
                        "tpu_num_devices": 8}, gsink)
    assert type(glob.engines[0]).__name__ == "MeshAggregationEngine"
    glob.start()
    try:
        local = _cpu_server({
            "forward_address": f"127.0.0.1:{glob.grpc_port}",
            "statsd_listen_addresses": ["udp://127.0.0.1:0"]}, lsink)
        local.start()
        try:
            port = local.bound_port()
            rng = np.random.default_rng(6)
            vals = np.round(rng.normal(100, 10, 400), 4)
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as c:
                for i in range(0, 400, 50):
                    c.sendto(b"\n".join(b"mg.lat:%.4f|ms" % v
                                        for v in vals[i:i + 50]),
                             ("127.0.0.1", port))
                c.sendto(b"mg.uniq:x|s\nmg.uniq:y|s", ("127.0.0.1", port))
                c.sendto(b"mg.total:4|c|#veneurglobalonly",
                         ("127.0.0.1", port))
            deadline = time.monotonic() + 30
            while local.packets_received < 10 \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            assert local.packets_received == 10, "datagrams lost"
            assert local.drain(10.0)
            local.flush_once(timestamp=100)
            assert glob.drain(10.0)
            glob.flush_once(timestamp=100)
            assert gsink.wait_for_flush(1)
            names = {m.name: m.value for m in gsink.all_metrics}
            v32 = vals.astype(np.float32).astype(np.float64)
            assert names["mg.lat.count"] == 400.0
            assert names["mg.lat.min"] == v32.min()
            assert names["mg.lat.max"] == v32.max()
            med = np.quantile(v32, 0.5, method="hazen")
            assert abs(names["mg.lat.50percentile"] - med) \
                <= 0.01 * np.ptp(v32)
            assert names["mg.uniq"] == pytest.approx(2, abs=0.5)
            assert names["mg.total"] == 4.0
        finally:
            local.stop()
    finally:
        glob.stop()


def test_native_ingest_with_a_mesh():
    """The reference serves native_ingest with a mesh when the pump's
    batch is the engine's, and raises AttributeError out of start()
    otherwise: the port serves the first (exact rows out of the C++
    bridge) and refuses the second at construction (ROADMAP C.15)."""
    cap = CaptureMetricSink()
    srv = _cpu_server({"native_ingest": True, "tpu_num_devices": 2,
                       "native_pump_batch": 256,
                       "statsd_listen_addresses": ["udp://127.0.0.1:0"]},
                      cap)
    assert type(srv.engines[0]).__name__ == "MeshAggregationEngine"
    srv.start()
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for i in range(50):
                s.sendto(b"n.ms:%d|ms" % i, ("127.0.0.1", srv.bound_port()))
            s.sendto(b"n.c:5|c\nn.s:abc|s", ("127.0.0.1", srv.bound_port()))
        deadline = time.monotonic() + 30
        while srv.native_bridge.stats()["lines"] < 52 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.drain(10)
        srv.flush_once(timestamp=5)
        assert cap.wait_for_flush(1)
        by = {m.name: m.value for m in cap.all_metrics
              if m.name.startswith("n.")}
        assert by["n.ms.count"] == 50.0 and by["n.ms.max"] == 49.0
        assert by["n.ms.min"] == 0.0 and by["n.c"] == 5.0
        assert by["n.s"] == pytest.approx(1, abs=0.01)
    finally:
        srv.stop()
    with pytest.raises(NotImplementedError, match="C.15"):
        _cpu_server({"native_ingest": True, "tpu_num_devices": 2},
                    CaptureMetricSink())


def test_engine_snapshot_is_disabled_with_a_mesh(tmp_path, caplog):
    """durability_engine_snapshot on a mesh global logs the reference's
    warning and takes no engine journal (the mesh keeps no dirty
    bitmaps); the server still flushes its imports."""
    with caplog.at_level(logging.WARNING):
        srv = _cpu_server({"is_global": True, "tpu_num_devices": 4,
                           "durability_enabled": True,
                           "durability_dir": str(tmp_path)},
                          CaptureMetricSink())
    try:
        assert srv._engine_journal is None
        assert any("mesh" in r.getMessage()
                   and "engine checkpointing disabled" in r.getMessage()
                   for r in caplog.records)
    finally:
        srv.stop()
