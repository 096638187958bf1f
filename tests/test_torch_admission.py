"""The port's overload defense against the reference's (ROADMAP item 9b).

`AdmissionController` parity: two controllers, the reference's and the
port's, each seeded with its own `random.Random` of one seed, run one
scripted sequence of admit_key / release_key / fold_metric /
admit_packet / on_tick and must give equal verdicts, fold rewrites,
debug_state and sketches. Then the reference's storm flows
(tests/test_overload.py) against a port server over real loopback UDP,
and last the storm datagrams into a reference server and a port server:
equal rows and equal `veneur.overload.*` counters.

The reference's import-fold flows (an over-budget forwarded key folding
on a global tier) wait for the port's global tier, ROADMAP item 10.
"""

import json
import random
import socket
import time
import urllib.request

import pytest

from veneur_tpu import observe as jobserve
from veneur_tpu.config import read_config as jread_config
from veneur_tpu.ingest import admission as jadm
from veneur_tpu.ingest import parser as jparser
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks.basic import CaptureMetricSink as JCapture
from veneur_tpu_torch import observe
from veneur_tpu_torch.config import read_config
from veneur_tpu_torch.ingest import admission as tadm
from veneur_tpu_torch.ingest import parser as tparser
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink

from test_torch_server import _clear_process_registries, _compare, _rows

S = observe.SERVER_SCOPE


# ---------------- the controller ----------------

def _fold_fields(m):
    if m is None:
        return None
    return (m.key.name, m.key.type, m.key.joined_tags, m.digest, m.value,
            m.sample_rate, m.scope, m.tags)


def _script(mod, parser, obs):
    """One scripted run of a controller; returns every verdict, fold,
    tick delta and state, in order."""
    reg = obs.TelemetryRegistry()
    adm = mod.AdmissionController(
        registry=reg, max_keys_per_prefix=5, max_prefixes=4,
        fold_sample_rate=0.5, min_sample_rate=0.2, sketch_buckets=64,
        estimator_window_intervals=3, rng=random.Random(1234))
    out = []
    keys = [parser.MetricKey(f"p{k % 6}.m{k}", ("counter", "timer",
                                                "gauge", "set")[k % 4],
                             "t:1" if k % 3 else "")
            for k in range(120)]
    for i, key in enumerate(keys):
        v = adm.admit_key(key)
        out.append(("admit", i, v))
        if i % 7 == 0 and v:
            adm.release_key(key)
            out.append(("release", i))
        if v is None:
            for scope in (parser.MIXED_SCOPE, parser.LOCAL_ONLY):
                m = parser.UDPMetric(key=key, digest=i, value=float(i),
                                     sample_rate=0.5, scope=scope,
                                     tags=["t:1"])
                for fwd in (False, True):
                    out.append(("fold", i, scope, fwd,
                                _fold_fields(adm.fold_metric(m, fwd))))
            fk, digest = adm.fold_key(key)
            out.append(("fold_key", i, fk.name, fk.type, fk.joined_tags,
                        digest))
        if i % 13 == 12:
            # an overloaded tick (overrun), then packets under the shed
            out.append(("tick", adm.on_tick(10.0, 1.0, 0.0)))
            out.append(("packets", [adm.admit_packet() for _ in range(50)]))
        if i % 29 == 28:
            out.append(("tick", adm.on_tick(0.0, 1.0, 0.1)))
            adm.count_folded(3)
    out.append(("state", adm.debug_state(top=50)))
    out.append(("sketches", adm.export_sketches()))
    out.append(("prefixes", adm.prefix_count(), adm.engaged,
                adm.shed_rate))
    return out


def test_controller_parity_under_one_seed():
    got = _script(tadm, tparser, observe)
    want = _script(jadm, jparser, jobserve)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (g, w)
    # the script reaches every verdict
    kinds = {g[0] for g in got}
    assert {"admit", "release", "fold", "tick", "packets"} <= kinds
    assert any(g[0] == "fold" and g[-1] is None for g in got)
    assert any(g[0] == "packets" and None in g[1] for g in got)


@pytest.mark.parametrize("m,n", [(16, 5), (64, 300), (256, 20000),
                                 (1024, 100000)])
def test_huffman_bucket_estimates_equal(m, n):
    rng = random.Random(m + n)
    ts, js = tadm.HuffmanBucketSketch(m), jadm.HuffmanBucketSketch(m)
    for _ in range(n):
        h = rng.getrandbits(64)
        assert ts.update(h) == js.update(h)
    assert bytes(ts.regs) == bytes(js.regs)
    assert ts.estimate() == pytest.approx(js.estimate(), rel=1e-12)
    assert tadm.estimate_registers(bytes(ts.regs)) == pytest.approx(
        jadm.estimate_registers(bytes(js.regs)), rel=1e-12)
    other_t, other_j = tadm.HuffmanBucketSketch(m), \
        jadm.HuffmanBucketSketch(m)
    for _ in range(50):
        h = rng.getrandbits(64)
        other_t.update(h)
        other_j.update(h)
    ts.merge(other_t)
    js.merge(other_j)
    assert bytes(ts.regs) == bytes(js.regs)
    with pytest.raises(ValueError):
        tadm.HuffmanBucketSketch(m + 1)


def test_from_config_reads_the_overload_keys():
    text = ("overload_defense_enabled: true\n"
            "overload_max_keys_per_prefix: 7\n"
            "overload_max_prefixes: 9\n"
            "overload_fold_sample_rate: 0.5\n"
            "overload_sketch_buckets: 128\n")
    t = tadm.from_config(read_config(text=text), observe.TelemetryRegistry())
    j = jadm.from_config(jread_config(text=text),
                         jobserve.TelemetryRegistry())
    for attr in ("max_keys_per_prefix", "max_prefixes", "fold_sample_rate",
                 "min_sample_rate", "tick_overrun_ratio",
                 "queue_high_watermark", "estimator_window", "_sketch_m",
                 "_sep", "_suffix"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert tadm.RATE_CORRECTED_TYPES == jadm.RATE_CORRECTED_TYPES


# ---------------- the reference's storm flows, on a port server --------

_BASE_CFG = """
interval: "3600s"
hostname: h
statsd_listen_addresses: ["udp://127.0.0.1:0"]
flush_phase_timers: false
aggregates: ["min", "max", "count"]
percentiles: [0.5, 0.75, 0.99]
tpu_histogram_slots: 512
tpu_counter_slots: 512
tpu_gauge_slots: 128
tpu_set_slots: 64
tpu_batch_size: 8192
tpu_buffer_depth: 256
"""


def _server(extra: str = "", defense: bool = True) -> tuple:
    text = _BASE_CFG + "aggregation_backend: cpu\n"
    if defense:
        text += "overload_defense_enabled: true\n"
    cap = CaptureMetricSink()
    srv = Server(read_config(text=text + extra), sinks=[cap], plugins=[],
                 span_sinks=[])
    srv.start()
    return srv, cap


def _send(srv, lines, already=0):
    """One datagram per line, in bursts of 200 each settled through the
    packet counter (so the socket's buffer never overflows), then
    drain()."""
    port = srv.bound_port()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        for i in range(0, len(lines), 200):
            for ln in lines[i:i + 200]:
                sock.sendto(ln, ("127.0.0.1", port))
            want = already + min(i + 200, len(lines))
            deadline = time.monotonic() + 20
            while (srv.telemetry.total(S, "packet.received") < want
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            assert srv.telemetry.total(S, "packet.received") == want, \
                "UDP datagrams lost in the kernel; cannot assert accounting"
        assert srv.drain(20.0)
    return len(lines)


def _assert_identity(srv, lines_sent):
    """received == applied + counted_degraded, every term a registry
    total (one line per datagram)."""
    tel = srv.telemetry
    applied = tel.total(S, "samples.processed")
    degraded = (tel.total(S, "overload.fold_sampled_out")
                + tel.total(S, "overload.shed_packets")
                + tel.total(S, "worker.dropped")
                + tel.total(S, "packet.error"))
    assert tel.total(S, "samples.dropped_no_slot") == 0
    assert lines_sent == applied + degraded, (lines_sent, applied, degraded)


def _in_budget_lines():
    lines = []
    for k in range(4):
        for v in range(32):
            lines.append(b"app.t%d:%s|ms"
                         % (k, str(k * 3 + v * 0.25).encode()))
    for k in range(2):
        for _ in range(8):
            lines.append(b"app.c%d:%d|c" % (k, k + 1))
    return lines


def _tenant_values(cap, prefix="app."):
    return {(m.name, tuple(m.tags)): m.value
            for m in cap.all_metrics if m.name.startswith(prefix)}


def _oracle():
    srv, cap = _server()
    try:
        _send(srv, _in_budget_lines())
        srv.flush_once(timestamp=100)
        assert cap.wait_for_flush()
        return _tenant_values(cap)
    finally:
        srv.stop()


def test_storm_cardinality_explosion():
    oracle = _oracle()
    srv, cap = _server("overload_max_keys_per_prefix: 8\n")
    try:
        n = _send(srv, _in_budget_lines())
        storm = [b"bad.u%d:1|c|#req:%d" % (k, k) for k in range(300)]
        n += _send(srv, storm, already=n)
        srv.flush_once(timestamp=100)
        assert cap.wait_for_flush()
        eng = srv.engines[0]
        bad_keys = [k for k in eng.counter_keys._map
                    if k.name.startswith("bad.")]
        assert len(bad_keys) == 8 + 1
        assert len(eng.counter_keys) <= 2 + 8 + 1
        assert srv.admission.prefix_count() <= 2
        assert len(srv.telemetry.debug_state()["counters"]) < 40
        _assert_identity(srv, n)
        folded = srv.telemetry.total(S, "overload.folded_samples")
        assert folded == 300 - 8
        assert srv.telemetry.total(S, "overload.keys_over_budget") > 0
        other = [m for m in cap.all_metrics if m.name == "bad.__other__"]
        assert len(other) == 1 and other[0].value == float(folded)
        assert other[0].tags == []
        assert _tenant_values(cap) == oracle
        st = srv.admission.debug_state()
        rows = {r["prefix"]: r for r in st["prefixes"]}
        assert rows["bad"]["over_budget"]
        assert rows["bad"]["estimated_keys"] > 8 * 10
        assert not rows["app"]["over_budget"]
    finally:
        srv.stop()


def test_storm_hot_key_skew():
    oracle = _oracle()
    srv, cap = _server("overload_max_keys_per_prefix: 8\n")
    try:
        n = _send(srv, _in_budget_lines())
        n += _send(srv, [b"hotkey.h:%d|ms" % (v % 97) for v in range(3000)],
                   already=n)
        srv.flush_once(timestamp=100)
        assert cap.wait_for_flush()
        assert len(srv.engines[0].histo_keys) == 4 + 1
        _assert_identity(srv, n)
        for name in ("overload.folded_samples", "overload.shed_packets",
                     "overload.fold_sampled_out"):
            assert srv.telemetry.total(S, name) == 0
        by_name = {m.name: m for m in cap.all_metrics}
        assert by_name["hotkey.h.count"].value == 3000.0
        assert by_name["hotkey.h.max"].value == 96.0
        assert _tenant_values(cap) == oracle
    finally:
        srv.stop()


def test_storm_sustained_over_capacity():
    srv, cap = _server("overload_tick_overrun_ratio: 0.000001\n"
                       "overload_min_sample_rate: 0.25\n")
    try:
        srv.admission._rng = random.Random(42)
        n = _send(srv, [b"cap.c:1|c"] * 200)
        srv.flush_once(timestamp=100)
        assert cap.wait_for_flush(1)
        assert srv.admission.shed_rate == 0.5 and srv.admission.engaged
        assert srv.health_state()["checks"]["overload"] == {
            "ok": False, "shed_rate": 0.5}
        n += _send(srv, [b"cap.c:1|c"] * 400, already=n)
        shed = srv.telemetry.total(S, "overload.shed_packets")
        assert shed > 0
        srv.flush_once(timestamp=200)
        assert cap.wait_for_flush(2)
        assert srv.admission.shed_rate == 0.25
        _assert_identity(srv, n)
        survivors = 400 - shed
        totals = [m.value for m in cap.all_metrics if m.name == "cap.c"]
        assert totals == [200.0, 2.0 * survivors]
        gauges = [m for m in cap.flushes[1]
                  if m.name == "veneur.overload.adaptive_sample_rate"]
        assert gauges and gauges[0].value == 0.5
        shed_rows = [m for m in cap.flushes[1]
                     if m.name == "veneur.overload.shed_packets_total"]
        assert shed_rows and shed_rows[0].value == shed
        names = [p[0] for p in srv.flight.last_tick().phases()]
        assert "overload" in names and "overload.shed" in names
        for _ in range(10):
            srv.admission.on_tick(0.0, 3600.0, 0.0)
            if srv.admission.shed_rate == 1.0:
                break
        assert srv.admission.shed_rate == 1.0 and not srv.admission.engaged
        assert srv.health_state()["checks"]["overload"]["ok"]
    finally:
        srv.stop()


def test_defense_off_is_a_regression_pinned_noop():
    srv, cap = _server(defense=False)
    try:
        assert srv.admission is None
        n = _send(srv, [b"bad.u%d:1|c" % k for k in range(300)])
        srv.flush_once(timestamp=100)
        assert cap.wait_for_flush()
        assert len(srv.engines[0].counter_keys) == 300
        assert not any(m.name.endswith("__other__")
                       for m in cap.all_metrics)
        assert not any(m.name.startswith("veneur.overload.")
                       for m in cap.all_metrics)
        assert srv.telemetry.total(S, "samples.processed") == n
        assert srv._debug_flush_state()["admission"] == {"enabled": False}
        assert "overload" not in srv.health_state()["checks"]
        assert srv._fleet_cardinality() == {}
    finally:
        srv.stop()


def test_debug_flush_exposes_admission_state():
    srv, cap = _server("overload_max_keys_per_prefix: 4\n"
                       "http_address: \"127.0.0.1:0\"\n")
    try:
        _send(srv, [b"dbg.u%d:1|c" % k for k in range(40)])
        srv.flush_once(timestamp=100)
        base = f"http://127.0.0.1:{srv.http_api.port}"
        with urllib.request.urlopen(base + "/debug/flush",
                                    timeout=10) as resp:
            state = json.loads(resp.read())
        adm = state["admission"]
        assert adm["enabled"] is True
        assert adm["max_keys_per_prefix"] == 4
        assert adm["adaptive_sample_rate"] == 1.0
        rows = {r["prefix"]: r for r in adm["prefixes"]}
        assert rows["dbg"]["admitted"] == 4
        assert rows["dbg"]["over_budget"] is True
        assert rows["dbg"]["estimated_keys"] > 4
        assert adm["counters"]["folded_samples"] == 36
        assert adm["counters"]["shed_packets"] == 0
        assert "flight_recorder" in state and "forward" in state
        with urllib.request.urlopen(base + "/debug/fleet",
                                    timeout=10) as resp:
            fleet = json.loads(resp.read())
        assert fleet["fleet_cardinality"]["dbg"] == \
            rows["dbg"]["estimated_keys"]
    finally:
        srv.stop()


def test_multi_worker_folds_are_single_homed():
    oracle = _oracle()
    srv, cap = _server("overload_max_keys_per_prefix: 8\n"
                       "num_workers: 4\n")
    try:
        assert len(srv.engines) == 4
        n = _send(srv, _in_budget_lines())
        n += _send(srv, [b"bad.u%d:1|c" % k for k in range(300)],
                   already=n)
        srv.flush_once(timestamp=100)
        assert cap.wait_for_flush()
        _assert_identity(srv, n)
        folded = srv.telemetry.total(S, "overload.folded_samples")
        assert folded == 300 - 8
        other = [m for m in cap.all_metrics if m.name == "bad.__other__"]
        assert len(other) == 1 and other[0].value == float(folded)
        assert sum(m.value for m in cap.all_metrics
                   if m.name.startswith("bad.")) == 300.0
        holders = [eng for eng in srv.engines
                   if any(k.name == "bad.__other__"
                          for k in eng.counter_keys._map)]
        assert len(holders) == 1
        assert _tenant_values(cap) == oracle
    finally:
        srv.stop()


@pytest.mark.parametrize("kind", ["counter", "timer", "gauge", "set"])
def test_engine_folds_every_bank(kind):
    """An over-budget key of each bank lands in its prefix's typed
    `__other__` key, counted as folded; a sampled-out fold is neither
    processed nor folded."""
    from veneur_tpu_torch.models.pipeline import (AggregationEngine,
                                                  EngineConfig)
    eng = AggregationEngine(EngineConfig(
        histogram_slots=64, counter_slots=64, gauge_slots=64,
        set_slots=32, batch_size=64, percentiles=(0.5,),
        aggregates=("count",)), device="cpu")
    reg = observe.TelemetryRegistry()
    eng.attach_admission(tadm.AdmissionController(
        registry=reg, max_keys_per_prefix=2))
    suffix = {"counter": "c", "timer": "ms", "gauge": "g", "set": "s"}[kind]
    for k in range(6):
        eng.process(tparser.parse_packet(
            b"f.k%d:%d|%s" % (k, k + 1, suffix.encode())))
    res = eng.flush(timestamp=1)
    names = {m.name for m in res.metrics}
    assert {n for n in names if n.startswith("f.k")} <= {
        n for n in names if n.startswith(("f.k0", "f.k1"))}
    assert any(n.startswith("f.__other__") for n in names)
    assert reg.total(S, "overload.folded_samples") == 4
    assert res.stats["samples"] == 6


# ---------------- the storm into both servers ----------------

# one worker: which keys of an over-budget prefix mint a slot follows
# their arrival order at the controller, which two workers would race
DIFF_CFG = _BASE_CFG.replace("flush_phase_timers: false\n", "") + \
    "overload_defense_enabled: true\noverload_max_keys_per_prefix: 16\n"


def test_storm_rows_and_counters_equal_the_references():
    """The storm datagrams (a tenant, a unique-tag explosion over every
    type, a hot key) into a reference server and a port server with
    overload_fold_sample_rate 1.0: equal rows under the contract, and
    equal veneur.overload.* counters, flush after flush."""
    jcap, tcap = JCapture(), CaptureMetricSink()
    jsrv = JServer(jread_config(text=DIFF_CFG), sinks=[jcap])
    tsrv = Server(read_config(text=DIFF_CFG + "aggregation_backend: cpu\n"),
                  sinks=[tcap])
    _clear_process_registries()
    for srv in (jsrv, tsrv):
        assert srv.admission.fold_sample_rate == 1.0
        srv.start()
    try:
        lines = _in_budget_lines()
        lines += [b"bad.u%d:%d|c|#req:%d" % (k, k % 5 + 1, k)
                  for k in range(200)]
        lines += [b"slow.t%d:%d|ms" % (k, k % 37) for k in range(120)]
        lines += [b"temp.g%d:%d|g" % (k, k) for k in range(60)]
        lines += [b"who.s%d:u%d|s" % (k % 40, k) for k in range(200)]
        lines += [b"hot.h:%d|ms" % (v % 97) for v in range(500)]
        for n in (1, 2):
            for srv in (jsrv, tsrv):
                _send(srv, lines,
                      already=srv.telemetry.total(S, "packet.received"))
            for srv, cap in ((jsrv, jcap), (tsrv, tcap)):
                assert srv.drain()
                srv.flush_once(timestamp=100 * n)
                assert cap.wait_for_flush(n)
                for t in list(srv._sink_inflight.values()):
                    t.join(30)
            jrows = _rows(jcap.flushes[n - 1])
            trows = _rows(tcap.flushes[n - 1])
            _compare(jrows, trows, n, sets=("who.",))
            for key in jrows:
                if key[0].startswith("veneur.overload."):
                    assert trows[key].value == jrows[key].value, key
            assert trows[("bad.__other__", (), 0)].value == \
                jrows[("bad.__other__", (), 0)].value
        for name in ("overload.folded_samples", "overload.keys_over_budget",
                     "overload.fold_sampled_out", "overload.shed_packets"):
            assert tsrv.telemetry.total(S, name) == \
                jsrv.telemetry.total(jobserve.SERVER_SCOPE, name), name
        assert tsrv.admission.debug_state() == jsrv.admission.debug_state()
    finally:
        jsrv.stop()
        tsrv.stop()
