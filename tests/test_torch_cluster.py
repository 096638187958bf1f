"""The port's cluster tier (veneur_tpu_torch/cluster/) — the flows of
tests/test_cluster.py, the forwarder and two-tier flows of
tests/test_delta_forward.py and the two import-side flows of
tests/test_overload.py, with the port in place of the reference: wire
roundtrips, two in-process port Servers over real loopback gRPC (ticked
by hand), the consistent ring and the proxy fan-out (gRPC and the HTTP
front), the discovering forwarder; the ledger's delta gap check, the
ResilientForwarder's resync scheduling and gap-refusal fallback, the
engine's dirty-aware export build, the two-tier delta and q16 probes
(bit-identity against a zero-fault full-forward oracle fleet) and the
mixed-codec refusal; and the overload defense's import folds against a
port global. Servers and engines run on the CPU (`device="cpu"`)."""

import logging
import random
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from veneur_tpu_torch import observe, sketches
from veneur_tpu_torch.cluster import wire
from veneur_tpu_torch.cluster.discovery import StaticDiscoverer
from veneur_tpu_torch.cluster.forward import GrpcForwarder, HttpJsonForwarder
from veneur_tpu_torch.cluster.importsrv import DedupeLedger
from veneur_tpu_torch.cluster.protos import forward_pb2, metric_pb2
from veneur_tpu_torch.cluster.proxy import ConsistentRing, ProxyServer
from veneur_tpu_torch.config import read_config
from veneur_tpu_torch.ingest.parser import (GLOBAL_ONLY, MetricKey,
                                            UDPMetric, parse_metric)
from veneur_tpu_torch.models.pipeline import (AggregationEngine,
                                              EngineConfig, ForwardExport)
from veneur_tpu_torch.resilience import (BreakerPolicy,
                                         DeltaGapRefusedError, Egress,
                                         EgressPolicy, ResilienceRegistry,
                                         ResilientForwarder, RetryPolicy)
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink
from veneur_tpu_torch.utils.faults import (FakeClock, ScriptedTransport,
                                           seeded_schedule)

def test_wire_roundtrip():
    exp = ForwardExport()
    key = MetricKey("api.lat", "timer", "env:prod,svc:web")
    exp.histograms.append((key, np.array([1.0, 5.0], np.float32),
                           np.array([3.0, 2.0], np.float32),
                           1.0, 5.0, 13.0, 5.0, 3.4))
    exp.sets.append((MetricKey("users", "set", ""),
                     np.arange(1 << 14, dtype=np.uint8) % 16))
    exp.counters.append((MetricKey("hits", "counter", ""), 42.0))
    exp.gauges.append((MetricKey("temp", "gauge", ""), 98.6))
    pbs = wire.export_to_metrics(exp)
    data = forward_pb2.MetricList(
        metrics=pbs).SerializeToString()
    back = forward_pb2.MetricList.FromString(data)
    assert len(back.metrics) == 4
    h = back.metrics[0]
    assert h.name == "api.lat"
    assert wire.metric_key_of(h) == key
    assert len(h.histogram.t_digest.centroids) == 2
    assert h.histogram.t_digest.count == 5.0
    s = back.metrics[1]
    regs = wire.decode_hll(s.set.hyper_log_log)
    assert len(regs) == 1 << 14 and regs[17] == 17 % 16
    assert back.metrics[2].counter.value == 42
    assert back.metrics[3].gauge.value == pytest.approx(98.6)


def _mk_server(extra, sink=None):
    text = """
interval: "3600s"
num_workers: 2
percentiles: [0.5, 0.99]
aggregates: ["min", "max", "count"]
hostname: h
tpu_histogram_slots: 512
tpu_counter_slots: 512
tpu_gauge_slots: 512
tpu_set_slots: 256
tpu_batch_size: 256
tpu_buffer_depth: 128
"""
    cfg = read_config(text=text)
    for k, v in extra.items():
        setattr(cfg, k, v)
    sink = sink or CaptureMetricSink()
    return Server(cfg, sinks=[sink], device="cpu"), sink


def test_two_servers_grpc_forward():
    """local Server --forwardrpc--> global Server, real loopback gRPC,
    flushed by hand: every sample reaches the global in one local
    flush, then one global flush."""
    glob, gsink = _mk_server({"grpc_listen_addresses": ["127.0.0.1:0"]})
    glob.start()
    try:
        gport = glob.grpc_port
        local, lsink = _mk_server({
            "forward_address": f"127.0.0.1:{gport}",
            "statsd_listen_addresses": ["udp://127.0.0.1:0"]})
        local.start()
        try:
            port = local.bound_port()
            c = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            rng = np.random.default_rng(2)
            vals = rng.normal(100, 10, 500)
            for i in range(0, 500, 50):
                c.sendto(b"\n".join(b"fw.lat:%.4f|ms" % v
                                    for v in vals[i:i + 50]),
                         ("127.0.0.1", port))
            c.sendto(b"fw.uniq:a|s\nfw.uniq:b|s\nfw.uniq:c|s",
                     ("127.0.0.1", port))
            c.sendto(b"fw.total:9|c|#veneurglobalonly", ("127.0.0.1", port))
            c.close()
            deadline = time.monotonic() + 25
            while local.packets_received < 12 \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            assert local.packets_received == 12, "datagrams lost"
            assert local.drain(10.0)
            local.flush_once(timestamp=100)
            assert glob.drain(10.0)
            glob.flush_once(timestamp=100)
            assert gsink.wait_for_flush(1) and lsink.wait_for_flush(1)
            names = {m.name: m for m in gsink.all_metrics}
            assert "fw.lat.50percentile" in names, names.keys()
            assert names["fw.lat.50percentile"].value == pytest.approx(
                np.median(vals), abs=3.0)
            assert names["fw.lat.count"].value == 500.0
            assert names["fw.uniq"].value == pytest.approx(3, abs=0.5)
            assert names["fw.total"].value == 9.0
            # local tier emitted aggregates but no percentiles for mixed
            lnames = {m.name for m in lsink.all_metrics}
            assert "fw.lat.count" in lnames
            assert "fw.lat.50percentile" not in lnames
        finally:
            local.stop()
    finally:
        glob.stop()


def test_ring_distribution_and_stability():
    ring = ConsistentRing(["a:1", "b:1", "c:1"])
    keys = [f"metric-{i}".encode() for i in range(3000)]
    before = {k: ring.get(k) for k in keys}
    counts = {}
    for d in before.values():
        counts[d] = counts.get(d, 0) + 1
    assert len(counts) == 3
    assert min(counts.values()) > 500  # roughly balanced
    # removing one destination must only remap its own keys
    ring.set_destinations(["a:1", "b:1"])
    moved = sum(1 for k in keys
                if before[k] != "c:1" and ring.get(k) != before[k])
    assert moved == 0


class _CaptureForwarder:
    instances: dict = {}

    def __init__(self, dest):
        self.dest = dest
        self.got = []
        _CaptureForwarder.instances[dest] = self

    def send_metrics(self, metrics):
        self.got.extend(metrics)


def test_proxy_routes_by_key():
    _CaptureForwarder.instances = {}
    proxy = ProxyServer(StaticDiscoverer(["g1:1", "g2:1", "g3:1"]),
                        forwarder_factory=_CaptureForwarder)
    metrics = []
    for i in range(300):
        m = metric_pb2.Metric(name=f"m{i}", type=metric_pb2.Counter)
        m.counter.value = i
        metrics.append(m)
    errs = proxy.handle_metric_list(forward_pb2.MetricList(metrics=metrics))
    assert not errs
    total = sum(len(f.got) for f in _CaptureForwarder.instances.values())
    assert total == 300
    assert len(_CaptureForwarder.instances) == 3
    # same key always lands on the same destination
    groups1 = proxy.route_metrics(metrics)
    groups2 = proxy.route_metrics(metrics)
    assert {d: [m.name for m in ms] for d, ms in groups1.items()} == \
        {d: [m.name for m in ms] for d, ms in groups2.items()}


def test_proxy_grpc_end_to_end():
    """client -> proxy gRPC -> (captured) destinations."""
    _CaptureForwarder.instances = {}
    proxy = ProxyServer(StaticDiscoverer(["d1:1", "d2:1"]),
                        forwarder_factory=_CaptureForwarder)
    server, port = proxy.start("127.0.0.1:0")
    try:
        fw = GrpcForwarder(f"127.0.0.1:{port}")
        exp = ForwardExport()
        for i in range(20):
            exp.counters.append(
                (MetricKey(f"c{i}", "counter", ""), float(i)))
        fw(exp)
        total = sum(len(f.got) for f in _CaptureForwarder.instances.values())
        assert total == 20
        assert len(_CaptureForwarder.instances) == 2
    finally:
        proxy.stop()


def test_discovering_forwarder_rotates_and_refreshes():
    """consul_forward_service_name path: destinations come from a
    Discoverer, rotate round-robin, and re-resolve after the refresh
    interval (discovery.go / Server.RefreshDestinations)."""
    from veneur_tpu_torch.cluster.discovery import StaticDiscoverer
    from veneur_tpu_torch.cluster.forward import DiscoveringForwarder

    calls = []

    class FakeFwd:
        def __init__(self, dest):
            self.dest = dest

        def __call__(self, export):
            calls.append(self.dest)

    disc = StaticDiscoverer(["a:1", "b:2"])
    fwd = DiscoveringForwarder(disc, "veneur-global",
                               refresh_interval_s=0.0,
                               forwarder_factory=FakeFwd)
    for _ in range(4):
        fwd(None)
    assert calls == ["a:1", "b:2", "a:1", "b:2"]
    disc.destinations = ["c:3"]
    fwd(None)
    assert calls[-1] == "c:3"

    class Flaky:
        def get_destinations_for_service(self, service):
            raise OSError("consul down")

    import pytest

    from veneur_tpu_torch.resilience import TransientEgressError

    fwd2 = DiscoveringForwarder(Flaky(), "svc", refresh_interval_s=0.0,
                                forwarder_factory=FakeFwd)
    # a discovery outage with no known destinations raises (transient)
    # so the server's ResilientForwarder spills the export for re-merge
    # instead of silently dropping the interval
    with pytest.raises(TransientEgressError):
        fwd2(None)
    assert fwd2.errors >= 1


def test_http_proxy_front_distributes_consistently():
    """POST /import batches are split per metric and consistent-hashed
    across destinations on the SAME ring as the gRPC arm (proxy.go sym:
    Proxy.Handler / Proxy.ProxyMetrics)."""
    import json as _json
    import urllib.request

    from veneur_tpu_torch.cluster.discovery import StaticDiscoverer
    from veneur_tpu_torch.cluster.proxy import HttpProxyFront, ProxyServer

    received: dict[str, list] = {"a": [], "b": [], "c": []}

    class FakeDest:
        def __init__(self, dest):
            self.dest = dest

        def send_json(self, dicts):
            received[self.dest].extend(dicts)

    proxy = ProxyServer(StaticDiscoverer(["a", "b", "c"]),
                        refresh_interval_s=3600)
    front = HttpProxyFront(proxy, dest_factory=FakeDest)
    srv, port = front.start("127.0.0.1:0")
    try:
        batch = [{"name": f"m{i}", "type": "counter",
                  "tags": ["env:prod"], "value": i} for i in range(300)]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/import",
            data=_json.dumps(batch).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=5) as resp:
            assert resp.status == 200
        total = sum(len(v) for v in received.values())
        assert total == 300
        # all three destinations get a share, and the split is stable
        assert all(len(v) > 30 for v in received.values())
        first = {d: [m["name"] for m in v] for d, v in received.items()}
        for v in received.values():
            v.clear()
        with urllib.request.urlopen(req, timeout=5):
            pass
        assert {d: [m["name"] for m in v]
                for d, v in received.items()} == first
        # same metric routes to the same place as the gRPC arm's ring
        from veneur_tpu_torch.cluster.proxy import ConsistentRing
        assert isinstance(proxy.ring, ConsistentRing)
        # malformed body -> 400, nothing crashes
        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/import", data=b"{not json",
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            urllib.request.urlopen(bad, timeout=5)
            assert False, "expected HTTP 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400
        assert front.proxied_total == 600
        # declared unknown forward format -> 400 (jsonmetric-v1
        # contract), declared v1 accepted
        for ver, want in (("gob", 400), ("jsonmetric-v1", 200)):
            req_v = urllib.request.Request(
                f"http://127.0.0.1:{port}/import",
                data=_json.dumps(batch[:3]).encode(),
                headers={"Content-Type": "application/json",
                         "X-Veneur-Forward-Version": ver},
                method="POST")
            try:
                with urllib.request.urlopen(req_v, timeout=5) as resp:
                    assert resp.status == want
            except urllib.error.HTTPError as e:
                assert e.code == want
    finally:
        front.stop()
        proxy.stop()


# ======================================================================
# unit: ledger gap check
# ======================================================================


def test_check_delta_unknown_sender_refused_and_counted():
    reg = ResilienceRegistry()
    led = DedupeLedger(registry=reg)
    assert not led.check_delta("ghost", 5)
    assert reg.peek("import", "forward.delta_gap_refused") == 1
    # the refusal must not invent sender state
    assert led.sender_count() == 0


def test_check_delta_contiguous_replay_and_gap():
    reg = ResilienceRegistry()
    led = DedupeLedger(registry=reg)
    assert led.admit("s", 10, 0, 1)
    assert led.check_delta("s", 11)       # next in chain
    assert led.check_delta("s", 10)       # replay — dedupe decides
    assert led.check_delta("s", 3)        # ancient replay likewise
    assert not led.check_delta("s", 12)   # hole at 11
    assert reg.peek("import", "forward.delta_gap_refused") == 1
    assert led.admit("s", 11, 0, 1)
    assert led.check_delta("s", 12)       # chain healed


def test_check_delta_restored_watermark_is_a_baseline():
    led = DedupeLedger(registry=ResilienceRegistry())
    led.restore_watermarks({"s": 7})
    assert led.check_delta("s", 8)
    assert not led.check_delta("s", 9)


# ======================================================================
# unit: resync scheduling + gap fallback at the forwarder
# ======================================================================

def _mk_fwd(inner, **kw):
    kw.setdefault("registry", ResilienceRegistry())
    kw.setdefault("sender_id", "t-sender")
    kw.setdefault("seq_start", 1)
    return ResilientForwarder(inner, destination="t", **kw)


def _export(v=1.0, kind="full"):
    exp = ForwardExport(kind=kind)
    exp.counters.append((MetricKey("d.c", "counter", ""), float(v)))
    return exp


def test_first_interval_full_then_delta_with_periodic_resync():
    sent = []
    fwd = _mk_fwd(lambda export, envelope=None: sent.append(
        (export.kind, envelope.kind)), full_resync_intervals=3)
    assert fwd.next_forward_kind() == "full"    # no receiver baseline
    cadence = []
    for _i in range(7):
        kind = fwd.next_forward_kind()
        cadence.append(kind)
        fwd(_export(kind=kind))
    # resync every 3rd interval: full, delta, delta, FULL, ...
    assert cadence == ["full", "delta", "delta",
                       "full", "delta", "delta", "full"]
    # the envelope kind always matches what the export IS
    assert [e for e, _k in sent] == cadence
    assert [k for _e, k in sent] == cadence


def test_delta_disabled_and_multi_destination_inner_stay_full():
    fwd = _mk_fwd(lambda export, envelope=None: None,
                  delta_enabled=False)
    fwd(_export())
    assert fwd.next_forward_kind() == "full"

    class RotatingInner:
        delta_capable = False

        def __call__(self, export, envelope=None):
            pass

    fwd2 = _mk_fwd(RotatingInner())
    fwd2(_export())
    assert fwd2.next_forward_kind() == "full"   # rotation => no chain


def test_demotion_to_spill_forces_resync():
    calls = []

    def failing(export, envelope=None):
        calls.append(envelope.interval_seq)
        raise TimeoutError("down")

    fwd = _mk_fwd(failing, max_spill_intervals=2,
                  full_resync_intervals=1000)
    fwd._force_full = False         # pretend a full already delivered
    for i in range(2):
        with pytest.raises(TimeoutError):
            fwd(_export(i, kind="delta"))
    assert fwd.next_forward_kind() == "delta"
    with pytest.raises(TimeoutError):
        fwd(_export(3, kind="delta"))   # third park overflows the ladder
    # the demoted interval punched a seq hole: next build must be full
    assert fwd.next_forward_kind() == "full"
    assert fwd.registry.peek("t", "reenveloped") == 1


def test_gap_refusal_spills_payload_and_forces_full_resync():
    """A refused delta is NOT parked (livelock) and NOT lost: it rides
    the next interval, which is forced full; the refusal does not
    raise out of the flush."""
    seen = []
    refuse = {"on": True}

    def inner(export, envelope=None):
        if refuse["on"] and envelope.kind == "delta":
            raise DeltaGapRefusedError("t: no baseline")
        seen.append((envelope.kind, envelope.interval_seq,
                     sorted(k.name for k, _v in export.counters),
                     [v for _k, v in export.counters]))

    fwd = _mk_fwd(inner, full_resync_intervals=1000)
    fwd._force_full = False
    fwd(_export(5.0, kind="delta"))          # refused, silently parked
    assert fwd.pending_spill == 1
    assert fwd.registry.peek("t", "delta_gap_refused") == 1
    assert fwd.registry.peek("t", "delta_gap_fallback") == 1
    assert fwd.next_forward_kind() == "full"
    refuse["on"] = False
    fwd(_export(2.0, kind="full"))           # resync carries the spill
    assert fwd.pending_spill == 0
    (kind, _seq, names, values) = seen[0]
    assert kind == "full" and names == ["d.c", "d.c"]
    # spilled entries PREPEND (chronological: the refused 5.0 is older)
    assert values == [5.0, 2.0]
    assert fwd.next_forward_kind() == "delta"


def test_gap_refusal_during_replay_drains_ladder_without_livelock():
    mode = {"refuse_deltas": True}
    delivered = []

    def inner(export, envelope=None):
        if envelope.kind == "delta" and mode["refuse_deltas"]:
            raise DeltaGapRefusedError("t: gap")
        if mode.get("down"):
            raise TimeoutError("down")
        delivered.append(envelope.kind)

    fwd = _mk_fwd(inner, full_resync_intervals=1000)
    fwd._force_full = False
    mode["refuse_deltas"] = False
    mode["down"] = True
    for i in range(3):                       # park three deltas
        with pytest.raises(TimeoutError):
            fwd(_export(1.0, kind="delta"))
    mode["down"] = False
    mode["refuse_deltas"] = True             # receiver lost its state
    fwd(_export(1.0, kind="delta"))          # replay ladder: all refused
    # every parked delta fell back to the spill tier, none replays
    # forever; the current interval's data is in the spill too. The
    # counter counts SKETCHES (like reenveloped): 3 replayed singles
    # + the current interval's 2 rows after the spill merged into it.
    assert fwd.registry.peek("t", "delta_gap_fallback") == 5
    assert fwd.next_forward_kind() == "full"
    mode["refuse_deltas"] = False
    fwd(_export(1.0, kind="full"))
    assert fwd.pending_spill == 0
    assert delivered == ["full"]             # one resync carried all 5


def test_gap_refusal_with_zero_sketch_budget_does_not_crash():
    """Edge: an export past max_spill_sketches is demoted by _park's
    budget enforcement BEFORE the gap-fallback demotes it — the
    fallback must not pop an empty ladder, and the resync is still
    forced."""
    def inner(export, envelope=None):
        if envelope.kind == "delta":
            raise DeltaGapRefusedError("t: gap")

    fwd = _mk_fwd(inner, max_spill_sketches=0,
                  full_resync_intervals=1000)
    fwd._force_full = False
    fwd(_export(1.0, kind="delta"))     # refused; must not IndexError
    assert fwd.next_forward_kind() == "full"


def test_stray_409_on_a_full_send_stays_on_the_park_path():
    """A 409 from some intermediary on a FULL send is NOT a gap
    refusal (receivers only gap-check deltas): the interval must park
    for exactly-once replay, never spill to the at-least-once tier."""
    import urllib.error

    def transport(req, timeout=None):
        raise urllib.error.HTTPError(req.full_url, 409, "conflict",
                                     {}, None)

    inner = HttpJsonForwarder(
        "http://x", egress=Egress("x", transport=transport,
                                  policy=EgressPolicy(
                                      retry=RetryPolicy(max_attempts=1))))
    fwd = _mk_fwd(inner)
    with pytest.raises(Exception):
        fwd(_export(kind="full"))
    st = fwd.debug_state()
    assert len(st["ladder"]) == 1       # parked, exactly-once
    assert st["spill_sketches"] == 0
    assert fwd.registry.peek("t", "delta_gap_refused") == 0


def test_aged_out_entry_forces_resync():
    """An entry emptied by gauge aging leaves the ladder without ever
    delivering its seq — a chain hole, so the next build must be a
    full resync (else every later delta eats one refusal trip)."""
    fail = {"on": True}

    def inner(export, envelope=None):
        if fail["on"]:
            raise TimeoutError("down")

    fwd = _mk_fwd(inner, gauge_max_age_intervals=1,
                  full_resync_intervals=1000)
    fwd._force_full = False
    exp = ForwardExport(kind="delta")
    exp.gauges.append((MetricKey("d.g", "gauge", ""), 1.0))
    with pytest.raises(TimeoutError):
        fwd(exp)                        # gauges-only interval parks
    for _ in range(2):                  # age past gauge_max_age
        with pytest.raises(TimeoutError):
            fwd(_export(kind="delta"))
    assert all(e.export.gauges == [] or e.seq for e in fwd._entries)
    assert fwd.next_forward_kind() == "full"


def test_replay_entries_pin_their_original_kind():
    kinds = []
    fail = {"on": True}

    def inner(export, envelope=None):
        if fail["on"]:
            raise TimeoutError("down")
        kinds.append(envelope.kind)

    fwd = _mk_fwd(inner, full_resync_intervals=1000)
    with pytest.raises(TimeoutError):
        fwd(_export(kind="full"))
    fail["on"] = False
    fwd(_export(kind="delta"))
    # the replayed first interval re-declares full (its pinned kind),
    # the current one delta
    assert kinds == ["full", "delta"]


# ======================================================================
# unit: dirty-aware export build (third consumer of the bitmap)
# ======================================================================

def _mk_engine(fwd=True, inc=True):
    return AggregationEngine(EngineConfig(
        histogram_slots=128, counter_slots=64, gauge_slots=64,
        set_slots=32, batch_size=128, buffer_depth=32,
        percentiles=(0.5, 0.99), aggregates=("min", "max", "count"),
        forward_enabled=fwd, flush_incremental=inc), device="cpu")


def _touch_counter(eng, name, v=1.0):
    s = eng.counter_keys.lookup(
        MetricKey(name, "counter", ""), GLOBAL_ONLY)
    eng.ingest_counter_batch(np.full(1, s, np.int32),
                             np.full(1, v, np.float32),
                             np.ones(1, np.float32), count=1)


def _touch_set(eng, name, vals):
    for v in vals:
        eng.process(UDPMetric(MetricKey(name, "set", ""), 0, v, 1.0, 0))


def test_delta_export_ships_only_touched_counters_and_sets():
    eng = _mk_engine()
    _touch_counter(eng, "d.a", 2.0)
    _touch_counter(eng, "d.b", 3.0)
    _touch_set(eng, "d.s1", ["u1", "u2"])
    _touch_set(eng, "d.s2", ["u3"])
    res = eng.flush(timestamp=100, forward_kind="full")
    assert res.export.kind == "full"
    assert sorted(k.name for k, _v in res.export.counters) == \
        ["d.a", "d.b"]

    # interval 2: only d.a and d.s1 touched
    _touch_counter(eng, "d.a", 5.0)
    _touch_set(eng, "d.s1", ["u9"])
    res2 = eng.flush(timestamp=101, forward_kind="delta")
    assert res2.export.kind == "delta"
    assert [k.name for k, _v in res2.export.counters] == ["d.a"]
    assert [k.name for k, _r in res2.export.sets] == ["d.s1"]
    assert res2.stats["forward_kind"] == "delta"

    # interval 3, full resync: idle keys ship again (zeros / empties)
    _touch_counter(eng, "d.a", 1.0)
    res3 = eng.flush(timestamp=102, forward_kind="full")
    assert sorted(k.name for k, _v in res3.export.counters) == \
        ["d.a", "d.b"]
    vals = {k.name: v for k, v in res3.export.counters}
    assert vals["d.b"] == 0.0
    assert sorted(k.name for k, _r in res3.export.sets) == \
        ["d.s1", "d.s2"]


def test_delta_request_degrades_to_full_without_dirty_tracking():
    eng = _mk_engine(inc=False)     # no bitmap, tracking never armed
    _touch_counter(eng, "d.a", 2.0)
    res = eng.flush(timestamp=100, forward_kind="delta")
    assert res.export.kind == "full"
    assert res.stats["forward_kind"] == "full"


def test_full_resync_fills_the_wire_never_the_local_frame():
    """The kind changes the WIRE only: a full resync ships idle
    global-only keys' zero rows upstream, but the local frame stays
    touched-keys-only under either kind, and a GLOBAL_ONLY key never
    leaks into the local frame through the resync table."""
    eng = _mk_engine()
    s = eng.counter_keys.lookup(MetricKey("d.mixed", "counter", ""), 0)
    eng.ingest_counter_batch(np.full(1, s, np.int32),
                             np.full(1, 4.0, np.float32),
                             np.ones(1, np.float32), count=1)
    _touch_counter(eng, "d.glob", 2.0)
    res1 = eng.flush(timestamp=100, forward_kind="full")
    assert [m.name for m in res1.metrics] == ["d.mixed"]
    assert [(k.name, v) for k, v in res1.export.counters] == \
        [("d.glob", 2.0)]
    # interval 2: NOTHING touched. A delta ships nothing; a full
    # resync ships the idle global-only key's ZERO row — and neither
    # puts anything in the local frame (frame rows are touched-only
    # by design, the kind never changes local flush output).
    res2 = eng.flush(timestamp=101, forward_kind="delta")
    assert res2.export.counters == [] and res2.metrics == []
    res3 = eng.flush(timestamp=102, forward_kind="full")
    assert [(k.name, v) for k, v in res3.export.counters] == \
        [("d.glob", 0.0)]
    assert res3.metrics == []


# ======================================================================
# unit: per-flush stamp hoist (HttpJsonForwarder satellite)
# ======================================================================

def test_http_forwarder_computes_stamp_headers_once_per_flush():
    sent = []

    def transport(req, timeout=None):
        sent.append(req)

        class R:
            status = 200

            def read(self):
                return b"{}"

            def close(self):
                pass
        return R()

    fwd = HttpJsonForwarder(
        "http://x", max_per_body=1,
        egress=Egress("x", transport=transport,
                      policy=EgressPolicy(
                          retry=RetryPolicy(max_attempts=1))),
        engine_stamp="h=tdigest/1,s=hll/1")
    calls = []
    orig = fwd._flush_headers
    fwd._flush_headers = lambda: (calls.append(1) or orig())
    exp = ForwardExport()
    for i in range(3):
        exp.counters.append((MetricKey(f"c{i}", "counter", ""), 1.0))
    fwd(exp)
    assert len(sent) == 3           # three chunks on the wire...
    assert len(calls) == 1          # ...ONE stamp-header computation
    for req in sent:                # every chunk still carries it
        assert req.headers.get("X-veneur-sketch-engines") \
            == "h=tdigest/1,s=hll/1"


# ======================================================================
# unit: config knob validation
# ======================================================================

def test_config_knob_validation():
    assert read_config(text="forward_delta: false").forward_delta \
        is False
    cfg = read_config(text="forward_centroid_codec: q16")
    assert cfg.forward_centroid_codec == "q16"
    with pytest.raises(ValueError):
        read_config(text="forward_centroid_codec: zstd")
    with pytest.raises(ValueError):
        read_config(text="forward_full_resync_intervals: 0")


# ======================================================================
# two-tier probes (real UDP -> local Server -> scripted HTTP egress
# whose deliver= does REAL POSTs into a real global Server)
# ======================================================================

_DELTA_YAML = """
interval: "3600s"
num_workers: 1
percentiles: [0.5, 0.99]
aggregates: ["min", "max", "count"]
hostname: h
tpu_histogram_slots: 512
tpu_counter_slots: 512
tpu_gauge_slots: 512
tpu_set_slots: 256
tpu_batch_size: 256
tpu_buffer_depth: 256
"""


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mk_delta_global(reg, port, codec="lossless"):
    cfg = read_config(text=_DELTA_YAML)
    cfg.http_address = f"127.0.0.1:{port}"
    cfg.is_global = True
    cfg.forward_centroid_codec = codec
    srv = Server(cfg, sinks=[CaptureMetricSink()], plugins=[],
                 device="cpu")
    srv.dedupe_ledger = DedupeLedger(registry=reg)
    srv.start()
    return srv


def _mk_delta_local(forwarder):
    cfg = read_config(text=_DELTA_YAML)
    cfg.statsd_listen_addresses = ["udp://127.0.0.1:0"]
    cfg.forward_address = "placeholder:1"
    srv = Server(cfg, sinks=[CaptureMetricSink()], plugins=[],
                 device="cpu", forwarder=forwarder)
    srv.start()
    return srv


def _delta_round_lines(r: int, rng: np.random.Generator) -> bytes:
    """Round traffic with a real idle set: 4 always-touched timers and
    one always-touched global counter; 8 global counters and 2 sets
    touched ONLY in round 0 (what delta forwarding leaves home)."""
    lines = []
    for k in range(4):
        for v in rng.normal(100 + 10 * k, 5, 5):
            lines.append(b"dl.t%d:%.4f|ms" % (k, v))
    lines.append(b"dl.hot:%d|c|#veneurglobalonly" % (r + 1))
    if r == 0:
        for k in range(8):
            lines.append(b"dl.idle%d:5|c|#veneurglobalonly" % k)
        for k in range(2):
            for u in range(4):
                lines.append(b"dl.set%d:u%d|s" % (k, u))
    return b"\n".join(lines)


def _flushed(srv, ts):
    return sorted((m.name, tuple(m.tags), str(m.type), m.value)
                  for m in srv.flush_once(timestamp=ts)
                  if not m.name.startswith("veneur."))


class _RoundTransport:
    def __init__(self):
        self.current = None

    def __call__(self, req, timeout=None):
        return self.current(req, timeout=timeout)


def _run_fleet(schedules, *, delta: bool, restart_global_before=None,
               codec="lossless", seed=7):
    """Drive the two-tier topology over len(schedules) rounds; flush
    the global after round `restart_global_before - 1`, hard-replace
    it (fresh ledger — the gap-refusal trigger), and again at the
    end. Returns (flush outputs, receiver registry, forwarder)."""
    reg = ResilienceRegistry()
    gport = _free_port()
    glob = _mk_delta_global(reg, gport, codec=codec)
    clock = FakeClock()
    rt = _RoundTransport()
    egress = Egress(
        "delta-global",
        policy=EgressPolicy(
            retry=RetryPolicy(max_attempts=3, base_backoff_s=0.001,
                              max_backoff_s=0.002, deadline_s=120.0),
            breaker=BreakerPolicy(failure_threshold=10_000)),
        transport=rt, clock=clock, sleep=clock.sleep,
        rng=random.Random(42), registry=reg)
    stamp = sketches.stamp_with_codec(sketches.DEFAULT_STAMP, codec)
    inner = HttpJsonForwarder(f"http://127.0.0.1:{gport}",
                              timeout_s=5.0, max_per_body=3,
                              egress=egress, engine_stamp=stamp,
                              centroid_codec=codec)

    def deliver(req):
        return urllib.request.urlopen(req, timeout=5)

    fwd = ResilientForwarder(inner, destination="delta-global",
                             sender_id="delta-sender", registry=reg,
                             delta_enabled=delta,
                             full_resync_intervals=1000)
    local = _mk_delta_local(fwd)
    outputs = []
    try:
        port = local.bound_port()
        c = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rng = np.random.default_rng(seed)
        for r, schedule in enumerate(schedules):
            if restart_global_before == r:
                assert glob.drain(10.0)
                outputs.append(_flushed(glob, 5000))
                glob.stop()
                glob = _mk_delta_global(reg, gport, codec=codec)
            rt.current = ScriptedTransport(schedule, clock,
                                           deliver=deliver)
            c.sendto(_delta_round_lines(r, rng), ("127.0.0.1", port))
            deadline = time.monotonic() + 10
            while local.packets_received < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert local.packets_received >= 1, "datagram lost"
            assert local.drain(10.0)
            local.flush_once(timestamp=1000 + r)
            clock.advance(10.0)
        c.close()
        assert glob.drain(10.0)
        outputs.append(_flushed(glob, 9999))
        dups = reg.peek("import", "forward.duplicates_dropped")
        pending = fwd.pending_spill
    finally:
        local.stop()
        glob.stop()
    return outputs, reg, fwd, dups, pending


_DELTA_SCHEDULES = [
    ["ok"],                                 # full baseline (seq 1)
    ["ack_lost", "ok"],                     # ambiguous, deduped
    [503, 503, "ok"],                       # clean retry ladder
    ["ok"],
    # -- receiver hard-restart happens here (fresh ledger) --
    ["ok", "ok"],                           # delta REFUSED (409), then
                                            # nothing: fallback spills
    ["ok"],                                 # forced full resync
    seeded_schedule(201, 8, p_fail=0.6, ambiguous=True),
    seeded_schedule(202, 8, p_fail=0.6, ambiguous=True),
    ["ok"],
    ["ok"],
]


def test_two_tier_delta_bit_identical_to_full_oracle():
    """THE delta acceptance probe: the chaos-storm delta fleet's
    global state equals a zero-fault full-forward oracle fleet's at
    both flush boundaries, bit-exactly, with the gap -> refusal ->
    full-resync path demonstrably exercised and duplicates deduped."""
    outs, reg, fwd, dups, pending = _run_fleet(
        _DELTA_SCHEDULES, delta=True, restart_global_before=4)
    oracle_outs, _oreg, _ofwd, odups, opending = _run_fleet(
        [["ok"]] * len(_DELTA_SCHEDULES), delta=False,
        restart_global_before=4)
    assert pending == 0 and opending == 0
    # the machinery actually fired
    assert reg.peek("import", "forward.delta_gap_refused") >= 1
    assert reg.peek("delta-global", "delta_gap_fallback") >= 1
    assert dups > 0 and odups == 0
    # bytes accounting: both kinds seen on the wire, and the registry
    # totals are live for /debug/fleet
    assert reg.total("delta-global", "forward.bytes_delta") > 0
    assert reg.total("delta-global", "forward.bytes_full") > 0
    # THE criterion: both flush boundaries bit-identical, no approx
    assert outs[0] == oracle_outs[0]
    assert outs[1] == oracle_outs[1]
    names = {n for n, _t, _ty, _v in outs[1]}
    assert "dl.hot" in names
    assert any(n.startswith("dl.idle") for n in names), \
        "full resync must re-ship idle keys to the restarted global"


def test_two_tier_quantized_within_one_percent_of_oracle():
    """q16 fleet (both ends stamped h=tdigest/1q): percentile rows
    within 1% of the lossless oracle fleet; counter totals and
    histogram counts/min/max EXACT (quantization never touches the
    scalar fields)."""
    scheds = [["ok"]] * 5
    q_outs, *_rest = _run_fleet(scheds, delta=True, codec="q16")
    l_outs, *_rest2 = _run_fleet(scheds, delta=True, codec="lossless")
    (q_final,) = q_outs
    (l_final,) = l_outs
    assert [row[:3] for row in q_final] == [row[:3] for row in l_final]
    for (name, tags, typ, qv), (_n2, _t2, _ty2, lv) in zip(q_final,
                                                           l_final):
        if (name.endswith("percentile") or name.endswith(".min")
                or name.endswith(".max")):
            if lv == 0.0:
                assert abs(qv) < 1e-6
            else:
                assert abs(qv - lv) / abs(lv) <= 0.01, \
                    f"{name}: {qv} vs {lv}"
        else:
            # counter sums, counts, set estimates: exact
            assert qv == lv, f"{name}: {qv} vs {lv}"


def test_mixed_codec_fleet_refused_before_decode():
    """A q16 sender against a lossless receiver is rejected (400 at
    /import, counted veneur.import.engine_mismatch_total) and nothing
    is applied — packed rows must never be misread as empty lossless
    centroid lists."""
    from veneur_tpu_torch import resilience as res
    before = res.DEFAULT_REGISTRY.total("import",
                                        "import.engine_mismatch")
    reg = ResilienceRegistry()
    gport = _free_port()
    glob = _mk_delta_global(reg, gport, codec="lossless")
    clock = FakeClock()
    rt = _RoundTransport()
    egress = Egress("mixed-global",
                    policy=EgressPolicy(
                        retry=RetryPolicy(max_attempts=1,
                                          deadline_s=30.0),
                        breaker=BreakerPolicy(failure_threshold=100)),
                    transport=rt, clock=clock, sleep=clock.sleep,
                    rng=random.Random(1), registry=reg)
    inner = HttpJsonForwarder(
        f"http://127.0.0.1:{gport}", timeout_s=5.0, egress=egress,
        engine_stamp=sketches.stamp_with_codec(
            sketches.DEFAULT_STAMP, "q16"),
        centroid_codec="q16")

    def deliver(req):
        return urllib.request.urlopen(req, timeout=5)

    rt.current = ScriptedTransport(["ok"], clock, deliver=deliver)
    fwd = ResilientForwarder(inner, destination="mixed-global",
                             sender_id="mixed-sender", registry=reg)
    exp = ForwardExport()
    exp.histograms.append(
        (MetricKey("mx.t", "timer", ""), np.float32([1.0, 2.0]),
         np.float32([1.0, 1.0]), 1.0, 2.0, 3.0, 2.0, 1.5))
    try:
        with pytest.raises(Exception):
            fwd(exp)                 # 400 (terminal) -> parked
        assert fwd.pending_spill > 0
        assert res.DEFAULT_REGISTRY.total(
            "import", "import.engine_mismatch") > before
        assert glob.drain(5.0)
        names = {m.name for m in glob.flush_once(timestamp=999)}
        assert not any(n.startswith("mx.") for n in names)
    finally:
        glob.stop()
        # the mismatch counter lives in the PROCESS-global registry
        # (that is the point: one fleet page); compensate this test's
        # contribution so later suites asserting a pristine
        # mismatch_rejects == 0 (test_sketches' two-tier probe) stay
        # order-independent
        after = res.DEFAULT_REGISTRY.total("import",
                                           "import.engine_mismatch")
        if after > before:
            res.DEFAULT_REGISTRY.incr("import", "import.engine_mismatch",
                                      before - after)


# ======================================================================
# delta-aware proxy guard
# ======================================================================
#
# A proxy fanning ONE sender out to MULTIPLE globals re-shards the
# per-sender seq chain: each receiver sees only its ring share's seqs,
# every other seq reads as a gap, and the gap check refuses each delta
# — a refusal/resync livelock. The proxy therefore DEMOTES the delta
# marker to full on a multi-destination ring (the payload is a
# full-fidelity touched-key subset; the marker only arms the gap
# belt-check), warns once per sender, and counts
# veneur.proxy.delta_demoted_total. Single-destination rings pass the
# marker through untouched.


class _RecordingFwd:
    sent: list = []

    def __init__(self, dest):
        self.dest = dest

    def send_metrics(self, metrics, envelope=None, **kw):
        _RecordingFwd.sent.append((self.dest, envelope))


def _proxy_with(dests):
    from veneur_tpu_torch.cluster.discovery import StaticDiscoverer
    from veneur_tpu_torch.cluster.proxy import ProxyServer
    _RecordingFwd.sent = []
    return ProxyServer(StaticDiscoverer(dests),
                       forwarder_factory=_RecordingFwd)


def _delta_list(n=40, sender="snd-dd"):
    from veneur_tpu_torch.cluster import wire
    from veneur_tpu_torch.cluster.protos import forward_pb2, metric_pb2
    ms = [metric_pb2.Metric(name=f"dd.m{i}", type=metric_pb2.Counter,
                            counter=metric_pb2.CounterValue(value=1))
          for i in range(n)]
    return forward_pb2.MetricList(
        metrics=ms, envelope=wire.envelope_pb(sender, 7, 0, 1,
                                              kind="delta"))


def test_proxy_demotes_delta_on_multi_destination_ring(caplog):
    import logging as _logging

    from veneur_tpu_torch.resilience import DEFAULT_REGISTRY
    base = DEFAULT_REGISTRY.total("proxy", "proxy.delta_demoted")
    proxy = _proxy_with(["g1:1", "g2:1"])
    with caplog.at_level(_logging.WARNING,
                         logger="veneur_tpu_torch.cluster.proxy"):
        assert proxy.handle_metric_list(_delta_list()) == []
        assert proxy.handle_metric_list(_delta_list()) == []
    assert len(_RecordingFwd.sent) >= 3   # both rounds fanned out
    for _dest, env in _RecordingFwd.sent:
        assert env is not None
        assert env.forward_kind == 0      # demoted to full
        assert env.sender_id == "snd-dd"  # rest of the envelope intact
        assert env.interval_seq == 7
    assert DEFAULT_REGISTRY.total(
        "proxy", "proxy.delta_demoted") == base + 2
    warned = [r for r in caplog.records if "demoted" in r.message]
    assert len(warned) == 1               # once per sender, not per batch


def test_proxy_passes_delta_through_on_single_destination():
    from veneur_tpu_torch.resilience import DEFAULT_REGISTRY
    base = DEFAULT_REGISTRY.total("proxy", "proxy.delta_demoted")
    proxy = _proxy_with(["only:1"])
    assert proxy.handle_metric_list(_delta_list(sender="snd-one")) == []
    assert len(_RecordingFwd.sent) == 1
    _dest, env = _RecordingFwd.sent[0]
    assert env.forward_kind == 1          # delta marker untouched
    assert DEFAULT_REGISTRY.total(
        "proxy", "proxy.delta_demoted") == base


def test_http_proxy_front_demotes_delta_kind_header():
    import json as _json

    from veneur_tpu_torch.cluster import wire
    from veneur_tpu_torch.cluster.proxy import HttpProxyFront

    seen = []

    class FakeDest:
        def __init__(self, dest):
            pass

        def send_json(self, dicts, envelope=None):
            seen.append(envelope)

    proxy = _proxy_with(["h1:1", "h2:1"])
    front = HttpProxyFront(proxy, dest_factory=FakeDest)
    srv, port = front.start("127.0.0.1:0")
    try:
        headers = {"Content-Type": "application/json",
                   "X-Veneur-Forward-Version": "jsonmetric-v1"}
        headers.update(wire.envelope_headers("snd-h", 9, 0, 1,
                                             kind="delta"))
        assert wire.FORWARD_KIND_HEADER in headers
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/import",
            data=_json.dumps([{"name": "m", "type": "counter",
                               "tags": [], "value": 1}]).encode(),
            headers=headers, method="POST")
        with urllib.request.urlopen(req, timeout=5) as resp:
            assert resp.status == 200
        assert len(seen) == 1
        env = seen[0]
        # kind header dropped (absent == full); envelope ids intact
        assert wire.forward_kind_from_headers(env) == wire.KIND_FULL
        assert wire.envelope_from_headers(env) == ("snd-h", 9, 0, 1)
    finally:
        srv.shutdown()


# ======================================================================
# overload defense: the import-side folds against a port global
# ======================================================================

S = observe.SERVER_SCOPE

_OVERLOAD_CFG = """
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


def _overload_server(extra: str = "", defense: bool = True) -> tuple:
    text = _OVERLOAD_CFG
    if defense:
        text += "overload_defense_enabled: true\n"
    cfg = read_config(text=text + extra)
    cap = CaptureMetricSink()
    srv = Server(cfg, sinks=[cap], plugins=[], span_sinks=[],
                 device="cpu")
    srv.start()
    return srv, cap


def test_multi_worker_import_folds_are_single_homed():
    """The global tier with num_workers > 1: an over-budget FORWARDED
    key whose fold target homes on another engine raises out of
    import_* and the worker loop re-routes the rewritten aggregate —
    one flush, one `<prefix>.__other__` row, exact folded total."""
    from veneur_tpu_torch.cluster.forward import HttpJsonForwarder

    glob, gcap = _overload_server("overload_max_keys_per_prefix: 2\n"
                         "num_workers: 2\n"
                         "http_address: \"127.0.0.1:0\"\n"
                         "is_global: true\n")
    try:
        assert len(glob.engines) == 2
        fwd = HttpJsonForwarder(
            f"http://127.0.0.1:{glob.http_api.port}")
        loc = Server(
            read_config(text=_OVERLOAD_CFG
                        + "forward_address: \"placeholder:1\"\n"),
            sinks=[CaptureMetricSink()], plugins=[], span_sinks=[],
            device="cpu")
        loc.forwarder = fwd
        # feed engines synchronously (worker threads not started)
        for k in range(12):
            m = parse_metric(
                b"imp.c%d:%d|c|#veneurglobalonly" % (k, k + 1))
            loc.engines[m.digest % len(loc.engines)].process(m)
        loc.flush_once(timestamp=50)     # real POST /import
        assert glob.drain(20.0)
        glob.flush_once(timestamp=100)
        assert gcap.wait_for_flush()

        other = [m for m in gcap.all_metrics
                 if m.name == "imp.__other__"]
        assert len(other) == 1
        kept = [m for m in gcap.all_metrics
                if m.name.startswith("imp.c")]
        assert len(kept) == 2
        # exact conservation: sum 1..12 split between kept and folded
        assert sum(m.value for m in kept) + other[0].value == 78.0
        assert glob.telemetry.total(S, "overload.folded_samples") == 10
        holders = [eng for eng in glob.engines
                   if any(k.name == "imp.__other__"
                          for k in eng.counter_keys._map)]
        assert len(holders) == 1
    finally:
        glob.stop()


def test_local_only_folds_never_forward():
    """veneurlocalonly's contract survives the fold: on a forwarding
    server an over-budget LOCAL_ONLY sample folds into the prefix's
    `.local` twin key (LOCAL_ONLY, flushed fully locally), NOT into
    the GLOBAL_ONLY `__other__` that rides to the global tier — a
    local-only value must never leave the host, and it must not share
    a fold slot with forwarded folds (a slot's scope is per-key, so
    one LOCAL_ONLY sample would retroactively rescope every sample
    already folded there)."""
    from veneur_tpu_torch.cluster.forward import HttpJsonForwarder

    glob, gcap = _overload_server("http_address: \"127.0.0.1:0\"\n"
                         "is_global: true\n", defense=False)
    try:
        fwd = HttpJsonForwarder(
            f"http://127.0.0.1:{glob.http_api.port}")
        lcap = CaptureMetricSink()
        loc = Server(
            read_config(text=_OVERLOAD_CFG
                        + "overload_defense_enabled: true\n"
                        + "overload_max_keys_per_prefix: 1\n"
                        + "forward_address: \"placeholder:1\"\n"),
            sinks=[lcap], plugins=[], span_sinks=[], device="cpu")
        loc.forwarder = fwd
        # feed engines synchronously (worker threads not started)
        for line in (b"p.a:1|c",                        # mints (budget 1)
                     b"p.secret:5|c|#veneurlocalonly",  # folds -> .local
                     b"p.m:3|c"):                       # folds -> global
            m = parse_metric(line)
            loc.engines[m.digest % len(loc.engines)].process(m)
        loc.flush_once(timestamp=50)     # real POST /import
        assert glob.drain(20.0)
        glob.flush_once(timestamp=100)
        assert gcap.wait_for_flush()
        assert lcap.wait_for_flush()

        # the local-only value flushed fully locally, tagless
        lo = [m for m in lcap.all_metrics
              if m.name == "p.__other__.local"]
        assert len(lo) == 1 and lo[0].value == 5.0 and lo[0].tags == []
        # ... and never reached the global tier under ANY name
        gvals = {m.name: m.value for m in gcap.all_metrics}
        assert not any("local" in n for n in gvals)
        # the MIXED fold rescoped GLOBAL_ONLY and merged at the global
        assert gvals["p.__other__"] == 3.0
        # it did NOT also flush locally (no duplicate series fleet-wide)
        assert not any(m.name == "p.__other__" for m in lcap.all_metrics)
        assert loc.telemetry.total(S, "overload.folded_samples") == 2
    finally:
        glob.stop()


# ======================================================================
# the proxy CLI, Consul discovery and a proxied port fleet
# ======================================================================

def test_proxy_cli_static_config(tmp_path):
    from veneur_tpu_torch.cli import proxy as proxy_cli

    # happy path: static destinations, Go-style refresh duration
    proxy = proxy_cli.proxy_from_config({
        "grpc_address": "127.0.0.1:0",
        "forward_destinations": ["127.0.0.1:9999", "127.0.0.1:9998"],
        "consul_refresh_interval": "1m",
    })
    try:
        assert len(proxy.ring) == 2
        assert proxy.ring.get(b"some.metric|c|") in (
            "127.0.0.1:9998", "127.0.0.1:9999")
        assert proxy.refresh_interval_s == 60.0
        assert proxy.grpc_port > 0
    finally:
        proxy.stop()
    # config missing both discovery modes errors out
    bad = tmp_path / "bad.yaml"
    bad.write_text("grpc_address: '127.0.0.1:0'\n")
    assert proxy_cli.main(["-f", str(bad)]) == 1


def _free_tcp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_proxy_cli_subprocess_routes_to_a_port_global(tmp_path):
    """`python3 -m veneur_tpu_torch.cli.proxy -f <yaml>` in a process of
    its own: a gRPC forward through it lands on the port global its
    static destination names; SIGTERM stops it with exit 0."""
    import os
    import signal
    import subprocess
    import sys

    glob, gsink = _mk_server({"grpc_listen_addresses": ["127.0.0.1:0"]})
    glob.start()
    pport = _free_tcp_port()
    cfg = tmp_path / "proxy.yaml"
    cfg.write_text(f"grpc_address: '127.0.0.1:{pport}'\n"
                   f"forward_destinations: ['127.0.0.1:{glob.grpc_port}']\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "veneur_tpu_torch.cli.proxy", "-f",
         str(cfg)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:             # until the proxy process listens
            try:
                socket.create_connection(("127.0.0.1", pport), 1).close()
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()[1]
                assert time.monotonic() < deadline, "proxy never listened"
                time.sleep(0.1)
        fw = GrpcForwarder(f"127.0.0.1:{pport}")
        exp = ForwardExport()
        exp.counters.append((MetricKey("via.proxy", "counter", ""), 7.0))
        fw(exp)
        fw.close()
        assert glob.drain(10.0)
        out = {m.name: m.value for m in glob.flush_once(timestamp=10)}
        assert out["via.proxy"] == 7.0
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            _out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        glob.stop()
    assert proc.returncode == 0, err


def test_consul_discoverer_reads_passing_instances():
    """ConsulDiscoverer against a local fake Consul health endpoint:
    service address (or the node's) and port of each passing instance,
    fetched through the resilience layer."""
    import http.server
    import json as _json
    import threading

    from veneur_tpu_torch.cluster.discovery import ConsulDiscoverer

    seen = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen.append(self.path)
            body = _json.dumps([
                {"Service": {"Address": "10.0.0.1", "Port": 8128}},
                {"Node": {"Address": "10.0.0.2"},
                 "Service": {"Address": "", "Port": 8129}},
                {"Service": {"Address": "10.0.0.3"}},   # no port: skipped
            ]).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        disc = ConsulDiscoverer(f"http://127.0.0.1:{httpd.server_port}/")
        assert disc.get_destinations_for_service("veneur-global") == \
            ["10.0.0.1:8128", "10.0.0.2:8129"]
        assert seen == ["/v1/health/service/veneur-global?passing"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_server_builds_a_discovering_forwarder_for_consul():
    from veneur_tpu_torch.cluster.forward import DiscoveringForwarder

    srv, _sink = _mk_server({
        "consul_forward_service_name": "veneur-global",
        "consul_refresh_interval": "45s",
        "statsd_listen_addresses": []})
    try:
        assert isinstance(srv.forwarder, ResilientForwarder)
        inner = srv.forwarder.inner
        assert isinstance(inner, DiscoveringForwarder)
        assert inner.service == "veneur-global"
        assert inner.refresh_interval_s == 45.0
        assert srv.forwarder.destination == "veneur-global"
        assert all(e.cfg.forward_enabled for e in srv.engines)
    finally:
        srv.stop()


def test_proxied_fleet_lands_each_key_on_its_ring_global():
    """Two port locals -> a port ProxyServer -> two port globals, all
    over real loopback gRPC: every forwarded key gets a row on exactly
    the global its ring hash names, and the summed counters are exact."""
    globs = [_mk_server({"grpc_listen_addresses": ["127.0.0.1:0"],
                         "num_workers": 1}) for _ in range(2)]
    for g, _s in globs:
        g.start()
    dests = [f"127.0.0.1:{g.grpc_port}" for g, _s in globs]
    proxy = ProxyServer(StaticDiscoverer(dests), refresh_interval_s=3600)
    _server, pport = proxy.start("127.0.0.1:0")
    locals_ = []
    try:
        for _ in range(2):
            loc, _s = _mk_server({
                "forward_address": f"127.0.0.1:{pport}",
                "statsd_listen_addresses": ["udp://127.0.0.1:0"]})
            loc.start()
            locals_.append(loc)
        for i, loc in enumerate(locals_):
            lines = [b"px.c%d:%d|c|#veneurglobalonly" % (k, k + i)
                     for k in range(40)]
            lines += [b"px.t%d:%d|ms" % (k, 10 * k + i) for k in range(20)]
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as c:
                c.sendto(b"\n".join(lines), ("127.0.0.1", loc.bound_port()))
            deadline = time.monotonic() + 20
            while loc.packets_received < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert loc.drain(10.0)
            loc.flush_once(timestamp=100)
            assert loc.forwarder.pending_spill == 0
        rows = []
        for g, _s in globs:
            assert g.drain(10.0)
            rows.append({m.name: m.value for m in g.flush_once(
                timestamp=100) if m.name.startswith("px.")})
        for k in range(40):
            name = f"px.c{k}"
            owner = dests.index(proxy.ring.get(
                f"{name}counter".encode()))
            assert name in rows[owner] and name not in rows[1 - owner]
            assert rows[owner][name] == float(2 * k + 1)
        for k in range(20):
            name = f"px.t{k}"
            owner = dests.index(proxy.ring.get(f"{name}timer".encode()))
            assert rows[owner][f"{name}.count"] == 2.0
            assert f"{name}.count" not in rows[1 - owner]
        assert all(rows)             # both globals got a share
    finally:
        for loc in locals_:
            loc.stop()
        proxy.stop()
        for g, _s in globs:
            g.stop()
