"""The exactly-once forward contract on the port (veneur_tpu_torch/cluster/,
veneur_tpu_torch/resilience.py) — tests/test_exactly_once.py with the
port in place of the reference: the idempotency envelope on both wire
formats (encode AND decode arms mirrored), the receiver-side dedupe
ledger and its bounds, the poison-pill import guard, and the graceful
importsrv shutdown; servers run on the CPU (`device="cpu"`). Then the
port's DedupeLedger against the reference's on the same admit stream."""

import numpy as np
import pytest

from veneur_tpu_torch.cluster import wire
from veneur_tpu_torch.cluster.forward import (GrpcForwarder, HttpJsonForwarder)
from veneur_tpu_torch.cluster.importsrv import (DedupeLedger, ForwardHandler,
                                          ImportedMetric,
                                          stop_import_server)
from veneur_tpu_torch.cluster.protos import forward_pb2, metric_pb2
from veneur_tpu_torch.ingest.parser import MetricKey
from veneur_tpu_torch.models.pipeline import ForwardExport
from veneur_tpu_torch.resilience import (Egress, ForwardEnvelope,
                                   PartialDeliveryError,
                                   ResilienceRegistry,
                                   ResilientForwarder, accepts_envelope)
from veneur_tpu_torch.utils.faults import FaultHarness


@pytest.fixture
def fault_harness():
    """The port's harness (tests/conftest.py's fixture builds the
    reference's)."""
    return FaultHarness(seed=0)


def export_of(n_counters=0, histos=0):
    exp = ForwardExport()
    for i in range(n_counters):
        exp.counters.append((MetricKey(f"c{i}", "counter", ""), 1.0))
    for i in range(histos):
        exp.histograms.append(
            (MetricKey(f"h{i}", "timer", ""),
             np.ones(2, np.float32), np.ones(2, np.float32),
             0.0, 1.0, 2.0, 2.0, 0.0))
    return exp


# ------------------------------------------------------------ envelope

class TestEnvelopeEncodeDecodeParity:
    """The CI-gate satellite: envelope fields must be mirrored between
    the encode (forwarder stamping) and decode (importsrv / HTTP
    import) paths of BOTH contracts — a field added or renamed on one
    side only fails here, not silently on the wire."""

    def test_grpc_send_metrics_arm_roundtrips(self, fault_harness):
        """GrpcForwarder stamps MetricList.envelope; the importsrv
        decode helper must read back identical fields, chunk by
        chunk."""
        h = fault_harness
        sent = []
        fwd = GrpcForwarder("127.0.0.1:1", max_per_batch=2,
                            egress=h.egress("g"))
        fwd._send = lambda req, timeout=None: sent.append(req)
        env = ForwardEnvelope("sender-a", 7)
        fwd(export_of(n_counters=5), envelope=env)
        assert len(sent) == 3
        decoded = [wire.envelope_from_metric_list(req) for req in sent]
        assert decoded == [("sender-a", 7, 0, 3),
                           ("sender-a", 7, 1, 3),
                           ("sender-a", 7, 2, 3)]

    def test_grpc_partial_tail_replays_same_chunk_ids(self,
                                                     fault_harness):
        """After chunk 1 of 3 fails, the replay of the tail must carry
        chunk ids 1 and 2 of the ORIGINAL count — not restart at 0."""
        h = fault_harness
        sent = []

        def send(req, timeout=None):
            if len(sent) == 1:      # second chunk dies terminally
                from veneur_tpu_torch.resilience import TerminalEgressError
                raise TerminalEgressError("boom")
            sent.append(req)

        fwd = GrpcForwarder("127.0.0.1:1", max_per_batch=2,
                            egress=h.egress("g"))
        fwd._send = send
        env = ForwardEnvelope("s", 9)
        with pytest.raises(PartialDeliveryError) as ei:
            fwd(export_of(n_counters=5), envelope=env)
        assert ei.value.delivered_chunks == 1
        assert ei.value.chunk_count == 3
        # replay the tail under the resumed envelope
        fwd2 = GrpcForwarder("127.0.0.1:1", max_per_batch=2,
                             egress=h.egress("g2"))
        fwd2._send = lambda req, timeout=None: sent.append(req)
        fwd2(ei.value.undelivered,
             envelope=ForwardEnvelope("s", 9, chunk_offset=1,
                                      chunk_count=3))
        decoded = [wire.envelope_from_metric_list(req) for req in sent]
        assert decoded == [("s", 9, 0, 3), ("s", 9, 1, 3),
                           ("s", 9, 2, 3)]
        # the tail bodies cover exactly the undelivered metrics
        names = [m.name for req in sent[1:] for m in req.metrics]
        assert names == ["c2", "c3", "c4"]

    def test_http_jsonmetric_arm_roundtrips(self, fault_harness):
        """HttpJsonForwarder stamps the X-Veneur-* headers; the HTTP
        import side decodes through wire.envelope_from_headers — same
        tuple, chunk by chunk."""
        from veneur_tpu_torch.utils.faults import _FakeResponse

        h = fault_harness
        reqs = []

        def transport(req, timeout=None):
            reqs.append(req)
            return _FakeResponse(200)

        eg = h.egress("http", transport=transport)
        fwd = HttpJsonForwarder("http://x", max_per_body=2, egress=eg)
        fwd(export_of(n_counters=3),
            envelope=ForwardEnvelope("sender-h", 12))
        assert len(reqs) == 2
        decoded = [wire.envelope_from_headers(r.headers) for r in reqs]
        assert decoded == [("sender-h", 12, 0, 2), ("sender-h", 12, 1, 2)]

    def test_send_metrics_v2_arm_roundtrips(self):
        """The streaming arm has no request message to carry the
        envelope: it rides as the veneur-envelope-bin metadata header
        (a serialized forwardrpc.Envelope). Encode with the wire
        helper, decode with the matching one."""
        md = [("user-agent", "x"),
              (wire.ENVELOPE_METADATA_KEY,
               wire.envelope_pb("s2", 4, 1, 2).SerializeToString())]
        assert wire.envelope_from_metadata(md) == ("s2", 4, 1, 2)
        assert wire.envelope_from_metadata([("other", b"x")]) is None
        assert wire.envelope_from_metadata(None) is None

    def test_header_decode_rejects_malformed(self):
        assert wire.envelope_from_headers({}) is None
        with pytest.raises(ValueError):
            wire.envelope_from_headers(
                {wire.ENVELOPE_SENDER_HEADER: "s"})
        with pytest.raises(ValueError):
            wire.envelope_from_headers(
                {wire.ENVELOPE_SENDER_HEADER: "s",
                 wire.ENVELOPE_SEQ_HEADER: "nan",
                 wire.ENVELOPE_CHUNK_HEADER: "0/1"})

    def test_trace_context_parity_all_three_arms(self):
        """The fleet-trace context (trace_id, span_id,
        close_ns) rides alongside the envelope on all three carriers —
        MetricList.envelope fields 5-7, the serialized-Envelope V2
        metadata, and the X-Veneur-Trace-* headers — with every codec
        mirrored in wire.py. Zeros encode to NOTHING (legacy byte
        parity) and malformed context decodes to None, never an error
        (trace loss must not cost an interval)."""
        # pb arm
        e = wire.envelope_pb("s", 1, 0, 1, trace_id=11, span_id=22,
                             close_ns=33)
        ml = forward_pb2.MetricList(envelope=e)
        assert wire.trace_from_metric_list(ml) == (11, 22, 33)
        assert wire.envelope_from_metric_list(ml) == ("s", 1, 0, 1)
        plain = forward_pb2.MetricList(
            envelope=wire.envelope_pb("s", 1, 0, 1))
        assert wire.trace_from_metric_list(plain) is None
        # V2 metadata arm (shares the envelope's carrier)
        md = [(wire.ENVELOPE_METADATA_KEY, e.SerializeToString())]
        assert wire.trace_from_metadata(md) == (11, 22, 33)
        assert wire.trace_from_metadata(None) is None
        assert wire.trace_from_metadata(
            [(wire.ENVELOPE_METADATA_KEY, b"\xff\xfe garbage")]) is None
        # header arm
        hs = wire.envelope_headers("s", 1, 0, 1, trace_id=11,
                                   span_id=22, close_ns=33)
        assert wire.trace_from_headers(hs) == (11, 22, 33)
        assert wire.envelope_from_headers(hs) == ("s", 1, 0, 1)
        # zero trace -> byte-identical legacy header set
        assert wire.envelope_headers("s", 1, 0, 1) == \
            wire.envelope_headers("s", 1, 0, 1, trace_id=0, span_id=0,
                                  close_ns=0)
        # tolerant decode: malformed trace is dropped, envelope intact
        bad = dict(hs)
        bad[wire.TRACE_HEADER] = "not-a-trace"
        assert wire.trace_from_headers(bad) is None
        assert wire.envelope_from_headers(bad) == ("s", 1, 0, 1)
        assert wire.trace_from_headers({}) is None
        # zero trace_id = "no context" on the header arm too (pb and
        # metadata arms already skip it) — an unconditional stamper
        # must not produce a dangling-parent span tree
        zero = dict(hs)
        zero[wire.TRACE_HEADER] = "0:22"
        assert wire.trace_from_headers(zero) is None

    def test_http_proxy_front_passes_trace_headers_through(self):
        """The HTTP proxy front must forward the trace headers with the
        envelope — dropping them would cut the cross-tier span tree in
        half at the proxy."""
        import json as _json
        import urllib.request

        from veneur_tpu_torch.cluster.discovery import StaticDiscoverer
        from veneur_tpu_torch.cluster.proxy import HttpProxyFront, ProxyServer

        seen = []

        class FakeDest:
            def __init__(self, dest):
                pass

            def send_json(self, dicts, envelope=None):
                seen.append(envelope)

        proxy = ProxyServer(StaticDiscoverer(["a"]),
                            refresh_interval_s=3600)
        front = HttpProxyFront(proxy, dest_factory=FakeDest)
        srv, port = front.start("127.0.0.1:0")
        try:
            headers = {"Content-Type": "application/json",
                       "X-Veneur-Forward-Version": "jsonmetric-v1"}
            headers.update(wire.envelope_headers(
                "px", 5, 0, 1, trace_id=101, span_id=202,
                close_ns=303))
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/import",
                data=_json.dumps([{"name": "m", "type": "counter",
                                   "tags": [], "value": 1}]).encode(),
                headers=headers, method="POST")
            with urllib.request.urlopen(req, timeout=5) as resp:
                assert resp.status == 200
            assert len(seen) == 1
            env = seen[0]
            assert wire.envelope_from_headers(env) == ("px", 5, 0, 1)
            assert wire.trace_from_headers(env) == (101, 202, 303)
        finally:
            srv.shutdown()

    def test_accepts_envelope_detection(self):
        def legacy(export):
            pass

        def modern(export, envelope=None):
            pass

        assert not accepts_envelope(legacy)
        assert accepts_envelope(modern)
        assert accepts_envelope(lambda *a, **kw: None)


# ------------------------------------------------------- dedupe ledger

class TestDedupeLedger:
    def test_drops_replayed_chunks_and_counts(self):
        reg = ResilienceRegistry()
        led = DedupeLedger(registry=reg)
        assert led.admit("s", 1, 0, 2)
        assert led.admit("s", 1, 1, 2)
        assert not led.admit("s", 1, 0, 2)   # retry of chunk 0
        assert not led.admit("s", 1, 1, 2)   # replay of chunk 1
        assert led.admit("s", 2, 0, 1)       # next interval applies
        assert reg.peek("import", "forward.duplicates_dropped") == 2
        assert led.size() == 3

    def test_independent_senders(self):
        led = DedupeLedger()
        assert led.admit("a", 1, 0)
        assert led.admit("b", 1, 0)          # same ids, other sender
        assert not led.admit("a", 1, 0)

    def test_watermark_advances_on_seq_eviction(self):
        led = DedupeLedger(max_seqs_per_sender=3)
        for seq in range(1, 6):              # seqs 1..5; 1,2 evicted
            assert led.admit("s", seq, 0)
        assert led.size() == 3
        assert not led.admit("s", 1, 0)      # below watermark: dropped
        assert not led.admit("s", 2, 1)      # even a new chunk id
        assert not led.admit("s", 4, 0)      # tracked duplicate
        assert led.admit("s", 4, 1)          # tracked, new chunk

    def test_sustained_replay_storm_stays_within_bounds(self):
        """The acceptance criterion: a storm replaying old intervals
        and streaming new ones cannot grow the ledger past its
        configured bound."""
        reg = ResilienceRegistry()
        led = DedupeLedger(max_seqs_per_sender=8, max_senders=4,
                           registry=reg)
        chunks = 4
        for wave in range(50):
            for sender in range(10):         # 10 senders, bound 4
                for seq in range(1, 20):     # 19 seqs, bound 8
                    for _replay in range(3):   # the storm: each chunk
                        for c in range(chunks):   # resent 3x
                            led.admit(f"s{sender}", seq, c, chunks)
        assert led.sender_count() <= 4
        assert led.size() <= 4 * 8 * chunks
        assert reg.peek("import", "forward.duplicates_dropped") > 0

    def test_per_seq_chunk_set_is_capped(self):
        """Regression: max_seqs_per_sender bounds seq
        COUNT but one seq's chunk set must be bounded too, or a buggy
        sender grows receiver memory without limit."""
        reg = ResilienceRegistry()
        led = DedupeLedger(registry=reg)
        cap = DedupeLedger.MAX_CHUNKS_PER_SEQ
        for c in range(cap):
            assert led.admit("abuser", 1, c)
        assert led.size() == cap
        assert not led.admit("abuser", 1, cap)   # overflow rejected
        assert led.size() == 0                   # seq evicted wholesale
        assert reg.peek("import", "forward.chunk_overflow") == 1
        assert not led.admit("abuser", 1, 0)     # now below watermark
        assert led.admit("abuser", 2, 0)         # next seq unaffected

    def test_idle_sender_forgotten_after_ttl(self):
        from veneur_tpu_torch.utils.faults import FakeClock

        clock = FakeClock()
        led = DedupeLedger(ttl_s=60.0, clock=clock)
        assert led.admit("old", 1, 0)
        clock.advance(61.0)
        assert led.admit("fresh", 1, 0)      # triggers TTL sweep
        assert led.sender_count() == 1
        # the forgotten sender degrades to at-least-once: its replay
        # is applied again rather than dropped
        assert led.admit("old", 1, 0)

    def test_clear_resets_everything(self):
        led = DedupeLedger()
        led.admit("s", 1, 0)
        led.clear()
        assert led.size() == 0 and led.sender_count() == 0


# -------------------------------------- importsrv handler + poison pill

class _FakeContext:
    def __init__(self, metadata=()):
        self._md = tuple(metadata)

    def invocation_metadata(self):
        return self._md


def _metric(name="m", value=1):
    m = metric_pb2.Metric(name=name, type=metric_pb2.Counter)
    m.counter.value = value
    return m


class TestForwardHandlerDedupe:
    def test_send_metrics_drops_duplicate_chunk_whole(self):
        got = []
        led = DedupeLedger(registry=ResilienceRegistry())
        h = ForwardHandler(lambda d, im: got.append(im), ledger=led)
        ml = forward_pb2.MetricList(metrics=[_metric("a"), _metric("b")])
        ml.envelope.CopyFrom(wire.envelope_pb("s", 1, 0, 1))
        h._send_metrics(ml, _FakeContext())
        assert [im.pb.name for im in got] == ["a", "b"]
        h._send_metrics(ml, _FakeContext())      # ambiguous-retry replay
        assert len(got) == 2                     # dropped whole
        # a DIFFERENT chunk of the same interval still applies
        ml2 = forward_pb2.MetricList(metrics=[_metric("c")])
        ml2.envelope.CopyFrom(wire.envelope_pb("s", 1, 1, 2))
        h._send_metrics(ml2, _FakeContext())
        assert len(got) == 3

    def test_send_metrics_without_envelope_always_applies(self):
        got = []
        h = ForwardHandler(lambda d, im: got.append(im),
                           ledger=DedupeLedger(
                               registry=ResilienceRegistry()))
        ml = forward_pb2.MetricList(metrics=[_metric("a")])
        h._send_metrics(ml, _FakeContext())
        h._send_metrics(ml, _FakeContext())      # legacy at-least-once
        assert len(got) == 2

    def test_v2_mid_stream_failure_does_not_poison_ledger(self):
        """Regression: the envelope must be admitted
        only after the stream is fully received — a connection that
        dies mid-stream aborts with nothing recorded, so the sender's
        whole-stream retry under the same envelope still applies."""
        got = []
        led = DedupeLedger(registry=ResilienceRegistry())
        h = ForwardHandler(lambda d, im: got.append(im), ledger=led)
        md = [(wire.ENVELOPE_METADATA_KEY,
               wire.envelope_pb("v2", 8, 0, 1).SerializeToString())]

        def broken_stream():
            yield _metric("a")
            raise ConnectionResetError("client went away mid-stream")

        with pytest.raises(ConnectionResetError):
            h._send_metrics_v2(broken_stream(), _FakeContext(md))
        assert got == [] and led.size() == 0
        # the retry of the SAME envelope applies in full
        h._send_metrics_v2(iter([_metric("a"), _metric("b")]),
                           _FakeContext(md))
        assert [im.pb.name for im in got] == ["a", "b"]

    def test_http_bad_body_does_not_poison_ledger(self):
        """Regression: a 400 promises nothing was
        imported, so the envelope must not be admitted before the body
        decodes — the sender's re-send of the same chunk with a good
        body must apply, not be dropped as a duplicate."""
        import json as _json
        import urllib.error
        import urllib.request

        from veneur_tpu_torch.http_api import HttpApi

        got = []
        led = DedupeLedger(registry=ResilienceRegistry())
        api = HttpApi("127.0.0.1:0",
                      submit=lambda d, pb: got.append(pb), ledger=led)
        api.start()
        try:
            url = f"http://127.0.0.1:{api.port}/import"
            headers = {"Content-Type": "application/json"}
            headers.update(wire.envelope_headers("hs", 3, 0, 1))
            bad = urllib.request.Request(
                url, data=b'[{"name": "x"}]',   # no type: decode fails
                headers=headers, method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(bad, timeout=5)
            assert ei.value.code == 400
            assert led.size() == 0               # nothing admitted
            good = urllib.request.Request(
                url, data=_json.dumps(
                    [{"name": "x", "type": "counter",
                      "value": 4}]).encode(),
                headers=headers, method="POST")
            with urllib.request.urlopen(good, timeout=5) as resp:
                assert _json.loads(resp.read())["imported"] == 1
            assert [pb.name for pb in got] == ["x"]
            # and the duplicate of the now-delivered chunk IS dropped
            with urllib.request.urlopen(good, timeout=5) as resp:
                assert _json.loads(resp.read())["deduped"] is True
            assert len(got) == 1
        finally:
            api.stop()

    def test_send_metrics_v2_dedupes_via_metadata(self):
        got = []
        led = DedupeLedger(registry=ResilienceRegistry())
        h = ForwardHandler(lambda d, im: got.append(im), ledger=led)
        md = [(wire.ENVELOPE_METADATA_KEY,
               wire.envelope_pb("v2", 3, 0, 1).SerializeToString())]
        h._send_metrics_v2(iter([_metric("a")]), _FakeContext(md))
        assert len(got) == 1
        h._send_metrics_v2(iter([_metric("a")]), _FakeContext(md))
        assert len(got) == 1                     # stream dropped whole

    def test_route_rejects_poison_metric_and_counts(self):
        reg = ResilienceRegistry()
        calls = []

        def explode(digest, im):
            raise AssertionError("must not be reached")

        h = ForwardHandler(calls.append, registry=reg)

        class Evil:
            name = property(lambda self: (_ for _ in ()).throw(
                ValueError("bad name")))
            type = metric_pb2.Counter
            tags = ()

        h._route(Evil())                         # must not raise
        assert reg.peek("import", "import.rejected") == 1
        del explode


class TestWorkerPoisonGuard:
    def _server(self):
        from veneur_tpu_torch.config import read_config
        from veneur_tpu_torch.server import Server
        from veneur_tpu_torch.sinks.basic import CaptureMetricSink

        # a one-hour interval: the started flusher must not tick (and
        # drain the rejected counter) before the test's own flush_once
        cfg = read_config(text="""
interval: "3600s"
statsd_listen_addresses: []
tpu_histogram_slots: 256
tpu_counter_slots: 256
tpu_gauge_slots: 256
tpu_set_slots: 128
""")
        return Server(cfg, sinks=[CaptureMetricSink()], plugins=[],
                     device="cpu")

    def test_corrupted_hll_rejected_worker_survives(self):
        """The poison-pill regression: a malformed HLL payload used to
        propagate out of apply_metric_to_engine and kill the worker
        loop; now it is rejected per-metric and counted."""
        srv = self._server()
        try:
            srv.start()
            bad = metric_pb2.Metric(name="evil.set",
                                    type=metric_pb2.Set)
            bad.set.hyper_log_log = b"\xff\x00garbage"   # bad version
            ok = _metric("good.counter", 5)
            srv._route_metric(ImportedMetric(bad))
            srv._route_metric(ImportedMetric(ok))
            assert srv.drain(5.0)
            # the worker survived the poison pill and processed the
            # good metric after it
            out = {m.name: m.value
                   for m in srv.flush_once(timestamp=10)}
            assert out.get("good.counter") == 5.0
            assert out["veneur.import.rejected_total"] == 1.0
        finally:
            srv.stop()

    def test_malformed_centroid_metric_rejected(self):
        srv = self._server()
        try:
            srv.start()
            bad = metric_pb2.Metric(name="evil.histo",
                                    type=metric_pb2.Histogram)
            bad.histogram.t_digest.centroids.add(mean=float("nan"),
                                                 weight=-1.0)
            # monkeypatch the engine to make centroid import explode the
            # way a malformed payload does deeper in the stack
            eng = srv.engines[0]
            orig = eng.import_histogram
            eng.import_histogram = lambda *a, **kw: (_ for _ in ()
                                                     ).throw(
                ValueError("malformed centroid"))
            try:
                srv._route_metric(ImportedMetric(bad))
                srv._route_metric(ImportedMetric(_metric("fine", 1)))
                assert srv.drain(5.0)
            finally:
                eng.import_histogram = orig
            out = {m.name: m.value
                   for m in srv.flush_once(timestamp=10)}
            assert out.get("fine") == 1.0
            assert out["veneur.import.rejected_total"] == 1.0
        finally:
            srv.stop()

    def test_imported_batch_arm_applies_and_rejects_per_metric(self):
        """The worker's ImportedBatch arm: one op's metrics land under
        one lock hold, advancing the engine's applied-op watermark; a
        corrupt metric rejects itself (counted), not the op."""
        from veneur_tpu_torch.cluster.importsrv import ImportedBatch

        srv = self._server()
        try:
            srv.start()
            bad = metric_pb2.Metric(name="evil.set", type=metric_pb2.Set)
            bad.set.hyper_log_log = b"\xff\x00garbage"
            srv.worker_queues[0].put_nowait(ImportedBatch(
                7, [_metric("batch.a", 2), bad, _metric("batch.b", 3)]))
            assert srv.drain(5.0)
            assert srv.engines[0].last_import_op == 7
            out = {m.name: m.value
                   for m in srv.flush_once(timestamp=10)}
            assert out["batch.a"] == 2.0 and out["batch.b"] == 3.0
            assert out["veneur.import.rejected_total"] == 1.0
        finally:
            srv.stop()


# ----------------------------------------------- sender-id / seq space

class TestSenderIdentity:
    def test_static_sender_id_wall_seeds_seq_space(self):
        """Regression: a configured stable sender_id
        restarting with seq=1 would sit below the receiver's persisted
        watermark forever (blackhole). Static ids must wall-seed."""
        fwd = ResilientForwarder(lambda e: None, sender_id="leaf-01")
        assert fwd._next_seq > 1_000_000_000_000   # wall milliseconds
        # auto ids are unique per incarnation: they start at 1
        fwd2 = ResilientForwarder(lambda e: None)
        assert fwd2._next_seq == 1
        # an 'old' incarnation's watermark is cleared by the restart,
        # even for a sub-second flush interval (seqs advanced 2/s for
        # an hour; ms seeding outruns that, seconds seeding would not)
        led = DedupeLedger()
        old_seed = fwd._next_seq - 3_600_000       # started 1h earlier
        old_watermark_seq = old_seed + 2 * 3600    # 500ms interval
        assert led.admit("leaf-01", old_watermark_seq, 0)
        assert led.admit("leaf-01", fwd._next_seq, 0)

    def test_server_builds_wall_seeded_forwarder_for_static_id(self):
        from veneur_tpu_torch.config import read_config
        from veneur_tpu_torch.server import Server
        from veneur_tpu_torch.sinks.basic import CaptureMetricSink

        cfg = read_config(text="""
interval: "1s"
statsd_listen_addresses: []
forward_address: "placeholder:1"
forward_sender_id: "leaf-01"
tpu_histogram_slots: 256
tpu_counter_slots: 256
tpu_gauge_slots: 256
tpu_set_slots: 128
""")
        srv = Server(cfg, sinks=[CaptureMetricSink()], plugins=[],
                     device="cpu")
        try:
            assert srv.forwarder.sender_id == "leaf-01"
            assert srv.forwarder._next_seq > 1_000_000_000_000
        finally:
            srv.stop()


# ------------------------------------------- proxy partial-failure ack

class TestProxyPartialFailureNotAcked:
    def test_grpc_front_aborts_on_partial_fanout_failure(self):
        """Regression: the gRPC proxy front must not
        ack a batch whose fan-out partially failed — the sender would
        never replay the failed destinations' shares."""
        import grpc as grpc_mod

        from veneur_tpu_torch.cluster.discovery import StaticDiscoverer
        from veneur_tpu_torch.cluster.proxy import ProxyServer

        class FlakyFwd:
            def __init__(self, dest):
                self.dest = dest

            def send_metrics(self, metrics):
                if self.dest == "bad:1":
                    raise ConnectionRefusedError("down")

        class AbortingContext:
            def __init__(self):
                self.aborted = None

            def abort(self, code, details):
                self.aborted = (code, details)
                raise RuntimeError("aborted")     # grpc's abort raises

        proxy = ProxyServer(StaticDiscoverer(["good:1", "bad:1"]),
                            forwarder_factory=FlakyFwd)
        metrics = [_metric(f"m{i}") for i in range(50)]
        ml = forward_pb2.MetricList(metrics=metrics)
        ctx = AbortingContext()
        with pytest.raises(RuntimeError):
            proxy._serve_batch(ml, ctx)
        assert ctx.aborted is not None
        assert ctx.aborted[0] == grpc_mod.StatusCode.UNAVAILABLE
        # a fan-out that routes entirely to the healthy peer still acks
        good_only = next(
            m for m in (_metric(f"probe{i}") for i in range(100))
            if set(proxy.route_metrics([m])) == {"good:1"})
        ctx2 = AbortingContext()
        out = proxy._serve_batch(
            forward_pb2.MetricList(metrics=[good_only]), ctx2)
        assert isinstance(out, forward_pb2.Empty)
        assert ctx2.aborted is None


# ------------------------------------- real-gRPC ambiguous failure e2e

class TestGrpcExactlyOnceEndToEnd:
    def test_ack_lost_retry_does_not_double_count(self, fault_harness):
        """Real loopback gRPC: the send lands at the global tier, the
        ack is dropped, the retry resends the same enveloped chunk —
        the receiver's ledger drops it, so the counter is NOT doubled
        (a scenario that double-counts without the ledger)."""
        from veneur_tpu_torch.config import read_config
        from veneur_tpu_torch.server import Server
        from veneur_tpu_torch.sinks.basic import CaptureMetricSink
        from veneur_tpu_torch.utils.faults import ScriptedCallable

        cfg = read_config(text="""
interval: "3600s"
statsd_listen_addresses: []
grpc_listen_addresses: ["127.0.0.1:0"]
num_workers: 1
tpu_histogram_slots: 256
tpu_counter_slots: 256
tpu_gauge_slots: 256
tpu_set_slots: 128
""")
        cfg.is_global = True
        reg = ResilienceRegistry()
        glob = Server(cfg, sinks=[CaptureMetricSink()], plugins=[],
                     device="cpu")
        glob.dedupe_ledger = DedupeLedger(registry=reg)
        glob.start()
        try:
            h = fault_harness
            fwd = GrpcForwarder(f"127.0.0.1:{glob.grpc_port}",
                                egress=h.egress("g2g"))
            real_send = fwd._send
            fwd._send = ScriptedCallable(
                ["ack_lost", "ok"], h.clock,
                on_success=lambda batch, **kw: real_send(batch))
            rfwd = ResilientForwarder(fwd, destination="g2g",
                                      sender_id="g2g-sender",
                                      registry=h.registry)
            exp = ForwardExport()
            exp.counters.append(
                (MetricKey("e2e.total", "counter", ""), 5.0))
            rfwd(exp)          # attempt 1 applied+lost, retry deduped
            assert glob.drain(10.0)
            out = {m.name: m.value
                   for m in glob.flush_once(timestamp=50)}
            assert out.get("e2e.total") == 5.0     # NOT 10.0
            assert reg.peek("import",
                            "forward.duplicates_dropped") == 1
            assert rfwd.pending_spill == 0
        finally:
            glob.stop()


# ------------------------------------------------- graceful shutdown

class TestGracefulImportsrvShutdown:
    class _FakeGrpcServer:
        """Mimics grpc.Server.stop(grace) -> threading.Event."""

        def __init__(self, finishes_after: float, clock):
            import threading
            self._ev = threading.Event()
            self._deadline = clock() + finishes_after
            self._clock = clock

        def stop(self, grace):
            return self

        # Event protocol driven by the fake clock
        def is_set(self):
            return self._clock() >= self._deadline

    def test_inflight_rpcs_complete_within_grace(self, fault_harness):
        clock = fault_harness.clock
        srv = self._FakeGrpcServer(finishes_after=0.05, clock=clock)
        assert stop_import_server(srv, grace=1.0, clock=clock,
                                  sleep=clock.sleep) is True
        assert clock() < 1.0         # returned as soon as it drained

    def test_grace_expiry_path(self, fault_harness):
        clock = fault_harness.clock
        srv = self._FakeGrpcServer(finishes_after=10.0, clock=clock)
        assert stop_import_server(srv, grace=0.5, clock=clock,
                                  sleep=clock.sleep) is False
        assert clock() >= 0.5        # the clock, not the wall
        assert clock.sleeps          # it polled

    def test_server_stop_drains_before_ledger_teardown(self,
                                                      fault_harness):
        """Server.stop must give in-flight SendMetrics their grace and
        only then clear the dedupe ledger."""
        from veneur_tpu_torch.config import read_config
        from veneur_tpu_torch.server import Server
        from veneur_tpu_torch.sinks.basic import CaptureMetricSink

        cfg = read_config(text="""
interval: "1s"
statsd_listen_addresses: []
grpc_listen_addresses: ["127.0.0.1:0"]
tpu_histogram_slots: 256
tpu_counter_slots: 256
tpu_gauge_slots: 256
tpu_set_slots: 128
""")
        srv = Server(cfg, sinks=[CaptureMetricSink()], plugins=[],
                     device="cpu")
        assert srv.dedupe_ledger is not None
        srv.start()
        srv.dedupe_ledger.admit("s", 1, 0)
        assert srv.dedupe_ledger.size() == 1
        clock = fault_harness.clock
        events = []

        class SlowServer(self._FakeGrpcServer):
            def stop(self, grace):
                events.append(("stop", grace))
                return self

        srv._grpc_servers.append(
            SlowServer(finishes_after=0.01, clock=clock))
        srv.stop(grace=0.5, clock=clock, sleep=clock.sleep)
        assert any(e == ("stop", 0.5) for e in events)
        # torn down only after the drain completed
        assert srv.dedupe_ledger.size() == 0


# ---------------------------------------- the ledger against the reference

@pytest.mark.parametrize("seed", range(4))
def test_dedupe_ledger_matches_the_reference(seed):
    """One seeded stream of admits (replays, duplicates, extra chunks,
    senders beyond max_senders, idle gaps past the TTL) and delta gap
    checks through the reference's DedupeLedger and the port's: the
    same verdict for every call, the same sizes, watermarks and
    counters (Exact level)."""
    from veneur_tpu.cluster.importsrv import DedupeLedger as JLedger
    from veneur_tpu.resilience import ResilienceRegistry as JRegistry
    from veneur_tpu.utils.faults import FakeClock as JClock
    from veneur_tpu_torch.utils.faults import FakeClock

    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(600):
        sid = f"s{int(rng.integers(0, 6))}"
        seq = int(rng.integers(1, 40))
        if rng.random() < 0.15:
            ops.append(("delta", sid, seq))
        else:
            ops.append(("admit", sid, seq, int(rng.integers(0, 3)),
                        int(rng.integers(0, 3))))
        if rng.random() < 0.02:
            ops.append(("advance", 50.0))

    def run(ledger_cls, reg_cls, clock_cls):
        clock, reg = clock_cls(), reg_cls()
        led = ledger_cls(max_seqs_per_sender=8, max_senders=4, ttl_s=40.0,
                         clock=clock, registry=reg)
        led.MAX_CHUNKS_PER_SEQ = 2
        out = []
        for op in ops:
            if op[0] == "advance":
                clock.advance(op[1])
            elif op[0] == "delta":
                out.append(led.check_delta(op[1], op[2]))
            else:
                out.append(led.admit(*op[1:]))
            out.append((led.size(), led.sender_count()))
        return out, led.max_admitted(), sorted(reg.take().items())

    ref = run(JLedger, JRegistry, JClock)
    port = run(DedupeLedger, ResilienceRegistry, FakeClock)
    assert port == ref
    verdicts = [v for v in port[0] if isinstance(v, bool)]
    assert True in verdicts and False in verdicts


# ------------------------------------------------------------- chaos twin
#
# The port twin of tests/test_exactly_once_chaos.py's
# test_chaos_state_bit_identical_to_oracle, port local to port global:
# seeded UDP traffic -> local Server (real socket, one worker, manual
# flush ticks) -> ResilientForwarder -> HttpJsonForwarder whose egress
# transport is a ScriptedTransport with `deliver=` wired to REAL HTTP
# POSTs against the global Server's /import, so an "ack_lost" step
# applies the body at the global and then drops the response. One
# datagram a round, one worker queue each, pinned flush timestamps and
# an injected egress clock make the run deterministic; the forwarder
# replays failed intervals oldest-first, so the global Combines
# interval seqs in order — which is what makes bit-identity reachable.

_CHAOS_YAML = """
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


class _RoundTransport:
    """Mutable slot so each chaos round installs a fresh scripted
    schedule on the same Egress."""

    def __init__(self):
        self.current = None

    def __call__(self, req, timeout=None):
        return self.current(req, timeout=timeout)


def _chaos_round_lines(r: int, rng) -> bytes:
    """One round's traffic as a single datagram: 4 timer keys (digest
    forwards), a set, and two global-only counters — ~9 jsonmetric
    entries per flush, i.e. 3 wire chunks at max_per_body=3."""
    lines = []
    for k in range(4):
        for v in rng.normal(100 + 10 * k, 5, 5):
            lines.append(b"chaos.t%d:%.4f|ms" % (k, v))
    for u in range(3):
        lines.append(b"chaos.uniq:u%d-%d|s" % (r % 4, u))
    lines.append(b"chaos.total:%d|c|#veneurglobalonly" % (r + 1))
    lines.append(b"chaos.extra:2|c|#veneurglobalonly")
    return b"\n".join(lines)


def _chaos_run(schedules, seed=7):
    """Drive the topology over len(schedules) rounds; returns (the
    global's flushed rows, duplicates dropped, pending spill)."""
    import random
    import socket
    import time
    import urllib.request

    from veneur_tpu_torch.config import read_config
    from veneur_tpu_torch.resilience import (BreakerPolicy, EgressPolicy,
                                             RetryPolicy)
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.basic import CaptureMetricSink
    from veneur_tpu_torch.utils.faults import FakeClock, ScriptedTransport

    reg = ResilienceRegistry()
    gcfg = read_config(text=_CHAOS_YAML)
    gcfg.http_address = "127.0.0.1:0"
    gcfg.is_global = True
    glob = Server(gcfg, sinks=[CaptureMetricSink()], plugins=[],
                  device="cpu")
    # a dedicated registry: the local's self-metric drains between
    # rounds must not eat the duplicate counters asserted on
    glob.dedupe_ledger = DedupeLedger(registry=reg)
    glob.start()
    clock = FakeClock()
    rt = _RoundTransport()
    egress = Egress(
        "chaos-global",
        policy=EgressPolicy(
            retry=RetryPolicy(max_attempts=3, base_backoff_s=0.001,
                              max_backoff_s=0.002, deadline_s=120.0),
            breaker=BreakerPolicy(failure_threshold=10_000)),
        transport=rt, clock=clock, sleep=clock.sleep,
        rng=random.Random(42), registry=reg)
    inner = HttpJsonForwarder(f"http://127.0.0.1:{glob.http_api.port}",
                              timeout_s=5.0, max_per_body=3, egress=egress)

    def deliver(req):
        return urllib.request.urlopen(req, timeout=5)

    fwd = ResilientForwarder(inner, destination="chaos-global",
                             sender_id="chaos-sender", registry=reg)
    lcfg = read_config(text=_CHAOS_YAML)
    lcfg.statsd_listen_addresses = ["udp://127.0.0.1:0"]
    lcfg.forward_address = "placeholder:1"   # enables forward exports
    local = Server(lcfg, sinks=[CaptureMetricSink()], plugins=[],
                   device="cpu", forwarder=fwd)
    local.start()
    try:
        rng = np.random.default_rng(seed)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as c:
            for r, schedule in enumerate(schedules):
                rt.current = ScriptedTransport(schedule, clock,
                                               deliver=deliver)
                c.sendto(_chaos_round_lines(r, rng),
                         ("127.0.0.1", local.bound_port()))
                deadline = time.monotonic() + 10
                while local.packets_received < 1 \
                        and time.monotonic() < deadline:
                    time.sleep(0.005)
                assert local.packets_received >= 1, "datagram lost"
                assert local.drain(10.0)
                local.flush_once(timestamp=1000 + r)  # faults are caught
                clock.advance(10.0)                   # and parked
        assert glob.drain(10.0)
        out = sorted((m.name, tuple(m.tags), str(m.type), m.value)
                     for m in glob.flush_once(timestamp=9999)
                     if not m.name.startswith("veneur."))
        return out, reg.peek("import", "forward.duplicates_dropped"), \
            fwd.pending_spill
    finally:
        local.stop()
        glob.stop()


def test_chaos_state_bit_identical_to_oracle():
    """After scripted ack-loss / 503 / partial-delivery storms
    (including seeded ambiguous schedules), the port global's flushed
    state — every percentile and aggregate, the HLL set estimates, the
    counter sums — equals a zero-fault rerun over the same traffic bit
    for bit, and the dedupe ledger fired."""
    from veneur_tpu_torch.utils.faults import seeded_schedule

    schedules = [
        ["ok"],
        ["ack_lost", "ok"],                    # retry after ambiguous loss
        [503, 503, "ok"],                      # clean retry ladder
        ["ok", "ack_lost", "timeout", "timeout"],   # partial: applied tail
        ["refused"],                           # full outage: park + replay
        ["ok"],                                # recovery: replay storm
        ["ok"],
        seeded_schedule(101, 8, p_fail=0.6, ambiguous=True),
        seeded_schedule(102, 8, p_fail=0.6, ambiguous=True),
        seeded_schedule(103, 8, p_fail=0.6, ambiguous=True),
        ["ok"],
        ["ok"],
    ]
    faulty, dups, pending = _chaos_run(schedules)
    oracle, oracle_dups, oracle_pending = _chaos_run(
        [["ok"]] * len(schedules))
    assert pending == 0 and oracle_pending == 0
    assert dups > 0 and oracle_dups == 0
    assert faulty == oracle
    names = {n for n, _t, _ty, _v in faulty}
    assert any(n.endswith(".50percentile") for n in names)
    assert "chaos.uniq" in names and "chaos.total" in names
