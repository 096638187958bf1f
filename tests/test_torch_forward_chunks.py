"""The port's GrpcForwarder chunks a forward by encoded bytes as well as
by metric count (ROADMAP C.10): a p=14 HLL row is 16 KiB, so a chunk of
a few hundred sets would overrun grpc's 4 MiB receive limit at the
global.

Unit: the chunk bounds close at whichever limit comes first, every
chunk of 1000 p=14 sets stays under the receive limit, and a partial
delivery's tail replays the very chunks it had (the same metrics under
the same chunk ids). Then a mixed fleet, both ways, with 1000 HLL sets
in one interval: a port local forwards over gRPC with its default
chunking to a reference global and to a port global, and a reference
local forwards to the port global through the reference's own
GrpcForwarder (unchanged: it chunks by count only, so it is given 200
metrics a chunk). Every global's set rows are the same estimates (HLL
registers merge exactly across the packages; the estimate within rtol
1e-5) and within HLL's error of the truth. One reference Server starts
in this file; the port runs on the CPU.
"""

import time

import pytest

from veneur_tpu.cluster import forward as jforward
from veneur_tpu.config import read_config as jread_config
from veneur_tpu.ingest import parser as jparser
from veneur_tpu.models import pipeline as jpipe
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks.basic import CaptureMetricSink as JCapture
from veneur_tpu_torch.cluster import forward as tforward
from veneur_tpu_torch.cluster import wire
from veneur_tpu_torch.config import read_config
from veneur_tpu_torch.ingest import parser as tparser
from veneur_tpu_torch.models import pipeline as tpipe
from veneur_tpu_torch.resilience import ForwardEnvelope, PartialDeliveryError
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink
from veneur_tpu_torch.utils.faults import FaultHarness

N_SETS = 1000

_GLOBAL_YAML = """
interval: "3600s"
hostname: g
statsd_listen_addresses: []
grpc_listen_addresses: ["127.0.0.1:0"]
is_global: true
num_workers: 1
tpu_histogram_slots: 256
tpu_counter_slots: 128
tpu_gauge_slots: 128
tpu_set_slots: 2048
tpu_batch_size: 4096
"""


def _lines(prefix):
    """One interval of N_SETS sets, 5-44 members each (mixed scope: the
    local forwards them), and the members of each."""
    lines, truth = [], {}
    for k in range(N_SETS):
        members = [f"u{k}-{m}" for m in range(5 + k % 40)]
        truth[f"{prefix}.s{k}"] = len(members)
        lines += [f"{prefix}.s{k}:{m}|s".encode() for m in members]
    return lines, truth


def _engine_cfg(pipe):
    return pipe.EngineConfig(forward_enabled=True, histogram_slots=64,
                             counter_slots=64, gauge_slots=64,
                             set_slots=1024, hll_precision=14,
                             batch_size=4096)


def _port_export(prefix):
    eng = tpipe.AggregationEngine(_engine_cfg(tpipe), device="cpu")
    lines, truth = _lines(prefix)
    for ln in lines:
        eng.process(tparser.parse_packet(ln))
    export = eng.flush(timestamp=1, forward_kind="full").export
    assert len(export.sets) == N_SETS
    return export, truth


def _reference_export(prefix):
    eng = jpipe.AggregationEngine(_engine_cfg(jpipe))
    lines, truth = _lines(prefix)
    for ln in lines:
        eng.process(jparser.parse_packet(ln))
    export = eng.flush(timestamp=1, forward_kind="full").export
    assert len(export.sets) == N_SETS
    return export, truth


@pytest.fixture(scope="module")
def port_export():
    return _port_export("p")


def _recording(fwd):
    """Wrap a forwarder's RPC stub to keep each chunk sent."""
    sent = []
    real = fwd._send

    def send(req, timeout=None):
        sent.append(req)
        return real(req, timeout=timeout)
    fwd._send = send
    return sent


# ---------------------------------------------------------------- unit

def test_chunk_bounds_close_at_the_first_limit():
    class M:
        def __init__(self, n):
            self.n = n

        def ByteSize(self):
            return self.n

    ms = [M(100)] * 10 + [M(5000)] + [M(10)] * 3
    # 102 bytes a small metric on the wire (tag and length prefix)
    assert tforward._chunk_bounds(ms, 4, 10**6) == [
        (0, 4), (4, 8), (8, 12), (12, 14)]
    assert tforward._chunk_bounds(ms, 100, 350) == [
        (0, 3), (3, 6), (6, 9), (9, 10), (10, 11), (11, 14)]
    assert tforward._chunk_bounds([], 10, 10) == []
    # a tail that starts at a bound is chunked as the original was
    full = tforward._chunk_bounds(ms, 100, 350)
    assert [(a + 6, b + 6) for a, b in
            tforward._chunk_bounds(ms[6:], 100, 350)] == full[2:]


def test_1000_hll_sets_chunk_under_the_receive_limit(port_export):
    export, _truth = port_export
    h = FaultHarness(seed=0)
    fwd = tforward.GrpcForwarder("127.0.0.1:1", egress=h.egress("g"))
    sent = []
    fwd._send = lambda req, timeout=None: sent.append(req)
    fwd(export, envelope=ForwardEnvelope("s", 3))
    sizes = [req.ByteSize() for req in sent]
    assert max(sizes) < tforward.GRPC_RECEIVE_LIMIT
    assert len(sent) == -(-sum(sizes) // tforward.MAX_CHUNK_BYTES) >= 5
    assert sum(len(req.metrics) for req in sent) == N_SETS
    ids = [wire.envelope_from_metric_list(req) for req in sent]
    assert ids == [("s", 3, j, len(sent)) for j in range(len(sent))]
    # the count limit still closes chunks of small metrics first
    fwd2 = tforward.GrpcForwarder("127.0.0.1:1", max_per_batch=64,
                                  egress=h.egress("g2"))
    fwd2._send = lambda req, timeout=None: sent.append(req)
    fwd2(export)
    assert len(sent) - len(ids) == -(-N_SETS // 64)


def test_partial_delivery_replays_the_same_chunks(port_export):
    """Chunk 2 fails terminally: the tail replayed under the resumed
    envelope is chunks 2.. again, metric for metric."""
    from veneur_tpu_torch.resilience import TerminalEgressError
    export, _truth = port_export
    h = FaultHarness(seed=0)
    first = []

    def send(req, timeout=None):
        if len(first) == 2:
            raise TerminalEgressError("boom")
        first.append(req)

    fwd = tforward.GrpcForwarder("127.0.0.1:1", egress=h.egress("g"))
    fwd._send = send
    whole = []
    ref = tforward.GrpcForwarder("127.0.0.1:1", egress=h.egress("r"))
    ref._send = lambda req, timeout=None: whole.append(req)
    ref(export, envelope=ForwardEnvelope("s", 9))
    with pytest.raises(PartialDeliveryError) as ei:
        fwd(export, envelope=ForwardEnvelope("s", 9))
    assert ei.value.delivered_chunks == 2
    assert ei.value.chunk_count == len(whole)
    replay = []
    fwd2 = tforward.GrpcForwarder("127.0.0.1:1", egress=h.egress("g2"))
    fwd2._send = lambda req, timeout=None: replay.append(req)
    fwd2(ei.value.undelivered, envelope=ForwardEnvelope(
        "s", 9, chunk_offset=2, chunk_count=len(whole)))
    assert [r.SerializeToString() for r in first + replay] == \
        [r.SerializeToString() for r in whole]


# ------------------------------------------------------- mixed fleet

def _wait_ingested(srv, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if srv.drain(5):
            return
        time.sleep(0.05)
    raise AssertionError("global did not drain")


def _set_rows(cap, prefix):
    return {m.name: m.value for fl in cap.flushes for m in fl
            if m.name.startswith(prefix + ".s")}


def test_mixed_fleet_forwards_1000_hll_sets_both_ways(port_export):
    p_export, p_truth = port_export
    r_export, r_truth = _reference_export("r")
    jcap, tcap = JCapture(), CaptureMetricSink()
    jglob = JServer(jread_config(text=_GLOBAL_YAML), sinks=[jcap],
                    plugins=[])
    tglob = Server(read_config(text=_GLOBAL_YAML), sinks=[tcap],
                   plugins=[], device="cpu")
    jglob.start()
    tglob.start()
    try:
        # port local -> reference global and -> port global, each with
        # the port forwarder's default chunks
        for glob in (jglob, tglob):
            fwd = tforward.GrpcForwarder(f"127.0.0.1:{glob.grpc_port}",
                                         timeout_s=30.0)
            sent = _recording(fwd)
            fwd(p_export, envelope=ForwardEnvelope(f"p-{id(glob)}", 1))
            fwd.close()
            assert len(sent) >= 5
            assert max(r.ByteSize() for r in sent) < \
                tforward.GRPC_RECEIVE_LIMIT
        # reference local -> port global: the reference's forwarder as it
        # is, its chunks cut by count to fit the limit
        jfwd = jforward.GrpcForwarder(f"127.0.0.1:{tglob.grpc_port}",
                                      timeout_s=30.0, max_per_batch=200)
        jfwd(r_export)
        jfwd.close()
        for glob in (jglob, tglob):
            _wait_ingested(glob)
        jglob.flush_once(timestamp=100)
        tglob.flush_once(timestamp=100)
        assert jcap.wait_for_flush(1) and tcap.wait_for_flush(1)
    finally:
        jglob.stop()
        tglob.stop()
    jp, tp, tr = (_set_rows(jcap, "p"), _set_rows(tcap, "p"),
                  _set_rows(tcap, "r"))
    assert len(jp) == len(tp) == len(tr) == N_SETS
    for k in range(N_SETS):
        want = p_truth[f"p.s{k}"]
        assert tp[f"p.s{k}"] == pytest.approx(jp[f"p.s{k}"], rel=1e-5)
        assert tr[f"r.s{k}"] == pytest.approx(tp[f"p.s{k}"], rel=1e-5)
        assert abs(tp[f"p.s{k}"] - want) <= max(1.0, 0.03 * want)
    assert r_truth == {f"r.s{k}": n for k, n in
                       ((int(k[3:]), n) for k, n in p_truth.items())}


def test_one_unchunked_message_overruns_the_receive_limit(port_export):
    """What the byte limit prevents: the same 1000 sets in one chunk are
    refused by the receiver (RESOURCE_EXHAUSTED)."""
    import grpc
    export, _truth = port_export
    srv = Server(read_config(text=_GLOBAL_YAML), sinks=[CaptureMetricSink()],
                 plugins=[], device="cpu")
    srv.start()
    try:
        fwd = tforward.GrpcForwarder(f"127.0.0.1:{srv.grpc_port}")
        with pytest.raises(grpc.RpcError) as ei:
            fwd._send(_one_message(export), timeout=30.0)
        assert ei.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        fwd.close()
    finally:
        srv.stop()


def _one_message(export):
    from veneur_tpu_torch.cluster.protos import forward_pb2
    return forward_pb2.MetricList(
        metrics=wire.export_to_metrics(export, codec="lossless"))

