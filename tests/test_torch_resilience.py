"""The port's egress-resilience layer (veneur_tpu_torch/resilience.py) —
the non-journal flows of tests/test_resilience.py with the port in place
of the reference: every retry / breaker / re-merge transition driven
deterministically through the port's fault harness
(veneur_tpu_torch/utils/faults.py): scripted failure schedules, injected
monotonic clock, zero real sleeps, zero sockets. The engines run on the
CPU (`device="cpu"`). Then the two ladders side by side: the same
exports and the same scripted faults through the reference's
ResilientForwarder and the port's deliver the same envelopes, payloads
and counters."""

import numpy as np
import pytest

from tests.oracle_tdigest import OracleDigest
from veneur_tpu_torch.ingest.parser import MetricKey
from veneur_tpu_torch.models.pipeline import (AggregationEngine,
                                              EngineConfig, ForwardExport)
from veneur_tpu_torch.resilience import (BreakerPolicy, CircuitBreaker,
                                         CircuitOpenError, EgressPolicy,
                                         HTTPStatusError,
                                         ResilienceRegistry,
                                         ResilientForwarder, RetryPolicy,
                                         SpillBuffer, is_retryable)
from veneur_tpu_torch.utils.faults import (FakeClock, FaultHarness,
                                           ScriptedCallable,
                                           seeded_schedule)


@pytest.fixture
def fault_harness():
    """The port's harness: a shared FakeClock, scripted transports and
    the port's Egress (tests/conftest.py's fixture builds the
    reference's)."""
    return FaultHarness(seed=0)


def small_engine(**kw):
    cfg = dict(histogram_slots=256, counter_slots=128, gauge_slots=128,
               set_slots=64, buffer_depth=128, percentiles=(0.5, 0.99),
               forward_enabled=True)
    cfg.update(kw)
    return AggregationEngine(EngineConfig(**cfg), device="cpu")


# ---------------------------------------------------------------- retry

class TestRetry:
    def test_fail_twice_503_then_succeed_zero_loss(self, fault_harness):
        """The acceptance schedule: two 503s then success must deliver
        with the expected attempt/retry counters and full-jitter
        backoff sleeps — and nothing lost or spilled."""
        h = fault_harness
        tr = h.transport([503, 503, "ok"])
        eg = h.egress("dest", transport=tr)
        status = eg.post(object(), timeout_s=5.0)
        assert status == 200
        assert tr.attempts == 3
        reg = h.registry
        assert reg.peek("dest", "attempts") == 3
        assert reg.peek("dest", "retries") == 2
        assert reg.peek("dest", "success") == 1
        assert reg.peek("dest", "failures") == 0
        # full jitter: sleep k ~ U(0, base * 2^k), base=0.2
        assert len(h.clock.sleeps) == 2
        assert 0.0 <= h.clock.sleeps[0] <= 0.2
        assert 0.0 <= h.clock.sleeps[1] <= 0.4

    def test_terminal_4xx_not_retried(self, fault_harness):
        h = fault_harness
        tr = h.transport([403, "ok"])
        eg = h.egress("dest", transport=tr)
        with pytest.raises(HTTPStatusError):
            eg.post(object())
        assert tr.attempts == 1
        assert h.registry.peek("dest", "failures") == 1
        assert h.clock.sleeps == []

    def test_attempts_exhausted_raises_last_error(self, fault_harness):
        h = fault_harness
        eg = h.egress("dest", schedule=["timeout", "refused", "timeout"])
        with pytest.raises(TimeoutError):
            eg.post(object())
        assert h.registry.peek("dest", "attempts") == 3
        assert h.registry.peek("dest", "failures") == 1

    def test_deadline_budget_stops_retry_ladder(self, fault_harness):
        """A slow destination eats the per-flush budget: even with
        attempts remaining, the ladder stops once the deadline passes
        (slow-then-fail consumes 6s of an 8s budget per attempt)."""
        h = fault_harness
        pol = EgressPolicy(retry=RetryPolicy(
            max_attempts=10, base_backoff_s=0.2, max_backoff_s=5.0,
            deadline_s=8.0))
        tr = h.transport([("slow", 6.0, "timeout"),
                          ("slow", 6.0, "timeout"), "ok"])
        eg = h.egress("slowpoke", policy=pol, transport=tr)
        with pytest.raises(TimeoutError):
            eg.post(object(), timeout_s=10.0)
        # second attempt started inside the budget, third never ran
        assert tr.attempts == 2
        # per-attempt socket timeout is clamped to the remaining budget
        assert tr.calls[0][1] <= 8.0
        assert tr.calls[1][1] <= 2.1

    def test_slow_then_ok_delivers_within_budget(self, fault_harness):
        h = fault_harness
        tr = h.transport([("slow", 1.0, "timeout"), ("slow", 0.5), "ok"])
        eg = h.egress("dest", transport=tr)
        assert eg.post(object(), timeout_s=5.0) == 200
        assert tr.attempts == 2   # slow-then-ok succeeded on attempt 2

    def test_seeded_schedule_always_terminates(self, fault_harness):
        h = fault_harness
        for seed in range(8):
            sched = seeded_schedule(seed, n=3)
            eg = h.egress(f"s{seed}", schedule=sched,
                          policy=EgressPolicy(retry=RetryPolicy(
                              max_attempts=len(sched),
                              deadline_s=1000.0)))
            assert eg.post(object(), timeout_s=1.0) == 200

    def test_retryable_classification(self):
        import urllib.error
        assert is_retryable(TimeoutError())
        assert is_retryable(ConnectionRefusedError())
        assert is_retryable(ConnectionResetError())
        assert is_retryable(HTTPStatusError("d", 503))
        assert is_retryable(HTTPStatusError("d", 429))
        assert not is_retryable(HTTPStatusError("d", 400))
        assert not is_retryable(HTTPStatusError("d", 404))
        assert is_retryable(urllib.error.URLError("dns"))
        assert not is_retryable(ValueError("bug"))
        # breaker-open is transient for OUTER callers (buffer/requeue)
        assert is_retryable(CircuitOpenError("open"))


# -------------------------------------------------------------- breaker

class TestBreaker:
    POL = BreakerPolicy(failure_threshold=3, open_duration_s=30.0,
                        half_open_successes=2)

    def make(self):
        clock = FakeClock()
        reg = ResilienceRegistry()
        return CircuitBreaker("d", self.POL, clock=clock,
                              registry=reg), clock, reg

    def test_closed_to_open_to_half_open_to_closed(self):
        br, clock, reg = self.make()
        assert br.state == "closed"
        for _ in range(2):
            br.record_failure()
        assert br.state == "closed"      # below threshold
        br.record_failure()
        assert br.state == "open"        # threshold hit
        assert reg.peek("d", "breaker_opened") == 1
        assert not br.allow()            # rejected while open
        clock.advance(29.9)
        assert not br.allow()            # still cooling down
        clock.advance(0.2)
        assert br.allow()                # -> half-open, probe admitted
        assert br.state == "half_open"
        assert not br.allow()            # one probe at a time
        br.record_success()
        assert br.state == "half_open"   # needs 2 probe successes
        assert br.allow()
        br.record_success()
        assert br.state == "closed"

    def test_half_open_failure_reopens_and_restarts_timer(self):
        br, clock, reg = self.make()
        for _ in range(3):
            br.record_failure()
        clock.advance(31)
        assert br.allow()
        br.record_failure()              # probe fails
        assert br.state == "open"
        assert reg.peek("d", "breaker_opened") == 2
        clock.advance(15)
        assert not br.allow()            # timer restarted at reopen
        clock.advance(16)
        assert br.allow()

    def test_success_resets_consecutive_failures(self):
        br, _, _ = self.make()
        br.record_failure()
        br.record_failure()
        br.record_success()
        br.record_failure()
        br.record_failure()
        assert br.state == "closed"      # never 3 consecutive

    def test_egress_open_breaker_rejects_without_transport_call(
            self, fault_harness):
        h = fault_harness
        pol = EgressPolicy(
            retry=RetryPolicy(max_attempts=1, deadline_s=8.0),
            breaker=BreakerPolicy(failure_threshold=2,
                                  open_duration_s=30.0))
        tr = h.transport(["timeout"])
        eg = h.egress("dead", policy=pol, transport=tr)
        for _ in range(2):
            with pytest.raises(TimeoutError):
                eg.post(object())
        assert eg.breaker.state == "open"
        with pytest.raises(CircuitOpenError):
            eg.post(object())
        assert tr.attempts == 2          # the rejection cost no attempt
        assert h.registry.peek("dead", "breaker_rejected") == 1
        # cooldown -> half-open probe goes through and closes
        h.clock.advance(31)
        tr.schedule[:] = ["ok"]
        assert eg.post(object()) == 200
        assert eg.breaker.state == "closed"


# ---------------------------------------------------------------- spill

def export_of(histos=(), sets=(), counters=(), gauges=()):
    e = ForwardExport()
    e.histograms.extend(histos)
    e.sets.extend(sets)
    e.counters.extend(counters)
    e.gauges.extend(gauges)
    return e


def hkey(name="h"):
    return MetricKey(name=name, type="timer", joined_tags="")


class TestSpillBuffer:
    def test_counters_sum_sets_or_gauges_lww(self):
        reg = ResilienceRegistry()
        sp = SpillBuffer(destination="d", registry=reg)
        ck = MetricKey("c", "counter", "")
        gk = MetricKey("g", "gauge", "")
        sk = MetricKey("s", "set", "")
        sp.spill(export_of(counters=[(ck, 2.0)], gauges=[(gk, 1.0)],
                           sets=[(sk, np.array([1, 0], np.uint8))]))
        sp.spill(export_of(counters=[(ck, 3.0)], gauges=[(gk, 9.0)],
                           sets=[(sk, np.array([0, 4], np.uint8))]))
        out = sp.merge_into(export_of(gauges=[(gk, 7.0)]))
        assert out.counters == [(ck, 5.0)]            # summed
        assert list(out.sets[0][1]) == [1, 4]         # register max
        # spilled gauge precedes the fresh one: last write wins upstream
        assert out.gauges[0] == (gk, 9.0)
        assert out.gauges[-1] == (gk, 7.0)
        assert len(sp) == 0                           # drained
        assert reg.peek("d", "remerged") == 3

    def test_gauges_age_out_other_types_do_not(self):
        sp = SpillBuffer(gauge_max_age_intervals=2, destination="d",
                         registry=ResilienceRegistry())
        gk = MetricKey("g", "gauge", "")
        ck = MetricKey("c", "counter", "")
        sp.spill(export_of(gauges=[(gk, 1.0)], counters=[(ck, 1.0)]))
        for _ in range(3):   # three more failed intervals, no fresh g
            sp.spill(export_of(counters=[(ck, 1.0)]))
        out = sp.merge_into(export_of())
        assert out.gauges == []                       # evicted at age>2
        assert out.counters == [(ck, 4.0)]            # counters immortal

    def test_budget_eviction_counted(self):
        reg = ResilienceRegistry()
        sp = SpillBuffer(max_sketches=4, destination="d", registry=reg)
        counters = [(MetricKey(f"c{i}", "counter", ""), 1.0)
                    for i in range(10)]
        sp.spill(export_of(counters=counters))
        assert len(sp) == 4
        assert reg.peek("d", "spill_evicted") == 6

    def test_histogram_merge_is_lossless_on_sum_and_count(self):
        sp = SpillBuffer(destination="d", registry=ResilienceRegistry())
        k = hkey()
        m1 = np.array([1.0, 2.0], np.float32)
        w1 = np.array([1.0, 1.0], np.float32)
        m2 = np.array([10.0], np.float32)
        w2 = np.array([3.0], np.float32)
        sp.spill(export_of(histos=[(k, m1, w1, 1.0, 2.0, 3.0, 2.0, 1.5)]))
        sp.spill(export_of(histos=[(k, m2, w2, 10.0, 10.0, 30.0, 3.0,
                                    0.3)]))
        out = sp.merge_into(export_of())
        (key, means, weights, vmin, vmax, vsum, cnt, recip), = \
            out.histograms
        assert key == k
        assert vmin == 1.0 and vmax == 10.0
        assert vsum == 33.0 and cnt == 5.0
        assert recip == pytest.approx(1.8)
        assert float(np.dot(means, weights)) == pytest.approx(33.0)

    def test_centroid_cap_preserves_mass(self):
        sp = SpillBuffer(destination="d", registry=ResilienceRegistry())
        k = hkey()
        rng = np.random.default_rng(7)
        total_w = 0.0
        for _ in range(4):
            m = rng.normal(size=1024).astype(np.float32)
            w = np.ones(1024, np.float32)
            total_w += 1024
            sp.spill(export_of(histos=[(k, m, w, float(m.min()),
                                        float(m.max()), float(m.sum()),
                                        1024.0, 0.0)]))
        (_, means, weights, *_rest), = sp.merge_into(
            export_of()).histograms
        assert len(means) <= SpillBuffer.CENTROID_CAP
        assert float(weights.sum()) == pytest.approx(total_w)


class TestResilientForwarder:
    def test_terminal_failure_replays_matching_oracle(self):
        """The acceptance criterion: interval A's forward fails
        terminally; the next flush replays A under its ORIGINAL
        envelope (seq 1) before sending B (seq 2) — the receiver
        Combines both in seq order, with global quantiles matching the
        oracle fed both intervals together."""
        from veneur_tpu_torch.cluster import wire
        from veneur_tpu_torch.ingest import parser

        local = small_engine()
        rng = np.random.default_rng(3)
        a_vals = rng.gamma(2.0, 10.0, 400)
        b_vals = rng.gamma(9.0, 3.0, 400)

        envs = []
        inner = ScriptedCallable(       # terminal, then good
            [400, "ok"],
            on_success=lambda *a, **kw: envs.append(kw.get("envelope")))
        reg = ResilienceRegistry()
        fwd = ResilientForwarder(inner, destination="global",
                                 sender_id="s", seq_start=1,
                                 registry=reg)

        def one_interval(vals, ts):
            for v in vals:
                local.process(parser.parse_packet(
                    f"remerge.t:{v:.5f}|ms".encode()))
            return local.flush(timestamp=ts)

        res_a = one_interval(a_vals, 10)
        with pytest.raises(HTTPStatusError):
            fwd(res_a.export)
        assert reg.peek("global", "spilled") > 0

        res_b = one_interval(b_vals, 20)
        fwd(res_b.export)              # replays A (seq 1), then sends B
        assert reg.peek("global", "replayed") > 0
        assert len(inner.delivered) == 2
        # the replay kept its original envelope; B got the next seq
        assert [(e.sender_id, e.interval_seq) for e in envs] == \
            [("s", 1), ("s", 2)]
        assert fwd.pending_spill == 0

        # feed the delivered exports into a fresh global engine in
        # delivery order (A then B — the in-order contract)
        glob = small_engine(is_global=True, forward_enabled=False)
        for (args,) in inner.delivered:
            for m in wire.export_to_metrics(args):
                wire.apply_metric_to_engine(glob, m)
        out = {m.name: m.value for m in glob.flush(timestamp=30).metrics}

        oracle = OracleDigest()
        for v in np.concatenate([a_vals, b_vals]):
            oracle.add(float(v))
        assert out["remerge.t.count"] == 800.0   # zero loss
        span = oracle.max - oracle.min
        for q, name in ((0.5, "remerge.t.50percentile"),
                        (0.99, "remerge.t.99percentile")):
            assert abs(out[name] - oracle.quantile(q)) <= 0.05 * span

    def test_success_path_does_not_touch_spill(self):
        inner = ScriptedCallable(["ok"])
        reg = ResilienceRegistry()
        fwd = ResilientForwarder(inner, destination="d", registry=reg)
        ck = MetricKey("c", "counter", "")
        fwd(export_of(counters=[(ck, 1.0)]))
        assert len(fwd.spill) == 0
        assert reg.peek("d", "spilled") == 0
        assert reg.peek("d", "remerged") == 0

    def test_gauge_ages_out_through_production_replay_cycles(self):
        """The real outage shape — park, replay-fail, park the next
        interval too, every flush — must still age gauges out of the
        replay ledger while counters replay lossless."""
        inner = ScriptedCallable(["refused"] * 4 + ["ok"])
        reg = ResilienceRegistry()
        fwd = ResilientForwarder(inner, destination="d",
                                 gauge_max_age_intervals=2,
                                 registry=reg)
        gk = MetricKey("g", "gauge", "")
        ck = MetricKey("c", "counter", "")
        with pytest.raises(ConnectionRefusedError):     # age 0
            fwd(export_of(gauges=[(gk, 5.0)], counters=[(ck, 1.0)]))
        for _ in range(3):   # ages 1, 2, then evicted at 3 > 2
            with pytest.raises(ConnectionRefusedError):
                fwd(export_of(counters=[(ck, 1.0)]))
        fwd(export_of(counters=[(ck, 1.0)]))  # replays all, then sends
        assert fwd.pending_spill == 0
        gauges, counters = [], 0.0
        for (delivered,) in inner.delivered:
            gauges.extend(delivered.gauges)
            counters += sum(v for _, v in delivered.counters)
        assert gauges == []                             # aged out
        assert counters == 5.0                          # lossless
        assert reg.peek("d", "spill_evicted") == 1

    def test_fresh_gauge_report_outlives_stale_one_mid_outage(self):
        """A gauge re-reported mid-outage lives in a YOUNGER ledger
        entry: the stale value ages out of its own entry while the
        fresh one survives to replay (and, replaying in seq order,
        would win last-write-wins at the receiver regardless)."""
        inner = ScriptedCallable(["refused"] * 4 + ["ok"])
        fwd = ResilientForwarder(inner, destination="d",
                                 gauge_max_age_intervals=2,
                                 registry=ResilienceRegistry())
        gk = MetricKey("g", "gauge", "")
        with pytest.raises(ConnectionRefusedError):
            fwd(export_of(gauges=[(gk, 1.0)]))          # age 0
        with pytest.raises(ConnectionRefusedError):
            fwd(export_of())                            # age 1
        with pytest.raises(ConnectionRefusedError):
            fwd(export_of(gauges=[(gk, 2.0)]))          # fresh entry
        with pytest.raises(ConnectionRefusedError):
            fwd(export_of())                            # stale evicted
        fwd(export_of())                                # delivers
        assert fwd.pending_spill == 0
        gauges = [g for (d,) in inner.delivered for g in d.gauges]
        assert gauges == [(gk, 2.0)]          # survived, fresh, LWW-last

    def test_partial_delivery_spills_only_the_unsent_tail(self):
        from veneur_tpu_torch.resilience import PartialDeliveryError

        k1 = MetricKey("c1", "counter", "")
        k2 = MetricKey("c2", "counter", "")

        calls = []

        def inner(export):
            calls.append(export)
            if len(calls) == 1:
                # pretend the first entry (c1) landed upstream
                raise PartialDeliveryError(
                    export_of(counters=[(k2, 7.0)]), OSError("mid"))

        reg = ResilienceRegistry()
        fwd = ResilientForwarder(inner, destination="d", registry=reg)
        with pytest.raises(PartialDeliveryError):
            fwd(export_of(counters=[(k1, 3.0), (k2, 7.0)]))
        # only the undelivered entry is pending
        assert fwd.pending_spill == 1
        fwd(export_of())
        assert calls[-1].counters == [(k2, 7.0)]   # no c1 re-send
        assert fwd.pending_spill == 0

    def test_grpc_export_tail_maps_wire_order_back_to_export(self):
        from veneur_tpu_torch.cluster.forward import _export_tail

        hk = hkey()
        sk = MetricKey("s", "set", "")
        ck = MetricKey("c", "counter", "")
        gk = MetricKey("g", "gauge", "")
        exp = export_of(
            histos=[(hk, np.ones(2, np.float32), np.ones(2, np.float32),
                     0.0, 1.0, 1.0, 2.0, 0.0)],
            sets=[(sk, np.zeros(4, np.uint8))],
            counters=[(ck, 1.0)], gauges=[(gk, 2.0)])
        # wire order: histo(0), set(1), counter(2), gauge(3)
        tail = _export_tail(exp, 2)
        assert tail.histograms == [] and tail.sets == []
        assert tail.counters == [(ck, 1.0)]
        assert tail.gauges == [(gk, 2.0)]
        tail = _export_tail(exp, 1)
        assert tail.histograms == [] and len(tail.sets) == 1
        assert _export_tail(exp, 0).counters == [(ck, 1.0)]
        assert len(_export_tail(exp, 4).gauges) == 0

    def test_low_breaker_threshold_cannot_cut_retries_short(
            self, fault_harness):
        """breaker_failure_threshold=1 with retries: the breaker records
        the call's FINAL outcome, so a mid-ladder transient cannot trip
        it and mask the real error with CircuitOpenError."""
        h = fault_harness
        pol = EgressPolicy(
            retry=RetryPolicy(max_attempts=3, deadline_s=8.0),
            breaker=BreakerPolicy(failure_threshold=1))
        eg = h.egress("touchy", policy=pol,
                      transport=h.transport([503, 503, "ok"]))
        assert eg.post(object()) == 200          # full ladder ran
        assert eg.breaker.state == "closed"
        # a terminally-failing call still opens it on its final outcome
        eg2 = h.egress("touchy2", policy=pol,
                       transport=h.transport(["timeout"]))
        with pytest.raises(TimeoutError):
            eg2.post(object())
        assert eg2.breaker.state == "open"

    def test_shared_deadline_spans_batches(self, fault_harness):
        """Multi-batch forwards share ONE deadline budget: each batch's
        per-attempt socket timeout shrinks as earlier batches consume
        the budget (no N x retry_deadline flush stalls)."""
        from veneur_tpu_torch.cluster.forward import GrpcForwarder

        h = fault_harness
        fwd = GrpcForwarder("127.0.0.1:1", timeout_s=10.0,
                            max_per_batch=1, egress=h.egress("up"))
        seen = []

        def fake_send(batch, timeout=None):
            seen.append(timeout)
            h.clock.advance(5.0)

        fwd._send = fake_send
        ck = [(MetricKey(f"c{i}", "counter", ""), 1.0) for i in range(3)]
        fwd(export_of(counters=ck))   # 3 batches, deadline_s=8
        assert seen[0] == pytest.approx(8.0)   # full budget
        assert seen[1] == pytest.approx(3.0)   # 5s consumed
        assert seen[2] == pytest.approx(0.001)  # budget gone: floor

    def test_spilled_sketches_forward_even_on_idle_intervals(self):
        """Stranding fix: once sketches are spilled, an interval with
        no new exports must still attempt the forward so the spill
        drains as soon as the endpoint recovers."""
        from veneur_tpu_torch.config import read_config
        from veneur_tpu_torch.ingest import parser
        from veneur_tpu_torch.server import Server
        from veneur_tpu_torch.sinks.basic import CaptureMetricSink

        cfg = read_config(text="""
interval: "1s"
statsd_listen_addresses: []
forward_address: "placeholder:1"
tpu_histogram_slots: 256
tpu_counter_slots: 256
tpu_gauge_slots: 256
tpu_set_slots: 128
""")
        inner = ScriptedCallable(["refused", "ok"])
        srv = Server(cfg, sinks=[CaptureMetricSink()], plugins=[],
                     device="cpu", forwarder=ResilientForwarder(
                         inner, destination="d",
                         registry=ResilienceRegistry()))
        try:
            # a timer: mixed-scope histograms forward their digest
            # (plain counters stay local under forwarding)
            srv.engines[0].process(
                parser.parse_packet(b"strand.t:5|ms"))
            srv.flush_once(timestamp=10)       # forward fails, spills
            assert srv.forwarder.pending_spill == 1
            assert inner.delivered == []
            srv.flush_once(timestamp=20)       # idle interval: retries
            assert srv.forwarder.pending_spill == 0
            (delivered,) = inner.delivered[-1]
            (key, _m, _w, _mn, _mx, _sum, cnt, _r), = \
                delivered.histograms
            assert key.name == "strand.t" and cnt == 1.0
        finally:
            srv.stop()

    def test_discovering_forwarder_closes_pruned_destinations(self):
        from veneur_tpu_torch.cluster.discovery import StaticDiscoverer
        from veneur_tpu_torch.cluster.forward import DiscoveringForwarder

        closed = []

        class FakeFwd:
            def __init__(self, dest):
                self.dest = dest

            def __call__(self, export):
                pass

            def close(self):
                closed.append(self.dest)

        disc = StaticDiscoverer(["a:1", "b:2"])
        fwd = DiscoveringForwarder(disc, "svc", refresh_interval_s=0.0,
                                   forwarder_factory=FakeFwd)
        fwd(None)
        fwd(None)   # both destinations now have live forwarders
        disc.destinations = ["b:2"]
        fwd(None)
        assert closed == ["a:1"]

    def test_repeated_failures_accumulate_losslessly(self):
        inner = ScriptedCallable(["refused", "refused", "refused", "ok"])
        reg = ResilienceRegistry()
        fwd = ResilientForwarder(inner, destination="d", registry=reg)
        ck = MetricKey("c", "counter", "")
        for i in range(3):
            with pytest.raises(ConnectionRefusedError):
                fwd(export_of(counters=[(ck, 1.0)]))
        fwd(export_of(counters=[(ck, 1.0)]))
        # all four intervals delivered, in seq order, nothing doubled
        assert fwd.pending_spill == 0
        total = sum(v for (d,) in inner.delivered
                    for _, v in d.counters)
        assert total == 4.0

    def test_replay_ladder_honors_wall_budget(self, fault_harness):
        """Regression: N parked intervals must not
        stall one flush tick for N x retry_deadline — the ladder stops
        at replay_budget_s and defers the rest to the next flush."""
        from veneur_tpu_torch.resilience import TransientEgressError

        h = fault_harness

        def slow_inner(export):
            h.clock.advance(5.0)     # each replay burns 5 fake seconds

        fwd = ResilientForwarder(slow_inner, destination="d",
                                 registry=ResilienceRegistry())
        ck = MetricKey("c", "counter", "")
        # park 4 intervals (no budget during the outage itself)
        fail = ResilientForwarder(
            ScriptedCallable(["refused"]), destination="d",
            registry=ResilienceRegistry())
        for entry_vals in range(4):
            with pytest.raises(ConnectionRefusedError):
                fail(export_of(counters=[(ck, 1.0)]))
        fwd._entries = fail._entries           # hand over the backlog
        fwd.replay_budget_s = 12.0
        fwd._clock = h.clock
        t0 = h.clock()
        with pytest.raises(TransientEgressError, match="budget"):
            fwd(export_of(counters=[(ck, 1.0)]))
        # 5s + 5s + 5s > 12s budget: 3 replays ran, ladder stopped,
        # the rest (plus the parked current interval) wait for the
        # next flush instead of stalling this one indefinitely
        assert h.clock() - t0 == pytest.approx(15.0)
        assert fwd.pending_spill == 2          # 1 deferred + 1 parked
        # next flush (budget refreshed) drains the remainder
        fwd(export_of())
        assert fwd.pending_spill == 0

    def test_ledger_overflow_demotes_oldest_to_merged_tier(self):
        """Replay entries beyond max_spill_intervals fold into the
        same-key-merged overflow tier and ride the NEXT interval's
        fresh envelope (counted as reenveloped — the documented
        at-least-once degradation)."""
        envs = []
        inner = ScriptedCallable(
            ["refused"] * 4 + ["ok"],
            on_success=lambda *a, **kw: envs.append(kw.get("envelope")))
        reg = ResilienceRegistry()
        fwd = ResilientForwarder(inner, destination="d",
                                 max_spill_intervals=2, sender_id="s",
                                 seq_start=1, registry=reg)
        ck = MetricKey("c", "counter", "")
        for i in range(4):
            with pytest.raises(ConnectionRefusedError):
                fwd(export_of(counters=[(ck, 1.0)]))
        # 4 failed intervals, ledger bound 2: two demoted and merged
        assert reg.peek("d", "reenveloped") == 2
        assert fwd.pending_spill == 3   # 2 entries + 1 merged overflow
        fwd(export_of(counters=[(ck, 1.0)]))
        assert fwd.pending_spill == 0
        total = sum(v for (d,) in inner.delivered
                    for _, v in d.counters)
        assert total == 5.0             # lossless through the demotion
        # replays used original seqs; the merged tier rode the final
        # interval's fresh envelope
        seqs = [e.interval_seq for e in envs]
        assert seqs == sorted(seqs) and seqs[-1] == 5


# ------------------------------------------------- server integration

class TestServerIntegration:
    def make_server(self, **overrides):
        from veneur_tpu_torch.config import read_config
        from veneur_tpu_torch.server import Server
        from veneur_tpu_torch.sinks.basic import CaptureMetricSink

        cfg = read_config(text="""
interval: "1s"
statsd_listen_addresses: []
hostname: testhost
tpu_histogram_slots: 256
tpu_counter_slots: 256
tpu_gauge_slots: 256
tpu_set_slots: 128
tpu_batch_size: 256
tpu_buffer_depth: 128
""")
        for k, v in overrides.items():
            setattr(cfg, k, v)
        sink = CaptureMetricSink()
        return Server(cfg, sinks=[sink], plugins=[], device="cpu"), sink

    def test_flush_timeout_plumbed_to_sinks_and_forwarder(self):
        """flush_timeout and the retry knobs reach the config-built
        forwarder instead of its hardcoded defaults (the config-built
        sinks that also take them are ROADMAP item 9b.2)."""
        from veneur_tpu_torch.config import read_config
        from veneur_tpu_torch.resilience import ResilientForwarder
        from veneur_tpu_torch.server import Server

        cfg = read_config(text="""
interval: "1s"
statsd_listen_addresses: []
flush_timeout: "3s"
retry_max_attempts: 7
forward_address: "http://127.0.0.1:1"
forward_use_grpc: false
tpu_histogram_slots: 256
tpu_counter_slots: 256
tpu_gauge_slots: 256
tpu_set_slots: 128
""")
        srv = Server(cfg, device="cpu")   # forwarder built from config
        try:
            assert isinstance(srv.forwarder, ResilientForwarder)
            assert srv.forwarder.inner.timeout_s == 3.0
            # the retry knob reached the forwarder's egress policy
            assert srv.forwarder.inner._egress.policy.retry \
                .max_attempts == 7
        finally:
            srv.stop()

    def test_resilience_counters_surface_in_self_metrics(self):
        from veneur_tpu_torch import resilience

        srv, _sink = self.make_server()
        try:
            resilience.DEFAULT_REGISTRY.incr("dest-x", "retries", 5)
            resilience.DEFAULT_REGISTRY.incr("dest-x", "remerged", 2)
            out = {(m.name, tuple(m.tags)): m.value
                   for m in srv._self_metrics(ts=1, t0=0.0)}
            assert out[("veneur.resilience.retries_total",
                        ("destination:dest-x",))] == 5.0
            assert out[("veneur.resilience.remerged_total",
                        ("destination:dest-x",))] == 2.0
            # drained: the next interval reports nothing
            again = [m for m in srv._self_metrics(ts=2, t0=0.0)
                     if m.name.startswith("veneur.resilience.")]
            assert again == []
        finally:
            srv.stop()


# --------------------------------------------------------- Server.drain

class TestServerDrain:
    def test_deadline_expiry_path_with_injected_clock(self):
        """An unserviced queue item (server never started -> no worker
        threads) must expire the drain deadline — driven entirely by
        the fault clock, no real waiting."""
        from veneur_tpu_torch.utils.faults import FakeClock

        srv, _sink = TestServerIntegration().make_server()
        try:
            clock = FakeClock()
            srv.worker_queues[0].put_nowait(object())
            assert srv.drain(timeout=5.0, clock=clock,
                             sleep=clock.sleep) is False
            assert clock() >= 5.0          # the clock, not the wall
            assert clock.sleeps           # it polled, then gave up
        finally:
            srv.stop()

    def test_drain_succeeds_on_settled_queues(self):
        from veneur_tpu_torch.utils.faults import FakeClock

        srv, _sink = TestServerIntegration().make_server()
        try:
            clock = FakeClock()
            assert srv.drain(timeout=5.0, clock=clock,
                             sleep=clock.sleep) is True
        finally:
            srv.stop()


# ------------------------------------------- the port against the reference

def _package(name):
    """(MetricKey, ForwardExport, resilience, forward) of one package."""
    import importlib
    return tuple(importlib.import_module(f"{name}.{m}") for m in (
        "ingest.parser", "models.pipeline", "resilience",
        "cluster.forward"))


def _exports(pkg, seed, n):
    """n intervals of mixed exports from one seed, built with `pkg`'s
    classes: histograms, sets, counters and gauges over a small key
    space, so the spill tier merges same-key entries."""
    parser, pipeline, _res, _fwd = pkg
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        e = pipeline.ForwardExport()
        for k in rng.choice(6, 2, replace=False):
            m = np.sort(rng.normal(50, 9, 24)).astype(np.float32)
            w = rng.integers(1, 4, 24).astype(np.float32)
            e.histograms.append((parser.MetricKey(f"h{k}", "timer", ""), m,
                                 w, float(m.min()), float(m.max()),
                                 float(m @ w), float(w.sum()), 0.5))
        for k in rng.choice(4, 2, replace=False):
            e.sets.append((parser.MetricKey(f"s{k}", "set", ""),
                           rng.integers(0, 20, 64).astype(np.uint8)))
        for k in rng.choice(8, 3, replace=False):
            e.counters.append((parser.MetricKey(f"c{k}", "counter", ""),
                               float(rng.integers(1, 100))))
        if rng.random() < 0.7:
            e.gauges.append((parser.MetricKey("g", "gauge", ""),
                             float(rng.normal())))
        out.append(e)
    return out


def _summary(export) -> tuple:
    return (tuple((k.name, m.tolist(), w.tolist(), mn, mx, sm, c, r)
                  for k, m, w, mn, mx, sm, c, r in export.histograms),
            tuple((k.name, np.asarray(r).tolist()) for k, r in export.sets),
            tuple((k.name, v) for k, v in export.counters),
            tuple((k.name, v) for k, v in export.gauges), export.kind)


def _drive_ladder(name, seed, steps):
    """Drive one package's ResilientForwarder through `steps` (one per
    send attempt: ok, fail, ack_lost, partial, gap) over seeded exports,
    the kind of each interval asked from next_forward_kind() as the
    server asks it; return everything observable."""
    pkg = _package(name)
    _parser, _pipeline, res, fwdmod = pkg
    script = iter(steps)
    wire_log = []

    def inner(export, envelope=None):
        step = next(script, "ok")
        env = (envelope.sender_id, envelope.interval_seq,
               envelope.chunk_offset, envelope.chunk_count, envelope.kind)
        n = (len(export.histograms) + len(export.sets)
             + len(export.counters) + len(export.gauges))
        if step == "gap" and envelope.kind == "delta":
            wire_log.append(("gap", env))
            raise res.DeltaGapRefusedError("delta-over-gap")
        if step == "partial" and n >= 2:
            head = fwdmod._export_tail(export, 0)
            del head.gauges[:]
            wire_log.append(("partial", env, _summary(head)))
            raise res.PartialDeliveryError(
                fwdmod._export_tail(export, n // 2), OSError("mid"),
                delivered_chunks=1, chunk_count=2)
        if step == "fail":
            wire_log.append(("fail", env))
            raise ConnectionRefusedError("scripted")
        wire_log.append(("ok" if step != "ack_lost" else "ack_lost", env,
                         _summary(export)))
        if step == "ack_lost":
            raise TimeoutError("scripted ack lost")

    reg = res.ResilienceRegistry()
    fwd = res.ResilientForwarder(inner, destination="d", sender_id="s",
                                 seq_start=1, max_spill_intervals=3,
                                 gauge_max_age_intervals=2,
                                 full_resync_intervals=4, registry=reg)
    outcomes = []
    for export in _exports(pkg, seed, 14):
        export.kind = fwd.next_forward_kind()
        try:
            fwd(export)
            outcomes.append("ok")
        except Exception as e:
            outcomes.append(type(e).__name__)
    return (wire_log, outcomes, sorted(reg.take().items()),
            fwd.pending_spill, fwd.debug_state()["delta"])


@pytest.mark.parametrize("seed", range(6))
def test_replay_ladder_matches_the_reference(seed):
    """The same exports and the same scripted faults — refused sends,
    ambiguous ack losses, partial deliveries, delta-over-gap refusals —
    through the reference's ladder and the port's: the same envelopes
    on every send, the same payloads, outcomes, counters, pending
    spill and delta posture (Exact level: the ladder is host code)."""
    rng = np.random.default_rng(100 + seed)
    steps = list(rng.choice(["ok", "ok", "fail", "ack_lost", "partial",
                             "gap"], 40))
    ref = _drive_ladder("veneur_tpu", seed, steps)
    port = _drive_ladder("veneur_tpu_torch", seed, steps)
    assert port == ref
    kinds = {e[1][4] for e in port[0]}
    assert kinds == {"full", "delta"}       # both kinds went on the wire


def test_journal_arm_is_refused_naming_item_11(tmp_path):
    """Item 11 is ported: the journal arm is served, no longer refused.
    A forwarder over a ForwardJournal parks a failed interval in the
    journal, and a new forwarder on the same directory recovers it under
    its original envelope."""
    from veneur_tpu_torch.durability import ForwardJournal
    from veneur_tpu_torch.utils.faults import kill_journal_lock
    exp = ForwardExport()
    exp.counters.append((MetricKey("c", "counter", ""), 2.0))
    j1 = ForwardJournal(str(tmp_path))
    rf = ResilientForwarder(ScriptedCallable(["refused"]), journal=j1,
                            sender_id="s-11", seq_start=5)
    with pytest.raises(Exception):
        rf(exp)
    kill_journal_lock(j1)
    sent = []
    rf2 = ResilientForwarder(
        lambda export, envelope=None: sent.append(envelope),
        journal=ForwardJournal(str(tmp_path)), sender_id="other")
    assert rf2.sender_id == "s-11" and rf2.pending_spill == 1
    rf2(ForwardExport())
    assert [(e.sender_id, e.interval_seq) for e in sent] == [("s-11", 5)]
    rf2.close()


def test_forwarding_server_counters_reach_self_metrics():
    """A port Server forwarding through a ResilientForwarder: a failed
    interval spills (veneur.resilience.spilled_total), the next tick
    replays it (replayed_total), each drained into the NEXT flush's
    self-metrics under the destination's tag; /debug/flush and /healthz
    carry the ladder."""
    from veneur_tpu_torch import observe
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ingest import parser
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.basic import CaptureMetricSink

    observe.DEFAULT_REGISTRY.take()      # start from a drained registry
    inner = ScriptedCallable(["refused", "ok"])
    cap = CaptureMetricSink()
    srv = Server(Config(statsd_listen_addresses=[], interval="3600s",
                        forward_address="placeholder:1",
                        tpu_histogram_slots=256, tpu_counter_slots=128,
                        tpu_gauge_slots=128, tpu_set_slots=64,
                        tpu_batch_size=256),
                 sinks=[cap], plugins=[], device="cpu",
                 forwarder=ResilientForwarder(inner, destination="dx"))
    try:
        srv.engines[0].process(parser.parse_packet(b"fwd.t:5|ms"))
        srv.flush_once(timestamp=10)          # forward fails, parks
        st = srv._debug_flush_state()["forward"]
        assert st["pending_spill"] == 1 and len(st["ladder"]) == 1
        health = srv.health_state()
        assert health["checks"]["forward"]["ok"] is False
        assert health["status"] == "degraded"
        srv.flush_once(timestamp=20)          # replays
        srv.flush_once(timestamp=30)
        assert cap.wait_for_flush(3)
        tagged = [{(m.name, tuple(m.tags)): m.value for m in f}
                  for f in cap.flushes]
        key = ("veneur.resilience.spilled_total", ("destination:dx",))
        assert tagged[1][key] == 1.0
        assert tagged[2][("veneur.resilience.replayed_total",
                          ("destination:dx",))] == 1.0
        assert srv.forwarder.pending_spill == 0
        assert srv.health_state()["checks"]["forward"]["ok"] is True
        (delivered,) = inner.delivered[-1]
        assert [k.name for k, *_ in delivered.histograms] == ["fwd.t"]
    finally:
        srv.stop()

