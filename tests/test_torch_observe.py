"""The port's observe/ against the reference's: the same counter, gauge
and phase sequence through both packages' TelemetryRegistry,
FlightRecorder and FleetView gives the same veneur.* rows, phase trees
and fleet views."""

import dataclasses

from veneur_tpu import observe as jobs
from veneur_tpu_torch import observe as tobs


def _metric_rows(metrics):
    return [(m.name, m.timestamp, m.value, list(m.tags), int(m.type),
             m.hostname) for m in metrics]


def _feed_registry(obs):
    reg = obs.TelemetryRegistry()
    S = obs.SERVER_SCOPE
    for name, n in (("packet.received", 7), ("packet.error", 1),
                    ("worker.dropped", 0)):
        reg.incr(S, name, n)
    reg.mark(S, "worker.dropped", 0)
    reg.mark("sink:capture", "sink.metrics_flushed", 12)
    reg.incr("http://global:8127", "attempts", 3)
    reg.set_gauge(S, "flush.total_duration_ns", 1.5e6)
    reg.set_gauge("sender:abc", "e2e.freshness_age_ns", 42)
    reg.incr_level(S, "flush.count", 2)
    return reg


def test_registry_drains_the_same_rows():
    j, t = _feed_registry(jobs), _feed_registry(tobs)
    assert t.peek(tobs.SERVER_SCOPE, "packet.received") == 7
    assert _metric_rows(t.snapshot(5, "h")) == _metric_rows(
        j.snapshot(5, "h"))
    assert t.debug_state() == j.debug_state()
    assert t.totals_by_name_prefix("sink.") == j.totals_by_name_prefix(
        "sink.")
    rows = _metric_rows(t.drain(5, "h"))
    assert rows == _metric_rows(j.drain(5, "h"))
    assert ("veneur.packet.received_total", 5, 7, [], 0, "h") in rows
    assert ("veneur.resilience.attempts_total", 5, 3,
            ["destination:http://global:8127"], 0, "h") in rows
    assert _metric_rows(t.drain(6)) == _metric_rows(j.drain(6)) == []
    assert t.level(tobs.SERVER_SCOPE, "flush.count") == 2
    assert t.total(tobs.SERVER_SCOPE, "packet.received") == 7


def _feed_recorder(obs):
    fr = obs.FlightRecorder(capacity=2, max_phases=8)
    trees = []
    for ts in (100, 110, 120):
        tick = fr.begin_tick(ts)
        token = obs.set_current_tick(tick)
        assert obs.current_tick() is tick
        ep = tick.start("engine")
        ef = tick.add("engine.flush", 10, 50, parent=ep, engine=0)
        tick.add("engine.swap", 10, 12, parent=ef)
        tick.add("engine.device.exec", 20, 45, parent=ef)
        tick.finish(ep)
        tick.annotate(ep, n=ts)
        tick.add("telemetry", 60, 70)
        for i in range(4):                  # past the slot budget
            tick.finish(tick.start(f"sink.flush.{i}"))
        obs.reset_current_tick(token)
        fr.end_tick(tick)
        d = tick.to_dict()
        trees.append((d["tick_id"], d["timestamp"], d["dropped_phases"],
                      [(p["name"], p["parent"], p["in_flight"],
                        p.get("meta")) for p in d["phases"]],
                      [p for p in tick.phases() if p[1] == 10]))
        samples = obs.phase_timer_samples(tick)
        trees.append([(m.key, m.digest, m.scope) for m in samples])
        trees.append([(m.key, m.digest, m.value, m.scope)
                      for m in samples if m.key.name.endswith("telemetry")])
    assert obs.current_tick() is None
    state = fr.debug_state()
    trees.append((state["tick_count"], state["capacity"],
                  [t["tick_id"] for t in state["ticks"]]))
    assert fr.emit_spans(fr.last_tick(), None) == 0
    return fr, trees


def _as_plain(x):
    """MetricKey dataclasses of two packages compare by their fields."""
    if dataclasses.is_dataclass(x):
        return dataclasses.astuple(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_as_plain(v) for v in x)
    return x


def test_recorder_records_the_same_phase_trees():
    _, jtrees = _feed_recorder(jobs)
    tfr, ttrees = _feed_recorder(tobs)
    assert _as_plain(ttrees) == _as_plain(jtrees)
    # one tick: 8 phase slots, 9 phases asked for, 1 dropped
    assert ttrees[0][2] == 1


class _Spans:
    def __init__(self):
        self.spans = []

    def record(self, span):
        self.spans.append(span)
        return True


def test_emit_spans_with_a_client_is_not_ported():
    """Ported since: with a client, emit_spans replays the last tick as
    the reference's span tree (names and parents; the fixed-edge phases'
    durations)."""
    trees = []
    for obs in (jobs, tobs):
        fr, _ = _feed_recorder(obs)
        tick, client = fr.last_tick(), _Spans()
        n = fr.emit_spans(tick, client)
        assert n == len(client.spans) > 1
        ids = {sp.id: i for i, sp in enumerate(client.spans)}
        trees.append([(sp.name, ids.get(sp.parent_id),
                       sp.end_timestamp - sp.start_timestamp
                       if sp.name.endswith(("swap", "exec", "telemetry"))
                       else None)
                      for sp in client.spans[1:]])
    assert trees[1] == trees[0]


def test_timer_samples_are_the_references():
    for name, fn in (("fanout", lambda o: [o.fanout_timer_sample("capture",
                                                                 2.5)]),
                     ("e2e", lambda o: o.e2e_timer_samples(
                         {"s1": [1.0, 2.0], "s2": [3.0]}))):
        t = [(m.key, m.digest, m.value, m.scope) for m in fn(tobs)]
        j = [(m.key, m.digest, m.value, m.scope) for m in fn(jobs)]
        assert _as_plain(t) == _as_plain(j), name


def _feed_fleet(obs):
    clock = iter(range(10_000_000_000, 10**12, 1_000_000_000))
    fv = obs.FleetView(max_senders=2, window=8, clock=lambda: next(clock))
    fv.observe_interval("a", 1, close_ns=5_000_000_000)
    fv.observe_interval("b", 1, close_ns=6_000_000_000)
    fv.note_stamp("b", "h=tdigest/1,s=hll/1", True)
    fv.note_stamp("c", None, False)          # evicts a (max_senders 2)
    e2e = fv.on_flush(20_000_000_000)
    return (e2e, fv.freshness(21_000_000_000), fv.sender_count(),
            fv.debug_state(22_000_000_000))


def test_fleet_view_is_the_references():
    assert _feed_fleet(tobs) == _feed_fleet(jobs)
    obs = tobs.ImportObserver(fleet=tobs.FleetView(),
                              flight=tobs.FlightRecorder(4, 16))
    with obs.request(("s", 3), None, "http") as scope:
        scope.admitted = True
        scope.finish(scope.start("apply"), n_metrics=1)
    assert obs.debug_state()["tick_count"] == 1
    assert obs.fleet.sender_count() == 1
