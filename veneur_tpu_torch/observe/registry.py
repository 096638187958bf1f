"""The unified telemetry registry — the one spine for veneur.* self-metrics
(the port's copy of veneur_tpu/observe/registry.py: the same keys, names
and drains).

Before this module the process had three disjoint self-telemetry
surfaces: the egress layer's ResilienceRegistry, the durability
package's `veneur.durability.*` counter drain, and the Server's ad-hoc
attribute counters under `_stats_lock`. They are now all instances (or
scopes) of ONE `TelemetryRegistry`, and the name/tag mapping from
registry keys to wire metrics lives in exactly one place —
`TelemetryRegistry.drain` below. vlint TL01 enforces the monopoly:
naming a `veneur.*` self-metric anywhere else in the tree is flagged.

Key model: every counter/gauge is addressed by `(scope, name)`.

  scope `_server`         the owning Server's process-wide accounting;
                          drains with NO tags
                          (`veneur.packet.received_total`, ...)
  scope `"kind:instance"` a per-component stat (kind one of sink /
                          plugin / spansink, e.g. `sink:datadog`);
                          drains tagged with the scope itself
  scope anything else     a per-destination egress stat; drains tagged
                          `destination:<scope>` (destinations are
                          often URLs, so a bare `:` cannot be the
                          component-kind discriminator)

Name model (unchanged from the pre-unification drains, so every
existing dashboard keeps working):

  dotted name             `veneur.<name>` (+ `_total` for counters):
                          `flush.error` -> `veneur.flush.error_total`
  plain name              the egress layer's short counters land under
                          `veneur.resilience.<name>_total`

Counters are interval-delta (drained-and-reset each flush, like the
reference's internal statsd client) with a cumulative shadow for
scrape surfaces (`snapshot`, Prometheus semantics). Gauges are
last-write-wins and cleared on drain (a component that didn't report
this interval emits nothing). Levels are monotonic process-lifetime
counts that never drain (e.g. `flush.count`).
"""

from __future__ import annotations

import threading

from ..metrics import InterMetric, MetricType

# The one scope that drains untagged: the Server's own accounting.
SERVER_SCOPE = "_server"

_PREFIX = "veneur."
_RESILIENCE_PREFIX = "veneur.resilience."

# Self-timer names for the flight recorder's dogfood loop (the only
# other veneur.* names this module mints): each flush tick's top-level
# phase durations are re-ingested as LOCAL-ONLY timers, so the server's
# own t-digest engine serves percentiles of its own flush phases.
PHASE_TIMER_PREFIX = "veneur.flush.phase."

# The flight recorder's name for a collection grafted into a tick's tree;
# a collection is not a flush phase, so the dogfood loop skips it.
GC_PHASE = "gc"


def metric_name(name: str, counter: bool) -> str:
    """Registry key name -> wire metric name (the one mapping)."""
    full = (_PREFIX + name) if "." in name else (_RESILIENCE_PREFIX
                                                + name)
    return full + ("_total" if counter else "")


# component kinds whose scopes tag as themselves ("sink:datadog" ->
# tag sink:datadog, "sender:<id>" -> the fleet view's per-sender
# freshness/e2e gauges); anything else is a destination
_COMPONENT_KINDS = ("sink:", "plugin:", "spansink:", "sender:")


def scope_tags(scope: str) -> list:
    if scope == SERVER_SCOPE:
        return []
    if scope.startswith(_COMPONENT_KINDS):
        return [scope]
    return [f"destination:{scope}"]


class TelemetryRegistry:
    """Thread-safe (scope, name)-keyed counters/gauges/levels, drained
    once per flush by the server into veneur.* self-metrics. This class
    IS the former ResilienceRegistry (resilience.py re-exports it under
    that name); `incr`/`take`/`peek` keep their exact contracts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, str], int] = {}
        self._cumulative: dict[tuple[str, str], int] = {}
        self._gauges: dict[tuple[str, str], float] = {}
        self._levels: dict[tuple[str, str], int] = {}

    # ---- counters (interval-delta + cumulative shadow) ----

    def incr(self, destination: str, counter: str, n: int = 1):
        if n == 0:
            return
        self.mark(destination, counter, n)

    def mark(self, scope: str, name: str, n: int = 1):
        """Like incr, but records the key even when n == 0 — for
        per-interval stats whose ZERO is a signal (a sink that flushed
        0 metrics or hit 0 errors still reports, as the pre-unification
        sink-stat drain did)."""
        with self._lock:
            key = (scope, name)
            self._counters[key] = self._counters.get(key, 0) + n
            self._cumulative[key] = self._cumulative.get(key, 0) + n

    def take(self) -> dict[tuple[str, str], int]:
        """Drain: return-and-reset (interval-delta semantics, like the
        server's other self-telemetry counters)."""
        with self._lock:
            out, self._counters = self._counters, {}
        return out

    def peek(self, destination: str, counter: str) -> int:
        with self._lock:
            return self._counters.get((destination, counter), 0)

    def total(self, scope: str, name: str) -> int:
        """Cumulative count since process start (survives drains)."""
        with self._lock:
            return self._cumulative.get((scope, name), 0)

    def totals_by_name_prefix(self, prefix: str) -> dict:
        """{(scope, name): cumulative} for every counter whose name
        starts with `prefix` — scrape surfaces (the /debug/fleet
        forward-bytes block) read destination-scoped families without
        knowing the destination strings up front."""
        with self._lock:
            return {(s, n): v for (s, n), v in self._cumulative.items()
                    if n.startswith(prefix)}

    # ---- gauges (last-write-wins, cleared on drain) ----

    def set_gauge(self, scope: str, name: str, value: float):
        with self._lock:
            self._gauges[(scope, name)] = float(value)

    def take_gauges(self) -> dict[tuple[str, str], float]:
        with self._lock:
            out, self._gauges = self._gauges, {}
        return out

    # ---- levels (monotonic, never drained) ----

    def incr_level(self, scope: str, name: str, n: int = 1):
        with self._lock:
            key = (scope, name)
            self._levels[key] = self._levels.get(key, 0) + n

    def level(self, scope: str, name: str) -> int:
        with self._lock:
            return self._levels.get((scope, name), 0)

    # ---- drains ----

    def drain(self, ts: int, hostname: str = "") -> list[InterMetric]:
        """One interval's self-metrics: every counter (reset) and gauge
        (cleared), named and tagged by the module-level mapping. The
        ONE place registry keys become veneur.* wire names."""
        out = []
        for (scope, cname), v in sorted(self.take().items()):
            out.append(InterMetric(
                name=metric_name(cname, counter=True), timestamp=ts,
                value=v, tags=scope_tags(scope),
                type=MetricType.COUNTER, hostname=hostname))
        for (scope, gname), v in sorted(self.take_gauges().items()):
            out.append(InterMetric(
                name=metric_name(gname, counter=False), timestamp=ts,
                value=v, tags=scope_tags(scope),
                type=MetricType.GAUGE, hostname=hostname))
        return out

    def snapshot(self, ts: int, hostname: str = "") -> list[InterMetric]:
        """Non-destructive view for scrape surfaces: cumulative
        counters (Prometheus counter semantics), current gauges, and
        levels (as gauges). Nothing is reset."""
        with self._lock:
            counters = dict(self._cumulative)
            gauges = dict(self._gauges)
            levels = dict(self._levels)
        out = []
        for (scope, cname), v in sorted(counters.items()):
            out.append(InterMetric(
                name=metric_name(cname, counter=True), timestamp=ts,
                value=v, tags=scope_tags(scope),
                type=MetricType.COUNTER, hostname=hostname))
        for (scope, gname), v in sorted(gauges.items()):
            out.append(InterMetric(
                name=metric_name(gname, counter=False), timestamp=ts,
                value=v, tags=scope_tags(scope),
                type=MetricType.GAUGE, hostname=hostname))
        for (scope, lname), v in sorted(levels.items()):
            out.append(InterMetric(
                name=metric_name(lname, counter=False), timestamp=ts,
                value=v, tags=scope_tags(scope),
                type=MetricType.GAUGE, hostname=hostname))
        return out

    def debug_state(self) -> dict:
        """JSON-ready registry contents for /debug/flush."""
        with self._lock:
            return {
                "counters": {f"{s}|{n}": v for (s, n), v
                             in sorted(self._cumulative.items())},
                "gauges": {f"{s}|{n}": v for (s, n), v
                           in sorted(self._gauges.items())},
                "levels": {f"{s}|{n}": v for (s, n), v
                           in sorted(self._levels.items())},
            }


# The process-default registry: egress objects constructed without an
# explicit registry (config-built sinks, forwarders, journals) count
# here, and Server._self_metrics drains it. Per-Server accounting uses
# a per-instance registry so two servers in one process (the chaos
# harness topology) never cross-count.
DEFAULT_REGISTRY = TelemetryRegistry()


def phase_timer_samples(tick) -> list:
    """The dogfood loop: one flush tick's TOP-LEVEL phase durations as
    parsed timer samples, ready for Server._route_metric. LOCAL-ONLY
    scope is load-bearing: these samples must never ride a forward
    envelope (the exactly-once chaos suite proves forwarded state
    bit-identical to an oracle, and phase durations are timing noise).
    Emitted here because the registry module owns veneur.* naming."""
    from ..ingest.parser import LOCAL_ONLY, MetricKey, UDPMetric
    from ..utils.hashing import metric_digest

    out = []
    for name, t0, t1, parent in tick.phases():
        if parent != -1 or t1 <= t0 or name == GC_PHASE:
            continue   # only completed top-level flush phases
        mname = PHASE_TIMER_PREFIX + name
        key = MetricKey(mname, "timer", "")
        out.append(UDPMetric(
            key=key, digest=metric_digest(mname, "timer", ""),
            value=(t1 - t0) / 1e6, scope=LOCAL_ONLY))
    mname = PHASE_TIMER_PREFIX + "total"
    key = MetricKey(mname, "timer", "")
    out.append(UDPMetric(
        key=key, digest=metric_digest(mname, "timer", ""),
        value=tick.duration_ns() / 1e6, scope=LOCAL_ONLY))
    return out


def flush_span_name(phase_name: str | None = None) -> str:
    """SSF span names for the recorder's self-tracing emission (the
    flusher.go `veneur.flush` span parity) — minted here, with the
    other self-metric names."""
    return "veneur.flush" if phase_name is None \
        else "veneur.flush." + phase_name


def import_span_name(phase_name: str | None = None) -> str:
    """SSF span names for the receiver's import tree (the cross-tier
    half of one interval's span tree: these spans parent on the REMOTE
    sender's flush span via the propagated trace context)."""
    return "veneur.import" if phase_name is None \
        else "veneur.import." + phase_name


def fanout_timer_sample(sink_name: str, duration_ms: float):
    """One sink's fan-out duration as a LOCAL-ONLY timer sample
    (`veneur.flush.phase.fanout.<sink>`): the per-sink child of the
    dogfood phase timers, emitted by the sink's OWN flush thread when
    it finishes (the tick-end sampler would race sinks still in
    flight). Local-only for the same reason as the phase timers: a
    slow vendor's timing noise must never ride a forward envelope."""
    from ..ingest.parser import LOCAL_ONLY, MetricKey, UDPMetric
    from ..utils.hashing import metric_digest

    mname = PHASE_TIMER_PREFIX + "fanout." + sink_name
    key = MetricKey(mname, "timer", "")
    return UDPMetric(
        key=key, digest=metric_digest(mname, "timer", ""),
        value=float(duration_ms), scope=LOCAL_ONLY)


# End-to-end interval latency (close -> merged-into-flush at the
# global), per sender. Timer samples dogfood through the engine like
# the phase timers; the per-sender freshness watermark rides the
# registry as a sender:-scoped gauge. Names minted here (TL01).
E2E_TIMER_NAME = "veneur.e2e.interval_latency_ms"


def e2e_timer_samples(per_sender_ms: dict) -> list:
    """{sender_id: [latency_ms, ...]} -> LOCAL-ONLY timer samples
    tagged sender:<id>, ready for Server._route_metric. LOCAL_ONLY is
    load-bearing exactly as for phase timers: e2e bookkeeping must
    never change forwarded state (the chaos oracles pin it)."""
    from ..ingest.parser import LOCAL_ONLY, MetricKey, UDPMetric
    from ..utils.hashing import metric_digest

    out = []
    for sender_id, samples in per_sender_ms.items():
        tags = f"sender:{sender_id}"
        key = MetricKey(E2E_TIMER_NAME, "timer", tags)
        digest = metric_digest(E2E_TIMER_NAME, "timer", tags)
        for ms in samples:
            out.append(UDPMetric(key=key, digest=digest,
                                 value=float(ms), scope=LOCAL_ONLY))
    return out
