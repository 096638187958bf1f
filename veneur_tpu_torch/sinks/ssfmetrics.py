"""ssfmetrics: the internal span→metrics bridge sink (the port's copy of
veneur_tpu/sinks/ssfmetrics.py).

Parity: sinks/ssfmetrics/metrics.go (sym: metricExtractionSink) plus the
sample conversion of samplers/parser.go (sym: samplers.ParseMetricSSF) and
the indicator-span timer derivation (config key
`indicator_span_timer_name`). Every SSFSample embedded in an ingested
span is converted to a UDPMetric and re-submitted to the metric workers,
so applications that only emit spans still get their metrics aggregated;
indicator spans additionally produce a duration timer.

The server always builds this sink, so it reads the protobuf enums by
their numbers in protos/ssf.proto and imports no protobuf itself.
"""

from __future__ import annotations

from . import SpanSink
from .. import ssf
from ..ingest.parser import (GLOBAL_ONLY, LOCAL_ONLY, MIXED_SCOPE,
                             MetricKey, ServiceCheck, UDPMetric)
from ..utils.hashing import metric_digest

_SSF_TYPE = {
    ssf.COUNTER: "counter",
    ssf.GAUGE: "gauge",
    ssf.HISTOGRAM: "histogram",
    ssf.SET: "set",
    ssf.STATUS: "status",
}
# the SSFSample.Scope numbers of protos/ssf.proto: DEFAULT, LOCAL, GLOBAL
_SSF_SCOPE = {
    0: MIXED_SCOPE,
    1: LOCAL_ONLY,
    2: GLOBAL_ONLY,
}

# derived from the client-side table so the unit set lives in one place
_TIME_SCALE_NS = {u: s * 1e9 for u, s in ssf.TIME_UNITS.items()}


def sample_to_check(s) -> ServiceCheck | None:
    """STATUS samples → service checks (the reference converts these in
    samplers.ParseMetricSSF rather than dropping them)."""
    if s.metric != ssf.STATUS or not s.name:
        return None
    tags = sorted(f"{k}:{v}" if v else k for k, v in s.tags.items())
    return ServiceCheck(
        name=s.name, status=int(s.status),
        timestamp=int(s.timestamp // 1_000_000_000) or None,
        message=s.message, tags=tags)


def sample_to_metric(s, host_tag: str = "") -> UDPMetric | None:
    """samplers.ParseMetricSSF: one embedded sample → one UDPMetric."""
    mtype = _SSF_TYPE.get(s.metric)
    if mtype is None or mtype == "status" or not s.name:
        return None
    tags = sorted(f"{k}:{v}" if v else k for k, v in s.tags.items())
    joined = ",".join(tags)
    value: float | str = s.message if mtype == "set" else float(s.value)
    # timers arrive as HISTOGRAM samples carrying a time unit; normalise
    # to ms so the same duration aggregates identically whatever unit
    # the client chose
    if mtype == "histogram" and s.unit in _TIME_SCALE_NS:
        mtype = "timer"
        value = float(value) * _TIME_SCALE_NS[s.unit] / 1e6
    key = MetricKey(name=s.name, type=mtype, joined_tags=joined)
    return UDPMetric(
        key=key,
        digest=metric_digest(s.name, mtype, joined),
        value=value,
        sample_rate=s.sample_rate or 1.0,
        scope=_SSF_SCOPE.get(s.scope, MIXED_SCOPE),
        tags=tags,
    )


def indicator_timer(span, timer_name: str) -> UDPMetric | None:
    """Indicator spans → a duration timer named `timer_name`, tagged
    with the span's service and error status (metricExtractionSink's
    indicator-span handling)."""
    if not (timer_name and span.indicator and span.start_timestamp
            and span.end_timestamp):
        return None
    dur_ns = max(0, span.end_timestamp - span.start_timestamp)
    tags = sorted([f"service:{span.service}",
                   f"error:{'true' if span.error else 'false'}"])
    joined = ",".join(tags)
    key = MetricKey(name=timer_name, type="timer", joined_tags=joined)
    return UDPMetric(
        key=key,
        digest=metric_digest(timer_name, "timer", joined),
        value=dur_ns / 1e6,   # report in ms, like DogStatsD timers
        sample_rate=1.0,
        scope=MIXED_SCOPE,
        tags=tags,
    )


class SSFMetricsSink(SpanSink):
    """SpanSink that feeds embedded samples back into the metric
    pipeline via `submit(UDPMetric)` (the server's worker router)."""

    def __init__(self, submit, indicator_span_timer_name: str = ""):
        self._submit = submit
        self._timer_name = indicator_span_timer_name
        self.samples_extracted = 0

    def name(self) -> str:
        return "ssfmetrics"

    def ingest(self, span) -> None:
        for s in span.metrics:
            item = sample_to_metric(s)
            if item is None:
                item = sample_to_check(s)
            if item is not None:
                self._submit(item)
                self.samples_extracted += 1
        t = indicator_timer(span, self._timer_name)
        if t is not None:
            self._submit(t)
            self.samples_extracted += 1
