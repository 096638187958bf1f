"""Datadog metric/span sink — the reference's default egress.

Parity: sinks/datadog/datadog.go (sym: DatadogMetricSink.Flush — POST
/api/v1/series with JSON bodies chunked by `flush_max_per_body`;
events + service checks; DatadogSpanSink → APM traces API).

Semantics carried over:
  * counters are emitted as Datadog "rate": value / interval, with the
    interval attached (how the reference reports DogStatsD counters).
  * gauges emit as "gauge"; metric hostname/device overrides via the
    magic `host:` / `device:` tags.
  * chunking: bodies hold at most `flush_max_per_body` series.

Transport is stdlib urllib (zlib-deflated JSON like the reference), so the
sink has no third-party deps; tests point `api_url` at a loopback
http.server.

The port's copy of veneur_tpu/sinks/datadog.py: the same payloads, over the
port's resilience layer.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
import zlib

from ..metrics import InterMetric, MetricType
from ..resilience import Egress, EgressPolicy, is_retryable
from . import MetricSink, SpanSink

log = logging.getLogger("veneur_tpu_torch.sinks.datadog")


class DatadogMetricSink(MetricSink):
    def __init__(self, api_key: str, api_url: str = "https://app.datadoghq.com",
                 hostname: str = "", tags: list[str] | None = None,
                 interval_s: int = 10, flush_max_per_body: int = 25_000,
                 timeout_s: float = 10.0, egress: Egress | None = None,
                 egress_policy: EgressPolicy | None = None):
        self.api_key = api_key
        self.api_url = api_url.rstrip("/")
        self.hostname = hostname
        self.tags = tags or []
        self.interval_s = interval_s
        self.flush_max_per_body = flush_max_per_body
        self.timeout_s = timeout_s
        self._egress = egress or Egress("datadog", policy=egress_policy)
        self._tag_memo: dict = {}

    def name(self) -> str:
        return "datadog"

    def _series(self, m: InterMetric) -> dict:
        if m.type == MetricType.COUNTER:
            mtype, value = "rate", m.value / max(self.interval_s, 1)
        else:
            mtype, value = "gauge", m.value
        host, device, tags = self._split_tags(m.tags)
        s = {
            "metric": m.name,
            "points": [[m.timestamp, value]],
            "type": mtype,
            "host": host or m.hostname or self.hostname,
            "tags": tags,
            "interval": self.interval_s,
        }
        if device:
            s["device_name"] = device
        return s

    def _post(self, path: str, body: dict, deadline=None):
        data = zlib.compress(json.dumps(body).encode())
        req = urllib.request.Request(
            f"{self.api_url}{path}?api_key={self.api_key}",
            data=data,
            headers={"Content-Type": "application/json",
                     "Content-Encoding": "deflate"},
            method="POST")
        self._egress.post(req, timeout_s=self.timeout_s,
                          deadline=deadline)

    def flush(self, metrics):
        series, checks = [], []
        for m in metrics:
            if m.type == MetricType.STATUS:
                checks.append(m)
            else:
                series.append(self._series(m))
        # chunked bodies + checks share ONE flush deadline budget
        deadline = self._egress.deadline()
        self._post_series(series, deadline)
        self._post_status(checks, deadline)

    def _post_series(self, series, deadline=None):
        for i in range(0, len(series), self.flush_max_per_body):
            self._post("/api/v1/series",
                       {"series": series[i:i + self.flush_max_per_body]},
                       deadline=deadline)

    def _split_tags(self, tg: list) -> tuple:
        """(host_override, device, merged_tags) for one key's shared tag
        list. Memoized by value (tuple of the tags) so ephemeral lists —
        per-flush self-metrics, extras — share entries with the interned
        frame lists instead of growing the memo per list instance; the
        bound keeps worst-case retention to ~64k entries."""
        key = tuple(tg)
        out = self._tag_memo.get(key)
        if out is not None:
            return out
        host, device, tags = "", "", list(self.tags)
        for t in tg:
            if t.startswith("host:"):
                host = t[5:]
            elif t.startswith("device:"):
                device = t[7:]
            else:
                tags.append(t)
        if len(self._tag_memo) >= 65536:
            self._tag_memo.clear()
        out = (host, device, tags)
        # vlint: disable=TH01 reason=flush-path-only state: the server
        # keeps one flush of a sink in flight (Server._fan_out skips a
        # sink whose last flush runs), and flush/flush_frames are its
        # two entries, never concurrent
        self._tag_memo[key] = out
        return out

    def flush_frames(self, frames):
        """Frame-native flush: build the series bodies straight from the
        columnar blocks (same wire output as flush(), without
        materializing InterMetric objects)."""
        iv = self.interval_s
        div = max(iv, 1)  # divide (not multiply-by-reciprocal) so the
        # rate values match _series() bit-for-bit
        series = []
        app = series.append
        for fr in frames.frames:
            ts = fr.timestamp
            fr_host = fr.hostname or self.hostname
            for names, tags, values, types in fr.blocks:
                is_rate = [t == MetricType.COUNTER for t in types]
                m = values.shape[1]
                rows = values.tolist()
                for nm, tg, row in zip(names, tags, rows):
                    host, device, dtags = self._split_tags(tg)
                    h = host or fr_host
                    cols = (nm,) if m == 1 and isinstance(nm, str) else nm
                    for j in range(m):
                        s = {
                            "metric": cols[j],
                            "points": [[ts, row[j] / div
                                        if is_rate[j] else row[j]]],
                            "type": "rate" if is_rate[j] else "gauge",
                            "host": h,
                            "tags": dtags,
                            "interval": iv,
                        }
                        if device:
                            s["device_name"] = device
                        app(s)
        name = self.name()
        checks = []
        for x in frames.extra:
            if not x.sinks or name in x.sinks:
                if x.type == MetricType.STATUS:
                    checks.append(x)
                else:
                    app(self._series(x))
        deadline = self._egress.deadline()
        self._post_series(series, deadline)
        self._post_status(checks, deadline)
        return len(series) + len(checks)

    def _post_status(self, status_metrics, deadline=None):
        """Status-typed InterMetrics (the StatusCheck sampler's flush
        shape) become Datadog service checks — the reference's datadog
        sink does the same conversion at flush."""
        for m in status_metrics:
            body = {"check": m.name, "status": int(m.value),
                    "tags": list(m.tags), "message": m.message}
            if m.timestamp:
                body["timestamp"] = m.timestamp
            if m.hostname:
                body["host_name"] = m.hostname
            try:
                self._post("/api/v1/check_run", body, deadline=deadline)
            except Exception as ex:
                log.warning("datadog check post failed: %s", ex)

    def flush_other(self, events, checks):
        for e in events:
            body = {
                "title": e.title, "text": e.text,
                "aggregation_key": e.aggregation_key,
                "priority": e.priority or "normal",
                "source_type_name": e.source_type,
                "alert_type": e.alert_type or "info",
                "tags": e.tags,
            }
            if e.timestamp:
                body["date_happened"] = e.timestamp
            if e.hostname:
                body["host"] = e.hostname
            try:
                self._post("/api/v1/events", body)
            except Exception as ex:  # one bad event must not stop the rest
                log.warning("datadog event post failed: %s", ex)
        for c in checks:
            body = {"check": c.name, "status": c.status,
                    "tags": c.tags, "message": c.message}
            if c.timestamp:
                body["timestamp"] = c.timestamp
            if c.hostname:
                body["host_name"] = c.hostname
            try:
                self._post("/api/v1/check_run", body)
            except Exception as ex:
                log.warning("datadog check post failed: %s", ex)


class DatadogSpanSink(SpanSink):
    """SSF spans → Datadog APM traces (sinks/datadog/datadog.go sym:
    DatadogSpanSink): buffer ingested spans, group by trace id, and PUT
    them to a local Datadog trace agent's /v0.3/traces endpoint as the
    agent's JSON list-of-traces format. Nanosecond SSF timestamps map
    straight onto the agent's start/duration fields."""

    def __init__(self, trace_api_address: str = "http://127.0.0.1:8126",
                 buffer_size: int = 16384, timeout_s: float = 10.0,
                 egress: Egress | None = None,
                 egress_policy: EgressPolicy | None = None):
        self.trace_api_address = trace_api_address.rstrip("/")
        self.buffer_size = buffer_size
        self.timeout_s = timeout_s
        self._egress = egress or Egress("datadog-traces",
                                        policy=egress_policy)
        self._spans: list = []
        self._lock = threading.Lock()
        self.dropped_total = 0
        self.flushed_total = 0
        self.requeued_total = 0

    def name(self) -> str:
        return "datadog"

    def ingest(self, span):
        # spans with no timing/ids are metric carriers, not traces
        if not span.trace_id or not span.id or not span.start_timestamp:
            return
        with self._lock:
            if len(self._spans) >= self.buffer_size:
                self.dropped_total += 1
                return
            self._spans.append(span)

    @staticmethod
    def _convert(span) -> dict:
        dur = max(0, (span.end_timestamp or span.start_timestamp)
                  - span.start_timestamp)
        d = {
            "trace_id": span.trace_id,
            "span_id": span.id,
            "parent_id": span.parent_id,
            "name": span.name,
            "resource": span.tags.get("resource", span.name),
            "service": span.service,
            "start": span.start_timestamp,
            "duration": dur,
            "error": 1 if span.error else 0,
            "meta": dict(span.tags),
        }
        return d

    def flush(self):
        with self._lock:
            spans, self._spans = self._spans, []
        if not spans:
            return
        traces: dict[int, list] = {}
        for s in spans:
            traces.setdefault(s.trace_id, []).append(self._convert(s))
        body = json.dumps(list(traces.values())).encode()
        req = urllib.request.Request(
            f"{self.trace_api_address}/v0.3/traces", data=body,
            headers={"Content-Type": "application/json"}, method="PUT")
        try:
            self._egress.post(req, timeout_s=self.timeout_s)
            self.flushed_total += len(spans)
        except Exception as e:
            if not is_retryable(e):
                # terminal (4xx: the batch itself is refused) —
                # requeueing would re-PUT the same doomed body forever,
                # pinning the ring and starving new spans
                with self._lock:
                    self.dropped_total += len(spans)
                log.warning("datadog trace flush terminally failed "
                            "(%d spans dropped): %s", len(spans), e)
                return
            # transient: requeue the failed spans into the ring up to
            # buffer_size (next flush retries them); only what the ring
            # cannot hold is dropped — ring semantics, OLDEST overflow
            # goes first
            with self._lock:
                room = max(0, self.buffer_size - len(self._spans))
                keep = spans[-room:] if room else []
                self._spans[:0] = keep
                self.requeued_total += len(keep)
                evicted = len(spans) - len(keep)
                self.dropped_total += evicted
            log.warning(
                "datadog trace flush failed (%d spans requeued, %d "
                "evicted): %s", len(keep), evicted, e)
