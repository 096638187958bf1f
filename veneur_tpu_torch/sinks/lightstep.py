"""LightStep span sink: SSF spans → a LightStep collector.

Parity: sinks/lightstep/lightstep.go (sym: LightStepSpanSink — wraps the
LightStep tracer, converting each SSFSpan into an OpenTracing span with
trace/span/parent ids and tags, reported to a collector with an access
token). The vendor tracer library isn't available here, so the sink
speaks the collector's JSON report surface directly: buffered spans are
POSTed as one report body per flush with the access token attached —
the same buffer-then-report lifecycle the tracer performs internally.
Tests point `collector_url` at a loopback http.server.

The port's copy of veneur_tpu/sinks/lightstep.py: the same payloads, over the
port's resilience layer.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request

from . import SpanSink

log = logging.getLogger("veneur_tpu_torch.sinks.lightstep")


def span_to_record(span) -> dict:
    """One SSFSpan → one LightStep span record (the field mapping the
    reference performs via the OpenTracing API: ot.ParentSpanID /
    lightstep.TraceIDField etc.)."""
    return {
        "span_guid": f"{span.id:x}",
        "trace_guid": f"{span.trace_id:x}",
        "span_name": span.name,
        "oldest_micros": span.start_timestamp // 1000,
        "youngest_micros": span.end_timestamp // 1000,
        "attributes": [
            {"Key": "component", "Value": span.service},
            {"Key": "parent_span_guid", "Value": f"{span.parent_id:x}"},
            {"Key": "error", "Value": str(bool(span.error)).lower()},
        ] + [{"Key": k, "Value": v} for k, v in sorted(span.tags.items())],
    }


class LightStepSpanSink(SpanSink):
    def __init__(self, access_token: str, collector_url: str,
                 hostname: str = "", max_buffer: int = 16384,
                 timeout_s: float = 10.0, egress=None,
                 egress_policy=None):
        from ..resilience import Egress
        # no default collector here: config.lightstep_collector_host is
        # the single source of truth for the endpoint
        self.access_token = access_token
        self.url = collector_url.rstrip("/") + "/api/v0/reports"
        self.hostname = hostname
        self.max_buffer = max_buffer
        self.timeout_s = timeout_s
        self._egress = egress or Egress("lightstep",
                                        policy=egress_policy)
        self._buf: list = []
        self._lock = threading.Lock()
        self.flushed_total = 0
        self.dropped_total = 0

    def name(self) -> str:
        return "lightstep"

    def ingest(self, span):
        with self._lock:
            if len(self._buf) >= self.max_buffer:
                self.dropped_total += 1
                return
            self._buf.append(span)

    def flush(self):
        with self._lock:
            spans, self._buf = self._buf, []
        if not spans:
            return
        body = json.dumps({
            "auth": {"access_token": self.access_token},
            "runtime": {"group_name": "veneur", "guid": self.hostname},
            "span_records": [span_to_record(s) for s in spans],
        }).encode()
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            self._egress.post(req, timeout_s=self.timeout_s)
            self.flushed_total += len(spans)
        except Exception as e:
            self.dropped_total += len(spans)
            log.error("lightstep report failed (%d spans dropped): %s",
                      len(spans), e)
