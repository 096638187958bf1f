"""Splunk span sink: SSF spans → Splunk HTTP Event Collector.

Parity: sinks/splunk/splunk.go (sym: splunkSpanSink — buffers ingested
spans, serialises each as an HEC JSON event `{"time": ..., "host": ...,
"event": {...}}`, POSTs batches to /services/collector/event with an
`Authorization: Splunk <token>` header). Transport is stdlib urllib so
tests can point `hec_address` at a loopback http.server.

The port's copy of veneur_tpu/sinks/splunk.py: the same payloads, over the
port's resilience layer.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request

from . import SpanSink

log = logging.getLogger("veneur_tpu_torch.sinks.splunk")


def span_to_event(span, hostname: str) -> dict:
    """One SSFSpan → one HEC event dict (the serialized shape the
    reference posts per span)."""
    return {
        "time": span.start_timestamp / 1e9,
        "host": hostname,
        "event": {
            "trace_id": f"{span.trace_id:x}",
            "id": f"{span.id:x}",
            "parent_id": f"{span.parent_id:x}",
            "start_timestamp": span.start_timestamp,
            "end_timestamp": span.end_timestamp,
            "duration_ns": max(0, span.end_timestamp
                               - span.start_timestamp),
            "error": bool(span.error),
            "service": span.service,
            "indicator": bool(span.indicator),
            "name": span.name,
            "tags": dict(span.tags),
        },
    }


class SplunkSpanSink(SpanSink):
    def __init__(self, hec_address: str, token: str, hostname: str = "",
                 max_buffer: int = 16384, timeout_s: float = 10.0,
                 egress=None, egress_policy=None):
        from ..resilience import Egress
        self.url = hec_address.rstrip("/") + "/services/collector/event"
        self.token = token
        self.hostname = hostname
        self.max_buffer = max_buffer
        self.timeout_s = timeout_s
        self._egress = egress or Egress("splunk", policy=egress_policy)
        self._buf: list = []
        self._lock = threading.Lock()
        self.flushed_total = 0
        self.dropped_total = 0

    def name(self) -> str:
        return "splunk"

    def ingest(self, span) -> None:
        with self._lock:
            if len(self._buf) >= self.max_buffer:
                self.dropped_total += 1
                return
            self._buf.append(span)

    def flush(self) -> None:
        with self._lock:
            batch, self._buf = self._buf, []
        if not batch:
            return
        # HEC batching: newline-delimited JSON events in one body
        body = "\n".join(
            json.dumps(span_to_event(s, self.hostname)) for s in batch
        ).encode()
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": "application/json",
                     "Authorization": f"Splunk {self.token}"})
        try:
            self._egress.post(req, timeout_s=self.timeout_s)
            self.flushed_total += len(batch)
        except Exception as e:
            self.dropped_total += len(batch)
            log.error("splunk HEC flush failed: %s", e)
