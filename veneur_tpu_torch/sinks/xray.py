"""AWS X-Ray span sink: SSF spans → X-Ray daemon UDP segments.

Parity: sinks/xray/xray.go (sym: XRaySpanSink — each span becomes one
JSON "segment" datagram sent to the local X-Ray daemon, prefixed with
the daemon's `{"format": "json", "version": 1}` header line; trace ids
are rendered in X-Ray's `1-<epoch hex8>-<hex24>` form).

The port's copy of veneur_tpu/sinks/xray.py: the same payloads, over the
port's resilience layer.
"""

from __future__ import annotations

import json
import logging
import socket

from . import SpanSink

log = logging.getLogger("veneur_tpu_torch.sinks.xray")

_HEADER = b'{"format": "json", "version": 1}\n'


def xray_trace_id(trace_id: int, start_ns: int) -> str:
    """X-Ray trace id: version-epoch-96bit, derived deterministically
    from the SSF trace id so all spans of a trace land together."""
    epoch = (start_ns // 1_000_000_000) & 0xFFFFFFFF
    return f"1-{epoch:08x}-{trace_id & ((1 << 96) - 1):024x}"


def span_to_segment(span) -> dict:
    seg = {
        "name": (span.service or "unknown")[:200],
        "id": f"{span.id & ((1 << 64) - 1):016x}",
        "trace_id": xray_trace_id(span.trace_id, span.start_timestamp),
        "start_time": span.start_timestamp / 1e9,
        "end_time": span.end_timestamp / 1e9,
        "error": bool(span.error),
        "annotations": {k: v for k, v in span.tags.items()},
    }
    if span.parent_id:
        seg["parent_id"] = f"{span.parent_id & ((1 << 64) - 1):016x}"
        seg["type"] = "subsegment"
    if span.name:
        seg["annotations"]["span_name"] = span.name
    return seg


class XRaySpanSink(SpanSink):
    """Deliberately NOT behind an Egress: ingest() runs once per span
    on the span-worker hot path, and a UDP sendto to the local daemon
    is fire-and-forget — a dropped datagram is the protocol's loss
    model and retrying a connectionless send has nothing to wait for.
    Failures still surface per destination in veneur.resilience.*
    (error path only, no per-span locking)."""

    def __init__(self, daemon_address: str = "127.0.0.1:2000",
                 registry=None):
        from ..resilience import DEFAULT_REGISTRY
        host, _, port = daemon_address.rpartition(":")
        host = host.strip("[]") or "127.0.0.1"
        self._dest = (host, int(port))
        self._dest_name = f"xray://{daemon_address}"
        self._registry = registry or DEFAULT_REGISTRY
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        self._sock = socket.socket(family, socket.SOCK_DGRAM)
        self.sent_total = 0
        self.dropped_total = 0

    def name(self) -> str:
        return "xray"

    def ingest(self, span) -> None:
        payload = _HEADER + json.dumps(span_to_segment(span)).encode()
        try:
            self._sock.sendto(payload, self._dest)
            self.sent_total += 1
        except OSError as e:
            self.dropped_total += 1
            self._registry.incr(self._dest_name, "failures")
            log.debug("xray send failed: %s", e)

    def stop(self) -> None:
        self._sock.close()
