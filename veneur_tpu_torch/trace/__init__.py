"""Client-side tracing library: emit SSF spans/samples to a veneur (the
port's copy of veneur_tpu/trace/__init__.py).

Parity: trace/*.go (sym: trace.Client, trace.NewClient, trace.Trace,
trace.StartSpanFromContext, trace.Record, trace.DefaultClient) and
trace/metrics (sym: metrics.ReportBatch). Used both by applications and
by the server to instrument itself, exactly as the reference does.

Transport: UDP datagrams carrying bare SSFSpan protobufs, or UNIX
datagram sockets; fire-and-forget with a bounded in-process buffer and a
background flusher thread standing in for the reference's buffered
client goroutine. The protobuf module is imported where a span is
built, not when this module is imported.
"""

from __future__ import annotations

import contextvars
import queue
import random
import socket
import threading
import time
from urllib.parse import urlparse

from ..ssf import Samples, count  # noqa: F401  (re-export for callers)

_current_span: contextvars.ContextVar["Span | None"] = \
    contextvars.ContextVar("veneur_trace_span", default=None)


def _span_id(rng=random) -> int:
    # positive int63, matching the reference's id space
    return rng.getrandbits(63) or 1


class Span:
    """One trace span under construction (trace.Trace). Context-manager:
    entering sets it current, exiting stamps the end time and records."""

    def __init__(self, client: "Client | None", name: str, service: str,
                 trace_id: int | None = None, parent_id: int = 0,
                 tags: dict | None = None, indicator: bool = False):
        self.client = client
        self.name = name
        self.service = service
        self.trace_id = trace_id or _span_id()
        self.id = _span_id()
        self.parent_id = parent_id
        self.tags = dict(tags or {})
        self.indicator = indicator
        self.error = False
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.samples = Samples()
        self._token = None

    # -- context manager: with tracer.start_span(...) as span: --
    def __enter__(self):
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.error = True
        if self._token is not None:
            _current_span.reset(self._token)
        self.finish()
        return False

    def add(self, *samples):
        """Attach fire-and-forget metric samples to ride in this span."""
        self.samples.add(*samples)

    def to_proto(self):
        from ..ssf.protos import ssf_pb2
        span = ssf_pb2.SSFSpan(
            version=0, trace_id=self.trace_id, id=self.id,
            parent_id=self.parent_id, start_timestamp=self.start_ns,
            end_timestamp=self.end_ns or time.time_ns(),
            error=self.error, service=self.service,
            indicator=self.indicator, name=self.name)
        for k, v in self.tags.items():
            span.tags[k] = str(v)
        self.samples.attach(span)
        return span

    def finish(self):
        if self.end_ns != 0:
            return   # idempotent: explicit finish inside `with` is a no-op
        self.end_ns = time.time_ns()
        if self.client is not None:
            self.client.record(self.to_proto())


class Client:
    """Buffered fire-and-forget SSF emitter (trace.Client).

    `addr` is "udp://host:port" or "unix:///path.sock". Spans are queued
    (bounded, drop-on-full — deliberate lossiness, counted) and sent by a
    daemon thread.
    """

    def __init__(self, addr: str, capacity: int = 1024,
                 flush_interval_s: float = 0.0):
        u = urlparse(addr if "://" in addr else f"udp://{addr}")
        if u.scheme in ("udp", ""):
            host = u.hostname or "127.0.0.1"
            family = socket.AF_INET6 if ":" in host else socket.AF_INET
            self._sock = socket.socket(family, socket.SOCK_DGRAM)
            self._dest = (host, u.port or 8128)
        elif u.scheme == "unix":
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
            self._dest = u.path
        else:
            raise ValueError(f"unsupported trace client scheme {u.scheme}")
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self.dropped = 0
        self.sent = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="trace-client", daemon=True)
        self._thread.start()

    def record(self, span) -> bool:
        """Enqueue one span (trace.Record); False = dropped."""
        try:
            self._q.put_nowait(span)
            return True
        except queue.Full:
            self.dropped += 1
            return False

    def _run(self):
        while True:
            try:
                span = self._q.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    break
                continue
            if span is None:
                break
            try:
                self._sock.sendto(span.SerializeToString(), self._dest)
                self.sent += 1
            except OSError:
                self.dropped += 1

    def flush(self, timeout: float = 2.0):
        """Best-effort drain of the queue."""
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.005)

    def close(self):
        self._stop.set()   # _run notices on its next queue-poll timeout
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=2.0)
        self._sock.close()


def current_span() -> Span | None:
    return _current_span.get()


def start_span(client: Client | None, name: str, service: str = "",
               tags: dict | None = None, indicator: bool = False) -> Span:
    """trace.StartSpanFromContext: child of the context's current span
    if one exists, else a new trace root. Use as a context manager."""
    parent = _current_span.get()
    if parent is not None:
        return Span(client or parent.client, name,
                    service or parent.service, trace_id=parent.trace_id,
                    parent_id=parent.id, tags=tags, indicator=indicator)
    return Span(client, name, service, tags=tags, indicator=indicator)


def report_batch(client: Client | None, samples: Samples,
                 service: str = "") -> bool:
    """trace/metrics.ReportBatch: send samples with no enclosing trace —
    they travel in a bare carrier span the server's ssfmetrics sink
    unpacks."""
    if client is None or not samples.batch:
        return False
    from ..ssf.protos import ssf_pb2
    carrier = ssf_pb2.SSFSpan(version=0, service=service)
    samples.attach(carrier)
    return client.record(carrier)
