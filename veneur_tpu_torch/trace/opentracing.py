"""OpenTracing bridge over the SSF trace client (the port's copy of
veneur_tpu/trace/opentracing.py).

Parity: trace/opentracing.go — the reference implements the
opentracing-go Tracer/Span/SpanContext interfaces on top of trace.Trace
so OpenTracing-instrumented applications emit SSF without code changes.
The opentracing-python package is pure API convention (duck typing), so
this module implements the same surface self-contained: `Tracer` with
start_span / start_active_span / inject / extract, `Span` with
set_tag / log_kv / set_operation_name / finish, and TEXT_MAP / HTTP
header propagation of (trace id, span id). When the real `opentracing`
package is importable, `register()` installs this tracer as the global
one.

Carrier format: `trace-id` and `parent-id` keys (decimal int63), the
same pair veneur's SSF spans carry on the wire.
"""

from __future__ import annotations

import contextvars
import time

from . import Client, Span as _SSFSpan, _span_id

FORMAT_TEXT_MAP = "text_map"
FORMAT_HTTP_HEADERS = "http_headers"
FORMAT_BINARY = "binary"

TRACE_ID_KEY = "trace-id"
PARENT_ID_KEY = "parent-id"


class SpanContextCorruptedException(Exception):
    pass


class UnsupportedFormatException(Exception):
    pass


class SpanContext:
    """Propagation state: ids plus baggage (OpenTracing's SpanContext)."""

    __slots__ = ("trace_id", "span_id", "baggage")

    def __init__(self, trace_id: int, span_id: int,
                 baggage: dict | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.baggage = dict(baggage or {})


class Span:
    """OpenTracing-shaped span that records as SSF on finish."""

    def __init__(self, tracer: "Tracer", operation_name: str,
                 context: SpanContext, parent_id: int = 0,
                 tags: dict | None = None, start_time: float | None = None):
        self._tracer = tracer
        self.operation_name = operation_name
        self._context = context
        self.parent_id = parent_id
        self.tags = dict(tags or {})
        self.start_time = start_time or time.time()
        self.finish_time = 0.0
        self.logs: list = []
        self._finished = False

    # -- OpenTracing API --

    @property
    def context(self) -> SpanContext:
        return self._context

    @property
    def tracer(self) -> "Tracer":
        return self._tracer

    def set_operation_name(self, name: str) -> "Span":
        self.operation_name = name
        return self

    def set_tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def log_kv(self, key_values: dict, timestamp: float | None = None):
        self.logs.append((timestamp or time.time(), dict(key_values)))
        return self

    def set_baggage_item(self, key: str, value: str) -> "Span":
        self._context.baggage[key] = value
        return self

    def get_baggage_item(self, key: str):
        return self._context.baggage.get(key)

    def finish(self, finish_time: float | None = None):
        if self._finished:
            return
        self._finished = True
        self.finish_time = finish_time or time.time()
        client = self._tracer.client
        if client is None:
            return
        ssf = _SSFSpan(
            client, self.operation_name, self._tracer.service,
            trace_id=self._context.trace_id,
            parent_id=self.parent_id,
            tags={k: str(v) for k, v in self.tags.items()},
            indicator=bool(self.tags.get("indicator", False)))
        ssf.id = self._context.span_id
        ssf.error = bool(self.tags.get("error", False))
        ssf.start_ns = int(self.start_time * 1e9)
        ssf.end_ns = int(self.finish_time * 1e9)
        client.record(ssf.to_proto())

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.set_tag("error", True)
        self.finish()
        return False


class _Scope:
    """Minimal ScopeManager scope (the active-span holder)."""

    def __init__(self, tracer, span, finish_on_close):
        self.span = span
        self._tracer = tracer
        self._finish = finish_on_close
        self._prev = tracer._active
        tracer._active = span

    def close(self):
        self._tracer._active = self._prev
        if self._finish:
            self.span.finish()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.span.set_tag("error", True)
        self.close()
        return False


class Tracer:
    def __init__(self, client: Client | None = None,
                 service: str = "unknown-service"):
        self.client = client
        self.service = service
        # context-local, like trace.__init__'s _current_span: a plain
        # attribute would let concurrent threads parent spans onto each
        # other's unrelated traces
        self._active_var: contextvars.ContextVar = contextvars.ContextVar(
            f"veneur_ot_active_{id(self)}", default=None)

    @property
    def _active(self):
        return self._active_var.get()

    @_active.setter
    def _active(self, span):
        self._active_var.set(span)

    # -- span creation --

    @property
    def active_span(self):
        return self._active

    def start_span(self, operation_name: str, child_of=None,
                   tags: dict | None = None,
                   start_time: float | None = None,
                   ignore_active_span: bool = False) -> Span:
        parent_ctx = None
        if child_of is not None:
            parent_ctx = (child_of.context if isinstance(child_of, Span)
                          else child_of)
        elif self._active is not None and not ignore_active_span:
            parent_ctx = self._active.context
        if parent_ctx is not None:
            ctx = SpanContext(parent_ctx.trace_id, _span_id(),
                              parent_ctx.baggage)
            parent_id = parent_ctx.span_id
        else:
            tid = _span_id()
            ctx = SpanContext(tid, tid)
            parent_id = 0
        return Span(self, operation_name, ctx, parent_id=parent_id,
                    tags=tags, start_time=start_time)

    def start_active_span(self, operation_name: str, child_of=None,
                          tags: dict | None = None,
                          finish_on_close: bool = True,
                          ignore_active_span: bool = False) -> _Scope:
        span = self.start_span(operation_name, child_of=child_of,
                               tags=tags,
                               ignore_active_span=ignore_active_span)
        return _Scope(self, span, finish_on_close)

    # -- propagation --

    def inject(self, span_context: SpanContext, format: str, carrier):
        if format in (FORMAT_TEXT_MAP, FORMAT_HTTP_HEADERS):
            carrier[TRACE_ID_KEY] = str(span_context.trace_id)
            carrier[PARENT_ID_KEY] = str(span_context.span_id)
            for k, v in span_context.baggage.items():
                carrier[f"baggage-{k}"] = v
        elif format == FORMAT_BINARY:
            carrier.extend(
                f"{span_context.trace_id}:{span_context.span_id}"
                .encode())
        else:
            raise UnsupportedFormatException(format)

    def extract(self, format: str, carrier) -> SpanContext:
        if format in (FORMAT_TEXT_MAP, FORMAT_HTTP_HEADERS):
            items = {str(k).lower(): v for k, v in dict(carrier).items()}
            try:
                tid = int(items[TRACE_ID_KEY])
                sid = int(items[PARENT_ID_KEY])
            except (KeyError, ValueError) as e:
                raise SpanContextCorruptedException(str(e))
            baggage = {k[len("baggage-"):]: v for k, v in items.items()
                       if k.startswith("baggage-")}
            return SpanContext(tid, sid, baggage)
        if format == FORMAT_BINARY:
            try:
                tid, sid = bytes(carrier).decode().split(":")
                return SpanContext(int(tid), int(sid))
            except Exception as e:
                raise SpanContextCorruptedException(str(e))
        raise UnsupportedFormatException(format)


def register(client: Client, service: str) -> Tracer:
    """Build a Tracer and, when the real opentracing package is
    importable, install it as the global tracer (the reference's
    opentracing-go registration)."""
    tracer = Tracer(client, service)
    try:
        import opentracing as _ot
        _ot.tracer = tracer
    except ImportError:
        pass
    return tracer
