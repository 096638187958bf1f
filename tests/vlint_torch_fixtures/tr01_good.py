"""TR01 good fixture: the trace context crosses the wire through the
wire module's codec helpers. This docstring names X-Veneur-Trace-Id."""

from veneur_tpu_torch.cluster import wire


def trace_of(headers):
    return wire.trace_from_headers(headers)


def unrelated_headers():
    return {"X-Veneur-Sender-Id": "a", "Content-Type": "application/json"}
