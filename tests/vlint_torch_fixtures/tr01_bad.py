"""TR01 fixture: trace-context wire literals spelled outside
cluster/wire.py. This docstring names X-Veneur-Trace-Id and
veneur-envelope-bin and must stay silent (documentation is exempt)."""


def handroll_trace_header(trace_id, span_id):
    return {"X-Veneur-Trace-Id": f"{trace_id}:{span_id}"}       # TR01


def handroll_close_header(close_ns):
    return {"X-Veneur-Interval-Close-Ns": str(close_ns)}        # TR01


def respelled_lowercase(headers):
    # a re-spelled casing is the exact drift the check exists for
    return headers.get("x-veneur-trace-id")                     # TR01


def grpc_metadata_carrier(blob):
    return (("veneur-envelope-bin", blob),)                     # TR01


def documented_probe(headers):
    # vlint: disable=TR01 reason=fixture-only diagnostic reading the
    # header without decoding it; wire.py owns the codec
    return "X-Veneur-Trace-Id" in headers


def unrelated_headers():
    return {"X-Veneur-Sender-Id": "a", "Content-Type": "application/json"}
