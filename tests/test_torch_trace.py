"""The port's tracing against the reference's (ROADMAP item 9b).

For one recorded flush tick, the port's `FlightRecorder.emit_spans`
sends the span tree the reference's sends: names, parent links, tags,
service and timestamps, the ids compared by structure (the root carries
the tick's own pinned identity). Then the trace client's spans and the
OpenTracing bridge: the same operations give equal span structure, and
inject/extract give equal carriers.
"""

import pytest

from veneur_tpu import observe as jobserve
from veneur_tpu import trace as jtrace
from veneur_tpu.trace import opentracing as jot
from veneur_tpu_torch import observe as tobserve
from veneur_tpu_torch import trace as ttrace
from veneur_tpu_torch.trace import opentracing as tot


class Recorder:
    """A trace client that keeps what it is handed."""

    def __init__(self):
        self.spans = []

    def record(self, span):
        self.spans.append(span)
        return True


# (name, parent index, start offset ns, end offset ns or 0 = in flight)
PHASES = [("engine", -1, 10, 900), ("engine.flush", 0, 20, 800),
          ("engine.swap", 1, 30, 60), ("engine.drain", 1, 60, 400),
          ("telemetry", -1, 900, 950), ("fanout", -1, 950, 990),
          ("sink.flush", 5, 955, 0), ("overload", -1, 990, 999)]


def _tick(mod):
    rec = mod.FlightRecorder(capacity=4, max_phases=32)
    tick = rec.begin_tick(1234)
    m0 = tick.mono_start
    for name, parent, t0, t1 in PHASES:
        i = tick.start(name, parent)
        s = tick._slots[i]
        s.t0, s.t1 = m0 + t0, (m0 + t1 if t1 else 0)
    rec.end_tick(tick)
    tick.mono_end = m0 + 1000
    return rec, tick


def _tree(rec, tick, **kw):
    client = Recorder()
    n = rec.emit_spans(tick, client, **kw)
    assert n == len(client.spans)
    ids = {s.id: i for i, s in enumerate(client.spans)}
    wall0 = tick.wall_start_ns
    out = []
    for s in client.spans:
        out.append((s.name, s.service, ids.get(s.parent_id, s.parent_id),
                    dict(s.tags), s.start_timestamp - wall0,
                    s.end_timestamp - wall0, s.trace_id == client.spans[0]
                    .trace_id))
    return client.spans, out


@pytest.mark.parametrize("kw", [{}, {"trace_id": 99, "parent_id": 7},
                                {"namer": lambda p=None: f"x.{p}"}])
def test_emit_spans_sends_the_references_tree(kw):
    jrec, jtick = _tick(jobserve)
    trec, ttick = _tick(tobserve)
    jspans, jtree = _tree(jrec, jtick, **kw)
    tspans, ttree = _tree(trec, ttick, **kw)
    assert ttree == jtree
    # the in-flight phase is left out; the root carries the tick's ids
    assert len(tspans) == len(PHASES)
    assert tspans[0].id == ttick.span_id
    assert tspans[0].trace_id == kw.get("trace_id", ttick.trace_id)
    assert tspans[0].tags["tick_id"] == str(ttick.tick_id)
    assert len({s.id for s in tspans}) == len(tspans)


def test_emit_spans_without_a_client_sends_nothing():
    rec, tick = _tick(tobserve)
    assert rec.emit_spans(tick, None) == 0


def _client_spans(mod):
    sent = Recorder()
    with mod.start_span(sent, "parent", service="svc", indicator=True,
                        tags={"a": 1}):
        with mod.start_span(None, "child", tags={"b": "x"}) as child:
            assert mod.current_span() is child
        try:
            with mod.start_span(None, "failing"):
                raise ValueError("boom")
        except ValueError:
            pass
    assert mod.current_span() is None
    other = mod.start_span(sent, "explicit", service="s2")
    other.finish()
    other.finish()                      # idempotent
    root = sent.spans[-2]
    ids = {s.id: i for i, s in enumerate(sent.spans)}
    return [(s.name, s.service, s.indicator, s.error, dict(s.tags),
             ids.get(s.parent_id, s.parent_id), s.trace_id == root.trace_id)
            for s in sent.spans]


def test_trace_spans_have_the_references_structure():
    assert _client_spans(ttrace) == _client_spans(jtrace)


def test_report_batch_carrier_equal():
    t, j = Recorder(), Recorder()
    tb, jb = ttrace.Samples(), jtrace.Samples()
    tb.add(ttrace.count("c", 2.0, timestamp=5))
    jb.add(jtrace.count("c", 2.0, timestamp=5))
    assert ttrace.report_batch(t, tb, service="svc")
    assert jtrace.report_batch(j, jb, service="svc")
    assert t.spans[0].SerializeToString() == j.spans[0].SerializeToString()
    assert not ttrace.report_batch(None, tb)
    assert not ttrace.report_batch(t, ttrace.Samples())


@pytest.mark.parametrize("fmt", [tot.FORMAT_TEXT_MAP,
                                 tot.FORMAT_HTTP_HEADERS, tot.FORMAT_BINARY])
def test_opentracing_inject_extract_equal(fmt):
    tctx = tot.SpanContext(123, 456, {"user": "u1"})
    jctx = jot.SpanContext(123, 456, {"user": "u1"})
    tcar = bytearray() if fmt == tot.FORMAT_BINARY else {}
    jcar = bytearray() if fmt == jot.FORMAT_BINARY else {}
    tot.Tracer().inject(tctx, fmt, tcar)
    jot.Tracer().inject(jctx, fmt, jcar)
    assert tcar == jcar
    t = tot.Tracer().extract(fmt, tcar)
    j = jot.Tracer().extract(fmt, jcar)
    assert (t.trace_id, t.span_id, t.baggage) == \
        (j.trace_id, j.span_id, j.baggage)


@pytest.mark.parametrize("fmt,carrier", [
    (tot.FORMAT_TEXT_MAP, {"trace-id": "x"}), (tot.FORMAT_TEXT_MAP, {}),
    (tot.FORMAT_BINARY, bytearray(b"nope")), ("smoke-signals", {})])
def test_opentracing_bad_carriers_raise_as_the_reference(fmt, carrier):
    with pytest.raises(Exception) as te:
        tot.Tracer().extract(fmt, carrier)
    with pytest.raises(Exception) as je:
        jot.Tracer().extract(fmt, carrier)
    assert type(te.value).__name__ == type(je.value).__name__


def _ot_spans(mod):
    sent = Recorder()
    tracer = mod.Tracer(sent, "svc")
    with tracer.start_active_span("outer", tags={"indicator": True}):
        with tracer.start_active_span("inner") as scope:
            scope.span.set_tag("k", 3).log_kv({"event": "x"})
            scope.span.set_baggage_item("b", "v")
        try:
            with tracer.start_active_span("failing"):
                raise RuntimeError("boom")
        except RuntimeError:
            pass
    loose = tracer.start_span("loose", ignore_active_span=True)
    loose.finish()
    ids = {s.id: i for i, s in enumerate(sent.spans)}
    return [(s.name, s.service, s.indicator, s.error, dict(s.tags),
             ids.get(s.parent_id, s.parent_id)) for s in sent.spans]


def test_opentracing_spans_have_the_references_structure():
    assert _ot_spans(tot) == _ot_spans(jot)
