"""The collector's milliseconds in the window, inside the flush_once
calls or not, over the number of calls (gc.callbacks stamps each
collection)."""


def read(rec):
    f, spans = rec.get("flushes"), rec.get("gc_spans")
    if not f or spans is None:
        return None
    return sum(e - s for s, e in spans) / len(f) * 1e3
