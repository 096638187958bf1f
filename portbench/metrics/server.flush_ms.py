"""Milliseconds a flush takes: the wall of every `Server.flush_once`
call that closes an interval of the window, timed by the harness around
each, over the number of calls."""


def read(rec):
    f = rec.get("flushes")
    if not f:
        return None
    return sum(x["t1"] - x["t0"] for x in f) / len(f) * 1e3
