"""The CPU of the flush_once calls that start in the window, on the
thread that calls them, in percent of one core over the window."""


def read(rec):
    cpu, w = rec.get("cpu"), rec.get("window_s")
    if not cpu or not w:
        return None
    return cpu["flush_s"] / w * 100
