"""Samples a second that the port absorbs: the timer and counter
samples that the rows of the window's flushes hold (histogram counts,
and counter sums over their lines' weights), over the window, which
runs from the call of the flush that opens it to the call of the last."""


def read(rec):
    n, w = rec.get("flush_samples"), rec.get("window_s")
    if not n or not w:
        return None
    return sum(n) / w
