"""90th percentile of the window's flush_once walls (ms)."""

import numpy as np


def read(rec):
    f = rec.get("flushes")
    if not f:
        return None
    return float(np.percentile([(x["t1"] - x["t0"]) * 1e3 for x in f], 90))
