"""90th percentile of the engine's lock-held swap (ms) over the
window's flushes, from the server's veneur.flush.swap_duration_ns."""

import numpy as np


def read(rec):
    f = rec.get("flushes")
    if not f:
        return None
    return float(np.percentile([x["swap_ns"] / 1e6 for x in f], 90))
