"""Mean host assembly of the flushed rows (ms) over the window's
flushes, from the server's veneur.flush.assembly_duration_ns."""


def read(rec):
    f = rec.get("flushes")
    if not f:
        return None
    return sum(x["assembly_ns"] for x in f) / len(f) / 1e6
