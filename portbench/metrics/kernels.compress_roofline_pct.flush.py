"""Share of its bytes bound that the compress kernel reached in the
flushes' launches of the traced window: the bound of each launch from
its shape, summed, over their device time, in percent."""

from portbench.trace import compress_bound_s


def read(rec):
    launches = [x for x in rec.get("trace", {}).get("compress", [])
                if x[3]]
    dev = sum(x[4] for x in launches)
    if not launches or dev <= 0:
        return None
    return sum(compress_bound_s(*x[:3]) for x in launches) / dev * 100
