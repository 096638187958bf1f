"""SR02 good fixture: the centroid rows are rewritten by their owner,
the engine's compress; the buffer and scalar fields carry no ordering
invariant and may be replaced."""


def rebuild(engine, bank, buf_value, buf_weight):
    return engine.compress(bank._replace(buf_value=buf_value,
                                         buf_weight=buf_weight))


def scalar_patch(bank, c):
    return bank._replace(vsum=c, count=c)
