"""OV01 good fixture: every drop verdict of a decision function is
counted in its own branch; helpers that are not admit*/fold*/shed*
may return None silently."""


class _Controller:
    def __init__(self, registry):
        self._tel = registry

    def admit_packet(self, pkt):
        if pkt is None:
            self._tel.incr("_server", "overload.shed_packets")
            return None
        return True

    def fold_metric(self, m):
        if m.rate < 1.0:
            self._tel.incr("_server", "overload.fold_sampled_out")
            return None
        return m

    def shed_key(self, key, changed):
        if key is None:
            if changed:
                self._tel.mark("_server", "overload.keys_over_budget")
            return None
        return key

    def route_helper(self, m):
        if m is None:
            return None
        return m
