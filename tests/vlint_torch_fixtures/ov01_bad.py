"""OV01 fixture: uncounted drop verdicts in overload-defense decision
functions. The filename carries the /ov01_ scope marker; only
admit*/fold*/shed*-named functions are decision functions."""


class _Controller:
    def __init__(self, registry):
        self._tel = registry

    def admit_packet_uncounted(self):
        if self._tel is None:
            return None                                        # OV01
        return True

    def shed_sample_counts_elsewhere(self, m):
        self._tel.incr("_server", "overload.shed_packets")
        if m is None:
            # the count above is NOT in this branch: on this path the
            # drop is double-counted or mis-counted, and the checker
            # must not accept a count that belongs to another verdict
            return None                                        # OV01
        return m

    def fold_metric_counted(self, m):
        if m.rate < 1.0:
            self._tel.incr("_server", "overload.fold_sampled_out")
            return None                                        # ok
        return m

    def admit_key_nested_count(self, key, changed):
        if key is None:
            if changed:
                self._tel.mark("_server", "overload.keys_over_budget")
            return None                                        # ok
        return True

    def fold_bare_return_uncounted(self, m):
        if m is None:
            return                                             # OV01
        return m

    def route_helper_not_a_decision(self, m):
        # not admit*/fold*/shed*-named: free to return None silently
        if m is None:
            return None
        return m

    def shed_documented_escape(self, m):
        if m is None:
            # vlint: disable=OV01 reason=fixture-only: counted by the
            # caller, which owns this verdict's accounting
            return None
        return m
