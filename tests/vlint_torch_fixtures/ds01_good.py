"""DS01 good fixture: every device-landing bank write marks the dirty
bitmap, directly or through a marking helper."""


class _Engine:
    def _mark_dirty(self, kind, slots):
        self._dirty[kind][slots] = True

    def land_marked(self, slots, values, weights):
        self._mark_dirty(1, slots)
        self.counter_bank = self._kern["counter"](
            self.counter_bank, slots, values, weights)

    def land_via_marking_helper(self, slots, values):
        self.gauge_bank = self.helper_marks(
            self.gauge_bank, slots, values)

    def helper_marks(self, bank, slots, values):
        dirty = self._dirty
        dirty[2][slots] = True
        return self._kern["gauge"](bank, slots, values)
