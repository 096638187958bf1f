"""DS01 fixture: device-landing bank writes that skip the dirty-bitmap
mark. The filename carries the /ds01_ scope marker. One finding per
function, at its first landing line."""


class _Engine:
    def _mark_dirty(self, kind, slots):
        self._dirty[kind][slots] = True

    def land_unmarked(self, slots, values, weights):
        self.histo_bank = self._kern["histo"](                 # DS01
            self.histo_bank, slots, values, weights)

    def land_marked(self, slots, values, weights):
        self._mark_dirty(1, slots)
        self.counter_bank = self._kern["counter"](             # ok
            self.counter_bank, slots, values, weights)

    def land_via_marking_helper(self, slots, values):
        self.gauge_bank = self.helper_marks(                   # ok
            self.gauge_bank, slots, values)

    def helper_marks(self, bank, slots, values):
        dirty = self._dirty
        dirty[2][slots] = True
        return self._kern["gauge"](bank, slots, values)        # ok

    def land_via_inert_helper(self, slots, registers):
        self.set_bank = self.helper_no_mark(                   # DS01
            self.set_bank, slots, registers)

    def helper_no_mark(self, bank, slots, registers):
        # a landing-leaf call with no mark anywhere in the chain
        return merge_rows(bank, slots, registers)              # DS01

    def swap_fresh_suppressed(self):
        # vlint: disable=DS01 reason=fixture-only: fresh-bank rebind,
        # not a data landing — the new rows are exactly fresh init
        (self.histo_bank, self.counter_bank) = self._fresh_fn()


def merge_rows(bank, slots, registers):
    return bank
