"""QT01 fixture: query-path code touching a live engine's ingest/flush
lock or banks. The filename carries the /qt01_ scope marker. Line
numbers are pinned by tests/test_torch_vlint.py."""

import threading


class _QueryTier:
    def query_with_live_lock(self, engine, qs):
        with engine.lock:                                    # QT01
            return engine.histo_bank

    def query_acquires(self, engine):
        engine.lock.acquire()                                # QT01
        try:
            return engine.counter_bank
        finally:
            engine.lock.release()

    def query_writes_banks(self, engine, bank):
        engine.histo_bank = bank                             # QT01

    def query_writes_bank_tuple(self, engine, banks):
        (engine.counter_bank, engine.set_bank) = banks       # QT01 x2

    def query_scratch_ok(self, factory, group):
        # the blessed shape: a factory-minted scratch engine driven
        # through its public surface (it takes its OWN lock inside)
        eng = factory()
        eng.restore_checkpoint(*group)                       # ok
        return eng.flush(timestamp=1)                        # ok

    def query_private_lock_ok(self):
        self._lock = threading.Lock()
        with self._lock:                                     # ok
            return dict(self.__dict__)

    def query_suppressed(self, engine):
        # vlint: disable=QT01 reason=fixture-only: demonstrating the
        # suppression syntax for a documented non-engine lock
        with engine.lock:
            pass
