"""QT01 good fixture: the query tier drives scratch engines through
their public surface and takes only its own bookkeeping locks."""

import threading


class _QueryTier:
    def __init__(self):
        self._lock = threading.Lock()
        self._cache_lock = threading.Lock()

    def query_scratch(self, factory, group):
        eng = factory()
        eng.restore_checkpoint(*group)
        return eng.flush(timestamp=1)

    def query_private_lock(self):
        with self._lock:
            return dict(self.__dict__)
