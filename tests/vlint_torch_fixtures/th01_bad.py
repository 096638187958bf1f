"""TH01 fixture: unguarded shared-state write. The /th01_ marker scopes
the threaded-file check in; the guarded write must NOT be flagged."""
import threading


class Server:
    def __init__(self):
        self.lock = threading.Lock()
        self.unguarded = 0
        self.guarded = 0

    def start(self):
        threading.Thread(target=self._loop).start()

    def _loop(self):
        self.work()

    def work(self):
        self.unguarded += 1
        with self.lock:
            self.guarded += 1
