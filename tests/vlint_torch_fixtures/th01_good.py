"""TH01 good fixture: th01_bad.py with its shared write under the lock;
a method reached from one thread root writes freely, and a *_locked
method runs under its caller's lock."""
import threading


class Server:
    def __init__(self):
        self.lock = threading.Lock()
        self.unguarded = 0
        self.guarded = 0
        self.loop_only = 0

    def start(self):
        threading.Thread(target=self._loop).start()

    def _loop(self):
        self.loop_only += 1
        self.work()

    def work(self):
        with self.lock:
            self.unguarded += 1
            self._bump_locked()

    def _bump_locked(self):
        self.guarded += 1
