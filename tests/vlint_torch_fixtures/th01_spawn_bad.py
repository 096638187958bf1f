"""TH01 fixture: a thread started through a spawner method, the port's
`self._spawn(self._flush_loop, "flusher")` idiom. The loop and the
public flush_once both reach _tick, so its unguarded write is flagged;
the write under the lock and the one in the loop alone are not."""
import threading


class Server:
    def __init__(self):
        self.lock = threading.Lock()
        self.ticks = 0
        self.guarded = 0
        self.loops = 0

    def start(self):
        self._spawn(self._flush_loop, "flusher")

    def _spawn(self, target, name):
        t = threading.Thread(target=target, name=name, daemon=True)
        t.start()
        return t

    def _flush_loop(self):
        self.loops += 1
        self._tick()

    def flush_once(self):
        self._tick()

    def _tick(self):
        self.ticks += 1                                          # TH01
        with self.lock:
            self.guarded += 1
