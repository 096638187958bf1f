"""The window's CPU accounting: every thread of the process counts but
the harness's own, which counts only inside its flush_once calls."""

import hashlib
import threading
import time
from types import SimpleNamespace

import torch

from portbench.cells import common

FLUSH_CPU_S = 0.05
INTERVAL_S = 0.25


def spin_cpu(seconds: float) -> None:
    t0 = time.thread_time()
    while time.thread_time() - t0 < seconds:
        pass


class FakeServer:
    """A flush_once that spends FLUSH_CPU_S of its caller's CPU and
    returns an empty FrameSet."""

    calls = 0

    def flush_once(self):
        self.calls += 1
        spin_cpu(FLUSH_CPU_S)
        return SimpleNamespace(frames=[], extra=[])


def test_the_harness_thread_counts_only_inside_its_flushes(monkeypatch):
    # the harness's thread spins between the flushes, where it would sleep
    def spin_until(t):
        while time.monotonic() < t:
            pass

    monkeypatch.setattr(common, "wait_until", spin_until)
    stop = threading.Event()

    def pump():
        # hashing releases the interpreter lock, so this thread's CPU
        # does not wait on the harness's spinning
        buf = bytes(1 << 24)
        while not stop.is_set():
            hashlib.sha256(buf).digest()

    th = threading.Thread(target=pump, name="pump-stand-in")
    th.start()
    recorders = common.Recorders(torch.device("cpu"), False)
    recorders.start()
    try:
        srv = FakeServer()
        win = common.window(
            srv, {"interval_s": INTERVAL_S}, SimpleNamespace(seconds=1.0),
            common.NameCodes(), (0.5,), "pump", lambda: [], recorders,
            time.monotonic() + 0.05, threads={"pump": th.native_id})
    finally:
        stop.set()
        th.join()
    cpu = common.cpu_split(win)
    wall = win["t_w1"] - win["t_w0"]
    assert srv.calls == 5
    # the opening flush and three of the four that close an interval
    # start within the span
    assert abs(cpu["flush_s"] - 4 * FLUSH_CPU_S) < 0.03
    # the pump stand-in ran all through the window
    assert cpu["pump_s"] > 0.2 * wall, cpu
    # the harness's thread spun outside its flushes, and none of that
    # counts: the window's CPU is the pump's and the flushes'
    outside = cpu["main_s"] - cpu["flush_s"]
    assert outside > 0.2 * wall, cpu
    rest = cpu["window_s"] - cpu["flush_s"] - cpu["pump_s"]
    assert abs(rest) < 0.1, cpu
    assert cpu["window_s"] < cpu["process_s"] - 0.2 * wall


def test_a_thread_that_cannot_be_read_is_left_out():
    assert common.thread_cpu_s(-1) is None
    c0 = common.cpu_clocks({"gone": -1})
    win = {"cpu_clocks": (c0, c0), "open_flush_cpu_s": 0.0,
           "flushes": [{"cpu_s": 1.0}]}
    assert "gone_s" not in common.cpu_split(win)
