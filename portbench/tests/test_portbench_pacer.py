"""The sender sends its prelude, then keeps to its open loop's schedule
(a ramp, then the rate), against a fake port; and the traced run pairs each compress launch with
its own kernel."""

import json
import socket
import subprocess
import sys
import time

import pytest

from portbench import run, trace
from portbench.gen import statsd

TRAFFIC = {"generator": "statsd", "senders": 1, "lines_per_datagram": 10,
           "max_datagram_bytes": 1432, "ramp_s": 0.5,
           "mix": {"timer": {"keys": 50, "share": 4, "zipf": 1.2},
                   "counter": {"keys": 10, "share": 1, "zipf": 1.2}}}
RATE = 20000.0


@pytest.mark.parametrize("t", [0.0, 0.1, 0.25, 0.5, 0.7, 3.0])
def test_the_schedule_inverts(t):
    n = statsd.lines_due(t, RATE, 0.5)
    assert statsd.time_due(n, RATE, 0.5) == pytest.approx(t, abs=1e-9)


def test_the_sender_keeps_to_its_schedule():
    port = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    port.bind(("127.0.0.1", 0))
    port.settimeout(0.002)
    spec = {"traffic": TRAFFIC, "seed": 3, "sender": 0, "pool_lines": 1000}
    p = subprocess.Popen([sys.executable, "-m", "portbench.gen.statsd",
                          json.dumps(spec)], cwd=run.ROOT,
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         text=True)
    try:
        assert json.loads(p.stdout.readline())["ready"]
        p.stdin.write(json.dumps({"port": port.getsockname()[1]}) + "\n")
        p.stdin.flush()
        primed = json.loads(p.stdout.readline())["primed"]
        assert primed == statsd.prelude_datagrams(TRAFFIC, 0) * 10
        first = []
        while sum(d.count(b"\n") + 1 for d in first) < primed:
            first.append(port.recv(65536))
        names = {line.split(b":")[0] for d in first
                 for line in d.split(b"\n")}
        assert len(names) == 60         # every key of the mix, once
        t0 = time.monotonic() + 0.05
        p.stdin.write(json.dumps({"t0": t0, "rate": RATE}) + "\n")
        p.stdin.flush()
        lines, ahead = primed, 0.0
        while time.monotonic() < t0 + 1.5:
            try:
                d = port.recv(65536)
            except socket.timeout:
                continue
            lines += d.count(b"\n") + 1
            due = statsd.lines_due(time.monotonic() - t0, RATE, 0.5)
            ahead = max(ahead, lines - primed - due)
        p.stdin.write("stop\n")
        p.stdin.flush()
        report = json.loads(p.stdout.readline())
        while True:
            try:
                d = port.recv(65536)
            except socket.timeout:
                break
            lines += d.count(b"\n") + 1
        # never more than one datagram ahead of the schedule, and about
        # as many lines as it owes by the stop
        assert ahead <= TRAFFIC["lines_per_datagram"]
        assert report["lines"] == lines
        owed = statsd.lines_due(1.5, RATE, 0.5)
        assert report["lines"] - primed >= \
            0.8 * owed - report["held_s"] * RATE
    finally:
        p.stdin.close()
        p.wait(10)
        port.close()


class FakeTrace:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_launches_pair_with_their_kernels_by_order():
    calls = [(100, 256, 256, False, 0.5), (32768, 256, 256, True, 1.5),
             (200, 256, 256, False, 2.5), (32768, 256, 256, True, 9.5)]
    events = [("compress_kernel(float)", 0.50, 0.51),
              ("elementwise", 1.0, 1.1),
              ("compress_kernel(float)", 1.60, 1.70),
              ("compress_kernel(float)", 2.60, 2.62),
              ("compress_kernel(float)", 9.60, 9.80)]
    out = trace.summarize(FakeTrace(events), calls, 1.0, 9.0, {}, "pump")
    assert [c[:4] for c in out["compress"]] == [c[:4] for c in calls[1:3]]
    assert [c[4] for c in out["compress"]] == pytest.approx([0.1, 0.02])
    assert out["busy_s"] == pytest.approx(0.1 + 0.1 + 0.02)
    with pytest.raises(RuntimeError):
        trace.summarize(FakeTrace(events), calls[1:], 1.0, 9.0, {}, "pump")
