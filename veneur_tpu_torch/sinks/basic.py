"""The simple sinks: blackhole, debug, capture, localfile (the port's copy
of veneur_tpu/sinks/basic.py; span sinks wait for the SSF pipeline,
ROADMAP queue A item 9b).

Parity: sinks/blackhole/ (discard, for tests/benchmarks), sinks/debug/
(log flushed values), plugins/localfile/ (append TSV rows — the same TSV
schema the s3 plugin writes).
"""

from __future__ import annotations

import sys
import threading

from ..metrics import InterMetric
from . import MetricSink, Plugin


class BlackholeMetricSink(MetricSink):
    def __init__(self):
        self.flushed_total = 0

    def name(self) -> str:
        return "blackhole"

    def flush(self, metrics):
        self.flushed_total += len(metrics)

    def flush_frames(self, frames):
        # frame-native: count without materializing a single InterMetric
        n = len(frames)
        self.flushed_total += n
        return n


class DebugMetricSink(MetricSink):
    """Log every flushed metric (sinks/debug)."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr

    def name(self) -> str:
        return "debug"

    def flush(self, metrics):
        for m in metrics:
            print(f"DEBUG METRIC {m.name} {m.value} "
                  f"tags={','.join(m.tags)} type={m.type.name.lower()}",
                  file=self.stream)

    def flush_other(self, events, checks):
        for e in events:
            print(f"DEBUG EVENT {e.title!r}", file=self.stream)
        for c in checks:
            print(f"DEBUG CHECK {c.name} status={c.status}",
                  file=self.stream)


class CaptureMetricSink(MetricSink):
    """Test helper: record everything (the reference's capturing fake
    sink pattern in server_test.go)."""

    def __init__(self):
        self.flushes: list[list[InterMetric]] = []
        self.events = []
        self.checks = []
        self._cv = threading.Condition()

    def name(self) -> str:
        return "capture"

    def flush(self, metrics):
        with self._cv:
            self.flushes.append(list(metrics))
            self._cv.notify_all()

    def flush_other(self, events, checks):
        self.events.extend(events)
        self.checks.extend(checks)

    def wait_for_flush(self, n=1, timeout=10.0) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: len(self.flushes) >= n,
                                     timeout)

    @property
    def all_metrics(self):
        return [m for fl in self.flushes for m in fl]


def tsv_line(m: InterMetric, hostname: str, interval_s: int) -> str:
    """One TSV row per metric — the localfile/s3 plugin schema
    (plugins/s3/s3.go: name, tags, type, hostname, timestamp, value,
    interval)."""
    return "\t".join([
        m.name, ",".join(m.tags), m.type.name.lower(),
        m.hostname or hostname, str(m.timestamp), repr(m.value),
        str(interval_s)]) + "\n"


def tsv_from_frames(frames, hostname: str, interval_s: int):
    """Yield TSV rows straight from the FrameSet's blocks — byte-for-byte
    what tsv_line produces over the materialized list, minus the 600k
    InterMetric objects."""
    iv = str(interval_s)
    for fr in frames.frames:
        ts = str(fr.timestamp)
        host = fr.hostname or hostname
        for names, tags, values, types in fr.blocks:
            tnames = [t.name.lower() for t in types]
            m = values.shape[1]
            rows = values.tolist()
            if m == 1:
                t0 = tnames[0]
                for nm, tg, row in zip(names, tags, rows):
                    if not isinstance(nm, str):
                        nm = nm[0]
                    yield (f"{nm}\t{','.join(tg)}\t{t0}\t{host}\t{ts}"
                           f"\t{row[0]!r}\t{iv}\n")
            else:
                for nms, tg, row in zip(names, tags, rows):
                    jt = ",".join(tg)
                    for j in range(m):
                        yield (f"{nms[j]}\t{jt}\t{tnames[j]}\t{host}"
                               f"\t{ts}\t{row[j]!r}\t{iv}\n")
    for x in frames.extra:
        yield tsv_line(x, hostname, interval_s)


class LocalFilePlugin(Plugin):
    """Append one interval's metrics as TSV (plugins/localfile)."""

    def __init__(self, path: str, interval_s: int = 10):
        self.path = path
        self.interval_s = interval_s

    def name(self) -> str:
        return "localfile"

    def flush(self, metrics, hostname):
        with open(self.path, "a") as f:
            for m in metrics:
                f.write(tsv_line(m, hostname, self.interval_s))

    def flush_frames(self, frames, hostname):
        with open(self.path, "a") as f:
            f.writelines(tsv_from_frames(frames, hostname,
                                         self.interval_s))
