"""Core metric value types of the flush (the port's copy of
veneur_tpu.metrics: MetricType, InterMetric, MetricFrame, FrameSet and
SampleBatchStats).

Parity: samplers/samplers.go (sym: InterMetric, MetricScope) — the flushed
representation handed to sinks.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import IntEnum


class MetricType(IntEnum):
    COUNTER = 0
    GAUGE = 1
    HISTOGRAM = 2
    SET = 3
    TIMER = 4
    STATUS = 5


@dataclass
class InterMetric:
    """One flushed metric handed to MetricSink.Flush — the unit of egress
    (samplers.InterMetric)."""
    name: str
    timestamp: int          # unix seconds
    value: float
    tags: list[str] = field(default_factory=list)
    type: MetricType = MetricType.GAUGE
    message: str = ""
    hostname: str = ""
    sinks: list[str] = field(default_factory=list)  # empty = all sinks


class MetricFrame:
    """Columnar flushed metrics — the egress representation.

    A flush at 100k histogram keys emits ~600k metrics; building 600k
    Python objects inside the flush would dominate the <50ms latency
    budget. Instead the flush assembles blocks of (per-key names, per-key
    tag refs, a [n, m] numpy value matrix, m column types) and hands this
    frame to the server; InterMetric objects are materialized lazily, only
    when a sink iterates (where the cost is amortized into serialization).

    `names[i]` is either one string (m == 1) or a sequence of m strings;
    `tags[i]` is a list[str] SHARED across all metrics of that key (and
    across flushes, via the engine's presentation cache) — consumers must
    treat it as read-only.
    """

    __slots__ = ("timestamp", "hostname", "_blocks", "_n", "_list",
                 "_mat_lock")

    def __init__(self, timestamp: int, hostname: str = ""):
        self.timestamp = timestamp
        self.hostname = hostname
        self._blocks: list = []
        self._n = 0
        self._list: list[InterMetric] | None = None
        self._mat_lock = threading.Lock()

    def add_block(self, names, tags, values, types) -> None:
        import numpy as np

        values = np.asarray(values)
        if values.ndim == 1:
            values = values[:, None]
        if len(names) != values.shape[0] or len(tags) != values.shape[0]:
            raise ValueError("block rows mismatch")
        if len(types) != values.shape[1]:
            raise ValueError("block cols mismatch")
        self._blocks.append((names, tags, values, tuple(types)))
        self._n += values.size
        self._list = None

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        if self._list is not None:
            yield from self._list
            return
        ts, host = self.timestamp, self.hostname
        for names, tags, values, types in self._blocks:
            rows = values.tolist()
            m = values.shape[1]
            if m == 1:
                t0 = types[0]
                for nm, tg, row in zip(names, tags, rows):
                    yield InterMetric(
                        name=nm if isinstance(nm, str) else nm[0],
                        timestamp=ts, value=row[0], tags=tg,
                        type=t0, hostname=host)
            else:
                for nms, tg, row in zip(names, tags, rows):
                    for j in range(m):
                        yield InterMetric(
                            name=nms[j], timestamp=ts, value=row[j],
                            tags=tg, type=types[j], hostname=host)

    def to_list(self) -> list[InterMetric]:
        # several sink threads may materialize concurrently; the lock
        # makes the (expensive) materialization happen exactly once
        if self._list is None:
            with self._mat_lock:
                if self._list is None:
                    self._list = [m for m in self]
        return self._list

    @property
    def blocks(self):
        """The raw (names, tags, values[n, m], types) blocks — the
        frame-native sink serialization surface."""
        return self._blocks


class FrameSet:
    """One flush's complete output: the engines' columnar frames plus
    loose InterMetrics (status checks, self-telemetry). This is what the
    server hands to sinks. Frame-native sinks serialize straight from the
    blocks; legacy sinks iterate, which materializes InterMetric objects
    lazily in the SINK's thread (off the flush critical path) and caches
    them once for all such sinks."""

    __slots__ = ("frames", "extra")

    def __init__(self, frames=None, extra=None):
        self.frames = frames or []
        self.extra = extra or []

    def __len__(self) -> int:
        return sum(len(f) for f in self.frames) + len(self.extra)

    def __iter__(self):
        for f in self.frames:
            yield from f
        yield from self.extra

    def to_list(self) -> list[InterMetric]:
        out = []
        for f in self.frames:
            out.extend(f.to_list())
        out.extend(self.extra)
        return out


@dataclass
class SampleBatchStats:
    """Per-flush ingest bookkeeping, reported as veneur.* self-metrics."""
    samples: int = 0
    dropped_no_slot: int = 0
    parse_errors: int = 0
