"""Egress layer: metric/span sinks and plugins (the port's copy of
veneur_tpu/sinks/__init__.py; the network sinks wait for ROADMAP queue A
item 9b).

Parity: sinks/sinks.go (sym: MetricSink — Name/Start/Flush/
FlushOtherSamples; SpanSink — Name/Start/Ingest/Flush) and plugins/
(sym: Plugin). Sinks are independent: one slow or failing sink must never
stall the others, so the server fans flushes out with per-sink timeouts
(veneur runs one goroutine per sink; here a thread per sink).
"""

from __future__ import annotations

import abc
from typing import Iterable

from ..metrics import FrameSet, InterMetric


class MetricSink(abc.ABC):
    """Destination for flushed metrics (sinks.MetricSink)."""

    @abc.abstractmethod
    def name(self) -> str: ...

    def start(self) -> None:
        """One-time setup; raise to disable the sink."""

    @abc.abstractmethod
    def flush(self, metrics: list[InterMetric]) -> None:
        """Deliver one interval's metrics. Called once per flush tick."""

    def flush_frames(self, frames: FrameSet) -> int | None:
        """Frame-aware delivery: the server hands every sink the flush's
        columnar FrameSet. The default materializes InterMetrics (lazily,
        in this sink's thread, shared across legacy sinks) and calls
        flush(); frame-native sinks override this to serialize straight
        from the blocks and never build 600k Python objects.

        Returns the number of metrics actually delivered (after sink
        routing / type drops) so veneur.sink.metrics_flushed_total counts
        what went out, not what was offered; None means "all of them"."""
        routed = filter_for_sink(self.name(), frames.to_list())
        self.flush(routed)
        return len(routed)

    def flush_other(self, events, checks) -> None:
        """Deliver events / service checks (FlushOtherSamples)."""

    def stop(self) -> None:
        """Graceful shutdown."""


class SpanSink(abc.ABC):
    """Destination for ingested SSF spans (sinks.SpanSink)."""

    @abc.abstractmethod
    def name(self) -> str: ...

    def start(self) -> None: ...

    @abc.abstractmethod
    def ingest(self, span) -> None: ...

    def flush(self) -> None: ...

    def stop(self) -> None: ...


class Plugin(abc.ABC):
    """Whole-interval dump plugins (plugins.Plugin: s3, localfile)."""

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def flush(self, metrics: list[InterMetric], hostname: str) -> None: ...

    def flush_frames(self, frames: FrameSet, hostname: str) -> None:
        """Frame-aware variant; default materializes lazily."""
        self.flush(frames.to_list(), hostname)


def filter_for_sink(sink_name: str, metrics: Iterable[InterMetric]):
    """Honor InterMetric.sinks routing (empty = deliver everywhere)."""
    return [m for m in metrics if not m.sinks or sink_name in m.sinks]
