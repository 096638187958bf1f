"""SSF — Sensor Sample Format: veneur's native span/sample wire format
(the port's copy of veneur_tpu/ssf/__init__.py).

Parity: the hand-written helpers of the reference's ssf package —
ssf/*.go (sym: ssf.Count, ssf.Gauge, ssf.Histogram, ssf.Timing, ssf.Set,
ssf.Status, ssf.RandomlySample, ssf.Samples) — around the protobuf types
in protos/ssf.proto (sym: ssf.SSFSpan, ssf.SSFSample).

Samples are fire-and-forget metric points that ride inside spans; the
ssfmetrics sink extracts them into the aggregation engines on the server
side, so an application emitting spans gets metrics "for free".

The protobuf module is imported by the helpers that build a sample and
by the `SSFSpan` / `SSFSample` attributes, never when this package is
imported.
"""

from __future__ import annotations

import random
import time

# unit strings the reference attaches to timings
NANOSECOND = "ns"
MICROSECOND = "µs"
MILLISECOND = "ms"
SECOND = "s"

# unit string → seconds; "us" is an accepted ASCII alias for µs
TIME_UNITS = {
    NANOSECOND: 1e-9,
    MICROSECOND: 1e-6,
    "us": 1e-6,
    MILLISECOND: 1e-3,
    SECOND: 1.0,
}
_TIME_UNITS = TIME_UNITS


def __getattr__(name):
    if name in ("SSFSpan", "SSFSample"):
        from .protos import ssf_pb2
        return getattr(ssf_pb2, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _mk(metric, name: str, value: float, tags=None, unit: str = "",
        sample_rate: float = 1.0, timestamp: int | None = None, **kw):
    from .protos import ssf_pb2
    s = ssf_pb2.SSFSample(
        metric=metric, name=name, value=float(value),
        sample_rate=float(sample_rate), unit=unit,
        timestamp=int(timestamp) if timestamp is not None
        else time.time_ns(), **kw)
    for k, v in (tags or {}).items():
        s.tags[k] = v
    return s


# the SSFSample.Metric numbers of protos/ssf.proto
COUNTER, GAUGE, HISTOGRAM, SET, STATUS = 0, 1, 2, 3, 4


def count(name: str, value: float, tags=None, **kw):
    """A counter increment (ssf.Count)."""
    return _mk(COUNTER, name, value, tags, **kw)


def gauge(name: str, value: float, tags=None, **kw):
    """A gauge observation (ssf.Gauge)."""
    return _mk(GAUGE, name, value, tags, **kw)


def histogram(name: str, value: float, tags=None, **kw):
    """A histogram observation (ssf.Histogram)."""
    return _mk(HISTOGRAM, name, value, tags, **kw)


def timing(name: str, duration_s: float, unit: str = MILLISECOND,
           tags=None, **kw):
    """A timer observation; duration is seconds, converted to `unit`
    (ssf.Timing takes a time.Duration + resolution the same way)."""
    scale = _TIME_UNITS.get(unit, 1.0)
    return _mk(HISTOGRAM, name, duration_s / scale, tags, unit=unit, **kw)


def set_sample(name: str, member: str, tags=None, **kw):
    """A set-membership observation (ssf.Set); the member string travels
    in `message`."""
    return _mk(SET, name, 0.0, tags, message=member, **kw)


def status(name: str, state: int, tags=None, message: str = "", **kw):
    """A service-check observation (ssf.Status)."""
    return _mk(STATUS, name, float(state), tags, status=state,
               message=message, **kw)


def randomly_sample(rate: float, *samples, rng=random):
    """Keep the batch with probability `rate`, stamping the sample-rate on
    the survivors so aggregation re-weights them (ssf.RandomlySample)."""
    if rate >= 1.0 or rng.random() < rate:
        for s in samples:
            s.sample_rate = float(rate)
        return list(samples)
    return []


class Samples:
    """Batch of samples with a single .add() and one report hand-off
    (ssf.Samples)."""

    def __init__(self):
        self.batch: list = []

    def add(self, *samples):
        self.batch.extend(samples)

    def attach(self, span):
        span.metrics.extend(self.batch)
