"""Sketch-engine registry — counterpart of veneur_tpu/sketches/__init__.py.

The pipeline holds ONE histogram engine and ONE set engine, selected by
the `histogram_backend` / `set_backend` config keys. This slice of the
port has the default pair only (t-digest + HLL); the REQ and ULL engines
are still to port (ROADMAP queue A) and are refused loudly. The wire
stamp strings are identical to the JAX package's, so a mixed fleet can
compare them.
"""

from __future__ import annotations

from .hll_engine import HLLEngine
from .tdigest_engine import TDigestEngine

HISTOGRAM_BACKENDS = ("tdigest",)
SET_BACKENDS = ("hll",)


def histogram_engine(cfg):
    backend = getattr(cfg, "histogram_backend", "tdigest")
    if backend == "tdigest":
        return TDigestEngine(compression=float(cfg.compression),
                             buffer_depth=int(cfg.buffer_depth))
    raise ValueError(
        f"histogram_backend {backend!r} is not ported yet "
        f"(ported: {', '.join(HISTOGRAM_BACKENDS)}; ROADMAP queue A, "
        "non-default engines)")


def set_engine(cfg):
    backend = getattr(cfg, "set_backend", "hll")
    if backend == "hll":
        return HLLEngine(precision=int(cfg.hll_precision))
    raise ValueError(
        f"set_backend {backend!r} is not ported yet "
        f"(ported: {', '.join(SET_BACKENDS)}; ROADMAP queue A, "
        "non-default engines)")


def engine_stamp(heng, seng) -> str:
    """The wire stamp of an engine pair: "h=<id>/<ver>,s=<id>/<ver>"."""
    return (f"h={heng.id}/{heng.wire_version},"
            f"s={seng.id}/{seng.wire_version}")


# what an unstamped (legacy) peer is running, by definition
DEFAULT_STAMP = engine_stamp(TDigestEngine(), HLLEngine())
