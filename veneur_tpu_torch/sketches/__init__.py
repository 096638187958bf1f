"""Sketch-engine registry — counterpart of veneur_tpu/sketches/__init__.py.

The pipeline holds ONE histogram engine and ONE set engine, selected by
the `histogram_backend` / `set_backend` config keys:

  histogram_backend:  "tdigest" (default) | "req"
  set_backend:        "hll" (default)     | "ull"

The wire stamp strings ("h=<id>/<ver>,s=<id>/<ver>") and the
set-register byte codec (byte 0 the engine code, 1 = HLL v1, 2 = ULL v1;
byte 1 the precision; then the raw u8 registers) are identical to the
JAX package's, so a mixed fleet can compare stamps and exchange
registers.
"""

from __future__ import annotations

import numpy as np

from .hll_engine import HLLEngine
from .req import REQEngine
from .tdigest_engine import TDigestEngine
from .ull import ULLEngine, join_registers_np

HISTOGRAM_BACKENDS = ("tdigest", "req")
SET_BACKENDS = ("hll", "ull")

# set-register wire codes (byte 0 of the payload)
_SET_WIRE_CODES = {"hll": 1, "ull": 2}
_SET_WIRE_IDS = {v: k for k, v in _SET_WIRE_CODES.items()}


def histogram_engine(cfg):
    backend = getattr(cfg, "histogram_backend", "tdigest")
    if backend == "tdigest":
        return TDigestEngine(compression=float(cfg.compression),
                             buffer_depth=int(cfg.buffer_depth))
    if backend == "req":
        return REQEngine(levels=int(getattr(cfg, "req_levels", 2)),
                         capacity=int(getattr(cfg, "req_capacity", 256)))
    raise ValueError(
        f"unknown histogram_backend {backend!r} "
        f"(known: {', '.join(HISTOGRAM_BACKENDS)})")


def set_engine(cfg):
    backend = getattr(cfg, "set_backend", "hll")
    if backend == "hll":
        return HLLEngine(precision=int(cfg.hll_precision))
    if backend == "ull":
        return ULLEngine(precision=int(getattr(cfg, "ull_precision", 13)))
    raise ValueError(
        f"unknown set_backend {backend!r} "
        f"(known: {', '.join(SET_BACKENDS)})")


def engine_stamp(heng, seng) -> str:
    """The wire stamp of an engine pair: "h=<id>/<ver>,s=<id>/<ver>"."""
    return (f"h={heng.id}/{heng.wire_version},"
            f"s={seng.id}/{seng.wire_version}")


# what an unstamped (legacy) peer is running, by definition
DEFAULT_STAMP = engine_stamp(TDigestEngine(), HLLEngine())


def parse_stamp(stamp: str) -> dict | None:
    """"h=tdigest/1,s=hll/1" -> {"h": ("tdigest", 1, "lossless"),
    "s": ("hll", 1, "lossless")}; a trailing "q" on a version (the
    quantized-centroid marker) parses as codec "q16". None for a
    malformed stamp (a peer that cannot be reasoned about is the
    mismatch case, not the legacy case)."""
    out = {}
    try:
        for part in stamp.split(","):
            kind, _, rest = part.partition("=")
            eng, _, ver = rest.partition("/")
            if kind not in ("h", "s") or not eng:
                return None
            codec = "lossless"
            if ver.endswith("q"):
                ver, codec = ver[:-1], "q16"
            out[kind] = (eng, int(ver or 1), codec)
    except ValueError:
        return None
    return out if ("h" in out and "s" in out) else None


def stamp_compatible(local: str, remote: str | None) -> bool:
    """Is a peer's stamp (None = legacy peer = DEFAULT_STAMP) mergeable
    into engines running `local`? Compared component-wise on (engine id,
    wire version, codec), so ordering never matters."""
    mine = parse_stamp(local)
    theirs = parse_stamp(remote if remote is not None else DEFAULT_STAMP)
    if mine is None or theirs is None:
        return False
    return mine == theirs


def encode_set_registers(engine_id: str, registers) -> bytes:
    regs = np.asarray(registers, np.uint8)
    precision = int(np.log2(len(regs)))
    return bytes([_SET_WIRE_CODES[engine_id], precision]) + regs.tobytes()


def decode_set_registers(data: bytes) -> tuple:
    """-> (engine_id, registers u8[m]); raises ValueError on an unknown
    code or a length mismatch."""
    if len(data) < 2 or data[0] not in _SET_WIRE_IDS:
        raise ValueError("bad set-sketch payload (unknown engine code)")
    precision = data[1]
    regs = np.frombuffer(data[2:], np.uint8)
    if len(regs) != 1 << precision:
        raise ValueError("set-sketch register count mismatch")
    return _SET_WIRE_IDS[data[0]], regs


def set_engine_for_id(engine_id: str, precision: int):
    """Engine object for a decoded wire payload (registers are joined by
    the payload's own engine)."""
    if engine_id == "hll":
        return HLLEngine(precision=precision)
    if engine_id == "ull":
        return ULLEngine(precision=precision)
    raise ValueError(f"unknown set engine {engine_id!r}")


def describe(heng, seng) -> dict:
    """JSON-ready engine description for /debug/flush (the same dict as
    the JAX package's)."""
    return {
        "stamp": engine_stamp(heng, seng),
        "histogram": {"id": heng.id, "wire_version": heng.wire_version,
                      "params": {k: getattr(heng, k)
                                 for k in heng.__dataclass_fields__},
                      "error_contract": heng.error_contract},
        "set": {"id": seng.id, "wire_version": seng.wire_version,
                "params": {k: getattr(seng, k)
                           for k in seng.__dataclass_fields__},
                "error_contract": seng.error_contract},
    }


def merge_registers(engine_id: str, a, b):
    """Host-side register union under the payload's engine semantics
    (max for HLL, lattice join for ULL)."""
    if engine_id == "ull":
        return join_registers_np(a, b)
    return np.maximum(np.asarray(a, np.uint8), np.asarray(b, np.uint8))
