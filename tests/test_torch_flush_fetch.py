"""The flush fetch modes (ROADMAP item 16) of veneur_tpu_torch's engine,
against the JAX package's on the CPU: the counterparts of
tests/test_engine.py's fetch-mode tests.

Every mode ("sync", "staged", "host" — "staged" on a CPU engine, as the
JAX package falls back without pinned host memory — and "async") only
changes how the outputs leave the device, so a port engine flushes bit
for bit the rows of a port sync engine, and the JAX package's rows
under the comparison contract (percentiles within 1% of the key's
spread, set estimates rtol 1e-5, the rest exact). The compact mode
(`flush_fetch_f16`) keeps count and sum exact, rounds quantiles and the
other aggregates to f16 (rtol 1e-3 of the f32 engine's), and fetches its
full-precision twins and 2Sum lo terms exactly when the JAX package's
sentinels ask for them: the same keys cross the wire in both packages.
Both the incremental and the full flush bodies, and the baseline rows,
go through the one fetch.
"""

import numpy as np
import pytest
import torch

from veneur_tpu.ingest import parser as jparser
from veneur_tpu.models import pipeline as jpipe
from veneur_tpu_torch.ingest import parser as tparser
from veneur_tpu_torch.models import pipeline as tpipe

MODES = ["sync", "staged", "host", "async"]
LINES = ([b"c.hits:7|c", b"g.temp:70|g", b"s.u:alice|s", b"s.u:bob|s"]
         + [f"t.req:{v}|ms".encode() for v in range(1, 201)])
OUT_OF_RANGE = ([f"t.big:{v}|ms".encode()
                 for v in (1e5, 2e5, 3e5, 4e5, 5e5)] * 20
                + [f"t.tiny:{v}|ms".encode() for v in (1e-6, 2e-6, 3e-6)]
                * 20)


def _cfg(mod, **kw):
    base = dict(histogram_slots=256, counter_slots=128, gauge_slots=128,
                set_slots=64, batch_size=512, buffer_depth=128)
    base.update(kw)
    return mod.EngineConfig(**base)


def _port(lines, **kw):
    eng = tpipe.AggregationEngine(_cfg(tpipe, **kw), device="cpu")
    eng.warmup()
    for ln in lines:
        eng.process(tparser.parse_packet(ln))
    return eng


def _ref(lines, **kw):
    eng = jpipe.AggregationEngine(_cfg(jpipe, **kw))
    for ln in lines:
        eng.process(jparser.parse_packet(ln))
    return eng


def _rows(res):
    return {(m.name, tuple(m.tags)): m.value for m in res.metrics}


def _contract(got, want, f16=False):
    """Port rows against the JAX package's: percentiles within 1% of the
    key's spread (plus f16's rounding under the compact mode), the set
    rtol 1e-5, the rest exact (f16-rounded alike in both under the
    compact mode: min and max are exact before the rounding)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        name = k[0]
        if name.endswith("percentile"):
            base = name.rsplit(".", 1)[0]
            spread = want[(base + ".max", k[1])] - want[(base + ".min", k[1])]
            tol = 0.01 * spread + (1e-3 * abs(w) if f16 else 0.0)
            assert abs(got[k] - w) <= tol, (k, got[k], w)
        elif name == "s.u":
            assert got[k] == pytest.approx(w, rel=1e-5), k
        else:
            assert got[k] == w, (k, got[k], w)


@pytest.mark.parametrize("mode", MODES)
def test_flush_fetch_modes_identical(mode):
    """Every mode flushes the port's sync rows bit for bit (incremental
    then full flush body), and the JAX package's rows under the same
    mode within the contract."""
    port = _port(LINES, flush_fetch=mode)
    assert port._fetch_mode == ("staged" if mode == "host" else mode)
    sync = _port(LINES)
    want = _rows(_ref(LINES, flush_fetch=mode).flush(1000))
    got = _rows(port.flush(1000))
    assert port._last_flush_info["path"] == "incremental"
    assert got == _rows(sync.flush(1000))
    _contract(got, want)
    full = _port(LINES, flush_fetch=mode, flush_incremental=False)
    assert _rows(full.flush(1000)) == got


@pytest.mark.parametrize("mode,incremental", [
    ("sync", True), ("staged", True), ("host", False), ("async", False)])
def test_flush_fetch_f16_compact(mode, incremental):
    """Compact wire mode: count and sum exact (f32 hi + sentinel-gated lo),
    quantiles and min/max within f16 rounding of the f32 engine's, the
    JAX package's compact rows within the contract, and fewer bytes
    fetched than the f32 engine's flush."""
    kw = dict(aggregates=("min", "max", "count", "sum"),
              flush_incremental=incremental)
    f32 = _port(LINES, **kw)
    eng = _port(LINES, flush_fetch=mode, flush_fetch_f16=True, **kw)
    res32, res = f32.flush(1000), eng.flush(1000)
    ref = _rows(_ref(LINES, flush_fetch=mode, flush_fetch_f16=True,
                     **kw).flush(1000))
    got, want = _rows(res), _rows(res32)
    assert got.keys() == want.keys()
    for k in want:
        exact = k[0].endswith((".count", ".sum")) \
            or not k[0].startswith("t.")
        np.testing.assert_allclose(got[k], want[k],
                                   rtol=0 if exact else 1e-3, err_msg=k)
    _contract(got, ref, f16=True)
    assert res.stats["fetch_bytes"] < res32.stats["fetch_bytes"]


def test_flush_fetch_f16_out_of_range_falls_back_exact():
    """Values beyond f16's range (> 65504) and below its min normal trip
    the sentinels and the host fetches the full-precision twins: the
    rows equal the f32 engine's (rtol 1e-6, as the JAX package's test)
    and are all finite."""
    f32 = _rows(_port(OUT_OF_RANGE).flush(1000))
    got = _rows(_port(OUT_OF_RANGE, flush_fetch_f16=True).flush(1000))
    assert got.keys() == f32.keys()
    for k in f32:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], f32[k], rtol=1e-6, err_msg=k)
    _contract(got, _rows(_ref(OUT_OF_RANGE, flush_fetch_f16=True)
                         .flush(1000)))


@pytest.mark.parametrize("lines", [LINES, OUT_OF_RANGE],
                         ids=["in_range", "out_of_range"])
def test_compact_fetch_moves_the_reference_keys(monkeypatch, lines):
    """The compact flush's first fetch and its sentinel-gated second one
    move the same keys in both packages (the q32/lp32 twins only out of
    f16's range, the lo terms only when nonzero), with the same
    overflow and tiny sentinels."""
    seen = {}

    def recorder(name, fn):
        def wrapped(out, *a, **kw):
            host = fn(out, *a, **kw)
            if "lo_mag" in host:
                seen.setdefault(name, []).append(
                    (sorted(host), float(host["overflow_mag"]),
                     float(host["tiny_mag"]), float(host["lo_mag"])))
            return host
        return wrapped
    monkeypatch.setattr(tpipe, "fetch_flush_outputs",
                        recorder("port", tpipe.fetch_flush_outputs))
    monkeypatch.setattr(jpipe, "fetch_flush_outputs",
                        recorder("ref", jpipe.fetch_flush_outputs))
    kw = dict(aggregates=("min", "max", "count", "sum"),
              flush_fetch_f16=True)
    _port(lines, **kw).flush(1000)
    _ref(lines, **kw).flush(1000)
    # the last fetch of each is the interval's (the first may be the
    # baseline rows)
    p, r = seen["port"][-1], seen["ref"][-1]
    assert p[0] == r[0]
    assert p[1] == pytest.approx(r[1], rel=1e-3)
    assert p[2] == pytest.approx(r[2], rel=1e-3) and p[3] == r[3] == 0.0


def test_f16_tiny_sentinel_sits_at_min_normal():
    """_F16_TINY is f16's min normal (2^-14), the JAX package's value: a
    magnitude below it would cross the wire as an f16 subnormal, so the
    twins are fetched; at or above it they are not."""
    assert tpipe._F16_TINY == jpipe._F16_TINY == 2.0 ** -14
    assert tpipe._F16_SAT == jpipe._F16_SAT

    def fetched_keys(tiny, overflow=1.0, lo=0.0):
        out = {"lo_mag": torch.tensor(lo),
               "overflow_mag": torch.tensor(overflow),
               "tiny_mag": torch.tensor(tiny, dtype=torch.float32),
               "q16": torch.zeros((2, 2), dtype=torch.float16),
               "q32": torch.zeros((2, 2)),
               "lo_count": torch.zeros(2)}
        return set(tpipe.fetch_flush_outputs(out, "sync"))

    assert "q32" in fetched_keys(6.1e-5)
    assert "q32" in fetched_keys(6.103e-5)
    assert "q32" not in fetched_keys(6.10352e-5)
    assert "q32" in fetched_keys(1.0, overflow=61440.0)
    assert "lo_count" in fetched_keys(1.0, lo=1e-3)
    assert "lo_count" not in fetched_keys(1.0)


@pytest.mark.parametrize("mode", ["staged", "async"])
def test_fetch_modes_on_the_req_ull_pair(mode):
    """The other engine pair's outputs (REQ's quantiles, ULL's value
    counts finished on the host) leave the device under each mode as
    under sync: the rows are bit for bit a sync engine's, f16 included
    within its rounding."""
    kw = dict(histogram_backend="req", set_backend="ull",
              req_capacity=64, ull_precision=10)
    sync = _rows(_port(LINES, **kw).flush(1000))
    assert _rows(_port(LINES, flush_fetch=mode, **kw).flush(1000)) == sync
    f16 = _rows(_port(LINES, flush_fetch=mode, flush_fetch_f16=True,
                      **kw).flush(1000))
    assert f16.keys() == sync.keys()
    for k in sync:
        np.testing.assert_allclose(f16[k], sync[k], rtol=1e-3, err_msg=k)
