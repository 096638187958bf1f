"""The whole slice: veneur_tpu_torch's AggregationEngine against
veneur_tpu's on one parsed DogStatsD stream (CPU), for every sketch
engine pair: (tdigest, hll) — the default — and (req, ull), (tdigest,
ull), (req, hll).

Three intervals go through both engines: one that takes the incremental
flush (with a hot-slot batch), one above the 0.75 dirty threshold that
takes the full flush, and an empty one (a double flush). Contract
levels of the flushed rows:

  * exact: metric names, tags and types, the flush path and its dirty
    counts, histogram count/min/max, counter totals of integer-weighted
    streams, gauge values, status checks, ULL set estimates (the u8
    registers are exact, so the value counts are, and the same numpy ML
    solve gives the same number);
  * contract: t-digest percentiles within 1% of the key's spread (max -
    min), REQ percentiles within rtol 1e-4 (ulps of log/exp between
    XLA-CPU and torch-CPU in the compacted items, and the cumsum's
    order), histogram sums and a 0.3-rate counter within rtol 1e-6
    (float64 batch sums in the port, float32 in JAX), HLL set estimates
    within rtol 1e-5 (JAX's exp2 is inexact for integer exponents >=
    13).

The port must also flush bit-identical rows with its incremental flush
on and off, for every pair.
"""

import numpy as np
import pytest
import torch

from veneur_tpu.ingest.parser import MetricKey as JMetricKey
from veneur_tpu.ingest.parser import ServiceCheck as JServiceCheck
from veneur_tpu.ingest.parser import parse_packet as j_parse
from veneur_tpu.models import pipeline as jpipe
from veneur_tpu_torch import sketches
from veneur_tpu_torch.ingest.parser import MetricKey as TMetricKey
from veneur_tpu_torch.ingest.parser import ServiceCheck, UDPMetric
from veneur_tpu_torch.ingest.parser import parse_packet as t_parse
from veneur_tpu_torch.models import pipeline as tpipe

CFG = dict(histogram_slots=64, counter_slots=32, gauge_slots=32,
           set_slots=8, buffer_depth=32, batch_size=256,
           percentiles=(0.5, 0.75, 0.99),
           aggregates=("min", "max", "count", "sum"))
# the non-default engine pairs; REQ at capacity 64 so the busiest keys
# and the hot key compact in the engine path too
OTHER_PAIRS = [("req", "ull"), ("tdigest", "ull"), ("req", "hll")]
REQ_CAPACITY = 64


def _lines(rng, n, n_timers):
    out = []
    for i in range(n):
        k = int(rng.integers(0, n_timers))
        kind = i % 7
        if kind in (0, 1):
            out.append(f"t.lat.{k}:{rng.lognormal(3, 1):.3f}|ms"
                       f"|#az:{k % 3},svc:api")
        elif kind == 2:
            out.append(f"h.size.{k % 4}:{rng.gamma(2, 50):.2f}|h")
        elif kind == 3:
            out.append(f"c.hits.{k % 8}:{int(rng.integers(1, 9))}|c|@0.5")
        elif kind == 4:
            out.append(f"c3.bytes:{int(rng.integers(1, 500))}|c|@0.3")
        elif kind == 5:
            out.append(f"g.temp.{k % 6}:{rng.normal(50, 10):.2f}|g|#dc:x")
        else:
            out.append(f"s.users.{k % 3}:u{int(rng.integers(0, 700))}|s")
    out.append("_sc|svc.health|1|#az:1|m:degraded")
    return [ln.encode() for ln in out]


def _intervals():
    rng = np.random.default_rng(11)
    hot = rng.lognormal(2, 0.5, 300).astype(np.float32)
    bulk = rng.gamma(3, 10, (56, 5)).astype(np.float32)
    return [
        {"lines": _lines(rng, 1500, 12), "hot": hot},
        {"lines": _lines(rng, 300, 12), "bulk": bulk},
        {"lines": []},
    ]


def _feed(eng, parse, d):
    for ln in d["lines"]:
        m = parse(ln)
        if isinstance(m, (ServiceCheck, JServiceCheck)):
            eng.process_service_check(m)
        else:
            eng.process(m)
    if "hot" in d:
        s = _lookup(eng, "hot.lat")
        v = d["hot"]
        eng.ingest_histo_batch(np.full(len(v), s, np.int32), v,
                               np.ones(len(v), np.float32), count=len(v))
    if "bulk" in d:
        b = d["bulk"]
        slots = np.repeat([_lookup(eng, f"bulk.{i}") for i in range(len(b))],
                          b.shape[1]).astype(np.int32)
        eng.ingest_histo_batch(slots, b.reshape(-1),
                               np.ones(b.size, np.float32), count=b.size)


def _lookup(eng, name):
    key = TMetricKey if isinstance(eng, tpipe.AggregationEngine) \
        else JMetricKey
    return eng.histo_keys.lookup(key(name, "timer", ""), 0)


def _rows(res):
    return {(m.name, tuple(m.tags)): (int(m.type), m.value)
            for m in res.metrics}


def _status(res):
    return sorted((m.name, tuple(m.tags), m.value, m.message)
                  for m in res.status_metrics)


def _canon(res):
    return sorted((m.name, tuple(m.tags), int(m.type), repr(m.value))
                  for m in res.metrics)


def _pair_cfg(pair):
    hb, sb = pair
    kw = dict(CFG, histogram_backend=hb, set_backend=sb)
    if hb == "req":
        kw["req_capacity"] = REQ_CAPACITY
    return kw


def _run(pair):
    """Feed the intervals to a JAX engine, a port engine and a port
    engine with the incremental flush off; their flushes per interval."""
    kw = _pair_cfg(pair)
    jeng = jpipe.AggregationEngine(jpipe.EngineConfig(**kw))
    teng = tpipe.AggregationEngine(tpipe.EngineConfig(**kw), device="cpu")
    tfull = tpipe.AggregationEngine(
        tpipe.EngineConfig(flush_incremental=False, **kw), device="cpu")
    out = []
    for i, d in enumerate(_intervals()):
        _feed(jeng, j_parse, d)
        _feed(teng, t_parse, d)
        _feed(tfull, t_parse, d)
        out.append((jeng.flush(timestamp=100 + i),
                    teng.flush(timestamp=100 + i),
                    tfull.flush(timestamp=100 + i)))
    return out


@pytest.fixture(scope="module")
def flushed():
    return _run(("tdigest", "hll"))


@pytest.fixture(scope="module", params=OTHER_PAIRS, ids="-".join)
def pair_flushed(request):
    return request.param, _run(request.param)


def _check_matches_jax(jres, tres, interval, pair):
    assert tres.stats["flush_path"] == jres.stats["flush_path"]
    assert tres.stats["flush_path"]["path"] == \
        ("incremental", "full", "incremental")[interval]
    jr, tr = _rows(jres), _rows(tres)
    assert sorted(tr) == sorted(jr)
    assert {k: v[0] for k, v in tr.items()} == {k: v[0]
                                                for k, v in jr.items()}
    assert _status(tres) == _status(jres)
    if interval == 2:
        assert not tr and not tres.status_metrics
        return
    assert len(tr) > 100
    hb, sb = pair
    for (name, tags), (_t, v) in tr.items():
        w = jr[(name, tags)][1]
        base = name.rsplit(".", 1)[0]
        if name.endswith((".count", ".min", ".max")) \
                or name.startswith(("c.", "g.")):
            assert v == w, (name, tags, v, w)
        elif name.endswith("percentile") and hb == "req":
            assert v == pytest.approx(w, rel=1e-4), (name, v, w)
        elif name.endswith("percentile"):
            spread = tr[(base + ".max", tags)][1] - \
                tr[(base + ".min", tags)][1]
            assert abs(v - w) <= 0.01 * spread + 1e-6, (name, v, w)
        elif name.startswith("s.") and sb == "ull":
            assert v == w, (name, v, w)
        elif name.startswith("s."):
            assert v == pytest.approx(w, rel=1e-5)
        else:                                      # .sum and c3.bytes
            assert v == pytest.approx(w, rel=1e-6), (name, v, w)


@pytest.mark.parametrize("interval", [0, 1, 2])
def test_flush_matches_jax(flushed, interval):
    jres, tres, _ = flushed[interval]
    _check_matches_jax(jres, tres, interval, ("tdigest", "hll"))


@pytest.mark.parametrize("interval", [0, 1, 2])
def test_other_engine_pairs_match_jax(pair_flushed, interval):
    pair, out = pair_flushed
    jres, tres, _ = out[interval]
    _check_matches_jax(jres, tres, interval, pair)


@pytest.mark.parametrize("interval", [0, 1, 2])
def test_other_engine_pairs_incremental_equals_full(pair_flushed,
                                                    interval):
    _, out = pair_flushed
    _, tres, tfull = out[interval]
    assert tfull.stats["flush_path"]["path"] == "full"
    assert _canon(tres) == _canon(tfull)
    assert _status(tres) == _status(tfull)


def test_other_engine_pairs_hot_slot_batch_is_exact(pair_flushed):
    """The hot key's 300 samples pre-cluster to the bank's batch
    headroom (for REQ, one level of capacity points, which compact at
    the flush): count, min and max stay exact."""
    _, out = pair_flushed
    rows = _rows(out[0][1])
    v = _intervals()[0]["hot"]
    assert rows[("hot.lat.count", ())][1] == 300.0
    assert rows[("hot.lat.min", ())][1] == float(v.min())
    assert rows[("hot.lat.max", ())][1] == float(v.max())


def test_hot_slot_batch_is_exact(flushed):
    _, tres, _ = flushed[0]
    rows = _rows(tres)
    v = _intervals()[0]["hot"]
    assert rows[("hot.lat.count", ())][1] == 300.0
    assert rows[("hot.lat.min", ())][1] == float(v.min())
    assert rows[("hot.lat.max", ())][1] == float(v.max())


@pytest.mark.parametrize("interval", [0, 1, 2])
def test_incremental_flush_bit_identical_to_full(flushed, interval):
    _, tres, tfull = flushed[interval]
    assert tfull.stats["flush_path"]["path"] == "full"
    assert _canon(tres) == _canon(tfull)
    assert _status(tres) == _status(tfull)


def test_engine_defaults_to_cuda():
    """With no device the engine takes the card; on a box without one
    it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        assert tpipe.AggregationEngine(
            tpipe.EngineConfig(**CFG)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.AggregationEngine(tpipe.EngineConfig(**CFG))


@pytest.mark.parametrize("module", ["tdigest", "hll", "req", "ull"])
def test_bank_init_requires_a_device(module):
    """A bank is never placed on the CPU by default: the caller names
    the device, as the engine always does."""
    from veneur_tpu_torch.ops import hll, tdigest
    from veneur_tpu_torch.sketches import req, ull
    init = {"tdigest": tdigest.init, "hll": hll.init, "req": req.init,
            "ull": ull.init}[module]
    with pytest.raises(TypeError, match="device"):
        init(4)
    bank = init(4, device="cpu")
    assert all(leaf.device.type == "cpu" for leaf in bank)


@pytest.mark.parametrize("override", [
    {"flush_fetch": "staged"}, {"flush_fetch_f16": True},
    {"flush_fetch": "host"}, {"flush_fetch": "async"}])
def test_features_outside_the_slice_are_refused(override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.EngineConfig(**override)


@pytest.mark.parametrize("flag,server_key,value", [
    ("forward_enabled", "forward_address", "http://127.0.0.1:1"),
    ("is_global", "is_global", True)])
def test_global_tier_flags_construct_and_the_server_refuses_them(
        flag, server_key, value):
    """The engine takes the global tier's flags; since the forwarder and
    the import server are ported, the server no longer refuses the
    config key that turns them on: it sets the flag on its engines and
    builds the forwarder or the dedupe ledger."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.resilience import ResilientForwarder
    from veneur_tpu_torch.server import Server
    eng = tpipe.AggregationEngine(tpipe.EngineConfig(**CFG, **{flag: True}),
                                  device="cpu")
    assert getattr(eng.cfg, flag) is True
    assert eng._fwd_out == (flag == "forward_enabled")
    cfg = Config(aggregation_backend="cpu", tpu_histogram_slots=256,
                 tpu_counter_slots=128, tpu_gauge_slots=128,
                 tpu_set_slots=64, tpu_batch_size=256,
                 forward_use_grpc=False)
    setattr(cfg, server_key, value)
    srv = Server(cfg)
    try:
        assert all(getattr(e.cfg, flag) is True for e in srv.engines)
        if flag == "forward_enabled":
            assert isinstance(srv.forwarder, ResilientForwarder)
        else:
            assert srv.dedupe_ledger is not None and srv.forwarder is None
    finally:
        srv.stop()


@pytest.mark.parametrize("override", [
    {"histogram_backend": "kll"}, {"set_backend": "cpc"},
    {"ull_precision": 3}, {"ull_precision": 17}, {"req_levels": 0},
    {"req_capacity": 24}, {"req_capacity": 100}])
def test_bad_engine_settings_are_refused(override):
    """The JAX config's checks (veneur_tpu/config.py) on the port's
    EngineConfig."""
    with pytest.raises(ValueError):
        tpipe.EngineConfig(**override)


@pytest.mark.parametrize("pair", [("tdigest", "hll")] + OTHER_PAIRS,
                         ids="-".join)
def test_engine_stamp_matches_jax(pair):
    from veneur_tpu import sketches as jsk
    assert sketches.DEFAULT_STAMP == jsk.DEFAULT_STAMP
    kw = _pair_cfg(pair)
    teng = tpipe.AggregationEngine(tpipe.EngineConfig(**kw), device="cpu")
    cfg = jpipe.EngineConfig(**kw)
    assert teng.engine_stamp == jsk.engine_stamp(
        jsk.histogram_engine(cfg), jsk.set_engine(cfg))
    assert sketches.stamp_compatible(teng.engine_stamp, teng.engine_stamp)
    assert sketches.stamp_compatible(teng.engine_stamp, None) == \
        (pair == ("tdigest", "hll"))


@pytest.mark.parametrize("stamp", [
    "h=tdigest/1,s=hll/1", "h=req/1,s=ull/1", "s=ull/2,h=tdigest/1q",
    "h=tdigest", "garbage", "h=x/y,s=hll/1", "h=req/1"])
def test_stamp_parsing_matches_jax(stamp):
    from veneur_tpu import sketches as jsk
    assert sketches.parse_stamp(stamp) == jsk.parse_stamp(stamp)
    for other in ("h=tdigest/1,s=hll/1", "h=req/1,s=ull/1", None):
        assert sketches.stamp_compatible(stamp, other) == \
            jsk.stamp_compatible(stamp, other)


@pytest.mark.parametrize("engine_id", ["hll", "ull"])
def test_set_register_codec_matches_jax(engine_id):
    from veneur_tpu import sketches as jsk
    rng = np.random.default_rng(3)
    a = rng.integers(0, 200, 1 << 10).astype(np.uint8)
    b = rng.integers(0, 200, 1 << 10).astype(np.uint8)
    data = sketches.encode_set_registers(engine_id, a)
    assert data == jsk.encode_set_registers(engine_id, a)
    back_id, back = sketches.decode_set_registers(data)
    assert back_id == engine_id
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(sketches.merge_registers(engine_id, a, b),
                                  jsk.merge_registers(engine_id, a, b))
    assert sketches.set_engine_for_id(engine_id, 10).id == engine_id
    for bad in (b"\x07\x0a" + a.tobytes(), data[:-1], b"\x01"):
        with pytest.raises(ValueError):
            sketches.decode_set_registers(bad)


def test_parsed_stream_is_identical():
    """The port's parser copy yields the same samples as the JAX
    package's on the test stream."""
    for ln in _intervals()[0]["lines"]:
        t, j = t_parse(ln), j_parse(ln)
        if isinstance(t, UDPMetric):
            assert (t.key.name, t.key.type, t.key.joined_tags, t.digest,
                    t.value, t.sample_rate, t.scope) == \
                (j.key.name, j.key.type, j.key.joined_tags, j.digest,
                 j.value, j.sample_rate, j.scope)
