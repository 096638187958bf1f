"""Cases the port's gate did not pin yet, port against reference on the
CPU: idle eviction (`idle_ttl_intervals: 1` over six intervals) and
bank-full drops at tiny slots, for both engine pairs (t-digest + HLL,
REQ + ULL); and a server with req+ull, three workers, `tags`,
`tags_exclude`, `metric_max_name_length` and idle eviction.

Contract (ROADMAP): slot ids, key sets, `dropped_no_slot` and processed
counts exact; count/min/max, counters, gauges and ULL estimates exact;
t-digest percentiles within 1% of the key's spread, REQ within rtol
1e-4, HLL estimates within rtol 1e-5.
"""

import numpy as np
import pytest

from veneur_tpu.config import read_config as jread_config
from veneur_tpu.ingest.parser import parse_packet as j_parse
from veneur_tpu.models import pipeline as jpipe
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks.basic import CaptureMetricSink as JCapture
from veneur_tpu_torch.config import read_config
from veneur_tpu_torch.ingest.parser import parse_packet as t_parse
from veneur_tpu_torch.models import pipeline as tpipe
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink

from test_torch_server import (_clear_process_registries, _compare,
                               _datagrams, _flush, _rows, _send)

PAIRS = [("tdigest", "hll"), ("req", "ull")]


def _engines(pair, **kw):
    hb, sb = pair
    cfg = dict(histogram_backend=hb, set_backend=sb, buffer_depth=32,
               batch_size=64, percentiles=(0.5, 0.99),
               aggregates=("min", "max", "count"), **kw)
    if hb == "req":
        cfg["req_capacity"] = 64
    return (jpipe.AggregationEngine(jpipe.EngineConfig(**cfg)),
            tpipe.AggregationEngine(tpipe.EngineConfig(**cfg),
                                    device="cpu"))


def _interval_lines(rng, keys):
    """Lines of every type over the given key ids."""
    out = []
    for k in keys:
        for v in rng.lognormal(2, 1, 5):
            out.append(f"e.lat.{k}:{v:.3f}|ms")
        out.append(f"e.hits.{k}:{int(rng.integers(1, 9))}|c")
        out.append(f"e.temp.{k}:{rng.normal(50, 10):.2f}|g")
        for m in rng.integers(0, 200, 6):
            out.append(f"e.users.{k}:u{m}|s")
    order = rng.permutation(len(out))
    return [out[i].encode() for i in order]


def _interners(eng):
    return [{(k.name, k.type, k.joined_tags): (info.slot, info.scope,
                                               info.last_interval)
             for k, info in ki._map.items()}
            for ki in (eng.histo_keys, eng.counter_keys, eng.gauge_keys,
                       eng.set_keys)]


def _compare_flush(jres, tres, pair, label):
    hb, sb = pair
    jr = {(m.name, tuple(m.tags)): (int(m.type), m.value)
          for m in jres.metrics}
    tr = {(m.name, tuple(m.tags)): (int(m.type), m.value)
          for m in tres.metrics}
    assert set(tr) == set(jr), (label, sorted(set(jr) ^ set(tr)))
    for (name, tags), (typ, v) in tr.items():
        w = jr[(name, tags)][1]
        assert typ == jr[(name, tags)][0]
        if name.endswith("percentile"):
            if hb == "req":
                assert v == pytest.approx(w, rel=1e-4), (label, name)
            else:
                base = name.rsplit(".", 1)[0]
                spread = tr[(base + ".max", tags)][1] - \
                    tr[(base + ".min", tags)][1]
                assert abs(v - w) <= 0.01 * spread + 1e-6, (label, name)
        elif name.startswith("e.users.") and sb == "hll":
            assert v == pytest.approx(w, rel=1e-5), (label, name)
        else:
            assert v == w, (label, name, v, w)
    for k in ("samples", "dropped_no_slot"):
        assert tres.stats[k] == jres.stats[k], (label, k)


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_idle_eviction_over_six_intervals(pair):
    """idle_ttl_intervals: 1 — a key idle for more than one interval is
    evicted and its slot reused; both engines evict the same keys and
    hand out the same slots, interval after interval."""
    jeng, teng = _engines(pair, histogram_slots=64, counter_slots=32,
                          gauge_slots=32, set_slots=16,
                          idle_ttl_intervals=1)
    rng = np.random.default_rng(5)
    plan = [range(0, 10), range(5, 15), range(20, 25), range(0, 10),
            [], range(10, 16)]
    sizes = []
    for i, keys in enumerate(plan):
        lines = _interval_lines(rng, keys)
        for eng, parse in ((jeng, j_parse), (teng, t_parse)):
            for ln in lines:
                eng.process(parse(ln))
        jres, tres = jeng.flush(timestamp=i), teng.flush(timestamp=i)
        _compare_flush(jres, tres, pair, i)
        assert _interners(teng) == _interners(jeng), i
        sizes.append(len(teng.counter_keys))
    # eviction happened: at each flush the keys the interval did not
    # touch left the interner
    assert sizes == [10, 10, 5, 10, 0, 6]


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_bank_full_drops_at_tiny_slots(pair):
    """More keys than slots: both engines drop the same samples for want
    of a slot (counted in dropped_no_slot) and flush the same rows."""
    jeng, teng = _engines(pair, histogram_slots=8, counter_slots=8,
                          gauge_slots=8, set_slots=4)
    rng = np.random.default_rng(9)
    for i in range(2):
        lines = _interval_lines(rng, range(i * 3, i * 3 + 14))
        for eng, parse in ((jeng, j_parse), (teng, t_parse)):
            for ln in lines:
                eng.process(parse(ln))
        jres, tres = jeng.flush(timestamp=i), teng.flush(timestamp=i)
        _compare_flush(jres, tres, pair, i)
        assert tres.stats["dropped_no_slot"] > 0
        assert _interners(teng) == _interners(jeng)


SERVER_YAML = """
interval: "3600s"
statsd_listen_addresses: ["udp://127.0.0.1:0"]
num_workers: 3
num_readers: 1
histogram_backend: req
set_backend: ull
tpu_req_capacity: 64
percentiles: [0.5, 0.99]
aggregates: ["min", "max", "count", "sum"]
hostname: testhost
tags: ["region:us", "tier:edge"]
tags_exclude: ["host", "pod"]
metric_max_name_length: 24
tpu_slot_idle_ttl_intervals: 1
tpu_histogram_slots: 768
tpu_counter_slots: 384
tpu_gauge_slots: 384
tpu_set_slots: 192
tpu_batch_size: 256
tpu_buffer_depth: 64
"""


def _server_lines(rng, n, tag, keys):
    out = []
    for i in range(n):
        k = int(rng.choice(keys))
        kind = i % 5
        host = f"host:h{i % 7},pod:p{i % 3},env:{tag}"
        if kind == 0:
            out.append(f"r.lat.{k}:{rng.lognormal(3, 1):.3f}|ms|#{host}")
        elif kind == 1:
            out.append(f"r.hits.{k}:{int(rng.integers(1, 9))}|c|#{host}")
        elif kind == 2:
            out.append(f"r.temp.{k}:{rng.normal(50, 10):.2f}|g")
        elif kind == 3:
            out.append(f"r.users.{k % 5}:u{int(rng.integers(0, 400))}|s")
        else:
            out.append(f"r.size.{k % 4}:{rng.gamma(2, 50):.2f}|h")
    # names over metric_max_name_length are refused (parse errors)
    out += ["a.name.well.over.the.limit:1|c",
            "x.too.long.a.timer.name.too:3|ms"]
    return [ln.encode() for ln in out]


def test_req_ull_server_three_workers_tags_exclude_and_eviction():
    """A reference and a port server with req+ull, three workers, global
    tags, tags_exclude, a name-length bound and idle eviction, over four
    flushes (two key sets, then a return, then idle): equal row-key sets
    and values under the contract."""
    jcap, tcap = JCapture(), CaptureMetricSink()
    jsrv = JServer(jread_config(text=SERVER_YAML), sinks=[jcap])
    tsrv = Server(read_config(text=SERVER_YAML + "aggregation_backend: cpu\n"),
                  sinks=[tcap])
    assert len(tsrv.engines) == 3
    _clear_process_registries()
    jsrv.start()
    tsrv.start()
    rng = np.random.default_rng(13)
    try:
        for n, (tag, keys) in enumerate((("one", range(0, 30)),
                                         ("two", range(20, 50)),
                                         ("three", range(0, 10)),
                                         (None, ())), start=1):
            if tag is not None:
                dgrams = _datagrams(rng, _server_lines(rng, 900, tag,
                                                       list(keys)))
                _send((jsrv, tsrv), dgrams)
            ts = 5000 + 10 * n
            jrows = _rows(_flush(jsrv, jcap, ts, n))
            trows = _rows(_flush(tsrv, tcap, ts, n))
            _compare(jrows, trows, n, sets=("r.users.",))
            if tag is not None:
                assert trows[("veneur.packet.error_total", (), 0)].value \
                    == 2
                lat = [k for k in trows if k[0].startswith("r.lat.")]
                assert lat and all("host" not in t and "pod" not in t
                                   for k in lat for t in k[1])
            for key in trows:
                if key[0].startswith("r.") and key[0].endswith(
                        ("percentile", ".min", ".max")):
                    # REQ percentiles within rtol 1e-4 (the 1%-of-spread
                    # bound of _compare holds them too)
                    assert trows[key].value == pytest.approx(
                        jrows[key].value, rel=1e-4), key
    finally:
        jsrv.stop()
        tsrv.stop()
