"""The global tier of veneur_tpu_torch against veneur_tpu's, on the CPU.

Local engines with `forward_enabled` build forward exports, the wire
turns them into metricpb bytes, and a global engine (`is_global`) lands
them through `import_list`. The same traffic, made from a seed, goes
through both packages. Contract levels:

  * exact: export key lists and their order, the export kind, the
    counter, gauge and set payload bytes, HLL/ULL registers after
    import, counter totals, gauge values, histogram count/min/max, the
    `forward_kind` and `retired_import_op` stats, and the flushed row
    keys and types;
  * contract: t-digest percentiles within 1% of each key's spread (of
    numpy's quantile over the union, and of each other), HLL estimates
    within rtol 1e-5, REQ percentiles within rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu import observe as jobserve
from veneur_tpu.cluster import wire as jwire
from veneur_tpu.ingest import admission as jadm
from veneur_tpu.ingest import parser as jparser
from veneur_tpu.models import pipeline as jpipe
from veneur_tpu.ops import hll as jhll
from veneur_tpu.ops import scalar as jscalar
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu_torch import observe
from veneur_tpu_torch.cluster import wire as twire
from veneur_tpu_torch.cluster.protos import forward_pb2
from veneur_tpu_torch.ingest import admission as tadm
from veneur_tpu_torch.ingest import parser as tparser
from veneur_tpu_torch.models import pipeline as tpipe
from veneur_tpu_torch.ops import hll as thll
from veneur_tpu_torch.ops import scalar as tscalar
from veneur_tpu_torch.ops import tdigest as ttd

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU side here is many small tensor ops; the suite runs
    several workers at once, and an intra-op thread pool in each would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(histogram_slots=256, counter_slots=128, gauge_slots=128,
             set_slots=64, batch_size=512, buffer_depth=128)
PAIRS = [("tdigest", "hll"), ("req", "ull")]


class Pkg:
    """One package's engine, parser and wire under one interface."""

    def __init__(self, name):
        self.name = name
        torch_side = name == "torch"
        self.pipe = tpipe if torch_side else jpipe
        self.parser = tparser if torch_side else jparser
        self.wire = twire if torch_side else jwire

    def engine(self, **kw):
        cfg = self.pipe.EngineConfig(**{**SMALL, **kw})
        if self.name == "torch":
            return tpipe.AggregationEngine(cfg, device="cpu")
        return jpipe.AggregationEngine(cfg)

    def feed(self, eng, lines):
        for ln in lines:
            eng.process(self.parser.parse_packet(ln))

    def key(self, name, mtype, tags=""):
        return self.parser.MetricKey(name, mtype, tags)

    def send(self, res, codec="lossless"):
        """A local's flush result as the bytes a forwarder sends."""
        metrics = self.wire.export_to_metrics(res.export, codec=codec)
        return forward_pb2.MetricList(metrics=metrics).SerializeToString()


PORT, REF = Pkg("torch"), Pkg("jax")


def received(data):
    return forward_pb2.MetricList.FromString(data).metrics


def local_lines(j, rng, samples):
    """One local's traffic: mixed timers (their samples recorded in
    `samples`), local-only and global-only timers, global-only and mixed
    counters, global-only gauges and mixed sets."""
    out = []
    for k in range(12):
        for v in rng.gamma(3.0, 20.0, 9 + k).astype(np.float32):
            samples.setdefault(f"t.m{k}", []).append(v)
            out.append(b"t.m%d:%r|ms|#env:p" % (k, float(v)))
    for k in range(3):
        out.append(b"t.l%d:%d|ms|#veneurlocalonly" % (k, j + k))
        v = float(np.float32(rng.normal(50, 5)))
        samples.setdefault(f"t.g{k}", []).append(np.float32(v))
        out.append(b"t.g%d:%r|h|#veneurglobalonly" % (k, v))
    for k in range(6):
        out.append(b"c.g%d:%d|c|#veneurglobalonly" % (k, j + k))
        out.append(b"c.m%d:2|c" % k)
    for k in range(4):
        out.append(b"g.g%d:%d.5|g|#veneurglobalonly" % (k, 10 * j + k))
    for k in range(3):
        for i in range(40):
            out.append(b"s.m%d:u%d|s" % (k, 20 * j + i))
    return out


def canon(res):
    return sorted((m.name, tuple(m.tags), int(m.type), repr(m.value))
                  for m in res.metrics)


def rows(res):
    return {(m.name, tuple(m.tags)): m for m in res.metrics}


def point_quantiles(means, weights, qs):
    """Quantiles of weighted points, interpolated between mid-ranks (the
    same function for both packages' exports)."""
    order = np.argsort(means, kind="stable")
    m = np.asarray(means, np.float64)[order]
    w = np.asarray(weights, np.float64)[order]
    cum = np.cumsum(w)
    return np.interp(qs, (cum - w / 2) / cum[-1], m)


def check_global_rows(res_t, res_j, samples, counters, gauges, pair):
    """Two global flushes of the same forwards, against each other and
    the truth of the union. t-digest percentiles: within 1% of the key's
    spread of each other and of numpy's "hazen" quantile (what a handful
    of singleton centroids interpolates to); REQ percentiles of these
    uncompacted keys: within rtol 1e-4 of each other and of the REQ knot
    scheme on the raw samples (`chip_smoke.req_quantile_np`)."""
    from chip_smoke import req_quantile_np
    rt, rj = rows(res_t), rows(res_j)
    assert sorted((k, int(m.type)) for k, m in rt.items()) == \
        sorted((k, int(m.type)) for k, m in rj.items())
    for key, m in rt.items():
        name = key[0]
        want = rj[key].value
        if name.endswith("percentile"):
            v = np.asarray(samples[name.rsplit(".", 1)[0]], np.float64)
            q = float(name.rsplit(".", 1)[1][:-len("percentile")]) / 100
            if pair[0] == "req":
                truth = req_quantile_np(v, [float(np.float32(q))])[0]
                assert m.value == pytest.approx(want, rel=1e-4), name
                assert m.value == pytest.approx(truth, rel=1e-4), name
                continue
            spread = v.max() - v.min()
            assert abs(m.value - want) <= 0.01 * spread + 1e-6, name
            truth = np.quantile(v, q, method="hazen")
            assert abs(m.value - truth) <= 0.01 * spread + 1e-6, name
        elif name.startswith("s.") and pair[1] == "hll":
            assert m.value == pytest.approx(want, rel=1e-5), name
        else:
            assert m.value == want, name
    for name, total in counters.items():
        assert rt[(name, ())].value == total
    for name, value in gauges.items():
        assert rt[(name, ())].value == value
    for name, v in samples.items():
        tags = ("env:p",) if name.startswith("t.m") else ()
        assert rt[(name + ".count", tags)].value == len(v)
        assert rt[(name + ".min", tags)].value == float(np.min(v))
        assert rt[(name + ".max", tags)].value == float(np.max(v))


def fleet(pkg, pair, n_locals, seed, codec="lossless"):
    """n_locals locals of one package: (the bytes each sends, their
    flush results, the union's timer samples, counter totals and last
    gauge values)."""
    rng = np.random.default_rng(seed)
    samples, sent, results = {}, [], []
    counters, gauges = {}, {}
    for j in range(n_locals):
        loc = pkg.engine(forward_enabled=True, histogram_backend=pair[0],
                         set_backend=pair[1])
        pkg.feed(loc, local_lines(j, rng, samples))
        res = loc.flush(timestamp=10)
        results.append(res)
        sent.append(pkg.send(res, codec))
        for k in range(6):
            counters[f"c.g{k}"] = counters.get(f"c.g{k}", 0) + j + k
        for k in range(4):
            gauges[f"g.g{k}"] = 10 * j + k + 0.5
    return sent, results, samples, counters, gauges


def land(pkg, pair, sent, **kw):
    glob = pkg.engine(is_global=True, histogram_backend=pair[0],
                      set_backend=pair[1], **kw)
    for op, data in enumerate(sent, start=1):
        assert glob.import_list(op, received(data)) == ([], [])
    return glob


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_local_export_matches_reference(pair):
    """A port local and a reference local fed the same traffic: the same
    export keys in the same order, byte-equal counter, gauge and set
    payloads, histogram exports within the contract, and the same local
    frame (mixed timers aggregates only, local-only timers in full)."""
    sent_t, res_t, samples, _c, _g = fleet(PORT, pair, 2, seed=1)
    sent_j, res_j, _s, _c2, _g2 = fleet(REF, pair, 2, seed=1)
    for rt, rj, bt, bj in zip(res_t, res_j, sent_t, sent_j):
        et, ej = rt.export, rj.export
        assert et.kind == ej.kind == "full"
        assert et.set_engine == ej.set_engine == pair[1]
        for field in ("histograms", "sets", "counters", "gauges"):
            assert [(k.name, k.type, k.joined_tags)
                    for k, *_ in getattr(et, field)] == \
                [(k.name, k.type, k.joined_tags)
                 for k, *_ in getattr(ej, field)], field
        mt, mj = received(bt), received(bj)
        for a, b in zip(mt, mj):
            if a.WhichOneof("value") != "histogram":
                assert a.SerializeToString() == b.SerializeToString()
        for ht, hj in zip(et.histograms, ej.histograms):
            assert ht[3:5] == hj[3:5] and ht[6] == hj[6]
            assert ht[5] == pytest.approx(hj[5], rel=1e-6)
            assert float(np.sum(ht[2])) == float(np.sum(hj[2]))
            v = np.asarray(samples[ht[0].name], np.float64)
            spread = v.max() - v.min()
            qs = [0.25, 0.5, 0.9]
            np.testing.assert_allclose(
                point_quantiles(ht[1], ht[2], qs),
                point_quantiles(hj[1], hj[2], qs), atol=0.01 * spread)
        assert "t.l0" not in {k.name for k, *_ in et.histograms}
        kt, kj = rows(rt), rows(rj)
        assert sorted(kt) == sorted(kj)
        assert ("t.m0.min", ("env:p",)) in kt
        assert ("t.m0.50percentile", ("env:p",)) not in kt
        assert ("t.l0.50percentile", ()) in kt
        assert not any(k[0].startswith(("t.g", "c.g", "g.g", "s."))
                       for k in kt)
        for key, m in kt.items():
            if "percentile" not in key[0]:
                assert m.value == kj[key].value, key


@pytest.mark.parametrize("codec", ["lossless", "q16"])
@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_two_tier_matches_reference(pair, codec):
    """Port locals into a port global against reference locals into a
    reference global, over the wire, in either centroid codec."""
    sent_t, _r, samples, counters, gauges = fleet(PORT, pair, 3, 2, codec)
    sent_j, *_ = fleet(REF, pair, 3, 2, codec)
    gt, gj = land(PORT, pair, sent_t), land(REF, pair, sent_j)
    res_t, res_j = gt.flush(timestamp=20), gj.flush(timestamp=20)
    check_global_rows(res_t, res_j, samples, counters, gauges, pair)
    assert res_t.stats["retired_import_op"] == \
        res_j.stats["retired_import_op"] == 3
    # after the flush both globals hold fresh banks again
    assert canon(gt.flush(timestamp=21)) == canon(gj.flush(timestamp=21)) \
        == []


@pytest.mark.parametrize("direction", ["reference_into_port",
                                       "port_into_reference"])
def test_mixed_fleet(direction):
    """One package's local bytes land in the other's global, and the two
    globals fed the same bytes flush the same rows (within contract);
    the merged registers are equal byte for byte."""
    pair = ("tdigest", "hll")
    sender = REF if direction == "reference_into_port" else PORT
    sent, _r, samples, counters, gauges = fleet(sender, pair, 3, 3)
    gt, gj = land(PORT, pair, sent), land(REF, pair, sent)
    for g in (gt, gj):
        g._flush_import_sets()
    regs_t = gt.set_bank.registers.numpy()
    regs_j = np.asarray(gj.set_bank.registers)
    for k in range(3):
        st = gt.set_keys.lookup(tparser.MetricKey(f"s.m{k}", "set", ""), 2)
        sj = gj.set_keys.lookup(jparser.MetricKey(f"s.m{k}", "set", ""), 2)
        np.testing.assert_array_equal(regs_t[st], regs_j[sj])
    check_global_rows(gt.flush(timestamp=5), gj.flush(timestamp=5),
                      samples, counters, gauges, pair)


def test_scope_routing_with_forwarding():
    cfg = dict(forward_enabled=True, aggregates=("min", "max", "count"))
    lines = [b"t.mixed:10|ms", b"t.mixed:20|ms",
             b"t.local:5|ms|#veneurlocalonly",
             b"t.global:9|ms|#veneurglobalonly", b"c.local:1|c",
             b"c.global:4|c|#veneurglobalonly", b"s.mixed:a|s",
             b"g.local:3|g", b"g.global:7|g|#veneurglobalonly",
             b"s.local:b|s|#veneurlocalonly"]
    out = {}
    for pkg in (PORT, REF):
        eng = pkg.engine(**cfg)
        pkg.feed(eng, lines)
        res = eng.flush(timestamp=10)
        m = {x.name: x.value for x in res.metrics}
        assert "t.mixed.min" in m and "t.mixed.50percentile" not in m
        fwd = [k.name for k, *_ in res.export.histograms]
        assert "t.mixed" in fwd and "t.global" in fwd
        assert "t.local" not in fwd and "t.local.50percentile" in m
        assert not any(n.startswith("t.global") for n in m)
        assert m["c.local"] == 1.0 and "c.global" not in m
        assert [k.name for k, _v in res.export.counters] == ["c.global"]
        assert [k.name for k, _v in res.export.gauges] == ["g.global"]
        assert "s.mixed" not in m and m["g.local"] == 3.0
        assert [k.name for k, _r in res.export.sets] == ["s.mixed"]
        assert "s.local" in m
        out[pkg.name] = (sorted(m), fwd, res.export.counters[0][1],
                         res.export.gauges[0][1])
    assert out["torch"] == out["jax"]


def _big_digest_import(pkg, n, seed, name):
    rng = np.random.default_rng(seed)
    data = rng.gamma(4.0, 25.0, n).astype(np.float32)
    glob = pkg.engine(is_global=True, percentiles=(0.5, 0.99))
    glob.import_histogram(
        pkg.key(name, "timer"), data, np.ones(n, np.float32),
        float(data.min()), float(data.max()), float(data.sum()),
        float(n), float((1.0 / data).sum()))
    return data, rows(glob.flush(timestamp=10))


def _check_big(data, out, name, tol):
    assert out[(name + ".count", ())].value == len(data)
    spread = data.max() - data.min()
    for q, v in zip((0.5, 0.99), np.quantile(data, [0.5, 0.99])):
        got = out[(f"{name}.{q * 100:g}percentile", ())].value
        assert abs(got - v) < tol * spread


def test_import_oversized_digest_is_bounded_and_accurate(monkeypatch):
    """A forwarded digest wider than the import cap is clustered in
    bounded chunks (cluster_rows never sees a row wider than the cap)
    and still merges to accurate percentiles, as in the reference."""
    widths = []
    real = ttd.cluster_rows

    def spy(values, weights, *a, **kw):
        widths.append(values.shape[1])
        return real(values, weights, *a, **kw)

    monkeypatch.setattr(ttd, "cluster_rows", spy)
    n = 3 * tpipe._IMPORT_W_CAP + 1234
    data, out_t = _big_digest_import(PORT, n, 7, "big.lat")
    _d, out_j = _big_digest_import(REF, n, 7, "big.lat")
    assert max(widths) <= tpipe._IMPORT_W_CAP and len(widths) >= 2
    for out in (out_t, out_j):
        _check_big(data, out, "big.lat", 0.01)
    assert sorted(out_t) == sorted(out_j)


def test_import_rechunk_trusted_passes_use_sorted_prefix(monkeypatch):
    """Past the first pass, the re-chunking re-clusters its own outputs
    pile-aligned through sorted_prefix=C; both arms run, and the landed
    state stays exact on count and accurate on quantiles (as the
    reference's, with the same cap)."""
    prefixes = []
    real = ttd.cluster_rows

    def spy(values, weights, *a, sorted_prefix=0, **kw):
        prefixes.append(sorted_prefix)
        return real(values, weights, *a, sorted_prefix=sorted_prefix, **kw)

    monkeypatch.setattr(ttd, "cluster_rows", spy)
    monkeypatch.setattr(tpipe, "_IMPORT_W_CAP", 1)   # cap floors at 2*C
    monkeypatch.setattr(jpipe, "_IMPORT_W_CAP", 1)
    data, out_t = _big_digest_import(PORT, 2600, 13, "deep.lat")
    _d, out_j = _big_digest_import(REF, 2600, 13, "deep.lat")
    C = ttd.init(1, 100.0, 128, device="cpu").num_centroids
    assert 0 in prefixes and C in prefixes
    for out in (out_t, out_j):
        _check_big(data, out, "deep.lat", 0.015)


def test_import_path_folds_over_budget_keys():
    """An over-budget forwarded key's aggregate lands in the prefix's
    `__other__` key through the same merge, in both packages."""
    outs = {}
    for pkg, adm_mod, obs in ((PORT, tadm, observe), (REF, jadm, jobserve)):
        eng = pkg.engine(histogram_slots=256, counter_slots=128,
                         gauge_slots=64, set_slots=32, percentiles=(0.5,),
                         aggregates=("count",))
        reg = obs.TelemetryRegistry()
        eng.attach_admission(adm_mod.AdmissionController(
            registry=reg, max_keys_per_prefix=2))
        for k in range(10):
            eng.import_counter(pkg.key(f"imp.c{k}", "counter"),
                               float(k + 1))
        for k in range(4):
            eng.import_histogram(pkg.key(f"imp.h{k}", "timer"),
                                 [1.0 * k, 2.0 * k], [1.0, 1.0],
                                 0.0, 2.0 * k, 3.0 * k, 2.0, 0.0)
        by_name = {m.name: m.value for m in eng.flush(timestamp=1).metrics}
        assert by_name["imp.c0"] == 1.0 and by_name["imp.c1"] == 2.0
        assert by_name["imp.__other__"] == 52.0
        assert by_name["imp.__other__.count"] == 8.0
        assert not any(n.startswith("imp.c2") for n in by_name)
        assert reg.total(obs.SERVER_SCOPE, "overload.folded_samples") == 12
        outs[pkg.name] = by_name
    assert outs["torch"] == outs["jax"]


# ---- delta exports (the engine-level cases of the reference) ----

def _touch_counter(pkg, eng, name, v):
    s = eng.counter_keys.lookup(pkg.key(name, "counter"),
                                pkg.parser.GLOBAL_ONLY)
    eng.ingest_counter_batch(np.full(1, s, np.int32),
                             np.full(1, v, np.float32),
                             np.ones(1, np.float32), count=1)


def _touch_set(pkg, eng, name, vals):
    for v in vals:
        eng.process(pkg.parser.UDPMetric(pkg.key(name, "set"), 0, v, 1.0, 0))


def _delta_engine(pkg, inc=True):
    kw = dict(histogram_slots=64, counter_slots=64, gauge_slots=64,
              set_slots=16, batch_size=256, buffer_depth=32,
              forward_enabled=True, flush_incremental=inc)
    if pkg is REF:
        kw["flush_double_buffer"] = inc
    return pkg.engine(**kw)


def _export_view(res):
    e = res.export
    return (e.kind, [(k.name, v) for k, v in e.counters],
            [(k.name, bytes(r)) for k, r in e.sets], res.stats["forward_kind"])


def test_delta_export_ships_only_touched_counters_and_sets():
    views = {}
    for pkg in (PORT, REF):
        eng = _delta_engine(pkg)
        _touch_counter(pkg, eng, "d.a", 2.0)
        _touch_counter(pkg, eng, "d.b", 3.0)
        _touch_set(pkg, eng, "d.s1", ["u1", "u2"])
        _touch_set(pkg, eng, "d.s2", ["u3"])
        res = eng.flush(timestamp=100, forward_kind="full")
        assert res.export.kind == "full"
        assert sorted(k.name for k, _v in res.export.counters) == \
            ["d.a", "d.b"]
        _touch_counter(pkg, eng, "d.a", 5.0)
        _touch_set(pkg, eng, "d.s1", ["u9"])
        res2 = eng.flush(timestamp=101, forward_kind="delta")
        assert res2.export.kind == "delta"
        assert [k.name for k, _v in res2.export.counters] == ["d.a"]
        assert [k.name for k, _r in res2.export.sets] == ["d.s1"]
        assert res2.stats["forward_kind"] == "delta"
        _touch_counter(pkg, eng, "d.a", 1.0)
        res3 = eng.flush(timestamp=102, forward_kind="full")
        assert sorted(k.name for k, _v in res3.export.counters) == \
            ["d.a", "d.b"]
        assert {k.name: v for k, v in res3.export.counters}["d.b"] == 0.0
        assert sorted(k.name for k, _r in res3.export.sets) == \
            ["d.s1", "d.s2"]
        views[pkg.name] = [_export_view(r) for r in (res, res2, res3)]
    assert views["torch"] == views["jax"]


def test_delta_request_degrades_to_full_without_dirty_tracking():
    for pkg in (PORT, REF):
        eng = _delta_engine(pkg, inc=False)
        _touch_counter(pkg, eng, "d.a", 2.0)
        res = eng.flush(timestamp=100, forward_kind="delta")
        assert res.export.kind == "full"
        assert res.stats["forward_kind"] == "full"
        # a non-forwarding engine builds a full (empty) export either way
        plain = pkg.engine()
        assert plain.flush(forward_kind="delta").stats["forward_kind"] == \
            "full"


def test_full_resync_fills_the_wire_never_the_local_frame():
    views = {}
    for pkg in (PORT, REF):
        eng = _delta_engine(pkg)
        s = eng.counter_keys.lookup(pkg.key("d.mixed", "counter"), 0)
        eng.ingest_counter_batch(np.full(1, s, np.int32),
                                 np.full(1, 4.0, np.float32),
                                 np.ones(1, np.float32), count=1)
        _touch_counter(pkg, eng, "d.glob", 2.0)
        res1 = eng.flush(timestamp=100, forward_kind="full")
        assert [m.name for m in res1.metrics] == ["d.mixed"]
        assert [(k.name, v) for k, v in res1.export.counters] == \
            [("d.glob", 2.0)]
        res2 = eng.flush(timestamp=101, forward_kind="delta")
        assert res2.export.counters == [] and res2.metrics == []
        res3 = eng.flush(timestamp=102, forward_kind="full")
        assert [(k.name, v) for k, v in res3.export.counters] == \
            [("d.glob", 0.0)]
        assert res3.metrics == []
        views[pkg.name] = [_export_view(r) for r in (res1, res2, res3)]
    assert views["torch"] == views["jax"]


# ---- the incremental flush on the forwarding and global builds ----

def _forwarding_run(inc):
    rng = np.random.default_rng(11)
    eng = PORT.engine(forward_enabled=True, flush_incremental=inc,
                      histogram_slots=512)
    out = []
    for interval in range(3):
        lines = local_lines(interval, rng, {}) if interval != 1 else []
        PORT.feed(eng, lines)
        res = eng.flush(timestamp=interval)
        out.append((canon(res), PORT.send(res), res.stats["flush_path"]))
    return out


def test_incremental_flush_bit_identical_on_forwarding_build():
    inc, full = _forwarding_run(True), _forwarding_run(False)
    assert any(len(received(b)) for _c, b, _p in inc)
    for (ci, bi, pi), (cf, bf, pf) in zip(inc, full):
        assert pi["path"] == "incremental" and pf["path"] == "full"
        assert ci == cf and bi == bf


def _stage_imports(eng, rng):
    for k in range(40):
        means = np.sort(rng.normal(100, 9, 16).astype(np.float32))
        eng.import_histogram(tparser.MetricKey(f"i.h{k}", "timer", ""),
                             means, np.ones(16, np.float32),
                             float(means.min()), float(means.max()),
                             float(means.sum()), 16.0, 0.2)
    for k in range(10):
        eng.import_counter(tparser.MetricKey(f"i.c{k}", "counter", ""), 2.5)
    for k in range(4):
        eng.import_gauge(tparser.MetricKey(f"i.g{k}", "gauge", ""), 1.5)
    regs = rng.integers(0, 20, 1 << 14).astype(np.uint8)
    eng.import_set(tparser.MetricKey("i.s", "set", ""), regs, "hll")


def test_import_path_bit_identical_and_landed_outside_lock():
    """Staged imports retire with the banks at the swap and land in the
    retired banks outside the lock: the flush equals the one that lands
    them in the live banks first, with the incremental flush on and
    off, and the locked window holds no landing."""
    def run(inc, land_first):
        eng = PORT.engine(is_global=True, flush_incremental=inc)
        _stage_imports(eng, np.random.default_rng(3))
        if land_first:
            with eng.lock:
                eng._flush_import_centroids()
                eng._flush_import_sets()
                cb, gb, eng._gauge_seq = eng._land_import_scalars(
                    eng.counter_bank, eng.gauge_bank,
                    eng._import_counter_acc, eng._import_gauge_acc,
                    eng._dirty, eng._gauge_seq)
                eng.counter_bank, eng.gauge_bank = cb, gb
                eng._import_counter_acc, eng._import_gauge_acc = {}, {}
        res = eng.flush(timestamp=5)
        return canon(res), res

    ref, res = run(True, False)
    assert len(ref) == 40 * 6 + 10 + 4 + 1
    assert res.stats["flush_path"]["path"] == "incremental"
    phases = dict((n, (a, b)) for n, a, b in res.stats["phases"])
    assert phases["swap"][1] <= phases["drain"][0]
    assert run(False, False)[0] == ref
    assert run(True, True)[0] == ref
    assert run(False, True)[0] == ref


def test_req_ull_direct_import_matches_reference():
    """REQ + ULL: forwarded items re-insert through the compactor (the
    "direct" strategy) and registers join by the lattice join; the merged
    registers equal the reference's byte for byte."""
    pair = ("req", "ull")
    sent, _r, samples, counters, gauges = fleet(PORT, pair, 2, 5)
    gt, gj = land(PORT, pair, sent), land(REF, pair, sent)
    gt._flush_import_sets()
    gj._flush_import_sets()
    for k in range(3):
        st = gt.set_keys.lookup(tparser.MetricKey(f"s.m{k}", "set", ""), 2)
        sj = gj.set_keys.lookup(jparser.MetricKey(f"s.m{k}", "set", ""), 2)
        np.testing.assert_array_equal(
            gt.set_bank.registers[st].numpy(),
            np.asarray(gj.set_bank.registers[sj]))
    res_t, res_j = gt.flush(timestamp=3), gj.flush(timestamp=3)
    rt, rj = rows(res_t), rows(res_j)
    assert sorted(rt) == sorted(rj)
    for key, m in rt.items():
        if key[0].endswith("percentile"):
            assert m.value == pytest.approx(rj[key].value, rel=1e-4), key
        else:
            assert m.value == rj[key].value, key
    for name, total in counters.items():
        assert rt[(name, ())].value == total


# ---- the ops of the import landing, against the reference ----

@pytest.mark.parametrize("prefix", ["full_sort", "sorted_prefix"])
def test_cluster_rows_matches_reference(prefix):
    rng = np.random.default_rng(4)
    S, M, C = 48, 512, 256
    v = rng.gamma(3, 20, (S, M)).astype(np.float32)
    w = np.where(rng.random((S, M)) < 0.8,
                 rng.integers(1, 5, (S, M)), 0).astype(np.float32)
    v[0, :10] = -0.0
    v[1, :40] = v[1, 0]
    w[2] = 0.0
    sp = 0
    if prefix == "sorted_prefix":
        head_m, head_w = jtd.cluster_rows(v[:, :C], w[:, :C],
                                          compression=100.0,
                                          num_centroids=C)
        v[:, :C], w[:, :C] = np.asarray(head_m), np.asarray(head_w)
        sp = C
    jm, jw = jtd.cluster_rows(v, w, compression=100.0, num_centroids=C,
                              sorted_prefix=sp)
    tm, tw = ttd.cluster_rows(torch.tensor(v), torch.tensor(w), 100.0, C,
                              sorted_prefix=sp)
    jm, jw = np.asarray(jm), np.asarray(jw)
    tm, tw = tm.numpy(), tw.numpy()
    np.testing.assert_array_equal(tw.sum(1), jw.sum(1))
    for r in range(S):
        if not w[r].any():
            assert not tw[r].any() and not tm[r].any()
            continue
        live = w[r] > 0
        spread = v[r][live].max() - v[r][live].min()
        qs = [0.05, 0.5, 0.95]
        np.testing.assert_allclose(
            point_quantiles(tm[r][tw[r] > 0], tw[r][tw[r] > 0], qs),
            point_quantiles(jm[r][jw[r] > 0], jw[r][jw[r] > 0], qs),
            atol=0.01 * spread + 1e-6)
        pos = tm[r][tw[r] > 0]
        assert (np.diff(pos) >= 0).all()
        assert (tw[r][len(pos):] == 0).all()
    if sp:
        fm, fw = ttd.cluster_rows(torch.tensor(v), torch.tensor(w), 100.0,
                                  C, sorted_prefix=0)
        np.testing.assert_array_equal(fm.numpy(), tm)
        np.testing.assert_array_equal(fw.numpy(), tw)


def _filled_banks(engine, rng):
    banks = []
    for _ in range(2):
        bank = engine.init(16, "cpu")
        n = 600
        slots = torch.tensor(rng.integers(-1, 16, n), dtype=torch.int32)
        if hasattr(bank, "registers"):
            idx, val = engine.host_hash_to_updates(
                rng.integers(0, 2 ** 64, n, dtype=np.uint64))
            bank = engine.insert(bank, slots, torch.tensor(idx),
                                 torch.tensor(val))
        else:
            vals = torch.tensor(rng.gamma(2, 30, n).astype(np.float32))
            vals[:7] = -0.0
            bank = engine.add_batch(bank, slots, vals, torch.ones(n))
        banks.append(bank)
    return banks


@pytest.mark.parametrize("engine_id", ["tdigest", "req", "hll", "ull"])
def test_merge_banks_is_bit_commutative(engine_id):
    from veneur_tpu_torch import sketches
    cfg = tpipe.EngineConfig(histogram_backend="req" if engine_id == "req"
                             else "tdigest",
                             set_backend="ull" if engine_id == "ull"
                             else "hll", req_capacity=64, hll_precision=10,
                             ull_precision=10, buffer_depth=32)
    engine = (sketches.set_engine(cfg) if engine_id in ("hll", "ull")
              else sketches.histogram_engine(cfg))
    a, b = _filled_banks(engine, np.random.default_rng(8))
    ab, ba = engine.merge_banks(a, b), engine.merge_banks(b, a)
    for name, x in ab._asdict().items():
        y = getattr(ba, name)
        assert torch.equal(x.view(torch.uint8) if x.is_floating_point()
                           else x, y.view(torch.uint8)
                           if y.is_floating_point() else y), name
    if engine_id in ("hll", "ull"):
        ref = (jhll.merge_banks(jhll.HLLBank(a.registers.numpy()),
                                jhll.HLLBank(b.registers.numpy()))
               if engine_id == "hll" else None)
        want = (np.asarray(ref.registers) if ref is not None else
                engine.merge_registers_np(a.registers.numpy(),
                                          b.registers.numpy()))
        np.testing.assert_array_equal(ab.registers.numpy(), want)
    else:
        assert torch.equal(ab.count, a.count + b.count)


def test_import_merge_ops_match_reference():
    """counter_merge, the HLL row merge and the ULL row join against the
    reference's on the same inputs: exact."""
    from veneur_tpu.sketches import ull as jull
    from veneur_tpu_torch.sketches import ull as tull
    rng = np.random.default_rng(6)
    K = 16
    slots = rng.integers(-1, K, 40).astype(np.int32)
    uslots = np.unique(slots[slots >= 0]).astype(np.int32)
    vals = rng.integers(-1000, 1000, uslots.size).astype(np.float64)
    jc = jscalar.counter_merge(jscalar.init_counters(K), uslots,
                               vals.astype(np.float32))
    tc = tscalar.counter_merge(tscalar.init_counters(K, "cpu"),
                               torch.tensor(uslots), torch.tensor(vals))
    np.testing.assert_array_equal(tc.hi.numpy(), np.asarray(jc.hi))
    np.testing.assert_array_equal(tc.lo.numpy(), np.asarray(jc.lo))
    regs = rng.integers(0, 64, (40, 256)).astype(np.uint8)
    base = rng.integers(0, 64, (K, 256)).astype(np.uint8)
    jh = jhll.merge_rows(jhll.HLLBank(base.copy()), slots, regs)
    th = thll.merge_rows(thll.HLLBank(torch.tensor(base)),
                         torch.tensor(slots), torch.tensor(regs))
    np.testing.assert_array_equal(th.registers.numpy(),
                                  np.asarray(jh.registers))
    uregs = rng.integers(0, 256, (40, 256)).astype(np.uint8)
    ju = jull._merge_rows_impl(jull.ULLBank(jnp.asarray(base)), slots, uregs)
    tu = tull._merge_rows_impl(tull.ULLBank(torch.tensor(base)),
                               torch.tensor(slots), torch.tensor(uregs))
    np.testing.assert_array_equal(tu.registers.numpy(),
                                  np.asarray(ju.registers))


def test_import_list_watermark_rejects_and_gauge_order():
    """import_list applies a whole op under one lock hold: a bad metric
    rejects itself, the watermark never moves back, the flush reports it
    as retired_import_op, and an imported gauge outranks the interval's
    ingested write. Same outcome in both packages."""
    outs = {}
    for pkg in (PORT, REF):
        eng = pkg.engine(is_global=True)
        pkg.feed(eng, [b"g.x:1|g"])
        good = pkg.wire.export_to_metrics(pkg.pipe.ForwardExport(
            counters=[(pkg.key("c", "counter"), 3.0)],
            gauges=[(pkg.key("g.x", "gauge"), 5.0)]))
        bad = pkg.wire.export_to_metrics(pkg.pipe.ForwardExport(
            set_engine="ull",
            sets=[(pkg.key("s", "set"), np.zeros(1 << 14, np.uint8))]))
        rerouted, rejected = eng.import_list(5, good + bad)
        assert rerouted == [] and len(rejected) == 1
        assert "engine mismatch" in str(rejected[0][1])
        eng.import_list(3, good)
        assert eng.last_import_op == 5
        with pytest.raises(ValueError, match="width"):
            eng.import_set(pkg.key("s", "set"), np.zeros(16, np.uint8))
        res = eng.flush(timestamp=1)
        assert res.stats["retired_import_op"] == 5
        outs[pkg.name] = sorted((m.name, m.value) for m in res.metrics)
    assert outs["torch"] == outs["jax"] == [("c", 6.0), ("g.x", 5.0)]
