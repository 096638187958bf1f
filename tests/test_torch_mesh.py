"""veneur_tpu_torch's multi-device engine (parallel/) against the JAX
package's on the CPU, at the same ("dp", "shard") grid: the reference
runs on the 8 virtual XLA host devices tests/conftest.py pins, the port
on eight "cpu" entries of one device list (a device may stand in the
grid more than once, as one card holds a whole grid).

Contract levels, port against reference:
  * exact: `route_batch`'s output bytes; histogram count, min and max;
    counter totals (f64(hi) + f64(lo)); gauge values and sequences;
    metric names and tags;
  * t-digest quantiles within 1% of each key's spread (max - min);
  * HLL estimates within rtol 1e-5 (JAX's exp2 is inexact for integer
    exponents >= 13);
  * sums within rtol 1e-6 and hmean within the JAX package's own test
    bounds (float64 batch sums in the port, float32 in JAX).
The port's mesh engine also flushes the rows of the port's single-device
engine fed the same stream, under the same contract.
"""

import types

import numpy as np
import pytest

from veneur_tpu.ingest import parser as jparser
from veneur_tpu.ingest.parser import MetricKey as JMetricKey
from veneur_tpu.models.pipeline import EngineConfig as JEngineConfig
from veneur_tpu.ops import hll as jhll
from veneur_tpu.parallel import mesh as jmesh
from veneur_tpu.parallel.engine import (
    MeshAggregationEngine as JMeshAggregationEngine)
from veneur_tpu.utils import hashing as jhashing
from veneur_tpu_torch.ingest import parser as tparser
from veneur_tpu_torch.ingest.parser import MetricKey as TMetricKey
from veneur_tpu_torch.models.pipeline import AggregationEngine
from veneur_tpu_torch.models.pipeline import EngineConfig as TEngineConfig
from veneur_tpu_torch.parallel import mesh as tmesh
from veneur_tpu_torch.parallel.engine import MeshAggregationEngine

CPUS = ["cpu"] * 8
MESH_KW = dict(histogram_slots=64, counter_slots=32, gauge_slots=32,
               set_slots=8, buf_size=64, hll_precision=12,
               percentiles=(0.5, 0.9))


def _engines(n_dp=2, n_shard=4, **kw):
    args = {**MESH_KW, **kw}
    return (jmesh.MeshEngine(jmesh.make_mesh(n_dp, n_shard), **args),
            tmesh.MeshEngine(tmesh.make_mesh(n_dp, n_shard, devices=CPUS),
                             **args))


def _empty_batches(eng, n=64):
    shape = (eng.D, eng.S * n)

    def z(dt, fill):
        return np.full(shape, fill, dt)
    return dict(
        h_slots=z(np.int32, -1), h_vals=z(np.float32, 0),
        h_wts=z(np.float32, 0), c_slots=z(np.int32, -1),
        c_vals=z(np.float32, 0), c_wts=z(np.float32, 0),
        g_slots=z(np.int32, -1), g_vals=z(np.float32, 0),
        g_seqs=z(np.int32, 0), s_slots=z(np.int32, -1),
        s_idx=z(np.int32, 0), s_rho=z(np.uint8, 0))


def _assert_merged_agree(j, t, spreads):
    """flush_merged outputs under the contract; `spreads` maps each live
    histogram slot to its samples' max - min."""
    for k in ("count", "min", "max"):
        np.testing.assert_array_equal(t["agg"][k], j["agg"][k], err_msg=k)
    assert t["quantiles"].shape == j["quantiles"].shape
    for g, spread in spreads.items():
        np.testing.assert_allclose(t["quantiles"][g], j["quantiles"][g],
                                   rtol=0, atol=0.01 * spread + 1e-6,
                                   err_msg=f"slot {g}")
    cold = np.ones(len(t["quantiles"]), bool)
    cold[list(spreads)] = False
    np.testing.assert_array_equal(t["quantiles"][cold], j["quantiles"][cold])
    np.testing.assert_array_equal(
        t["c_hi"].astype(np.float64) + t["c_lo"],
        np.asarray(j["c_hi"], np.float64) + j["c_lo"])
    np.testing.assert_array_equal(t["gauge_seq"], j["gauge_seq"])
    np.testing.assert_array_equal(t["gauge_val"], j["gauge_val"])
    np.testing.assert_allclose(t["set_est"], j["set_est"], rtol=1e-5)


@pytest.mark.parametrize("seed,n_dp,n_shard,n,dp_row,fill", [
    (0, 1, 4, 16, 0, 0.0), (1, 2, 4, 8, 1, 0.0), (2, 2, 4, 64, 0, 0.0),
    (3, 1, 8, 4, 0, -1.5), (4, 4, 2, 3, 3, 0.0), (5, 1, 1, 32, 0, 0.0)])
def test_route_batch_is_byte_exact(seed, n_dp, n_shard, n, dp_row, fill):
    """The port's route_batch returns the reference's arrays byte for
    byte, overflow counts included (segments too small for some shards'
    samples in most cases), for f32, i32 and u8 payloads."""
    rng = np.random.default_rng(seed)
    per_shard = 16
    K = per_shard * n_shard
    slots = rng.integers(-1, K, 200).astype(np.int32)
    vals = rng.normal(0, 10, 200).astype(np.float32)
    seqs = rng.integers(0, 1 << 30, 200).astype(np.int32)
    rho = rng.integers(0, 50, 200).astype(np.uint8)
    kw = dict(slots_per_shard=per_shard, n_per_segment=n, dp_row=dp_row,
              fill=fill)
    grid = types.SimpleNamespace(D=n_dp, S=n_shard)
    want = jmesh.MeshEngine.route_batch(grid, slots, vals, seqs, rho, **kw)
    got = tmesh.MeshEngine.route_batch(grid, slots, vals, seqs, rho, **kw)
    assert len(got) == len(want) == 5
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert got[-1] == want[-1]
    if n * n_shard < 150:
        assert got[-1] > 0


def test_dp_merge_reproduces_union():
    """Two dp replicas each ingest part of the samples of the same global
    slots; the merged flush (the replicas' centroids gathered and
    reclustered at B = D*C) agrees with the reference's."""
    jeng, teng = _engines()
    rng = np.random.default_rng(0)
    n = 64
    K, S = teng.histogram_slots, teng.S
    per_shard = K // S
    data = {}
    batches = _empty_batches(teng, n)
    for d in range(2):
        for s in range(S):
            gslots = rng.integers(0, K, n)
            owned = gslots[gslots // per_shard == s]
            vals = rng.normal(loc=owned.astype(np.float32), scale=0.1)
            k = len(owned)
            base = s * n
            batches["h_slots"][d, base:base + k] = owned % per_shard
            batches["h_vals"][d, base:base + k] = vals
            batches["h_wts"][d, base:base + k] = 1.0
            for g, v in zip(owned, vals.astype(np.float32)):
                data.setdefault(int(g), []).append(float(v))
    jeng.ingest(**batches)
    teng.ingest(**batches)
    j, t = jeng.flush_merged(), teng.flush_merged()
    assert t["quantiles"].shape == (K, 2)
    spreads = {g: max(v) - min(v) for g, v in data.items()}
    _assert_merged_agree(j, t, spreads)
    for g, vals in data.items():
        assert t["agg"]["count"][g] == len(vals)
        assert t["agg"]["min"][g] == np.float32(min(vals))
        assert t["agg"]["max"][g] == np.float32(max(vals))


def test_counters_psum_and_gauges_lww():
    """Counters add over dp, the gauge with the larger sequence wins over
    dp, and the flush resets the state (the gauge seq sentinel back at
    -1), as in the reference."""
    jeng, teng = _engines()
    b = _empty_batches(teng)
    n = b["g_slots"].shape[1] // teng.S
    for d, v in ((0, 3.0), (1, 4.0)):
        b["c_slots"][d, 0] = 5
        b["c_vals"][d, 0] = v
        b["c_wts"][d, 0] = 1.0
    for d, v, q in ((0, 111.0, 1), (1, 222.0, 7)):
        b["g_slots"][d, n] = 9 - 8
        b["g_vals"][d, n] = v
        b["g_seqs"][d, n] = q
    jeng.ingest(**b)
    teng.ingest(**b)
    j, t = jeng.flush_merged(), teng.flush_merged()
    _assert_merged_agree(j, t, {})
    assert t["counters"][5] == 7.0
    assert t["gauge_val"][9] == 222.0 and t["gauge_seq"][9] == 7
    assert t["gauge_seq"][0] == -1 and t["gauge_val"][0] == -np.inf
    j2, t2 = jeng.flush_merged(), teng.flush_merged()
    _assert_merged_agree(j2, t2, {})
    assert t2["counters"][5] == 0.0 and t2["agg"]["count"].sum() == 0.0
    assert (t2["gauge_seq"] == -1).all()


def test_hll_union_across_dp():
    """Overlapping member sets on the two dp rows of one set slot: the
    register max over dp estimates the union, as the reference's does."""
    jeng, teng = _engines(set_slots=8)
    b = _empty_batches(teng, n=512)
    per_shard = teng.set_slots // teng.S
    n = b["s_slots"].shape[1] // teng.S
    members = {0: [f"m-{i}" for i in range(300)],
               1: [f"m-{i}" for i in range(150, 450)]}
    for d, ms in members.items():
        hashes = np.array([jhashing.set_member_hash(m) for m in ms],
                          np.uint64)
        idx, rho = jhll.host_hash_to_updates(hashes, teng.hll_precision)
        k = len(ms)
        b["s_slots"][d, n:n + k] = 3 - per_shard
        b["s_idx"][d, n:n + k] = idx
        b["s_rho"][d, n:n + k] = rho
    jeng.ingest(**b)
    teng.ingest(**b)
    j, t = jeng.flush_merged(), teng.flush_merged()
    _assert_merged_agree(j, t, {})
    assert t["set_est"][3] == pytest.approx(450, rel=0.1)


def test_route_batch_helper():
    """The reference's route_batch example: local ids in each owner's
    segment, and the port's arrays equal the reference's."""
    jeng, teng = _engines(n_dp=1, n_shard=4)
    slots = np.array([0, 17, 33, 49, 1, -1], np.int32)
    vals = np.array([1., 2., 3., 4., 5., 6.], np.float32)
    per_shard = teng.histogram_slots // teng.S
    kw = dict(slots_per_shard=per_shard, n_per_segment=4)
    rs, rv, overflow = teng.route_batch(slots, vals, **kw)
    js, jv, joverflow = jeng.route_batch(slots, vals, **kw)
    assert rs.shape == (1, 16) and overflow == joverflow == 0
    assert rs.tobytes() == js.tobytes() and rv.tobytes() == jv.tobytes()
    seg0 = rs[0, :4]
    assert set(seg0[seg0 >= 0].tolist()) == {0, 1}
    assert 1 in rs[0, 4:8].tolist() and 1 in rs[0, 12:16].tolist()


def test_make_mesh_grids_and_refusals():
    """make_mesh cuts a device list (repeats allowed) into the grid;
    shard_devices maps logical shards onto devices; slot counts must
    divide the shard axis; without a card the default device list
    raises."""
    import torch
    m = tmesh.make_mesh(2, devices=CPUS)
    assert m.shape == {"dp": 2, "shard": 4}
    assert m.distinct() == [torch.device("cpu")]
    assert tmesh.shard_devices("cpu", 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="grid"):
        tmesh.make_mesh(2, 8, devices=CPUS)
    with pytest.raises(ValueError, match="divide"):
        tmesh.MeshEngine(m, histogram_slots=10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(1, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.shard_devices("cuda", 2)


# ---------------------------------------------------------------- engine

ENG_CFG = dict(histogram_slots=64, counter_slots=32, gauge_slots=32,
               set_slots=16, buffer_depth=32, batch_size=256,
               percentiles=(0.5, 0.9), aggregates=("min", "max", "count"))


def _engine_pair(**kw):
    cfg = {**ENG_CFG, **kw}
    j = JMeshAggregationEngine(JEngineConfig(**cfg), n_devices=8)
    t = MeshAggregationEngine(TEngineConfig(**cfg), devices=CPUS)
    j.warmup()
    t.warmup()
    return j, t


def _rows(res):
    return {(m.name, tuple(m.tags)): m.value for m in res.metrics}


def _assert_rows_agree(j, t, spreads, sets=(), rtol_sum=1e-6, rtol_hm=0.0):
    """Port rows against reference rows: same keys; percentiles within 1%
    of the key's spread; set rows rtol 1e-5; sums and hmeans within the
    given rtol; every other row exact."""
    assert t.keys() == j.keys()
    for k, want in j.items():
        name = k[0]
        base = name.rsplit(".", 1)[0]
        if name.endswith("percentile"):
            assert abs(t[k] - want) <= 0.01 * spreads[base] + 1e-6, k
        elif name in sets:
            assert t[k] == pytest.approx(want, rel=1e-5), k
        elif name.endswith(".sum"):
            assert t[k] == pytest.approx(want, rel=rtol_sum), k
        elif name.endswith(".hmean"):
            assert t[k] == pytest.approx(want, rel=rtol_hm), k
        else:
            assert t[k] == want, k


def _feed_lines(engines, lines):
    for eng, parse in engines:
        for ln in lines:
            eng.process(parse(ln))


def test_mesh_engine_unit_all_types():
    """Every bank type over many slots, so samples land on every shard
    column; then an empty interval."""
    j, t = _engine_pair()
    single = AggregationEngine(TEngineConfig(**ENG_CFG), device="cpu")
    rng = np.random.default_rng(3)
    lines, spreads = [], {}
    for k in range(16):
        v = np.round(rng.gamma(2.0, 20.0, 40), 4)
        spreads[f"t{k}"] = float(v.max() - v.min())
        lines += [f"t{k}:{x:.4f}|ms".encode() for x in v]
    lines += [b"c:2|c|@0.5"] * 5 + [b"g:1|g", b"g:9|g"]
    lines += [f"s:m{i % 23}|s".encode() for i in range(200)]
    _feed_lines(((j, jparser.parse_packet), (t, tparser.parse_packet),
                 (single, tparser.parse_packet)), lines)
    jr = _rows(j.flush(timestamp=7))
    res = t.flush(timestamp=7)
    tr = _rows(res)
    _assert_rows_agree(jr, tr, spreads, sets=("s",))
    # the port's mesh against the port's single-device engine
    _assert_rows_agree(tr, _rows(single.flush(timestamp=7)), spreads,
                       sets=("s",))
    assert tr[("c", ())] == 20.0 and tr[("g", ())] == 9.0
    assert res.stats["flush_path"] == {"path": "full"}
    assert [p[0] for p in res.stats["phases"]][:1] == ["drain"]
    assert len(t.flush(timestamp=8).metrics) == 0
    assert len(j.flush(timestamp=8).metrics) == 0


def test_mesh_engine_rejects_what_the_reference_rejects():
    """Forwarding, a non-default backend and the f16 fetch raise the
    reference's ValueError, before any bank is made."""
    for kw in ({"forward_enabled": True}, {"set_backend": "ull"},
               {"histogram_backend": "req"}, {"flush_fetch_f16": True}):
        with pytest.raises(ValueError):
            JMeshAggregationEngine(JEngineConfig(**ENG_CFG, **kw),
                                   n_devices=8)
        with pytest.raises(ValueError):
            MeshAggregationEngine(TEngineConfig(**ENG_CFG, **kw),
                                  devices=CPUS)


def test_mesh_hot_slot_batch():
    """A batch overfilling one slot's buffer takes the host pre-cluster
    sidestep (keep_extremes) on both packages' mesh paths: count, min and
    max exact, the sum within rtol 1e-6, quantiles within 1% of the
    spread of the reference's."""
    kw = dict(buffer_depth=64, batch_size=4096, percentiles=(0.5, 0.99),
              aggregates=("min", "max", "count", "sum"))
    j, t = _engine_pair(**kw)
    rng = np.random.default_rng(5)
    hv = rng.gamma(2.0, 20.0, 4096).astype(np.float32)
    slots = {}
    for eng, mk in ((j, JMetricKey), (t, TMetricKey)):
        hot = eng.histo_keys.lookup(mk("hot", "timer", ""), 0)
        cold = eng.histo_keys.lookup(mk("cold", "timer", ""), 0)
        s = np.full(4096, hot, np.int32)
        s[::8] = cold
        eng.ingest_histo_batch(s, hv, np.ones(4096, np.float32))
        slots[id(eng)] = (s, hot, cold)
    s, hot, cold = slots[id(t)]
    spreads = {n: float(hv[s == sl].max() - hv[s == sl].min())
               for n, sl in (("hot", hot), ("cold", cold))}
    tr = _rows(t.flush(timestamp=3))
    _assert_rows_agree(_rows(j.flush(timestamp=3)), tr, spreads)
    hot_vals = hv[s == hot].astype(np.float64)
    assert tr[("hot.count", ())] == float(len(hot_vals))
    assert tr[("hot.min", ())] == float(hot_vals.min())
    assert tr[("hot.max", ())] == float(hot_vals.max())
    assert abs(tr[("hot.sum", ())] - hot_vals.sum()) / hot_vals.sum() < 1e-5


def _set_regs(n_members, precision):
    regs = np.zeros(1 << precision, np.uint8)
    for mem in range(n_members):
        h = jhashing.set_member_hash(f"m{mem}")
        idx, rho = jhll.host_hash_to_updates(np.array([h], np.uint64),
                                             precision)
        regs[idx[0]] = max(regs[idx[0]], rho[0])
    return regs


def test_mesh_global_tier_imports():
    """The mesh engine as the GLOBAL tier: 32 senders' digests, sets,
    counters and gauges, imported into both packages' mesh engines, flush
    the same rows under the contract (sum rtol 1e-6, hmean rtol 1e-4)."""
    kw = dict(buffer_depth=128, batch_size=2048, hll_precision=10,
              percentiles=(0.5, 0.99),
              aggregates=("min", "max", "count", "sum", "hmean"),
              is_global=True)
    j, t = _engine_pair(**kw)
    rng = np.random.default_rng(9)
    n_shards, keys = 32, 8
    all_vals = {k: [] for k in range(keys)}
    for shard in range(n_shards):
        regs = _set_regs(40 * (shard % 4 + 1), 10)
        for k in range(keys):
            vals = rng.gamma(2.0, 20.0, 100).astype(np.float64)
            all_vals[k].append(vals)
            for eng, mk in ((j, JMetricKey), (t, TMetricKey)):
                eng.import_histogram(
                    mk(f"t.{k}", "timer", ""), vals, np.ones(100),
                    float(vals.min()), float(vals.max()),
                    float(vals.sum()), 100.0, float((1.0 / vals).sum()))
        for eng, mk in ((j, JMetricKey), (t, TMetricKey)):
            eng.import_counter(mk("hits", "counter", ""), 2.5)
            eng.import_gauge(mk("g", "gauge", ""), float(shard))
            eng.import_set(mk("u", "set", ""), regs)
    spreads = {f"t.{k}": float(np.ptp(np.concatenate(v)))
               for k, v in all_vals.items()}
    tr = _rows(t.flush(timestamp=4))
    _assert_rows_agree(_rows(j.flush(timestamp=4)), tr, spreads,
                       sets=("u",), rtol_hm=1e-4)
    for k in range(keys):
        union = np.concatenate(all_vals[k])
        assert tr[(f"t.{k}.count", ())] == float(len(union))
        hm = len(union) / (1.0 / union).sum()
        assert abs(tr[(f"t.{k}.hmean", ())] - hm) / hm < 1e-4
    assert tr[("hits", ())] == 2.5 * n_shards
    assert tr[("g", ())] == float(n_shards - 1)
    assert abs(tr[("u", ())] - 160) / 160 < 0.1


def test_mesh_global_tier_adversarial_landing():
    """Digests of odd sizes in shuffled order, import rounds cut at
    random points and live samples of the same keys in between: count
    exact, sum and hmean within the reference's own bounds, the rows
    within the contract of the reference's (hmean rtol 1e-3)."""
    kw = dict(buffer_depth=128, batch_size=2048, percentiles=(0.5, 0.99),
              aggregates=("min", "max", "count", "sum", "hmean"),
              is_global=True)
    j, t = _engine_pair(**kw)
    rng = np.random.default_rng(17)
    keys, n_shards = 6, 12
    expected = {k: [] for k in range(keys)}
    jobs = []
    for _ in range(n_shards):
        for k in range(keys):
            vals = rng.gamma(2.0, 20.0, int(rng.integers(3, 160)))
            jobs.append((k, vals))
            expected[k].append(vals)
    live = []
    for k in range(keys):
        vals = np.round(rng.gamma(2.0, 20.0, int(rng.integers(5, 60))), 4)
        live.append((k, vals))
        expected[k].append(vals)
    rng.shuffle(jobs)
    engines = ((j, JMetricKey, jparser.parse_packet),
               (t, TMetricKey, tparser.parse_packet))
    li = 0
    for k, vals in jobs:
        for eng, mk, _p in engines:
            eng.import_histogram(
                mk(f"t.{k}", "timer", ""), vals, np.ones(len(vals)),
                float(vals.min()), float(vals.max()), float(vals.sum()),
                float(len(vals)), float((1.0 / vals).sum()))
        cut, mix = rng.random(), rng.random()
        for eng, _mk, parse in engines:
            if cut < 0.2:
                with eng.lock:
                    eng._flush_import_centroids()
            if li < len(live) and mix < 0.2:
                k2, lv = live[li]
                for x in lv:
                    eng.process(parse(f"t.{k2}:{x:.4f}|ms".encode()))
        if li < len(live) and mix < 0.2:
            li += 1
    for k2, lv in live[li:]:
        _feed_lines(((j, jparser.parse_packet), (t, tparser.parse_packet)),
                    [f"t.{k2}:{x:.4f}|ms".encode() for x in lv])
    spreads = {f"t.{k}": float(np.ptp(np.concatenate(v)))
               for k, v in expected.items()}
    tr = _rows(t.flush(timestamp=5))
    _assert_rows_agree(_rows(j.flush(timestamp=5)), tr, spreads,
                       rtol_sum=1e-5, rtol_hm=1e-3)
    for k in range(keys):
        union = np.concatenate(expected[k])
        assert tr[(f"t.{k}.count", ())] == float(len(union))
        assert abs(tr[(f"t.{k}.sum", ())] - union.sum()) / union.sum() < 1e-5
        hm = len(union) / (1.0 / union).sum()
        assert abs(tr[(f"t.{k}.hmean", ())] - hm) / hm < 1e-3


def test_mesh_engine_matches_single_device_engine_on_a_stream():
    """The port's mesh engine (2 x 4, both dp rows fed through
    MeshEngine.ingest) against the port's single-device engine fed the
    same stream: counts, min, max, counters and gauges exact; quantiles
    within 1% of the key's spread; set estimates rtol 1e-5 (the same
    registers, reduced in another order)."""
    cfg = TEngineConfig(histogram_slots=256, counter_slots=64,
                        gauge_slots=64, set_slots=16, buffer_depth=32,
                        batch_size=128, percentiles=(0.5, 0.75, 0.99),
                        aggregates=("min", "max", "count"))
    mesh_eng = MeshAggregationEngine(cfg, devices=CPUS, n_dp=2)
    single = AggregationEngine(cfg, device="cpu")
    rng = np.random.default_rng(21)
    hs = np.repeat(np.arange(100, dtype=np.int32), 30)
    hv = rng.lognormal(3, 1, len(hs)).astype(np.float32)
    order = rng.permutation(len(hs))
    hs, hv = hs[order], hv[order]
    names = [f"h{i}" for i in range(100)]
    for eng in (mesh_eng, single):
        for i, n in enumerate(names):
            assert eng.histo_keys.lookup(TMetricKey(n, "timer", ""), 0) == i
    single.ingest_histo_batch(hs, hv, np.ones(len(hs), np.float32))
    me = mesh_eng.me
    per = me.histogram_slots // me.S
    half = len(hs) // 2
    for d, sl in ((0, slice(0, half)), (1, slice(half, None))):
        rs, rv, rw, over = me.route_batch(
            hs[sl], hv[sl], np.ones(len(hv[sl]), np.float32),
            slots_per_shard=per, n_per_segment=len(hs), dp_row=d)
        assert over == 0
        me.ingest(h_slots=rs, h_vals=rv, h_wts=rw)
    spreads = {n: float(np.ptp(hv[hs == i])) for i, n in enumerate(names)}
    _assert_rows_agree(_rows(single.flush(timestamp=1)),
                       _rows(mesh_eng.flush(timestamp=1)), spreads)


def test_mesh_flushes_the_median_the_reference_mesh_cannot():
    """ROADMAP C.16: with the `median` aggregate the reference's mesh
    flush raises ValueError (its merged quantiles lack the median
    column the assembly expects); the port's mesh computes quantile 0.5
    too and flushes the single-device engine's rows."""
    kw = dict(ENG_CFG, aggregates=("min", "max", "count", "median"))
    j = JMeshAggregationEngine(JEngineConfig(**kw), n_devices=8)
    t = MeshAggregationEngine(TEngineConfig(**kw), devices=CPUS)
    single = AggregationEngine(TEngineConfig(**kw), device="cpu")
    lines = [f"t:{i}|ms".encode() for i in range(10)]
    _feed_lines(((j, jparser.parse_packet), (t, tparser.parse_packet),
                 (single, tparser.parse_packet)), lines)
    with pytest.raises(ValueError, match="cols"):
        j.flush(timestamp=1)
    got = _rows(t.flush(timestamp=1))
    assert got == _rows(single.flush(timestamp=1))
    assert got[("t.median", ())] == 4.5


@pytest.mark.parametrize("n,points,keep", [
    (5000, 64, False), (5000, 64, True), (3, 64, True), (300, 3, True),
    (70, 256, True), (1000, 30, True)])
def test_precluster_matches_the_reference(n, points, keep):
    """_precluster_k1, the hot-slot sidestep's host clustering, returns
    the reference's means and weights bit for bit, with and without
    keep_extremes (the mesh's flavour: min and max kept as singletons);
    weights sum to the input's, and keep_extremes keeps the extremes."""
    from veneur_tpu.models import pipeline as jpipe
    from veneur_tpu_torch.models import pipeline as tpipe
    rng = np.random.default_rng(n + points)
    v = rng.gamma(2.0, 20.0, n)
    w = rng.integers(1, 4, n).astype(np.float64)
    got = tpipe._precluster_k1(v, w, points, keep_extremes=keep)
    want = jpipe._precluster_k1(v, w, points, keep_extremes=keep)
    for g, x in zip(got, want):
        assert g.tobytes() == x.tobytes()
    assert got[1].sum() == pytest.approx(w.sum(), rel=1e-12)
    if keep:
        assert got[0][0] == v.min() and got[0][-1] == v.max()
    if not keep:
        base = tpipe._precluster_k1(v, w, points)
        assert all(a.tobytes() == b.tobytes() for a, b in zip(base, got))
