"""The port's native ingest bridge (veneur_tpu_torch/ingest/native.py) on
the CPU: the C++ parser against the port's Python parser, the bridge's
interning and rings, the key views, the pump's landings in a CPU engine,
and the native SSF decoder against the port's span path. Needs g++: the
port builds native/vtpu_ingest.cpp into veneur_tpu_torch/_build/ on first
use.
"""

import os
import random
import re
import socket
import threading
import time

import numpy as np
import pytest

from tests.test_parser import INVALID, VALID  # the shared corpus
from veneur_tpu_torch.ingest import native, parser
from veneur_tpu_torch.utils import hashing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANKS = ("histo", "counter", "gauge", "set")


def py_verdict(line: bytes):
    """What the port's Python parser does with a line."""
    if line.startswith(b"_e{") or line.startswith(b"_sc|"):
        return "other", None
    try:
        m = parser.parse_metric(line)
    except parser.ParseError:
        return "error", None
    return "metric", m


def assert_conformant(line: bytes):
    pv, pm = py_verdict(line)
    cv, cm = native.parse_one(line)
    if cv == native.P_OTHER:
        # the C++ parser may hand a line it cannot prove identical to
        # Python (which then parses it); events and checks always go there
        return
    if pv == "metric":
        assert cv == native.P_METRIC, f"C++ rejected valid line {line!r}"
        assert cm["name"] == pm.key.name
        assert cm["type"] == pm.key.type
        assert cm["joined_tags"] == pm.key.joined_tags
        assert cm["digest"] == pm.digest
        assert cm["sample_rate"] == pm.sample_rate
        assert cm["scope"] == pm.scope
        if pm.key.type == "set":
            assert cm["value"] == pm.value
        else:
            assert cm["value"] == pm.value or (
                np.isnan(cm["value"]) and np.isnan(pm.value))
    else:
        assert cv == native.P_ERROR, \
            f"C++ accepted invalid line {line!r}: {cm}"


def mk_bridge(slots=64, ring=4096, **kw):
    return native.NativeBridge(histo_slots=slots, counter_slots=slots,
                               gauge_slots=slots, set_slots=slots,
                               hll_precision=14, idle_ttl=4,
                               ring_capacity=ring, max_packet=8192, **kw)


@pytest.fixture
def bridge():
    br = mk_bridge()
    yield br
    br.close()


def poll_all(br, bank, n=4096):
    slots = np.zeros(n, np.int32)
    a = np.zeros(n, np.float32)
    b = np.zeros(n, np.float32)
    c = np.zeros(n, np.int32)
    got = br.poll(bank, slots, a, b, c)
    return got, slots[:got], a[:got], b[:got], c[:got]


def rho_pairs(members, p=14):
    out = []
    for member in members:
        h = hashing.set_member_hash(member)
        rest = ((h << p) & 0xFFFFFFFFFFFFFFFF) | ((1 << p) - 1)
        out.append((h >> (64 - p), 65 - rest.bit_length()))
    return out


# ---------------------------------------------------------------- build


def test_library_is_built_under_the_port_and_never_native_build():
    path = native.build()
    assert path == native.LIB_PATH
    assert os.path.dirname(path) == os.path.join(
        ROOT, "veneur_tpu_torch", "_build")
    assert os.path.getmtime(path) >= os.path.getmtime(native.SOURCE)
    assert native.SOURCE == os.path.join(ROOT, "native", "vtpu_ingest.cpp")
    # the port loads its own library (not the reference's native/build)
    native.load()
    with open("/proc/self/maps") as f:
        assert native.LIB_PATH in f.read()


def test_failed_build_raises_native_unavailable(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "b" / "x.so"))
    with pytest.raises(native.NativeUnavailable, match="build failed"):
        native.build()
    assert os.listdir(tmp_path / "b") == [".libvtpu_ingest.lock"]
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cpp"))
    with pytest.raises(native.NativeUnavailable, match="source missing"):
        native.build()


def test_port_and_reference_bridges_coexist_in_one_process():
    """Both libraries define the same vtpu_* symbols; RTLD_LOCAL keeps
    each bridge on its own copy, and each interns the same keys to the
    same slots."""
    from veneur_tpu.ingest import native as ref_native
    try:
        ref_native.load()
    except ref_native.NativeUnavailable as e:  # pragma: no cover
        pytest.skip(f"reference bridge unavailable: {e}")
    ours, theirs = mk_bridge(), ref_native.NativeBridge(
        histo_slots=64, counter_slots=64, gauge_slots=64, set_slots=64,
        hll_precision=14, idle_ttl=4, ring_capacity=4096, max_packet=8192)
    try:
        assert ours._lib._handle != theirs._lib._handle
        pkt = b"a:1|c\nb:2|c|#x:y\nt:3|ms\nu:alice|s\nb:5|c|#x:y"
        ours.handle_packet(pkt)
        theirs.handle_packet(pkt)
        assert ours.drain_new_keys() == theirs.drain_new_keys()
        for bank in BANKS:
            got_o = poll_all(ours, bank)
            got_t = poll_all(theirs, bank)
            assert got_o[0] == got_t[0]
            for x, y in zip(got_o[1:], got_t[1:]):
                np.testing.assert_array_equal(x, y)
        assert ours.stats() == theirs.stats()
    finally:
        ours.close()
        theirs.close()


# ------------------------------------------------------- parse conformance


@pytest.mark.parametrize("case", VALID, ids=[v[0].decode() for v in VALID])
def test_valid_corpus(case):
    assert_conformant(case[0])


@pytest.mark.parametrize("line", INVALID, ids=[repr(x) for x in INVALID])
def test_invalid_corpus(line):
    assert_conformant(line)


def test_events_checks_and_oddities_punt():
    assert native.parse_one(b"_e{2,3}:ab|cde")[0] == native.P_OTHER
    assert native.parse_one(b"_sc|svc|0")[0] == native.P_OTHER
    assert native.parse_one(b"nam\xff:1|c")[0] == native.P_OTHER
    # CPython's float("1_0") == 10.0; the C++ parser must not guess
    assert native.parse_one(b"a:1_0|c")[0] == native.P_OTHER


def test_randomized_lines():
    rng = random.Random(42)
    names = ["a", "api.req", "x.y.z", "srv-1.count", "m" * 40]
    types = ["c", "g", "ms", "h", "s", "d", "q", ""]
    tagsets = ["", "#a:b", "#b,a", "#veneurlocalonly",
               "#veneurglobalonly,t:1", "#dup,dup"]
    rates = ["", "@0.5", "@1", "@2", "@0", "@x"]
    values = ["1", "-2.5", "1e3", "abc", "", "inf", "nan", "1.5e-2"]
    for _ in range(3000):
        line = f"{rng.choice(names)}:{rng.choice(values)}|{rng.choice(types)}"
        for extra in (rng.choice(rates), rng.choice(tagsets)):
            if extra:
                line += "|" + extra
        assert_conformant(line.encode())


def test_byte_soup_and_mutated_lines():
    rng = random.Random(7)
    alphabet = b"abc:|#@,.0123456789-+eE\x00\xffg\ns "
    for _ in range(3000):
        line = bytes(rng.choice(alphabet) for _ in range(rng.randrange(60)))
        assert_conformant(line)
    seeds = [v[0] for v in VALID]
    for _ in range(3000):
        line = bytearray(rng.choice(seeds))
        for _ in range(rng.randrange(1, 4)):
            op = rng.randrange(3)
            if op == 0 and line:
                line[rng.randrange(len(line))] = rng.randrange(256)
            elif op == 1 and line:
                del line[rng.randrange(len(line)):]
            else:
                i = rng.randrange(len(line) + 1)
                line[i:i] = line[:rng.randrange(8)]
        assert_conformant(bytes(line))


def test_bench_hook():
    lines = b"\n".join(f"api.req.time_{i % 97}:{i % 113}|ms|#svc:web"
                       .encode() for i in range(1000))
    arr = np.frombuffer(bytearray(lines), np.uint8)
    assert native.load().vtpu_bench_parse(native._u8(arr), len(lines),
                                          10) > 0


# ------------------------------------------------------- bridge mechanics


def test_counter_roundtrip(bridge):
    bridge.handle_packet(b"hits:3|c|@0.5\nhits:1|c\nother:2|c")
    got, slots, vals, wts, _ = poll_all(bridge, "counter")
    assert got == 3
    by_name = {k[4]: k for k in bridge.drain_new_keys()}
    assert set(by_name) == {"hits", "other"}
    mask = slots == by_name["hits"][3]
    assert mask.sum() == 2
    assert sorted(wts[mask].tolist()) == [1.0, 2.0]     # 1 / rate
    assert sorted(vals[mask].tolist()) == [1.0, 3.0]


def test_histo_and_timer_are_distinct_keys(bridge):
    bridge.handle_packet(b"x:1|ms\nx:1|h")
    keys = bridge.drain_new_keys()
    assert {k[1] for k in keys} == {2, 3}    # timer, histogram


def test_set_rho_matches_the_ports_hashing(bridge):
    bridge.handle_packet(b"users:alice|s\nusers:bob|s\nusers:\xc3\xa9|s")
    got, _slots, rho, _, idx = poll_all(bridge, "set")
    assert got == 3
    assert sorted(zip(idx.tolist(), rho.astype(int).tolist())) == \
        sorted(rho_pairs(["alice", "bob", "é"]))


def test_scope_tags(bridge):
    bridge.handle_packet(b"t:1|ms|#veneurglobalonly\nc:1|c|#veneurlocalonly")
    keys = {k[4]: k for k in bridge.drain_new_keys()}
    assert keys["t"][2] == parser.GLOBAL_ONLY
    assert keys["c"][2] == parser.LOCAL_ONLY
    assert bridge.slot_scopes("histo")[keys["t"][3]] == parser.GLOBAL_ONLY


def test_slow_path_routing_and_parse_errors(bridge):
    bridge.handle_packet(b"_e{2,2}:ab|cd\n_sc|s|0\na:1_0|c")
    assert bridge.drain_other() == [b"_e{2,2}:ab|cd", b"_sc|s|0",
                                    b"a:1_0|c"]
    bridge.handle_packet(b"bad\n:1|c\na:1|q")
    st = bridge.stats()
    assert st["parse_errors"] == 3 and st["slow_routed"] == 3
    assert st["packets"] == 2 and st["lines"] == 6


def test_bank_full_drops(bridge):
    for i in range(200):
        bridge.handle_packet(f"m{i}:1|c".encode())
    assert bridge.stats()["drops_no_slot"] == 200 - 64
    assert bridge.key_count("counter") == 64


def test_eviction(bridge):
    bridge.handle_packet(b"old:1|c")
    for _ in range(6):
        bridge.advance_interval("counter")
        bridge.handle_packet(b"fresh:1|c")
    assert bridge.key_count("counter") == 1     # "old" evicted


def test_intern_matches_the_parse_path(bridge):
    bridge.handle_packet(b"hits:1|c|#a:b")
    (_, _, _, slot, _, _), = bridge.drain_new_keys()
    assert bridge.intern("counter", 0, "hits", "a:b") == slot
    assert bridge.intern("counter", 0, "hits", "a:c") != slot


def test_udp_readers(bridge):
    port = bridge.start_udp("127.0.0.1", 0, 2)
    assert port > 0 and bridge.bound_port() == port
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for i in range(50):
            s.sendto(f"udp.m:{i}|ms".encode(), ("127.0.0.1", port))
    deadline = time.monotonic() + 5
    total = 0
    while total < 50 and time.monotonic() < deadline:
        total += poll_all(bridge, "histo")[0]
        time.sleep(0.01)
    assert total == 50
    bridge.stop()


def test_thread_local_cache_is_bridge_scoped():
    """A thread that ingested into bridge A must not reuse A's key-to-slot
    memo when it later serves bridge B."""
    a, b = mk_bridge(), mk_bridge()
    try:
        a.handle_packet(b"k1:1|c\nk2:1|c\nk3:1|c")
        assert {k[4]: k[3] for k in a.drain_new_keys()}["k3"] == 2
        b.handle_packet(b"other:1|c")
        b.handle_packet(b"k3:5|c")
        b_keys = {k[4]: k[3] for k in b.drain_new_keys()}
        assert b_keys["k3"] == 1
        _got, slots, vals, _, _ = poll_all(b, "counter")
        assert 5.0 in vals[slots == b_keys["k3"]].tolist()
    finally:
        a.close()
        b.close()


def test_tags_exclude_in_the_cpp_parser(bridge):
    bridge.set_tags_exclude(["pod_id", "debug"])
    bridge.handle_packet(b"m:1|c|#env:p,pod_id:a\nm:2|c|#env:p,pod_id:b\n"
                         b"m:3|c|#debug,env:p")
    keys = bridge.drain_new_keys()
    assert len(keys) == 1 and keys[0][5] == "env:p"
    got, _slots, vals, _, _ = poll_all(bridge, "counter")
    assert got == 3 and sorted(vals.tolist()) == [1.0, 2.0, 3.0]
    pm = parser.parse_metric(b"m:1|c|#env:p,pod_id:a",
                             frozenset(["pod_id", "debug"]))
    assert hashing.metric_digest(keys[0][4], "counter",
                                 keys[0][5]) == pm.digest


# ---------------------------------------------------- views, pump, engine


def small_engine():
    from veneur_tpu_torch.models.pipeline import (AggregationEngine,
                                                  EngineConfig)
    return AggregationEngine(EngineConfig(
        histogram_slots=64, counter_slots=64, gauge_slots=64, set_slots=64,
        batch_size=64, buffer_depth=16, compression=20,
        percentiles=(0.5,), aggregates=("count",)), device="cpu")


def wire(br, eng, batch=256, slow=None):
    views = {b: native.BridgeKeyView(br, b) for b in BANKS}
    eng.histo_keys, eng.counter_keys = views["histo"], views["counter"]
    eng.gauge_keys, eng.set_keys = views["gauge"], views["set"]
    pump = native.NativePump(br, eng, views, slow or (lambda line: None),
                             batch=batch)
    return views, pump


def test_pump_lands_buffer_copies():
    """The pump hands the engine copies, never its reused poll buffers:
    on the CPU the engine's tensors alias the arrays it is given."""
    br = mk_bridge()
    captured = []

    class StubEngine:
        def ingest_histo_batch(self, slots, values, weights, count=None,
                               mark=None):
            captured.append((slots, values, weights))

        def ingest_counter_batch(self, slots, values, weights, count=None,
                                 mark=None):
            captured.append((slots, values, weights))

        def ingest_gauge_batch(self, slots, values, count=None, mark=None):
            captured.append((slots, values))

        def ingest_set_batch(self, slots, reg_idx, rho, count=None,
                             mark=None):
            captured.append((slots, reg_idx, rho))

    try:
        views = {b: native.BridgeKeyView(br, b) for b in BANKS}
        pump = native.NativePump(br, StubEngine(), views, lambda line: None,
                                 batch=256)
        br.handle_packet(b"t:1|ms\nc:2|c\ng:3|g\ns:x|s")
        assert pump.pump_once() == 4 and pump.landed == 4
        assert len(captured) == 4
        bufs = [arr for tup in pump._bufs.values() for arr in tup]
        for tup in captured:
            for arr in tup:
                assert not any(np.shares_memory(arr, b) for b in bufs), \
                    "pump passed a live poll buffer to the engine"
    finally:
        br.close()


def test_pump_overwrites_no_landed_batch_on_the_cpu():
    """Batches wider than the pump's width in every bank: later polls
    reuse the buffers while the engine holds earlier batches (staged
    sets, histogram buffers); the flushed values stay exact."""
    br = mk_bridge(ring=1 << 16)
    eng = small_engine()
    try:
        _views, pump = wire(br, eng, batch=64)
        lines = []
        for i in range(1000):
            lines += [f"c{i % 7}:{i}|c", f"h{i % 5}:{i % 97}|ms",
                      f"s{i % 3}:m{i}|s", f"g{i % 4}:{i}|g"]
        for j in range(0, len(lines), 100):
            br.handle_packet("\n".join(lines[j:j + 100]).encode())
        assert pump.drain()
        assert pump.landed == 4000
        res = eng.flush(timestamp=1)
        vals = {m.name: m.value for m in res.metrics}
        for k in range(7):
            assert vals[f"c{k}"] == sum(range(k, 1000, 7))
        for k in range(4):
            assert vals[f"g{k}"] == max(range(k, 1000, 4))
        for k in range(5):
            assert vals[f"h{k}.count"] == 200
        for k in range(3):
            n = len(range(k, 1000, 3))
            assert abs(vals[f"s{k}"] - n) <= 3 * 1.04 / 128 * n + 1
    finally:
        br.close()


def test_views_track_touched_keys_eviction_and_all_items():
    br = mk_bridge()
    eng = small_engine()
    try:
        views, pump = wire(br, eng)
        br.handle_packet(b"old:1|c\nkeep:1|c\nt:1|ms")
        pump.pump_once()
        cv = views["counter"]
        assert sorted(k.name for k, *_ in cv.active_items()) == \
            ["keep", "old"]
        assert len(cv) == 2 and cv.key_of(cv.lookup(
            parser.MetricKey("keep", "counter", ""), 0)).name == "keep"
        eng.flush(timestamp=1)
        assert cv.active_items() == []
        assert sorted(k.name for k, *_ in cv.all_items()) == \
            ["keep", "old"]
        for ts in range(2, 8):
            br.handle_packet(b"keep:1|c")
            pump.pump_once()
            eng.flush(timestamp=ts)
        # the bridge evicted "old" after its idle TTL of 4 intervals, and
        # the view's mirror dropped it in the same advance
        assert len(cv) == 1
        assert [k.name for k, *_ in cv.all_items()] == ["keep"]
        assert [k.name for k, *_ in views["histo"].all_items()] == []
    finally:
        br.close()


def test_mark_runs_under_the_engine_lock_before_the_landing():
    eng = small_engine()
    seen = []

    def mark(slots):
        assert eng.lock.locked()
        seen.append((np.asarray(slots).tolist(), eng.samples_processed))

    eng.ingest_counter_batch(np.array([3, 5, -1], np.int32),
                             np.ones(3, np.float32), np.ones(3, np.float32),
                             count=2, mark=mark)
    eng.ingest_gauge_batch(np.array([1], np.int32), np.ones(1, np.float32),
                           mark=mark)
    eng.ingest_histo_batch(np.array([2], np.int32), np.ones(1, np.float32),
                           np.ones(1, np.float32), mark=mark)
    eng.ingest_set_batch(np.array([4], np.int32), np.array([7], np.int32),
                         np.array([2], np.uint8), mark=mark)
    assert seen == [([3, 5], 0), ([1], 2), ([2], 3), ([4], 4)]
    assert eng.samples_processed == 5


def test_gauge_seqs_follow_the_pump_order():
    """The pump lands banks in the reference's order (histo, counter,
    gauge, set), and a gauge's last write in ring order wins."""
    br = mk_bridge()
    eng = small_engine()
    try:
        _views, pump = wire(br, eng)
        br.handle_packet(b"g:1|g\ng:2|g\ng:3|g")
        br.handle_packet(b"g:9|g\ng:4|g")
        pump.pump_once()
        assert eng._gauge_seq == 5
        vals = {m.name: m.value for m in eng.flush(timestamp=1).metrics}
        assert vals["g"] == 4.0
    finally:
        br.close()


# ---------------------------------------------------------- native SSF


def pb_len(field, payload: bytes) -> bytes:
    return bytes([(field << 3) | 2, len(payload)]) + payload


def test_ssf_parity_randomized():
    """Every natively staged sample agrees with the port's
    sample_to_metric on key identity, bank, value and weight."""
    from veneur_tpu_torch.sinks.ssfmetrics import sample_to_metric
    from veneur_tpu_torch.ssf.protos import ssf_pb2

    rng = random.Random(42)
    br = mk_bridge(slots=256, ring=65536)
    expected, spans = [], []
    for _ in range(50):
        sp = ssf_pb2.SSFSpan(version=1)
        for _j in range(rng.randint(1, 4)):
            s = sp.metrics.add()
            s.metric = rng.choice([ssf_pb2.SSFSample.COUNTER,
                                   ssf_pb2.SSFSample.GAUGE,
                                   ssf_pb2.SSFSample.HISTOGRAM,
                                   ssf_pb2.SSFSample.SET])
            s.name = f"m{rng.randint(0, 20)}"
            s.value = round(rng.uniform(0.1, 500.0), 3)
            if s.metric == ssf_pb2.SSFSample.SET:
                s.message = f"member-{rng.randint(0, 99)}-é"
            if s.metric == ssf_pb2.SSFSample.HISTOGRAM and \
                    rng.random() < 0.5:
                s.unit = rng.choice(["ns", "µs", "us", "ms", "s", "bytes"])
            if rng.random() < 0.5:
                s.sample_rate = rng.choice([0.1, 0.5, 1.0])
            for _t in range(rng.randint(0, 3)):
                s.tags[f"k{rng.randint(0, 5)}"] = rng.choice(
                    ["", "v1", "v2", "ü"])
            s.scope = rng.choice([0, 1, 2])
            it = sample_to_metric(s)
            if it is not None:
                expected.append(it)
        spans.append(sp)
    try:
        for sp in spans:
            assert br.handle_ssf(sp.SerializeToString()) == 1
        keys = {(k[0], k[3]): k for k in br.drain_new_keys()}
        bank_of = {"counter": "counter", "gauge": "gauge", "timer": "histo",
                   "histogram": "histo", "set": "set"}
        for bi, bank in enumerate(BANKS):
            got, slots, a, b, c = poll_all(br, bank)
            exp = [it for it in expected if bank_of[it.key.type] == bank]
            assert got == len(exp), bank
            for i, it in enumerate(exp):
                rec = keys[(bi, int(slots[i]))]
                assert (rec[4], rec[5]) == (it.key.name, it.key.joined_tags)
                assert native._MTYPE_NAMES[rec[1]] == it.key.type
                if bank == "set":
                    assert (int(c[i]), int(a[i])) == \
                        rho_pairs([str(it.value)])[0]
                else:
                    assert a[i] == pytest.approx(it.value, rel=1e-6)
                    if bank != "gauge":
                        assert b[i] == pytest.approx(1.0 / it.sample_rate,
                                                     rel=1e-6)
    finally:
        br.close()


def test_ssf_duplicate_map_key_last_wins():
    from veneur_tpu_torch.sinks.ssfmetrics import sample_to_metric
    from veneur_tpu_torch.ssf.protos import ssf_pb2

    def tag_entry(k, v):
        return pb_len(8, pb_len(1, k) + pb_len(2, v))

    sample = (bytes([1 << 3, 0]) + pb_len(2, b"dup.c")
              + tag_entry(b"k", b"v1") + tag_entry(b"k", b"v2")
              + tag_entry(b"a", b"x"))
    span = pb_len(12, sample)
    it = sample_to_metric(ssf_pb2.SSFSpan.FromString(span).metrics[0])
    assert it.key.joined_tags == "a:x,k:v2"
    br = mk_bridge()
    try:
        assert br.handle_ssf(span) == 1
        (rec,) = br.drain_new_keys()
        assert rec[5] == it.key.joined_tags
    finally:
        br.close()


def test_ssf_invalid_utf8_rejected():
    bad_name = bytes([1 << 3, 0]) + pb_len(2, b"\xff\xfe")
    bad_tag = (bytes([1 << 3, 0]) + pb_len(2, b"ok")
               + pb_len(8, pb_len(1, b"k") + pb_len(2, b"\xc3\x28")))
    br = mk_bridge()
    try:
        for sample in (bad_name, bad_tag):
            assert br.handle_ssf(pb_len(12, sample)) == -1
        assert br.stats()["samples"] == 0 and br.drain_new_keys() == []
    finally:
        br.close()


def test_ssf_status_fallback_stages_nothing_and_malformed_is_an_error():
    from veneur_tpu_torch.ssf.protos import ssf_pb2
    br = mk_bridge()
    try:
        sp = ssf_pb2.SSFSpan()
        s = sp.metrics.add()
        s.metric = ssf_pb2.SSFSample.STATUS
        s.name = "chk"
        s.status = ssf_pb2.SSFSample.CRITICAL
        m = sp.metrics.add()
        m.metric = ssf_pb2.SSFSample.COUNTER
        m.name = "c"
        m.value = 1.0
        assert br.handle_ssf(sp.SerializeToString()) == 0
        st = br.stats()
        assert st["samples"] == 0 and st["ssf_fallbacks"] == 1
        assert br.handle_ssf(b"\xff\xff\xff\xff\x01") == -1
    finally:
        br.close()


def test_ssf_indicator_timer_matches_the_ports():
    from veneur_tpu_torch.sinks.ssfmetrics import indicator_timer
    from veneur_tpu_torch.ssf.protos import ssf_pb2
    br = mk_bridge()
    br.set_indicator_timer("veneur.indicator")
    try:
        sp = ssf_pb2.SSFSpan(indicator=True, error=True, service="api",
                             start_timestamp=10**18,
                             end_timestamp=10**18 + 12_345_678)
        assert br.handle_ssf(sp.SerializeToString()) == 1
        want = indicator_timer(sp, "veneur.indicator")
        (rec,) = br.drain_new_keys()
        assert (rec[4], rec[5]) == (want.key.name, want.key.joined_tags)
        got, _s, a, _b, _c = poll_all(br, "histo", 16)
        assert got == 1 and a[0] == pytest.approx(want.value, rel=1e-6)
    finally:
        br.close()


def _valid_span(rng):
    from veneur_tpu_torch.ssf.protos import ssf_pb2
    sp = ssf_pb2.SSFSpan(version=1)
    if rng.random() < 0.3:
        sp.indicator = True
        sp.service = "svc"
        sp.start_timestamp = 10**18
        sp.end_timestamp = 10**18 + rng.randrange(10**9)
    for _ in range(rng.randrange(0, 4)):
        s = sp.metrics.add()
        s.metric = rng.choice([0, 1, 2, 3, 4])
        s.name = rng.choice(["m.a", "m.b", "", "x" * 60])
        s.value = rng.uniform(-1e6, 1e6)
        if s.metric == 3:
            s.message = rng.choice(["u1", "ü", ""])
        if rng.random() < 0.4:
            s.unit = rng.choice(["ms", "s", "ns", "µs", "things"])
        if rng.random() < 0.5:
            s.sample_rate = rng.choice([0.0, 0.25, 1.0])
        for _ in range(rng.randrange(0, 3)):
            s.tags[rng.choice("abcd")] = rng.choice(["", "v", "ß"])
        s.scope = rng.randrange(0, 4)
    return sp.SerializeToString()


def test_ssf_fuzz_differential():
    """Mutated spans: the verdict stays in {-1, 0, 1}, and every span the
    C++ walker accepts is one the port's decoder accepts, with as many
    samples staged as sample_to_metric extracts."""
    from veneur_tpu_torch.sinks.ssfmetrics import sample_to_metric
    from veneur_tpu_torch.ssf.protos import ssf_pb2

    rng = random.Random(23)
    br = native.NativeBridge(histo_slots=512, counter_slots=512,
                             gauge_slots=256, set_slots=128,
                             hll_precision=14, idle_ttl=4,
                             ring_capacity=1 << 18, max_packet=8192)
    try:
        expect = 0
        for i in range(2500):
            data = _valid_span(rng)
            if i % 2:
                buf = bytearray(data)
                for _ in range(rng.randrange(1, 4)):
                    op = rng.randrange(3)
                    if op == 0 and buf:
                        buf[rng.randrange(len(buf))] = rng.randrange(256)
                    elif op == 1 and buf:
                        del buf[rng.randrange(len(buf)):]
                    else:
                        j = rng.randrange(len(buf) + 1)
                        buf[j:j] = buf[:rng.randrange(6)]
                data = bytes(buf)
            rc = br.handle_ssf(data)
            assert rc in (-1, 0, 1), rc
            if rc == 1:
                sp = ssf_pb2.SSFSpan.FromString(data)
                assert not any(s.metric == ssf_pb2.SSFSample.STATUS
                               and s.name for s in sp.metrics)
                expect += sum(1 for s in sp.metrics
                              if sample_to_metric(s) is not None)
        st = br.stats()
        assert int(st["samples"]) + int(st["drops_no_slot"]) == expect
        for _ in range(2000):
            soup = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(80)))
            assert br.handle_ssf(soup) in (-1, 0, 1)
    finally:
        br.close()


@pytest.mark.parametrize("extra,accepted", [
    (bytes([0x7b, 0x7c]), True),                # empty group
    (bytes([0x7b, 0x08, 0x05, 0x7c]), True),    # an inner varint
    (bytes([0x7b, 0x63, 0x64, 0x7c]), True),    # nested
    (bytes([0x7b, 0x6c]), False),               # mismatched end
    (bytes([0x7b]), False),                     # unterminated
    (bytes([0x7c]), False),                     # a bare end group
    (bytes([0x00, 0x00]), False),               # field number 0
])
def test_ssf_wire_format_corners_agree_with_the_ports_decoder(extra,
                                                               accepted):
    from veneur_tpu_torch.ssf import framing
    from veneur_tpu_torch.ssf.protos import ssf_pb2
    data = ssf_pb2.SSFSpan(version=1).SerializeToString() + extra
    br = mk_bridge()
    try:
        try:
            framing.parse_ssf_datagram(data)
            py = True
        except framing.FramingError:
            py = False
        assert py == accepted
        assert (br.handle_ssf(data) >= 0) == accepted
    finally:
        br.close()


def test_ssf_enum_truncation_and_deep_groups_fall_back():
    from veneur_tpu_torch.ssf import framing
    from veneur_tpu_torch.ssf.protos import ssf_pb2
    br = mk_bridge()
    try:
        # metric = 2^32 + 4 decodes as STATUS in Python: fall back
        sample = (bytes([1 << 3, 0x84, 0x80, 0x80, 0x80, 0x10])
                  + pb_len(2, b"chk"))
        span = pb_len(12, sample)
        assert ssf_pb2.SSFSpan.FromString(span).metrics[0].metric == \
            ssf_pb2.SSFSample.STATUS
        assert br.handle_ssf(span) == 0
        # unknown-field groups past the C++ depth cap fall back (the
        # Python decoder takes them), shallower ones stay native, and an
        # unterminated group is an error on both paths
        with open(native.SOURCE) as f:
            cap = int(re.search(r"constexpr int kPbSkipMaxDepth = (\d+);",
                                f.read()).group(1))

        def nested(depth):
            body = b""
            for _ in range(depth):
                body = bytes([123]) + body + bytes([124])
            return body

        assert br.handle_ssf(nested(cap + 4)) == 0
        framing.parse_ssf_datagram(nested(cap + 4))
        assert br.handle_ssf(nested(cap - 4)) == 1
        assert br.handle_ssf(bytes([123]) * 4) == -1
    finally:
        br.close()


def test_ssf_tag_entry_with_an_omitted_half_parses_like_the_port():
    from veneur_tpu_torch.sinks.ssfmetrics import sample_to_metric
    from veneur_tpu_torch.ssf import framing
    sample = (bytes([1 << 3, 0]) + pb_len(2, b"c.x")
              + bytes([(3 << 3) | 5]) + b"\x00\x00\x80\x3f"
              + pb_len(8, pb_len(2, b"justval"))
              + pb_len(8, pb_len(1, b"justkey")))
    dgram = pb_len(12, sample)
    br = mk_bridge()
    try:
        assert br.handle_ssf(dgram) == 1
        (rec,) = br.drain_new_keys()
        m = sample_to_metric(framing.parse_ssf_datagram(dgram).metrics[0])
        assert (rec[4], rec[5]) == (m.key.name, m.key.joined_tags)
    finally:
        br.close()


def test_concurrent_writers_fill_separate_ring_ways():
    """A writer thread owns one of the ring's eight ways (ring_capacity /
    8 samples each): four threads together stage what one cannot."""
    br = mk_bridge(slots=64, ring=8 * 1000)
    try:
        def write():
            for _ in range(9):
                br.handle_packet(b"\n".join([b"t:1|ms"] * 100))

        one = threading.Thread(target=write)
        one.start()
        one.join()
        assert br.stats()["ring_drops"] == 0
        threads = [threading.Thread(target=write) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = br.stats()
        assert st["ring_drops"] == 0 and st["samples"] == 5 * 900
        total = 0
        while True:
            got = poll_all(br, "histo", 2048)[0]
            if not got:
                break
            total += got
        assert total == 5 * 900
    finally:
        br.close()


def test_warm_ingest_kernels_lands_nothing():
    """The warm-up landings run on padding: every bank and dirty bitmap
    stays as it was, and the next flush holds no row."""
    import torch
    eng = small_engine()
    banks = (eng.histo_bank, eng.counter_bank, eng.gauge_bank, eng.set_bank)
    before = [[t.clone() for t in bank] for bank in banks]
    dirty = [d.copy() for d in eng._dirty]
    eng.warm_ingest_kernels(256)
    after = (eng.histo_bank, eng.counter_bank, eng.gauge_bank, eng.set_bank)
    for b0, b1 in zip(before, after):
        for x, y in zip(b0, b1):
            assert torch.equal(x, y)
    assert all((d0 == d1).all() for d0, d1 in zip(dirty, eng._dirty))
    assert eng.samples_processed == 0 and eng._gauge_seq == 0
    assert eng.flush(timestamp=1).metrics == []


def test_native_server_warms_the_landings_at_the_pump_width(monkeypatch):
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.models import pipeline
    from veneur_tpu_torch.server import Server
    widths = []
    monkeypatch.setattr(pipeline.AggregationEngine, "warm_ingest_kernels",
                        lambda self, b: widths.append(b))
    for native_on in (True, False):
        srv = Server(Config(statsd_listen_addresses=[], interval="3600s",
                            native_ingest=native_on, native_pump_batch=512,
                            tpu_histogram_slots=256, tpu_counter_slots=128,
                            tpu_gauge_slots=128, tpu_set_slots=64),
                     device="cpu")
        srv.start()
        srv.stop()
    # every engine's warm-up lands at its batch width (8192); the native
    # server's engine also at the pump's
    assert widths == [8192, 512, 8192]
