"""The time-travel query tier on the port (veneur_tpu_torch/durability/
history.py, the server's history arm and GET /query):
tests/test_history_query.py with the port in place of the reference,
servers on the CPU (`aggregation_backend: cpu`), then the two packages
held against each other (`TestAgainstTheReference`).

The reference's layers, run against the port:

* `HistoryStore` unit + fuzz: committed-generation retention, overlap
  resolution, both prune bounds, atomic manifest recovery under
  torn-write/bit-flip corruption (a bit-exact committed prefix, never
  an exception, never an invented generation), and the lease contract
  (pruning mid-query never yanks a generation a running query holds).

* The ORACLE gate: a scripted-clock two-tier rig — one local fans the
  SAME forwarded bodies to a history-armed global (flushing N
  intervals) and to a live oracle global (merging the same intervals
  directly in one flush). `GET /query` over the full window must match
  the oracle EXACTLY on counters/counts/sums/min/max/cardinality and
  within the engine's stated error contract on quantiles — for both
  the default tdigest+hll pair and the req+ull backends. Sub-windows
  check against raw-data truth.

* Read-path isolation: a query completes while every live engine's
  ingest/flush lock is HELD (the query tier provably never takes
  them), the query tick lands in the flight-recorder ring with >= 95%
  phase attribution under `query>query.{resolve,restore,merge,
  estimate}`, and concurrent queries during ingest+flush leave flushed
  totals exact.

Against the reference: parse_qspec's results and errors are the
reference's, and a port global and a reference global fed the same
journaled imports (the same POST /import bodies under the same
envelopes) answer the same GET /query requests: count, sum, min, max,
counter values and set cardinalities exact (HLL estimates within rtol
1e-5, the ROADMAP contract), quantiles within 1% of the window's sample
spread, and the same error statuses.
"""

import json
import os
import shutil
import tempfile
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from veneur_tpu_torch.config import read_config
from veneur_tpu_torch.durability import records as drec
from veneur_tpu_torch.durability.history import (HistoryCorrupt, HistoryStore,
                                           QueryError, parse_qspec)
from veneur_tpu_torch.ingest.parser import parse_metric
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink

# interval 3600s: every flush in these tests is an EXPLICIT
# flush_once(timestamp=...) with a scripted clock — the background
# flush loop must never fire mid-test, or it seals a wall-clock
# generation whose close stamp postdates every scripted one (and, with
# an age bound configured, would prune them all as ancient)
_BASE = """
interval: "3600s"
aggregation_backend: cpu
hostname: "hq"
flush_phase_timers: false
aggregates: ["min", "max", "count", "sum"]
percentiles: [0.5, 0.99]
tpu_histogram_slots: 256
tpu_counter_slots: 128
tpu_gauge_slots: 64
tpu_set_slots: 32
tpu_batch_size: 8192
tpu_buffer_depth: 256
"""

_ENGINES = "histogram_backend: \"req\"\nset_backend: \"ull\"\n"


# --------------------------------------------------------------- store


def _mk_store(d, retention=8, seconds=0.0):
    return HistoryStore(d, retention_generations=retention,
                        retention_seconds=seconds, fsync=False)


def _fill(store, n, base_recs=None, start_close=100):
    """Append n tiny generations with one-interval spacing."""
    base_recs = base_recs or []
    prev = 0
    gens = []
    for i in range(n):
        close = (start_close + 100 * i) * 1_000_000_000
        op = drec.encode_engine_import(i + 1, [], None)
        gens.append(store.append(close, prev, [i + 1], base_recs,
                                 [(i + 1, op)]))
        prev = close
    return gens


class TestHistoryStore:
    def test_append_resolve_overlap(self, tmp_path):
        st = _mk_store(str(tmp_path))
        _fill(st, 3)                       # closes at 100/200/300
        # full window
        got = st.acquire(0, 400 * 10**9)
        assert [e.gen for e in got] == [1, 2, 3]
        st.release(got)
        # interval 3 only: (200, 300]
        got = st.acquire(201 * 10**9, 301 * 10**9)
        assert [e.gen for e in got] == [3]
        st.release(got)
        # a window after the newest close resolves nothing
        assert st.acquire(400 * 10**9, 500 * 10**9) == []
        # ... but generation 1 (prev_close 0) claims everything
        # before its close — its baseline is the pre-history state
        got = st.acquire(10**9, 2 * 10**9)
        assert [e.gen for e in got] == [1]
        st.release(got)
        # boundary: t1 == an open edge excludes that generation
        got = st.acquire(0, 100 * 10**9)
        assert [e.gen for e in got] == [1]
        st.release(got)

    def test_count_prune_drops_oldest(self, tmp_path):
        st = _mk_store(str(tmp_path), retention=3)
        _fill(st, 5)
        assert [e.gen for e in st.entries()] == [3, 4, 5]
        # pruned files are gone; survivors intact
        assert not os.path.exists(st._seg_path(1))
        assert os.path.exists(st._seg_path(4))

    def test_age_prune_measures_from_newest_close(self, tmp_path):
        # scripted-clock friendly: age compares close stamps, not wall
        st = _mk_store(str(tmp_path), retention=100, seconds=250.0)
        _fill(st, 5)                       # closes 100..500
        # newest=500; floor=250 → 100 and 200 drop
        assert [e.gen for e in st.entries()] == [3, 4, 5]

    def test_empty_coalescing_still_ages_out_data_generations(
            self, tmp_path):
        # the coalesce branch widens the close stamp that the age
        # floor measures against — it must keep pruning, or an idle
        # stretch would pin expired data generations forever
        st = _mk_store(str(tmp_path), retention=100, seconds=250.0)
        _fill(st, 2)                       # data gens close 100, 200
        for i in range(4):                 # idle ticks 300..600
            st.append_empty((300 + 100 * i) * 10**9, 0)
        gens = st.entries()
        # floor = 600 - 250 = 350: both data gens aged out; the ONE
        # coalesced empty row (close 600) survives
        assert [(e.gen, e.nbytes == 0) for e in gens] == [(3, True)]
        assert gens[0].close_ns == 600 * 10**9

    def test_reload_recovers_committed_set(self, tmp_path):
        st = _mk_store(str(tmp_path))
        _fill(st, 4)
        before = [(e.gen, e.close_ns, e.prev_close_ns, e.nbytes)
                  for e in st.entries()]
        st2 = _mk_store(str(tmp_path))
        after = [(e.gen, e.close_ns, e.prev_close_ns, e.nbytes)
                 for e in st2.entries()]
        assert after == before
        # generation ids continue, never reuse
        g = _fill(st2, 1, start_close=900)[0]
        assert g == 5

    def test_orphan_segments_swept_at_open(self, tmp_path):
        st = _mk_store(str(tmp_path))
        _fill(st, 2)
        # a crash between segment publish and manifest commit leaves
        # an orphan .seg (and possibly a .tmp): swept at open
        orphan = st._seg_path(99)
        shutil.copy(st._seg_path(1), orphan)
        with open(st._man_path() + ".tmp", "wb") as f:
            f.write(b"torn")
        st2 = _mk_store(str(tmp_path))
        assert [e.gen for e in st2.entries()] == [1, 2]
        assert not os.path.exists(orphan)
        assert not os.path.exists(st2._man_path() + ".tmp")

    def test_prune_mid_query_defers_leased_unlink(self, tmp_path):
        st = _mk_store(str(tmp_path), retention=2)
        _fill(st, 2)
        held = st.acquire(0, 10**15)       # leases gens 1+2
        assert [e.gen for e in held] == [1, 2]
        _fill(st, 2, start_close=300)      # prunes gens 1+2
        assert [e.gen for e in st.entries()] == [3, 4]
        # the running query still reads its leased generations
        for e in held:
            assert os.path.exists(e.path)
            meta, groups, ops = st.load(e)
            assert meta[0] == e.gen
        st.release(held)
        # lease released: the deferred unlinks ran
        assert not os.path.exists(held[0].path)
        assert not os.path.exists(held[1].path)


class TestRetentionFuzz:
    """Torn-write / bit-flip over a multi-generation store: recovery
    yields a bit-exact committed prefix and never raises; a corrupt
    generation drops out of the committed set (so the query tier
    answers only from committed ones) instead of answering wrong."""

    def _written(self, d, n=5):
        st = _mk_store(d)
        _fill(st, n)
        return [(e.gen, e.close_ns, e.prev_close_ns, e.nbytes)
                for e in st.entries()]

    def test_manifest_torn_tail_recovers_prefix(self, tmp_path):
        d = str(tmp_path)
        before = self._written(d)
        man = os.path.join(d, "engine.history.manifest")
        size = os.path.getsize(man)
        with open(man, "r+b") as f:
            f.truncate(size - 7)           # mid-frame torn write
        st = _mk_store(d)
        got = [(e.gen, e.close_ns, e.prev_close_ns, e.nbytes)
               for e in st.entries()]
        assert got == before[:len(got)]    # bit-exact PREFIX
        assert len(got) == len(before) - 1

    def test_segment_bit_flip_drops_only_that_generation(self,
                                                         tmp_path):
        d = str(tmp_path)
        before = self._written(d)
        seg = os.path.join(d, f"engine.history.{3:016d}.seg")
        data = bytearray(open(seg, "rb").read())
        data[len(data) // 2] ^= 0x40
        with open(seg, "wb") as f:
            f.write(bytes(data))
        st = _mk_store(d)
        got = [(e.gen, e.close_ns, e.prev_close_ns, e.nbytes)
               for e in st.entries()]
        assert got == [r for r in before if r[0] != 3]
        # survivors still load
        for e in st.entries():
            st.load(e)

    def test_manifest_flip_never_raises_never_invents(self, tmp_path):
        d = str(tmp_path)
        before = self._written(d)
        man = os.path.join(d, "engine.history.manifest")
        raw = open(man, "rb").read()
        rng = np.random.default_rng(11)
        committed = {r[0] for r in before}
        for _ in range(24):
            data = bytearray(raw)
            data[int(rng.integers(0, len(data)))] ^= \
                1 << int(rng.integers(0, 8))
            with open(man, "wb") as f:
                f.write(bytes(data))
            st = _mk_store(d)              # never raises
            got = [(e.gen, e.close_ns, e.prev_close_ns, e.nbytes)
                   for e in st.entries()]
            # every surviving row is bit-exact one of the committed
            # ones — corruption can drop, never invent or mutate
            assert set(r[0] for r in got) <= committed
            assert all(r in before for r in got)
        with open(man, "wb") as f:
            f.write(raw)

    def test_load_of_corrupt_leased_segment_fails_loudly(self,
                                                         tmp_path):
        # belt-and-braces: corruption that lands AFTER open-time
        # validation (while an entry is live) fails the read loudly
        d = str(tmp_path)
        self._written(d, n=2)
        st = _mk_store(d)
        held = st.acquire(0, 10**15)
        seg = held[0].path
        data = bytearray(open(seg, "rb").read())
        data[-3] ^= 0x01
        with open(seg, "wb") as f:
            f.write(bytes(data))
        with pytest.raises(HistoryCorrupt):
            st.load(held[0])
        st.release(held)


def test_parse_qspec():
    qs, scalars, card, ctr = parse_qspec("0.5,0.99,count,sum")
    assert qs == (0.5, 0.99) and scalars == ("count", "sum")
    assert not card and not ctr
    assert parse_qspec("cardinality")[2]
    assert parse_qspec("value")[3]
    with pytest.raises(QueryError):
        parse_qspec("1.5")
    with pytest.raises(QueryError):
        parse_qspec("p99")
    with pytest.raises(QueryError):
        parse_qspec("")


# ------------------------------------------------------------ two-tier


def _mk_global(extra="", durability_dir=None):
    text = _BASE + "http_address: \"127.0.0.1:0\"\nis_global: true\n" \
        + extra
    if durability_dir is not None:
        text += (f"durability_enabled: true\n"
                 f"durability_dir: \"{durability_dir}\"\n"
                 f"history_retention_generations: 32\n")
    cfg = read_config(text=text)
    cap = CaptureMetricSink()
    srv = Server(cfg, sinks=[cap], plugins=[], span_sinks=[])
    srv.start()
    return srv, cap


def _mk_local(extra=""):
    loc = Server(
        read_config(text=_BASE + "forward_address: \"placeholder:1\"\n"
                    + extra),
        sinks=[CaptureMetricSink()], plugins=[], span_sinks=[])
    return loc


def _fanout_forwarder(loc, *ports):
    """The oracle rig's forwarder: one local flush POSTs the IDENTICAL
    jsonmetric-v1 body to every listed global — the history tier and
    the live oracle see the same bytes."""
    from veneur_tpu_torch.cluster.forward import HttpJsonForwarder
    fws = [HttpJsonForwarder(f"http://127.0.0.1:{p}",
                             engine_stamp=loc.engine_stamp)
           for p in ports]

    def fan(export):
        for fw in fws:
            fw(export)
    return fan


def _query(port, **params):
    qs = "&".join(f"{k}={v}" for k, v in params.items())
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/query?{qs}", timeout=60).read())


class TestTimeTravelOracle:
    """The acceptance gate: GET /query over any sub-window vs a live
    oracle server that merged the same intervals directly."""

    @pytest.mark.parametrize("engines,qbound", [
        ("", 0.015),          # tdigest+hll
        (_ENGINES, 0.05),     # req+ull (mid-range is distribution-
                              # dependent; tail is REQ's contract)
    ])
    def test_query_matches_live_oracle(self, engines, qbound):
        d = tempfile.mkdtemp()
        hist = oracle = loc = None
        try:
            hist, _hcap = _mk_global(engines, durability_dir=d)
            oracle, ocap = _mk_global(engines)
            loc = _mk_local(engines)
            loc.forwarder = _fanout_forwarder(
                loc, hist.http_api.port, oracle.http_api.port)
            rng = np.random.default_rng(7)
            all_vals, win_vals = [], []
            for i in range(3):
                # integer-valued samples: every count/sum intermediate
                # is exactly representable, so EXACT legs stay exact
                # through f32 bank arithmetic on both sides
                vals = rng.integers(1, 1000, 200).astype(np.float64)
                all_vals.append(vals)
                if i >= 1:
                    win_vals.append(vals)
                for v in vals:
                    loc.engines[0].process(parse_metric(
                        b"lat:%d|ms" % int(v)))
                loc.engines[0].process(parse_metric(
                    b"hits:%d|c|#veneurglobalonly" % (10 * (i + 1))))
                for j in range(300 * i, 300 * (i + 1)):
                    loc.engines[0].process(parse_metric(
                        b"users:u%d|s" % j))
                loc.flush_once(timestamp=20 + 100 * i)
                # generous drains: this box's virtualized CPU swings
                # ±30% under concurrent suite load
                assert hist.drain(60.0) and oracle.drain(60.0)
                hist.flush_once(timestamp=100 + 100 * i)
            oracle.flush_once(timestamp=300)
            assert ocap.wait_for_flush(timeout=30.0)
            want = {m.name: m.value for m in ocap.all_metrics}

            port = hist.http_api.port
            body = _query(port, metric="lat",
                          q="0.5,0.99,count,sum,min,max", t0=0, t1=301)
            res = body["results"]
            assert body["generations"]["count"] == 3
            # EXACT legs: bit-equal to the oracle's flushed values
            assert res["count"] == want["lat.count"] == 600.0
            assert res["sum"] == want["lat.sum"]
            assert res["min"] == want["lat.min"]
            assert res["max"] == want["lat.max"]
            # quantiles: within the engine's error contract of the
            # oracle that merged the same intervals directly
            for q, suffix in ((0.5, "50percentile"),
                              (0.99, "99percentile")):
                got = res["quantiles"][f"{q * 100:g}"]
                ref = want[f"lat.{suffix}"]
                assert abs(got - ref) / max(abs(ref), 1e-9) <= qbound, \
                    (q, got, ref)
            # cardinality: identical register join → EXACT equality
            card = _query(port, metric="users", q="cardinality",
                          t0=0, t1=301)["results"]["cardinality"]
            assert card == want["users"]
            assert abs(card - 900) / 900 <= 0.08
            # counter: exact f64 conservation
            val = _query(port, metric="hits", q="value",
                         t0=0, t1=301)["results"]["value"]
            assert val == want["hits"] == 60.0

            # SUB-WINDOW (intervals 2+3) vs raw-data truth: counts/
            # sums exact by construction, quantiles within contract
            sub = _query(port, metric="lat", q="0.5,0.99,count,sum",
                         t0=150, t1=301)
            wv = np.concatenate(win_vals)
            assert sub["generations"]["count"] == 2
            assert sub["results"]["count"] == float(wv.size)
            assert sub["results"]["sum"] == float(wv.sum())
            for q in (0.5, 0.99):
                got = sub["results"]["quantiles"][f"{q * 100:g}"]
                ref = float(np.quantile(wv, q))
                assert abs(got - ref) / ref <= max(qbound, 0.02), \
                    (q, got, ref)
            subv = _query(port, metric="hits", q="value",
                          t0=150, t1=301)["results"]["value"]
            assert subv == 50.0
            subc = _query(port, metric="users", q="cardinality",
                          t0=150, t1=301)["results"]["cardinality"]
            assert abs(subc - 600) / 600 <= 0.08
            # error contract is echoed with the answer
            assert "error_contract" in body["engines"]["histogram"]
        finally:
            for s in (hist, oracle):
                if s is not None:
                    s.stop()
            shutil.rmtree(d, ignore_errors=True)

    def test_window_errors_and_cache(self):
        d = tempfile.mkdtemp()
        hist = None
        try:
            hist, _ = _mk_global(durability_dir=d)
            port = hist.http_api.port
            # nothing flushed yet: 404, not an invented zero
            with pytest.raises(urllib.error.HTTPError) as ei:
                _query(port, metric="x", q="count", t0=0, t1=10)
            assert ei.value.code == 404
            hist.flush_once(timestamp=100)
            body = _query(port, metric="nothere", q="count",
                          t0=0, t1=101)
            assert body["matched_keys"] == 0
            assert body["cache"] == "miss"
            body = _query(port, metric="nothere", q="count",
                          t0=0, t1=101)
            assert body["cache"] == "hit"
            # bad q spec: 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                _query(port, metric="x", q="p99", t0=0, t1=101)
            assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                _query(port, metric="x", q="count", t0=5, t1=5)
            assert ei.value.code == 400
        finally:
            if hist is not None:
                hist.stop()
            shutil.rmtree(d, ignore_errors=True)

    def test_survives_restart_and_continues_timeline(self):
        """Generations persist across a restart; the next incarnation
        continues the timeline (no overlap, no gap claims) and serves
        cross-restart windows."""
        d = tempfile.mkdtemp()
        srv = None
        try:
            srv, _ = _mk_global(durability_dir=d)
            port = srv.http_api.port
            _post_import(port, [{"name": "r.c", "type": "counter",
                                 "value": 3}])
            assert srv.drain(20.0)
            srv.flush_once(timestamp=100)
            srv.stop()
            srv, _ = _mk_global(durability_dir=d)
            port = srv.http_api.port
            _post_import(port, [{"name": "r.c", "type": "counter",
                                 "value": 4}])
            assert srv.drain(20.0)
            srv.flush_once(timestamp=200)
            es = srv._history.entries()
            assert [e.gen for e in es] == [1, 2]
            assert es[1].prev_close_ns == es[0].close_ns
            got = _query(port, metric="r.c", q="value", t0=0, t1=201)
            assert got["results"]["value"] == 7.0
            got = _query(port, metric="r.c", q="value", t0=101, t1=201)
            assert got["results"]["value"] == 4.0
        finally:
            if srv is not None:
                srv.stop()
            shutil.rmtree(d, ignore_errors=True)

    def test_tags_filter_canonicalizes_to_sorted_join(self):
        """A caller's unsorted tags= spelling must match the engine's
        sorted-joined key (and pin the SAME digest route on the
        fast path) — not silently return matched_keys=0."""
        d = tempfile.mkdtemp()
        srv = None
        try:
            srv, _ = _mk_global(durability_dir=d)
            port = srv.http_api.port
            _post_import(port, [{"name": "tg.c", "type": "counter",
                                 "tags": ["b:2", "a:1"], "value": 6}])
            assert srv.drain(20.0)
            srv.flush_once(timestamp=100)
            for spelled in ("a:1,b:2", "b:2,a:1"):
                got = _query(port, metric="tg.c", q="value",
                             type="counter", tags=spelled, t0=0, t1=101)
                assert got["matched_keys"] == 1, spelled
                assert got["results"]["value"] == 6.0
                assert got["tags"] == "a:1,b:2"   # canonical echo
        finally:
            if srv is not None:
                srv.stop()
            shutil.rmtree(d, ignore_errors=True)

    def test_idle_ticks_coalesce_into_one_empty_generation(self):
        """An idle import tier must not write a segment + fsyncs per
        tick: provably-empty intervals seal as manifest-row-only
        generations, CONSECUTIVE ones coalesce into one row whose
        close stamp extends, a long idle stretch consumes one
        retention slot (never evicting data generations), and queries
        over the idle window still resolve (empty), not 404."""
        d = tempfile.mkdtemp()
        srv = None
        try:
            srv, _ = _mk_global(durability_dir=d)
            port = srv.http_api.port
            for i in range(4):          # fresh server: all idle
                srv.flush_once(timestamp=100 * (i + 1))
            es = srv._history.entries()
            assert len(es) == 1 and es[0].nbytes == 0
            assert es[0].close_ns == 400 * 10**9
            segs = [f for f in os.listdir(d) if f.endswith(".seg")]
            assert segs == []           # zero segment files written
            body = _query(port, metric="idle.x", q="count",
                          t0=150, t1=350)
            assert body["matched_keys"] == 0       # resolves, empty
            # data arrives: a real generation follows the empty one
            _post_import(port, [{"name": "idle.c", "type": "counter",
                                 "value": 4}])
            assert srv.drain(20.0)
            srv.flush_once(timestamp=500)
            srv.flush_once(timestamp=600)   # ops landed at 500 flush
            es = srv._history.entries()
            assert [e.nbytes == 0 for e in es][:1] == [True]
            assert any(e.nbytes > 0 for e in es)
            got = _query(port, metric="idle.c", q="value",
                         t0=0, t1=601)
            assert got["results"]["value"] == 4.0
            # survives a reload bit-exact
            before = [(e.gen, e.close_ns, e.prev_close_ns, e.nbytes)
                      for e in es]
            srv.stop()
            srv, _ = _mk_global(durability_dir=d)
            after = [(e.gen, e.close_ns, e.prev_close_ns, e.nbytes)
                     for e in srv._history.entries()]
            assert after == before
        finally:
            if srv is not None:
                srv.stop()
            shutil.rmtree(d, ignore_errors=True)

    def test_corrupt_generation_answers_only_from_committed(self):
        """The fuzz contract at the QUERY level: bit-flip one
        generation's segment, restart — the query tier resolves only
        the committed survivors (the corrupt interval drops out of
        every window loudly at open, counted; it is never silently
        folded into an answer)."""
        d = tempfile.mkdtemp()
        srv = None
        try:
            srv, _ = _mk_global(durability_dir=d)
            port = srv.http_api.port
            for i in range(3):
                _post_import(port, [{"name": "fz.c", "type": "counter",
                                     "value": 10 ** i}])
                assert srv.drain(20.0)
                srv.flush_once(timestamp=100 * (i + 1))
            full = _query(port, metric="fz.c", q="value", t0=0, t1=301)
            assert full["results"]["value"] == 111.0
            srv.stop()
            seg = os.path.join(d, f"engine.history.{2:016d}.seg")
            data = bytearray(open(seg, "rb").read())
            data[len(data) // 2] ^= 0x10
            with open(seg, "wb") as f:
                f.write(bytes(data))
            srv, _ = _mk_global(durability_dir=d)
            port = srv.http_api.port
            assert [e.gen for e in srv._history.entries()] == [1, 3]
            got = _query(port, metric="fz.c", q="value", t0=0, t1=301)
            # generation 2's 10.0 is gone WITH its generation — the
            # answer spans only committed intervals, never a silent
            # partial read of a corrupt one
            assert got["results"]["value"] == 101.0
            assert got["generations"]["count"] == 2
        finally:
            if srv is not None:
                srv.stop()
            shutil.rmtree(d, ignore_errors=True)

    def test_resharded_history_refused_loudly(self):
        """History sealed under one engine count queried under another
        must refuse (500), never re-route ops by the new modulus into
        a confidently-wrong answer — the same stance crash recovery
        takes on an engine-count mismatch."""
        d = tempfile.mkdtemp()
        srv = None
        try:
            srv, _ = _mk_global(durability_dir=d)   # num_workers 1
            port = srv.http_api.port
            _post_import(port, [{"name": "rs.c", "type": "counter",
                                 "value": 3}])
            assert srv.drain(20.0)
            srv.flush_once(timestamp=100)
            srv.stop()
            srv, _ = _mk_global("num_workers: 2\n", durability_dir=d)
            port = srv.http_api.port
            with pytest.raises(urllib.error.HTTPError) as ei:
                _query(port, metric="rs.c", q="value", t0=0, t1=101)
            assert ei.value.code == 500
            assert "engine" in json.loads(ei.value.read())["error"]
        finally:
            if srv is not None:
                srv.stop()
            shutil.rmtree(d, ignore_errors=True)

    def test_multi_worker_engine_routing(self):
        """num_workers 2: reconstruction routes each op's share by the
        SAME digest modulus the live tier used — totals conserve
        across both engines' groups."""
        d = tempfile.mkdtemp()
        srv = None
        try:
            srv, _ = _mk_global("num_workers: 2\n", durability_dir=d)
            port = srv.http_api.port
            batch = [{"name": f"mw.c{i}", "type": "counter",
                      "value": i + 1} for i in range(8)]
            _post_import(port, batch)
            assert srv.drain(20.0)
            srv.flush_once(timestamp=100)
            total = 0.0
            for i in range(8):
                got = _query(port, metric=f"mw.c{i}", q="value",
                             t0=0, t1=101)
                assert got["results"]["value"] == float(i + 1)
                total += got["results"]["value"]
            assert total == 36.0
        finally:
            if srv is not None:
                srv.stop()
            shutil.rmtree(d, ignore_errors=True)


def _post_import(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/import",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=10).read()


# ------------------------------------------------------- isolation


class TestReadPathIsolation:
    def test_query_completes_with_every_live_lock_held(self):
        """The deterministic isolation proof: hold EVERY live engine's
        ingest/flush lock and run a full (uncached) query — it can
        only complete if the read path never touches them."""
        d = tempfile.mkdtemp()
        srv = None
        try:
            srv, _ = _mk_global(durability_dir=d)
            port = srv.http_api.port
            _post_import(port, [{"name": "iso.c", "type": "counter",
                                 "value": 5}])
            assert srv.drain(20.0)
            srv.flush_once(timestamp=100)
            for eng in srv.engines:
                assert eng.lock.acquire(timeout=5)
            try:
                got = _query(port, metric="iso.c", q="value",
                             t0=0, t1=101)
                assert got["results"]["value"] == 5.0
                assert got["cache"] == "miss"
            finally:
                for eng in srv.engines:
                    eng.lock.release()
        finally:
            if srv is not None:
                srv.stop()
            shutil.rmtree(d, ignore_errors=True)

    def test_query_tick_in_ring_with_phase_attribution(self):
        d = tempfile.mkdtemp()
        srv = None
        try:
            srv, _ = _mk_global(durability_dir=d)
            port = srv.http_api.port
            _post_import(port, [{"name": "ph.c", "type": "counter",
                                 "value": 1}])
            assert srv.drain(20.0)
            srv.flush_once(timestamp=100)
            _query(port, metric="ph.c", q="value", t0=0, t1=101)
            ticks = srv.flight.snapshot()
            qticks = [t for t in ticks if any(
                p["name"] == "query" for p in t["phases"])]
            assert qticks, "query tick missing from the ring"
            t = qticks[0]
            by_name = {p["name"]: p for p in t["phases"]}
            root = by_name["query"]
            for ph in ("query.resolve", "query.restore",
                       "query.merge", "query.estimate"):
                assert ph in by_name, ph
                assert by_name[ph]["parent"] == t["phases"].index(root)
            covered = sum(
                p["end_ns"] - p["start_ns"] for p in t["phases"]
                if p["name"].startswith("query.")
                and p["end_ns"] is not None)
            dur = root["end_ns"] - root["start_ns"]
            assert dur > 0
            assert covered / dur >= 0.95, (covered, dur)
        finally:
            if srv is not None:
                srv.stop()
            shutil.rmtree(d, ignore_errors=True)

    def test_concurrent_queries_leave_flush_exact(self):
        """Queries hammering the tier during ingest + flushes change
        nothing: every flushed counter total stays exact (the no-query
        oracle value), every query response stays well-formed."""
        d = tempfile.mkdtemp()
        srv = None
        try:
            srv, cap = _mk_global(durability_dir=d)
            port = srv.http_api.port
            errs: list = []

            def hammer():
                for _ in range(4):
                    try:
                        _query(port, metric="st.c", q="value",
                               t0=0, t1=10_000)
                    except urllib.error.HTTPError as e:
                        if e.code != 404:
                            errs.append(e)
                    except Exception as e:    # pragma: no cover
                        errs.append(e)
            _post_import(port, [{"name": "st.c", "type": "counter",
                                 "value": 2}])
            assert srv.drain(20.0)
            srv.flush_once(timestamp=100)
            ths = [threading.Thread(target=hammer) for _ in range(3)]
            for t in ths:
                t.start()
            total = 2.0
            for i in range(3):
                _post_import(port, [{"name": "st.c", "type": "counter",
                                     "value": 7 + i}])
                total += 7 + i
                assert srv.drain(20.0)
                srv.flush_once(timestamp=200 + 100 * i)
            for t in ths:
                t.join(60)
            assert not errs
            got = _query(port, metric="st.c", q="value", t0=0, t1=501)
            assert got["results"]["value"] == total
            flushed = sum(m.value for m in cap.all_metrics
                          if m.name == "st.c")
            assert flushed == total
        finally:
            if srv is not None:
                srv.stop()
            shutil.rmtree(d, ignore_errors=True)


# --------------------------------------------- against the reference

_QSPECS = ["0.5,0.99,count,sum", "cardinality", "value", "0.999",
           " 0.25 , max ,min,avg", "0.5,0.5,0.1", "count,value,0.75",
           "1.5", "p99", "", "0", "1", "nan", "0.5,bogus"]


@pytest.mark.parametrize("raw", _QSPECS)
def test_parse_qspec_matches_the_reference(raw):
    from veneur_tpu.durability import history as jhist
    try:
        want = jhist.parse_qspec(raw)
    except jhist.QueryError as e:
        with pytest.raises(QueryError) as ei:
            parse_qspec(raw)
        assert (ei.value.status, ei.value.detail) == (e.status, e.detail)
    else:
        assert parse_qspec(raw) == want


def _seeded_bodies(rng, i):
    """Interval i's jsonmetric-v1 body: a timer digest of integer
    samples (every count/sum exact in f32 on both sides), a counter and
    a set's HLL registers (p=14)."""
    vals = rng.integers(1, 1000, 300).astype(np.float32)
    uniq, cnt = np.unique(vals, return_counts=True)
    regs = np.zeros(1 << 14, np.uint8)
    idx = rng.integers(0, 1 << 14, 400 * (i + 1))
    np.maximum.at(regs, idx, rng.integers(1, 12, idx.size).astype(np.uint8))
    body = [
        {"name": "lat", "type": "timer", "tags": [],
         "histogram": {"centroids": [[float(m), float(w)]
                                     for m, w in zip(uniq, cnt)],
                       "min": float(vals.min()), "max": float(vals.max()),
                       "sum": float(vals.astype(np.float64).sum()),
                       "count": float(vals.size),
                       "reciprocal_sum": float((1.0 / vals).sum())}},
        {"name": "hits", "type": "counter", "tags": ["t:a"],
         "value": 10 * (i + 1)},
        {"name": "users", "type": "set", "tags": [],
         "set": regs.tobytes().hex()},
    ]
    return body, vals


def _post_enveloped(port, body, seq):
    from veneur_tpu_torch.cluster.wire import envelope_headers
    headers = {"Content-Type": "application/json",
               "X-Veneur-Forward-Version": "jsonmetric-v1"}
    headers.update(envelope_headers("ref-vs-port", seq, 0, 1))
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/import", data=json.dumps(body).encode(),
        headers=headers, method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def _get(port, qs):
    try:
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}/query?{qs}",
                                   timeout=60)
        return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture(scope="module")
def twin_globals():
    """A reference durable global and a port durable global fed the
    same three intervals of journaled imports (the same bodies under
    the same envelopes), each interval sealed at the same scripted
    close; yields their HTTP ports and the samples a window holds."""
    from veneur_tpu.config import read_config as jread_config
    from veneur_tpu.server import Server as JServer
    from veneur_tpu.sinks.basic import CaptureMetricSink as JCapture
    d = tempfile.mkdtemp()
    extra = ("http_address: \"127.0.0.1:0\"\nis_global: true\n"
             "durability_enabled: true\nhistory_retention_generations: 8\n"
             "durability_fsync: never\n")
    srvs = []
    try:
        jtext = _BASE.replace("aggregation_backend: cpu\n", "") + extra
        jsrv = JServer(jread_config(
            text=jtext + f"durability_dir: \"{d}/ref\"\n"),
            sinks=[JCapture()], plugins=[], span_sinks=[])
        jsrv.start()
        srvs.append(jsrv)
        tsrv = Server(read_config(
            text=_BASE + extra + f"durability_dir: \"{d}/port\"\n"),
            sinks=[CaptureMetricSink()], plugins=[], span_sinks=[])
        tsrv.start()
        srvs.append(tsrv)
        rng = np.random.default_rng(14)
        samples = []
        for i in range(3):
            body, vals = _seeded_bodies(rng, i)
            samples.append(vals)
            for s in srvs:
                assert _post_enveloped(s.http_api.port, body, i + 1) == \
                    {"imported": 3}
                assert s.drain(60.0)
                s.flush_once(timestamp=100 + 100 * i)
        yield srvs[0].http_api.port, srvs[1].http_api.port, samples
    finally:
        for s in srvs:
            s.stop()
        shutil.rmtree(d, ignore_errors=True)


_WINDOWS = [(0, 301), (150, 301), (0, 101), (101, 201), (250, 10**6)]


@pytest.mark.parametrize("t0,t1", _WINDOWS)
def test_port_query_answers_as_the_reference(twin_globals, t0, t1):
    jport, tport, samples = twin_globals
    qs = f"metric=lat&q=0.5,0.99,count,sum,min,max,avg&t0={t0}&t1={t1}"
    (jc, jb), (tc, tb) = _get(jport, qs), _get(tport, qs)
    assert (tc, jc) == (200, 200)
    assert tb["generations"] == jb["generations"]
    assert tb["matched_keys"] == jb["matched_keys"] == 1
    jr, tr = jb["results"], tb["results"]
    for k in ("count", "sum", "min", "max"):
        assert tr[k] == jr[k], k
    assert tr["avg"] == pytest.approx(jr["avg"], rel=1e-6)
    gens = range(tb["generations"]["first"] - 1,
                 tb["generations"]["last"])
    v = np.concatenate([samples[g] for g in gens])
    assert tr["count"] == float(v.size)
    spread = float(v.max() - v.min())
    for q in jr["quantiles"]:
        assert abs(tr["quantiles"][q] - jr["quantiles"][q]) \
            <= 0.01 * spread, q
    for metric, q, rel in (("hits", "value", 0.0),
                           ("users", "cardinality", 1e-5)):
        qs = f"metric={metric}&q={q}&t0={t0}&t1={t1}"
        (jc, jb), (tc, tb) = _get(jport, qs), _get(tport, qs)
        assert (tc, jc) == (200, 200)
        want = jb["results"][q]
        assert tb["results"][q] == pytest.approx(want, rel=rel), metric
    assert _get(tport, f"metric=hits&q=value&type=counter&tags=t:a"
                       f"&t0={t0}&t1={t1}")[1]["results"] == \
        _get(jport, f"metric=hits&q=value&type=counter&tags=t:a"
                    f"&t0={t0}&t1={t1}")[1]["results"]


@pytest.mark.parametrize("qs", [
    "metric=lat&q=count&t0=400&t1=500",      # after the newest close
    "metric=lat&q=p99&t0=0&t1=301",
    "metric=lat&q=count&t0=5&t1=5",
    "q=count&t0=0&t1=301",
    "metric=lat&q=count&t1=301",
    "metric=lat&q=count&t0=0&t1=301&type=gauge",
    "metric=nothere&q=count&t0=0&t1=301"])
def test_port_query_errors_as_the_reference(twin_globals, qs):
    jport, tport, _ = twin_globals
    (jc, jb), (tc, tb) = _get(jport, qs), _get(tport, qs)
    assert tc == jc
    if jc != 200:
        assert tb == jb
    else:
        assert tb["matched_keys"] == jb["matched_keys"]
