"""The port's spans and counters for threads that are not flush ticks
(observe/recorder.py's SpanRing, the native pump's cycles, the collector
hook) and the flush tick's CPU time, on the CPU. The bridge tests need
g++ (the port builds native/vtpu_ingest.cpp on first use)."""

import gc
import os
import re
import threading
import time

import numpy as np
import pytest

from veneur_tpu_torch import observe
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.ingest import native
from veneur_tpu_torch.models.pipeline import AggregationEngine, EngineConfig
from veneur_tpu_torch.observe.recorder import GC_PHASE, SpanRing
from veneur_tpu_torch.server import Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ the ring


def test_span_ring_keeps_its_capacity_and_counts_what_it_overwrote():
    ring = SpanRing(4, ("a", "b"))
    for i in range(3):
        ring.record(10 * i, 10 * i + 5, i, -i)
    t, f = ring.entries()
    assert t.tolist() == [[0, 5], [10, 15], [20, 25]]
    assert f.tolist() == [[0, 0], [1, -1], [2, -2]]
    assert ring.overwritten == 0
    arrays = (ring._t, ring._f)
    for i in range(3, 7):
        ring.record(10 * i, 10 * i + 5, i, -i)
    t, f = ring.entries()
    assert len(t) == ring.capacity == 4
    assert t[:, 0].tolist() == [30, 40, 50, 60]      # the oldest went
    assert f[:, 0].tolist() == [3, 4, 5, 6]
    assert ring.count == 7 and ring.overwritten == 3
    assert ring._t is arrays[0] and ring._f is arrays[1]   # no new rows
    s = ring.summary(last=2)
    assert s["recorded"] == 7 and s["overwritten"] == 3
    assert s["last"] == [{"start_ns": 50, "end_ns": 55, "a": 5, "b": -5},
                         {"start_ns": 60, "end_ns": 65, "a": 6, "b": -6}]


def test_span_ring_window_is_none_once_the_window_is_overwritten():
    ring = SpanRing(4, ("n",))
    for i in range(6):
        ring.record(10 * i, 10 * i + 5, i)
    got = ring.window(35, 52)
    assert got is not None
    assert got[0][:, 0].tolist() == [30, 40, 50]
    assert ring.window(25, 60)[0][:, 0].tolist() == [20, 30, 40, 50]
    assert ring.window(12, 60) is None          # the row at 10 is gone
    fresh = SpanRing(4, ("n",))
    fresh.record(100, 105, 1)
    assert fresh.window(0, 200)[1].tolist() == [[1]]   # nothing was lost


def test_span_ring_drops_a_row_a_write_may_have_torn():
    ring = SpanRing(3, ("n",))
    for i in range(3):
        ring.record(i, i + 1, i)
    ring._pending = True         # a write in progress on another thread
    t, _ = ring.entries()
    assert t[:, 0].tolist() == [1, 2]


def test_span_ring_reader_never_sees_a_torn_row():
    """One writer records rows whose every column is its sequence number
    while readers copy the ring, the switch interval shortened so that
    threads interleave inside a row's stores: every row a reader gets is
    whole, and the rows are consecutive."""
    import sys
    ring = SpanRing(16, ("a", "b", "c"))
    stop = threading.Event()
    bad = []

    def write():
        seq = 1
        while not stop.is_set():
            ring.record(seq, seq, seq, seq, seq)
            seq += 1

    def read():
        while not stop.is_set():
            t, f = ring.entries()
            rows = np.concatenate([t, f], axis=1)
            if len(rows) and not ((rows == rows[:, :1]).all()
                                  and (np.diff(rows[:, 0]) == 1).all()):
                bad.append(rows)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=write)] + [
        threading.Thread(target=read) for _ in range((os.cpu_count() or 2)
                                                     + 2)]
    try:
        for th in threads:
            th.start()
        time.sleep(1.0)
    finally:
        stop.set()
        for th in threads:
            th.join(10)
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert ring.count > ring.capacity
    assert not bad, bad[0]


# ------------------------------------------------------------ the pump


class _FakeBridge:
    """A bridge whose rings hold `backlog[bank]` samples."""

    def __init__(self, backlog):
        self.backlog = dict(backlog)

    def poll(self, bank, slots, a, b, c):
        n = min(self.backlog.get(bank, 0), len(slots))
        self.backlog[bank] = self.backlog.get(bank, 0) - n
        slots[:n] = np.arange(n) % 8
        a[:n] = 1.0
        b[:n] = 1.0
        c[:n] = 1
        return n

    def drain_new_keys(self):
        return []

    def drain_other(self):
        return []

    def drain_ssf_other(self):
        return []


class _View:
    def mark(self, slots):
        pass


def _engine():
    return AggregationEngine(EngineConfig(
        histogram_slots=16, counter_slots=16, gauge_slots=16,
        set_slots=16, batch_size=64, hll_precision=10), device="cpu")


def _pump(backlog, **kw):
    ring = SpanRing(64, native.PUMP_FIELDS)
    views = {b: _View() for b in ("histo", "counter", "gauge", "set")}
    pump = native.NativePump(_FakeBridge(backlog), _engine(), views,
                             lambda line: None, batch=64, spans=ring, **kw)
    return pump, ring


def test_pump_fills_match_the_bridges_backlog():
    pump, ring = _pump({"histo": 200, "counter": 7, "set": 64},
                       ring_capacity=1024, writers=3)
    assert pump.ring_samples == (1024 // native.RING_WAYS + 1) * 3
    assert pump.pump_once() == 271
    t, f = ring.entries()
    assert f[:, :4].tolist() == [[200, 7, 0, 64]]
    assert 0 <= f[0, 4] < t[0, 1] - t[0, 0]      # no other taker: no wait
    assert t[0, 1] >= t[0, 0] > 0
    assert pump.pump_once() == 0 and ring.count == 1   # idle: no span
    busy, wait, cycles, peak = pump.take_stats()
    assert (cycles, peak) == (1, 200) and busy == t[0, 1] - t[0, 0]
    assert pump.take_stats() == (0, 0, 0, 0)


def test_pump_cycle_records_the_engine_lock_wait():
    pump, ring = _pump({"histo": 10})
    eng = pump.engine
    taken = threading.Event()

    def hold():
        with eng.lock:
            taken.set()
            time.sleep(0.06)

    th = threading.Thread(target=hold)
    th.start()
    taken.wait()
    pump.pump_once()
    th.join()
    (wait,), = ring.entries()[1][:, 4:].tolist()
    assert wait >= 50_000_000
    assert eng.lock_wait_ns >= wait
    assert pump.take_stats()[1] == wait


def test_pump_without_a_ring_stamps_nothing():
    views = {b: _View() for b in ("histo", "counter", "gauge", "set")}
    pump = native.NativePump(_FakeBridge({"counter": 5}), _engine(), views,
                             lambda line: None, batch=64)
    assert pump.pump_once() == 5
    assert pump.take_stats() == (0, 0, 0, 0)


def test_ring_ways_is_the_bridges():
    with open(os.path.join(ROOT, "native", "vtpu_ingest.cpp")) as f:
        src = f.read()
    ways, = re.findall(r"constexpr int RING_WAYS = (\d+);", src)
    assert native.RING_WAYS == int(ways)


def test_one_writers_bank_holds_one_way_of_the_ring():
    """The fill against the bridge's own rings: one thread stages 100
    timer samples into a ring of capacity 8 x 64, whose one way holds
    65; the pump drains those 65 and the bridge drops the other 35."""
    br = native.NativeBridge(histo_slots=8, counter_slots=8, gauge_slots=8,
                             set_slots=8, hll_precision=14, idle_ttl=4,
                             ring_capacity=native.RING_WAYS * 64,
                             max_packet=8192)
    try:
        for i in range(100):
            br.handle_packet(f"t:{i}|ms".encode())
        ring = SpanRing(8, native.PUMP_FIELDS)
        views = {b: native.BridgeKeyView(br, b)
                 for b in ("histo", "counter", "gauge", "set")}
        pump = native.NativePump(br, _engine(), views, lambda line: None,
                                 batch=16, spans=ring,
                                 ring_capacity=native.RING_WAYS * 64,
                                 writers=1)
        assert pump.pump_once() == 65 == pump.ring_samples
        assert br.stats()["ring_drops"] == 35
        assert pump.take_stats()[3] == pump.ring_samples
    finally:
        br.close()


# ------------------------------------------------------- the collector


def test_a_collection_in_a_tick_is_a_gc_phase_and_counted():
    fr = observe.FlightRecorder(capacity=4, max_phases=16)
    fr.collector_start()
    try:
        assert fr.collector_installed()
        tick = fr.begin_tick(100)
        ep = tick.start("engine")
        gc.collect()
        tick.finish(ep)
        fr.end_tick(tick)
        n, pause = fr.collector_totals()
        assert n >= 1 and pause > 0
        d = tick.to_dict()
        gcs = [p for p in d["phases"] if p["name"] == GC_PHASE]
        assert gcs, d["phases"]
        full = [p for p in gcs if p["meta"]["generation"] == 2]
        assert full and full[-1]["parent"] == 0          # inside engine
        assert full[-1]["meta"]["thread"] == threading.current_thread().name
        gc.collect()
        assert fr.collector_totals()[0] > n
        # the dogfood timers skip the collector's phases
        names = {m.key.name for m in observe.phase_timer_samples(tick)}
        assert not any(x.endswith("." + GC_PHASE) for x in names)
        state = fr.debug_state()
        assert state["collector"]["installed"]
        assert state["spans"][GC_PHASE]["recorded"] >= 2
    finally:
        fr.collector_stop()
    assert not fr.collector_installed()
    before = fr.collector_totals()
    gc.collect()
    assert fr.collector_totals() == before


def test_a_tick_finds_its_collections_past_the_newest_rows():
    """A full collection early in a tick, then 600 young ones: the
    graft reaches back past the newest rows to the full one."""
    fr = observe.FlightRecorder(capacity=2, max_phases=16)
    ring = fr.span_ring(GC_PHASE, ("generation", "thread"), 1 << 12)
    tick = fr.begin_tick(1)
    t = tick.mono_start
    ring.record(t + 10, t + 20, 2, threading.get_ident())
    for k in range(600):
        ring.record(t + 30 + k, t + 30 + k, 0, 0)
    fr.end_tick(tick)
    (phase,) = [p for p in tick.to_dict()["phases"] if p["name"] == GC_PHASE]
    assert (phase["start_ns"], phase["end_ns"]) == (10, 20)
    assert phase["meta"]["generation"] == 2


def test_tick_carries_its_cpu_time():
    fr = observe.FlightRecorder(capacity=2, max_phases=8)
    tick = fr.begin_tick(1)
    assert tick.to_dict()["cpu_ns"] is None                # in flight
    sum(i * i for i in range(200_000))
    fr.end_tick(tick)
    d = tick.to_dict()
    assert 0 < d["cpu_ns"] <= d["duration_ns"] + 10_000_000
    assert d["mono_start_ns"] == tick.mono_start


def _cfg(**kw):
    base = dict(statsd_listen_addresses=["udp://127.0.0.1:0"],
                interval="3600s", hostname="h", aggregation_backend="cpu",
                tpu_histogram_slots=64, tpu_counter_slots=64,
                tpu_gauge_slots=64, tpu_set_slots=16, tpu_batch_size=64)
    base.update(kw)
    return Config(**base)


def _self_rows(fs):
    return {m.name: m.value for m in fs.extra
            if m.name.startswith(("veneur.gc.", "veneur.ingest."))}


def test_server_hooks_the_collector_from_start_to_stop():
    srv = Server(_cfg())
    srv.start()
    try:
        hook = srv.flight._collector
        assert hook in gc.callbacks
        gc.collect()
        rows = _self_rows(srv.flush_once(timestamp=1000))
        assert rows["veneur.gc.number"] >= 1
        assert rows["veneur.gc.pause_total_ns"] > 0
        assert not any(k.startswith("veneur.ingest.") for k in rows)
        state = srv._debug_flush_state()["flight_recorder"]
        assert state["collector"]["installed"]
        assert state["ticks"][0]["cpu_ns"] > 0
    finally:
        srv.stop()
    assert hook not in gc.callbacks


def test_server_without_a_recorder_hooks_nothing():
    srv = Server(_cfg(flight_recorder=False))
    n = len(gc.callbacks)
    srv.start()
    try:
        assert len(gc.callbacks) == n
        assert _self_rows(srv.flush_once(timestamp=1000)) == {}
    finally:
        srv.stop()


def test_native_server_reports_the_pumps_cycles():
    srv = Server(_cfg(native_ingest=True, native_ring_capacity=1 << 12))
    srv.start()
    try:
        import socket
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for i in range(40):
                s.sendto(f"p.lat:{i}|ms\np.hits:1|c".encode(),
                         ("127.0.0.1", srv.bound_port()))
        deadline = time.monotonic() + 20
        while srv.native_bridge.stats()["packets"] < 40 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.drain(10)
        rows = _self_rows(srv.flush_once(timestamp=1000))
        assert rows["veneur.ingest.pump_cycles_total"] >= 1
        assert rows["veneur.ingest.pump_busy_ns_total"] > 0
        assert "veneur.ingest.pump_lock_wait_ns_total" in rows
        peak = rows["veneur.ingest.ring_fill_peak"]
        assert 1 <= peak <= 40
        assert rows["veneur.ingest.ring_fill_peak_ratio"] == pytest.approx(
            peak / srv.native_pump.ring_samples)
        pump = srv._debug_flush_state()["flight_recorder"]["spans"]["pump"]
        assert pump["fields"] == list(native.PUMP_FIELDS)
        assert sum(r["histo"] for r in pump["last"]) >= 1
        assert sum(r["histo"] + r["counter"] for r in pump["last"]) <= 80
    finally:
        srv.stop()


# ------------------------------------------- reading a window's spans


def _ns(s):
    return int(s * 1e9)


def _recorded_server(pump_capacity=8):
    """A stand-in for a stopped server: a recorder holding two flush
    ticks at 4 s and 8 s (an engine.swap of 1.2 s each), the pump's
    cycles and the collector's collections."""
    from types import SimpleNamespace
    fr = observe.FlightRecorder(capacity=4, max_phases=16)
    for t0 in (4.0, 8.0):
        tick = fr.begin_tick(int(t0))
        tick.mono_start = _ns(t0)
        tick.add("engine", _ns(t0), _ns(t0 + 1.9))
        tick.add("engine.flush", _ns(t0), _ns(t0 + 1.9), parent=0)
        tick.add("engine.swap", _ns(t0 + 0.6), _ns(t0 + 1.8), parent=1)
        tick.mono_end = _ns(t0 + 2.0)
        tick.cpu_ns = _ns(0.5)
    pumps = fr.span_ring("pump", native.PUMP_FIELDS, pump_capacity)
    pumps.record(_ns(4.1), _ns(4.5), 100, 0, 0, 0, 0)
    pumps.record(_ns(7.1), _ns(8.9), 65_000, 10, 0, 5, _ns(1.5))
    gcs = fr.span_ring(GC_PHASE, ("generation", "thread"), 8)
    gcs.record(_ns(1.2), _ns(2.9), 2, 1)
    gcs.record(_ns(8.7), _ns(8.8), 0, 1)
    return SimpleNamespace(flight=fr, native_pump=SimpleNamespace(
        ring_samples=131_073))


def _window_rec():
    return {"p_w0": 0.0, "p_w1": 10.0,
            "flushes": [{"t0": 3.999, "t1": 6.0}, {"t0": 7.999, "t1": 10.0}]}


def test_the_window_reader_reads_the_programs_spans():
    import trace_window as tw
    got = tw.program_numbers(_recorded_server(), _window_rec(), [])
    assert got["ingest.pump_busy_pct"] == pytest.approx(22.0)
    assert got["ingest.lock_wait_ms"] == pytest.approx(750.0)
    assert got["ingest.ring_peak_pct"] == pytest.approx(
        65_000 / 131_073 * 100)
    assert got["server.flush_cpu_ms"] == pytest.approx(500.0)
    # the collection at 8.7 s falls in the second swap (8.6-9.8 s)
    assert got["engine.swap_gc_ms"] == pytest.approx(50.0)
    assert got["gc.window_collections_by_generation"] == [1, 0, 1]


def test_the_window_reader_reads_nothing_the_rings_lost():
    import trace_window as tw
    srv = _recorded_server(pump_capacity=1)     # the 4.1-s cycle is gone
    got = tw.program_numbers(srv, _window_rec(), [])
    assert not any(k.startswith("ingest.") for k in got)
    assert "server.flush_cpu_ms" in got
    rec = dict(_window_rec(), flushes=[{"t0": 0.5, "t1": 1.0}])
    assert "server.flush_cpu_ms" not in tw.program_numbers(
        _recorded_server(), rec, [])


def test_idle_gaps_take_the_name_of_the_program_span_over_them():
    """Device busy 0-1, 3-4, 6-7 and 9-10 s: the gap at 1-3 s is the
    collector's, the one at 4-6 s the flush's swap (deeper than the
    engine phases around it), the one at 7-9 s a pump cycle that waited
    on the engine lock for most of it."""
    import trace_window as tw
    from portbench import trace as tr

    class Trace:
        def events(self):
            return [("k", float(s), float(s + 1)) for s in (0, 3, 6, 9)]

    srv = _recorded_server()
    fr = srv.flight
    got = tw.named_gaps((Trace(), 0.0, 10.0, "pump"),
                        fr.spans("pump").window(0, _ns(10)),
                        fr.spans(GC_PHASE).entries()[0], fr.snapshot(), tr)
    assert got == [["gc", 2000.0], ["flush:engine.swap", 2000.0],
                   ["pump:lock_wait", 2000.0]]


def test_perf_counter_and_monotonic_ns_read_one_clock():
    """The device trace is mapped onto perf_counter, the program stamps
    monotonic_ns: on Linux both are CLOCK_MONOTONIC."""
    info = {n: time.get_clock_info(n) for n in ("perf_counter", "monotonic")}
    assert info["perf_counter"].implementation == \
        info["monotonic"].implementation == "clock_gettime(CLOCK_MONOTONIC)"
    a = time.monotonic_ns()
    b = time.perf_counter()
    c = time.monotonic_ns()
    assert a - 1000 <= b * 1e9 <= c + 1000
