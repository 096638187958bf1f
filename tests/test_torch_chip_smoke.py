"""chip_smoke.py's phases 4-9 rehearsed on the CPU at small shapes.

On the CPU every kernel wrapper runs its plain version, so these show
that the script's cases, checks, timings and reports run end to end and
hold the port to numpy truth; the kernels themselves are held against
their plain versions only on the card (`python3 chip_smoke.py`).
"""

import pytest
import torch

import chip_smoke as cs

CPU = torch.device("cpu")
SMALL = {"histogram_slots": 2048, "counter_slots": 512, "gauge_slots": 512,
         "set_slots": 64, "batch_size": 256}
PLAN = {"A": {"datagrams": 300, "histos": (1200, 5), "counters": 200,
              "gauges": 200, "sets": (20, 1000)},
        "B": {"datagrams": 100, "histos": (1700, 2), "counters": 50},
        "C": {"datagrams": 100, "histos": (100, 4), "hot": 3000},
        "D": {}}


def test_phase_ull_insert_cases():
    out = cs.phase_ull_insert(CPU, K=16, m=256, n=4096, n_landing=4096)
    cases = ("serving", "offset_views", "landing", "one_word",
             "one_word_landing", "key_edges")
    assert set(out) == set(cases) | {"max_abs_err"}
    for c in cases:
        assert out[c]["bytes_differing"] == 0, c
        assert out[c]["relanding_changes"] == 0, c
    assert out["offset_views"]["n"] == 4095
    assert out["landing"]["n"] == 4096
    assert out["one_word"]["bytes_changed_by_the_batch"] <= 4


@pytest.mark.parametrize("path", list(cs.PATHS))
def test_phase_main_times_set_ingest(path):
    plan = dict(PLAN)
    if path == "req+ull":
        plan["C"] = {**plan["C"], "hot_normal": True}
    out = cs.phase_main(CPU, path, cfg_kw=SMALL, plan=plan)
    a = out["intervals"]["A"]
    assert a["set_updates"] == 20 * 1000
    assert a["set_updates_fed"] == 20 * 1000 + 60   # 60 datagram sets
    assert a["set_ingest_ms"] > 0 and a["set_updates_per_s"] > 0
    assert all(rec["equal_to_full_flush"]
               for rec in out["intervals"].values())
    # the wrappers run their plain versions here and count nothing
    assert all(n == 0 for n in out["launches"].values())


def test_phase_timing_reports_both_insert_shapes_and_routes():
    routes = ({"set_slots": 64, "batch_size": 256, "histogram_slots": 64,
               "counter_slots": 8, "gauge_slots": 8}, 8, 600, 1)
    out = cs.phase_timing(CPU, K=64, C=32, B=32, KS=16, m=256, mu=256,
                          n=4096, n_landing=8192, reps=(2, 1, 2),
                          routes=routes)
    assert out["ull_insert"]["shape"] == [16, 256, 4096]
    assert out["ull_insert_landing"]["shape"] == [16, 256, 8192]
    assert out["ull_insert_one_word"]["shape"] == [16, 256, 8192]
    for name in ("ull_insert", "ull_insert_landing", "ull_insert_one_word"):
        t = out[name]
        assert t["bound_by"] == "bytes" and t["bound_ms"] > 0
        assert t["ms"] > 0 and t["plain_ms"] > 0
    r = out["set_routes"]
    assert (r["updates"], r["batch"], r["capacity"]) == (8 * 600, 256,
                                                         16 * 256)
    for route in ("old", "new"):
        assert r[route]["ms"] > 0 and r[route]["updates_per_s"] > 0
    assert 0 < r["new"]["loop_ms"] <= r["new"]["ms"]
    assert set(r["host_us_a_batch"]) == {"mark_dirty", "append"}


def test_phase_server_rehearsal():
    """Phase 7 at small widths and traffic: the port's Server on the CPU
    over real UDP, its rows against numpy truth, its HTTP routes and its
    stop (the launch check runs on the card only)."""
    plan = {"timers": (300, 10), "counters": (100, 4), "gauges": 100,
            "sets": (20, 100), "checks": 10, "events": 3}
    cfg_kw = {"tpu_histogram_slots": 1024, "tpu_counter_slots": 256,
              "tpu_gauge_slots": 256, "tpu_set_slots": 64,
              "tpu_batch_size": 256}
    out = cs.phase_server(CPU, cfg_kw=cfg_kw, plan=plan)
    assert out["lines"] == 3000 + 400 + 100 + 2000 + 10 + 3 + 1
    assert out["datagrams"] < out["lines"] / 20
    assert out["datagrams_per_s"] > 0 and out["lines_per_s"] > 0
    for label in ("S1", "S2"):
        assert out[label]["total_duration_ns"] > 0
        assert set(out[label]) == {"total_duration_ns", "swap_duration_ns",
                                   "merge_duration_ns",
                                   "assembly_duration_ns", "rows", "gc_ms"}
        assert out[label]["gc_ms"] >= 0
    assert set(cs.ENGINE_PHASES) <= set(out["tick1_phases"])
    assert out["health"] == "ok" and out["stop_s"] < 10
    # the wrappers run their plain versions here and count nothing
    assert all(n == 0 for n in out["launches"].values())
    assert set(out["launches_by_step"]) == set(cs.SERVER_LAUNCHES)


def test_phase_server_cli_rehearsal():
    """Phase 7's daemon step on the CPU: the CLI in a subprocess takes one
    burst over UDP, flushes it to its file and exits 0 on SIGTERM."""
    out = cs.phase_server_cli(CPU, cfg_kw={
        "tpu_histogram_slots": 256, "tpu_counter_slots": 128,
        "tpu_gauge_slots": 128, "tpu_set_slots": 64, "tpu_batch_size": 256})
    assert out["exit_code"] == 0 and out["datagrams"] >= 2
    assert out["start_s"] > 0


SSF_PLAN = {"udp_spans": 1000, "udp_keys": (200, 100, 20, 50),
            "tcp_spans": 100, "tcp_keys": (50, 20, 10, 10),
            "indicator_every": 10, "app_counters": (100, 4),
            "app_timers": (50, 10), "storm": 2000, "budget": 256}


def test_phase_ssf_overload_rehearsal():
    """Phase 8 at small widths and traffic: the port's Server on the CPU
    with SSF over UDP and TCP, self-tracing, the overload defense and a
    profiler capture of T1's flush; rows against numpy truth, the storm's
    fold against the budget, the accounting identity and a clean stop
    (the launch check and compress_kernel in the trace: on the card)."""
    cfg_kw = {"tpu_histogram_slots": 1024, "tpu_counter_slots": 1024,
              "tpu_gauge_slots": 256, "tpu_set_slots": 64,
              "tpu_batch_size": 256}
    out = cs.phase_ssf_overload(CPU, cfg_kw=cfg_kw, plan=SSF_PLAN)
    assert (out["udp_spans"], out["tcp_spans"]) == (1000, 100)
    assert out["folded"] == 2000 - 256
    assert out["samples_sent"] == (4 * 1100 + 110 + 900 + 2000 + 2)
    for k in ("udp_spans_per_s", "udp_samples_per_s", "tcp_spans_per_s",
              "tcp_samples_per_s", "storm_datagrams_per_s"):
        assert out[k] > 0, k
    for label in ("T1", "T2"):
        assert set(out[label]) == {
            "total_duration_ns", "swap_duration_ns", "merge_duration_ns",
            "assembly_duration_ns", "overload_phase_ms", "gc_ms", "rows"}
        assert out[label]["overload_phase_ms"] > 0
    assert out["T2_spans_received"] > 0
    assert out["profile_trace_bytes"] > 0 and out["stop_s"] < 10
    # the wrappers run their plain versions here and count nothing
    assert all(n == 0 for n in out["launches"].values())
    assert set(out["launches_by_step"]) == set(cs.SSF_LAUNCHES)


def test_ssf_launch_table_is_whole():
    """Every step of phase 8's table names every kernel, as phase 7's
    does, and the kernels line's launches sum phases 5, 7 and 8."""
    names = {k[0] for k in cs.KERNELS}
    for table in (cs.SERVER_LAUNCHES, cs.SSF_LAUNCHES):
        assert list(table)[:2] == ["construction", "ingest"]
        assert len(table) == 4
        assert all(set(step) == names for step in table.values())
    assert sum(s["probe"] for s in cs.SSF_LAUNCHES.values()) == 1
    assert sum(s["ull_insert"] for s in cs.SSF_LAUNCHES.values()) == 0
    assert cs.SSF_LAUNCHES["ingest"]["compress"] == 2


GLOBAL_PLAN = {"locals": 4, "timers": (300, 25), "counters": (50, 4),
               "gauges": 50, "sets": (10, 200, 100), "local_timers": (5, 25),
               "hot_senders": 12, "hot_samples": 2000, "touch": 0.1,
               "req_locals": 2, "req_timers": (100, 25),
               "req_sets": (10, 200, 100)}


@pytest.fixture
def one_torch_thread():
    """Many small tensor ops: one intra-op thread, so the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase_global_rehearsal(monkeypatch, one_torch_thread):
    """Phase 9 at small widths and traffic: port locals' exports over the
    wire into a port global, G1-G4, rows against numpy truth. The import
    cap sits at its floor (2C) so the small hot pile takes both re-chunk
    arms, as the full plan's does at the real cap (the launch check: on
    the card)."""
    from veneur_tpu_torch.models import pipeline
    monkeypatch.setattr(pipeline, "_IMPORT_W_CAP", 1)
    cfg_kw = {"histogram_slots": 512, "counter_slots": 128,
              "gauge_slots": 128, "set_slots": 32, "batch_size": 1024}
    out = cs.phase_global(CPU, cfg_kw=cfg_kw, plan=GLOBAL_PLAN,
                          hot_cfg_kw={"batch_size": 1024})
    steps = out["steps"]
    assert list(steps) == ["G1", "G2", "G3", "G4"]
    for label in ("G1", "G2"):
        rec = steps[label]
        arms = {a for land in rec["landings"] for a in land["arms"]}
        assert arms == {0, 256}
        assert rec["import"]["metrics"] == 4 * (300 + 1 + 50 + 50 + 10) + 12
        assert rec["flush"]["path"] == "incremental"
        assert rec["worst"]["pct_err_over_spread"] <= 0.01 + 1e-6
        assert rec["small_senders"]["n"] == 12
        assert all(loc["metrics"] == 411 for loc in rec["locals"])
    assert steps["G3"]["import"]["metrics"] == 4 * (5 + 1)
    assert all(loc["forward_kind"] == "delta"
               for loc in steps["G3"]["locals"])
    assert steps["G4"]["landings"][0]["arms"] == []
    cs.print_global_timings(out, "cpu")
    # the wrappers run their plain versions here and count nothing
    assert all(n == 0 for n in out["launches"].values())
    assert set(out["launches_by_step"]) == set(cs.GLOBAL_LAUNCHES)


def test_global_launch_table_follows_the_plan():
    """Every step of phase 9's table names every kernel, and its counts
    follow from GLOBAL_PLAN as PERF.md derives them: three compresses
    and two hll_stats a sender in G1 (the hot-slot sidestep, the baseline
    rows and the work set), two compresses a landing (every 8192 staged
    digests at import, the remainder in the flush), 7 + 1 ull_insert
    launches a req+ull local."""
    from veneur_tpu_torch.models import pipeline
    names = {k[0] for k in cs.KERNELS}
    table = cs.GLOBAL_LAUNCHES
    assert all(set(step) == names for step in table.values())
    p = cs.GLOBAL_PLAN
    senders = p["locals"] + p["hot_senders"]
    assert table["G1 locals"] == {"compress": 3 * senders,
                                  "hll_stats": 2 * senders,
                                  "ull_insert": 0, "probe": senders}
    assert table["G2 locals"] == {"compress": 2 * senders,
                                  "hll_stats": senders, "ull_insert": 0,
                                  "probe": 0}
    digests = p["locals"] * (p["timers"][0] + 1) + p["hot_senders"]
    landings = digests // pipeline._IMPORT_STAGE_DIGESTS
    assert digests % pipeline._IMPORT_STAGE_DIGESTS
    for label in ("G1", "G2"):
        assert table[f"{label} import"]["compress"] == 2 * landings
    assert table["G1 flush"]["compress"] == 2 + 2
    assert table["G2 flush"]["compress"] == 2 + 1
    assert table["G4 locals"]["ull_insert"] == 8 * p["req_locals"]
    assert sum(s["probe"] for s in table.values()) == senders + 1 + 3
