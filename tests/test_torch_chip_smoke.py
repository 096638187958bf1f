"""chip_smoke.py's phases 2 and 4-14 rehearsed on the CPU at small shapes.

On the CPU every kernel wrapper runs its plain version, so these show
that the script's cases, checks, timings and reports run end to end and
hold the port to numpy truth; the kernels themselves are held against
their plain versions only on the card (`python3 chip_smoke.py`).
"""

import numpy as np
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


def test_phase_compress_holds_the_merge_widths():
    """Phase 2's cases at small shapes, the mesh's merged compress among
    them: an empty prefix and D replicas' compressed rows as the buffer,
    at B = 2C and 8C, every row bit for bit (the plain version on both
    sides here; the kernel on the card)."""
    out = cs.phase_compress(CPU, K=64, C=32, B=32, merge=((16, 2), (8, 8)))
    assert set(out) == {"serving", "overflow_clip", "merge_B64",
                        "merge_B256", "max_abs_err"}
    assert out["merge_B64"]["rows_bitwise_equal"] == 16
    assert out["merge_B256"]["B"] == 256 and out["merge_B256"]["sr02_kernel"]


def test_phase_timing_reports_both_insert_shapes_and_routes():
    routes = ({"set_slots": 64, "batch_size": 256, "histogram_slots": 64,
               "counter_slots": 8, "gauge_slots": 8}, 8, 600, 1)
    out = cs.phase_timing(CPU, K=64, C=32, B=32, KS=16, m=256, mu=256,
                          n=4096, n_landing=8192, reps=(2, 1, 2),
                          routes=routes, merge=(16, 2))
    assert out["compress_merge"]["shape"] == [16, 32, 64]
    assert out["compress_merge"]["bound_ms"] > 0
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
    does, each with the engine's warm-up in start() as its own step, and
    the kernels line's launches sum phases 5, 7 and 8."""
    names = {k[0] for k in cs.KERNELS}
    for table in (cs.SERVER_LAUNCHES, cs.SSF_LAUNCHES):
        assert list(table)[:3] == ["construction", "start", "ingest"]
        assert len(table) == 5
        assert table["start"] == cs.START_LAUNCHES
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


FLEET_PLAN = {"timers": (300, 25), "counters": (60, 4), "gauges": 60,
              "sets": (20, 200, 100), "local_timers": (5, 25), "hot": 200,
              "touch": 0.1}


def test_phase_fleet_rehearsal(monkeypatch, one_torch_thread):
    """Phase 10 at small widths and traffic: two port globals, a port
    proxy, three gRPC locals and an HTTP local through the scripted
    egress, three intervals; rows against numpy truth, the exports'
    kinds, duplicates dropped, no pending spill, and both globals bit
    for bit a zero-fault rerun. The import stage lands every 256
    digests here, so landings fall inside intervals as the full plan's
    do at 8192 (the launch check: on the card)."""
    from veneur_tpu_torch.models import pipeline
    monkeypatch.setattr(pipeline, "_IMPORT_STAGE_DIGESTS", 256)
    cfg_kw = {"tpu_histogram_slots": 1024, "tpu_counter_slots": 256,
              "tpu_gauge_slots": 256, "tpu_set_slots": 64,
              "tpu_batch_size": 1024}
    out = cs.phase_fleet(CPU, cfg_kw=cfg_kw, plan=FLEET_PLAN)
    assert len(out["rounds"]) == cs.FLEET_INTERVALS
    assert out["duplicates_dropped"] > 0
    for rec in out["rounds"]:
        assert [loc["local"] for loc in rec["locals"]] == [0, 1, 2, 3]
    assert [loc["kind"] for rec in out["rounds"]
            for loc in rec["locals"][:1]] == ["full", "delta", "full"]
    # landings fell inside the intervals and in each global's flush
    assert all(len(lands) >= 3 for lands in out["landings"])
    assert all(w["pct_err_over_spread"] <= 0.01 + 1e-6
               for w in out["worst"])
    assert out["proxy_metrics"] > 0
    cs.print_fleet_timings(out, "cpu")
    assert all(n == 0 for n in out["launches"].values())
    assert set(out["launches_by_step"]) == set(cs.FLEET_LAUNCHES)


def test_fleet_launch_table_follows_the_plan():
    """Every step of phase 10's table names every kernel, and its counts
    follow from FLEET_PLAN as PERF.md derives them: a probe an engine;
    a local's flush one compress and one hll_stats (two of each in its
    first); two compresses a global landing, every 8192 digests staged
    (global 1: 3 x 2501 + 5001 an interval, global 2: 3 x 2500) and the
    remainder in the flush with the baseline and the work set; the
    rerun the same landings."""
    from veneur_tpu_torch.models import pipeline
    names = {k[0] for k in cs.KERNELS}
    table = cs.FLEET_LAUNCHES
    assert all(set(step) == names for step in table.values())
    n = cs.FLEET_GRPC_LOCALS + 1
    nt = cs.FLEET_PLAN["timers"][0]
    per_round = [cs.FLEET_GRPC_LOCALS * (nt // 2 + 1) + nt + 1,
                 cs.FLEET_GRPC_LOCALS * (nt // 2)]
    stage = pipeline._IMPORT_STAGE_DIGESTS
    landings = []
    for r in range(cs.FLEET_INTERVALS):
        landings.append(sum((r + 1) * d // stage - r * d // stage
                            for d in per_round))
    assert all(cs.FLEET_INTERVALS * d % stage for d in per_round)
    for r in range(cs.FLEET_INTERVALS):
        local_c = (2 if r == 0 else 1) * n
        assert table[f"R{r + 1} ingest"] == dict.fromkeys(names, 0)
        assert table[f"R{r + 1} forward"] == {
            "compress": local_c + 2 * landings[r], "hll_stats": local_c,
            "ull_insert": 0, "probe": 0}
        assert table[f"rerun R{r + 1}"] == {
            "compress": 2 * landings[r], "hll_stats": 0, "ull_insert": 0,
            "probe": 0}
    for label in ("global flush", "rerun flush"):
        assert table[label] == {"compress": 2 * (2 + 2), "hll_stats": 4,
                                "ull_insert": 0, "probe": 0}
    assert table["construction"]["probe"] == 2 + n
    assert table["rerun construction"]["probe"] == 2


# phase 11 at small shapes: the timers and the import stage are scaled
# together (155 + 1 digests a local against a stage of 64, as 20001
# against 8192 at the defaults, and 156 of 256 histogram slots dirty as
# 20001 of 32768), so every landing falls where the full plan's does
DURABLE_PLAN = {"locals": 4, "timers": (155, 25), "counters": (50, 4),
                "gauges": 50, "sets": (10, 200, 100), "local_timers": (5, 25),
                "hot_senders": 0, "hot_samples": 2000}


def test_phase_durable_rehearsal(monkeypatch, one_torch_thread):
    """Phase 11 at small widths, with the in-process kill in place of the
    daemon's SIGKILL (tpu_hll_precision stays 14: at p=12 a set of a few
    hundred members misses set_ok). The checkpoint restores bit for bit,
    the killed global restarts bit for bit its twin, the killed sender's
    replay is dropped whole, and /query answers within the contract of
    numpy truth, equal on both servers, with neither's live state
    moved."""
    from veneur_tpu_torch.models import pipeline
    monkeypatch.setattr(pipeline, "_IMPORT_STAGE_DIGESTS", 64)
    cfg_kw = {"histogram_slots": 256, "counter_slots": 128,
              "gauge_slots": 128, "set_slots": 32}
    srv_kw = {"tpu_histogram_slots": 256, "tpu_counter_slots": 128,
              "tpu_gauge_slots": 128, "tpu_set_slots": 32,
              "tpu_hll_precision": 14}
    out = cs.phase_durable(CPU, cfg_kw=cfg_kw, srv_kw=srv_kw,
                           plan=DURABLE_PLAN)
    ck = out["checkpoint"]
    n = 156 + 50 + 50 + 10                  # a local's exported metrics
    assert ck["import"]["metrics"] == 4 * n
    assert ck["staged_digests"] == 4 * 156 % 64
    # mid-interval: the landed digests' rows; counters, gauges and the
    # 40 set rows (under a set landing of 256) are still staged
    assert ck["piles_dirty"] == 156
    kr = out["kill_restart"]
    assert kr["recovery"]["engines_restored"] == 1
    assert kr["recovery"]["metrics_replayed"] == 2 * n
    assert kr["rows"][0] == kr["rows"][1] > 0
    assert len(kr["twin_query_ticks"]) == len(cs.DURABLE_QUERIES)
    assert {"restore", "merge", "estimate"} <= set(kr["twin_query_ticks"][0])
    assert kr["answers"][1]["count"] == 4 * DURABLE_PLAN["hot_samples"]
    assert kr["worst"]["pct_err_over_spread"] <= 0.01 + 1e-6
    sk = out["sender_kill"]
    assert sk["recovered_intervals"] == 1
    assert sk["duplicates_dropped"] == -(-n // 200)
    cs.print_durable_timings(out, "cpu")
    assert all(n == 0 for n in out["launches"].values())
    assert set(out["launches_by_step"]) == set(cs.DURABLE_LAUNCHES)


def test_durable_launch_table_follows_the_plan():
    """Every step of phase 11's table names every kernel, and its counts
    follow from GLOBAL_PLAN and the import stage of 8192 digests as
    PERF.md derives them: a probe an engine; three compresses and two
    hll_stats a local; two compresses a landing; a global's first flush
    the remainder's landing, the baseline and the work set (compress 4,
    hll_stats 2), a later one without the baseline; the restarted
    daemon's warm-up in start(); the queries' scratch and merge
    engines."""
    from veneur_tpu_torch.models import pipeline
    names = {k[0] for k in cs.KERNELS}
    table = cs.DURABLE_LAUNCHES
    assert all(set(step) == names for step in table.values())
    p = cs.GLOBAL_PLAN
    stage = pipeline._IMPORT_STAGE_DIGESTS
    d = p["timers"][0] + 1                      # a local's digests
    assert table["locals"] == {"compress": 3 * p["locals"],
                               "hll_stats": 2 * p["locals"],
                               "ull_insert": 0, "probe": p["locals"]}
    assert table["checkpoint import"]["compress"] == 2 * (4 * d // stage)
    assert 4 * d % stage and 2 * d % stage
    first = {"compress": 4, "hll_stats": 2, "ull_insert": 0, "probe": 0}
    assert table["checkpoint flush"] == {k: 2 * v for k, v in first.items()}
    for r in (1, 2):
        assert table[f"twin interval {r}"]["compress"] == \
            2 * (2 * d // stage)
    assert table["twin flush 1"] == first
    assert table["twin flush 2"] == {**first, "compress": 3,
                                     "hll_stats": 1}
    warm = cs.START_LAUNCHES
    assert table["daemon restart to first flush"] == {
        **first, "compress": 2 * (2 * d // stage) + 4 + warm["compress"],
        "hll_stats": first["hll_stats"] + warm["hll_stats"], "probe": 1}
    rem = d % stage
    kill = 2 * (d // stage) + 2 * ((rem + d) // stage)
    assert table["sender kill forwards"]["compress"] == 2 * kill
    assert table["sender kill flush"] == {k: 2 * v for k, v in first.items()}
    merge = [4, 4, 1, 2]                  # g.t7, g.hot, counter, set
    land = 2 * (2 * d // stage)
    assert table["twin queries"] == {
        "compress": 2 * (land + 4) + sum(merge),
        "hll_stats": 2 * 2 + 2 + 2 + 1 + 2, "ull_insert": 0, "probe": 6}
    assert table["daemon queries"] == {
        "compress": land + 4 + 4 + sum(merge),
        "hll_stats": 2 * 2 + 2 + 2 + 1 + 2, "ull_insert": 0, "probe": 6}
    assert sum(s["probe"] for s in table.values()) == \
        p["locals"] + 2 + 1 + 1 + 2 + 6 + 6


# phase 12 at small shapes: the timers scaled with the histogram slots
# (2000 of 4096 dirty, as 20000 of 32768), the spans kept whole (10000,
# every tenth an indicator span: the indicator timer's 1000 samples)
NATIVE_PLAN = {"timers": (2000, 10), "counters": (500, 4), "gauges": 500,
               "sets": (100, 100), "checks": 100, "events": 10}
NATIVE_CFG = {"tpu_histogram_slots": 4096, "tpu_counter_slots": 2048,
              "tpu_gauge_slots": 2048, "tpu_set_slots": 256}
NATIVE_SSF = {"spans": 10000, "keys": (500, 200, 20, 100), "every": 10}


def test_phase_native_rehearsal():
    """Phase 12 at small widths: a native-ingest Server on the CPU over
    real UDP (the C++ readers), the pump's drains, the native SSF path;
    rows against numpy truth in every interval, the bridge's counters,
    and a clean stop."""
    out = cs.phase_native(CPU, cfg_kw={**NATIVE_CFG,
                                       "native_pump_batch": 1024},
                          plan=NATIVE_PLAN, ssf_plan=NATIVE_SSF)
    n_lines = 20000 + 2000 + 500 + 10000 + 100 + 10 + 1
    assert out["lines"] == n_lines and out["bridge_S1"]["lines"] == n_lines
    assert out["bridge_S1"]["samples"] == n_lines - 111
    assert [r["samples"] for r in out["pump"]] == [n_lines - 111] * 2
    assert [r["profiled"] for r in out["pump"]] == [False, True]
    assert all(r["device_ms"] is None for r in out["pump"])  # no card
    assert out["landings"]["pump_full_ms"]
    assert out["bridge_ssf"]["ssf_spans"] == 10000
    assert out["S2"]["ssf_datagrams"] > 0        # S1's self-traced spans
    for label in ("S1", "S2", "S3", "S4"):
        assert out[label]["total_duration_ns"] > 0
    cs.print_native_timings(out, "cpu")
    assert all(n == 0 for n in out["launches"].values())
    assert set(out["launches_by_step"]) == set(cs.NATIVE_LAUNCHES)


def _count_plain_calls(monkeypatch):
    """Count the kernel wrappers' plain calls on the CPU as launches (and
    each engine's construction as the probe's)."""
    from veneur_tpu_torch import kernels
    from veneur_tpu_torch.kernels import compress as kc
    from veneur_tpu_torch.kernels import hll_stats as kh
    from veneur_tpu_torch.models import pipeline

    def counting(name, fn):
        def wrapper(*a, **kw):
            kernels.count_launch(name)
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(kc, "fused_compress",
                        counting("compress", kc.fused_compress))
    monkeypatch.setattr(kh, "hll_stats", counting("hll_stats", kh.hll_stats))
    monkeypatch.setattr(pipeline.AggregationEngine, "__init__", counting(
        "probe", pipeline.AggregationEngine.__init__))


@pytest.mark.parametrize("kw", [
    {"batch_size": 8192},
    {"batch_size": 512, "buffer_depth": 64, "histogram_slots": 64}])
def test_start_launch_table_holds_on_the_cpu(monkeypatch, kw):
    """START_LAUNCHES: an engine's warmup() at the default widths and
    batch, and at a batch past its few slots' buffers, counting the
    wrappers' plain calls; the engine's live state and its cached
    baseline rows stay as they were."""
    from veneur_tpu_torch import kernels
    from veneur_tpu_torch.models import pipeline
    _count_plain_calls(monkeypatch)
    cfg = {"histogram_slots": 2048, "counter_slots": 1024,
           "gauge_slots": 1024, "set_slots": 256, **kw}
    eng = pipeline.AggregationEngine(pipeline.EngineConfig(**cfg),
                                     device=CPU)
    kernels.reset_launches()
    eng.warmup()
    assert dict(kernels.launches) == cs.START_LAUNCHES
    assert eng._flush_baseline is None
    assert eng._last_flush_info == {"path": "full"}
    assert not any(d.any() for d in eng._dirty)


def test_native_launch_table_holds_on_the_cpu(monkeypatch):
    """NATIVE_LAUNCHES at the scaled plan, counting the kernel wrappers'
    plain calls on the CPU (and each engine's construction for the
    probe): no landing overfills a slot but the indicator timer's, whose
    1000 samples pass its buffer depth three times."""
    from veneur_tpu_torch import kernels
    from veneur_tpu_torch.kernels import compress as kc
    from veneur_tpu_torch.kernels import hll_stats as kh
    from veneur_tpu_torch.models import pipeline

    def counting(name, fn):
        def wrapper(*a, **kw):
            kernels.count_launch(name)
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(kc, "fused_compress",
                        counting("compress", kc.fused_compress))
    monkeypatch.setattr(kh, "hll_stats", counting("hll_stats", kh.hll_stats))
    monkeypatch.setattr(pipeline.AggregationEngine, "__init__", counting(
        "probe", pipeline.AggregationEngine.__init__))
    out = cs.phase_native(CPU, cfg_kw=NATIVE_CFG, plan=NATIVE_PLAN,
                          ssf_plan=NATIVE_SSF)
    assert out["launches_by_step"] == cs.NATIVE_LAUNCHES
    names = {k[0] for k in cs.KERNELS}
    assert all(set(step) == names for step in cs.NATIVE_LAUNCHES.values())


# phase 13 at small shapes: phase 7's rehearsal traffic, 1000 spans whose
# timing keys keep S1's dirty histogram rows under the incremental
# threshold (300 + 50 of 1024, as 22000 of 32768)
SINKS_PLAN = {"timers": (300, 10), "counters": (100, 4), "gauges": 100,
              "sets": (20, 100), "checks": 10, "events": 3}
SINKS_CFG = {"tpu_histogram_slots": 1024, "tpu_counter_slots": 512,
             "tpu_gauge_slots": 256, "tpu_set_slots": 64,
             "tpu_batch_size": 256}
SINKS_SSF = {"spans": 1000, "keys": (50, 50, 10, 20), "every": 10}
SINKS_FWD = {"tpu_histogram_slots": 256, "tpu_counter_slots": 128,
             "tpu_gauge_slots": 128, "tpu_set_slots": 64,
             "tpu_batch_size": 256}


def test_phase_sinks_rehearsal(monkeypatch):
    """Phase 13 at small widths on the CPU: every network sink the config
    builds, aimed at captures in this process; each metric sink's payload
    against numpy truth, every span at every span sink, Kafka and S3
    counting their drops, the failed forwards at the sentry capture, a
    clean stop, and the launches of each step (the wrappers' plain calls
    counted) equal SINKS_LAUNCHES."""
    _count_plain_calls(monkeypatch)
    out = cs.phase_sinks(CPU, cfg_kw=SINKS_CFG, plan=SINKS_PLAN,
                         ssf_plan=SINKS_SSF, fwd_cfg_kw=SINKS_FWD)
    assert out["launches_by_step"] == cs.SINKS_LAUNCHES
    assert out["lines"] == 3000 + 400 + 100 + 2000 + 10 + 3 + 1
    assert out["spans"] == 1000
    s = out["sinks"]
    assert s["datadog"]["requests"] == 1 + 10 + 3    # series, checks, events
    assert s["datadog"]["wire_bytes"] < s["datadog"]["body_bytes"]
    assert s["signalfx"]["requests"] == 1
    assert s["newrelic"]["requests"] == 2            # metrics + events
    assert s["span xray"]["wire_bytes"] > 0
    rows = out["S1"]["rows"]
    assert s["kafka"]["metrics_flushed"] == rows     # the server's count
    assert s["s3"]["dropped"] == rows + out["S2"]["rows"]
    assert 1 <= out["sentry_events"] <= cs.SINKS_FORWARD_TICKS
    assert out["fanout_ms"] > 0
    assert all(v < 10 for v in out["stop_s"].values())
    cs.print_sinks_timings(out, "cpu")


# phase 14 at small shapes: a 2 x 4 grid of the CPU, interval A scaled
# as PLAN's (its histogram keys under the incremental threshold of the
# single-device engines of (d)), phase 7's rehearsal traffic for the
# server, and a small forwarded interval for the global
MESH_CFG = {"histogram_slots": 2048, "counter_slots": 512,
            "gauge_slots": 512, "set_slots": 64, "batch_size": 256}
MESH_SRV = {"tpu_histogram_slots": 1024, "tpu_counter_slots": 256,
            "tpu_gauge_slots": 256, "tpu_set_slots": 64,
            "tpu_batch_size": 256}
MESH_SRV_PLAN = {"timers": (300, 10), "counters": (100, 4), "gauges": 100,
                 "sets": (20, 100), "checks": 10, "events": 3}
MESH_GLOBAL = {"timers": (200, 25), "counters": (100, 4), "gauges": 100,
               "sets": (20, 100)}


def test_phase_mesh_rehearsal(monkeypatch):
    """Phase 14 at small widths on the CPU: the mesh engine through its
    routing and straight through MeshEngine.ingest on both dp rows, the
    mesh server, the mesh global behind a forwarding local, and the fetch
    modes, each against numpy truth or sync; the launches of each step
    (the wrappers' plain calls counted) equal MESH_LAUNCHES."""
    _count_plain_calls(monkeypatch)
    out = cs.phase_mesh(CPU, cfg_kw=MESH_CFG, plan={"A": PLAN["A"]},
                        srv_cfg_kw=MESH_SRV, srv_plan=MESH_SRV_PLAN,
                        glob_plan=MESH_GLOBAL)
    assert out["launches_by_step"] == cs.MESH_LAUNCHES
    assert out["grid"] == [cs.MESH_DP, cs.MESH_SHARDS]
    for arm in ("engine", "direct"):
        assert out["steps"][f"{arm} A ingest"]["samples"] == \
            cs.samples_of(cs.build_interval(np.random.default_rng(14),
                                            PLAN["A"], "A"))
        assert out["steps"][f"{arm} A flush"]["rows"] > 0
        assert out["steps"][f"{arm} empty flush"]["rows"] == 0
    assert out["server"]["lines"] == 3000 + 400 + 100 + 2000 + 10 + 3 + 1
    assert out["global"]["rows"] == 200 * 6 + 100 + 100 + 20
    assert list(out["fetch"]) == [
        f"fetch {m}{' f16' if f16 else ''}" for m, f16 in cs.FETCH_CASES]
    for label, f in out["fetch"].items():
        assert f["bytes"] > 0 and len(f["fetch_ms"]) == 2, label
        assert all(ms >= 0 for ms in f["fetch_ms"] + f["exec_ms"]), label
    assert out["fetch"]["fetch sync f16"]["bytes"] \
        < out["fetch"]["fetch sync"]["bytes"]
    cs.print_mesh_timings(out, "cpu")


def test_mesh_launch_table_follows_the_grid():
    """MESH_LAUNCHES is the grid's arithmetic: S * (D + 1) compresses and
    S hll_stats a mesh flush (a 1 x 1 grid one compress: the
    single-device body); the server's and the global's 1 x 8 grid 2 x 8
    and 8; each single-device engine a probe and its first flush's two
    compresses and two hll_stats, the fetch cases in two turns."""
    t = cs.MESH_LAUNCHES
    assert t["engine A flush"] == cs._launch_row(compress=12, hll_stats=4)
    assert t["direct empty flush"] == t["engine A flush"]
    assert t["server S1"] == cs._launch_row(compress=16, hll_stats=8)
    assert t["global start"] == cs._launch_row(compress=19, hll_stats=10)
    assert cs._mesh_launches(1, 1, 1)["engine A flush"] == \
        cs._launch_row(compress=1, hll_stats=1)
    names = {k[0] for k in cs.KERNELS}
    assert all(set(step) == names for step in t.values())
    assert sum(step["probe"] for step in t.values()) == 1 + 1 + 1 + 1 + 2 + 10
    assert [k for k in t if k.startswith("fetch")] == [
        f"fetch {m}{' f16' if f16 else ''} turn {n}"
        for n, (m, f16) in cs.fetch_turns()]


def test_mesh_cards_rehearsal():
    """mesh_cards.py's turns on the CPU: the 2 x 4 grid "on one card" and
    "round-robin over four cards" (every entry the CPU here) in turns,
    rows against truth and bit for bit across turns, then a mesh server;
    its main() refuses to run without two cards."""
    import subprocess
    import sys

    import mesh_cards
    cpus = [torch.device("cpu")] * 4
    assert mesh_cards.layouts(cpus, 4) == {
        "one card": cpus[:1] * 8, "4 cards": cpus * 2}
    recs = mesh_cards.run_layouts(cpus, 4, cfg_kw=MESH_CFG,
                                  plan=PLAN["A"])
    assert [(r["layout"], r["arm"]) for r in recs] == [
        (lay, arm) for lay in ("one card", "4 cards", "4 cards",
                               "one card")
        for arm in ("engine", "direct")]
    assert all(r["flush_ms"] > 0 and r["samples_per_s"] > 0 for r in recs)
    srv = mesh_cards.run_server(CPU, cfg_kw=MESH_SRV, plan=MESH_SRV_PLAN)
    assert srv["shard_devices"] == ["cpu"] * 8 and srv["S1_ms"] > 0
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "mesh_cards.py"],
                             cwd=cs.ROOT, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and '"ok"' not in out.stdout
