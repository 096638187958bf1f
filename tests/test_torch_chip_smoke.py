"""chip_smoke.py's phases 4-7 rehearsed on the CPU at small shapes.

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
                                   "assembly_duration_ns", "rows"}
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
