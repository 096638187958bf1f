"""The program's own spans over the benchmark's window: what the port's
flight recorder stamped (the native pump's cycles, the collector's
collections, each flush tick's phases and CPU time) read once the window
of `local-native.steady` has closed, and what the flight recorder costs.

    python3 trace_window.py one --seed N [--seconds 50] [--trace 0|1]
        [--config FILE] [--spans 1]
    python3 trace_window.py cost --seeds A,B,... [--seconds 50]
    python3 trace_window.py spans --seeds A,B,... [--seconds 50]
    python3 trace_window.py micro

`one` is one run of the cell, as `python3 -m portbench.run` makes it but
with the configuration read from FILE when given; it prints the run's
result line, and with `--spans 1` the program's numbers beside it
(`program`): the pump's busy share of the window, its engine-lock wait
a flush, the fullest bank's highest fill as a share of what its rings
hold, the collector's ms inside the engine's lock-held swap a flush, the
flush ticks' mean CPU ms, and in a traced run the device's ten longest
idle gaps named by the program span that covers most of each. `cost`
runs each seed twice in fresh processes, the flight recorder on (the
accepted file) and off (a copy with `flight_recorder: false`), in turn;
`spans` runs each seed once traced. Both read the program's numbers
(`--spans 1`) and print one JSON line a run; those three need one CUDA
device. `micro` prices each stamp alone, [without, with] in ns (see
`micro`). Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CELL = "local-native.steady"


def _capture_servers() -> list:
    """Every port Server made in this process, in the order made."""
    from veneur_tpu_torch import server
    made, init = [], server.Server.__init__

    def wrapped(self, *a, **kw):
        made.append(self)
        init(self, *a, **kw)

    server.Server.__init__ = wrapped
    return made


def _capture_summaries() -> list:
    """The arguments of each device-trace summary the harness makes."""
    from portbench import trace
    seen, orig = [], trace.summarize

    def wrapped(dt, calls, t0, t1, host, idle_name):
        seen.append((dt, t0, t1, idle_name))
        return orig(dt, calls, t0, t1, host, idle_name)

    trace.summarize = wrapped
    return seen


def _clip_ns(t: np.ndarray, t0: int, t1: int) -> float:
    return float(np.clip(t[:, 1], t0, t1).sum() - np.clip(t[:, 0], t0, t1)
                 .sum()) if len(t) else 0.0


def _window_ticks(flight, flushes: list) -> list | None:
    """The tick dicts of the window's flushes (one a harness-timed call,
    found by its monotonic start); None where the ring lost one."""
    ticks = flight.snapshot()
    out = []
    for f in flushes:
        lo, hi = int(f["t0"] * 1e9), int(f["t1"] * 1e9)
        got = [t for t in ticks if lo <= t["mono_start_ns"] <= hi]
        if len(got) != 1:
            return None
        out.append(got[0])
    return out


def _phase_spans(tick: dict) -> list:
    """[(name, depth, start, end)] of a tick's completed phases, absolute
    monotonic ns; depth counts the parents above a phase."""
    ph, base, out = tick["phases"], tick["mono_start_ns"], []
    for p in ph:
        if p["end_ns"] is None:
            continue
        d, q = 0, p["parent"]
        while q >= 0:
            d, q = d + 1, ph[q]["parent"]
        out.append((p["name"], d, base + p["start_ns"], base + p["end_ns"]))
    return out


def program_numbers(srv, rec: dict, summaries: list) -> dict:
    """The program's numbers over the window [p_w0, p_w1] (perf_counter
    s, which is monotonic_ns's clock on Linux), leaving out each whose
    ring no longer covers the window."""
    from portbench import trace as tr
    t0, t1 = int(rec["p_w0"] * 1e9), int(rec["p_w1"] * 1e9)
    flight, pump = srv.flight, srv.native_pump
    flushes = rec["flushes"]
    out = {}
    if flight is None:
        return out
    pw = (None if flight.spans("pump") is None
          else flight.spans("pump").window(t0, t1))
    gw = flight.spans("gc").window(t0, t1)
    ticks = _window_ticks(flight, flushes)
    if pw is not None:
        pt, pf = pw
        out["ingest.pump_busy_pct"] = _clip_ns(pt, t0, t1) / (t1 - t0) * 100
        out["ingest.lock_wait_ms"] = float(pf[:, 4].sum()) / len(
            flushes) / 1e6
        out["ingest.ring_peak_pct"] = float(pf[:, :4].max(initial=0)) \
            / pump.ring_samples * 100
        out["ingest.ring_peak_samples"] = int(pf[:, :4].max(initial=0))
        out["ingest.ring_samples"] = pump.ring_samples
        out["ingest.pump_cycles"] = len(pt)
    if ticks is not None:
        out["server.flush_cpu_ms"] = float(np.mean(
            [t["cpu_ns"] for t in ticks])) / 1e6
        out["server.flush_cpu_ms_each"] = [round(t["cpu_ns"] / 1e6, 2)
                                           for t in ticks]
        if gw is not None:
            gt = gw[0]
            inside = 0.0
            for t in ticks:
                for name, _d, s, e in _phase_spans(t):
                    if name == "engine.swap":
                        inside += _clip_ns(gt, s, e)
            out["engine.swap_gc_ms"] = inside / len(ticks) / 1e6
            out["engine.swap_ms_each"] = [
                round(sum(e - s for n, _d, s, e in _phase_spans(t)
                          if n == "engine.swap") / 1e6, 2) for t in ticks]
    if gw is not None:
        gt, gf = gw
        out["gc.window_ms_by_generation"] = [
            round(_clip_ns(gt[gf[:, 0] == g], t0, t1) / 1e6, 3)
            for g in range(3)]
        out["gc.window_collections_by_generation"] = [
            int((gf[:, 0] == g).sum()) for g in range(3)]
    if summaries and pw is not None and gw is not None \
            and ticks is not None:
        out["idle_gaps"] = named_gaps(summaries[-1], pw, gw[0],
                                      flight.snapshot(), tr)
    return out


def named_gaps(summary, pw, gt, ticks: list, tr) -> list:
    """The device's ten longest idle gaps in the window, each named by
    the program span that covers most of it, in the order gc, the flush
    phases deepest first (`flush:<phase>`), the pump's cycles
    (`pump:lock_wait` where a cycle waited on the engine lock for more
    than half of it, else `pump:land`); a later kind counts only where
    no earlier one does. kineto's times come on perf_counter through the
    harness's marker offset, and perf_counter is monotonic_ns's clock."""
    dt, t0, t1, idle_name = summary
    evs = [(s, e) for _n, s, e in dt.events() if e > t0 and s < t1]
    host = {"gc": [(s / 1e9, e / 1e9) for s, e in gt]}
    phases = [p for t in ticks for p in _phase_spans(t) if p[0] != "gc"]
    for name, _d, _s, _e in sorted(phases, key=lambda p: -p[1]):
        host.setdefault("flush:" + name, [])
    for name, _d, s, e in phases:
        host["flush:" + name].append((s / 1e9, e / 1e9))
    pt, pf = pw
    wait = pf[:, 4] * 2 > (pt[:, 1] - pt[:, 0])
    host["pump:lock_wait"] = [(s / 1e9, e / 1e9) for s, e in pt[wait]]
    host["pump:land"] = [(s / 1e9, e / 1e9) for s, e in pt[~wait]]
    out = []
    for g0, g1 in sorted(tr.gaps(evs, t0, t1), key=lambda g: g[0] - g[1])[
            :10]:
        cover, taken = {}, 0.0
        for k, v in host.items():
            o = tr.overlap(g0, g1, v)
            cover[k] = max(0.0, o - taken)
            taken = max(taken, o)
        best = max(cover, key=cover.get)
        out.append([best if cover[best] > 0 else idle_name,
                    round((g1 - g0) * 1e3, 3)])
    return out


def one(argv) -> int:
    from portbench import run as pr
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--config")
    ap.add_argument("--spans", type=int, default=0)
    a = ap.parse_args(argv)
    args = pr.parse(["--workload", CELL, "--seed", str(a.seed), "--seconds",
                     str(a.seconds), "--trace", str(a.trace)])
    cell = pr.load_cell(CELL)
    if a.config:
        with open(a.config) as f:
            cell["config"] = json.load(f)
    servers = _capture_servers() if a.spans else None
    summaries = _capture_summaries() if a.spans and a.trace else []
    prep = pr.driver(cell).prepare(cell, args)
    import torch
    if not torch.cuda.is_available():
        prep["procs"].close()
        print("trace_window: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rec = pr.run_cell(cell, args, device, prep)
    res = pr.result_of(cell, rec, args,
                       {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0), "count": 1})
    # the end-to-end metrics and the wall of the flush in every run
    for name in ("samples_per_s", "setup_s", "server.flush_ms"):
        res["metrics"].setdefault(name, {"value": pr.reader(name)(rec)})
    res["seed"] = a.seed
    res["notes"] = rec["notes"]
    res["flight_recorder"] = bool(cell["config"]["server"].get(
        "flight_recorder", True))
    if servers:
        res["program"] = program_numbers(servers[-1], rec, summaries)
    print(json.dumps(res), flush=True)
    return 0


def micro(reps: int = 7) -> dict:
    """What the recorder's new stamps cost, ns each, the least of `reps`
    timed loops: a pump cycle that moved samples, stamped against not
    (a stub bridge and engine, one sample a bank); a young collection
    with the collector hook against without; a flush tick's begin and
    end with a full collector ring against without."""
    import gc
    import time
    from types import SimpleNamespace
    from veneur_tpu_torch.ingest import native
    from veneur_tpu_torch.observe import recorder

    class Bridge:
        def poll(self, bank, slots, a, b, c):
            return 1

        def drain_new_keys(self):
            return []

        def drain_other(self):
            return []

    def land(*a, **k):
        pass

    eng = SimpleNamespace(lock_wait_ns=0, ingest_histo_batch=land,
                          ingest_counter_batch=land, ingest_gauge_batch=land,
                          ingest_set_batch=land)
    views = {b: SimpleNamespace(mark=None) for b in native.PUMP_FIELDS[:4]}

    def per_call(fn, n):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter_ns() - t0) / n)
        return best

    out = {}
    plain = native.NativePump(Bridge(), eng, views, None, batch=8)
    stamped = native.NativePump(Bridge(), eng, views, None, batch=8,
                                spans=recorder.SpanRing(
                                    native.PUMP_SPANS, native.PUMP_FIELDS))
    out["pump_cycle_ns"] = [per_call(plain.pump_once, 20000),
                            per_call(stamped.pump_once, 20000)]
    fr = recorder.FlightRecorder()
    young = [per_call(lambda: gc.collect(0), 2000)]
    fr.collector_start()
    try:
        young.append(per_call(lambda: gc.collect(0), 2000))
    finally:
        fr.collector_stop()
    out["young_collection_ns"] = young
    ring = fr.spans(recorder.GC_PHASE)
    now = time.monotonic_ns()
    for k in range(ring.capacity):
        ring.record(now - 1000 + k, now - 999 + k, k % 3, 1)

    def tick(rec):
        rec.end_tick(rec.begin_tick(0))

    bare = recorder.FlightRecorder()
    out["tick_ns"] = [per_call(lambda: tick(bare), 200),
                      per_call(lambda: tick(fr), 200)]
    return out


def _runs(seeds, configs, seconds, extra=()) -> int:
    bad = 0
    for seed in seeds:
        for cfg in configs:
            cmd = [sys.executable, os.path.abspath(__file__), "one",
                   "--seed", str(seed), "--seconds", str(seconds), *extra]
            if cfg:
                cmd += ["--config", cfg]
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                               text=True)
            lines = p.stdout.strip().splitlines()
            if p.returncode or not lines:
                bad += 1
                print(json.dumps({"seed": seed, "config": cfg,
                                  "rc": p.returncode,
                                  "stderr": p.stderr[-2000:]}), flush=True)
                continue
            print(lines[-1], flush=True)
    return 1 if bad else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "one":
        return one(argv[1:])
    if argv[0] == "micro":
        print(json.dumps(micro()), flush=True)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("cost", "spans"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=50)
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    if a.mode == "spans":
        return _runs(seeds, [None], a.seconds, ("--trace", "1",
                                                "--spans", "1"))
    from portbench import run as pr
    cell = pr.load_cell(CELL)
    off = dict(cell["config"])
    off["server"] = dict(off["server"], flight_recorder=False)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "local-native-off.json")
        with open(path, "w") as f:
            json.dump(off, f)
        return _runs(seeds, [None, path], a.seconds, ("--spans", "1"))


if __name__ == "__main__":
    sys.exit(main())
