#!/usr/bin/env python3
"""The first use of the serving ops on the card, with and without the
engine's warm-up in Server.start() (one NVIDIA H100).

    python3 warmup_first_use.py

Each run is a fresh process that builds the kernels (chip_smoke phase 1)
and starts the port's Server at the deployment defaults with the warm-up
placed one of three ways:

  off     AggregationEngine.warmup does nothing: what start() did for a
          Python-ingest server before it warmed its engines;
  main    the warm-up runs on the thread that calls start();
  worker  the warm-up runs first on each worker's own thread, the thread
          that lands, and start() waits for it (what start() does).

and feeds it one of two ways:

  udp     chip_smoke phase 7 alone: S1 (325,111 DogStatsD lines) over
          UDP, paced, then an empty S2. The first landings overlap the
          UDP readers parsing the first burst, so they also wait for the
          interpreter lock;
  queue   S1's metric lines, parsed beforehand, fill the worker's queue
          before start(), and the caller only waits: the worker lands
          with no other thread running Python.

Each run prints, per kind of the worker's ingest landing (histograms,
counters), the first landing's ms against the median landing's (wall,
the worker thread's CPU ms in it, the final synchronize), start()'s ms,
and in `udp` S1's and S2's flush walls and the `start` step's launches.
The runs go udp off, worker, main, then queue off, worker, main, then
udp worker and queue worker again. The script fails unless every run
passes (in `udp` phase 7's checks, its launches against SERVER_LAUNCHES
with the `start` row zero where the warm-up is off) and, in every
`queue` run with the warm-up, each kind's first landing is within 2x its
median.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
RUNS = (("udp", "off"), ("udp", "worker"), ("udp", "main"),
        ("queue", "off"), ("queue", "worker"), ("queue", "main"),
        ("udp", "worker"), ("queue", "worker"))

_RUN = r"""
import json, queue, sys, time
import numpy as np
import torch
import chip_smoke as cs
from veneur_tpu_torch import server as tserver
from veneur_tpu_torch.models import pipeline
feed, arm = sys.argv[1], sys.argv[2]
warm = pipeline.AggregationEngine.warmup
if arm in ("off", "main"):
    pipeline.AggregationEngine.warmup = lambda self: None
if arm == "off":
    cs.SERVER_LAUNCHES["start"] = {k: 0 for k in cs.START_LAUNCHES}
if arm == "main":
    start = tserver.Server.start

    def start_warm_on_the_caller(self):
        for eng in self.engines:
            warm(eng)
        start(self)
    tserver.Server.start = start_warm_on_the_caller
d = torch.device("cuda", 0)
cs.phase_build(d)
if feed == "udp":
    out = cs.phase_server(d)
    rec = {"landings": out["landings"], "start_s": out["start_s"],
           "S1_ms": out["S1"]["total_duration_ns"],
           "S1_merge_ms": out["S1"]["merge_duration_ns"],
           "S2_ms": out["S2"]["total_duration_ns"],
           "start_launches": out["launches_by_step"]["start"]}
else:
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ingest.parser import UDPMetric, parse_packet
    from veneur_tpu_torch.sinks.basic import CaptureMetricSink
    lines, _truth, _c, _t = cs.server_traffic(np.random.default_rng(17),
                                              cs.SERVER_PLAN)
    metrics = [m for m in (parse_packet(ln) for ln in lines
                           if not ln.startswith((b"_", b"srv.bad")))
               if isinstance(m, UDPMetric)]
    srv = tserver.Server(Config(statsd_listen_addresses=[],
                                interval="3600s", hostname="chip"),
                         sinks=[CaptureMetricSink()], device=d)
    timers = cs.LandingTimes(srv.engines[0], d)
    q = queue.Queue()
    for m in metrics:
        q.put(m)
    srv.worker_queues[0] = q
    t0 = time.perf_counter()
    srv.start()
    start_s = time.perf_counter() - t0
    cs.wait_until(lambda: q.unfinished_tasks == 0, 300, "the queue")
    cs.check(srv.drain(timeout=120), "drain() timed out")
    rec = {"landings": [timers.summary()], "start_s": start_s,
           "metrics": len(metrics)}
    timers.restore()
    srv.stop()
print("RUN " + json.dumps({"feed": feed, "arm": arm, **rec}))
"""


def _kinds(lnd):
    return ", ".join(
        f"{k} first {v['first_ms']:.2f} ms (CPU {v['first_cpu_ms']:.2f}, "
        f"sync {v['first_sync_ms']:.2f}) vs median {v['median_ms']:.2f} ms "
        f"(CPU {v['median_cpu_ms']:.2f}, sync {v['median_sync_ms']:.2f}) "
        f"over {v['n']}, the first three "
        f"{', '.join(f'{x:.2f}' for x in v['first3_ms'])}"
        for k, v in lnd.items())


def main() -> int:
    try:
        import torch
    except ImportError:
        print("warmup_first_use: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("warmup_first_use: no CUDA device; this run needs one card",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    card = cs.card_line()
    results = []
    for feed, arm in RUNS:
        p = subprocess.run([sys.executable, "-c", _RUN, feed, arm],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=900)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("RUN ")]
        if p.returncode != 0 or not lines:
            print(p.stdout[-4000:])
            print(p.stderr[-4000:], file=sys.stderr)
            print(f"warmup_first_use: {feed} {arm} failed", file=sys.stderr)
            return 1
        r = json.loads(lines[-1][4:])
        results.append(r)
        (lnd,) = r["landings"]
        tail = (f"; S1 flush {r['S1_ms']:.2f} ms (merge "
                f"{r['S1_merge_ms']:.2f}), S2 {r['S2_ms']:.2f} ms; start "
                f"launches {r['start_launches']}" if feed == "udp" else
                f"; {r['metrics']} metrics queued before start()")
        print(f"warm-up {arm}, {feed}: start() {r['start_s'] * 1e3:.2f} ms; "
              f"landings: {_kinds(lnd)}{tail} | {card}", flush=True)
    ok = all(v["first_ms"] <= 2 * v["median_ms"]
             for r in results if r["feed"] == "queue" and r["arm"] != "off"
             for lnd in r["landings"] for v in lnd.values())
    print(json.dumps({"warmup_first_use": results, "card": card}))
    if not ok:
        print("warmup_first_use: a queued first landing over 2x its median "
              "with the warm-up on", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
