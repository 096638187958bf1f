#!/usr/bin/env python3
"""The multi-device engine across several cards of one host.

Run from the root of a checkout on a machine with two or more NVIDIA
cards:

    python3 mesh_cards.py

chip_smoke.py's phase 14 puts every instance of a grid on one card, so
the merge's gathers are copies within that card's memory. Here the same
2 x 4 grid is laid out twice in one process: on cuda:0 alone, and with
instance i on cuda:(i mod the cards), so each shard column's replicas
and the columns' outputs cross between cards. In turns (one card, the
cards, the cards, one card), phase 5's interval A goes through a
MeshAggregationEngine (its routing, dp row 0) and straight into
MeshEngine.ingest on both dp rows, each flushed against numpy truth
(phase 5's contract); the cards' rows must be bit for bit the one card's.
Then a Server(Config(tpu_num_devices=8)) spreads its 1 x 8 grid over
the cards (shard i on cuda:(i mod the cards)) and takes phase 7's lines
over real UDP, against truth. Printed: each layout's ingest samples/s and
flush wall, swap, merge and assembly ms, the server's lines/s and S1
flush, the kernel launches of each card's turn, every card's name and
power limit, and last {"ok": true, "cards": N}. It exits non-zero with
fewer than two cards.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import types

import numpy as np


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, check=True,
        text=True, timeout=60)
    return [ln.strip() for ln in out.stdout.strip().splitlines()]


def layouts(devices, n_cards, grid=8):
    """{label: the grid's device list}: one card, and round-robin over
    `n_cards` of `devices`."""
    return {"one card": [devices[0]] * grid,
            f"{n_cards} cards": [devices[i % n_cards] for i in range(grid)]}


def run_layouts(devices, n_cards, cfg_kw=None, plan=None, turns=None,
                n_dp=2):
    """Interval A through both layouts in turns; returns each turn's
    record. Every turn's rows are held to numpy truth, and every turn
    of one arm to the first turn's rows bit for bit."""
    import chip_smoke as cs
    import torch
    from veneur_tpu_torch import kernels
    from veneur_tpu_torch.models.pipeline import EngineConfig
    from veneur_tpu_torch.parallel.engine import MeshAggregationEngine
    cfg_kw = cfg_kw or {}
    data = cs.build_interval(np.random.default_rng(14),
                             plan or cs.SERVE_PLAN["A"], "A")
    truth = cs.truth_of(data)
    lay = layouts(devices, n_cards)
    one, many = list(lay)
    turns = turns or (one, many, many, one)
    first = {}
    recs = []

    def sync_all():
        for d in set(devices[:n_cards]):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    for label in turns:
        for arm in ("engine", "direct"):
            kernels.reset_launches()
            eng = MeshAggregationEngine(EngineConfig(**cfg_kw),
                                        devices=lay[label], n_dp=n_dp)
            t0 = time.perf_counter()
            if arm == "engine":
                cs.feed(eng, data)
            else:
                cs.feed_direct(eng, cs.direct_arrays(eng, data),
                               eng.cfg.batch_size)
            sync_all()
            ingest_s = time.perf_counter() - t0
            t0 = time.monotonic()
            res = eng.flush(timestamp=4000)
            flush_ms = (time.monotonic() - t0) * 1e3
            cs.check_against_truth(res, truth, eng, f"{label} {arm}")
            rows = cs.canon(res)
            if arm in first:
                cs.check(rows == first[arm],
                         f"{label} {arm}: rows differ from the first turn's")
            else:
                first[arm] = rows
            recs.append({
                "layout": label, "arm": arm,
                "samples_per_s": cs.samples_of(data) / ingest_s,
                "flush_ms": flush_ms,
                "swap_ms": res.stats["swap_ns"] / 1e6,
                "merge_ms": res.stats["merge_ns"] / 1e6,
                "assembly_ms": res.stats["assembly_ns"] / 1e6,
                "launches": dict(kernels.launches)})
            del eng
    return recs


def run_server(device, cfg_kw=None, plan=None, n=8):
    """A Server with tpu_num_devices `n` on `device` (its shards go
    round-robin over the cards), phase 7's S1 over real UDP, against
    truth."""
    import chip_smoke as cs
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.metrics import MetricType
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.basic import CaptureMetricSink
    lines, truth, _checks, _titles = cs.server_traffic(
        np.random.default_rng(15), plan or cs.SERVER_PLAN)
    cfg = Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                 interval="3600s", hostname="cards", tpu_num_devices=n,
                 **(cfg_kw or {}))
    dgrams = cs.pack_datagrams(lines, cfg.metric_max_length)
    cap = CaptureMetricSink()
    srv = Server(cfg, sinks=[cap], device=device)
    out = {"shard_devices": [str(d) for row in
                             srv.engines[0].me.mesh.devices for d in row]}
    srv.start()
    try:
        t0 = time.perf_counter()
        cs.send_paced(srv, dgrams)
        cs.check(srv.drain(timeout=120), "drain() timed out")
        out["lines_per_s"] = len(lines) / (time.perf_counter() - t0)
        srv.flush_once(timestamp=4100)
        cs.check(cap.wait_for_flush(1, timeout=120), "no flush")
        s1 = {(m.name, tuple(m.tags)): m for m in cap.flushes[0]}
        out["S1_ms"] = s1[("veneur.flush.total_duration_ns", ())].value / 1e6
        rows = [m for m in s1.values() if not m.name.startswith("veneur.")
                and m.type != MetricType.STATUS]
        cs.check_against_truth(types.SimpleNamespace(metrics=rows,
                                                     frame=rows),
                               truth, srv.engines[0], "cards server S1")
    finally:
        srv.stop()
    return out


def main() -> int:
    try:
        import torch
        import chip_smoke as cs
    except ImportError as e:
        print(f"mesh_cards: {e}; run it from the root of a checkout",
              file=sys.stderr)
        return 2
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"mesh_cards: {n} CUDA devices; this run needs two or more",
              file=sys.stderr)
        return 2
    cards = card_lines()
    devices = [torch.device("cuda", i) for i in range(n)]
    cs.phase_build(devices[0])
    recs = run_layouts(devices, n)
    for label in dict.fromkeys(r["layout"] for r in recs):
        for arm in ("engine", "direct"):
            mine = [r for r in recs if (r["layout"], r["arm"]) == (label, arm)]
            print(f"timing mesh_cards {label} {arm}: flush "
                  f"{[round(r['flush_ms'], 2) for r in mine]} ms (median "
                  f"{statistics.median(r['flush_ms'] for r in mine):.2f}), "
                  f"merge {[round(r['merge_ms'], 2) for r in mine]}, "
                  f"assembly {[round(r['assembly_ms'], 2) for r in mine]}, "
                  f"ingest {[round(r['samples_per_s']) for r in mine]} "
                  f"samples/s, launches {mine[0]['launches']} | "
                  f"{'; '.join(cards)}")
    srv = run_server(devices[0])
    print(f"timing mesh_cards server: shards on {srv['shard_devices']}, "
          f"{srv['lines_per_s']:.0f} lines/s, S1 {srv['S1_ms']:.2f} ms | "
          f"{'; '.join(cards)}")
    print(json.dumps({"runs": recs, "server": srv}))
    print(json.dumps({"ok": True, "cards": n}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
