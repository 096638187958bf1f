"""The control of the correctness check: the reference put in the port's
place, computed in bfloat16 (the precision below the f32 that the
configurations state), and judged like a run.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 \\
        [--seconds S]

For each seed it builds what the cell's generators would send in a run
of S seconds, splits every key's samples over one flush an interval,
computes each flush's rows from the samples rounded to bfloat16, and
prints the judge's numbers; the control has failed when `correct` is
false. No device is used: the rows are the reference's own.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import run
from .gen import statsd as sgen
from .reference import local as lref


def bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bfloat16 (ties to even)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def hazen(x: np.ndarray, qs) -> np.ndarray:
    return np.quantile(np.asarray(x, np.float64), qs, method="hazen")


def local_rows(sent: lref.Sent, flushes: int, qs) -> list:
    """Each key's samples split into `flushes` even runs; the rows of
    each run from bfloat16 samples."""
    out = [dict() for _ in range(flushes)]
    for kind, d in sent.kinds.items():
        rows = [([], []) for _ in range(flushes)]
        for i, key in enumerate(d["keys"].tolist()):
            seq = d["vals"][d["start"][i]:d["start"][i] + d["n"][i]]
            for j, part in enumerate(np.array_split(seq, flushes)):
                if not len(part):
                    continue
                if kind == sgen.TIMER:
                    p = bf16(part)
                    v = np.r_[hazen(p, qs), p.min(), p.max(), len(p)]
                elif kind == sgen.COUNTER:
                    v = float(part.sum())
                elif kind == sgen.GAUGE:
                    v = float(part[-1])
                else:
                    v = float(len(part))
                rows[j][0].append(key)
                rows[j][1].append(v)
        for j, (k, v) in enumerate(rows):
            if k:
                out[j][kind] = (np.array(k, np.int64), np.array(v))
    return out


def local(cell: dict, seed: int, seconds: float) -> dict:
    conf, traffic = cell["config"], cell["traffic"]
    interval = float(conf["interval_s"])
    total = int(float(traffic["rate_lines_per_s"]) * seconds)
    pools = sgen.pool_lines(traffic, seed, total)
    sent_n = [int(round(total * s)) for s in sgen.sender_shares(traffic,
                                                                 seed)]
    sent = lref.Sent(traffic, seed, pools, sent_n)
    srv = conf["server"]
    qs = tuple(srv["percentiles"])
    rows = local_rows(sent, max(1, int(seconds // interval)), qs)
    return lref.judge(sent, rows, qs, srv["tpu_compression"],
                      srv["tpu_hll_precision"], seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True,
                    help="<config>.<traffic>, listed in BENCHMARK.json or "
                         "not")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    a = ap.parse_args(argv)
    config, traffic = a.workload.split(".", 1)
    cell = run.cell_from_files(f"portbench/configs/{config}.json", traffic)
    for seed in (int(s) for s in a.seeds.split(",")):
        v = local(cell, seed, a.seconds)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "correct": v["correct"], "checks": v["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
