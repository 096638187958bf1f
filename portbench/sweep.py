"""Offered-rate sweep of an open-loop cell, to find its knee.

    python3 -m portbench.sweep --workload local-native.steady \\
        --rates 200000,250000,300000 --seeds 11,12,13 --seconds 10

Runs the cell once for each rate and seed, each in a process of its
own with the traffic's one `rate_*_per_s` key replaced, and prints one
JSON line a run: the lines offered, the samples the rows show missing,
whether the run was correct, the samples a second absorbed, the mean
flush, and how late the senders ran (null where the cell's record has
none of these). Its last line is the knee: the highest rate at which
no run, at it or below it, lost a sample. The cell's rate is set below
it by hand.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def with_rate(traffic: dict, rate: float) -> dict:
    """The traffic with its one `rate_*_per_s` key set to `rate`."""
    keys = [k for k in traffic
            if k.startswith("rate_") and k.endswith("_per_s")]
    if len(keys) != 1:
        raise SystemExit("a swept traffic has one rate_*_per_s key, "
                         f"not {keys}")
    return dict(traffic, **{keys[0]: rate})


def one(workload: str, rate: float, seed: int, seconds: float) -> dict:
    import torch

    from . import run
    cell = run.load_cell(workload)
    cell["traffic"] = with_rate(cell["traffic"], rate)
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds)])
    rec = run.run_cell(cell, args, torch.device("cuda", 0))
    for n in rec["notes"]:
        print(f"{rate:.0f} {seed}:", n, file=sys.stderr)
    return {"rate": rate, "seed": seed, "attempted": rec["attempted"],
            "failed": rec["failed"], "correct": rec["correct"],
            "samples_per_s": run.reader("samples_per_s")(rec),
            "flush_ms": run.reader("server.flush_ms")(rec),
            "max_lag_s": rec.get("max_lag_s"),
            "sent_lines": rec.get("sent_lines"), "bridge": rec.get("bridge"),
            "checks": rec["checks"]}


def knee(results: list):
    """The highest rate at which no run, at it or below it, failed."""
    best = None
    for r in sorted({x["rate"] for x in results}):
        if any(x.get("failed", 1) or x.get("rc") for x in results
               if x["rate"] == r):
            break
        best = r
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seeds", default="7")
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--one", type=float)
    a = ap.parse_args(argv)
    if a.one is not None:
        print(json.dumps(one(a.workload, a.one, int(a.seeds), a.seconds)),
              flush=True)
        return 0
    from . import run
    with_rate(run.load_cell(a.workload)["traffic"], 0)  # before any run
    results = []
    for r in a.rates.split(","):
        for seed in a.seeds.split(","):
            out = subprocess.run(
                [sys.executable, "-m", "portbench.sweep", "--workload",
                 a.workload, "--rates", r, "--one", r, "--seconds",
                 str(a.seconds), "--seeds", seed],
                stdout=subprocess.PIPE, text=True)
            line = (out.stdout.strip().splitlines() or ["{}"])[-1]
            res = (json.loads(line) if out.returncode == 0 else
                   {"rate": float(r), "seed": int(seed),
                    "rc": out.returncode})
            results.append(res)
            print(json.dumps(res), flush=True)
    print(json.dumps({"knee": knee(results)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
