"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <config>.<traffic> --seed N \\
        --seconds S --trace 0|1

from the root of a checkout. It reads the cell from BENCHMARK.json, its
configuration from the file the configuration's entry names, its
traffic from `portbench/traffic/<traffic>.json`, and every metric it
reports from `portbench/metrics/<metric-name>.py` (a `read(record)`
that returns the number, or None where the record holds nothing to read
it from). It needs as many CUDA devices as the cell asks for, and exits
with 2, printing no result, where they are not there. The last line of
its standard output is the result; the numbers compared against the
reference close its standard error, each beside its limit.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """This process's start on the time.monotonic clock (Linux: its
    start time in clock ticks since boot)."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        since_boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return now - (since_boot - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


PROCESS_START = _process_start()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "veneur_tpu")


def load_cell(name: str, root: str = ROOT) -> dict:
    """The workload `name` of `root`/BENCHMARK.json with its
    configuration, traffic and metrics, each found by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    cell = cell_from_files(c["file"], w["traffic"], root)

    def mine(m):
        return name in m.get("workloads", [name])

    cell.update(workload=w,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])
    return cell


def cell_from_files(config_file: str, traffic: str, root: str = ROOT):
    """The configuration file and the traffic mix named, as a one-chip
    cell with no metrics: what BENCHMARK.json does not list can still be
    run and judged (tests, the control)."""
    with open(os.path.join(root, config_file)) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           traffic + ".json")) as f:
        traffic_doc = json.load(f)
    return {"workload": {"name": f"{config['name']}.{traffic}", "chips": 1},
            "config": config, "traffic": traffic_doc, "end_to_end": [],
            "per_layer": []}


def reader(metric: str, root: str = ROOT):
    """The `read` of portbench/metrics/<metric>.py."""
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def metrics_of(cell: dict, rec: dict, trace: bool) -> dict:
    """The cell's metrics from the run's record: its end-to-end ones in a
    plain run, its per-layer ones in a traced run. An end-to-end metric
    that reads nothing is the harness's fault and ends the run."""
    out = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        v = reader(m["name"])(rec)
        if v is None:
            if not trace:
                raise RuntimeError(f"{m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    args.process_start = PROCESS_START
    return args


def driver(cell: dict):
    return importlib.import_module("portbench.cells."
                                   + cell["config"]["kind"])


def run_cell(cell: dict, args, device, prep=None) -> dict:
    """Set up, measure and judge one run; returns its record. `prep` is
    what the driver's `prepare` returned, where it was called first."""
    return driver(cell).run(cell, args, device, prep)


def result_of(cell: dict, rec: dict, args, device_info: dict) -> dict:
    res = {"correct": bool(rec["correct"]), "attempted": rec["attempted"],
           "failed": rec["failed"],
           "metrics": metrics_of(cell, rec, bool(args.trace)),
           "device": dict(device_info,
                          memory_peak_bytes=rec["memory_peak_bytes"])}
    if args.trace and "trace" in rec:
        res["device"]["busy_s"] = rec["trace"]["busy_s"]
        res["device"]["window_s"] = rec["trace"]["window_s"]
        res["breakdown"] = rec["trace"]["breakdown"]
    res["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in rec["checks"].items()}
    return res


def main(argv=None) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    # the load generators build their payloads while torch loads
    prep = driver(cell).prepare(cell, args)
    import torch
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        prep["procs"].close()
        print(f"portbench: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rec = run_cell(cell, args, device, prep)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    res = result_of(cell, rec, args, info)
    for n in rec["notes"]:
        print("portbench:", n, file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
