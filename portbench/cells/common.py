"""What the cell drivers share: the generator processes, the flush
schedule and the FrameSet reader."""

from __future__ import annotations

import gc
import json
import os
import re
import select
import subprocess
import sys
import time

import numpy as np

from .. import trace as tr
from ..gen import statsd as gen

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Procs:
    """Generator processes started with `python -m <module> <spec>`: each
    prints one JSON line when ready and one report when told to stop."""

    def __init__(self, module: str, specs: list):
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", module, json.dumps(s)], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            for s in specs]

    def _line(self, p, timeout: float) -> dict:
        r, _, _ = select.select([p.stdout], [], [], timeout)
        if not r:
            raise RuntimeError(f"generator {p.pid} said nothing in "
                               f"{timeout} s")
        line = p.stdout.readline()
        if not line:
            raise RuntimeError(f"generator {p.pid} exited with "
                               f"{p.wait()}")
        return json.loads(line)


    def tell(self, msgs: list) -> None:
        """One JSON line to each process."""
        for p, m in zip(self.procs, msgs):
            p.stdin.write(json.dumps(m) + "\n")
            p.stdin.flush()

    def reports(self, timeout: float = 60.0) -> list:
        """The next line of each process."""
        return [self._line(p, timeout) for p in self.procs]

    def stop(self, timeout: float = 60.0) -> list:
        for p in self.procs:
            p.stdin.write("stop\n")
            p.stdin.flush()
        out = self.reports(timeout)
        self.close()
        return out

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.stdin.close()
                except OSError:
                    pass
                try:
                    p.wait(10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


def lines_between(timeline: list, t0: float, t1: float) -> float:
    """Lines a generator sent in [t0, t1], from its (time, lines) marks."""
    t = np.array([m[0] for m in timeline])
    n = np.array([m[1] for m in timeline], np.float64)
    return float(np.interp(t1, t, n) - np.interp(t0, t, n))


def wait_until(t: float) -> None:
    while True:
        d = t - time.monotonic()
        if d <= 0:
            return
        time.sleep(min(d, 0.05))


class NameCodes(dict):
    """Row name (a histogram's tuple of row names, or a scalar's name)
    -> the generator's key code, or -1 for a row of no generated key;
    each name parsed once."""

    TIMER = re.compile(r"pb\.(?:lat|g)\.(\d+)\.")
    SCALAR = re.compile(r"pb\.(hits|temp|users)\.(\d+)$")
    KIND = {"hits": gen.COUNTER, "temp": gen.GAUGE, "users": gen.SET}

    def __missing__(self, name):
        code = -1
        if isinstance(name, tuple):
            m = self.TIMER.match(name[0])
            if m:
                code = gen.TIMER << gen.KEY_BITS | int(m.group(1))
        else:
            m = self.SCALAR.match(name)
            if m:
                code = self.KIND[m.group(1)] << gen.KEY_BITS | int(m.group(2))
        self[name] = code
        return code


def histo_columns(names: tuple, qs: tuple) -> list:
    """Column order of a histogram block: [p for qs] + [min, max, count]."""
    sufs = [n.rsplit(".", 1)[1] if n.count(".") else n for n in names]
    want = [f"{q * 100:g}percentile" for q in qs] + ["min", "max", "count"]
    return [sufs.index(w) for w in want]


def read_frameset(fs, codes: NameCodes, qs: tuple, self_names: tuple):
    """One flush's rows: [(codes, values)] per block, the histogram
    blocks' columns put in the reference's order, and the self-metrics
    named in `self_names`."""
    blocks = []
    for frame in fs.frames:
        for names, _tags, values, _types in frame.blocks:
            c = np.fromiter(map(codes.__getitem__, names), np.int64,
                            len(names))
            if values.shape[1] > 1:
                mine = np.flatnonzero(c >= 0)
                if not len(mine):
                    continue
                values = values[:, histo_columns(names[mine[0]], qs)]
            blocks.append((c, values))
    extra = {m.name: m.value for m in fs.extra if m.name in self_names}
    return blocks, extra


def by_kind(blocks: list) -> dict:
    """kind -> (keys, values) of one flush's generated rows."""
    out = {}
    for c, v in blocks:
        mine = c >= 0
        for kind in np.unique(c[mine] >> gen.KEY_BITS):
            sel = mine & ((c >> gen.KEY_BITS) == kind)
            keys = c[sel] & ((1 << gen.KEY_BITS) - 1)
            vals = v[sel] if v.shape[1] > 1 else v[sel, 0]
            if int(kind) in out:
                k0, v0 = out[int(kind)]
                keys, vals = np.r_[k0, keys], np.concatenate([v0, vals])
            out[int(kind)] = (keys, vals)
    return out


def check_tags(fs, codes: NameCodes) -> int:
    """Rows of the final flush whose tags are not their key's."""
    bad = 0
    for frame in fs.frames:
        for names, tags, _values, _types in frame.blocks:
            for name, tg in zip(names, tags):
                c = codes[name]
                if c >= 0 and sorted(tg) != gen.expected_tags(
                        c >> gen.KEY_BITS, c & ((1 << gen.KEY_BITS) - 1)):
                    bad += 1
    return bad


def collect_quietly() -> None:
    """One full collection before the window: every run starts it with
    the collector's generations empty, so the collections that fall in
    the window depend on the work done there, not on set-up's leftovers."""
    gc.collect()


SELF = ("veneur.flush.swap_duration_ns", "veneur.flush.merge_duration_ns",
        "veneur.flush.assembly_duration_ns")


def warm(srv, t_go: float, interval: float, n: int, codes, qs,
         probe=None) -> tuple:
    """The set-up's flushes but the last, one an interval from `t_go`,
    then one full collection; the window opens with the last, at `t_go`
    + n intervals. Returns their rows and `probe()` read after each."""
    rows, probes = [], []
    for k in range(1, n):
        wait_until(t_go + k * interval)
        rows.append(read_frameset(srv.flush_once(), codes, qs, SELF)[0])
        if probe is not None:
            probes.append((probe(), time.monotonic()))
    collect_quietly()
    return rows, probes


class Recorders:
    """What a run records besides its flush timings: the collector's
    pauses in every run, and in a `--trace 1` run the compress launches
    and the device's trace. Started before the load starts, so that
    starting the profiler holds up no traffic, and read once the load
    has stopped."""

    def __init__(self, device, traced: bool):
        self.on, self.stopped = traced, False
        self.gc = tr.GcLog()
        if traced:
            self.dev = tr.DeviceTrace(device)
            self.comp = tr.CompressLog(self.dev)

    def start(self, settle_s: float = 2.0):
        """Start recording; a traced run then gives the profiler
        `settle_s` seconds to finish starting before any traffic comes."""
        self.gc.start()
        if self.on:
            self.comp.start()
            time.sleep(settle_s)

    def stop(self):
        if not self.stopped:
            self.stopped = True
            self.gc.stop()
            if self.on:
                self.comp.stop()


def thread_cpu_s(tid: int):
    """CPU seconds, user and system, of thread `tid` of this process
    (`/proc/self/task/<tid>/stat`, in clock ticks), or None where the
    thread cannot be read."""
    try:
        with open(f"/proc/self/task/{tid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def cpu_clocks(threads: dict) -> dict:
    """CPU seconds read together: the whole process's (every thread, user
    and system; child processes are not in it), the calling thread's,
    and each of `threads`' (name -> native thread id)."""
    out = {"process": time.clock_gettime(time.CLOCK_PROCESS_CPUTIME_ID),
           "main": time.thread_time()}
    for name, tid in threads.items():
        out[name] = thread_cpu_s(tid)
    return out


def timed_flush(srv) -> tuple:
    """`srv.flush_once()` and the calling thread's CPU seconds in it."""
    c0 = time.thread_time()
    fs = srv.flush_once()
    return fs, time.thread_time() - c0


def window(srv, conf: dict, args, codes, qs, idle_name: str, close,
           recorders: Recorders, t_open: float, probe=None,
           threads: dict | None = None) -> dict:
    """The measured window: whole intervals of `--seconds`, from the
    flush that opens it at `t_open` to the call of the flush that closes
    the last interval. It calls `Server.flush_once` every interval, each
    call timed, its rows read and its FrameSet dropped; the opening
    flush's rows come first in `rows` and its call is not among
    `flushes`, so the samples in `flushes`' rows are those landed in the
    window. Then `close()`, which stops the load and returns what the
    generators report, and only then are the recorders stopped and read,
    so that reading the trace holds up no traffic. `probe()`, where
    given, is read after each flush.

    The CPU clocks (`cpu_clocks`, with `threads`) are read with `t_w0`
    and `t_w1`, and the calling thread's CPU inside each `flush_once`
    call: the opening one as `open_flush_cpu_s`, the others as each
    flush's `cpu_s`."""
    interval = float(conf["interval_s"])
    threads = threads or {}
    out = {"flushes": [], "rows": []}
    try:
        wait_until(t_open)
        gc0 = [g["collections"] for g in gc.get_stats()]
        t_w0, p_w0 = time.monotonic(), time.perf_counter()
        c_w0 = cpu_clocks(threads)
        fs, out["open_flush_cpu_s"] = timed_flush(srv)
        out["rows"].append(read_frameset(fs, codes, qs, SELF)[0])
        del fs
        for k in range(1, max(1, int(args.seconds // interval)) + 1):
            wait_until(t_w0 + k * interval)
            t_w1, t0 = time.monotonic(), time.perf_counter()
            c_w1 = cpu_clocks(threads)
            fs, cpu_s = timed_flush(srv)
            t1 = time.perf_counter()
            blocks, extra = read_frameset(fs, codes, qs, SELF)
            del fs
            out["rows"].append(blocks)
            f = {"t0": t0, "t1": t1, "cpu_s": cpu_s,
                 "swap_ns": extra.get(SELF[0], 0.0),
                 "merge_ns": extra.get(SELF[1], 0.0),
                 "assembly_ns": extra.get(SELF[2], 0.0)}
            if probe is not None:
                f["probe"], f["probe_at"] = probe(), time.monotonic()
            out["flushes"].append(f)
        out.update(t_w0=t_w0, t_w1=t_w1, p_w0=p_w0, p_w1=t0,
                   cpu_clocks=(c_w0, c_w1))
        out["gc_collections"] = [g["collections"] - n for g, n
                                 in zip(gc.get_stats(), gc0)]
    finally:
        out["reports"] = close()
        recorders.stop()
    out["gc_spans"] = [tuple(x) for x in recorders.gc.spans()
                       if x[1] > out["p_w0"] and x[0] < out["p_w1"]]
    if recorders.on:
        host = {"gc": out["gc_spans"],
                "flush": [(f["t0"], f["t1"]) for f in out["flushes"]]}
        out["trace"] = tr.summarize(recorders.dev, recorders.comp.calls,
                                    out["p_w0"], out["p_w1"], host,
                                    idle_name)
    return out


def flush_notes(win: dict) -> list:
    """The window's flushes, one by one, and its collections."""
    f = win["flushes"]
    return ["flush walls ms " + str([round((x["t1"] - x["t0"]) * 1e3, 1)
                                     for x in f]),
            "swap ms " + str([round(x["swap_ns"] / 1e6, 1) for x in f]),
            "collections in the window by generation "
            + str(win.get("gc_collections")),
            "collector ms outside the flushes %.1f" % (
                tr.outside_s(win["gc_spans"], [(x["t0"], x["t1"]) for x in f])
                * 1e3)]


def cpu_split(win: dict) -> dict:
    """The CPU seconds that the port's process spent from `t_w0` to
    `t_w1`: the process's, less the harness's calling thread's, plus
    that thread's inside the flush_once calls that start in the span
    (the opening one and all but the last of `flushes`), as `window_s`;
    beside it those parts, and `<name>_s` for each thread read."""
    c0, c1 = win["cpu_clocks"]
    flush = win["open_flush_cpu_s"] + sum(f["cpu_s"]
                                          for f in win["flushes"][:-1])
    out = {"process_s": c1["process"] - c0["process"],
           "main_s": c1["main"] - c0["main"], "flush_s": flush}
    out["window_s"] = out["process_s"] - out["main_s"] + flush
    for name in c0.keys() - {"process", "main"}:
        if c0[name] is not None and c1[name] is not None:
            out[name + "_s"] = c1[name] - c0[name]
    return out


def record(kind: str, conf: dict, args, win: dict, phases: dict,
           verdict: dict, peak: int, attempted: float) -> dict:
    """The run's record, which the metric readers read."""
    verdict["notes"] += flush_notes(win)
    rec = {"kind": kind, "interval_s": float(conf["interval_s"]),
           "window_s": win["t_w1"] - win["t_w0"],
           "setup_s": win["t_w0"] - args.process_start,
           "setup_phases_s": phases,
           "flushes": win["flushes"], "p_w0": win["p_w0"],
           "p_w1": win["p_w1"], "attempted": int(round(attempted)),
           "failed": verdict["failed"], "correct": verdict["correct"],
           "checks": verdict["checks"], "notes": verdict["notes"],
           "memory_peak_bytes": peak, "cpu": cpu_split(win)}
    for k in ("trace", "gc_spans"):
        if k in win:
            rec[k] = win[k]
    return rec


def device_peak(device) -> int:
    import torch
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))
