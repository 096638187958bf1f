"""What a run records besides its own timings: the collector's pauses,
and in a `--trace 1` run the compress launches' shapes and the device's
trace. Each recorder is started before the load and read once the
window has closed."""

from __future__ import annotations

import gc
import re
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet


def compress_bound_s(K: int, C: int, B: int) -> float:
    """The bytes bound of one compress of K rows of C centroids and B
    buffer lanes: read mean, weight, buf_value and buf_weight once and
    write two [K, C] outputs, at the HBM bandwidth (0.0601 ms at
    32768 x 256 x 256)."""
    return (4 * K * (2 * C + 2 * B) + 4 * K * 2 * C) / HBM_BYTES_PER_S


class GcLog:
    """Start and end (perf_counter) of every collection, in arrays
    allocated up front."""

    def __init__(self, cap: int = 1 << 16):
        self.t = np.zeros((cap, 2))
        self.n = 0
        self._t0 = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None and self.n < len(self.t):
            self.t[self.n] = (self._t0, time.perf_counter())
            self.n += 1
            self._t0 = None

    def start(self):
        gc.callbacks.append(self._cb)

    def stop(self):
        gc.callbacks.remove(self._cb)

    def spans(self) -> np.ndarray:
        return self.t[:self.n]


class CompressLog:
    """Wraps the port's compress wrapper, whose callers look it up at
    each call, and starts and stops the device trace with it: records
    (K, C, B, from the flush thread, launch time on perf_counter) of each
    launch in launch order. Launches are serialized under one lock, and
    the trace starts and stops under that lock, so the records are the
    trace's compress kernels one for one; every launch goes to the one
    stream the port uses, so the card runs them in that order."""

    def __init__(self, dev):
        self.dev = dev
        self.calls = []
        self._lock = threading.Lock()
        self._orig = None
        self._main = threading.main_thread().ident

    def start(self):
        from veneur_tpu_torch.kernels import compress as kc
        orig = self._orig = kc.fused_compress

        def wrapped(mean, weight, buf_value, buf_weight, compression):
            with self._lock:
                t = time.perf_counter()
                out = orig(mean, weight, buf_value, buf_weight, compression)
                if mean.is_cuda and mean.shape[0] > 0:
                    self.calls.append(
                        (mean.shape[0], mean.shape[1], buf_value.shape[1],
                         threading.get_ident() == self._main, t))
                return out

        with self._lock:
            self.dev.start()
            kc.fused_compress = wrapped

    def stop(self):
        from veneur_tpu_torch.kernels import compress as kc
        with self._lock:
            kc.fused_compress = self._orig
            self.dev.stop()


def _ev_span_ns(ev) -> tuple:
    """(start, end) ns of a kineto event, whichever accessors it has."""
    if hasattr(ev, "start_ns"):
        s = int(ev.start_ns())
    else:
        s = int(ev.start_us() * 1000)
    if hasattr(ev, "end_ns"):
        return s, int(ev.end_ns())
    if hasattr(ev, "duration_ns"):
        return s, s + int(ev.duration_ns())
    return s, s + int(ev.duration_us() * 1000)


class DeviceTrace:
    """torch.profiler over the card, its events put on the host's
    perf_counter clock by a marker kernel launched at each end."""

    MARK = "spin"

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.marks = []

    def _mark(self):
        import torch
        torch.cuda.synchronize(self.device)
        self.marks.append(time.perf_counter())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)

    def start(self):
        """Start tracing."""
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark()

    def stop(self):
        self._mark()
        self.prof.__exit__(None, None, None)

    def events(self) -> list:
        """[(name, start, end)] of every device operation traced, on the
        host's clock, in the order they started."""
        from torch.autograd import DeviceType
        raw = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            raw.append((ev.name(), *_ev_span_ns(ev)))
        raw.sort(key=lambda e: e[1])
        marks = [e for e in raw if self.MARK in e[0]]
        if not marks:
            raise RuntimeError("no marker kernel in the device trace")
        off = self.marks[0] - marks[0][1] / 1e9
        out = []
        for name, s, e in raw:
            if self.MARK in name:
                continue
            out.append((name, s / 1e9 + off, e / 1e9 + off))
        return out


def union_s(spans: list) -> float:
    total, end = 0.0, -np.inf
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(spans: list, t0: float, t1: float) -> list:
    """(start, end) of the device's idle stretches in [t0, t1]."""
    out, cur = [], t0
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out


def overlap(a0, a1, spans) -> float:
    return sum(max(0.0, min(a1, e) - max(a0, s)) for s, e in spans)


def outside_s(spans: list, cover: list) -> float:
    """Seconds of `spans` that no span of `cover` overlaps (each list of
    (start, end), those of `cover` disjoint)."""
    return sum((e - s) - overlap(s, e, cover) for s, e in spans)


def clean_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def summarize(dt: DeviceTrace, compress_calls: list, t0: float, t1: float,
              host: dict, idle_name: str) -> dict:
    """busy_s and window_s over [t0, t1], the compress launches made in
    it with each kernel's device time, and the breakdown: the device
    operations that took most time, and the longest idle gaps named by
    the host span that covers most of each (`host`: name -> [(start,
    end)]; else `idle_name`)."""
    every = dt.events()
    comp = [e - s for name, s, e in every if "compress_kernel" in name]
    if len(comp) != len(compress_calls):
        raise RuntimeError(f"{len(compress_calls)} compress launches "
                           f"recorded, {len(comp)} in the device trace")
    launches = [(*c[:4], d) for c, d in zip(compress_calls, comp)
                if t0 <= c[4] < t1]
    evs = [(n, max(s, t0), min(e, t1)) for n, s, e in every
           if e > t0 and s < t1]
    spans = [(s, e) for _, s, e in evs]
    busy = union_s(spans)
    by_name = {}
    for name, s, e in evs:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    named = []
    for g0, g1 in sorted(gaps(spans, t0, t1),
                         key=lambda g: g[0] - g[1])[:10]:
        # in the order given: a later span counts only where no earlier
        # one does (a collection inside a flush is the collector's)
        cover, taken = {}, 0.0
        for k, v in host.items():
            o = overlap(g0, g1, v)
            cover[k] = max(0.0, o - taken)
            taken = max(taken, o)
        best = max(cover, key=cover.get) if cover else None
        named.append([best if best and cover[best] > 0 else idle_name,
                      g1 - g0])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": t1 - t0,
            "compress": launches, "kernels": by_name,
            "breakdown": {"device_ops": [[clean_name(k), v] for k, v in top],
                          "idle_gaps": named}}
