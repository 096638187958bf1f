#!/usr/bin/env python3
"""On-card smoke run of veneur_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It needs one CUDA card, nvcc (CUDA_HOME, PATH or /usr/local/cuda), torch
and numpy, and imports nothing but the port. Phases, each of which fails
the run:

  1. build     nvcc compiles veneur_tpu_torch/csrc/*.cu into one library
               under veneur_tpu_torch/_build/ (keyed on a hash of the
               sources); prints the build seconds and the ptxas report.
  2. compress  the t-digest compress kernel against its plain torch
               version at the serving shape (K=32768 rows, C=256
               centroids, B=256 buffer) with a legal centroid prefix and
               adversarial rows (+-0.0, duplicates, a NaN payload, a
               zero-weight tail, an empty buffer, empty rows), plus the
               C=64 cluster-overflow clip at a small shape.
  3. hll_stats the HLL estimate reduction against its plain version at
               [4096, 16384] u8 registers and at a ragged [37, 1000].
  4. main path AggregationEngine(EngineConfig()) on the card: DogStatsD
               datagrams through parse_packet -> process, bulk batches
               through ingest_*_batch, one interval above the 0.75
               dirty threshold (the full flush), a hot key with 50k
               samples in one batch (the hot-slot sidestep) and an
               empty double flush, held against numpy truth. Both
               kernels' launch counters, set to 0 just before, must rise
               in this run. Then a second engine with the incremental
               flush off (not counted) is fed the same data and must
               flush bit-identical rows.
  5. timing    median kernel and plain-version times at the serving
               shapes, against each kernel's bound, and the flush times.

Then it prints one JSON line describing every kernel, the card's name
and power limit as nvidia-smi reports them, and, last, the device line
{"ok": true, "device": {...}}. Without a card, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bandwidth and f32 rate outside
# the tensor cores; a kernel's bound is the larger of bytes / bandwidth
# and operations / rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# serving shapes at the default EngineConfig
SERVE_K, SERVE_C, SERVE_B = 32768, 256, 256
SERVE_SETS, SERVE_M = 4096, 16384


class Phase:
    """Runs named phases, keeps going after a failure, and remembers
    every failure so the run can exit non-zero at the end."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        t0 = time.monotonic()
        print(f"== phase {name}", flush=True)
        try:
            out = fn(*args)
        except Exception:  # a failed phase fails the run, at the end
            traceback.print_exc()
            self.failed.append(name)
            print(f"== phase {name}: FAILED after "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
            return None
        print(f"== phase {name}: ok in {time.monotonic() - t0:.1f} s",
              flush=True)
        return out


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps, warmup=1):
    """Median milliseconds of `fn()` over `reps` runs, each bracketed by
    CUDA events on the card (host clock on the CPU, for rehearsals)."""
    import torch
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=60,
        check=True, text=True)
    return out.stdout.strip().splitlines()[0].strip()


# ------------------------------------------------------------- phase 1

def phase_build():
    from veneur_tpu_torch.kernels import _build
    _build.load()
    path, secs, log = _build.last_build
    print(f"library {os.path.relpath(path, ROOT)} built in {secs:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "error" in line:
            print("  " + line.strip())
    return {"build_s": secs, "library": os.path.relpath(path, ROOT)}


# ------------------------------------------------------------- phase 2

def compress_inputs(device, K, C, B, seed=0, adversarial=True):
    """A [K, C] legal centroid prefix (made by the plain compress from
    a lognormal buffer) plus a fresh [K, B] buffer, as in the JAX
    package's fused-compress tests; adversarial rows at the head."""
    import torch
    from veneur_tpu_torch.ops import tdigest
    rng = np.random.default_rng(seed)
    z = torch.zeros(K, C, dtype=torch.float32, device=device)
    fill = torch.as_tensor(rng.integers(1, B + 1, K), device=device)
    lane = torch.arange(B, device=device)
    v0 = torch.as_tensor(rng.lognormal(3, 1, (K, B)).astype(np.float32),
                         device=device)
    w0 = (lane[None, :] < fill[:, None]).float()
    mean, weight = tdigest.compress_plain(z, z, v0, w0, 100.0)
    bv = rng.normal(20, 30, (K, B)).astype(np.float32)
    bw = (np.abs(rng.normal(1, 0.5, (K, B))) + 0.01).astype(np.float32)
    if adversarial:
        m0 = mean[:, 0].cpu().numpy()
        bv[:, 0] = -0.0                      # signed-zero key folding
        bv[:, 1] = 0.0
        bv[:, 2] = bv[:, 3]                  # duplicate values
        bv[:, 5] = m0                        # duplicates of prefix means
        bv[0, 4] = np.frombuffer(np.uint32(0x7FC01234).tobytes(),
                                 np.float32)[0]   # NaN with a payload
        bw[2, 100:] = 0.0                    # zero-weight buffer tail
        bw[3, :] = 0.0                       # empty buffer, live prefix
        bw[4, :] = 0.0                       # empty row
        weight[4] = 0.0
        mean[4] = 0.0
        weight[5] = 0.0                      # empty prefix, full buffer
        mean[5] = 0.0
    return (mean.contiguous(), weight.contiguous(),
            torch.as_tensor(bv, device=device),
            torch.as_tensor(bw, device=device))


def sr02_ok(mean, weight, skip):
    """Per row: positive weights form a prefix, and their means are
    non-decreasing. Rows in `skip` (those fed a NaN, whose order is
    outside the contract in both packages) are not checked."""
    pos = weight > 0
    prefix = (pos[:, 1:] <= pos[:, :-1]).all(dim=1)
    both = pos[:, 1:] & pos[:, :-1]
    order = ((mean[:, 1:] >= mean[:, :-1]) | ~both).all(dim=1)
    return bool((prefix & order | skip).all())


def diff_stats(a, b):
    """(rows equal bit for bit, max |a-b| over positions where neither
    is NaN, whether the NaN masks agree)."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    same = (a == b) | (na & nb)
    rows_equal = int(same.all(dim=1).sum())
    ok = ~(na | nb)
    d = (a - b).abs()
    d = torch.where(ok, d, torch.zeros_like(d))
    return rows_equal, float(d.max()) if d.numel() else 0.0, \
        bool(torch.equal(na, nb))


def check_adversarial_rows(args, km, kw, pm, pw):
    """Each adversarial row of `compress_inputs`, on its own: bit for bit
    equal to the plain version, plus what that row must keep."""
    import torch
    mean, weight, bv, bw = args
    for r, what in enumerate(("NaN payload", "signed zeros and duplicates",
                              "zero-weight buffer tail",
                              "empty buffer, live prefix", "empty row",
                              "empty prefix, full buffer")):
        same_m = bool(((km[r] == pm[r])
                       | (torch.isnan(km[r]) & torch.isnan(pm[r]))).all())
        check(same_m and torch.equal(kw[r], pw[r]),
              f"adversarial row {r} ({what}) differs from the plain version")
        tot_in = float(weight[r].double().sum() + bw[r].double().sum())
        tot = float(kw[r].double().sum())
        check(abs(tot - tot_in) <= 1e-6 * max(tot_in, 1e-30),
              f"adversarial row {r} ({what}): total weight {tot} != {tot_in}")
    check(bool(torch.isnan(km[0]).any()), "NaN payload row lost its NaN")
    check(float(bw[2, 100:].abs().sum()) == 0.0
          and float(bw[2, :100].sum()) > 0.0,
          "row 2 is not a zero-weight tail")
    for r, src_m, src_w in ((3, mean[3], weight[3]), (5, bv[5], bw[5])):
        live = kw[r] > 0
        lo = float(src_m[src_w > 0].min())
        hi = float(src_m[src_w > 0].max())
        check(bool(live.any()), f"row {r} lost all its weight")
        check(float(km[r][live].min()) >= lo
              and float(km[r][live].max()) <= hi,
              f"row {r}: centroid means outside its inputs' range")
    check(float(kw[4].abs().sum()) == 0.0
          and float(km[4].abs().sum()) == 0.0,
          "empty row is not a fixed point")


def phase_compress(device, K=SERVE_K, C=SERVE_C, B=SERVE_B):
    """Kernel vs plain at the serving shape. Tolerance: none. Both
    versions evaluate the same float64 sums in the same lane order and k1
    in float64, so the run fails unless every row is bit for bit equal
    (NaN positions matching), each row's total weight agrees with its
    inputs within rtol 1e-6, the kernel's output keeps the SR02
    ordering invariant, and each adversarial row passes its own
    checks."""
    import torch
    from veneur_tpu_torch.kernels import compress as kc
    out = {}
    for label, (k, c, b, adv) in {
            "serving": (K, C, B, True),
            "overflow_clip": (5, 64, 512, False)}.items():
        if label == "overflow_clip":
            rng = np.random.default_rng(9)
            z = torch.zeros(k, c, dtype=torch.float32, device=device)
            bv = torch.as_tensor(np.sort(rng.normal(0, 100, (k, b)))
                                 .astype(np.float32), device=device)
            bw = torch.ones(k, b, dtype=torch.float32, device=device)
            args = (z, z.clone(), bv, bw)
        else:
            args = compress_inputs(device, k, c, b, adversarial=adv)
        km, kw = kc.fused_compress(*args, 100.0)
        pm, pw = kc.compress_plain(*args, 100.0)
        sync(device)
        rows_m, err_m, nan_m = diff_stats(km, pm)
        rows_w, err_w, nan_w = diff_stats(kw, pw)
        tot_in = (args[1].double().sum(1) + args[3].double().sum(1))
        tot_k = kw.double().sum(1)
        rel = float(((tot_k - tot_in).abs()
                     / tot_in.clamp(min=1e-30)).max())
        rows_equal = min(rows_m, rows_w)
        rec = {"K": k, "C": c, "B": b, "rows_bitwise_equal": rows_equal,
               "max_abs_err_mean": err_m, "max_abs_err_weight": err_w,
               "nan_masks_agree": nan_m and nan_w,
               "max_rel_err_total_weight": rel,
               "sr02_kernel": sr02_ok(
                   km, kw, torch.isnan(args[0]).any(1)
                   | torch.isnan(args[2]).any(1))}
        print(f"compress {label}: {json.dumps(rec)}")
        check(rec["nan_masks_agree"], f"{label}: NaN positions differ")
        check(rows_equal == k,
              f"{label}: only {rows_equal}/{k} rows bitwise equal")
        check(rel <= 1e-6, f"{label}: total weight rel err {rel}")
        check(rec["sr02_kernel"], f"{label}: SR02 order broken")
        if label == "overflow_clip":
            check(float(kw[:, -1].min()) > 1.0,
                  "overflow clip did not happen")
        if adv:
            check_adversarial_rows(args, km, kw, pm, pw)
        out[label] = rec
    out["max_abs_err"] = max(max(r["max_abs_err_mean"],
                                 r["max_abs_err_weight"])
                             for r in out.values())
    return out


# ------------------------------------------------------------- phase 3

def hll_inputs(device, K, m, seed=1):
    """u8[K, m] registers as a real bank holds them: row r filled to a
    random fraction with geometric ranks, row 0 all zero, row 1 half."""
    import torch
    rng = np.random.default_rng(seed)
    fill = rng.random(K)
    live = rng.random((K, m), dtype=np.float32) < fill[:, None]
    rho = np.minimum(rng.geometric(0.5, (K, m)), 51)
    regs = np.where(live, rho, 0).astype(np.uint8)
    regs[0] = 0
    regs[1, : m // 2] = 0
    return torch.as_tensor(regs, device=device)


def phase_hll(device, K=SERVE_SETS, m=SERVE_M):
    """Kernel vs plain. Tolerance: ez exact (an integer count); zsum
    rtol 1e-6 (both sum exact powers of two in f32, in different
    orders)."""
    import torch
    from veneur_tpu_torch.kernels import hll_stats as kh
    out = {}
    for label, (k, mm) in {"serving": (K, m), "ragged": (37, 1000)}.items():
        regs = hll_inputs(device, k, mm)
        ez_k, zs_k = kh.hll_stats(regs)
        ez_p, zs_p = kh.hll_stats_plain(regs)
        sync(device)
        rel = float(((zs_k.double() - zs_p.double()).abs()
                     / zs_p.double()).max())
        rec = {"K": k, "m": mm, "ez_exact": bool(torch.equal(ez_k, ez_p)),
               "max_rel_err_zsum": rel,
               "max_abs_err": float(torch.maximum(
                   (ez_k - ez_p).abs().max(), (zs_k - zs_p).abs().max()))}
        print(f"hll_stats {label}: {json.dumps(rec)}")
        check(rec["ez_exact"], f"{label}: ez differs")
        check(rel <= 1e-6, f"{label}: zsum rel err {rel}")
        out[label] = rec
    out["max_abs_err"] = max(r["max_abs_err"] for r in out.values())
    return out


# ------------------------------------------------------------- phase 4

def _datagrams(rng, n, tag):
    """n DogStatsD lines over a few hundred keys of every type."""
    lines = []
    for i in range(n):
        k = int(rng.integers(0, 200))
        kind = i % 5
        if kind == 0:
            lines.append(f"dg.lat.{k}:{rng.lognormal(3, 1):.4f}|ms"
                         f"|#shard:{k % 4},run:{tag}")
        elif kind == 1:
            lines.append(f"dg.size.{k}:{rng.gamma(2, 50):.3f}|h")
        elif kind == 2:
            lines.append(f"dg.hits.{k}:{int(rng.integers(1, 9))}|c|@0.5")
        elif kind == 3:
            lines.append(f"dg.temp.{k}:{rng.normal(50, 10):.2f}|g")
        else:
            lines.append(f"dg.users.{k % 20}:u{int(rng.integers(0, 5000))}"
                         "|s")
    lines.append(f"_sc|dg.check|1|#run:{tag}|m:ok")
    return [ln.encode() for ln in lines]


class Truth:
    """Host-side truth of one interval, keyed like the flushed rows."""

    def __init__(self):
        self.histo = {}    # (name, tags) -> list of f32 samples
        self.counter = {}  # (name, tags) -> float sum
        self.gauge = {}    # (name, tags) -> last value
        self.sets = {}     # (name, tags) -> set of members / count

    def add_parsed(self, m):
        key = (m.key.name, tuple(m.key.joined_tags.split(","))
               if m.key.joined_tags else ())
        t = m.key.type
        if t in ("timer", "histogram"):
            self.histo.setdefault(key, []).append(np.float32(m.value))
        elif t == "counter":
            self.counter[key] = self.counter.get(key, 0.0) \
                + float(np.float32(m.value)) / m.sample_rate
        elif t == "gauge":
            self.gauge[key] = float(np.float32(m.value))
        elif t == "set":
            self.sets.setdefault(key, set()).add(m.value)


def _intern(interner, names, mtype):
    from veneur_tpu_torch.ingest.parser import MIXED_SCOPE, MetricKey
    return np.array([interner.lookup(MetricKey(n, mtype, ""), MIXED_SCOPE)
                     for n in names], np.int32)


def _feed_histos(eng, slots, vals, batch):
    for i in range(0, len(slots), batch):
        s = slots[i:i + batch]
        eng.ingest_histo_batch(s, vals[i:i + batch],
                               np.ones(len(s), np.float32), count=len(s))


def build_interval(rng, spec, tag):
    """The data of one interval, as plain arrays and byte lines, so two
    engines can be fed exactly the same stream."""
    n = spec.get("datagrams", 0)
    d = {"lines": _datagrams(rng, n, tag) if n else []}
    nh, per = spec.get("histos", (0, 0))
    if nh:
        vals = rng.lognormal(3, 1, (nh, per)).astype(np.float32)
        order = rng.permutation(nh * per)
        d["histo"] = (nh, per, vals, order)
    nc = spec.get("counters", 0)
    if nc:
        d["counter"] = rng.integers(1, 100, (nc, 4)).astype(np.float32)
    ng = spec.get("gauges", 0)
    if ng:
        d["gauge"] = rng.normal(0, 100, (ng, 3)).astype(np.float32)
    ns, members = spec.get("sets", (0, 0))
    if ns:
        # 64-bit member hashes: distinct members hash to uniform words
        d["set"] = rng.integers(0, 2 ** 64, (ns, members), dtype=np.uint64)
    hot = spec.get("hot", 0)
    if hot:
        d["hot"] = rng.lognormal(3, 1, hot).astype(np.float32)
    return d


def feed(eng, d, truth=None):
    """Drive one interval's data through the engine's user entry
    points."""
    from veneur_tpu_torch.ingest.parser import (
        ServiceCheck, UDPMetric, parse_packet)
    from veneur_tpu_torch.ops import hll
    b = eng.cfg.batch_size
    for ln in d["lines"]:
        m = parse_packet(ln)
        if isinstance(m, ServiceCheck):
            eng.process_service_check(m)
        elif isinstance(m, UDPMetric):
            eng.process(m)
            if truth is not None:
                truth.add_parsed(m)
    if "histo" in d:
        nh, per, vals, order = d["histo"]
        names = [f"bulk.h.{i}" for i in range(nh)]
        slots = np.repeat(_intern(eng.histo_keys, names, "timer"), per)
        _feed_histos(eng, slots[order], vals.reshape(-1)[order], b)
        if truth is not None:
            for i, n in enumerate(names):
                truth.histo[(n, ())] = vals[i]
    if "counter" in d:
        v = d["counter"]
        names = [f"bulk.c.{i}" for i in range(len(v))]
        slots = np.tile(_intern(eng.counter_keys, names, "counter"),
                        v.shape[1])
        flat = v.T.reshape(-1)
        for i in range(0, len(slots), b):
            s = slots[i:i + b]
            eng.ingest_counter_batch(s, flat[i:i + b],
                                     np.ones(len(s), np.float32),
                                     count=len(s))
        if truth is not None:
            for i, n in enumerate(names):
                truth.counter[(n, ())] = float(v[i].astype(np.float64)
                                               .sum())
    if "gauge" in d:
        v = d["gauge"]
        names = [f"bulk.g.{i}" for i in range(len(v))]
        slots = np.tile(_intern(eng.gauge_keys, names, "gauge"),
                        v.shape[1])
        flat = v.T.reshape(-1)         # write 0 of every key, then 1, 2
        for i in range(0, len(slots), b):
            s = slots[i:i + b]
            eng.ingest_gauge_batch(s, flat[i:i + b], count=len(s))
        if truth is not None:
            for i, n in enumerate(names):
                truth.gauge[(n, ())] = float(v[i, -1])
    if "set" in d:
        h = d["set"]
        names = [f"bulk.s.{i}" for i in range(len(h))]
        slots = np.repeat(_intern(eng.set_keys, names, "set"), h.shape[1])
        idx, rho = hll.host_hash_to_updates(h.reshape(-1),
                                            eng.cfg.hll_precision)
        for i in range(0, len(slots), b):
            s = slots[i:i + b]
            eng.ingest_set_batch(s, idx[i:i + b], rho[i:i + b],
                                 count=len(s))
        if truth is not None:
            for i, n in enumerate(names):
                truth.sets[(n, ())] = len(np.unique(h[i]))
    if "hot" in d:
        v = d["hot"]
        slot = _intern(eng.histo_keys, ["hot.lat"], "timer")[0]
        eng.ingest_histo_batch(np.full(len(v), slot, np.int32), v,
                               np.ones(len(v), np.float32), count=len(v))
        if truth is not None:
            truth.histo[("hot.lat", ())] = v


def rows_of(res):
    return {(m.name, tuple(m.tags)): m for m in res.metrics}


def check_against_truth(res, truth, hll_precision, label):
    """Counts, min, max, counter totals and gauge values exact;
    percentiles within 1% of each key's spread of numpy's quantile
    (method "hazen", the plotting positions a t-digest's singleton
    centroids interpolate between); set estimates within three times
    HLL's nominal standard error, plus one member."""
    rows = rows_of(res)
    worst = {"pct_err_over_spread": 0.0, "set_rel_err": 0.0}
    names = list(truth.histo)
    for key in names:
        v = np.asarray(truth.histo[key], np.float32)
        name, tags = key
        cnt = rows[(name + ".count", tags)].value
        check(cnt == len(v), f"{label} {name}: count {cnt} != {len(v)}")
        check(rows[(name + ".min", tags)].value == float(v.min()),
              f"{label} {name}: min")
        check(rows[(name + ".max", tags)].value == float(v.max()),
              f"{label} {name}: max")
        spread = float(v.max()) - float(v.min())
        want = np.quantile(v.astype(np.float64), [0.5, 0.75, 0.99],
                           method="hazen")
        for q, w in zip(("50", "75", "99"), want):
            got = rows[(f"{name}.{q}percentile", tags)].value
            err = abs(got - w) / spread if spread > 0 else abs(got - w)
            worst["pct_err_over_spread"] = max(
                worst["pct_err_over_spread"], err)
            check(err <= 0.01 + 1e-6,
                  f"{label} {name} p{q}: {got} vs {w} (spread {spread})")
    for key, want in truth.counter.items():
        got = rows[key].value
        check(got == want, f"{label} counter {key}: {got} != {want}")
    for key, want in truth.gauge.items():
        got = rows[key].value
        check(got == want, f"{label} gauge {key}: {got} != {want}")
    stderr = 1.04 / np.sqrt(1 << hll_precision)
    for key, want in truth.sets.items():
        n = want if isinstance(want, int) else len(want)
        got = rows[key].value
        rel = abs(got - n) / n
        worst["set_rel_err"] = max(worst["set_rel_err"], rel)
        # plus one: at a few dozen members a single register collision
        # (one member short) is already more than 3 standard errors
        check(abs(got - n) <= 3 * stderr * n + 1.0,
              f"{label} set {key}: {got} vs {n}")
    n_expected = (6 * len(truth.histo) + len(truth.counter)
                  + len(truth.gauge) + len(truth.sets))
    check(len(res.frame) == n_expected,
          f"{label}: {len(res.frame)} rows, expected {n_expected}")
    return worst


def canon(res):
    return sorted((m.name, tuple(m.tags), int(m.type), repr(m.value))
                  for m in res.metrics)


# interval plans: A incremental (~62% of the histogram slots dirty),
# B above the 0.75 threshold (full flush), C incremental with the hot
# key, D empty
SERVE_PLAN = {
    "A": {"datagrams": 3000, "histos": (20000, 25), "counters": 5000,
          "gauges": 5000, "sets": (1000, 1000)},
    "B": {"datagrams": 1000, "histos": (30000, 4), "counters": 500},
    "C": {"datagrams": 1000, "histos": (1000, 10), "hot": 50000},
    "D": {},
}
EXPECT_PATH = {"A": "incremental", "B": "full", "C": "incremental",
               "D": "incremental"}


def phase_main(device, cfg_kw=None, plan=None):
    """The port's main path at the default configuration, intervals
    A-D, against numpy truth. The launch counters are set to 0 just
    before the engine is built and read just after its last flush, so
    they count the main path alone. Then the same stream goes into a
    second engine with the incremental flush off (outside the count),
    whose rows must be bit-identical in every interval."""
    from veneur_tpu_torch import kernels
    from veneur_tpu_torch.models.pipeline import (
        AggregationEngine, EngineConfig)
    cfg_kw = cfg_kw or {}
    plan = plan or SERVE_PLAN
    rng = np.random.default_rng(7)
    data = {k: build_interval(rng, spec, k) for k, spec in plan.items()}

    out = {"intervals": {}}
    flushed = {}
    kernels.reset_launches()
    eng = AggregationEngine(EngineConfig(**cfg_kw), device=device)
    for i, (label, d) in enumerate(data.items()):
        truth = Truth()
        feed(eng, d, truth)
        before = dict(kernels.launches)
        t0 = time.monotonic()
        res = eng.flush(timestamp=1000 + i)
        ms = (time.monotonic() - t0) * 1e3
        flush_launches = {k: n - before[k]
                          for k, n in kernels.launches.items()}
        path = res.stats["flush_path"]["path"]
        check(path == EXPECT_PATH[label],
              f"{label}: flush path {path}, expected {EXPECT_PATH[label]}")
        worst = check_against_truth(res, truth, eng.cfg.hll_precision,
                                    label)
        if label == "D":
            check(len(res.metrics) == 0, "empty interval flushed rows")
        if label in ("A", "B", "C") and d["lines"]:
            check(any(m.name == "dg.check" for m in res.status_metrics),
                  f"{label}: service check missing")
        flushed[label] = canon(res)
        out["intervals"][label] = {
            "path": path, "flush_ms": ms,
            "merge_ms": res.stats["merge_ns"] / 1e6,
            "rows": len(res.frame),
            "dirty": res.stats["flush_path"].get("dirty"),
            "flush_launches": flush_launches, **worst}
    out["launches"] = dict(kernels.launches)
    print(f"main-path launches: {out['launches']}")
    for name, n in out["launches"].items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    del eng

    ref = AggregationEngine(EngineConfig(flush_incremental=False,
                                         **cfg_kw), device=device)
    for i, (label, d) in enumerate(data.items()):
        feed(ref, d)
        res_ref = ref.flush(timestamp=1000 + i)
        identical = flushed[label] == canon(res_ref)
        rec = out["intervals"][label]
        rec["equal_to_full_flush"] = identical
        print(f"interval {label}: {json.dumps(rec)}")
        check(identical, f"{label}: incremental flush != full flush")
    return out


# ------------------------------------------------------------- phase 5

def compress_bound_ms(K, C, B):
    """Least time for one compress: read mean, weight, buf_value,
    buf_weight once and write two [K, C] outputs; the operations are the
    two comparison networks (a bitonic sort of B and a merge of the
    padded row, ~8 integer ops per exchange) plus ~40 float ops per
    element for the sums, k1 and the cluster tail, at the f32 rate."""
    M = C + B
    P = 1 << (M - 1).bit_length()
    Pb = 1 << (B - 1).bit_length()
    lb = Pb.bit_length() - 1
    exchanges = (Pb // 2) * lb * (lb + 1) // 2 + (P // 2) * (
        P.bit_length() - 1)
    ops = K * (8 * exchanges + 40 * M)
    nbytes = 4 * K * (2 * C + 2 * B) + 4 * K * 2 * C
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3, \
        ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
         else "operations"), nbytes, ops


def hll_bound_ms(K, m):
    """Read K*m register bytes once and write two f32 per row; ~4 ops
    per register (compare, count, exponent build, add)."""
    nbytes = K * m + 8 * K
    ops = 4 * K * m
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(bytes_s, ops_s) * 1e3, \
        "bytes" if bytes_s >= ops_s else "operations", nbytes, ops


def phase_timing(device, K=SERVE_K, C=SERVE_C, B=SERVE_B,
                 KS=SERVE_SETS, m=SERVE_M, reps=(20, 3)):
    from veneur_tpu_torch.kernels import compress as kc
    from veneur_tpu_torch.kernels import hll_stats as kh
    args = compress_inputs(device, K, C, B)
    regs = hll_inputs(device, KS, m)
    out = {}
    bound, by, nbytes, ops = compress_bound_ms(K, C, B)
    out["compress"] = {
        "ms": time_ms(lambda: kc.fused_compress(*args, 100.0), device,
                      reps[0]),
        "plain_ms": time_ms(lambda: kc.compress_plain(*args, 100.0),
                            device, reps[1]),
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops,
        "shape": [K, C, B]}
    bound, by, nbytes, ops = hll_bound_ms(KS, m)
    out["hll_stats"] = {
        "ms": time_ms(lambda: kh.hll_stats(regs), device, reps[0]),
        "plain_ms": time_ms(lambda: kh.hll_stats_plain(regs), device,
                            reps[0]),
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops,
        "shape": [KS, m]}
    return out


# ------------------------------------------------------------- main

KERNELS = (
    ("compress", "veneur_tpu_torch/csrc/compress.cu",
     "veneur_tpu/kernels/compress.py:232"),
    ("hll_stats", "veneur_tpu_torch/csrc/hll_stats.cu",
     "veneur_tpu/kernels/hll_stats.py:75"),
)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card",
              file=sys.stderr)
        return 2
    try:
        import veneur_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from the root of a checkout of the "
              "repository (veneur_tpu_torch not found)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    ph = Phase()
    if ph.run("build", phase_build) is None:
        return 1
    report = {"compress": ph.run("compress", phase_compress, device),
              "hll_stats": ph.run("hll_stats", phase_hll, device),
              "main": ph.run("main path", phase_main, device),
              "timing": ph.run("timing", phase_timing, device)}
    if ph.failed:
        print(f"chip_smoke: failed phases: {', '.join(ph.failed)}",
              file=sys.stderr)
        return 1

    timing, main_out = report["timing"], report["main"]
    for name, t in timing.items():
        print(f"timing {name} {t['shape']}: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}) | {card}")
    for label, rec in main_out["intervals"].items():
        print(f"timing flush {label} ({rec['path']}): "
              f"{rec['flush_ms']:.2f} ms, merge {rec['merge_ms']:.2f} ms, "
              f"kernel launches {rec['flush_launches']} | {card}")
    kernels = []
    for name, source, replaces in KERNELS:
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": main_out["launches"][name],
            "max_abs_err": report[name]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
