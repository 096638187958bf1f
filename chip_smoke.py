#!/usr/bin/env python3
"""On-card smoke run of veneur_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It needs one CUDA card, nvcc (CUDA_HOME, PATH or /usr/local/cuda), torch
and numpy, and imports nothing but the port. Phases, each of which fails
the run:

  1. build     nvcc compiles veneur_tpu_torch/csrc/*.cu (one nvcc per
               source, all started together, then one link) into one
               library under veneur_tpu_torch/_build/ (keyed on a hash
               of the sources); prints the build seconds, the ptxas
               report and the compress kernel's shared memory and rows
               in flight per SM at the serving shape, then launches the
               probe kernel (x + 1 on f32[8, 128]) and fails unless
               every element reads 1.0.
  2. compress  the t-digest compress kernel against its plain torch
               version at the serving shape (K=32768 rows, C=256
               centroids, B=256 buffer) with a legal centroid prefix and
               adversarial rows (+-0.0, duplicates, a NaN payload, a
               zero-weight tail, an empty buffer, empty rows), plus the
               C=64 cluster-overflow clip at a small shape.
  3. hll_stats the HLL estimate reduction against its plain version at
               [4096, 16384] u8 registers and at a ragged [37, 1000].
  4. ull_insert the ULL scatter-join insert against its plain version on
               a [4096, 8192] bank, each case every byte equal and
               re-landing its batch changing nothing: the serving batch
               of 8192 (random canonical and non-canonical bytes, 25%
               duplicated targets with conflicting values, padding, the
               last slot and register, one register hit 1000 times, the
               four registers of one word hit together, the uint32 key
               edges), the engine's landing size (131072 updates of the
               same kinds), 8192 and 131072 updates on the four bytes of
               one word, the key edges alone, and the serving batch
               through views at an offset.
  5. main path, twice, through AggregationEngine on the card: the default
               EngineConfig() (t-digest + HLL), then
               histogram_backend="req", set_backend="ull". Each: DogStatsD
               datagrams through parse_packet -> process, bulk batches
               through ingest_*_batch, one interval above the 0.75
               dirty threshold (the full flush), a hot key with 50k
               samples in one batch (the hot-slot sidestep) and an
               empty double flush, held against numpy truth under the
               engine pair's contract. The launch counters are set to 0
               just before each path and read just after it: each path
               must launch its own kernels (default: compress, hll_stats;
               req+ull: ull_insert; both: the probe, at engine
               construction) and none of the other path's. Set ingest is
               timed (the bulk set loop of interval A, ended by landing
               the landing buffer's remainder and a synchronize:
               updates/s) and its ull_insert launches are
               held to one per landing buffer of updates plus one a
               flush. Then a second engine with the incremental flush off
               (not counted) is fed the same data and must flush
               bit-identical rows.
  6. timing    median kernel and plain-version times at the serving
               shapes, each kernel's device time from torch.profiler and
               its host share (time a call - device time), against each
               kernel's bound, and the flush times; ull_insert at the
               serving batch, at the landing size and on 131072 updates
               on one word. The probe and
               torch.add(x, 1.0) are timed in turns, call against call
               and device against device, and so are the two set landing
               routes on interval A's 1M updates: one insert per batch
               of 8192 (the route before the landing buffer) against the
               engine's landing buffer.

Then it prints one JSON line describing every kernel, the card's name
and power limit as nvidia-smi reports them, and, last, the device line
{"ok": true, "device": {...}}. Without a card, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bandwidth, and the f32 and
# float64 rates outside the tensor cores; a kernel's bound is the larger
# of bytes / bandwidth and the time of its operations at their rates.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12

# serving shapes at the default EngineConfig
SERVE_K, SERVE_C, SERVE_B = 32768, 256, 256
SERVE_SETS, SERVE_M = 4096, 16384
SERVE_ULL_M, SERVE_BATCH = 8192, 8192


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


def call_ms(fn, device):
    """Milliseconds of one `fn()`, bracketed by CUDA events on the card
    (host clock on the CPU, for rehearsals)."""
    import torch
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def time_ms(fn, device, reps, warmup=1):
    """Median milliseconds of `fn()` over `reps` runs (`call_ms`)."""
    for _ in range(warmup):
        fn()
    sync(device)
    return statistics.median(call_ms(fn, device) for _ in range(reps))


class GcPauses:
    """Milliseconds the interpreter's garbage collector spent inside a
    `with` block (gc.callbacks brackets every collection)."""

    def __enter__(self):
        self.ms = 0.0
        self._t0 = None
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self._t0 = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
        return False


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=60,
        check=True, text=True)
    return out.stdout.strip().splitlines()[0].strip()


# ------------------------------------------------------------- phase 1

def phase_build(device):
    """Build the library, then launch the probe kernel before any real
    one: x + 1 over zeros(8, 128) must read 1.0 everywhere and equal its
    plain version."""
    import torch
    from veneur_tpu_torch.kernels import _build, probe
    from veneur_tpu_torch.kernels import compress as kc
    _build.load()
    path, secs, log = _build.last_build
    print(f"library {os.path.relpath(path, ROOT)} built in {secs:.2f} s")
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "smem",
                                   "spill", "error")):
            print("  " + line.strip())
    props = torch.cuda.get_device_properties(device)
    occ = {"smem_bytes_a_row": kc.smem_bytes(SERVE_C, SERVE_B),
           "rows_per_sm": kc.blocks_per_sm(SERVE_C, SERVE_B, device.index),
           "sms": props.multi_processor_count}
    occ["waves"] = -(-SERVE_K // (occ["rows_per_sm"] * occ["sms"]))
    print(f"compress occupancy at C={SERVE_C} B={SERVE_B}: {json.dumps(occ)}")
    x = torch.zeros(probe.SHAPE, dtype=torch.float32, device=device)
    out = probe.probe_add(x)
    plain = probe.probe_plain(x)
    sync(device)
    check(bool((out == 1.0).all()),
          "probe kernel: not every element reads 1.0")
    err = float((out - plain).abs().max())
    print(f"probe: every element of {list(probe.SHAPE)} reads 1.0")
    return {"build_s": secs, "library": os.path.relpath(path, ROOT),
            "max_abs_err": err, "compress_occupancy": occ}


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

def ull_insert_inputs(device, K, m, n, seed=3):
    """A [K, m] register bank and an n-update batch as the phase
    describes. Returns (registers, slots, idx, vals) on `device`, plus
    the (slot, idx) of the hot register."""
    import torch
    rng = np.random.default_rng(seed)
    # canonical states on even rows (b1 needs q >= 2, b2 needs q >= 3),
    # arbitrary bytes (non-canonical ones too) on odd rows, one zero row
    q = rng.integers(0, 53, (K, m))
    b1 = rng.integers(0, 2, (K, m)) & (q >= 2)
    b2 = rng.integers(0, 2, (K, m)) & (q >= 3)
    regs = np.where(q > 0, (q << 2) | (b1 << 1) | b2, 0).astype(np.uint8)
    regs[1::2] = rng.integers(0, 256, (K // 2, m), dtype=np.uint8)
    regs[2] = 0
    slots = rng.integers(0, K, n).astype(np.int32)
    idx = rng.integers(0, m, n).astype(np.int32)
    vals = (rng.integers(1, 52, n) << 2).astype(np.uint8)
    vals[::5] = rng.integers(0, 256, len(vals[::5]), dtype=np.uint8)
    d = n // 4                       # 25% duplicated targets
    slots[:d], idx[:d] = slots[d:2 * d], idx[d:2 * d]
    i = 2 * d
    slots[i:i + 256] = -1            # padding
    i += 256
    slots[i:i + 8], idx[i:i + 8] = K - 1, m - 1
    i += 8
    hot = (4, 77)                    # one register hit 1000 times
    slots[i:i + 1000], idx[i:i + 1000] = hot
    vals[i:i + 1000] = (rng.integers(1, 52, 1000) << 2) \
        | rng.integers(0, 4, 1000)
    i += 1000
    slots[i:i + 400] = 8             # the four registers of one word
    idx[i:i + 400] = 100 + np.arange(400) % 4
    i += 400
    # the uint32 flat key slot * m + idx: (K, 0) and (1, -2m) name no
    # register and are dropped; (0, m) lands on row 1's register 0 and
    # (1, -1) on row 0's last register
    slots[i:i + 4] = (K, 1, 0, 1)
    idx[i:i + 4] = (0, -2 * m, m, -1)

    def t(a):
        return torch.as_tensor(a, device=device)

    return t(regs), t(slots), t(idx), t(vals), hot


def one_word_inputs(device, K, m, n, seed=5):
    """n updates with conflicting values on the four registers of one
    word of a random [K, m] bank."""
    import torch
    rng = np.random.default_rng(seed)
    regs = rng.integers(0, 256, (K, m), dtype=np.uint8)
    slots = np.full(n, K // 2, np.int32)
    idx = (40 + np.arange(n) % 4).astype(np.int32)
    vals = rng.integers(0, 256, n, dtype=np.uint8)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (regs, slots, idx, vals))


def key_edge_inputs(device, K, m, reps=64, seed=6):
    """The uint32 key edges of `ull_insert_inputs`, each `reps` times
    with conflicting values, on a random [K, m] bank."""
    import torch
    rng = np.random.default_rng(seed)
    regs = rng.integers(0, 256, (K, m), dtype=np.uint8)
    slots = np.repeat(np.array([K, 1, 0, 1], np.int32), reps)
    idx = np.repeat(np.array([0, -2 * m, m, -1], np.int32), reps)
    vals = rng.integers(0, 256, len(slots), dtype=np.uint8)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (regs, slots, idx, vals))


def landing_size(batch=SERVE_BATCH):
    """The engine's set landing buffer, in updates, at `batch`."""
    from veneur_tpu_torch.models.pipeline import SET_LANDING_BATCHES
    return SET_LANDING_BATCHES * batch


def check_insert_case(label, device, regs, slots, idx, vals, hot=None):
    """One batch through the kernel and the plain version on copies of
    `regs`: every byte equal; the hot register, if named, equal to a
    numpy fold of the join over its operands; re-landing the batch
    changes nothing."""
    from veneur_tpu_torch.kernels import ull_insert as ki
    from veneur_tpu_torch.sketches import ull
    kb = ull.ULLBank(registers=regs.clone())
    pb = ull.ULLBank(registers=regs.clone())
    ki.fused_insert(kb, slots, idx, vals)
    ull._insert_impl(pb, slots, idx, vals)
    sync(device)
    diff = int((kb.registers != pb.registers).sum())
    err = int((kb.registers.int() - pb.registers.int()).abs().max())
    changed = int((kb.registers != regs).sum())
    before = kb.registers.clone()
    ki.fused_insert(kb, slots, idx, vals)
    sync(device)
    rec = {"K": regs.shape[0], "m": regs.shape[1], "n": slots.shape[0],
           "bytes_differing": diff, "bytes_changed_by_the_batch": changed,
           "relanding_changes": int((kb.registers != before).sum()),
           "max_abs_err": err}
    if hot is not None:
        s_np, i_np, v_np = (a.cpu().numpy() for a in (slots, idx, vals))
        want = regs[hot].item()
        for v in v_np[(s_np == hot[0]) & (i_np == hot[1])]:
            want = int(ull.join_registers_np(want, v))
        rec["hot_register"] = [kb.registers[hot].item(), want]
    print(f"ull_insert {label}: {json.dumps(rec)}")
    check(diff == 0, f"{label}: {diff} register bytes differ from the "
          "plain version")
    check(changed > 0, f"{label}: the batch changed no byte")
    check(rec["relanding_changes"] == 0,
          f"{label}: re-landing the batch changed bytes")
    if hot is not None:
        check(rec["hot_register"][0] == rec["hot_register"][1],
              f"{label}: hot register differs from the numpy fold of the "
              "join")
    return rec


def phase_ull_insert(device, K=SERVE_SETS, m=SERVE_ULL_M, n=SERVE_BATCH,
                     n_landing=None):
    """Kernel vs plain. Tolerance: none — every register byte equal, in
    every case (see the module docstring). `n_landing` defaults to the
    engine's landing buffer at the serving batch."""
    n_landing = n_landing or landing_size()
    out = {}
    regs, slots, idx, vals, hot = ull_insert_inputs(device, K, m, n)
    out["serving"] = check_insert_case("serving", device, regs, slots, idx,
                                       vals, hot)
    check(out["serving"]["bytes_changed_by_the_batch"] >= n // 8,
          "serving: the batch changed too few bytes")
    out["offset_views"] = check_insert_case(
        "offset views", device, regs, slots[1:], idx[1:], vals[1:], hot)
    regs, slots, idx, vals, hot = ull_insert_inputs(device, K, m, n_landing,
                                                    seed=4)
    out["landing"] = check_insert_case("landing", device, regs, slots, idx,
                                       vals, hot)
    out["one_word"] = check_insert_case(
        "one word", device, *one_word_inputs(device, K, m, n))
    out["one_word_landing"] = check_insert_case(
        "one word, landing size", device,
        *one_word_inputs(device, K, m, n_landing))
    out["key_edges"] = check_insert_case(
        "key edges", device, *key_edge_inputs(device, K, m))
    out["max_abs_err"] = max(r["max_abs_err"] for r in out.values())
    return out


# ------------------------------------------------------------- phase 5

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
        d["hot"] = (rng.normal(1000, 10, hot) if spec.get("hot_normal")
                    else rng.lognormal(3, 1, hot)).astype(np.float32)
    return d


def feed(eng, d, truth=None):
    """Drive one interval's data through the engine's user entry
    points. Returns the set ingest's numbers: the bulk set updates, the
    wall time of their loop, ended by landing the landing buffer's
    remainder and a synchronize, so that every bulk update counted has
    landed, and the updates that reached the set engine in the interval
    (datagram sets included)."""
    from veneur_tpu_torch.ingest.parser import (
        ServiceCheck, UDPMetric, parse_packet)
    b = eng.cfg.batch_size
    out = {"set_updates": 0, "set_ingest_ms": 0.0,
           "set_updates_fed": sum(ln.endswith(b"|s") for ln in d["lines"])}
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
        idx, rho = eng._seng.host_hash_to_updates(h.reshape(-1))
        t0 = time.perf_counter()
        for i in range(0, len(slots), b):
            s = slots[i:i + b]
            eng.ingest_set_batch(s, idx[i:i + b], rho[i:i + b],
                                 count=len(s))
        with eng.lock:   # land the buffer's remainder inside the window
            eng.set_bank = eng._land_set_buffer(eng.set_bank,
                                                eng._set_landing)
        sync(eng.device)
        out["set_ingest_ms"] = (time.perf_counter() - t0) * 1e3
        out["set_updates"] = len(slots)
        out["set_updates_fed"] += len(slots)
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
    return out


def rows_of(res):
    return {(m.name, tuple(m.tags)): m for m in res.metrics}


QS = (0.5, 0.75, 0.99)


def req_quantile_np(v, qs):
    """float64 numpy evaluation of the REQ quantile's knot scheme on raw
    unit-weight samples: knots (0, min), hazen mid-points (i + 1/2)/n at
    the sorted samples, (1, max); linear interpolation between the knots
    that bracket q, in log space when every sample is positive."""
    x = np.sort(np.asarray(v, np.float64))
    n = len(x)
    kq = np.concatenate([[0.0], (np.arange(n) + 0.5) / n, [1.0]])
    kv = np.concatenate([[x[0]], x, [x[-1]]])
    log = x[0] > 0
    if log:
        kv = np.log(np.maximum(kv, 1e-37))
    out = []
    for q in qs:
        below = np.nonzero(kq < q)[0]
        if below.size == 0:
            r = kv[0]
        else:
            lo = below[-1]
            den = kq[lo + 1] - kq[lo]
            t = (q - kq[lo]) / den if den > 0 else 0.0
            r = kv[lo] + t * (kv[lo + 1] - kv[lo])
        out.append(np.exp(r) if log else r)
    return np.array(out)


def check_percentiles(rows, name, tags, v, heng, label, worst):
    """The histogram engine's contract. t-digest: within 1% of the key's
    spread of numpy's quantile (method "hazen", the plotting positions
    a t-digest's singleton centroids interpolate between). REQ: a key
    whose level never reached the compaction trigger holds its raw
    samples, so its percentiles are within rtol 1e-5 of
    `req_quantile_np` at the f32 quantiles (f32 knots and
    interpolation); a compacted key (the plans' only one is the hot key,
    a compact normal(1000, 10) stream) is held to the JAX package's REQ
    contract for compact streams, within 1% relative of numpy's
    percentile."""
    if heng.id == "req":
        cap = heng.capacity
        trig = cap - (cap - (5 * cap) // 8) // 2
        if len(v) < trig:
            want = req_quantile_np(
                v, np.float32(QS).astype(np.float64))
            tol = [1e-5 * abs(w) for w in want]
            kind = "req_raw_rel_err"
        else:
            want = np.percentile(v.astype(np.float64), [100 * q for q in QS])
            tol = [0.01 * abs(w) for w in want]
            kind = "req_compacted_rel_err"
        for q, w, t in zip(QS, want, tol):
            got = rows[(f"{name}.{q * 100:g}percentile", tags)].value
            worst[kind] = max(worst.get(kind, 0.0),
                              abs(got - w) / max(abs(w), 1e-30))
            check(abs(got - w) <= t,
                  f"{label} {name} p{q * 100:g}: {got} vs {w}")
        return
    spread = float(v.max()) - float(v.min())
    want = np.quantile(v.astype(np.float64), QS, method="hazen")
    for q, w in zip(QS, want):
        got = rows[(f"{name}.{q * 100:g}percentile", tags)].value
        err = abs(got - w) / spread if spread > 0 else abs(got - w)
        worst["pct_err_over_spread"] = max(
            worst.get("pct_err_over_spread", 0.0), err)
        check(err <= 0.01 + 1e-6,
              f"{label} {name} p{q * 100:g}: {got} vs {w} (spread {spread})")


def set_ok(got, n, seng):
    """The set engine's contract. HLL: within three nominal standard
    errors plus one member (at a few dozen members a single register
    collision is already more than 3 standard errors). ULL: within
    4 x 0.76/sqrt(m) + 0.01 relative, the bound the JAX package's
    cardinality oracle holds ULL to."""
    if seng.id == "ull":
        return abs(got - n) / n <= 4 * seng.nominal_error() + 0.01
    return abs(got - n) <= 3 * seng.nominal_error() * n + 1.0


def check_against_truth(res, truth, eng, label):
    """Counts, min, max, counter totals and gauge values exact;
    percentiles and set estimates under the engine pair's contract
    (check_percentiles, set_ok)."""
    rows = rows_of(res)
    worst = {"set_rel_err": 0.0}
    for key in truth.histo:
        v = np.asarray(truth.histo[key], np.float32)
        name, tags = key
        cnt = rows[(name + ".count", tags)].value
        check(cnt == len(v), f"{label} {name}: count {cnt} != {len(v)}")
        check(rows[(name + ".min", tags)].value == float(v.min()),
              f"{label} {name}: min")
        check(rows[(name + ".max", tags)].value == float(v.max()),
              f"{label} {name}: max")
        check_percentiles(rows, name, tags, v, eng._heng, label, worst)
    for key, want in truth.counter.items():
        got = rows[key].value
        check(got == want, f"{label} counter {key}: {got} != {want}")
    for key, want in truth.gauge.items():
        got = rows[key].value
        check(got == want, f"{label} gauge {key}: {got} != {want}")
    for key, want in truth.sets.items():
        n = want if isinstance(want, int) else len(want)
        got = rows[key].value
        rel = abs(got - n) / n
        worst["set_rel_err"] = max(worst["set_rel_err"], rel)
        check(set_ok(got, n, eng._seng), f"{label} set {key}: {got} vs {n}")
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
# the req+ull path: the same plan, with the hot key a compact
# normal(1000, 10) stream (the REQ contract for compact streams)
REQ_PLAN = {**SERVE_PLAN, "C": {**SERVE_PLAN["C"], "hot_normal": True}}

# each main path: its engine config, plan, and the kernels it must and
# must not launch
PATHS = {
    "default": {"cfg": {}, "plan": SERVE_PLAN,
                "launched": ("compress", "hll_stats", "probe"),
                "not_launched": ("ull_insert",)},
    "req+ull": {"cfg": {"histogram_backend": "req", "set_backend": "ull"},
                "plan": REQ_PLAN,
                "launched": ("ull_insert", "probe"),
                "not_launched": ("compress", "hll_stats")},
}


def phase_main(device, path="default", cfg_kw=None, plan=None):
    """One main path, intervals A-D, against numpy truth. The launch
    counters are set to 0 just before the engine is built and read just
    after its last flush, so they count this path alone; the path's
    kernels must have launched and the other path's not. Then the same
    stream goes into a second engine with the incremental flush off
    (outside the count), whose rows must be bit-identical in every
    interval. `cfg_kw` and `plan` override the path's (CPU rehearsals
    at small shapes)."""
    from veneur_tpu_torch import kernels
    from veneur_tpu_torch.models.pipeline import (
        AggregationEngine, EngineConfig)
    spec = PATHS[path]
    cfg_kw = {**spec["cfg"], **(cfg_kw or {})}
    plan = plan or spec["plan"]
    rng = np.random.default_rng(7)
    data = {k: build_interval(rng, spec, k) for k, spec in plan.items()}

    out = {"intervals": {}}
    flushed = {}
    kernels.reset_launches()
    eng = AggregationEngine(EngineConfig(**cfg_kw), device=device)
    capacity = eng._set_landing.capacity
    for i, (label, d) in enumerate(data.items()):
        truth = Truth()
        n_before = kernels.launches["ull_insert"]
        sets = feed(eng, d, truth)
        sets["set_ingest_launches"] = kernels.launches["ull_insert"] \
            - n_before
        if sets["set_updates"]:
            sets["set_updates_per_s"] = \
                sets["set_updates"] / sets["set_ingest_ms"] * 1e3
        before = dict(kernels.launches)
        with GcPauses() as gcp:
            t0 = time.monotonic()
            res = eng.flush(timestamp=1000 + i)
            ms = (time.monotonic() - t0) * 1e3
        flush_launches = {k: n - before[k]
                          for k, n in kernels.launches.items()}
        fpath = res.stats["flush_path"]["path"]
        check(fpath == EXPECT_PATH[label],
              f"{label}: flush path {fpath}, expected {EXPECT_PATH[label]}")
        worst = check_against_truth(res, truth, eng, label)
        if label == "D":
            check(len(res.metrics) == 0, "empty interval flushed rows")
        if label in ("A", "B", "C") and d["lines"]:
            check(any(m.name == "dg.check" for m in res.status_metrics),
                  f"{label}: service check missing")
        flushed[label] = canon(res)
        out["intervals"][label] = {
            "path": fpath, "flush_ms": ms,
            "swap_ms": res.stats["swap_ns"] / 1e6,
            "merge_ms": res.stats["merge_ns"] / 1e6,
            "assembly_ms": res.stats["assembly_ns"] / 1e6,
            "gc_ms": gcp.ms,
            "rows": len(res.frame),
            "dirty": res.stats["flush_path"].get("dirty"),
            "flush_launches": flush_launches, **sets, **worst}
    out["launches"] = dict(kernels.launches)
    print(f"main-path launches ({path}): {out['launches']}")
    if device.type == "cuda":
        for name in spec["launched"]:
            check(out["launches"][name] > 0,
                  f"kernel {name} was not launched on the {path} path")
        for name in spec["not_launched"]:
            check(out["launches"][name] == 0,
                  f"kernel {name} was launched on the {path} path")
    if "ull_insert" in spec["launched"]:
        # one insert per landing buffer of updates at ingest, and at
        # most one in each flush
        most = 0
        for label, rec in out["intervals"].items():
            fed = -(-rec["set_updates_fed"] // capacity)
            check(rec["set_ingest_launches"] <= fed,
                  f"{label}: {rec['set_ingest_launches']} ull_insert "
                  f"launches at ingest for {rec['set_updates_fed']} updates")
            check(rec["flush_launches"]["ull_insert"] <= 1,
                  f"{label}: {rec['flush_launches']['ull_insert']} "
                  "ull_insert launches in the flush")
            most += fed + 1
        check(out["launches"]["ull_insert"] <= most,
              f"{out['launches']['ull_insert']} ull_insert launches on the "
              f"{path} path, more than {most}")
    del eng

    ref = AggregationEngine(EngineConfig(flush_incremental=False,
                                         **cfg_kw), device=device)
    for i, (label, d) in enumerate(data.items()):
        feed(ref, d)
        res_ref = ref.flush(timestamp=1000 + i)
        identical = flushed[label] == canon(res_ref)
        rec = out["intervals"][label]
        rec["equal_to_full_flush"] = identical
        print(f"interval {label} ({path}): {json.dumps(rec)}")
        check(identical, f"{label}: incremental flush != full flush")
    return out


# ------------------------------------------------------------- phase 6

def time_fresh_ms(fn, make, device, reps):
    """Median milliseconds of `fn(make())` with `make()` (a fresh copy of
    state the function updates in place) outside the timed window."""
    fn(make())
    times = []
    for _ in range(reps):
        arg = make()
        sync(device)
        times.append(call_ms(lambda: fn(arg), device))
    return statistics.median(times)


def time_turns_ms(fns, device, reps):
    """Median milliseconds of one call of each function in `fns` (a
    name -> callable dict), timed as `time_ms` does but in turns — one
    call of each per round — so that every function sees the same state
    of the card and host."""
    for fn in fns.values():
        fn()
    sync(device)
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            times[name].append(call_ms(fn, device))
    return {name: statistics.median(t) for name, t in times.items()}


def calls_device_ms(fn, n, device):
    """Mean device time of one `fn()` from torch.profiler's trace of the
    card: the device time of every kernel the n calls launched, over n.
    For a PyTorch call whose kernel has no symbol of ours; None when the
    trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        sync(device)
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA]
    if not evs:
        return None
    return sum(ev.self_device_time_total for ev in evs) / n / 1e3


def kernel_device_ms(calls, device):
    """Mean device time of one launch of each kernel, from
    torch.profiler's trace of the card: `calls` maps a kernel's symbol in
    csrc/ to callables that each launch it once. The per-call times of
    `time_ms` also hold the host's share of a call (Python, the binding,
    the argument checks); this is the kernel alone."""
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fns in calls.values():
            for fn in fns:
                fn()
        sync(device)
    out = {}
    for ev in prof.key_averages():
        for sym in calls:
            if f"{sym}(" in ev.key and ev.count:
                out[sym] = ev.self_device_time_total / ev.count / 1e3
    return out


def compress_bound_ms(K, C, B, live, boundaries):
    """Least time for one compress of K rows holding `live` positive
    weights and `boundaries` clusters in all (what this run's data needs
    of k1 and of the greedy recurrence).

    Bytes: read mean, weight, buf_value, buf_weight once and write two
    [K, C] outputs. Operations, each share at its own rate:
      - float64 (34 TFLOP/s): per element of the M = C + B lanes, the
        weighted term and both blocked sums (5); per live lane, k1 at its
        right edge (48: ~32 for asin, ~10 for the division, 6 for the
        clamp and the affine steps) and its left edge's subtraction and
        comparison with the previous lane's cum (2) — a left edge equal to
        that cum has the same k1, so one more k1 a row is counted, for
        its first lane; per centroid, the segment differences and the
        mean's division (13);
      - f32 rate (67 TFLOP/s): the buffer sort (Pb * log2(Pb)
        comparisons, a comparison sort's order of work, B padded to the
        power of two Pb) and the merge network of the P-lane row (P/2 *
        log2(P) exchanges; the plain version's result is that network's),
        8 integer ops a comparison; the canonical keys (4 an element);
        the greedy recurrence (a subtraction and a comparison a live lane
        under the running k_start, and one update a boundary); the cluster
        ends' binary searches (3 ops a step) and the running max (10 a
        centroid).
    The bound is max(bytes / bandwidth, f64 time + f32 time)."""
    M = C + B
    P = 1 << (M - 1).bit_length()
    Pb = 1 << (B - 1).bit_length()
    comparisons = Pb * (Pb.bit_length() - 1) + (P // 2) * (
        P.bit_length() - 1)
    f64_ops = K * (5 * M + 48 + 13 * C) + live * (48 + 2)
    f32_ops = K * (8 * comparisons + 4 * M + 3 * C * M.bit_length()
                   + 10 * C) + 2 * live + boundaries
    nbytes = 4 * K * (2 * C + 2 * B) + 4 * K * 2 * C
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = f64_ops / F64_OPS_PER_S + f32_ops / F32_OPS_PER_S
    return max(bytes_s, ops_s) * 1e3, \
        "bytes" if bytes_s >= ops_s else "operations", nbytes, \
        f64_ops + f32_ops, {"f64_ops": f64_ops, "f32_ops": f32_ops,
                            "bytes_ms": bytes_s * 1e3, "ops_ms": ops_s * 1e3}


def hll_bound_ms(K, m):
    """Read K*m register bytes once and write two f32 per row; ~4 ops
    per register (compare, count, exponent build, add)."""
    nbytes = K * m + 8 * K
    ops = 4 * K * m
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(bytes_s, ops_s) * 1e3, \
        "bytes" if bytes_s >= ops_s else "operations", nbytes, ops


def ull_insert_bound_ms(slots, idx, K, m):
    """Read the update arrays once (9 bytes an update: slot, index,
    value) and read and write each distinct 32-bit word that this
    batch's live updates touch (8 bytes a word); ~20 integer operations
    an update (address, byte lane, join), at the f32 rate. An update is
    live as the kernel keys it: slot >= 0 and its uint32 flat index
    below K*m."""
    s = slots.cpu().numpy().astype(np.int64)
    i = idx.cpu().numpy().astype(np.int64)
    flat = ((s & 0xFFFFFFFF) * m + (i & 0xFFFFFFFF)) & 0xFFFFFFFF
    ok = (s >= 0) & (flat < K * m)
    words = np.unique(flat[ok] >> 2).size
    nbytes = 9 * len(s) + 8 * words
    ops = 20 * int(ok.sum())
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(bytes_s, ops_s) * 1e3, \
        "bytes" if bytes_s >= ops_s else "operations", nbytes, ops


def probe_bound_ms(n):
    """Read and write n f32 once; one add each."""
    nbytes, ops = 8 * n, n
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(bytes_s, ops_s) * 1e3, \
        "bytes" if bytes_s >= ops_s else "operations", nbytes, ops


def land_old_route(eng, slots, idx, rho):
    """Set updates landed as the engine landed them before its landing
    buffer: per batch of batch_size, under the lock, mark the dirty rows,
    copy the three arrays to the card and run one insert."""
    b = eng.cfg.batch_size
    for i in range(0, len(slots), b):
        s = slots[i:i + b]
        with eng.lock:
            eng.samples_processed += len(s)
            eng._mark_dirty_into(eng._dirty, 3, s)
            eng.set_bank = eng._insert_sets(eng.set_bank, s, idx[i:i + b],
                                            rho[i:i + b])
    sync(eng.device)


def land_new_route(eng, slots, idx, rho):
    """The same updates through the engine's entry point and landing
    buffer, then drain_all (which lands the buffer's remainder). Returns
    the milliseconds of the ingest loop alone."""
    b = eng.cfg.batch_size
    t0 = time.perf_counter()
    for i in range(0, len(slots), b):
        s = slots[i:i + b]
        eng.ingest_set_batch(s, idx[i:i + b], rho[i:i + b], count=len(s))
    loop_ms = (time.perf_counter() - t0) * 1e3
    eng.drain_all()
    sync(eng.device)
    return loop_ms


def time_set_routes(device, cfg_kw, sets, members, rounds):
    """Interval A's bulk set updates (`sets` x `members`) landed by the
    old route and the new one, in turns (old, new, new, old) on one
    engine, each landing into a fresh set bank: the median wall ms of
    each route, ended by a synchronize, its updates/s and its ull_insert
    launches; then the median host microseconds of one batch of the new
    route's loop by step (the dirty marks, the append)."""
    from veneur_tpu_torch import kernels
    from veneur_tpu_torch.models.pipeline import (
        AggregationEngine, EngineConfig, _SetLanding)
    rng = np.random.default_rng(8)
    eng = AggregationEngine(EngineConfig(**cfg_kw), device=device)
    h = rng.integers(0, 2 ** 64, (sets, members), dtype=np.uint64)
    slots = np.repeat(_intern(eng.set_keys,
                              [f"bulk.s.{i}" for i in range(sets)], "set"),
                      members)
    idx, rho = eng._seng.host_hash_to_updates(h.reshape(-1))
    times = {"old": [], "new": [], "new_loop": []}
    launches = {}
    for r in range(2 * rounds):
        for route in (("old", "new") if r % 2 == 0 else ("new", "old")):
            eng.set_bank = eng._seng.init(eng.cfg.set_slots, device)
            sync(device)
            n0 = kernels.launches["ull_insert"]
            t0 = time.perf_counter()
            if route == "old":
                land_old_route(eng, slots, idx, rho)
            else:
                times["new_loop"].append(
                    land_new_route(eng, slots, idx, rho))
            times[route].append((time.perf_counter() - t0) * 1e3)
            launches[route] = kernels.launches["ull_insert"] - n0
    out = {"updates": len(slots), "batch": eng.cfg.batch_size,
           "capacity": eng._set_landing.capacity}
    for route in ("old", "new"):
        ms = statistics.median(times[route])
        out[route] = {"ms": ms, "updates_per_s": len(slots) / ms * 1e3,
                      "launches": launches[route]}
    out["new"]["loop_ms"] = statistics.median(times["new_loop"])
    # the host's share of one batch of the new route's loop, by step
    buf = _SetLanding(out["capacity"])
    mark, append = [], []
    for i in range(0, len(slots), eng.cfg.batch_size):
        part = [a[i:i + eng.cfg.batch_size] for a in (slots, idx, rho)]
        t0 = time.perf_counter()
        eng._mark_dirty_into(eng._dirty, 3, part[0])
        t1 = time.perf_counter()
        if not buf.fits(len(part[0])):
            buf.take()
        buf.append(*part)
        mark.append((t1 - t0) * 1e6)
        append.append((time.perf_counter() - t1) * 1e6)
    out["host_us_a_batch"] = {"mark_dirty": statistics.median(mark),
                              "append": statistics.median(append)}
    return out


def phase_timing(device, K=SERVE_K, C=SERVE_C, B=SERVE_B,
                 KS=SERVE_SETS, m=SERVE_M, mu=SERVE_ULL_M, n=SERVE_BATCH,
                 n_landing=None, reps=(20, 3, 200), routes=None):
    """Per kernel: the median time a call (CUDA events around the
    wrapper, so the host's share of the call is in it), the plain
    version's, the device time from torch.profiler and the bound;
    ull_insert at the serving batch `n` and at the landing size
    `n_landing` (default: the engine's landing buffer). The probe and
    torch.add(x, 1.0) run in turns, reps[2] rounds. `routes` (engine
    config overrides, sets, members, rounds) sizes the comparison of the
    two set landing routes; the default is interval A at the deployment
    defaults."""
    import torch
    from veneur_tpu_torch.kernels import compress as kc
    from veneur_tpu_torch.kernels import hll_stats as kh
    from veneur_tpu_torch.kernels import probe as kp
    from veneur_tpu_torch.kernels import ull_insert as ki
    from veneur_tpu_torch.sketches import ull
    args = compress_inputs(device, K, C, B)
    regs = hll_inputs(device, KS, m)
    out = {}
    live = int((args[1] > 0).sum() + (args[3] > 0).sum())
    boundaries = int((kc.fused_compress(*args, 100.0)[1] > 0).sum())
    bound, by, nbytes, ops, parts = compress_bound_ms(K, C, B, live,
                                                      boundaries)
    out["compress"] = {
        "ms": time_ms(lambda: kc.fused_compress(*args, 100.0), device,
                      reps[0]),
        "plain_ms": time_ms(lambda: kc.compress_plain(*args, 100.0),
                            device, reps[1]),
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops,
        "bound_parts": parts, "live": live, "boundaries": boundaries,
        "shape": [K, C, B]}
    bound, by, nbytes, ops = hll_bound_ms(KS, m)
    out["hll_stats"] = {
        "ms": time_ms(lambda: kh.hll_stats(regs), device, reps[0]),
        "plain_ms": time_ms(lambda: kh.hll_stats_plain(regs), device,
                            reps[0]),
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops,
        "shape": [KS, m]}
    n_landing = n_landing or landing_size()
    insert_args = {}
    for name, make in (
            ("ull_insert", lambda: ull_insert_inputs(device, KS, mu, n)[:4]),
            ("ull_insert_landing",
             lambda: ull_insert_inputs(device, KS, mu, n_landing, 4)[:4]),
            ("ull_insert_one_word",
             lambda: one_word_inputs(device, KS, mu, n_landing))):
        uregs, slots, idx, vals = make()
        bound, by, nbytes, ops = ull_insert_bound_ms(slots, idx, KS, mu)

        def fresh(uregs=uregs):
            return ull.ULLBank(registers=uregs.clone())

        insert_args[name] = (fresh, slots, idx, vals)
        out[name] = {
            "ms": time_fresh_ms(
                lambda b: ki.fused_insert(b, slots, idx, vals), fresh,
                device, reps[0]),
            "plain_ms": time_fresh_ms(
                lambda b: ull._insert_impl(b, slots, idx, vals), fresh,
                device, reps[0]),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops,
            "shape": [KS, mu, slots.shape[0]]}
    x = torch.zeros(kp.SHAPE, dtype=torch.float32, device=device)
    bound, by, nbytes, ops = probe_bound_ms(x.numel())
    turns = time_turns_ms({"probe": lambda: kp.probe_add(x),
                           "add": lambda: torch.add(x, 1.0)}, device,
                          reps[2])
    out["probe"] = {
        "ms": turns["probe"],
        "plain_ms": time_ms(lambda: kp.probe_plain(x), device, reps[0]),
        "library_ms": turns["add"],
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops,
        "shape": list(kp.SHAPE)}
    if device.type == "cuda":
        dev_ms = kernel_device_ms({
            "compress_kernel": [lambda: kc.fused_compress(*args, 100.0)] * 3,
            "hll_stats_kernel": [lambda: kh.hll_stats(regs)] * 10,
            "probe_kernel": [lambda: kp.probe_add(x)] * 10}, device)
        for name in ("compress", "hll_stats", "probe"):
            out[name]["device_ms"] = dev_ms.get(f"{name}_kernel")
        # each shape on its own trace: both launch the same symbol
        for name, (fresh, slots, idx, vals) in insert_args.items():
            banks = [fresh() for _ in range(10)]
            out[name]["device_ms"] = kernel_device_ms({
                "ull_insert_kernel": [
                    (lambda b=b: ki.fused_insert(b, slots, idx, vals))
                    for b in banks]}, device).get("ull_insert_kernel")
            del banks
        out["probe"]["library_device_ms"] = calls_device_ms(
            lambda: torch.add(x, 1.0), 10, device)
    cfg_kw, sets, members, rounds = routes or (
        {"set_backend": "ull"}, 1000, 1000, 3)
    out["set_routes"] = time_set_routes(device, cfg_kw, sets, members,
                                        rounds)
    return out


# ------------------------------------------------------------- main

# (name, source, the TPU kernel it replaces, the phase holding it
# against its plain version, the timing at the main path's shape)
KERNELS = (
    ("compress", "veneur_tpu_torch/csrc/compress.cu",
     "veneur_tpu/kernels/compress.py:232", "compress", "compress"),
    ("hll_stats", "veneur_tpu_torch/csrc/hll_stats.cu",
     "veneur_tpu/kernels/hll_stats.py:75", "hll_stats", "hll_stats"),
    ("ull_insert", "veneur_tpu_torch/csrc/ull_insert.cu",
     "veneur_tpu/kernels/ull_insert.py:55", "ull_insert",
     "ull_insert_landing"),
    ("probe", "veneur_tpu_torch/csrc/probe.cu",
     "veneur_tpu/kernels/__init__.py:83", "build", "probe"),
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
    report = {"build": ph.run("build", phase_build, device)}
    if report["build"] is None:
        return 1
    report.update({
        "compress": ph.run("compress", phase_compress, device),
        "hll_stats": ph.run("hll_stats", phase_hll, device),
        "ull_insert": ph.run("ull_insert", phase_ull_insert, device)})
    main_out = {path: ph.run(f"main path {path}", phase_main, device, path)
                for path in PATHS}
    report["timing"] = ph.run("timing", phase_timing, device)
    if ph.failed:
        print(f"chip_smoke: failed phases: {', '.join(ph.failed)}",
              file=sys.stderr)
        return 1

    timing = report["timing"]

    def split(call_ms, dev_ms):
        """'<device> ms on the device, host <call - device> ms'"""
        if dev_ms is None:
            return "device and host shares not measured"
        return f"{dev_ms:.4f} ms on the device, host {call_ms - dev_ms:.4f} ms"

    kernel_timings = {k: t for k, t in timing.items() if k != "set_routes"}
    for name, t in kernel_timings.items():
        lib = (f", library {t['library_ms']:.4f} ms a call "
               f"({split(t['library_ms'], t['library_device_ms'])})"
               if "library_ms" in t else "")
        print(f"timing {name} {t['shape']}: kernel {t['ms']:.4f} ms a call "
              f"({split(t['ms'], t['device_ms'])}), "
              f"plain {t['plain_ms']:.4f} ms{lib}, bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}) | {card}")
    comp = timing["compress"]
    print(f"timing compress bound: {json.dumps(comp['bound_parts'])}, "
          f"{comp['live']} live lanes, {comp['boundaries']} boundaries "
          f"| {card}")
    probe_t = timing["probe"]
    print(f"timing probe vs torch.add, in turns: {probe_t['ms']:.4f} vs "
          f"{probe_t['library_ms']:.4f} ms a call, "
          f"{'not ' if probe_t['ms'] > probe_t['library_ms'] else ''}"
          f"within torch.add's | {card}")
    routes = timing["set_routes"]
    print(f"timing set landing routes, {routes['updates']} updates in "
          f"batches of {routes['batch']}, in turns: one insert a batch "
          f"{routes['old']['ms']:.2f} ms ({routes['old']['updates_per_s']:.0f}"
          f" updates/s, {routes['old']['launches']} launches), landing "
          f"buffer of {routes['capacity']} {routes['new']['ms']:.2f} ms "
          f"({routes['new']['updates_per_s']:.0f} updates/s, "
          f"{routes['new']['launches']} launches; the ingest loop "
          f"{routes['new']['loop_ms']:.2f} ms, the remainder's landing "
          f"{routes['new']['ms'] - routes['new']['loop_ms']:.2f} ms); "
          f"host a batch: dirty marks "
          f"{routes['host_us_a_batch']['mark_dirty']:.1f} us, append "
          f"{routes['host_us_a_batch']['append']:.1f} us | {card}")
    for path, out in main_out.items():
        for label, rec in out["intervals"].items():
            if rec["set_updates"]:
                print(f"timing set ingest {path} {label}: "
                      f"{rec['set_updates']} updates in "
                      f"{rec['set_ingest_ms']:.2f} ms, "
                      f"{rec['set_updates_per_s']:.0f} updates/s, "
                      f"ull_insert launches at ingest "
                      f"{rec['set_ingest_launches']} | {card}")
        for label, rec in out["intervals"].items():
            print(f"timing flush {path} {label} ({rec['path']}): "
                  f"{rec['flush_ms']:.2f} ms, swap {rec['swap_ms']:.2f} ms, "
                  f"merge {rec['merge_ms']:.2f} ms, host assembly "
                  f"{rec['assembly_ms']:.2f} ms, gc {rec['gc_ms']:.2f} ms, "
                  f"kernel launches {rec['flush_launches']} | {card}")
    kernels = []
    for name, source, replaces, phase, timed in KERNELS:
        t = timing[timed]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(out["launches"][name]
                            for out in main_out.values()),
            "max_abs_err": report[phase]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
