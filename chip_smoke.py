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
  7. server    the port's Server (server.py) in-process on the card at
               the deployment defaults (Config(): 32768 histogram, 16384
               counter, 16384 gauge and 4096 set slots, batch 8192,
               t-digest + HLL, one worker), a UDP listener, the HTTP
               listener and a capture sink. Interval S1 arrives over real
               UDP in datagrams of at most 4096 bytes, paced so none is
               dropped: 20000 timer keys x 10 samples (tagged), 5000
               counters x 4 (a fifth at @0.5), 5000 gauges, 1000 sets x
               100 members, 100 service checks, 10 events and a bad
               line; then drain() and flush_once(); then an empty S2.
               Checked: every datagram received, one parse error, no
               worker drop; S1's rows against numpy truth (the contract
               of phase 5), the status rows and the events; S2 carries
               only veneur.* rows, S1's phase timers among them;
               /healthcheck, /healthz and /debug/flush (S1's tick with
               its engine phases); the kernel launches of each step
               equal SERVER_LAUNCHES; stop() within 10 s, no thread
               left. Printed: the UDP ingest rate (datagrams/s and
               lines/s, from the first send to drain() returning) and
               S1's and S2's flush times from their
               veneur.flush.*_duration_ns rows, with the garbage
               collector's pauses in each flush_once. Then the daemon
               itself: `python3 -m veneur_tpu_torch.cli.veneur -f <yaml>`
               in a subprocess on the card (interval 1 s, a UDP
               listener, a flush_file) takes one burst of datagrams,
               writes every counter sample to its flush file, and exits 0
               on SIGTERM.
  8. ssf+overload  the port's Server at the same defaults with SSF
               listeners over UDP and TCP (so it traces its own flushes
               through its SSF UDP port), indicator_span_timer_name, the
               overload defense at 8192 keys a prefix, the profiler
               trigger, a UDP statsd listener, the HTTP listener and a
               capture sink. Interval T1, paced so nothing drops: 10000
               spans over UDP, each with a timing (5000 keys), a count
               (2000), a set member (200) and a gauge (1000), every
               tenth an indicator span; 1000 framed spans over TCP on
               keys of their own and one status sample; a garbage SSF
               datagram; the `app` tenant (2000 counters x 4, 500 timers
               x 10) and a storm of 50000 unique `storm.` counter keys
               over DogStatsD; one span and one line sent by `python3 -m
               veneur_tpu_torch.cli.emit`. /debug/flush/profile is
               requested, then drain() and flush_once(); then T2, which
               carries only T1's self-traced spans. Checked: every span
               counted and one SSF error, no drop; the SSF rows, the
               indicator timer and the tenant against numpy truth (phase
               5's contract), the status row; the storm minting exactly
               8192 keys and `storm.__other__` holding the exact folded
               count, which veneur.overload.folded_samples_total
               reports; received == applied + counted degraded samples;
               the adaptive rate at 1.0; /debug/flush naming the storm
               prefix over budget; T2 holding only veneur.* rows and a
               positive span count; the profile trace naming
               compress_kernel; the launches of each step equal
               SSF_LAUNCHES; stop() within 10 s, no thread left.
               Printed: spans/s and samples/s over UDP and TCP, the
               storm's datagrams/s, T1's and T2's flush times with the
               overload phase and the collector's pauses.

  9. global tier  port locals (EngineConfig(forward_enabled=True) at the
               default widths) flush forward exports, wire.export_to_metrics
               and a serialized forward_pb2.MetricList carry them as a
               forwarder would, and a port global (EngineConfig(
               is_global=True) at the defaults: 32768 histogram, 16384
               counter, 16384 gauge and 4096 set slots, batch 8192) decodes
               them (ParseFromString) and lands them with import_list, then
               flushes. G1 (lossless codec): four locals, each with a shard of
               20000 mixed timers x 25 samples, 5000 global-only counters x
               4, 5000 global-only gauges, 1000 mixed sets x 1000 members
               (local j's from j*500, a union of 2500), 100 local-only
               timers; the hot key g.hot from those four and 600 small
               locals (histogram_slots 64), 20000 samples each: its pile
               takes both re-chunk arms (sorted_prefix 0, then C) in the
               first landing. G2: the same with fresh samples and the q16
               codec. G3: the locals touch a tenth of their counters and
               sets and flush delta exports. G4: two req+ull locals (5000
               timers x 25, 1000 sets x 1000) into a req+ull global (the
               direct landing and the ULL row join). Checked: the global's
               rows against numpy truth over the union (phase 5's
               contract; counters exact, gauges the last import, each
               set's registers the join of the exported rows), the locals'
               frames (mixed timers aggregates only, local-only timers in
               full and never exported), G3's exports holding exactly the
               touched keys, both arms, and the launches of each step
               equal GLOBAL_LAUNCHES. Printed: each local's flush (the
               export build) and its export_to_metrics and serialization,
               the global's decode plus import_list per 1000 metrics, each
               import landing's cluster_rows and merge-and-compress ms
               (CUDA events), and the global flushes.

  10. fleet   a port fleet of real Servers at the deployment defaults
               (Config() widths): two port globals (a gRPC import
               listener and the HTTP listener each, one worker), a port
               ProxyServer ringing both, three port locals over UDP
               forwarding over gRPC to the proxy (chunks of 200 metrics:
               grpc's 4 MiB message limit) and one forwarding over HTTP
               straight to global 1's POST /import through a scripted
               egress whose deliveries are real POSTs (seeded ack losses,
               503s, timeouts, and in interval 2 a partial delivery whose
               tail replays in interval 3). Per local an interval: its
               shard of 5000 mixed timers x 25 samples (a quarter), 2000
               global-only counters x 4, 2000 global-only gauges, 500
               mixed sets x 200 members (the gRPC locals' a union of 400),
               50 local-only timers x 25 and 200 samples of a hot timer
               every local sends; the HTTP local's keys are its own (`h.`),
               but for the hot timer. Three intervals ticked by hand
               (interval 2 a delta forward touching a tenth of the
               counters and sets, interval 3 the full resync of
               forward_full_resync_intervals 2), then one flush of each
               global. Checked: every key's rows on the one global its ring
               hash names (the HTTP local's on global 1), the globals'
               rows against numpy truth over the union (phase 5's
               contract), the locals' own rows, the exports' kinds and the
               delta's keys, duplicates dropped by global 1's ledger and
               its /debug/fleet import recorder, no pending spill, both
               globals' rows bit for bit those of a zero-fault rerun of the
               same forwards (the recorded exports through fresh
               forwarders, proxy and globals), and the launches of each
               step equal FLEET_LAUNCHES. Printed: each local's flush
               (its engine phase, the export build included), its
               export_to_metrics (or JSON body) and forward ms, each
               global's imports a second from the first forward to
               drain() returning, the proxy's routing ms a 1000 metrics,
               each landing's cluster_rows and merge-and-compress ms, and
               each global's flush with the collector's pauses.

  11. durable  a durable global at the deployment defaults (EngineConfig()
               widths: 32768 t-digest slots at C=B=256, 4096 HLL sets at
               p=14), fed the exports of phase 9's four locals (its
               GLOBAL_PLAN, rerun: 20000 mixed timers x 25 in four
               column shards, 5000 counters x 4, 5000 gauges, 1000 sets
               x 1000 members, a hot shard of 20000 samples). 1: a global
               engine lands all four (import_list), mid-interval its
               checkpoint_state() is encoded through durability/records,
               appended to an EngineJournal with its sync, loaded,
               decoded and restored into a fresh engine on the card; both
               flush every row bit for bit equal. Printed: the bytes, the
               fetch, the encode, the CRC32C, the append with its sync,
               the load and decode, the restore. 2: `python3 -m
               veneur_tpu_torch.cli.veneur -f <yaml>` as a durable global
               daemon (is_global, durability_enabled,
               history_retention_generations 3, a gRPC import listener)
               takes locals 0-1's exports over GrpcForwarder (chunks of
               200) as interval 1, flushes it on its first tick, takes
               locals 2-3's as interval 2 and is SIGKILLed once they are
               acked; restarted on the same durability_dir it restores
               the checkpoint and replays interval 2's ops through
               import_list; its flush file's rows of both intervals are
               bit for bit those of an uncrashed in-process twin fed the
               same forwards. Printed: the restart from exec to /ready,
               veneur.durability.engine_restore_ns, the ops and metrics
               replayed. 3: a journaled sender killed between send and
               done (the scripted kill_after_send) recovers and replays
               its interval, the global drops every chunk of it, and the
               global's rows are bit for bit a zero-fault oracle's. 4:
               GET /query on the restarted daemon and on the twin over
               the retained generations: a timer's and the hot key's
               0.5/0.99 quantiles within the t-digest contract of numpy
               truth over the window's union of samples, count, min,
               max and a counter's value exact, a set under set_ok, both
               servers' answers equal; then neither's live state moved
               and the next live flushes hold no rows. The launches of
               each step (the daemon's from its /debug/flush) equal
               DURABLE_LAUNCHES. Printed: each query's wall and its
               query.restore / merge / estimate phases from its tick.

Then it prints one JSON line describing every kernel (its launches are
those of phases 5, 7, 8, 9, 10 and 11, the main paths), the card's name
and power limit as nvidia-smi reports them, and, last, the device line
{"ok": true, "device": {...}}. Without a card, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
import traceback
import types

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


# ------------------------------------------------------------- phase 7

# interval S1's traffic: (keys, samples a key) of timers, counters (a
# fifth at @0.5), gauges, sets (keys, members), service checks, events
SERVER_PLAN = {"timers": (20000, 10), "counters": (5000, 4),
               "gauges": 5000, "sets": (1000, 100), "checks": 100,
               "events": 10}

# the server phase's launches, predicted from the code before the first
# run (PERF.md section 6): the probe once, at the one engine's
# construction; in S1's flush compress and hll_stats once for the baseline
# rows of an empty flush (the engine's first incremental flush) and once
# for the 20000-row work set; in S2's flush (only S1's phase timers are
# dirty) once each; none at ingest; ull_insert never
SERVER_LAUNCHES = {
    "construction": {"compress": 0, "hll_stats": 0, "ull_insert": 0,
                     "probe": 1},
    "ingest": {"compress": 0, "hll_stats": 0, "ull_insert": 0, "probe": 0},
    "S1": {"compress": 2, "hll_stats": 2, "ull_insert": 0, "probe": 0},
    "S2": {"compress": 1, "hll_stats": 1, "ull_insert": 0, "probe": 0},
}

# the engine's own phases of an incremental flush, grafted under
# engine.flush in the tick's phase tree
ENGINE_PHASES = ("engine.swap", "engine.drain", "engine.gather",
                 "engine.device.dispatch", "engine.device.exec",
                 "engine.device.fetch", "engine.scatter",
                 "engine.materialize")


def server_traffic(rng, plan):
    """S1's DogStatsD lines, shuffled, with their truth: the Truth of the
    metric lines, each service check's status, the event titles; one bad
    line among them."""
    from veneur_tpu_torch.ingest.parser import UDPMetric, parse_packet
    lines = []
    nt, per = plan["timers"]
    for i in range(nt):
        for v in rng.lognormal(3, 1, per):
            lines.append(f"srv.lat.{i}:{v:.4f}|ms|#shard:{i % 8},env:chip")
    nc, per = plan["counters"]
    for i in range(nc):
        rate = "|@0.5" if i % 5 == 0 else ""
        for v in rng.integers(1, 100, per):
            lines.append(f"srv.hits.{i}:{v}|c{rate}")
    for i in range(plan["gauges"]):
        lines.append(f"srv.temp.{i}:{rng.normal(50, 10):.3f}|g")
    ns, members = plan["sets"]
    for i in range(ns):
        for j in range(members):
            lines.append(f"srv.users.{i}:u{i}-{j}|s")
    checks = {f"srv.check.{i}": i % 4 for i in range(plan["checks"])}
    lines += [f"_sc|{name}|{st}|#run:s1|m:ok" for name, st in checks.items()]
    titles = [f"deploy {i}" for i in range(plan["events"])]
    lines += [f"_e{{{len(t)},4}}:{t}|done|#run:s1" for t in titles]
    lines.append("srv.bad:not-a-number|c")
    lines = [lines[i].encode() for i in rng.permutation(len(lines))]
    truth = Truth()
    for ln in lines:
        if not ln.startswith((b"_", b"srv.bad")):
            m = parse_packet(ln)
            check(isinstance(m, UDPMetric), f"{ln!r} is not a metric")
            truth.add_parsed(m)
    return lines, truth, checks, titles


def pack_datagrams(lines, max_len):
    """Newline-joined lines in datagrams of at most max_len bytes."""
    out, cur, size = [], [], 0
    for ln in lines:
        if cur and size + 1 + len(ln) > max_len:
            out.append(b"\n".join(cur))
            cur, size = [], 0
        size += len(ln) + (1 if cur else 0)
        cur.append(ln)
    if cur:
        out.append(b"\n".join(cur))
    return out


def wait_until(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.001)


def send_paced(srv, dgrams):
    """Send every datagram to the server's UDP port in bursts of at most a
    quarter of its socket's receive buffer and half a worker queue's
    lines, each followed by a wait until the server has received every
    datagram sent and its worker queues are under half full: loopback
    drops what overflows the buffer, and a full worker queue drops lines
    (a burst of short lines can hold more lines than a queue)."""
    rcvbuf = srv._sockets[0].getsockopt(socket.SOL_SOCKET,
                                        socket.SO_RCVBUF)
    budget = max(4 * 4096, rcvbuf // 4)
    max_lines = min(q.maxsize for q in srv.worker_queues) // 2
    dest = ("127.0.0.1", srv.bound_port())
    sent = 0

    def settled():
        return srv.packets_received >= sent and all(
            q.qsize() < q.maxsize // 2 for q in srv.worker_queues)

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        i = 0
        while i < len(dgrams):
            burst = lines = 0
            while i < len(dgrams) and (burst == 0 or (
                    burst + len(dgrams[i]) <= budget
                    and lines + dgrams[i].count(b"\n") + 1 <= max_lines)):
                sock.sendto(dgrams[i], dest)
                burst += len(dgrams[i])
                lines += dgrams[i].count(b"\n") + 1
                i += 1
            sent = i
            wait_until(settled, 120, f"{sent} datagrams received")
    return {"rcvbuf": rcvbuf, "burst_bytes": budget}


def http_get(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read()


def free_port(kind):
    """A loopback port free for a socket of `kind` (SOCK_STREAM or
    SOCK_DGRAM) at the time of the call."""
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_server(device, cfg_kw=None, plan=None):
    """The port's Server at the deployment defaults on `device`: S1 over
    real UDP (paced), drained and flushed, then an empty S2; rows against
    numpy truth, the packet counters, the status rows and events, the
    HTTP routes, the launches against SERVER_LAUNCHES (on the card), and
    a clean stop. `cfg_kw` and `plan` override the widths and the traffic
    (CPU rehearsals at small shapes)."""
    from veneur_tpu_torch import kernels
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.metrics import MetricType
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.basic import CaptureMetricSink
    plan = plan or SERVER_PLAN
    rng = np.random.default_rng(17)
    lines, truth, checks, titles = server_traffic(rng, plan)
    cfg = Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                 http_address=f"127.0.0.1:{free_port(socket.SOCK_STREAM)}",
                 interval="3600s", hostname="chip", **(cfg_kw or {}))
    dgrams = pack_datagrams(lines, cfg.metric_max_length)
    cap = CaptureMetricSink()
    launches = {}

    def counted(label, fn):
        before = dict(kernels.launches)
        out = fn()
        launches[label] = {k: n - before[k]
                           for k, n in kernels.launches.items()}
        return out

    kernels.reset_launches()
    srv = counted("construction",
                  lambda: Server(cfg, sinks=[cap], device=device))
    out = {"datagrams": len(dgrams), "lines": len(lines)}
    try:
        srv.start()

        def ingest():
            t0 = time.perf_counter()
            out.update(send_paced(srv, dgrams))
            check(srv.drain(timeout=120), "drain() timed out")
            return time.perf_counter() - t0

        secs = counted("ingest", ingest)
        out["ingest_s"] = secs
        out["datagrams_per_s"] = len(dgrams) / secs
        out["lines_per_s"] = len(lines) / secs
        flushes = []
        gc_ms = {}
        for n, label in ((1, "S1"), (2, "S2")):
            check(srv.drain(timeout=120), "drain() timed out")
            with GcPauses() as gcp:
                counted(label,
                        lambda n=n: srv.flush_once(timestamp=2000 + n))
            gc_ms[label] = gcp.ms
            check(cap.wait_for_flush(n, timeout=120),
                  f"{label}: the sink got no flush")
            for t in list(srv._sink_inflight.values()):
                t.join(120)
            rows = {(m.name, tuple(m.tags)): m for m in cap.flushes[n - 1]}
            flushes.append(rows)
            out[label] = {
                k.split(".")[-1]: rows[(f"veneur.flush.{k}", ())].value / 1e6
                for k in ("total_duration_ns", "swap_duration_ns",
                          "merge_duration_ns", "assembly_duration_ns")}
            out[label]["rows"] = len(rows)
            out[label]["gc_ms"] = gc_ms[label]
        s1, s2 = flushes
        want_packets = {"veneur.packet.received_total": len(dgrams),
                        "veneur.packet.error_total": 1,
                        "veneur.worker.dropped_total": 0}
        for name, want in want_packets.items():
            got = s1[(name, ())].value
            check(got == want, f"S1 {name}: {got}, expected {want}")
        data = [m for m in s1.values() if not m.name.startswith("veneur.")
                and m.type != MetricType.STATUS]
        res = types.SimpleNamespace(metrics=data, frame=data)
        out["worst"] = check_against_truth(res, truth, srv.engines[0], "S1")
        status = {m.name: m.value for m in s1.values()
                  if m.type == MetricType.STATUS}
        check(status == {k: float(v) for k, v in checks.items()},
              f"S1 status rows: {len(status)} of {len(checks)} right")
        check(sorted(e.title for e in cap.events) == sorted(titles),
              f"events reaching flush_other: {len(cap.events)}")
        check(all(k[0].startswith("veneur.") for k in s2),
              "S2 carried rows other than veneur.*")
        for ph in ("engine", "telemetry", "fanout", "total"):
            key = (f"veneur.flush.phase.{ph}.count", ())
            check(key in s2 and s2[key].value == 1.0,
                  f"S2: no timer of S1's {ph} phase")
        port = srv.http_api.port
        check(http_get(port, "/healthcheck") == (200, b"ok\n"),
              "/healthcheck")
        code, body = http_get(port, "/healthz")
        health = json.loads(body)
        check(code == 200 and health["healthy"] and health["ready"],
              f"/healthz: {code} {health}")
        code, body = http_get(port, "/debug/flush")
        ticks = json.loads(body)["flight_recorder"]["ticks"]
        tick1 = [t for t in ticks if t["tick_id"] == 1]
        check(code == 200 and len(tick1) == 1, "/debug/flush: no tick 1")
        names = {p["name"] for p in tick1[0]["phases"]}
        missing = set(ENGINE_PHASES + ("engine.flush",)) - names
        check(not missing, f"/debug/flush tick 1 lacks {sorted(missing)}")
        out["tick1_phases"] = sorted(names)
        out["health"] = health["status"]
    finally:
        t0 = time.monotonic()
        srv.stop()
        out["stop_s"] = time.monotonic() - t0
    check(out["stop_s"] < 10.0, f"stop() took {out['stop_s']:.1f} s")
    alive = [t.name for t in srv._threads if t.is_alive()]
    check(not alive, f"threads alive after stop(): {alive}")
    out["launches_by_step"] = launches
    out["launches"] = {k: sum(step[k] for step in launches.values())
                       for k in kernels.launches}
    print(f"server launches: {json.dumps(launches)}")
    if device.type == "cuda":
        check(launches == SERVER_LAUNCHES,
              f"server launches {launches}, predicted {SERVER_LAUNCHES}")
    print(f"server: {json.dumps(out)}")
    return out


def phase_server_cli(device, cfg_kw=None):
    """The daemon's entry point on `device`: `python3 -m
    veneur_tpu_torch.cli.veneur -f <yaml>` in a subprocess (the deployment
    defaults, interval 1 s, a UDP listener, a flush_file), one burst of
    datagrams, the flush file until it holds every counter sample,
    SIGTERM, exit 0. `cfg_kw` adds config keys (CPU rehearsals at small
    widths)."""
    import signal
    import tempfile
    import threading
    backend = "cpu" if device.type == "cpu" else "tpu"
    port = free_port(socket.SOCK_DGRAM)
    lines = [f"cli.count.{i % 50}:{i % 7 + 1}|c".encode() for i in range(2000)]
    lines += [f"cli.lat.{i % 50}:{i % 97}|ms".encode() for i in range(2000)]
    want = float(sum(i % 7 + 1 for i in range(2000)))
    dgrams = pack_datagrams(lines, 4096)
    out = {"datagrams": len(dgrams)}
    with tempfile.TemporaryDirectory() as tmp:
        flush = os.path.join(tmp, "flush.tsv")
        cfg = os.path.join(tmp, "veneur.yaml")
        with open(cfg, "w") as f:
            f.write(f'interval: "1s"\nhostname: chip-cli\n'
                    f'statsd_listen_addresses: ["udp://127.0.0.1:{port}"]\n'
                    f'flush_file: "{flush}"\n'
                    f"aggregation_backend: {backend}\n")
            for k, v in (cfg_kw or {}).items():
                f.write(f"{k}: {v}\n")
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.cli.veneur", "-f", cfg],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        log = []
        serving = threading.Event()

        def read_log():
            for line in proc.stderr:
                log.append(line)
                if "serving on " in line:
                    serving.set()

        reader = threading.Thread(target=read_log, daemon=True)
        reader.start()

        def counted():
            if not os.path.exists(flush):
                return 0.0
            with open(flush) as f:
                rows = [r.split("\t") for r in f if r.endswith("\n")]
            return sum(float(r[5]) for r in rows
                       if r[0].startswith("cli.count."))

        try:
            check(serving.wait(300), "the CLI did not start serving: "
                  + "".join(log[-20:]))
            out["start_s"] = time.monotonic() - t0
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
                for d in dgrams:
                    sock.sendto(d, ("127.0.0.1", port))
            wait_until(lambda: counted() >= want, 60,
                       "the flush file to hold every counter sample")
            check(counted() == want, f"flush file counters {counted()} "
                  f"!= {want}")
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait(10)
            reader.join(10)
        out["exit_code"] = rc
        check(rc == 0, f"the CLI exited {rc} on SIGTERM: "
              + "".join(log[-20:]))
    print(f"server cli: {json.dumps(out)}")
    return out


# ------------------------------------------------------------- phase 8

# interval T1's traffic: SSF spans over UDP, each carrying a timing, a
# count of 1, a set member and a gauge on its family's keys (timing,
# counter, set, gauge key counts), every `indicator_every`-th an
# indicator span; framed spans over TCP on keys of their own, the first
# with one status sample more; the `app` tenant over DogStatsD UDP
# (counter keys x samples, timer keys x samples) and the `storm` of
# unique counter keys, one sample each
SSF_PLAN = {"udp_spans": 10000, "udp_keys": (5000, 2000, 200, 1000),
            "tcp_spans": 1000, "tcp_keys": (500, 200, 50, 100),
            "indicator_every": 10, "app_counters": (2000, 4),
            "app_timers": (500, 10), "storm": 50000, "budget": 8192}

# phase 8's launches, predicted from the code before its first run
# (PERF.md section 6): the probe at the one engine's construction; at
# ingest compress twice: the indicator timer is one key taking every
# eleventh histogram sample of the UDP spans, so the first histogram
# batch of 8192 holds 745 of its samples and the second 355 (the UDP
# remainder and the TCP spans' 100), both over the buffer depth of 256:
# each batch lands through the hot-slot sidestep, one whole-bank
# compress; the third, partial batch lands at T1's flush without one.
# In T1's flush compress and hll_stats twice (the empty flush's baseline
# rows, computed at the first incremental flush, and the work set); in
# T2's once each (T1's phase timers); ull_insert never
SSF_LAUNCHES = {
    "construction": {"compress": 0, "hll_stats": 0, "ull_insert": 0,
                     "probe": 1},
    "ingest": {"compress": 2, "hll_stats": 0, "ull_insert": 0, "probe": 0},
    "T1": {"compress": 2, "hll_stats": 2, "ull_insert": 0, "probe": 0},
    "T2": {"compress": 1, "hll_stats": 1, "ull_insert": 0, "probe": 0},
}

SSF_INDICATOR = "ssf.indicator"


def ssf_spans(rng, n, keys, prefix, every, t0_ns, truth):
    """n SSF spans of service `chip`, each with a timing (lognormal ms),
    a count of 1, a set member and a gauge on the `prefix` families'
    keys, every `every`-th an indicator span; their samples added to
    `truth` as the values the wire carries (an SSF sample's value is a
    float32)."""
    from veneur_tpu_torch import ssf
    from veneur_tpu_torch.ssf.protos import ssf_pb2
    nt, nc, ns, ng = keys
    spans = []
    lat = rng.lognormal(3, 1, n)
    temp = rng.normal(50, 10, n)
    dur = rng.integers(1_000, 5_000_000, n)
    kt, kc = rng.integers(0, nt, n), rng.integers(0, nc, n)
    ks, kg = rng.integers(0, ns, n), rng.integers(0, ng, n)
    members = rng.integers(0, 500, n)
    for i in range(n):
        start = t0_ns + i * 1000
        span = ssf_pb2.SSFSpan(
            version=0, trace_id=i + 1, id=i + 1, name=f"{prefix}.op",
            service="chip", start_timestamp=start,
            end_timestamp=start + int(dur[i]),
            indicator=(i % every == 0))
        span.metrics.extend([
            ssf.timing(f"{prefix}_lat.{kt[i]}", lat[i] / 1e3,
                       ssf.MILLISECOND),
            ssf.count(f"{prefix}_hits.{kc[i]}", 1.0),
            ssf.set_sample(f"{prefix}_users.{ks[i]}", f"u{members[i]}"),
            ssf.gauge(f"{prefix}_temp.{kg[i]}", temp[i])])
        t, c, s, g = span.metrics
        truth.histo.setdefault((t.name, ()), []).append(np.float32(t.value))
        truth.counter[(c.name, ())] = truth.counter.get((c.name, ()),
                                                        0.0) + 1.0
        truth.sets.setdefault((s.name, ()), set()).add(s.message)
        truth.gauge[(g.name, ())] = float(np.float32(g.value))
        if span.indicator:
            truth.histo.setdefault(
                (SSF_INDICATOR, ("error:false", "service:chip")),
                []).append(np.float32(int(dur[i]) / 1e6))
        spans.append(span)
    return spans


SKB_COST = 2048


def send_spans_paced(srv, payloads, send, what):
    """Send each payload with `send`, in bursts of at most a quarter of
    the SSF UDP socket's receive buffer, each followed by a wait until
    the server has counted every span sent and its span and worker
    queues are under half full. A datagram is charged its length plus
    SKB_COST: the kernel charges a socket each datagram's whole buffer,
    which for a span of a few hundred bytes is several times its
    length."""
    rcvbuf = srv._ssf_udp_sock.getsockopt(socket.SOL_SOCKET,
                                          socket.SO_RCVBUF)
    budget = max(4 * 4096, rcvbuf // 4)
    base = srv.spans_received
    sent = 0

    def settled():
        return (srv.spans_received - base >= sent
                and srv.span_queue.qsize() < srv.span_queue.maxsize // 2
                and all(q.qsize() < q.maxsize // 2
                        for q in srv.worker_queues))

    i = 0
    while i < len(payloads):
        burst = 0
        while i < len(payloads) and (
                burst == 0 or burst + len(payloads[i]) + SKB_COST <= budget):
            send(payloads[i])
            burst += len(payloads[i]) + SKB_COST
            i += 1
        sent = i
        wait_until(settled, 120, f"{sent} {what} spans received")


def emit(args):
    """One run of `python3 -m veneur_tpu_torch.cli.emit` with `args`."""
    subprocess.run([sys.executable, "-m", "veneur_tpu_torch.cli.emit",
                    *args], cwd=ROOT, check=True, timeout=120,
                   stdout=subprocess.DEVNULL)


def tick_phase_ms(srv, tick_id, name):
    """Milliseconds of the top-level phase `name` of flush tick
    `tick_id`, from the flight recorder."""
    for t in srv.flight.debug_state()["ticks"]:
        if t["tick_id"] == tick_id:
            for p in t["phases"]:
                if p["name"] == name and p["parent"] == -1:
                    return (p["end_ns"] - p["start_ns"]) / 1e6
    raise AssertionError(f"tick {tick_id} has no {name} phase")


def phase_ssf_overload(device, cfg_kw=None, plan=None):
    """The port's Server with SSF listeners (UDP and TCP), self-tracing,
    the overload defense and the profiler trigger on `device`: T1 over
    real sockets (paced), drained and flushed under a profiler capture,
    then T2 with only T1's self-traced spans; rows against numpy truth,
    the storm's fold against the budget, the accounting identity, the
    HTTP state, the trace file, the launches against SSF_LAUNCHES (on
    the card), and a clean stop. `cfg_kw` and `plan` override the widths
    and the traffic (CPU rehearsals at small shapes)."""
    import tempfile
    from veneur_tpu_torch import kernels
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ingest.parser import parse_packet
    from veneur_tpu_torch.metrics import MetricType
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.basic import CaptureMetricSink
    from veneur_tpu_torch.ssf import framing
    plan = plan or SSF_PLAN
    rng = np.random.default_rng(23)
    every = plan["indicator_every"]
    ssf_truth, app_truth = Truth(), Truth()
    t0_ns = time.time_ns()
    udp = ssf_spans(rng, plan["udp_spans"], plan["udp_keys"], "ssfu",
                    every, t0_ns, ssf_truth)
    tcp = ssf_spans(rng, plan["tcp_spans"], plan["tcp_keys"], "ssft",
                    every, t0_ns, ssf_truth)
    from veneur_tpu_torch import ssf
    tcp[0].metrics.append(ssf.status("ssft_check.db", 2, message="down"))
    udp_dgrams = [s.SerializeToString() for s in udp]
    tcp_frames = [framing.write_ssf(s) for s in tcp]
    nc, per_c = plan["app_counters"]
    nt, per_t = plan["app_timers"]
    app = [f"app.hits.{i}:{v}|c" for i in range(nc)
           for v in rng.integers(1, 100, per_c)]
    app += [f"app.lat.{i}:{v:.4f}|ms" for i in range(nt)
            for v in rng.lognormal(3, 1, per_t)]
    app = [app[i].encode() for i in rng.permutation(len(app))]
    for ln in app:
        app_truth.add_parsed(parse_packet(ln))
    storm = [f"storm.u{k}:1|c".encode() for k in range(plan["storm"])]
    budget = plan["budget"]
    samples_sent = (4 * (len(udp) + len(tcp)) + len(app) + len(storm)
                    + sum(s.indicator for s in udp + tcp) + 2)
    out = {"udp_spans": len(udp), "tcp_spans": len(tcp),
           "app_lines": len(app), "storm_keys": len(storm)}
    profile_dir = tempfile.mkdtemp(prefix="veneur-profile-")
    cfg = Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                 ssf_listen_addresses=["udp://127.0.0.1:0",
                                       "tcp://127.0.0.1:0"],
                 http_address=f"127.0.0.1:{free_port(socket.SOCK_STREAM)}",
                 interval="3600s", hostname="chip",
                 indicator_span_timer_name=SSF_INDICATOR,
                 overload_defense_enabled=True,
                 overload_max_keys_per_prefix=budget,
                 debug_flush_profile=True,
                 debug_flush_profile_dir=profile_dir, **(cfg_kw or {}))
    cap = CaptureMetricSink()
    launches = {}

    def counted(label, fn):
        before = dict(kernels.launches)
        res = fn()
        launches[label] = {k: n - before[k]
                           for k, n in kernels.launches.items()}
        return res

    kernels.reset_launches()
    srv = counted("construction",
                  lambda: Server(cfg, sinks=[cap], device=device))
    threads_before = set(threading.enumerate())
    try:
        srv.start()
        check(srv.trace_client is not None, "no self-tracing client")
        ssf_port = srv._ssf_udp_sock.getsockname()[1]
        tcp_port = srv._listen_socks[0].getsockname()[1]
        statsd = ("127.0.0.1", srv.bound_port())

        def ingest():
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
                t = time.perf_counter()
                send_spans_paced(
                    srv, udp_dgrams,
                    lambda d: sock.sendto(d, ("127.0.0.1", ssf_port)),
                    "UDP")
                check(srv.drain(timeout=120), "drain() timed out")
                out["udp_s"] = time.perf_counter() - t
                with socket.create_connection(("127.0.0.1", tcp_port),
                                              timeout=30) as conn:
                    t = time.perf_counter()
                    send_spans_paced(srv, tcp_frames, conn.sendall, "TCP")
                    check(srv.drain(timeout=120), "drain() timed out")
                    out["tcp_s"] = time.perf_counter() - t
                sock.sendto(b"garbage\xff", ("127.0.0.1", ssf_port))
                wait_until(lambda: srv.ssf_errors >= 1, 30,
                           "the garbage datagram")
                app_dg = pack_datagrams(app, cfg.metric_max_length)
                send_paced(srv, app_dg)
                storm_dg = pack_datagrams(storm, cfg.metric_max_length)
                t = time.perf_counter()
                send_paced(srv, storm_dg)
                check(srv.drain(timeout=120), "drain() timed out")
                out["storm_s"] = time.perf_counter() - t
            out["statsd_datagrams"] = len(app_dg) + len(storm_dg) + 1
            out["storm_datagrams"] = len(storm_dg)
            emit(["-hostport", f"udp://127.0.0.1:{ssf_port}", "-ssf",
                  "-name", "chip_emit.span", "-count", "1"])
            emit(["-hostport", f"udp://{statsd[0]}:{statsd[1]}",
                  "-name", "chip_emit.line", "-count", "1"])
            wait_until(lambda: srv.spans_received >= len(udp) + len(tcp) + 1
                       and srv.packets_received >= out["statsd_datagrams"],
                       60, "the emitted span and line")
            check(srv.drain(timeout=120), "drain() timed out")

        counted("ingest", ingest)
        n_ind = sum(s.indicator for s in udp)
        out["udp_spans_per_s"] = len(udp) / out["udp_s"]
        out["udp_samples_per_s"] = (4 * len(udp) + n_ind) / out["udp_s"]
        n_ind_t = sum(s.indicator for s in tcp)
        out["tcp_spans_per_s"] = len(tcp) / out["tcp_s"]
        out["tcp_samples_per_s"] = (4 * len(tcp) + n_ind_t + 1) / out["tcp_s"]
        out["storm_datagrams_per_s"] = out["storm_datagrams"] / out["storm_s"]
        http = srv.http_api.port
        code, body = http_get(http, "/debug/flush/profile")
        check(code == 200 and json.loads(body)["capture_ticks"] == 1,
              f"/debug/flush/profile: {code} {body!r}")
        flushes, gc_ms = [], {}
        for n, label in ((1, "T1"), (2, "T2")):
            if n == 2:
                # T1's self-traced spans reach the SSF listener after
                # T1's flush; T2 must count them
                wait_until(lambda: srv.spans_received > 0, 30,
                           "T1's self-traced spans")
            check(srv.drain(timeout=120), "drain() timed out")
            with GcPauses() as gcp:
                counted(label,
                        lambda n=n: srv.flush_once(timestamp=3000 + n))
            gc_ms[label] = gcp.ms
            check(cap.wait_for_flush(n, timeout=120),
                  f"{label}: the sink got no flush")
            for t in list(srv._sink_inflight.values()):
                t.join(120)
            rows = {(m.name, tuple(m.tags)): m for m in cap.flushes[n - 1]}
            flushes.append(rows)
            out[label] = {
                k.split(".")[-1]: rows[(f"veneur.flush.{k}", ())].value / 1e6
                for k in ("total_duration_ns", "swap_duration_ns",
                          "merge_duration_ns", "assembly_duration_ns")}
            out[label]["overload_phase_ms"] = tick_phase_ms(srv, n, "overload")
            out[label]["gc_ms"] = gc_ms[label]
            out[label]["rows"] = len(rows)
        t1, t2 = flushes

        def self_row(name, rows=t1):
            return rows[(f"veneur.{name}", ())].value

        n_spans = len(udp) + len(tcp) + 1
        check(self_row("ssf.received_total") == n_spans,
              f"T1 spans received {self_row('ssf.received_total')}, "
              f"sent {n_spans}")
        check(self_row("ssf.error_total") == 1,
              f"T1 ssf errors {self_row('ssf.error_total')}, expected 1")
        check(self_row("worker.dropped_total") == 0,
              "T1: a span or worker queue dropped")
        check(self_row("packet.received_total") == out["statsd_datagrams"],
              "T1: statsd datagrams lost")
        # the SSF rows against their truth
        fams = ("ssfu_", "ssft_", SSF_INDICATOR + ".", SSF_INDICATOR)
        data = [m for m in t1.values() if m.name.startswith(fams)
                and m.type != MetricType.STATUS]
        eng = srv.engines[0]
        out["worst_ssf"] = check_against_truth(
            types.SimpleNamespace(metrics=data, frame=data), ssf_truth,
            eng, "T1 ssf")
        ind = t1[(SSF_INDICATOR + ".count", ("error:false", "service:chip"))]
        check(ind.value == n_ind + n_ind_t,
              f"indicator timer count {ind.value}, spans {n_ind + n_ind_t}")
        status = t1.get(("ssft_check.db", ()))
        check(status is not None and status.type == MetricType.STATUS
              and status.value == 2.0, f"the status sample's row: {status}")
        check(t1[("chip_emit.span", ())].value == 1.0
              and t1[("chip_emit.line", ())].value == 1.0,
              "the emitted span's and line's counters")
        # the tenant against its no-storm truth
        data = [m for m in t1.values() if m.name.startswith("app.")]
        out["worst_app"] = check_against_truth(
            types.SimpleNamespace(metrics=data, frame=data), app_truth,
            eng, "T1 app")
        # the storm: the budget's keys plus one fold key
        storm_rows = {k: m for k, m in t1.items()
                      if k[0].startswith("storm.")}
        other = storm_rows.pop(("storm.__other__", ()), None)
        check(len(storm_rows) == budget and all(
            m.value == 1.0 for m in storm_rows.values()),
            f"storm: {len(storm_rows)} keys minted, budget {budget}")
        minted = sum(1 for e in srv.engines for k in e.counter_keys._map
                     if k.name.startswith("storm."))
        check(minted == budget + 1,
              f"storm: {minted} counter slots, expected {budget + 1}")
        folded = len(storm) - budget
        check(other is not None and other.value == folded
              and other.tags == [],
              f"storm.__other__: {other and other.value}, folded {folded}")
        check(self_row("overload.folded_samples_total") == folded,
              f"folded_samples_total {self_row('overload.folded_samples_total')}"
              f" != {folded}")
        check(self_row("overload.keys_over_budget_total") > 0,
              "no key over budget counted")
        # received == applied + counted_degraded
        applied = self_row("samples.processed_total")
        degraded = (self_row("overload.fold_sampled_out_total")
                    + self_row("overload.shed_packets_total")
                    + self_row("worker.dropped_total")
                    + self_row("packet.error_total"))
        check(samples_sent == applied + degraded,
              f"accounting: sent {samples_sent}, applied {applied}, "
              f"degraded {degraded}")
        check(self_row("samples.dropped_no_slot_total") == 0,
              "T1: samples dropped for want of a slot")
        check(self_row("overload.adaptive_sample_rate") == 1.0
              and self_row("overload.shed_packets_total") == 0,
              "the governor shed packets")
        out["folded"] = folded
        out["samples_sent"] = samples_sent
        code, body = http_get(http, "/debug/flush")
        adm = json.loads(body)["admission"]
        rows_by = {r["prefix"]: r for r in adm["prefixes"]}
        check(code == 200 and rows_by.get("storm", {}).get("over_budget")
              and rows_by["storm"]["admitted"] == budget,
              f"/debug/flush admission: {rows_by.get('storm')}")
        out["storm_estimated_keys"] = rows_by["storm"]["estimated_keys"]
        # T2: only veneur.* rows, and T1's self-traced spans counted
        check(all(k[0].startswith("veneur.") for k in t2),
              "T2 carried rows other than veneur.*: " + str(sorted(
                  k for k in t2 if not k[0].startswith("veneur."))[:5]))
        out["T2_spans_received"] = self_row("ssf.received_total", t2)
        check(out["T2_spans_received"] > 0, "T2 counted no span")
        # the profile capture of T1's flush
        traces = [f for f in os.listdir(profile_dir) if f.endswith(".json")]
        check(len(traces) == 1, f"profile traces: {traces}")
        with open(os.path.join(profile_dir, traces[0])) as f:
            text = f.read()
        out["profile_trace_bytes"] = len(text)
        out["profile_names_compress"] = "compress_kernel" in text
        if device.type == "cuda":
            check(out["profile_names_compress"],
                  "the profile trace does not name compress_kernel")
    finally:
        t0 = time.monotonic()
        srv.stop()
        out["stop_s"] = time.monotonic() - t0
    check(out["stop_s"] < 10.0, f"stop() took {out['stop_s']:.1f} s")
    alive = [t.name for t in set(threading.enumerate()) - threads_before
             if t.is_alive()]
    check(not alive, f"threads alive after stop(): {alive}")
    out["launches_by_step"] = launches
    out["launches"] = {k: sum(step[k] for step in launches.values())
                       for k in kernels.launches}
    print(f"ssf+overload launches: {json.dumps(launches)}")
    if device.type == "cuda":
        check(launches == SSF_LAUNCHES,
              f"ssf+overload launches {launches}, predicted {SSF_LAUNCHES}")
    print(f"ssf+overload: {json.dumps(out)}")
    return out


# ------------------------------------------------------------- phase 9

# the global tier's traffic. G1 (lossless) and G2 (q16): `locals` port
# locals, each with a shard of every mixed timer's samples, global-only
# counters (samples a local) and gauges, mixed sets (keys, members a
# local, offset between locals: local j sends members j*offset ...
# j*offset + members - 1), local-only timers; the hot key `g.hot` from
# those locals and `hot_senders` small locals, each with a shard of
# `hot_samples`. G3: the same locals touch `touch` of their counter keys
# and sets and flush a delta export. G4: `req_locals` req+ull locals
# with their own timers and sets into a req+ull global.
GLOBAL_PLAN = {"locals": 4, "timers": (20000, 25), "counters": (5000, 4),
               "gauges": 5000, "sets": (1000, 1000, 500),
               "local_timers": (100, 25), "hot_senders": 600,
               "hot_samples": 20000, "touch": 0.1, "req_locals": 2,
               "req_timers": (5000, 25), "req_sets": (1000, 1000, 500)}
# the small locals' widths (every other setting at its default)
HOT_SENDER_CFG = {"histogram_slots": 64, "counter_slots": 16,
                  "gauge_slots": 16, "set_slots": 16}

# phase 9's launches, predicted from the code before the first run
# (PERF.md section 6). Locals (4 default-width + 600 small, kept for G2):
# the probe at construction; the hot shard of 20000 samples lands through
# the hot-slot sidestep, one compress; each flush is incremental, the
# first one a compress and an hll_stats for the empty flush's baseline
# rows and one each for the work set. The global stages 4 x 20001 + 600
# = 80604 digests, so 9 landings fire at import (every 8192) and the
# remainder lands in the flush; a landing at C = B = 256 is one compress
# before the merge and one after. G3's flushes have no dirty histogram
# row but run the 64-row work set for their counters and sets. G4's
# locals land 1M set updates through the landing buffer of 131072: 7
# inserts at ingest and 1 in the flush each; REQ and ULL launch no
# compress or hll_stats, and the ULL import is the row join, not the
# insert kernel.
GLOBAL_LAUNCHES = {
    "G1 locals": {"compress": 1812, "hll_stats": 1208, "ull_insert": 0,
                  "probe": 604},
    "G1 construction": {"compress": 0, "hll_stats": 0, "ull_insert": 0,
                        "probe": 1},
    "G1 import": {"compress": 18, "hll_stats": 0, "ull_insert": 0,
                  "probe": 0},
    "G1 flush": {"compress": 4, "hll_stats": 2, "ull_insert": 0,
                 "probe": 0},
    "G2 locals": {"compress": 1208, "hll_stats": 604, "ull_insert": 0,
                  "probe": 0},
    "G2 import": {"compress": 18, "hll_stats": 0, "ull_insert": 0,
                  "probe": 0},
    "G2 flush": {"compress": 3, "hll_stats": 1, "ull_insert": 0,
                 "probe": 0},
    "G3 locals": {"compress": 4, "hll_stats": 4, "ull_insert": 0,
                  "probe": 0},
    "G3 import": {"compress": 0, "hll_stats": 0, "ull_insert": 0,
                  "probe": 0},
    "G3 flush": {"compress": 1, "hll_stats": 1, "ull_insert": 0,
                 "probe": 0},
    "G4 construction": {"compress": 0, "hll_stats": 0, "ull_insert": 0,
                        "probe": 3},
    "G4 locals": {"compress": 0, "hll_stats": 0, "ull_insert": 16,
                  "probe": 0},
    "G4 import": {"compress": 0, "hll_stats": 0, "ull_insert": 0,
                  "probe": 0},
    "G4 flush": {"compress": 0, "hll_stats": 0, "ull_insert": 0,
                 "probe": 0},
}


def member_hashes(key_ids, members):
    """64-bit member hashes (splitmix64 of key id << 32 | member): the
    same member of the same set hashes alike on every local."""
    z = ((np.asarray(key_ids, np.uint64) << np.uint64(32))
         | np.asarray(members, np.uint64)) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _slots(interner, names, mtype, scope):
    from veneur_tpu_torch.ingest.parser import MetricKey
    return np.array([interner.lookup(MetricKey(n, mtype, ""), scope)
                     for n in names], np.int32)


def _ingest_sets(eng, slots, key_ids, members):
    """Every (slot, member) of a [keys, members] plan through
    ingest_set_batch, in batches of the engine's batch size."""
    b = eng.cfg.batch_size
    s = np.repeat(slots, members.shape[1])
    idx, rho = eng._seng.host_hash_to_updates(
        member_hashes(np.repeat(key_ids, members.shape[1]),
                      members.reshape(-1)))
    for i in range(0, len(s), b):
        eng.ingest_set_batch(s[i:i + b], idx[i:i + b], rho[i:i + b],
                             count=len(s[i:i + b]))


def global_interval(rng, plan, j, hot):
    """Local j's share of one interval of G1/G2: the arrays it ingests."""
    per = plan["timers"][1]
    cols = np.array_split(np.arange(per), plan["locals"])[j]
    nc, cper = plan["counters"]
    ns, members, offset = plan["sets"]
    nl, lper = plan["local_timers"]
    return {
        "timer_cols": cols,
        "counters": rng.integers(1, 100, (nc, cper)).astype(np.float32),
        "gauges": rng.normal(0, 100, plan["gauges"]).astype(np.float32),
        "set_members": np.broadcast_to(
            np.arange(members) + j * offset, (ns, members)),
        "local_timers": rng.lognormal(2, 1, (nl, lper)).astype(np.float32),
        "hot": hot,
    }


def feed_global_local(eng, d, timers):
    """One default-width local's interval through the batch entry points:
    its shard of the mixed timers `g.t*`, the local-only timers `g.l*`,
    the global-only counters `g.c*` and gauges `g.g*`, the mixed sets
    `g.s*` and its hot shard (one batch: the hot-slot sidestep)."""
    from veneur_tpu_torch.ingest.parser import (GLOBAL_ONLY, LOCAL_ONLY,
                                                MIXED_SCOPE)
    b = eng.cfg.batch_size
    nt = timers.shape[0]
    cols = d["timer_cols"]
    ts = np.repeat(_slots(eng.histo_keys, [f"g.t{i}" for i in range(nt)],
                          "timer", MIXED_SCOPE), len(cols))
    _feed_histos(eng, ts, timers[:, cols].reshape(-1), b)
    lt = d["local_timers"]
    ls = np.repeat(_slots(eng.histo_keys,
                          [f"g.l{i}" for i in range(len(lt))], "timer",
                          LOCAL_ONLY), lt.shape[1])
    _feed_histos(eng, ls, lt.reshape(-1), b)
    c = d["counters"]
    cs = np.tile(_slots(eng.counter_keys, [f"g.c{i}" for i in range(len(c))],
                        "counter", GLOBAL_ONLY), c.shape[1])
    flat = c.T.reshape(-1)
    for i in range(0, len(cs), b):
        eng.ingest_counter_batch(cs[i:i + b], flat[i:i + b],
                                 np.ones(len(cs[i:i + b]), np.float32))
    g = d["gauges"]
    eng.ingest_gauge_batch(
        _slots(eng.gauge_keys, [f"g.g{i}" for i in range(len(g))], "gauge",
               GLOBAL_ONLY), g)
    m = d["set_members"]
    _ingest_sets(eng, _slots(eng.set_keys, [f"g.s{i}" for i in range(len(m))],
                             "set", MIXED_SCOPE), np.arange(len(m)), m)
    feed_hot(eng, d["hot"])


def feed_hot(eng, v):
    from veneur_tpu_torch.ingest.parser import MIXED_SCOPE
    slot = _slots(eng.histo_keys, ["g.hot"], "timer", MIXED_SCOPE)[0]
    eng.ingest_histo_batch(np.full(len(v), slot, np.int32), v,
                           np.ones(len(v), np.float32), count=len(v))


class LandingProbe:
    """Times each import landing of a global engine's digests: its
    cluster_rows calls and the merge-and-compress rest after the last of
    them (CUDA events on the card, the host clock on the CPU), with the
    arms (sorted_prefix) it ran, its digests and its compress launches.
    Keeps the set bank the last set landing returned (`set_bank`: the
    interval's bank, retired by the flush, with every row landed). Only
    the landing thread's cluster_rows calls count toward its landing:
    two globals' workers may land at once, each under its own probe."""

    def __init__(self, eng, device):
        from veneur_tpu_torch import kernels
        from veneur_tpu_torch.ops import tdigest
        self.records = []
        self._eng, self._device = eng, device
        self._kernels, self._td = kernels, tdigest
        self._cur = None
        self._thread = None
        self.set_bank = None

    def __enter__(self):
        # probes nest: each calls through the one entered before it
        self._real_cluster = self._td.cluster_rows
        self._td.cluster_rows = self._cluster
        self._real_land = self._eng._land_import_centroids
        self._eng._land_import_centroids = self._land
        self._real_sets = self._eng._land_import_sets
        self._eng._land_import_sets = self._land_sets
        return self

    def __exit__(self, *exc):
        self._td.cluster_rows = self._real_cluster
        del self._eng._land_import_centroids
        del self._eng._land_import_sets
        return False

    def _land_sets(self, bank, items, dirty):
        bank = self._real_sets(bank, items, dirty)
        if items:
            self.set_bank = bank
        return bank

    def _mark(self):
        import torch
        if self._device.type != "cuda":
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _ms(self, a, b):
        if self._device.type != "cuda":
            return (b - a) * 1e3
        return a.elapsed_time(b)

    def _cluster(self, values, weights, *args, sorted_prefix=0, **kw):
        t0 = self._mark()
        out = self._real_cluster(values, weights, *args,
                                 sorted_prefix=sorted_prefix, **kw)
        if self._cur is not None and \
                threading.get_ident() == self._thread:
            self._cur["calls"].append((t0, self._mark(), sorted_prefix,
                                       tuple(values.shape)))
        return out

    def _land(self, bank, items, dirty):
        if not items:
            return self._real_land(bank, items, dirty)
        self._cur = rec = {"calls": []}
        self._thread = threading.get_ident()
        before = self._kernels.launches["compress"]
        t0 = self._mark()
        out = self._real_land(bank, items, dirty)
        t1 = self._mark()
        sync(self._device)
        self._cur = None
        calls = rec["calls"]
        self.records.append({
            "digests": len(items),
            "arms": [c[2] for c in calls],
            "shapes": [list(c[3]) for c in calls],
            "cluster_rows_ms_each": [self._ms(a, b) for a, b, *_ in calls],
            "cluster_rows_ms": sum(self._ms(a, b) for a, b, *_ in calls),
            "merge_compress_ms": self._ms(calls[-1][1] if calls else t0,
                                          t1),
            "wall_ms": self._ms(t0, t1),
            "compress": self._kernels.launches["compress"] - before})
        return out


def _serialize(res, codec):
    """A local's flush result as a forwarder sends it: export_to_metrics,
    then one serialized MetricList; with the milliseconds of each."""
    from veneur_tpu_torch.cluster import wire
    from veneur_tpu_torch.cluster.protos import forward_pb2
    t0 = time.perf_counter()
    metrics = wire.export_to_metrics(res.export, codec=codec)
    t1 = time.perf_counter()
    data = forward_pb2.MetricList(metrics=metrics).SerializeToString()
    t2 = time.perf_counter()
    return data, {"metrics": len(metrics), "bytes": len(data),
                  "to_metrics_ms": (t1 - t0) * 1e3,
                  "serialize_ms": (t2 - t1) * 1e3}


def _import_all(glob, payloads, op0):
    """Decode each payload and land it with import_list, as an import
    server would; returns the metrics and the milliseconds of both."""
    from veneur_tpu_torch.cluster.protos import forward_pb2
    n = decode = apply = 0.0
    for op, data in enumerate(payloads, start=op0):
        t0 = time.perf_counter()
        ml = forward_pb2.MetricList.FromString(data)
        t1 = time.perf_counter()
        rerouted, rejected = glob.import_list(op, ml.metrics)
        t2 = time.perf_counter()
        check(not rerouted and not rejected,
              f"import op {op}: {len(rerouted)} rerouted, "
              f"{len(rejected)} rejected ({rejected[:1]})")
        n += len(ml.metrics)
        decode += (t1 - t0) * 1e3
        apply += (t2 - t1) * 1e3
    return {"metrics": int(n), "decode_ms": decode, "import_list_ms": apply,
            "ms_per_1000": (decode + apply) / max(n, 1) * 1e3}


def _flush_record(res, ms, gc_ms):
    st = res.stats
    return {"wall_ms": ms, "swap_ms": st["swap_ns"] / 1e6,
            "merge_ms": st["merge_ns"] / 1e6,
            "assembly_ms": st["assembly_ns"] / 1e6, "gc_ms": gc_ms,
            "rows": len(res.frame), "path": st["flush_path"]["path"],
            "forward_kind": st["forward_kind"]}


def timed_flush(eng, **kw):
    with GcPauses() as gcp:
        t0 = time.monotonic()
        res = eng.flush(**kw)
        ms = (time.monotonic() - t0) * 1e3
    return res, _flush_record(res, ms, gcp.ms)


def regs_of(eng, bank, names):
    """The register rows of `names` in `bank`, on the host (the slots
    read from the interner's table: a lookup would mark them touched)."""
    slot = {k.name: s for k, s, *_ in eng.set_keys.all_items()}
    return bank.registers[[slot[n] for n in names]].cpu().numpy()


def check_local_frame(res, timers, d, label):
    """A forwarding local's own rows: mixed timers (and the hot key)
    their aggregates only, local-only timers in full, nothing global;
    its export holds every mixed timer and the hot key, no local-only
    timer, and every global-only counter and gauge and mixed set."""
    rows = rows_of(res)
    nt = timers.shape[0]
    nl = len(d["local_timers"])
    check(len(res.frame) == 3 * (nt + 1) + 6 * nl,
          f"{label}: {len(res.frame)} local rows")
    cols = d["timer_cols"]
    for i in range(0, nt, 97):
        v = timers[i, cols]
        check(rows[(f"g.t{i}.count", ())].value == len(v)
              and rows[(f"g.t{i}.max", ())].value == float(v.max()),
              f"{label}: local aggregates of g.t{i}")
        check((f"g.t{i}.50percentile", ()) not in rows,
              f"{label}: g.t{i} flushed a local percentile")
    for i in range(nl):
        check((f"g.l{i}.50percentile", ()) in rows,
              f"{label}: local-only g.l{i} not flushed in full")
    names = [k.name for k, *_ in res.export.histograms]
    check(len(names) == nt + 1 and "g.hot" in names
          and not any(n.startswith("g.l") for n in names),
          f"{label}: export histograms")
    e = res.export
    check(len(e.counters) == len(d["counters"])
          and len(e.gauges) == len(d["gauges"])
          and len(e.sets) == len(d["set_members"]),
          f"{label}: export {len(e.counters)} counters, {len(e.gauges)} "
          f"gauges, {len(e.sets)} sets")


def check_global(res, glob, set_bank, timers, hot, counters, gauges,
                 exported, members, label):
    """The global's rows against numpy truth over the union: count, min
    and max exact, percentiles under the histogram engine's contract
    (check_percentiles), counters exact, gauges the last import; each
    set's registers equal to the join of the exported rows and its
    estimate under the set engine's contract (set_ok)."""
    from veneur_tpu_torch import sketches
    rows = rows_of(res)
    worst = {"set_rel_err": 0.0}
    keyed = [(f"g.t{i}", timers[i]) for i in range(timers.shape[0])]
    if hot is not None:
        keyed.append(("g.hot", hot))
    for name, v in keyed:
        check(rows[(name + ".count", ())].value == len(v)
              and rows[(name + ".min", ())].value == float(v.min())
              and rows[(name + ".max", ())].value == float(v.max()),
              f"{label}: {name} count/min/max")
        check_percentiles(rows, name, (), v, glob._heng, label, worst)
    for name, total in counters.items():
        check(rows[(name, ())].value == total,
              f"{label}: counter {name} {rows[(name, ())].value} != {total}")
    for name, value in gauges.items():
        check(rows[(name, ())].value == value, f"{label}: gauge {name}")
    names = list(exported)
    got = regs_of(glob, set_bank, names)
    for r, name in enumerate(names):
        want = exported[name][0]
        for regs in exported[name][1:]:
            want = sketches.merge_registers(glob._seng.id, want, regs)
        check(np.array_equal(got[r], want),
              f"{label}: {name} registers are not the join of the exports")
        est = rows[(name, ())].value
        worst["set_rel_err"] = max(worst["set_rel_err"],
                                   abs(est - members) / members)
        check(set_ok(est, members, glob._seng),
              f"{label}: set {name} {est} vs {members}")
    n_rows = (6 * len(keyed) + len(counters) + len(gauges) + len(exported))
    check(len(res.frame) == n_rows,
          f"{label}: {len(res.frame)} global rows, expected {n_rows}: "
          f"{sorted(rows)[:20]}")
    return worst


def phase_global(device, cfg_kw=None, plan=None, hot_cfg_kw=None):
    """The global tier on `device`: port locals (forward_enabled) flush
    their exports, `wire.export_to_metrics` and a serialized MetricList
    carry them, and a port global (is_global) decodes and lands them with
    import_list, then flushes; G1 lossless, G2 q16, G3 delta, G4 req+ull.
    Rows against numpy truth, the locals' frames and exports, both arms
    of the oversized-pile re-chunking, and the launches of each step
    against GLOBAL_LAUNCHES (on the card). `cfg_kw`, `hot_cfg_kw` and
    `plan` override the widths and the traffic (CPU rehearsals)."""
    from veneur_tpu_torch import kernels
    from veneur_tpu_torch.ingest.parser import GLOBAL_ONLY, MIXED_SCOPE
    from veneur_tpu_torch.models.pipeline import (AggregationEngine,
                                                  EngineConfig)
    plan = plan or GLOBAL_PLAN
    cfg_kw = cfg_kw or {}
    hot_kw = {**HOT_SENDER_CFG, **(hot_cfg_kw or {})}
    rng = np.random.default_rng(9)
    launches, out = {}, {"steps": {}}

    def counted(label, fn):
        before = dict(kernels.launches)
        r = fn()
        launches[label] = {k: n - before[k]
                           for k, n in kernels.launches.items()}
        return r

    def make(**kw):
        return AggregationEngine(EngineConfig(**{**cfg_kw, **kw}),
                                 device=device)

    kernels.reset_launches()
    n_loc, n_hot, hs = plan["locals"], plan["hot_senders"], plan["hot_samples"]
    locs, small, glob = [], [], None

    for label, codec in (("G1", "lossless"), ("G2", "q16")):
        nt, per = plan["timers"]
        timers = rng.lognormal(3, 1, (nt, per)).astype(np.float32)
        hots = rng.lognormal(3, 1, (n_loc + n_hot, hs)).astype(np.float32)
        shares = [global_interval(rng, plan, j, hots[j])
                  for j in range(n_loc)]
        rec = {"locals": [], "small_senders": {}}

        def locals_step():
            payloads = []
            if not locs:
                locs.extend(make(forward_enabled=True)
                            for _ in range(n_loc))
                small.extend(AggregationEngine(EngineConfig(
                    forward_enabled=True, **hot_kw), device=device)
                    for _ in range(n_hot))
            t0 = time.perf_counter()
            centroids = set()
            for s, eng in enumerate(small):
                feed_hot(eng, hots[n_loc + s])
                res = eng.flush(timestamp=90)
                check([k.name for k, *_ in res.export.histograms]
                      == ["g.hot"], f"{label}: small sender {s} export")
                centroids.add(len(res.export.histograms[0][1]))
                payloads.append(_serialize(res, codec)[0])
            rec["small_senders"] = {"n": n_hot,
                                    "s": time.perf_counter() - t0,
                                    "centroids": sorted(centroids)}
            for j, eng in enumerate(locs):
                t0 = time.perf_counter()
                feed_global_local(eng, shares[j], timers)
                ingest_s = time.perf_counter() - t0
                res, frec = timed_flush(eng, timestamp=90)
                check_local_frame(res, timers, shares[j],
                                  f"{label} local {j}")
                data, srec = _serialize(res, codec)
                payloads.append(data)
                rec["locals"].append({"ingest_s": ingest_s, **frec, **srec,
                                      "exports": res.export})
            return payloads

        payloads = counted(f"{label} locals", locals_step)
        exports = [r.pop("exports") for r in rec["locals"]]
        if glob is None:
            glob = counted("G1 construction",
                           lambda: make(is_global=True))
        with LandingProbe(glob, device) as probe:
            rec["import"] = counted(f"{label} import",
                                    lambda: _import_all(glob, payloads, 1))
            at_import = len(probe.records)
            res, rec["flush"] = counted(
                f"{label} flush", lambda: timed_flush(glob, timestamp=91))
        rec["landings"] = probe.records
        rec["landings_at_import"] = at_import
        arms = {a for r in probe.records for a in r["arms"]}
        C = glob.histo_bank.num_centroids
        check({0, C} <= arms, f"{label}: re-chunk arms {sorted(arms)}, "
              f"expected both 0 and {C}")
        counters = {f"g.c{i}": float(sum(d["counters"][i].astype(np.float64)
                                         .sum() for d in shares))
                    for i in range(plan["counters"][0])}
        gauges = {f"g.g{i}": float(shares[-1]["gauges"][i])
                  for i in range(plan["gauges"])}
        ns, members, offset = plan["sets"]
        exported = {f"g.s{i}": [] for i in range(ns)}
        for e in exports:
            for k, regs in e.sets:
                exported[k.name].append(regs)
        rec["worst"] = check_global(
            res, glob, probe.set_bank, timers, hots.reshape(-1), counters,
            gauges, exported, members + (n_loc - 1) * offset, label)
        out["steps"][label] = rec

    # G3: the locals touch a tenth of their counters and sets and flush a
    # delta export: exactly the touched keys ship
    nc = int(plan["counters"][0] * plan["touch"])
    ns = int(plan["sets"][0] * plan["touch"])
    members, offset = plan["sets"][1], plan["sets"][2]
    rec = {"locals": []}

    def delta_step():
        payloads = []
        for j, eng in enumerate(locs):
            cs = _slots(eng.counter_keys, [f"g.c{i}" for i in range(nc)],
                        "counter", GLOBAL_ONLY)
            eng.ingest_counter_batch(cs, np.full(nc, j + 1, np.float32),
                                     np.ones(nc, np.float32))
            _ingest_sets(eng, _slots(eng.set_keys,
                                     [f"g.s{i}" for i in range(ns)], "set",
                                     MIXED_SCOPE), np.arange(ns),
                         np.broadcast_to(np.arange(members) + 10 ** 6
                                         + j * offset, (ns, members)))
            res, frec = timed_flush(eng, timestamp=92, forward_kind="delta")
            e = res.export
            check(res.stats["forward_kind"] == "delta" == e.kind,
                  f"G3 local {j}: forward kind {res.stats['forward_kind']}")
            check([k.name for k, _v in e.counters]
                  == [f"g.c{i}" for i in range(nc)]
                  and [k.name for k, _r in e.sets]
                  == [f"g.s{i}" for i in range(ns)]
                  and not e.histograms and not e.gauges,
                  f"G3 local {j}: delta export holds {len(e.counters)} "
                  f"counters, {len(e.sets)} sets, {len(e.histograms)} "
                  f"histograms, {len(e.gauges)} gauges")
            data, srec = _serialize(res, "lossless")
            payloads.append((data, e))
            rec["locals"].append({**frec, **srec})
        return payloads

    sent = counted("G3 locals", delta_step)
    with LandingProbe(glob, device) as probe:
        rec["import"] = counted("G3 import", lambda: _import_all(
            glob, [d for d, _e in sent], 100))
        res, rec["flush"] = counted(
            "G3 flush", lambda: timed_flush(glob, timestamp=93))
    check(not probe.records, "G3: a delta without digests landed some")
    exported = {f"g.s{i}": [e.sets[i][1] for _d, e in sent]
                for i in range(ns)}
    rec["worst"] = check_global(
        res, glob, probe.set_bank, np.zeros((0, 1), np.float32), None,
        {f"g.c{i}": float(n_loc * (n_loc + 1) // 2) for i in range(nc)},
        {}, exported, members + (n_loc - 1) * offset, "G3")
    out["steps"]["G3"] = rec

    # G4: req+ull locals into a req+ull global: the direct landing and
    # the ULL row join
    pair = {"histogram_backend": "req", "set_backend": "ull"}
    nr = plan["req_locals"]
    nt, per = plan["req_timers"]
    timers = rng.lognormal(3, 1, (nt, per)).astype(np.float32)
    ns, members, offset = plan["req_sets"]
    rec = {"locals": []}
    rlocs = counted("G4 construction", lambda: [
        make(forward_enabled=True, **pair) for _ in range(nr)]
        + [make(is_global=True, **pair)])
    rglob = rlocs.pop()

    def req_step():
        payloads, exports = [], []
        for j, eng in enumerate(rlocs):
            cols = np.array_split(np.arange(per), nr)[j]
            ts = np.repeat(_slots(eng.histo_keys,
                                  [f"g.t{i}" for i in range(nt)], "timer",
                                  MIXED_SCOPE), len(cols))
            _feed_histos(eng, ts, timers[:, cols].reshape(-1),
                         eng.cfg.batch_size)
            _ingest_sets(eng, _slots(eng.set_keys,
                                     [f"g.s{i}" for i in range(ns)], "set",
                                     MIXED_SCOPE), np.arange(ns),
                         np.broadcast_to(np.arange(members) + j * offset,
                                         (ns, members)))
            res, frec = timed_flush(eng, timestamp=94)
            data, srec = _serialize(res, "lossless")
            payloads.append(data)
            exports.append(res.export)
            rec["locals"].append({**frec, **srec})
        return payloads, exports

    payloads, exports = counted("G4 locals", req_step)
    with LandingProbe(rglob, device) as probe:
        rec["import"] = counted("G4 import",
                                lambda: _import_all(rglob, payloads, 1))
        res, rec["flush"] = counted(
            "G4 flush", lambda: timed_flush(rglob, timestamp=95))
    rec["landings"] = probe.records
    rec["landings_at_import"] = 0
    exported = {f"g.s{i}": [e.sets[i][1] for e in exports]
                for i in range(ns)}
    rec["worst"] = check_global(res, rglob, probe.set_bank, timers, None,
                                {}, {}, exported,
                                members + (nr - 1) * offset, "G4")
    out["steps"]["G4"] = rec

    out["launches_by_step"] = launches
    out["launches"] = {k: sum(step[k] for step in launches.values())
                       for k in kernels.launches}
    print(f"global launches: {json.dumps(launches)}")
    if device.type == "cuda":
        check(launches == GLOBAL_LAUNCHES,
              f"global launches {launches}, predicted {GLOBAL_LAUNCHES}")
    print(f"global: {json.dumps(out)}")
    return out


# ------------------------------------------------------------- phase 10

# a port fleet on the card: each local's traffic an interval. Timers:
# `timers` keys x samples an interval, the sample columns split four
# ways, one shard a local; global-only counters (keys, samples) and
# gauges; mixed sets (keys, members a local, offset between the gRPC
# locals: local j sends members j*offset ... j*offset + members - 1, a
# union); local-only timers (keys, samples); the hot timer's samples a
# local. In intervals 2 and 3 the locals touch `touch` of their counters
# and sets, and everything else as in interval 1.
FLEET_PLAN = {"timers": (5000, 25), "counters": (2000, 4), "gauges": 2000,
              "sets": (500, 200, 100), "local_timers": (50, 25),
              "hot": 200, "touch": 0.1}
FLEET_INTERVALS = 3
FLEET_GRPC_LOCALS = 3
# the HTTP local's egress schedule, one an interval (utils/faults.py
# steps; the last step of each repeats): seeded ack losses, 503s,
# refusals, timeouts and slow sends, each chunk delivered within its
# interval by the retry ladder (max_attempts 8); in interval 2 chunk 1
# is applied and its ack lost, then times out to the end of its ladder:
# a partial delivery whose tail (chunk 1 again, and chunk 2) replays in
# interval 3 under its original ids, where the global drops chunk 1.
FLEET_RETRY_ATTEMPTS = 8
# gRPC chunks: grpc's default 4 MiB receive limit holds 200 metrics of
# 16 KiB HLL rows (GrpcForwarder chunks by metric count, 10,000 by
# default)
FLEET_GRPC_BATCH = 200


def fleet_schedules():
    from veneur_tpu_torch.utils.faults import seeded_schedule
    return (seeded_schedule(1001, FLEET_RETRY_ATTEMPTS, p_fail=0.6,
                            ambiguous=True),
            ["ok", "ack_lost", "timeout"],
            seeded_schedule(1003, FLEET_RETRY_ATTEMPTS, p_fail=0.6,
                            ambiguous=True))


# phase 10's launches, predicted from the code before the first chip run
# (PERF.md section 6). Construction: six engines (2 globals, 4 locals),
# a probe each. Ingest: none (no slot takes more than 200 < B samples an
# interval). A local's flush: the incremental work set, a compress and
# an hll_stats, and in its first flush one each more for the baseline
# rows. A global lands its staged digests every 8192, two compresses a
# landing (C = B = 256): the timer names are chosen so the ring homes
# 2500 of them on each global and the hot timer on global 1, so global 1
# stages 3 x 2501 + 5001 (the HTTP local) = 12504 digests an interval and
# global 2 3 x 2500 = 7500; the HTTP local's delivery delays only
# counters and gauges, so both streams, and their landings, are the same
# in the zero-fault rerun. Cumulative: global 1 lands at 8192 (R1),
# 16384 and 24576 (R2), 32768 (R3); global 2 at 8192 (R2) and 16384
# (R3). Each global's one flush: the remainder's landing (2), the
# baseline and the work set (1 + 1), hll_stats 2.
FLEET_LAUNCHES = {
    "construction": {"compress": 0, "hll_stats": 0, "ull_insert": 0,
                     "probe": 6},
    "R1 ingest": {"compress": 0, "hll_stats": 0, "ull_insert": 0,
                  "probe": 0},
    "R1 forward": {"compress": 10, "hll_stats": 8, "ull_insert": 0,
                   "probe": 0},
    "R2 ingest": {"compress": 0, "hll_stats": 0, "ull_insert": 0,
                  "probe": 0},
    "R2 forward": {"compress": 10, "hll_stats": 4, "ull_insert": 0,
                   "probe": 0},
    "R3 ingest": {"compress": 0, "hll_stats": 0, "ull_insert": 0,
                  "probe": 0},
    "R3 forward": {"compress": 8, "hll_stats": 4, "ull_insert": 0,
                   "probe": 0},
    "global flush": {"compress": 8, "hll_stats": 4, "ull_insert": 0,
                     "probe": 0},
    "rerun construction": {"compress": 0, "hll_stats": 0,
                           "ull_insert": 0, "probe": 2},
    "rerun R1": {"compress": 2, "hll_stats": 0, "ull_insert": 0,
                 "probe": 0},
    "rerun R2": {"compress": 6, "hll_stats": 0, "ull_insert": 0,
                 "probe": 0},
    "rerun R3": {"compress": 4, "hll_stats": 0, "ull_insert": 0,
                 "probe": 0},
    "rerun flush": {"compress": 8, "hll_stats": 4, "ull_insert": 0,
                    "probe": 0},
}


class _RoundTransport:
    """Mutable slot: each interval installs its scripted schedule on the
    HTTP local's one Egress."""

    def __init__(self):
        self.current = None

    def __call__(self, req, timeout=None):
        return self.current(req, timeout=timeout)


class _RecordingForwarder:
    """Stands between a local Server and its ResilientForwarder: keeps a
    copy of each interval's export as the server hands it over (for the
    zero-fault rerun and the delta checks) and the time of each call;
    everything else is the ResilientForwarder's."""

    def __init__(self, rf):
        self.rf = rf
        self.exports = []
        self.calls = []

    def __call__(self, export):
        from veneur_tpu_torch.models.pipeline import ForwardExport
        self.exports.append(ForwardExport(
            histograms=list(export.histograms), sets=list(export.sets),
            counters=list(export.counters), gauges=list(export.gauges),
            set_engine=export.set_engine, kind=export.kind))
        t0 = time.perf_counter()
        try:
            return self.rf(export)
        finally:
            self.calls.append((t0, time.perf_counter()))

    def __getattr__(self, name):
        return getattr(self.rf, name)


def fleet_names(ring, dests, plan):
    """The gRPC locals' timer names, 2500 (half) homed on each global by
    the proxy's ring, and the hot timer's, homed on global 1 (the HTTP
    local, which bypasses the proxy, sends it there too)."""
    nt = plan["timers"][0]
    per = {d: [] for d in dests}
    i = 0
    while min(len(v) for v in per.values()) < nt // 2:
        name = f"g.t{i}"
        owner = ring.get(f"{name}timer".encode())
        if len(per[owner]) < nt // 2:
            per[owner].append(name)
        i += 1
    i = 0
    while ring.get(f"g.hot{i}timer".encode()) != dests[0]:
        i += 1
    return {"g": per[dests[0]] + per[dests[1]],
            "h": [f"h.t{i}" for i in range(nt)], "hot": f"g.hot{i}"}


def fleet_lines(rng, plan, names, j, r):
    """Local j's DogStatsD lines of interval r, shuffled (j ==
    FLEET_GRPC_LOCALS is the HTTP local, the `h.` keys)."""
    http = j == FLEET_GRPC_LOCALS
    pre = "h" if http else "g"
    timers = names[pre]
    per = plan["timers"][1]
    cols = len(np.array_split(np.arange(per), FLEET_GRPC_LOCALS + 1)[j])
    vals = rng.lognormal(3, 1, (len(timers), cols))
    lines = [f"{n}:{v:.4f}|ms" for n, row in zip(timers, vals) for v in row]
    nc, cper = plan["counters"]
    touch = plan["touch"]
    for i in range(nc if r == 0 else round(nc * touch)):
        lines += [f"{pre}.c{i}:{v}|c|#veneurglobalonly"
                  for v in rng.integers(1, 100, cper)]
    lines += [f"{pre}.g{i}:{v:.3f}|g|#veneurglobalonly"
              for i, v in enumerate(rng.normal(0, 100, plan["gauges"]))]
    ns, members, offset = plan["sets"]
    first = 0 if http else j * offset
    for i in range(ns if r == 0 else round(ns * touch)):
        lines += [f"{pre}.s{i}:u{m}|s"
                  for m in range(first, first + members)]
    nl, lper = plan["local_timers"]
    lines += [f"{pre}.l{i}:{v:.4f}|ms|#veneurlocalonly"
              for i in range(nl) for v in rng.lognormal(2, 1, lper)]
    lines += [f"{names['hot']}:{v:.4f}|ms"
              for v in rng.lognormal(4, 0.5, plan["hot"])]
    return [lines[i].encode() for i in rng.permutation(len(lines))]


def http_body_bound(plan):
    """The HTTP local's jsonmetric-v1 chunk size: interval 2's export
    (every timer and the hot key, the touched sets, then counters and
    gauges) splits so chunks 0 and 1 hold every digest and set row and
    chunk 2 only counters and gauges — so its tail, delivered an
    interval late, moves no digest."""
    nt = plan["timers"][0]
    sets = round(plan["sets"][0] * plan["touch"])
    return -(-(nt + 1 + sets) // 2)


def fleet_truth(lines_by_local):
    """The forwarded union's truth (local-only timers left out)."""
    from veneur_tpu_torch.ingest.parser import parse_packet
    truth = Truth()
    for lines in lines_by_local:
        for ln in lines:
            if b"veneurlocalonly" not in ln:
                truth.add_parsed(parse_packet(ln))
    return truth


def _split_truth(truth, owner_of):
    """One Truth a global, by each key's owner."""
    out = [Truth(), Truth()]
    for kind in ("histo", "counter", "gauge", "sets"):
        for key, v in getattr(truth, kind).items():
            getattr(out[owner_of(key[0])], kind)[key] = v
    return out


def _fleet_global(device, cfg_kw, registry):
    from veneur_tpu_torch.cluster.importsrv import DedupeLedger
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.basic import CaptureMetricSink
    cfg = Config(statsd_listen_addresses=[], interval="3600s",
                 hostname="global", grpc_listen_addresses=["127.0.0.1:0"],
                 http_address="127.0.0.1:0", num_workers=1,
                 **(cfg_kw or {}))
    srv = Server(cfg, sinks=[CaptureMetricSink()], device=device)
    # a ledger of its own registry: the duplicates this run drops
    srv.dedupe_ledger = DedupeLedger(registry=registry)
    return srv


def _counting_submit(srv, counts):
    real = srv._submit_import

    def submit(digest, item):
        counts[id(srv)] = counts.get(id(srv), 0) + 1
        real(digest, item)
    srv._submit_import = submit


def _fleet_rows(frameset):
    return [m for m in frameset if not m.name.startswith("veneur.")]


def phase_fleet(device, cfg_kw=None, plan=None):
    """A port fleet on `device`: two port globals (gRPC and HTTP import
    listeners, one worker each), a port ProxyServer ringing both, three
    port locals over UDP forwarding over gRPC to the proxy and one
    forwarding over HTTP straight to global 1's /import through a
    scripted egress whose deliveries are real POSTs; three intervals
    ticked by hand, the globals flushed once at the end. Checked: every
    key on the one global its ring names (the HTTP local's on global 1),
    the globals' rows against numpy truth over the union, the locals'
    own rows, the exports' kinds (full, delta, full resync), the ledger's
    dropped duplicates, no pending spill, every row of both globals bit
    for bit equal to a zero-fault rerun of the same forwards (the
    recorded exports through fresh forwarders, proxy and globals), and,
    on the card, the launches of each step against FLEET_LAUNCHES.
    `cfg_kw` and `plan` override the widths and the traffic (CPU
    rehearsals at small shapes)."""
    import random

    from veneur_tpu_torch import kernels, observe
    from veneur_tpu_torch.cluster import wire
    from veneur_tpu_torch.cluster.discovery import StaticDiscoverer
    from veneur_tpu_torch.cluster.forward import (GrpcForwarder,
                                                  HttpJsonForwarder)
    from veneur_tpu_torch.cluster.proxy import ProxyServer
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.resilience import (BreakerPolicy, Egress,
                                             EgressPolicy,
                                             ResilienceRegistry,
                                             ResilientForwarder,
                                             RetryPolicy)
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.basic import CaptureMetricSink
    from veneur_tpu_torch.utils.faults import FakeClock, ScriptedTransport
    plan = plan or FLEET_PLAN
    rng = np.random.default_rng(23)
    launches, out = {}, {"rounds": []}

    def counted(label, fn):
        before = dict(kernels.launches)
        r = fn()
        step = launches.setdefault(label, dict.fromkeys(kernels.launches, 0))
        for k, n in kernels.launches.items():
            step[k] += n - before[k]
        return r

    reg = ResilienceRegistry()
    kernels.reset_launches()
    globs, loc_srvs = [], []
    proxy = None
    imported = {}
    try:
        globs = counted("construction", lambda: [
            _fleet_global(device, cfg_kw, reg) for _ in range(2)])
        for g in globs:
            _counting_submit(g, imported)
            g.start()
        dests = [f"127.0.0.1:{g.grpc_port}" for g in globs]
        proxy = ProxyServer(StaticDiscoverer(dests),
                            refresh_interval_s=3600)
        route = {"ms": 0.0, "metrics": 0}
        real_route = proxy.route_metrics

        def timed_route(metrics):
            t0 = time.perf_counter()
            try:
                return real_route(metrics)
            finally:
                route["ms"] += (time.perf_counter() - t0) * 1e3
                route["metrics"] += len(metrics)
        proxy.route_metrics = timed_route
        _server, proxy_port = proxy.start("127.0.0.1:0")
        base = dict(statsd_listen_addresses=["udp://127.0.0.1:0"],
                    interval="3600s", num_workers=1, num_readers=1,
                    forward_full_resync_intervals=2, **(cfg_kw or {}))
        loc_srvs = counted("construction", lambda: [
            Server(Config(hostname=f"local{j}",
                          forward_address=f"127.0.0.1:{proxy_port}", **base),
                   sinks=[CaptureMetricSink()], device=device)
            for j in range(FLEET_GRPC_LOCALS)] + [
            Server(Config(hostname="local-http",
                          forward_address="http://127.0.0.1:"
                                          f"{globs[0].http_api.port}",
                          forward_use_grpc=False,
                          flush_max_per_body=http_body_bound(plan), **base),
                   sinks=[CaptureMetricSink()], device=device)])
        for loc in loc_srvs[:FLEET_GRPC_LOCALS]:
            loc.forwarder.inner.max_per_batch = FLEET_GRPC_BATCH
        # the HTTP local's egress: the scripted schedule of the interval,
        # its deliveries real POSTs, its backoff on an injected clock
        clock = FakeClock()
        rt = _RoundTransport()
        http_loc = loc_srvs[FLEET_GRPC_LOCALS]
        http_loc.forwarder.inner._egress = Egress(
            "fleet-http", transport=rt, clock=clock, sleep=clock.sleep,
            rng=random.Random(42), policy=EgressPolicy(
                retry=RetryPolicy(max_attempts=FLEET_RETRY_ATTEMPTS,
                                  base_backoff_s=0.001, max_backoff_s=0.002,
                                  deadline_s=1000.0),
                breaker=BreakerPolicy(failure_threshold=10_000)))
        # each ladder behind a recorder
        for loc in loc_srvs:
            loc.forwarder = _RecordingForwarder(loc.forwarder)
            loc.start()
        names = fleet_names(proxy.ring, dests, plan)

        def deliver(req):
            import urllib.request
            return urllib.request.urlopen(req, timeout=60)

        # the patched hooks time export_to_metrics (gRPC locals) and the
        # JSON body build (the HTTP local) inside each local's forward
        enc = {"ms": 0.0}
        real_e2m = wire.export_to_metrics

        def timed_e2m(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real_e2m(*a, **kw)
            finally:
                enc["ms"] += (time.perf_counter() - t0) * 1e3
        wire.export_to_metrics = timed_e2m
        real_body = http_loc.forwarder.inner._body_entries

        def timed_body(export):
            t0 = time.perf_counter()
            try:
                return real_body(export)
            finally:
                enc["ms"] += (time.perf_counter() - t0) * 1e3
        http_loc.forwarder.inner._body_entries = timed_body

        schedules = fleet_schedules()
        all_lines = [[] for _ in loc_srvs]
        probes = [LandingProbe(g.engines[0], device) for g in globs]
        for p in probes:
            p.__enter__()
        try:
            for r in range(FLEET_INTERVALS):
                lines = [fleet_lines(rng, plan, names, j, r)
                         for j in range(len(loc_srvs))]
                for j, ls in enumerate(lines):
                    all_lines[j].extend(ls)
                dgrams = [pack_datagrams(ls, loc.cfg.metric_max_length)
                          for ls, loc in zip(lines, loc_srvs)]

                def ingest():
                    t0 = time.perf_counter()
                    for loc, dg in zip(loc_srvs, dgrams):
                        send_paced(loc, dg)
                        check(loc.drain(timeout=120), "drain() timed out")
                        check(loc.queue_drops == 0 and loc.parse_errors == 0,
                              f"fleet {loc.hostname}: {loc.queue_drops} "
                              f"lines dropped, {loc.parse_errors} bad")
                    return time.perf_counter() - t0

                rec = {"ingest_s": counted(f"R{r + 1} ingest", ingest),
                       "lines": sum(len(ls) for ls in lines),
                       "datagrams": sum(len(d) for d in dgrams)}
                rt.current = ScriptedTransport(schedules[r], clock,
                                               deliver=deliver)
                before = dict(imported)
                flushes = []

                def forward():
                    for j, loc in enumerate(loc_srvs):
                        enc["ms"] = 0.0
                        with GcPauses() as gcp:
                            t0 = time.perf_counter()
                            loc.flush_once(timestamp=3000 + 10 * r)
                            wall = (time.perf_counter() - t0) * 1e3
                        tick = loc.flight.debug_state()["tick_count"]
                        flushes.append({
                            "local": j, "wall_ms": wall, "gc_ms": gcp.ms,
                            "engine_ms": tick_phase_ms(loc, tick, "engine"),
                            "forward_ms": tick_phase_ms(loc, tick,
                                                        "forward"),
                            "encode_ms": enc["ms"],
                            "kind": loc.forwarder.exports[-1].kind})
                    for g in globs:
                        check(g.drain(timeout=300), "global drain() timed "
                                                    "out")
                    return time.perf_counter()

                t_end = counted(f"R{r + 1} forward", forward)
                t_first = min(loc.forwarder.calls[-1][0]
                              for loc in loc_srvs)
                rec["locals"] = flushes
                rec["import_s"] = t_end - t_first
                rec["imported"] = [imported.get(id(g), 0)
                                   - before.get(id(g), 0) for g in globs]
                out["rounds"].append(rec)
            flush_out = []

            def flush_globals():
                for g in globs:
                    with GcPauses() as gcp:
                        t0 = time.perf_counter()
                        fs = g.flush_once(timestamp=4000)
                        wall = (time.perf_counter() - t0) * 1e3
                    rows = {m.name: m for m in fs}
                    flush_out.append({
                        "frameset": fs, "wall_ms": wall, "gc_ms": gcp.ms,
                        **{k: rows[f"veneur.flush.{k}_duration_ns"].value
                           / 1e6 for k in ("total", "swap", "merge",
                                           "assembly")}})

            counted("global flush", flush_globals)
        finally:
            for p in reversed(probes):
                p.__exit__(None, None, None)
            wire.export_to_metrics = real_e2m
        out["landings"] = [p.records for p in probes]
        out["globals"] = [{k: v for k, v in f.items() if k != "frameset"}
                          for f in flush_out]
        out["proxy_route_ms_per_1000"] = (route["ms"]
                                          / max(route["metrics"], 1) * 1e3)
        out["proxy_metrics"] = route["metrics"]

        for loc in loc_srvs:
            check(loc.sinks[0].wait_for_flush(FLEET_INTERVALS, timeout=120),
                  "fleet: a local's sink missed a flush")
            for t in list(loc._sink_inflight.values()):
                t.join(120)
        # -- checks: ring routing and truth
        owner = {}
        for n in names["g"] + [names["hot"]]:
            owner[n] = dests.index(proxy.ring.get(f"{n}timer".encode()))

        def owner_of(name):
            if name.startswith("h.") or name == names["hot"]:
                return 0
            if name in owner:
                return owner[name]
            mtype = {"c": "counter", "g": "gauge", "s": "set"}[
                name.split(".")[1][0]]
            return dests.index(proxy.ring.get(f"{name}{mtype}".encode()))

        truths = _split_truth(fleet_truth(all_lines), owner_of)
        out["worst"] = []
        for i, (g, f) in enumerate(zip(globs, flush_out)):
            data = _fleet_rows(f["frameset"])
            res = types.SimpleNamespace(metrics=data, frame=data)
            out["worst"].append(check_against_truth(
                res, truths[i], g.engines[0], f"fleet global {i + 1}"))
        # the locals' own rows: mixed timers their aggregates only,
        # local-only timers in full
        for j, loc in enumerate(loc_srvs):
            pre = "h" if j == FLEET_GRPC_LOCALS else "g"
            rows = {m.name for fl in loc.sinks[0].flushes for m in fl}
            t0 = names[pre][0]
            check(f"{t0}.count" in rows and f"{t0}.max" in rows
                  and f"{t0}.50percentile" not in rows,
                  f"fleet local {j}: mixed timer rows")
            check(f"{pre}.l0.50percentile" in rows,
                  f"fleet local {j}: local-only timer not flushed in full")
            check(not any(n.startswith((f"{pre}.c", f"{pre}.s"))
                          for n in rows),
                  f"fleet local {j}: a global-only or mixed set row")
        # the exports' kinds and the delta's keys
        nc, ns = plan["counters"][0], plan["sets"][0]
        touched_c = round(nc * plan["touch"])
        touched_s = round(ns * plan["touch"])
        for j, loc in enumerate(loc_srvs):
            ex = loc.forwarder.exports
            check([e.kind for e in ex] == ["full", "delta", "full"],
                  f"fleet local {j}: export kinds {[e.kind for e in ex]}")
            check(len(ex[1].counters) == touched_c
                  and len(ex[1].sets) == touched_s,
                  f"fleet local {j}: delta shipped {len(ex[1].counters)} "
                  f"counters and {len(ex[1].sets)} sets")
            check(len(ex[2].counters) == nc and len(ex[2].sets) == ns,
                  f"fleet local {j}: the resync shipped "
                  f"{len(ex[2].counters)} counters, {len(ex[2].sets)} sets")
            check(loc.forwarder.pending_spill == 0,
                  f"fleet local {j}: {loc.forwarder.pending_spill} "
                  "sketches pending")
        dups = reg.peek("import", "forward.duplicates_dropped")
        out["duplicates_dropped"] = dups
        check(dups > 0, "fleet: the dedupe ledger dropped no duplicate")
        status, body = http_get(globs[0].http_api.port, "/debug/fleet")
        fleet = json.loads(body)
        check(status == 200 and fleet["import_recorder"] is not None,
              "fleet: /debug/fleet has no import recorder")
        sender = http_loc.forwarder.sender_id
        check(fleet["senders"].get(sender, {}).get("dedupe_watermark", 0)
              > 0, f"fleet: no watermark for the HTTP local {sender}")
        out["rows"] = [len(_fleet_rows(f["frameset"])) for f in flush_out]
        faulty = [sorted((m.name, tuple(m.tags), str(m.type), m.value)
                         for m in _fleet_rows(f["frameset"]))
                  for f in flush_out]
        exports = [loc.forwarder.exports for loc in loc_srvs]
    finally:
        t0 = time.monotonic()
        for s in loc_srvs:
            s.stop()
        if proxy is not None:
            proxy.stop()
        for g in globs:
            g.stop()
        out["stop_s"] = time.monotonic() - t0

    # -- the zero-fault rerun: the recorded exports, in the same order,
    # through fresh forwarders, a fresh proxy (ringed on the first run's
    # destinations, so each key goes where it went) and fresh globals
    reg2 = ResilienceRegistry()
    globs2 = counted("rerun construction",
                     lambda: [_fleet_global(device, cfg_kw, reg2)
                              for _ in range(2)])
    proxy2 = None
    rfs = []
    try:
        for g in globs2:
            g.start()
        addr = {d: f"127.0.0.1:{g.grpc_port}" for d, g in zip(dests, globs2)}
        proxy2 = ProxyServer(StaticDiscoverer(dests),
                             refresh_interval_s=3600,
                             forwarder_factory=lambda d: GrpcForwarder(
                                 addr[d]))
        _s2, port2 = proxy2.start("127.0.0.1:0")
        for j in range(FLEET_GRPC_LOCALS):
            rfs.append(ResilientForwarder(GrpcForwarder(
                f"127.0.0.1:{port2}", max_per_batch=FLEET_GRPC_BATCH,
                engine_stamp=loc_srvs[j].engine_stamp),
                destination=f"rerun-{j}"))
        rfs.append(ResilientForwarder(HttpJsonForwarder(
            f"http://127.0.0.1:{globs2[0].http_api.port}",
            max_per_body=http_body_bound(plan),
            engine_stamp=http_loc.engine_stamp), destination="rerun-http"))
        for r in range(FLEET_INTERVALS):
            def replay(r=r):
                for rf, ex in zip(rfs, exports):
                    rf(ex[r])
                for g in globs2:
                    check(g.drain(timeout=300), "rerun drain() timed out")
            counted(f"rerun R{r + 1}", replay)
        oracle = []

        def flush_rerun():
            for g in globs2:
                oracle.append(sorted(
                    (m.name, tuple(m.tags), str(m.type), m.value)
                    for m in _fleet_rows(g.flush_once(timestamp=4000))))
        counted("rerun flush", flush_rerun)
        check(reg2.peek("import", "forward.duplicates_dropped") == 0,
              "fleet rerun: a duplicate without a fault")
        for i in range(2):
            check(faulty[i] == oracle[i],
                  f"fleet global {i + 1}: {len(faulty[i])} rows, not bit "
                  f"for bit the zero-fault rerun's {len(oracle[i])}")
    finally:
        for rf in rfs:
            rf.close()
        if proxy2 is not None:
            proxy2.stop()
        for g in globs2:
            g.stop()
    check(out["stop_s"] < 30.0, f"fleet stop took {out['stop_s']:.1f} s")
    out["launches_by_step"] = launches
    out["launches"] = {k: sum(step[k] for step in launches.values())
                       for k in kernels.launches}
    print(f"fleet launches: {json.dumps(launches)}")
    if device.type == "cuda":
        check(launches == FLEET_LAUNCHES,
              f"fleet launches {launches}, predicted {FLEET_LAUNCHES}")
    print(f"fleet: {json.dumps(out)}")
    return out


def print_fleet_timings(f, card):
    """Phase 10's times, a line each, with the card."""
    for i, rec in enumerate(f["rounds"]):
        print(f"timing fleet R{i + 1} ingest: {rec['lines']} lines in "
              f"{rec['datagrams']} datagrams to 4 locals in "
              f"{rec['ingest_s']:.3f} s (paced) | {card}")
        for loc in rec["locals"]:
            kind = "JSON body" if loc["local"] == FLEET_GRPC_LOCALS \
                else "export_to_metrics"
            print(f"timing fleet R{i + 1} local {loc['local']} flush "
                  f"({loc['kind']}): {loc['wall_ms']:.2f} ms, engine "
                  f"(export build included) {loc['engine_ms']:.2f} ms, "
                  f"forward {loc['forward_ms']:.2f} ms ({kind} "
                  f"{loc['encode_ms']:.2f} ms), gc {loc['gc_ms']:.2f} ms "
                  f"| {card}")
        for g, n in enumerate(rec["imported"]):
            print(f"timing fleet R{i + 1} global {g + 1}: {n} metrics "
                  f"imported, {n / rec['import_s']:.0f} metrics/s from the "
                  f"first forward to drain() returning "
                  f"({rec['import_s']:.3f} s) | {card}")
    print(f"timing fleet proxy: {f['proxy_metrics']} metrics routed, "
          f"{f['proxy_route_ms_per_1000']:.3f} ms a 1000 | {card}")
    for g, lands in enumerate(f["landings"]):
        for i, land in enumerate(lands):
            each = ", ".join(f"{ms:.2f}" for ms in
                             land["cluster_rows_ms_each"])
            print(f"timing fleet global {g + 1} landing {i}: "
                  f"{land['digests']} digests, cluster_rows "
                  f"{land['cluster_rows_ms']:.2f} ms ({each}) over "
                  f"{land['shapes']}, merge and compress "
                  f"{land['merge_compress_ms']:.2f} ms, wall "
                  f"{land['wall_ms']:.2f} ms | {card}")
    for g, rec in enumerate(f["globals"]):
        print(f"timing fleet global {g + 1} flush: wall "
              f"{rec['wall_ms']:.2f} ms (total {rec['total']:.2f}, swap "
              f"{rec['swap']:.2f}, merge {rec['merge']:.2f}, assembly "
              f"{rec['assembly']:.2f}), gc {rec['gc_ms']:.2f} ms, "
              f"{f['rows'][g]} rows, kernel launches "
              f"{f['launches_by_step']['global flush']} (both) | {card}")


# ------------------------------------------------------------- phase 11

# phase 11: a durable global at the deployment defaults. The four locals
# are phase 9's (GLOBAL_PLAN: 20000 mixed timers x 25 in four column
# shards, 5000 global-only counters x 4, 5000 gauges, 1000 mixed sets x
# 1000 members from j*500, 100 local-only timers, a hot shard of 20000
# samples). Step 1 lands all four exports in a global engine and
# checkpoints it mid-interval; step 2 forwards locals 0-1's exports as
# interval 1 and locals 2-3's as interval 2 over gRPC (chunks of 200:
# grpc's 4 MiB limit, ROADMAP C.10) into the durable global daemon and
# its uncrashed in-process twin; step 3 sends local 0's and local 1's
# exports through a journaled sender killed between send and done; step
# 4 queries step 2's generations.
DURABLE_GRPC_BATCH = 200
# the daemon's flush interval: interval 1's forwards and their landing
# must fit inside incarnation A's first tick, interval 2's between its
# first and second, and the restarted incarnation's queries between its
# first and third ticks (every tick from its second on seals a generation
# of the interner's table, and three are retained)
DURABLE_DAEMON_INTERVAL_S = 15
DURABLE_RETENTION = 3
DURABLE_QUERIES = (("g.t7", "0.5,0.99,count,min,max"),
                   ("g.hot", "0.5,0.99,count,min,max"),
                   ("g.c3", "value"), ("g.s5", "cardinality"))


def _launch_row(compress=0, hll_stats=0, ull_insert=0, probe=0):
    return {"compress": compress, "hll_stats": hll_stats,
            "ull_insert": ull_insert, "probe": probe}


# phase 11's launches, predicted from the code before the first chip run
# (PERF.md section 6). A probe an engine built, scratch and merge engines
# included. A local: its hot shard lands through the hot-slot sidestep
# (one compress), its one flush the baseline rows and the work set (two
# compresses, two hll_stats). A global lands its staged digests every
# 8192, two compresses a landing, and the remainder in its flush, which
# adds the baseline (first flush of an engine only) and the work set; an
# hll_stats each for the baseline and the work set. Step 1: 4 x 20001 =
# 80004 digests, 9 landings at import; both engines flush the same
# remainder. Step 2 an interval: 2 x 20001 = 40002 digests, 4 landings
# at import. The restarted daemon (its own process: read from its
# /debug/flush) lands interval 2 again in its recovery, then flushes.
# Step 3: 20001 + 20001 digests, 2 landings each, in both globals; the
# replayed interval is dropped whole. Step 4, each server: the first
# query restores both generations into scratch engines (the twin
# replays interval 2's ops on its post-flush baseline; the daemon
# restores its post-recovery baseline, landed but for 7234 staged
# digests) and merges the two rows in a merge engine (one landing, the
# baseline, the work set); the later ones reuse the generations and
# build a merge engine each: g.hot as g.t7, the counter an idle flush
# (the baseline only), the set a work set of set rows.
DURABLE_LAUNCHES = {
    "locals": _launch_row(compress=12, hll_stats=8, probe=4),
    "checkpoint construction": _launch_row(probe=1),
    "checkpoint import": _launch_row(compress=18),
    "checkpoint fetch": _launch_row(),
    "restore": _launch_row(probe=1),
    "checkpoint flush": _launch_row(compress=8, hll_stats=4),
    "twin construction": _launch_row(probe=1),
    "twin interval 1": _launch_row(compress=8),
    "twin flush 1": _launch_row(compress=4, hll_stats=2),
    "twin interval 2": _launch_row(compress=8),
    "twin flush 2": _launch_row(compress=3, hll_stats=1),
    "daemon restart to first flush": _launch_row(compress=12,
                                                 hll_stats=2, probe=1),
    "sender kill construction": _launch_row(probe=2),
    "sender kill forwards": _launch_row(compress=16),
    "sender kill flush": _launch_row(compress=8, hll_stats=4),
    "twin queries": _launch_row(compress=35, hll_stats=11, probe=6),
    "daemon queries": _launch_row(compress=27, hll_stats=11, probe=6),
}


def _tenant_rows(frameset):
    """A flush's rows but the veneur.* self-metrics, canonical as the
    flush file writes them (name, tags, type, repr of the value)."""
    return sorted((m.name, ",".join(m.tags), m.type.name.lower(),
                   repr(float(m.value)))
                  for m in frameset if not m.name.startswith("veneur."))


def _file_rows(path):
    """{timestamp: canonical tenant rows} and {name: value} of the
    veneur.* rows, from a LocalFilePlugin flush file."""
    rows, own = {}, {}
    if not os.path.exists(path):
        return rows, own
    with open(path) as f:
        for line in f:
            if not line.endswith("\n"):
                continue
            name, tags, mtype, _host, ts, value, _iv = \
                line.rstrip("\n").split("\t")
            if name.startswith("veneur."):
                own[name] = float(value)
            else:
                rows.setdefault(int(ts), []).append(
                    (name, tags, mtype, repr(float(value))))
    return {ts: sorted(r) for ts, r in rows.items()}, own


def _durable_locals(device, cfg_kw, plan, rng):
    """Phase 9's four default-width locals: one interval each of its
    shard of GLOBAL_PLAN, flushed; returns their exports and the truth
    they were fed."""
    from veneur_tpu_torch.models.pipeline import (AggregationEngine,
                                                  EngineConfig)
    n_loc, hs = plan["locals"], plan["hot_samples"]
    nt, per = plan["timers"]
    timers = rng.lognormal(3, 1, (nt, per)).astype(np.float32)
    hots = rng.lognormal(3, 1, (n_loc, hs)).astype(np.float32)
    shares = [global_interval(rng, plan, j, hots[j]) for j in range(n_loc)]
    exports = []
    for j in range(n_loc):
        eng = AggregationEngine(EngineConfig(forward_enabled=True,
                                             **cfg_kw), device=device)
        feed_global_local(eng, shares[j], timers)
        exports.append(eng.flush(timestamp=90).export)
        del eng
    return exports, {"timers": timers, "hots": hots, "shares": shares,
                     "plan": plan}


def _durable_truth(truth, locs):
    """The samples, counter sums, last gauges and set cardinalities of
    the union of the contiguous locals `locs`' exports."""
    sh = [truth["shares"][j] for j in locs]
    plan = truth["plan"]
    ns, members, offset = plan["sets"]
    cols = np.concatenate([d["timer_cols"] for d in sh])
    return {
        "timers": truth["timers"][:, cols],
        "hot": np.concatenate([truth["hots"][j] for j in locs]),
        "counters": sum(d["counters"].astype(np.float64).sum(axis=1)
                        for d in sh),
        "gauges": sh[-1]["gauges"],
        "set_members": members + (max(locs) - min(locs)) * offset,
    }


def _serialize_export(export):
    from veneur_tpu_torch.cluster import wire
    from veneur_tpu_torch.cluster.protos import forward_pb2
    return forward_pb2.MetricList(
        metrics=wire.export_to_metrics(export)).SerializeToString()


def _durable_checkpoint(device, cfg_kw, exports, tmp, counted, truth):
    """Step 1: a default-width global engine lands the four exports;
    mid-interval (after its landings, with the remainder staged) its
    checkpoint is fetched, encoded, appended to an EngineJournal with its
    sync, loaded, decoded and restored into a fresh engine; both flush,
    every row equal bit for bit."""
    from veneur_tpu_torch.durability import EngineJournal, crc32c
    from veneur_tpu_torch.durability import records as drec
    from veneur_tpu_torch.durability.history import \
        collect_checkpoint_groups
    from veneur_tpu_torch.models.pipeline import (AggregationEngine,
                                                  EngineConfig)

    def make():
        eng = AggregationEngine(EngineConfig(is_global=True, **cfg_kw),
                                device=device)
        eng.enable_dirty_tracking()
        return eng

    glob = counted("checkpoint construction", make)
    payloads = [_serialize_export(e) for e in exports]
    imp = counted("checkpoint import",
                  lambda: _import_all(glob, payloads, 1))
    out = {"import": imp}
    t = {}

    def fetch():
        t0 = time.perf_counter()
        snap = glob.checkpoint_state()
        t["fetch"] = (time.perf_counter() - t0) * 1e3
        return snap
    snap = counted("checkpoint fetch", fetch)
    # the banks fetched as a row gather on the device (the others as
    # whole leaves sliced on the host)
    gathered = [kind for kind, (ids, _l) in snap["banks"].items()
                if 0 < len(ids) < glob._delta_threshold
                * glob._dirty[kind].size]
    t0 = time.perf_counter()
    recs = drec.encode_engine_checkpoint(0, 1, snap)
    t["encode"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for rec_type, payload in recs:
        crc32c(bytes([rec_type]) + payload)
    t["crc32c"] = (time.perf_counter() - t0) * 1e3
    ej = EngineJournal(os.path.join(tmp, "step1"), fsync="always")
    ej.load_records()
    t0 = time.perf_counter()
    nbytes = ej.append_checkpoint(recs)
    ej.sync()
    t["append_sync"] = (time.perf_counter() - t0) * 1e3
    ej.close()
    t0 = time.perf_counter()
    ej2 = EngineJournal(os.path.join(tmp, "step1"), fsync="always")
    loaded = ej2.load_records()
    ej2.close()
    groups, _ops, torn, errors = collect_checkpoint_groups(loaded)
    check(not torn and not errors and list(groups) == [0],
          f"checkpoint reload: groups {list(groups)}, {torn} torn, "
          f"{errors} undecodable")
    g = groups[0]
    _n, wm, gseq, fpr = g["meta"]
    banks = {}
    for payload in g["banks"]:
        _i, kind, ids, leaves = drec.decode_engine_bank(
            payload, leaf_names_of=glob.bank_leaf_names)
        banks[kind] = (ids, leaves)
    t["decode"] = (time.perf_counter() - t0) * 1e3
    rest = counted("restore", make)

    def restore():
        t0 = time.perf_counter()
        rest.restore_checkpoint(fpr, gseq, wm, g["keys"], banks,
                                g["staged"])
        sync(device)
        t["restore"] = (time.perf_counter() - t0) * 1e3
    counted("restore", restore)
    out.update({
        "bytes": nbytes, "records": len(recs),
        "piles_dirty": snap["piles_dirty"],
        "piles_total": snap["piles_total"],
        "staged_digests": len(snap["staged"]["centroids"]),
        "gathered": gathered,
        "ms": t})
    check(out["staged_digests"] > 0 and snap["piles_dirty"] > 0,
          "step 1: the checkpoint holds no landed rows or no staged "
          "digests (not mid-interval)")

    def flush_both():
        return glob.flush(timestamp=91), rest.flush(timestamp=91)
    res_a, res_b = counted("checkpoint flush", flush_both)
    check(canon(res_a) == canon(res_b),
          "step 1: the restored engine's flush is not bit for bit the "
          "original's")
    rows = rows_of(res_a)
    tr = _durable_truth(truth, list(range(len(exports))))
    per = tr["timers"].shape[1]
    for i in range(0, tr["timers"].shape[0], 97):
        v = tr["timers"][i]
        check(rows[(f"g.t{i}.count", ())].value == per
              and rows[(f"g.t{i}.max", ())].value == float(v.max())
              and rows[(f"g.t{i}.min", ())].value == float(v.min()),
              f"step 1: g.t{i} count/min/max")
    for i in range(0, len(tr["counters"]), 97):
        check(rows[(f"g.c{i}", ())].value == tr["counters"][i],
              f"step 1: counter g.c{i}")
    out["rows"] = len(res_a.frame)
    return out


def _durable_server_cfg(srv_kw, **kw):
    from veneur_tpu_torch.config import Config
    return Config(**{**dict(
        statsd_listen_addresses=[], interval="3600s", hostname="durable",
        num_workers=1, is_global=True, flush_phase_timers=False,
        durability_enabled=True,
        history_retention_generations=DURABLE_RETENTION), **srv_kw, **kw})


def _senders(addr, stamp, tag):
    from veneur_tpu_torch.cluster.forward import GrpcForwarder
    from veneur_tpu_torch.resilience import ResilientForwarder
    return [ResilientForwarder(
        GrpcForwarder(addr, max_per_batch=DURABLE_GRPC_BATCH,
                      engine_stamp=stamp),
        destination=f"{tag}-{j}", sender_id=f"durable-local-{j}",
        seq_start=1) for j in range(2)]


def _forward_interval(senders, exports):
    t0 = time.perf_counter()
    for rf, e in zip(senders, exports):
        rf(e)
    return time.perf_counter() - t0


def _hard_kill_in_process(srv):
    """An in-process SIGKILL: the listeners drop at once, no drain, no
    journal close; the journal locks go as a killed process's fds do."""
    from veneur_tpu_torch.utils.faults import kill_journal_lock
    srv._stop.set()
    for g in srv._grpc_servers:
        g.stop(None)
    if srv.http_api is not None:
        srv.http_api.stop()
    kill_journal_lock(srv._engine_journal)
    kill_journal_lock(srv._dedupe_journal)


def _daemon_yaml(path, gport, hport, ddir, flush_file, interval, srv_kw):
    lines = [f'interval: "{interval}s"', "hostname: durable",
             "statsd_listen_addresses: []",
             f'grpc_listen_addresses: ["127.0.0.1:{gport}"]',
             f'http_address: "127.0.0.1:{hport}"', "is_global: true",
             "num_workers: 1", "flush_phase_timers: false",
             "durability_enabled: true", f'durability_dir: "{ddir}"',
             f"history_retention_generations: {DURABLE_RETENTION}",
             f'flush_file: "{flush_file}"']
    lines += [f"{k}: {json.dumps(v)}" for k, v in srv_kw.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


class _Daemon:
    """`python3 -m veneur_tpu_torch.cli.veneur -f <yaml>` in a subprocess
    on the card, its log in a file, its HTTP listener polled."""

    def __init__(self, yaml_path, log_path, hport):
        self.hport = hport
        self.log_path = log_path
        self._log = open(log_path, "w")
        self.t_exec = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.cli.veneur", "-f",
             yaml_path], cwd=ROOT, stdout=self._log,
            stderr=subprocess.STDOUT)

    def tail(self):
        self._log.flush()
        with open(self.log_path) as f:
            return "".join(f.readlines()[-30:])

    def get(self, path):
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.hport}{path}", timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def wait_ready(self, timeout=300):
        """Seconds from exec until GET /ready answers 200."""
        deadline = time.monotonic() + timeout
        while True:
            check(self.proc.poll() is None,
                  f"the daemon exited {self.proc.returncode}: {self.tail()}")
            try:
                if self.get("/ready")[0] == 200:
                    return time.monotonic() - self.t_exec
            except OSError:
                pass
            check(time.monotonic() < deadline,
                  f"the daemon was not ready in {timeout} s: {self.tail()}")
            time.sleep(0.05)

    def debug(self):
        return self.get("/debug/flush")[1]

    def flush_count(self):
        return self.debug()["flush_count"]

    def wait_flushes(self, n, timeout):
        deadline = time.monotonic() + timeout
        while self.flush_count() < n:
            check(self.proc.poll() is None, f"the daemon exited: "
                  f"{self.tail()}")
            check(time.monotonic() < deadline,
                  f"the daemon did not flush {n} times in {timeout} s")
            time.sleep(0.05)

    def queue_empty(self):
        return self.get("/healthz")[1]["checks"]["queues"]["fill"] == 0

    def kill(self):
        import signal
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(30)
        self._log.close()

    def stop(self):
        import signal
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10)
        if not self._log.closed:
            self._log.close()
        return self.proc.returncode


def _query_body(get, metric, q, t1):
    status, body = get(f"/query?metric={metric}&q={q}&t0=0&t1={t1}")
    check(status == 200, f"/query {metric} {q}: {status} {body}")
    return body


def _query_ticks(ticks):
    """Each query tick's wall and its query.* phases, in ms, oldest first
    (the flight recorder's snapshot is newest first)."""
    out = []
    for t in reversed(ticks):
        ph = {p["name"]: p for p in t["phases"]}
        if "query" not in ph:
            continue
        ms = {n[len("query."):] if n != "query" else "wall":
              (p["end_ns"] - p["start_ns"]) / 1e6
              for n, p in ph.items() if p.get("end_ns") is not None}
        out.append(ms)
    return out


def _check_answers(answers, truth, seng, label):
    """Step 4's answers against numpy truth over the window's union of
    samples: count, min, max and the counter exact, the quantiles under
    the t-digest contract (check_percentiles: 1% of the spread of the
    hazen quantiles), the set under set_ok."""
    worst = {"pct_err_over_spread": 0.0}
    for (metric, _q), body in zip(DURABLE_QUERIES, answers):
        res = body["results"]
        check(body["matched_keys"] == 1, f"{label} {metric}: matched "
              f"{body['matched_keys']} keys")
        if metric in ("g.t7", "g.hot"):
            v = truth["timers"][7] if metric == "g.t7" else truth["hot"]
            check(res["count"] == float(v.size)
                  and res["min"] == float(v.min())
                  and res["max"] == float(v.max()),
                  f"{label} {metric}: count/min/max {res}")
            spread = float(v.max()) - float(v.min())
            for q in (0.5, 0.99):
                want = float(np.quantile(v.astype(np.float64), q,
                                         method="hazen"))
                got = res["quantiles"][f"{q * 100:g}"]
                err = abs(got - want) / spread
                worst["pct_err_over_spread"] = max(
                    worst["pct_err_over_spread"], err)
                check(err <= 0.01 + 1e-6, f"{label} {metric} p{q * 100:g}:"
                      f" {got} vs {want} (spread {spread})")
        elif metric == "g.c3":
            check(res["value"] == float(truth["counters"][3]),
                  f"{label} g.c3: {res['value']} vs {truth['counters'][3]}")
        else:
            n = truth["set_members"]
            worst["set_rel_err"] = abs(res["cardinality"] - n) / n
            check(set_ok(res["cardinality"], n, seng),
                  f"{label} g.s5: {res['cardinality']} vs {n}")
    return worst


def _durable_twin_and_daemon(device, srv_kw, exports, truth, tmp, counted,
                             daemon):
    """Steps 2 and 4: the durable global (a daemon on the card, or an
    in-process server for CPU rehearsals) takes interval 1 over gRPC and
    flushes it, takes interval 2, is killed before its flush and
    restarted on the same durability_dir; its flush of the recovered
    interval must be bit for bit its uncrashed twin's. Then both answer
    the same /query requests over the retained generations, within the
    contract of numpy truth and equal to each other, and a live flush
    after the queries holds no row of theirs."""
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.basic import CaptureMetricSink
    out = {}
    intervals = [exports[:2], exports[2:4]]
    twin = counted("twin construction", lambda: Server(_durable_server_cfg(
        srv_kw, grpc_listen_addresses=["127.0.0.1:0"],
        http_address="127.0.0.1:0",
        durability_dir=os.path.join(tmp, "twin")),
        sinks=[CaptureMetricSink()], device=device))
    twin.start()
    twin_rows, twin_send = [], []
    try:
        senders = _senders(f"127.0.0.1:{twin.grpc_port}",
                           twin.engine_stamp, "twin")
        for r, ex in enumerate(intervals):
            def send(ex=ex):
                s = _forward_interval(senders, ex)
                check(twin.drain(timeout=300), "twin drain() timed out")
                return s
            twin_send.append(counted(f"twin interval {r + 1}", send))
            fs = counted(f"twin flush {r + 1}", lambda r=r: twin.flush_once(
                timestamp=100 + 100 * r))
            twin_rows.append(_tenant_rows(fs))
        for rf in senders:
            rf.close()
        out["twin_send_s"] = twin_send
        out["rows"] = [len(r) for r in twin_rows]

        # -- the durable global, killed and restarted
        gport = free_port(socket.SOCK_STREAM)
        hport = free_port(socket.SOCK_STREAM)
        ddir = os.path.join(tmp, "global")
        if daemon:
            got, rec = _daemon_kill_restart(srv_kw, intervals, twin, tmp,
                                            gport, hport, ddir, out,
                                            counted)
        else:
            got, rec = _in_process_kill_restart(device, srv_kw, intervals,
                                                twin, gport, ddir, out,
                                                counted)
        b, get = rec["b"], rec["get"]
        try:
            check(got[0] == twin_rows[0],
                  f"step 2: the daemon's first flush ({len(got[0])} rows) is"
                  f" not bit for bit the twin's ({len(twin_rows[0])})")
            check(got[1] == twin_rows[1],
                  f"step 2: the restarted global's flush ({len(got[1])} "
                  f"rows) is not bit for bit the twin's "
                  f"({len(twin_rows[1])})")
            # -- step 4: /query over the retained generations
            tr = _durable_truth(truth, [0, 1, 2, 3])
            checkpoints = [e.checkpoint_state() for e in twin.engines]

            def ask(getter, t1):
                return [_query_body(getter, m, q, t1)
                        for m, q in DURABLE_QUERIES]

            def twin_get(path):
                return _http_json(twin.http_api.port, path)
            t0 = time.perf_counter()
            twin_ans = counted("twin queries", lambda: ask(twin_get, 200))
            out["twin_query_s"] = time.perf_counter() - t0
            before = b["launches"]()
            t0 = time.perf_counter()
            b_ans = ask(get, b["t1"])
            out["daemon_query_s"] = time.perf_counter() - t0
            b["count"]("daemon queries", before)
            out["worst"] = _check_answers(
                twin_ans, tr, twin.engines[0]._seng, "twin query")
            for (m, q), x, y in zip(DURABLE_QUERIES, twin_ans, b_ans):
                check(x["generations"]["count"] == y["generations"]["count"]
                      == 2, f"step 4: {m}: generations {x['generations']} "
                      f"(twin), {y['generations']} (restarted global)")
                check(x["results"] == y["results"],
                      f"step 4: {m} {q}: the restarted global answers "
                      f"{y['results']}, the twin {x['results']}")
            out["answers"] = [x["results"] for x in twin_ans]
            out["twin_query_ticks"] = _query_ticks(twin.flight.snapshot())
            out["daemon_query_ticks"] = _query_ticks(
                get("/debug/flush")[1]["flight_recorder"]["ticks"])
            # read-path isolation: the live state is the queries' neither
            # before nor after, and the next live flushes carry none of
            # their rows
            after = [e.checkpoint_state() for e in twin.engines]
            check([(c["piles_dirty"], c["last_import_op"], c["interner"])
                   for c in checkpoints]
                  == [(c["piles_dirty"], c["last_import_op"], c["interner"])
                      for c in after],
                  "step 4: the queries changed the twin's live engines")
            check(_tenant_rows(twin.flush_once(timestamp=400)) == [],
                  "step 4: the twin's live flush after the queries holds "
                  "rows")
            check(b["flush_after_queries"]() == [],
                  "step 4: the restarted global's live flush after the "
                  "queries holds rows")
        finally:
            out["daemon_exit"] = b["stop"]()
    finally:
        twin.stop()
    if daemon:
        check(out["daemon_exit"] == 0,
              f"the restarted daemon exited {out['daemon_exit']} on SIGTERM")
    return out


def _http_json(port, path):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _daemon_kill_restart(srv_kw, intervals, twin, tmp, gport, hport, ddir,
                         out, counted):
    """Incarnation A takes interval 1 before its first tick and interval
    2 after it, and is SIGKILLed once interval 2 is acked; B, on the same
    ports and durability_dir, flushes the recovered interval on its first
    tick. Both tick every DURABLE_DAEMON_INTERVAL_S."""
    files = [os.path.join(tmp, f"flush-{x}.tsv") for x in "ab"]
    yamls = [os.path.join(tmp, f"global-{x}.yaml") for x in "ab"]
    for x in range(2):
        _daemon_yaml(yamls[x], gport, hport, ddir, files[x],
                     DURABLE_DAEMON_INTERVAL_S, srv_kw)
    a = _Daemon(yamls[0], os.path.join(tmp, "global-a.log"), hport)
    try:
        out["a_ready_s"] = a.wait_ready()
        senders = _senders(f"127.0.0.1:{gport}", twin.engine_stamp, "a")
        out["a_send_s"] = [_forward_interval(senders, intervals[0])]
        wait_until(a.queue_empty, 120, "daemon A's worker queue to empty")
        time.sleep(1.0)        # the last metric taken off the queue lands
        check(a.flush_count() == 0,
              "daemon A flushed before interval 1 landed: raise "
              "DURABLE_DAEMON_INTERVAL_S")
        a.wait_flushes(1, 3 * DURABLE_DAEMON_INTERVAL_S)
        out["a_send_s"].append(_forward_interval(senders, intervals[1]))
        check(a.flush_count() == 1,
              "daemon A flushed interval 2 before the kill: raise "
              "DURABLE_DAEMON_INTERVAL_S")
        for rf in senders:
            rf.close()
    finally:
        a.kill()
    rows_a, _own = _file_rows(files[0])
    check(len(rows_a) == 1, f"daemon A flushed tenant rows at "
          f"{len(rows_a)} timestamps")
    b = _Daemon(yamls[1], os.path.join(tmp, "global-b.log"), hport)
    try:
        out["restart_ready_s"] = b.wait_ready()
        b.wait_flushes(1, 3 * DURABLE_DAEMON_INTERVAL_S)

        def first_flush():
            rows, _own = _file_rows(files[1])
            return rows
        wait_until(lambda: len(first_flush()) == 1, 60,
                   "daemon B's first flush in its flush file")
        rows_b = first_flush()
        dbg = b.debug()
        rec = dbg["durability"]["engine_checkpoint"]["restore"]
        check(rec["engines_restored"] == 1 and rec["ops_replayed"] >= 1,
              f"daemon B's recovery: {rec}")
        out["recovery"] = rec
        _rows, own = _file_rows(files[1])
        out["engine_restore_ns"] = own["veneur.durability.engine_restore_ns"]
        launched = dbg["sketch_engines"]["kernels"]["launches"]
        counted("daemon restart to first flush", lambda: None,
                external=launched)
    except Exception:
        b.stop()
        raise

    def launches():
        return b.debug()["sketch_engines"]["kernels"]["launches"]

    def count(label, before):
        now = launches()
        counted(label, lambda: None,
                external={k: now[k] - before[k] for k in now})

    def flush_after_queries():
        b.wait_flushes(b.flush_count() + 1, 3 * DURABLE_DAEMON_INTERVAL_S)
        rows, _own = _file_rows(files[1])
        return [r for ts, rs in rows.items() for r in rs
                if ts != min(rows)]

    # the query window ends at B's first flush: generations 1 (A's) and
    # 2 (the recovered interval), none of the later ticks'
    return ([next(iter(rows_a.values())), next(iter(rows_b.values()))],
            {"b": {"launches": launches, "count": count,
                   "flush_after_queries": flush_after_queries,
                   "stop": b.stop, "t1": next(iter(rows_b))},
             "get": b.get})


def _in_process_kill_restart(device, srv_kw, intervals, twin, gport, ddir,
                             out, counted):
    """The CPU rehearsal of the daemon's kill: the same flow with the
    global in-process and the kill simulated (_hard_kill_in_process)."""
    from veneur_tpu_torch import kernels
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.basic import CaptureMetricSink

    def make():
        return Server(_durable_server_cfg(
            srv_kw, grpc_listen_addresses=[f"127.0.0.1:{gport}"],
            http_address="127.0.0.1:0", durability_dir=ddir),
            sinks=[CaptureMetricSink()], device=device)
    a = make()
    a.start()
    senders = _senders(f"127.0.0.1:{gport}", twin.engine_stamp, "a")
    try:
        out["a_send_s"] = [_forward_interval(senders, intervals[0])]
        check(a.drain(timeout=300), "A drain() timed out")
        rows_a = _tenant_rows(a.flush_once(timestamp=100))
        out["a_send_s"].append(_forward_interval(senders, intervals[1]))
        # the killed global's workers end with the process on the card;
        # here they finish their queue first, so that none of their
        # landings overlaps the restarted global's (the journal is the
        # same either way: an op is written ahead when it is taken)
        check(a.drain(timeout=300), "A drain() timed out")
    finally:
        for rf in senders:
            rf.close()
        _hard_kill_in_process(a)
    t0 = time.monotonic()

    def restart():
        srv = make()
        out["recovery"] = srv._recovery
        srv.start()
        out["restart_ready_s"] = time.monotonic() - t0
        return srv, _tenant_rows(srv.flush_once(timestamp=200))
    b, rows_b = counted("daemon restart to first flush", restart)
    out["engine_restore_ns"] = b._recovery["restore_ns"]

    def get(path):
        return _http_json(b.http_api.port, path)

    def count(label, before):
        counted(label, lambda: None, external={
            k: n - before[k] for k, n in kernels.launches.items()})

    def stop():
        b.stop()
        return 0
    return ([rows_a, rows_b],
            {"b": {"launches": lambda: dict(kernels.launches),
                   "count": count,
                   "flush_after_queries": lambda: _tenant_rows(
                       b.flush_once(timestamp=300)),
                   "stop": stop, "t1": 200},
             "get": get})


def _durable_sender_kill(device, srv_kw, exports, tmp, counted):
    """Step 3: a journaled sender forwards local 0's export, then local
    1's, and is killed between the send and its DONE record (the
    scripted kill_after_send); a new sender recovers the interval from
    the journal and replays it under its original envelope, which the
    global's dedupe ledger drops whole. The global's rows are bit for bit
    those of a zero-fault oracle sent the two exports once."""
    from veneur_tpu_torch.cluster.forward import GrpcForwarder
    from veneur_tpu_torch.durability import ForwardJournal
    from veneur_tpu_torch.models.pipeline import ForwardExport
    from veneur_tpu_torch.resilience import (ResilienceRegistry,
                                             ResilientForwarder)
    from veneur_tpu_torch.utils.faults import (ScriptedCallable,
                                               SimulatedKill,
                                               kill_journal_lock)
    regs = [ResilienceRegistry(), ResilienceRegistry()]
    globs = counted("sender kill construction", lambda: [
        _fleet_global(device, {**srv_kw, "flush_phase_timers": False}, r)
        for r in regs])
    out = {}
    try:
        for g in globs:
            g.start()
        jdir = os.path.join(tmp, "sender")
        a_ex, b_ex = exports[0], exports[1]

        def grpc(g):
            return GrpcForwarder(f"127.0.0.1:{g.grpc_port}",
                                 max_per_batch=DURABLE_GRPC_BATCH,
                                 engine_stamp=g.engine_stamp)

        def forwards():
            wire_fwd = grpc(globs[0])
            rf = ResilientForwarder(
                ScriptedCallable(["ok", "kill_after_send"],
                                 on_success=wire_fwd),
                journal=ForwardJournal(jdir, fsync="never"),
                sender_id="durable-sender", seq_start=1,
                destination="kill")
            rf(a_ex)
            try:
                rf(b_ex)
                check(False, "step 3: the scripted kill did not fire")
            except SimulatedKill:
                pass
            kill_journal_lock(rf._journal)
            wire_fwd.close()
            reg = ResilienceRegistry()
            rf2 = ResilientForwarder(
                grpc(globs[0]), journal=ForwardJournal(jdir, fsync="never"),
                sender_id="another", seq_start=1, destination="kill",
                registry=reg)
            out["recovered_intervals"] = reg.peek(
                "kill", "durability.recovered_intervals")
            check(rf2.sender_id == "durable-sender"
                  and out["recovered_intervals"] == 1,
                  f"step 3: recovered {out['recovered_intervals']} "
                  f"interval(s) as {rf2.sender_id}")
            rf2(ForwardExport())
            check(rf2.pending_spill == 0, "step 3: the replay is pending")
            rf2.close()
            oracle = ResilientForwarder(grpc(globs[1]), sender_id="oracle",
                                        seq_start=1, destination="oracle")
            oracle(a_ex)
            oracle(b_ex)
            oracle.close()
            for g in globs:
                check(g.drain(timeout=300), "step 3: drain() timed out")
        counted("sender kill forwards", forwards)
        rows = counted("sender kill flush", lambda: [
            _tenant_rows(g.flush_once(timestamp=500)) for g in globs])
        out["duplicates_dropped"] = regs[0].peek(
            "import", "forward.duplicates_dropped")
        n = sum(len(x) for x in (b_ex.histograms, b_ex.sets, b_ex.counters,
                                 b_ex.gauges))
        check(out["duplicates_dropped"] == -(-n // DURABLE_GRPC_BATCH),
              f"step 3: {out['duplicates_dropped']} duplicate chunks "
              f"dropped, the replay had {-(-n // DURABLE_GRPC_BATCH)}")
        check(regs[1].peek("import", "forward.duplicates_dropped") == 0,
              "step 3: the oracle dropped a duplicate")
        check(rows[0] == rows[1],
              f"step 3: the killed sender's global ({len(rows[0])} rows) "
              f"is not bit for bit the oracle's ({len(rows[1])})")
        out["rows"] = len(rows[0])
    finally:
        for g in globs:
            g.stop()
    return out


def phase_durable(device, cfg_kw=None, srv_kw=None, plan=None,
                  daemon=None):
    """A durable global on `device` at the deployment defaults (phase
    11): the engine checkpoint and restore at full width (step 1), a
    durable global daemon killed with SIGKILL after acking interval 2 and
    restarted (step 2; `daemon=False`, the CPU rehearsals' default, runs
    the global in-process and simulates the kill), a journaled sender
    killed between send and done (step 3), and /query over step 2's
    generations (step 4). The launches of each step against
    DURABLE_LAUNCHES on the card. `cfg_kw`/`srv_kw` (engine and server
    widths) and `plan` override the deployment defaults and traffic."""
    import shutil
    import tempfile

    import torch

    from veneur_tpu_torch import kernels
    plan = plan or GLOBAL_PLAN
    cfg_kw = cfg_kw or {}
    srv_kw = srv_kw or {}
    if daemon is None:
        daemon = device.type == "cuda"
    rng = np.random.default_rng(11)
    launches, out = {}, {}

    def counted(label, fn, external=None):
        before = dict(kernels.launches)
        r = fn()
        step = launches.setdefault(label, dict.fromkeys(kernels.launches, 0))
        for k, n in (external or kernels.launches).items():
            step[k] += n - (0 if external else before[k])
        return r

    kernels.reset_launches()
    tmp = tempfile.mkdtemp(prefix="durable-")
    try:
        exports, truth = counted("locals", lambda: _durable_locals(
            device, cfg_kw, plan, rng))
        out["checkpoint"] = _durable_checkpoint(device, cfg_kw, exports,
                                                tmp, counted, truth)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out["kill_restart"] = _durable_twin_and_daemon(
            device, srv_kw, exports, truth, tmp, counted, daemon)
        out["sender_kill"] = _durable_sender_kill(device, srv_kw, exports,
                                                  tmp, counted)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches_by_step"] = launches
    out["launches"] = {k: sum(step[k] for step in launches.values())
                       for k in kernels.launches}
    print(f"durable launches: {json.dumps(launches)}")
    if device.type == "cuda":
        check(launches == DURABLE_LAUNCHES,
              f"durable launches {launches}, predicted {DURABLE_LAUNCHES}")
    print(f"durable: {json.dumps(out, default=str)}")
    return out


def print_durable_timings(d, card):
    """Phase 11's times, a line each, with the card."""
    c = d["checkpoint"]
    ms = c["ms"]
    print(f"timing durable checkpoint: {c['bytes']} bytes in "
          f"{c['records']} records ({c['piles_dirty']} of "
          f"{c['piles_total']} piles dirty, {c['staged_digests']} staged "
          f"digests; banks gathered on the device {c['gathered']}): fetch "
          f"{ms['fetch']:.2f} ms, encode {ms['encode']:.2f} ms, CRC32C "
          f"{ms['crc32c']:.2f} ms, append with its sync "
          f"{ms['append_sync']:.2f} ms, load and decode {ms['decode']:.2f}"
          f" ms, restore (host compose and copies to the card) "
          f"{ms['restore']:.2f} ms; {c['rows']} rows equal bit for bit "
          f"| {card}")
    k = d["kill_restart"]
    rec = k["recovery"]
    print(f"timing durable kill-restart: interval sends "
          f"{', '.join(f'{s:.2f}' for s in k['a_send_s'])} s to the "
          f"daemon ({', '.join(f'{s:.2f}' for s in k['twin_send_s'])} s "
          f"to the twin); restart from exec to /ready "
          f"{k['restart_ready_s']:.2f} s; veneur.durability."
          f"engine_restore_ns {k['engine_restore_ns']:.0f}; "
          f"{rec['ops_replayed']} ops and {rec['metrics_replayed']} "
          f"metrics replayed; flushes of {k['rows']} rows bit for bit the "
          f"twin's | {card}")
    for who in ("twin", "daemon"):
        ticks = k[f"{who}_query_ticks"]
        for (m, q), t in zip(DURABLE_QUERIES, ticks[-len(DURABLE_QUERIES):]):
            print(f"timing durable query ({who}) {m} q={q}: wall "
                  f"{t.get('wall', 0):.2f} ms, restore "
                  f"{t.get('restore', 0):.2f}, merge {t.get('merge', 0):.2f},"
                  f" estimate {t.get('estimate', 0):.2f} | {card}")
    s = d["sender_kill"]
    print(f"durable sender kill: {s['recovered_intervals']} interval "
          f"recovered, {s['duplicates_dropped']} duplicate chunks dropped, "
          f"{s['rows']} rows bit for bit the oracle's | {card}")


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


def print_global_timings(g, card):
    """Phase 9's times, a line each, with the card."""
    for label, rec in g["steps"].items():
        for j, loc in enumerate(rec["locals"]):
            print(f"timing global {label} local {j}: flush (export build "
                  f"included) {loc['wall_ms']:.2f} ms, swap "
                  f"{loc['swap_ms']:.2f}, merge {loc['merge_ms']:.2f}, "
                  f"assembly {loc['assembly_ms']:.2f}, gc "
                  f"{loc['gc_ms']:.2f}; export_to_metrics "
                  f"{loc['to_metrics_ms']:.2f} ms and serialization "
                  f"{loc['serialize_ms']:.2f} ms for {loc['metrics']} "
                  f"metrics, {loc['bytes']} bytes | {card}")
        hot = rec.get("small_senders")
        if hot:
            print(f"timing global {label} small senders: {hot['n']} "
                  f"ingested, flushed and serialized in {hot['s']:.3f} s; "
                  f"centroids a digest {hot['centroids']} | {card}")
        imp = rec["import"]
        print(f"timing global {label} import: {imp['metrics']} metrics, "
              f"decode {imp['decode_ms']:.2f} ms + import_list "
              f"{imp['import_list_ms']:.2f} ms = {imp['ms_per_1000']:.3f} "
              f"ms per 1000 metrics | {card}")
        for i, land in enumerate(rec.get("landings", [])):
            where = ("import" if i < rec["landings_at_import"]
                     else "flush")
            each = ", ".join(f"{ms:.2f}" for ms in
                             land["cluster_rows_ms_each"])
            how = (f"cluster_rows {land['cluster_rows_ms']:.2f} ms ({each}) "
                   f"over {land['shapes']} (sorted_prefix {land['arms']}), "
                   f"merge and compress {land['merge_compress_ms']:.2f} ms"
                   if land["arms"] else "direct (no cluster_rows)")
            print(f"timing global {label} landing {i} ({where}): "
                  f"{land['digests']} digests, {how}, wall "
                  f"{land['wall_ms']:.2f} ms, compress launches "
                  f"{land['compress']} | {card}")
        f = rec["flush"]
        print(f"timing global {label} flush ({f['path']}): "
              f"{f['wall_ms']:.2f} ms, swap {f['swap_ms']:.2f} ms, merge "
              f"{f['merge_ms']:.2f} ms, assembly {f['assembly_ms']:.2f} ms, "
              f"gc {f['gc_ms']:.2f} ms, {f['rows']} rows, kernel launches "
              f"{g['launches_by_step'][label + ' flush']} | {card}")


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
    server = ph.run("server", phase_server, device)
    cli = ph.run("server cli", phase_server_cli, device)
    ssf_out = ph.run("ssf+overload", phase_ssf_overload, device)
    glob_out = ph.run("global tier", phase_global, device)
    fleet_out = ph.run("fleet", phase_fleet, device)
    durable_out = ph.run("durable", phase_durable, device)
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
    print(f"timing server UDP ingest: {server['datagrams']} datagrams, "
          f"{server['lines']} lines from the first send to drain() "
          f"returning in {server['ingest_s']:.3f} s: "
          f"{server['datagrams_per_s']:.0f} datagrams/s, "
          f"{server['lines_per_s']:.0f} lines/s (a lower bound: the sender "
          f"waits after each burst of {server['burst_bytes']} bytes; "
          f"SO_RCVBUF {server['rcvbuf']}) | {card}")
    for label in ("S1", "S2"):
        f = server[label]
        print(f"timing server flush {label}: total "
              f"{f['total_duration_ns']:.2f} ms, swap "
              f"{f['swap_duration_ns']:.2f} ms, merge "
              f"{f['merge_duration_ns']:.2f} ms, assembly "
              f"{f['assembly_duration_ns']:.2f} ms, gc in flush_once "
              f"{f['gc_ms']:.2f} ms, {f['rows']} rows, "
              f"kernel launches {server['launches_by_step'][label]} | {card}")
    print(f"server cli: python3 -m veneur_tpu_torch.cli.veneur serving "
          f"{cli['start_s']:.2f} s after its start; {cli['datagrams']} "
          f"datagrams flushed to its flush_file; exit {cli['exit_code']} on "
          f"SIGTERM | {card}")
    s8 = ssf_out
    for proto in ("udp", "tcp"):
        print(f"timing ssf {proto.upper()} ingest: {s8[proto + '_spans']} "
              f"spans from the first send to drain() returning in "
              f"{s8[proto + '_s']:.3f} s: {s8[proto + '_spans_per_s']:.0f} "
              f"spans/s, {s8[proto + '_samples_per_s']:.0f} samples/s "
              f"(paced) | {card}")
    print(f"timing ssf+overload storm: {s8['storm_keys']} unique counter "
          f"keys in {s8['storm_datagrams']} datagrams in "
          f"{s8['storm_s']:.3f} s: {s8['storm_datagrams_per_s']:.0f} "
          f"datagrams/s; {s8['folded']} samples folded into "
          f"storm.__other__ | {card}")
    for label in ("T1", "T2"):
        f = s8[label]
        print(f"timing ssf+overload flush {label}: total "
              f"{f['total_duration_ns']:.2f} ms, swap "
              f"{f['swap_duration_ns']:.2f} ms, merge "
              f"{f['merge_duration_ns']:.2f} ms, assembly "
              f"{f['assembly_duration_ns']:.2f} ms, overload phase "
              f"{f['overload_phase_ms']:.4f} ms, gc in flush_once "
              f"{f['gc_ms']:.2f} ms, {f['rows']} rows, kernel launches "
              f"{s8['launches_by_step'][label]}"
              f"{' (under the profiler capture)' if label == 'T1' else ''}"
              f" | {card}")
    print_global_timings(glob_out, card)
    print_fleet_timings(fleet_out, card)
    print_durable_timings(durable_out, card)
    paths = [*main_out.values(), server, ssf_out, glob_out, fleet_out,
             durable_out]
    kernels = []
    for name, source, replaces, phase, timed in KERNELS:
        t = timing[timed]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(out["launches"][name] for out in paths),
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
