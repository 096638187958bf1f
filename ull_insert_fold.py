#!/usr/bin/env python3
"""The ULL insert kernel against its warp pre-join variant, on one H100.

Run from the root of a checkout on a machine with one card:

    python3 ull_insert_fold.py

It builds veneur_tpu_torch/csrc/ull_insert.cu (the kernel the port
launches: one CAS loop per update) and
veneur_tpu_torch/variants/ull_insert_fold.cu (the variant that folds a
warp's updates on one 32-bit word into one CAS loop a word), each into
its own library under veneur_tpu_torch/_build/fold/ (git-ignored) with
the kernel library's nvcc flags, prints ptxas's register and spill
lines, and runs both through ctypes on the same batches on a [4096,
8192] bank (the req+ull path's set bank):

  random       uniform slots and registers, canonical values;
  serving      chip_smoke.py phase 4's contended batch (25% duplicated
               targets, padding, one register hit 1000 times, the four
               registers of one word);
  one_word     the four registers of one word, conflicting values;
  hot_member   random, with 10% of the updates one (register, value):
               a set member sent over and over;
  interval_a   interval A's bulk set updates as the main path lands
               them: 1000 hashed members a set, in order.

at 8192 (one staged batch) and 131072 (the engine's landing buffer).
For each batch it prints the share of live updates whose warp of 32
consecutive updates holds another live update on the same word (what
the variant folds), whether each kernel leaves every byte of the plain
version, and each kernel's mean device time over ten fresh banks by
torch.profiler, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K, M = 4096, 8192
SIZES = (8192, 131072)
KERNELS = {"per_update": "csrc/ull_insert.cu",
           "fold": "variants/ull_insert_fold.cu"}


def crowded_share(slots, idx, m, total):
    """Share of live updates whose warp (32 consecutive updates) holds
    another live update on the same 32-bit word, under the kernel's
    uint32 flat key."""
    s = np.asarray(slots, np.int64)
    flat = ((s & 0xFFFFFFFF) * m + (np.asarray(idx, np.int64) & 0xFFFFFFFF)) \
        & 0xFFFFFFFF
    live = (s >= 0) & (flat < total)
    if not live.any():
        return 0.0
    word = np.where(live, flat >> 2, -1 - np.arange(len(s)))
    pad = -len(word) % 32
    w = np.concatenate([word, -1 - len(s) - np.arange(pad)]).reshape(-1, 32)
    same = (w[:, :, None] == w[:, None, :]).sum(axis=2) > 1
    return float(same.reshape(-1)[:len(s)][live].mean())


def build(out_dir):
    """Both kernels built at once, each into its own library. Returns
    {name: (path, ptxas lines)}."""
    from veneur_tpu_torch.kernels import _build
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in KERNELS.items():
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-shared", "-o", so, os.path.join(_build.PKG_DIR, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {KERNELS[name]}\n{log}")
        out[name] = (so, [ln.split("info    :")[-1].strip()
                          for ln in log.splitlines()
                          if re.search(r"Used \d+ registers|spill", ln)])
    return out


def batches(device):
    """{label: (registers, slots, idx, vals)} on `device`."""
    import torch
    import chip_smoke as cs
    from veneur_tpu_torch.sketches.ull import ULLEngine

    def t(*a):
        return tuple(torch.as_tensor(x, device=device) for x in a)

    def random(n, seed):
        rng = np.random.default_rng(seed)
        return (rng.integers(0, 256, (K, M), dtype=np.uint8),
                rng.integers(0, K, n).astype(np.int32),
                rng.integers(0, M, n).astype(np.int32),
                (rng.integers(1, 52, n) << 2).astype(np.uint8))

    out = {}
    for n in SIZES:
        out[f"random {n}"] = t(*random(n, 1))
        out[f"serving {n}"] = cs.ull_insert_inputs(device, K, M, n)[:4]
        out[f"one_word {n}"] = cs.one_word_inputs(device, K, M, n)
        regs, slots, idx, vals = random(n, 2)
        hot = np.random.default_rng(3).random(n) < 0.1
        slots[hot], idx[hot], vals[hot] = 7, 1234, 4 * 20
        out[f"hot_member {n}"] = t(regs, slots, idx, vals)
        rng = np.random.default_rng(4)
        h = rng.integers(0, 2 ** 64, n, dtype=np.uint64)
        idx, vals = ULLEngine(precision=13).host_hash_to_updates(h)
        slots = np.repeat(np.arange(-(-n // 1000), dtype=np.int32), 1000)
        out[f"interval_a {n}"] = t(np.zeros((K, M), np.uint8), slots[:n],
                                   idx.astype(np.int32), vals)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ull_insert_fold: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from veneur_tpu_torch.sketches import ull
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    libs = {}
    for name, (so, ptxas) in build(os.path.join(
            ROOT, "veneur_tpu_torch", "_build", "fold")).items():
        print(f"ptxas {name} ({KERNELS[name]}): {'; '.join(ptxas)}")
        lib = ctypes.CDLL(so)
        lib.vt_ull_insert.argtypes = [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        libs[name] = lib
    ok = True
    for label, (regs, slots, idx, vals) in batches(dev).items():
        want = ull.ULLBank(registers=regs.clone())
        ull._insert_impl(want, slots, idx, vals)
        rec = {"batch": label, "crowded_share": crowded_share(
            slots.cpu().numpy(), idx.cpu().numpy(), M, K * M)}
        for name, lib in libs.items():
            def launch(bank, lib=lib):
                err = lib.vt_ull_insert(
                    bank.data_ptr(), slots.data_ptr(), idx.data_ptr(),
                    vals.data_ptr(), slots.shape[0], K, M, dev.index,
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            bank = regs.clone()
            launch(bank)
            torch.cuda.synchronize(dev)
            equal = bool(torch.equal(bank, want.registers))
            ok &= equal
            banks = [regs.clone() for _ in range(10)]
            ms = cs.kernel_device_ms({"ull_insert_kernel": [
                (lambda b=b: launch(b)) for b in banks]}, dev)
            rec[name] = {"device_ms": ms.get("ull_insert_kernel"),
                         "every_byte_equal": equal}
            del banks
        print(json.dumps(rec), f"| {card}", flush=True)
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
