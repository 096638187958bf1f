#!/usr/bin/env python3
"""Where a row of the compress kernel spends its cycles, on one H100.

Run from the root of a checkout on a machine with one card:

    python3 compress_clocks.py

It copies veneur_tpu_torch/csrc/compress.cu into a build directory
(veneur_tpu_torch/_build/clocks/, git-ignored), adds a `clock64()` stamp
at the start of each row and after every `__syncthreads()` (thread 0
records it, with the source line of the barrier), builds that copy with
the library's nvcc flags and runs it at the serving shape, twice: at
K=132 rows (one row on each SM: the latency of a row alone) and at
K=32768 (eight rows resident on each SM: the latency of a row among its
neighbours). For each stamp it prints the source line of the barrier
that ends the stretch and the mean cycles of the stretch over all rows,
and checks that the stamped kernel is still bit for bit equal to the
plain version. The stamps cost about a tenth of the kernel's time.
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
SLOTS = 48


def instrumented_source(src: str) -> str:
    """compress.cu with a stamp at the start of each row and after each
    barrier: the cycle counter into clocks[row][i], and (row 0 alone, so
    that the rows do not contend for one address) the stamp's source
    line into lines[i]."""
    stamp = ("if (tid == 0 && ci_ < {n}) {{ vt_clk[row * {n} + ci_] = "
             "clock64(); if (row == 0) vt_line[ci_] = {line}; }} ++ci_;")
    out = []
    for no, line in enumerate(src.splitlines(), 1):
        if line.strip() == "__syncthreads();":  # a barrier on its own
            line = line.replace("__syncthreads();", "__syncthreads(); "
                                + stamp.format(n=SLOTS, line=no))
        out.append(line)
        if re.match(r"\s*const float inf = __int_as_float", line):
            out.append("  int ci_ = 0; " + stamp.format(n=SLOTS, line=0))
    head = ("__device__ long long* vt_clk;\n__device__ int vt_line[%d];\n"
            'extern "C" int vt_set_clocks(long long* p) {\n'
            "  return (int)cudaMemcpyToSymbol(vt_clk, &p, sizeof(p));\n}\n"
            'extern "C" int vt_get_lines(int* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, vt_line, "
            "sizeof(vt_line));\n}\n" % SLOTS)
    text = "\n".join(out) + "\n"
    anchor = '#include "device_guard.cuh"\n'
    if anchor not in text or "int ci_ = 0;" not in text:
        raise RuntimeError("compress.cu no longer has the expected anchors")
    return text.replace(anchor, anchor + head, 1)


def build(build_dir: str) -> str:
    from veneur_tpu_torch.kernels import _build
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "compress.cu")) as f:
        src = instrumented_source(f.read())
    with open(os.path.join(build_dir, "compress.cu"), "w") as f:
        f.write(src)
    so = os.path.join(build_dir, "libcompress_clocks.so")
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
         "-shared", "-o", so, os.path.join(build_dir, "compress.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed\n" + proc.stdout)
    return so


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("compress_clocks: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from veneur_tpu_torch.kernels import compress as kc
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    so = build(os.path.join(ROOT, "veneur_tpu_torch", "_build", "clocks"))
    lib = ctypes.CDLL(so)
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.vt_compress.argtypes = [P] * 6 + [I, I, I, D, I, P]
    lib.vt_set_clocks.argtypes = [P]
    lib.vt_get_lines.argtypes = [P]
    K, C, B = cs.SERVE_K, cs.SERVE_C, cs.SERVE_B
    args = cs.compress_inputs(dev, K, C, B)
    pm, pw = kc.compress_plain(*args, 100.0)
    clocks = torch.zeros(K, SLOTS, dtype=torch.int64, device=dev)
    lib.vt_set_clocks(clocks.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for k in (132, K):
        sub = [t[:k].contiguous() for t in args]
        om, ow = torch.empty_like(sub[0]), torch.empty_like(sub[0])

        def run():
            err = lib.vt_compress(*(a.data_ptr() for a in sub),
                                  om.data_ptr(), ow.data_ptr(), k, C, B,
                                  100.0, 0, stream)
            if err:
                raise RuntimeError(f"launch failed with cudaError {err}")

        clocks.zero_()
        ms = cs.time_ms(run, dev, 5)
        same = bool((((om == pm[:k]) | (torch.isnan(om) & torch.isnan(pm[:k])))
                     .all()) and torch.equal(ow, pw[:k]))
        ok &= same
        c = clocks[:k].double().cpu().numpy()
        n = int((c[0] != 0).sum())
        lines = (ctypes.c_int * SLOTS)()
        lib.vt_get_lines(lines)
        stretch = np.diff(c[:, :n], axis=1).mean(axis=0)
        print(json.dumps({
            "K": k, "ms": ms, "bitwise_equal": same,
            "row_cycles": float((c[:, n - 1] - c[:, 0]).mean()),
            "stretches": [[lines[i + 1], round(float(v))]
                          for i, v in enumerate(stretch)]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
