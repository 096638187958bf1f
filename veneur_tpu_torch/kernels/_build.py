"""Build-at-first-use of the CUDA sources and their Python binding.

Every `csrc/*.cu` and the binding `csrc/bindings.cpp` is compiled by its
own `nvcc -c`, all started together, and one `nvcc -shared` links the
objects into one library under `veneur_tpu_torch/_build/` (listed in
.gitignore). The library's name carries a hash of the sources and flags,
so an edited source builds anew and an unchanged one is reused. It is
loaded as the CPython extension module `_veneur_kernels` (needs the
interpreter's C headers, `Python.h`), whose functions are the C entry
points: they take plain pointers (Python ints, from `tensor.data_ptr()`),
sizes, the device index and the raw handle of the current CUDA stream;
each selects that device for its launch (csrc/device_guard.cuh) and
returns `cudaGetLastError()` after it.
"""

from __future__ import annotations

import glob
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
BINDINGS = os.path.join(CSRC_DIR, "bindings.cpp")
MODULE = "_veneur_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
              "--ptxas-options=-v", "-I" + sysconfig.get_paths()["include"])

# entry name -> its positional arguments in csrc/bindings.cpp: p a pointer
# (a Python int), i a C int, d a double
ENTRIES = {
    "vt_compress": "ppppppiiidip",
    "vt_compress_smem_bytes": "ii",
    "vt_compress_blocks_per_sm": "iii",
    "vt_hll_stats": "pppiiip",
    "vt_ull_insert": "ppppiiiip",
    "vt_probe": "ppiip",
}


class NvccError(RuntimeError):
    pass


def sources() -> list:
    """The kernel sources, one a kernel."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libveneur_kernels_{h.hexdigest()[:16]}.so")


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise NvccError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> tuple:
    """Compile the library if it is not built yet. Returns (path,
    seconds spent building, compiler log)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        try:
            for src in sources() + [BINDINGS]:
                obj = os.path.join(tmp, os.path.basename(src) + ".o")
                objs.append(obj)
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            outs = [p.communicate()[0].decode() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        log = "".join(outs)
        if any(p.returncode != 0 for p in procs):
            raise NvccError("nvcc failed\n" + log)
        tmp_so = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_so,
                               *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        log += proc.stdout.decode()
        if proc.returncode != 0:
            raise NvccError("nvcc link failed\n" + log)
        os.replace(tmp_so, path)
    return path, time.monotonic() - t0, log


_lock = threading.Lock()
_lib = None
# (path, seconds spent building, compiler log) of the load in this process
last_build = None


def load():
    """The library as an extension module whose functions are the C
    entries; builds it on first use."""
    global _lib, last_build
    with _lock:
        if _lib is None:
            last_build = build()
            loader = importlib.machinery.ExtensionFileLoader(
                MODULE, last_build[0])
            spec = importlib.util.spec_from_file_location(
                MODULE, last_build[0], loader=loader)
            lib = importlib.util.module_from_spec(spec)
            loader.exec_module(lib)
            _lib = lib
        return _lib
