"""Build-at-first-use of the CUDA sources and their ctypes binding.

Every `csrc/*.cu` is compiled by its own `nvcc -c`, all started
together, and one `nvcc -shared` links the objects into one library
under `veneur_tpu_torch/_build/` (listed in .gitignore). The library's name
carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one is reused. The C entry points take plain
pointers (`c_void_p`, from `tensor.data_ptr()`), `c_int` sizes and the
CUDA stream (`torch.cuda.current_stream().cuda_stream`), and return
`cudaGetLastError()` after their launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
              "--ptxas-options=-v")

# entry name -> (argtypes, restype)
_P, _I, _D, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, \
    ctypes.c_size_t
ENTRIES = {
    "vt_compress": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _I, _P], _I),
    "vt_compress_smem_bytes": ([_I, _I], _S),
    "vt_hll_stats": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "vt_ull_insert": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "vt_probe": ([_P, _P, _I, _I, _P], _I),
}


class NvccError(RuntimeError):
    pass


def sources() -> list:
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
            for src in sources():
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
    """The loaded library with every entry's argtypes/restype declared;
    builds it on first use."""
    global _lib, last_build
    with _lock:
        if _lib is None:
            last_build = build()
            lib = ctypes.CDLL(last_build[0])
            for name, (argtypes, restype) in ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib
