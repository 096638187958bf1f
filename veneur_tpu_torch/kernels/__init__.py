"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper (compress.fused_compress, hll_stats.hll_stats,
ull_insert.fused_insert, probe.probe_add) takes torch tensors. On a
CUDA tensor it checks device, dtype, shape and
contiguity, launches its kernel on the current stream and adds one to
its entry in `launches` (through `count_launch`, under a lock: the
server launches from worker and flusher threads) — or raises; there is
no fallback. On a CPU
tensor it runs the kernel's plain torch version and counts nothing.

The sources live in `veneur_tpu_torch/csrc/` and are built on first use
(`_build.load`); nothing is compiled or imported from CUDA when this
package is imported.

The launch route is kept short because the small kernels' calls are
mostly host time: the first launch loads the library (an extension
module, csrc/bindings.cpp) once into the module global `_lib` under
`_build`'s lock, and every later launch reads that global — no lock, no
import, no ctypes conversion. The C entries select the tensor's device
themselves and restore the caller's, so no `torch.cuda.device` context
is entered, and the stream comes from torch's raw current-stream query.
The checks stay, each a plain attribute test.
"""

from __future__ import annotations

import threading

import torch

from . import _build

# launches of each kernel since the last reset (plain integers, written
# only under _launch_lock)
launches = {"compress": 0, "hll_stats": 0, "ull_insert": 0, "probe": 0}
_launch_lock = threading.Lock()

# the loaded library with its bound C entries, after the first launch
_lib = None


def reset_launches() -> None:
    with _launch_lock:
        for k in launches:
            launches[k] = 0


def count_launch(name: str) -> None:
    """Add one to kernel `name`'s count; called by its wrapper right
    after the launch, and nowhere else."""
    with _launch_lock:
        launches[name] += 1


def lib():
    """The kernel library: built and loaded by the first call, a module
    global read after that."""
    global _lib
    if _lib is None:
        _lib = _build.load()
    return _lib


def launch_error(name: str, err: int) -> RuntimeError:
    """The error to raise when a kernel's C entry reports `err` != 0."""
    return RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def require_cuda(name: str, tensor: torch.Tensor, dtype, ndim: int,
                 device: int = -1) -> int:
    """Validate one kernel argument on the card; returns its device
    index. With `device` >= 0 the tensor must lie on that card."""
    if not tensor.is_cuda:
        raise ValueError(f"{name}: tensor on {tensor.device}, expected cuda")
    if tensor.dtype != dtype:
        raise ValueError(f"{name}: dtype {tensor.dtype}, expected {dtype}")
    if tensor.dim() != ndim:
        raise ValueError(f"{name}: {tensor.dim()}-d tensor, expected {ndim}-d")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")
    index = tensor.get_device()
    if device >= 0 and index != device:
        raise ValueError(f"{name}: tensor on cuda:{index}, expected "
                         f"cuda:{device}")
    return index


# stream_handle(index): the raw handle of the current CUDA stream of card
# `index` — torch's own C query, bound here so that a launch pays no Python
# frame for it; None in a torch built without CUDA, where no CUDA tensor
# reaches a wrapper
stream_handle = getattr(torch._C, "_cuda_getCurrentRawStream", None)
