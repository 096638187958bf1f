"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper (compress.fused_compress, hll_stats.hll_stats) takes torch
tensors. On a CUDA tensor it checks device, dtype, shape and
contiguity, launches its kernel on the current stream and adds one to
its entry in `launches` — or raises; there is no fallback. On a CPU
tensor it runs the kernel's plain torch version and counts nothing.

The sources live in `veneur_tpu_torch/csrc/` and are built on first use
(`_build.load`); nothing is compiled or imported from CUDA when this
package is imported.
"""

from __future__ import annotations

import torch

# launches of each kernel since the last reset (plain integers)
launches = {"compress": 0, "hll_stats": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel's C entry reported a launch error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def require_cuda(name: str, tensor: torch.Tensor, dtype, ndim: int) -> None:
    """Validate one kernel argument on the card."""
    if tensor.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {tensor.device}, expected cuda")
    if tensor.dtype != dtype:
        raise ValueError(f"{name}: dtype {tensor.dtype}, expected {dtype}")
    if tensor.dim() != ndim:
        raise ValueError(f"{name}: {tensor.dim()}-d tensor, expected {ndim}-d")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
