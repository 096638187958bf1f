"""Wrapper of the fused t-digest compress kernel (csrc/compress.cu).

Counterpart of veneur_tpu/kernels/compress.py:fused_compress. On CUDA
tensors it launches one kernel over every row; on CPU tensors it runs
the plain version, `compress_plain` (ops/tdigest.py), re-exported here.
"""

from __future__ import annotations

import functools

import torch

from . import launch_error, launches, lib, require_cuda, stream_handle
from ..ops.tdigest import compress_plain

__all__ = ["fused_compress", "compress_plain"]

_MAX_SMEM = 227 * 1024


@functools.lru_cache(maxsize=None)
def smem_bytes(C: int, B: int) -> int:
    """Shared memory one row of C centroids and B buffer lanes needs
    (asked of the library once per shape)."""
    return lib().vt_compress_smem_bytes(C, B)


def blocks_per_sm(C: int, B: int, device: int) -> int:
    """Rows the kernel keeps in flight on one SM of card `device` at
    this shape (the occupancy calculator's answer)."""
    n = lib().vt_compress_blocks_per_sm(C, B, device)
    if n < 0:
        raise launch_error("compress occupancy", -n)
    return n


def fused_compress(mean, weight, buf_value, buf_weight, compression: float):
    """[K, C] centroids + [K, B] buffers -> (new_mean, new_weight) [K, C]:
    the whole compress of every row (sort, rank-merge, k1 clustering,
    ordering clamp)."""
    if mean.is_cpu:
        return compress_plain(mean, weight, buf_value, buf_weight,
                              compression)
    dev = require_cuda("fused_compress mean", mean, torch.float32, 2)
    require_cuda("fused_compress weight", weight, torch.float32, 2, dev)
    require_cuda("fused_compress buf_value", buf_value, torch.float32, 2, dev)
    require_cuda("fused_compress buf_weight", buf_weight, torch.float32, 2,
                 dev)
    K, C = mean.shape
    B = buf_value.shape[1]
    if weight.shape != (K, C) or buf_weight.shape != (K, B) \
            or buf_value.shape[0] != K:
        raise ValueError("fused_compress: leaf shapes disagree "
                         f"{tuple(mean.shape)} {tuple(weight.shape)} "
                         f"{tuple(buf_value.shape)} {tuple(buf_weight.shape)}")
    if C < 1 or B < 1 or B > (1 << 16):
        raise ValueError(f"fused_compress: unsupported C={C} B={B}")
    smem = smem_bytes(C, B)
    if smem > _MAX_SMEM:
        raise ValueError(f"fused_compress: C={C} B={B} needs {smem} B of "
                         f"shared memory, over {_MAX_SMEM}")
    out_mean = torch.empty_like(mean)
    out_weight = torch.empty_like(mean)
    if K == 0:
        return out_mean, out_weight
    err = lib().vt_compress(
        mean.data_ptr(), weight.data_ptr(), buf_value.data_ptr(),
        buf_weight.data_ptr(), out_mean.data_ptr(), out_weight.data_ptr(),
        K, C, B, float(compression), dev, stream_handle(dev))
    if err:
        raise launch_error("fused_compress", err)
    launches["compress"] += 1
    return out_mean, out_weight
