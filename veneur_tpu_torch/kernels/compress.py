"""Wrapper of the fused t-digest compress kernel (csrc/compress.cu).

Counterpart of veneur_tpu/kernels/compress.py:fused_compress. On CUDA
tensors it launches one kernel over every row; on CPU tensors it runs
the plain version, `compress_plain` (ops/tdigest.py), re-exported here.
"""

from __future__ import annotations

import torch

from . import check_launch, launches, require_cuda, stream_handle
from ..ops.tdigest import compress_plain

__all__ = ["fused_compress", "compress_plain"]

_MAX_SMEM = 227 * 1024


def fused_compress(mean, weight, buf_value, buf_weight, compression: float):
    """[K, C] centroids + [K, B] buffers -> (new_mean, new_weight) [K, C]:
    the whole compress of every row (sort, rank-merge, k1 clustering,
    ordering clamp)."""
    if mean.device.type == "cpu":
        return compress_plain(mean, weight, buf_value, buf_weight,
                              compression)
    for name, t in (("mean", mean), ("weight", weight),
                    ("buf_value", buf_value), ("buf_weight", buf_weight)):
        require_cuda(f"fused_compress {name}", t, torch.float32, 2)
    K, C = mean.shape
    B = buf_value.shape[1]
    if weight.shape != (K, C) or buf_weight.shape != (K, B) \
            or buf_value.shape[0] != K:
        raise ValueError("fused_compress: leaf shapes disagree "
                         f"{tuple(mean.shape)} {tuple(weight.shape)} "
                         f"{tuple(buf_value.shape)} {tuple(buf_weight.shape)}")
    if C < 1 or B < 1 or B > (1 << 16):
        raise ValueError(f"fused_compress: unsupported C={C} B={B}")
    devs = {t.device for t in (mean, weight, buf_value, buf_weight)}
    if len(devs) != 1:
        raise ValueError(f"fused_compress: tensors on {devs}")
    from ._build import load
    lib = load()
    smem = lib.vt_compress_smem_bytes(C, B)
    if smem > _MAX_SMEM:
        raise ValueError(f"fused_compress: C={C} B={B} needs {smem} B of "
                         f"shared memory, over {_MAX_SMEM}")
    out_mean = torch.empty_like(mean)
    out_weight = torch.empty_like(mean)
    if K == 0:
        return out_mean, out_weight
    with torch.cuda.device(mean.device):
        err = lib.vt_compress(
            mean.data_ptr(), weight.data_ptr(), buf_value.data_ptr(),
            buf_weight.data_ptr(), out_mean.data_ptr(),
            out_weight.data_ptr(), K, C, B, float(compression),
            mean.device.index, stream_handle(mean.device))
    check_launch(err, "fused_compress")
    launches["compress"] += 1
    return out_mean, out_weight
