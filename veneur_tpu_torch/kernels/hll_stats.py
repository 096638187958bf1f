"""Wrapper of the HLL estimate reduction kernel (csrc/hll_stats.cu).

Counterpart of veneur_tpu/kernels/hll_stats.py:hll_stats. On a CUDA
tensor it launches one kernel over every row; on a CPU tensor it runs
the plain version, `hll_stats_plain`.
"""

from __future__ import annotations

import torch

from . import launch_error, launches, lib, require_cuda, stream_handle


def hll_stats_plain(registers):
    """(ez[K], zsum[K]) f32 row statistics of a u8[K, m] register bank:
    the count of zero registers and the sum of 2^-register."""
    ez = (registers == 0).sum(dim=1).float()
    zsum = torch.exp2(-registers.float()).sum(dim=1)
    return ez, zsum


def hll_stats(registers):
    """(ez[K], zsum[K]) for a u8[K, m] register bank."""
    if registers.is_cpu:
        return hll_stats_plain(registers)
    dev = require_cuda("hll_stats registers", registers, torch.uint8, 2)
    K, m = registers.shape
    if m < 1:
        raise ValueError("hll_stats: register width must be >= 1")
    ez = registers.new_empty(K, dtype=torch.float32)
    zsum = registers.new_empty(K, dtype=torch.float32)
    if K == 0:
        return ez, zsum
    err = lib().vt_hll_stats(registers.data_ptr(), ez.data_ptr(),
                             zsum.data_ptr(), K, m, dev, stream_handle(dev))
    if err:
        raise launch_error("hll_stats", err)
    launches["hll_stats"] += 1
    return ez, zsum
