"""Wrapper of the ULL scatter-join insert kernel (csrc/ull_insert.cu).

Counterpart of veneur_tpu/kernels/ull_insert.py:fused_insert. On a CUDA
bank it launches one kernel over the batch and updates the registers in
place; on a CPU bank it runs the plain version, `_insert_impl`
(sketches/ull.py).
"""

from __future__ import annotations

import torch

from . import count_launch, launch_error, lib, require_cuda, stream_handle
from ..sketches.ull import _insert_impl, check_flat_range


def fused_insert(bank, slots, reg_idx, vals):
    """Join vals u8[n] into bank.registers in place at the uint32 flat
    index slots[i] * m + reg_idx[i] (slots/reg_idx i32[n]), the key of
    `_insert_impl`; padding (slot < 0) and indices past the bank are
    dropped. Returns the bank."""
    regs = bank.registers
    if regs.is_cpu:
        return _insert_impl(bank, slots, reg_idx, vals)
    dev = require_cuda("fused_insert registers", regs, torch.uint8, 2)
    require_cuda("fused_insert slots", slots, torch.int32, 1, dev)
    require_cuda("fused_insert reg_idx", reg_idx, torch.int32, 1, dev)
    require_cuda("fused_insert vals", vals, torch.uint8, 1, dev)
    K, m = regs.shape
    n = slots.shape[0]
    if reg_idx.shape[0] != n or vals.shape[0] != n:
        raise ValueError(f"fused_insert: batch lengths disagree {n} "
                         f"{reg_idx.shape[0]} {vals.shape[0]}")
    check_flat_range(K, m)
    # the kernel CASes the aligned 32-bit word holding each byte: it must
    # lie inside the register row and inside the allocation
    base = regs.data_ptr()
    if base % 4 or m % 4:
        raise ValueError("fused_insert: registers must be 4-byte aligned "
                         f"with a row width divisible by 4 (m={m})")
    if n == 0 or K == 0:
        return bank
    err = lib().vt_ull_insert(base, slots.data_ptr(), reg_idx.data_ptr(),
                              vals.data_ptr(), n, K, m, dev,
                              stream_handle(dev))
    if err:
        raise launch_error("fused_insert", err)
    count_launch("ull_insert")
    return bank
