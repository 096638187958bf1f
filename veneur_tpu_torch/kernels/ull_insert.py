"""Wrapper of the ULL scatter-join insert kernel (csrc/ull_insert.cu).

Counterpart of veneur_tpu/kernels/ull_insert.py:fused_insert. On a CUDA
bank it launches one kernel over the batch and updates the registers in
place; on a CPU bank it runs the plain version, `_insert_impl`
(sketches/ull.py).
"""

from __future__ import annotations

import torch

from . import check_launch, launches, require_cuda, stream_handle
from ..sketches.ull import _insert_impl


def fused_insert(bank, slots, reg_idx, vals):
    """Join vals u8[n] into bank.registers[slots[i], reg_idx[i]] in place
    (slots/reg_idx i32[n]); updates outside the bank are dropped. Returns
    the bank."""
    regs = bank.registers
    if regs.device.type == "cpu":
        return _insert_impl(bank, slots, reg_idx, vals)
    require_cuda("fused_insert registers", regs, torch.uint8, 2)
    require_cuda("fused_insert slots", slots, torch.int32, 1)
    require_cuda("fused_insert reg_idx", reg_idx, torch.int32, 1)
    require_cuda("fused_insert vals", vals, torch.uint8, 1)
    K, m = regs.shape
    n = slots.shape[0]
    if reg_idx.shape[0] != n or vals.shape[0] != n:
        raise ValueError(f"fused_insert: batch lengths disagree {n} "
                         f"{reg_idx.shape[0]} {vals.shape[0]}")
    devs = {t.device for t in (regs, slots, reg_idx, vals)}
    if len(devs) != 1:
        raise ValueError(f"fused_insert: tensors on {devs}")
    # the kernel CASes the aligned 32-bit word holding each byte: it must
    # lie inside the register row and inside the allocation
    if regs.data_ptr() % 4 or m % 4:
        raise ValueError("fused_insert: registers must be 4-byte aligned "
                         f"with a row width divisible by 4 (m={m})")
    if n == 0 or K == 0:
        return bank
    from ._build import load
    lib = load()
    with torch.cuda.device(regs.device):
        err = lib.vt_ull_insert(regs.data_ptr(), slots.data_ptr(),
                                reg_idx.data_ptr(), vals.data_ptr(), n, K,
                                m, regs.device.index,
                                stream_handle(regs.device))
    check_launch(err, "fused_insert")
    launches["ull_insert"] += 1
    return bank
