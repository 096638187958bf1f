"""Batched HyperLogLog bank — counterpart of veneur_tpu/ops/hll.py.

The reference's samplers.Set wraps a HyperLogLog with 2^14 registers;
inserts hash the member and take max(register, rho); estimation uses the
LogLog-Beta bias-corrected harmonic mean.

K sets live as one u8[K, m] register matrix. Hashing happens on the host
(the device never sees strings); the device ops are a scatter-max
(insert) and a row reduction (estimate). The row reduction is the
`hll_stats` kernel on the card (kernels/hll_stats.py, csrc/hll_stats.cu)
and its plain torch version on the CPU.

`insert` and `merge_rows` update the register matrix of the bank they
are given in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import scatter


class HLLBank(NamedTuple):
    registers: torch.Tensor  # u8[K, m], m = 2^precision

    @property
    def num_slots(self):
        return self.registers.shape[0]

    @property
    def num_registers(self):
        return self.registers.shape[1]


def init(num_slots: int, precision: int = 14, *, device) -> HLLBank:
    return HLLBank(registers=torch.zeros(
        (num_slots, 1 << precision), dtype=torch.uint8, device=device))


def host_hash_to_updates(hashes64, precision: int = 14):
    """Split host-side 64-bit member hashes into (register index, rho):
    index = top `precision` bits; rho = 1 + leading zeros of the
    remaining bits, capped at 64 - precision + 1 (numpy, host side)."""
    h = np.asarray(hashes64, np.uint64)
    idx = (h >> np.uint64(64 - precision)).astype(np.int32)
    rest = (h << np.uint64(precision)) | np.uint64((1 << precision) - 1)
    # clz via exact float64 log2 of the top 53 bits (rho is capped at
    # 64 - precision + 1, so truncating the low 11 bits never matters)
    y = (rest >> np.uint64(11)).astype(np.float64)
    clz = np.where(y > 0, 52.0 - np.floor(np.log2(np.maximum(y, 1.0))), 64.0)
    rho = np.minimum(clz + 1.0, 64 - precision + 1).astype(np.uint8)
    return idx, rho


def insert(bank: HLLBank, slots, reg_idx, rho) -> HLLBank:
    """Batched Set.Sample: registers[slot, idx] = max(., rho), in place.
    slot == -1 marks padding. The batch is first reduced to one max per
    distinct (slot, idx) target — a sort of the packed target word and a
    run-last pick — so the register write touches each byte once and
    needs no atomics on any device."""
    K, m = bank.num_slots, bank.num_registers
    valid = (slots >= 0) & (slots < K)
    if not bool(valid.any()):
        return bank
    target = slots[valid].long() * m + reg_idx[valid].long()
    packed = torch.sort((target << 8) | rho[valid].long()).values
    tgt = packed >> 8
    last = scatter.run_lasts(tgt)
    tgt = tgt[last]
    best = (packed[last] & 0xFF).to(torch.uint8)
    flat = bank.registers.view(-1)
    flat[tgt] = torch.maximum(flat[tgt], best)
    return bank


def merge_rows(bank: HLLBank, slots, registers) -> HLLBank:
    """Batched Set.Combine: union forwarded register rows u8[n, m] into
    their slots (elementwise max), in place. slot == -1 marks padding;
    rows of one slot in the batch are max-reduced together first, so
    each bank row is written once."""
    K = bank.num_slots
    valid = (slots >= 0) & (slots < K)
    if not bool(valid.any()):
        return bank
    uniq, inv = torch.unique(slots[valid].long(), return_inverse=True)
    rows = registers[valid].int()
    acc = bank.registers[uniq].int().scatter_reduce(
        0, inv[:, None].expand(-1, rows.shape[1]), rows, reduce="amax")
    bank.registers[uniq] = acc.to(torch.uint8)
    return bank


def merge_banks(a: HLLBank, b: HLLBank) -> HLLBank:
    """Slot-aligned union of two whole banks (elementwise max)."""
    return HLLBank(registers=torch.maximum(a.registers, b.registers))


# LogLog-Beta coefficients for p=14 (m=16384), as used by the vendored
# axiomhq/hyperloglog estimator.
_BETA14 = (-0.370393911, 0.070471823, 0.17393686, 0.16339839,
           -0.09237745, 0.03738027, -0.005384159, 0.00042419)


def estimate(bank: HLLBank) -> torch.Tensor:
    """Batched cardinality estimate, one f32 per slot: LogLog-Beta
    m * alpha * (m - ez) / (beta(ez) + sum 2^-reg), from the row
    statistics of the `hll_stats` kernel (or its plain version on the
    CPU)."""
    from ..kernels.hll_stats import hll_stats
    ez, zsum = hll_stats(bank.registers)
    return _estimate_from_stats(bank, ez, zsum)


def _estimate_from_stats(bank: HLLBank, ez, zsum) -> torch.Tensor:
    m = bank.num_registers
    zl = torch.log(ez + 1.0)
    beta = ez * _BETA14[0]
    acc = zl
    for c in _BETA14[1:]:
        beta = beta + c * acc
        acc = acc * zl
    alpha = 0.7213 / (1.0 + 1.079 / m)
    est = alpha * m * (m - ez) / (beta + zsum)
    # ez == m  <=>  every register is zero  <=>  empty set
    return torch.where(ez < m, est, torch.zeros_like(est))
