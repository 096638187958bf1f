"""Shared scatter/segmented-batch utilities for the sketch banks.

Counterpart of veneur_tpu/ops/scatter.py. A device batch is a set of
parallel 1-D tensors (slots[N], values[N], weights[N]) where slot == -1
marks padding. The helpers compute per-slot ranks (the position of a
sample among the samples of the same slot within the batch), which turn
a scatter into per-slot ring buffers into plain indexed writes.

The reference processes one sample at a time on the owning goroutine
(worker.go sym: Worker.ProcessMetric); here the same routing is a sort by
slot id plus rank arithmetic, done once per batch for the whole batch.
"""

from __future__ import annotations

import torch


def sort_by_slot(slots, *arrays, num_slots: int):
    """Stable-sort a batch by slot id. Padding (slot < 0) and ids past
    `num_slots` sort to the end. Returns (sorted_slots, *sorted_arrays)
    with the original slot values kept (padding stays -1).

    The sort runs on ONE packed int64 key (slot << idx_bits | idx): the
    index in the low bits makes every key distinct, so the order is the
    stable one whatever algorithm sorts it."""
    n = slots.shape[0]
    if n == 0:
        return (slots,) + tuple(arrays)
    idx_bits = max(1, (n - 1).bit_length())
    key = torch.where((slots < 0) | (slots > num_slots),
                      torch.full_like(slots, num_slots), slots).long()
    idx = torch.arange(n, dtype=torch.int64, device=slots.device)
    packed = (key << idx_bits) | idx
    order = torch.sort(packed, stable=True).values & ((1 << idx_bits) - 1)
    return (slots[order],) + tuple(a[order] for a in arrays)


def run_ranks(sorted_slots):
    """Given slot ids sorted ascending, return the 0-based rank of each
    element within its run of equal ids (int64)."""
    n = sorted_slots.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=sorted_slots.device)
    if n == 0:
        return idx
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_slots.device)
    is_start[1:] = sorted_slots[1:] != sorted_slots[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return idx - run_start


def run_lasts(sorted_slots):
    """Boolean mask marking the last element of each run of equal slot ids
    (used for last-write-wins gauge semantics)."""
    n = sorted_slots.shape[0]
    last = torch.ones(n, dtype=torch.bool, device=sorted_slots.device)
    if n > 1:
        last[:-1] = sorted_slots[:-1] != sorted_slots[1:]
    return last


def drop_index(slots, num_slots: int, mask=None, *, wrap=False):
    """Row of each sample in a [num_slots + 1] scratch whose last row,
    the sentinel `num_slots`, callers slice off: the `mode="drop"` of
    the JAX scatters. Masked-off samples and ids outside [0, num_slots)
    go to the sentinel.

    `wrap=True` is the rule of a JAX helper that hands its ids to `.at[]`
    as they are (`segment_count`): `.at[]` first wraps a negative id in
    [-num_slots, -1] onto id + num_slots, as numpy indexing does, and
    drops only what is still outside. The default is the rule of the JAX
    helpers that map padding to the sentinel themselves
    (`where(slots >= 0, slots, K)`), where a negative id never reaches
    the scatter."""
    K = num_slots
    if wrap:
        slots = torch.where((slots < 0) & (slots >= -K), slots + K, slots)
    bad = (slots < 0) | (slots >= K)
    if mask is not None:
        bad = bad | ~mask
    return torch.where(bad, torch.full_like(slots, K), slots).long()


def segment_count(slots, mask, num_slots: int):
    """Count of True-mask samples per slot (int32), dropping out-of-range
    ids; a negative id the mask admits wraps as in the JAX helper. Integer
    adds, so the result does not depend on their order."""
    idx = drop_index(slots, num_slots, mask, wrap=True)
    out = torch.zeros(num_slots + 1, dtype=torch.int32, device=slots.device)
    out.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return out[:num_slots]


def segment_sum_f64(slots, values, num_slots: int, mask=None):
    """Per-slot sum of f32 `values`, accumulated in float64 and rounded
    once to float32 (dropping padding). Integer-valued and other exactly
    representable sums are exact in any order, so the atomics of a CUDA
    `index_add_` cannot change them; a sum of fractional values is exact
    to ~1e-16 before the single rounding, so the f32 result is the same
    in any order except when that tiny error straddles an f32 rounding
    boundary (then it differs by one ulp)."""
    idx = drop_index(slots, num_slots, mask)
    out = torch.zeros(num_slots + 1, dtype=torch.float64,
                      device=slots.device)
    out.index_add_(0, idx, values.double())
    return out[:num_slots].float()
