"""Counter and gauge banks — the scalar samplers as batched scatters.

Counterpart of veneur_tpu/ops/scalar.py. Reference: samplers/samplers.go
(sym: Counter.Sample — `value += v * 1/rate`, flushed per interval;
Gauge.Sample — last write wins).

Counters keep a compensated (2Sum) f32 hi/lo pair: each batch is
segment-summed into a dense f32 delta, then folded into the pair with an
error-free transformation — float64-grade totals with f32 state. The
delta is accumulated in float64 and rounded once (ops/scatter.py
`segment_sum_f64`), so the atomics of a CUDA scatter cannot reorder it
into another value for exactly representable sums.

Gauges keep f32 plus an i32 sequence number so last-write-wins holds
across batches.

The update functions return new banks; the ones that scatter write into
fresh tensors and never modify their input bank in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import scatter


class CounterBank(NamedTuple):
    hi: torch.Tensor  # f32[K]
    lo: torch.Tensor  # f32[K] compensation term

    @property
    def num_slots(self):
        return self.hi.shape[0]


class GaugeBank(NamedTuple):
    value: torch.Tensor  # f32[K]
    seq: torch.Tensor    # i32[K], last writer's sequence, -1 == never written

    @property
    def num_slots(self):
        return self.value.shape[0]


def init_counters(num_slots: int, device) -> CounterBank:
    return CounterBank(
        hi=torch.zeros(num_slots, dtype=torch.float32, device=device),
        lo=torch.zeros(num_slots, dtype=torch.float32, device=device))


def init_gauges(num_slots: int, device) -> GaugeBank:
    return GaugeBank(
        value=torch.zeros(num_slots, dtype=torch.float32, device=device),
        seq=torch.full((num_slots,), -1, dtype=torch.int32, device=device))


def _two_sum(a, b):
    """Error-free transformation: a + b = s + err exactly (Knuth 2Sum)."""
    s = a + b
    a2 = s - b
    b2 = s - a2
    err = (a - a2) + (b - b2)
    return s, err


def _fold(bank: CounterBank, delta) -> CounterBank:
    s, err = _two_sum(bank.hi, delta + bank.lo)
    return CounterBank(hi=s, lo=err)


def counter_add(bank: CounterBank, slots, values, weights) -> CounterBank:
    """Batched Counter.Sample: value[slot] += v * weight (weight = 1/rate)."""
    delta = scatter.segment_sum_f64(slots, values * weights,
                                    bank.num_slots)
    return _fold(bank, delta)


def counter_totals(bank: CounterBank):
    """Read totals with the compensation folded back in (host side does
    float64(hi) + float64(lo) for full precision)."""
    return bank.hi, bank.lo


def gauge_set(bank: GaugeBank, slots, values, seqs) -> GaugeBank:
    """Batched Gauge.Sample with last-write-wins.

    `seqs` is a monotonically increasing host-assigned sequence per sample;
    within a batch the per-slot max-seq sample wins (the stable sort puts
    it last in its run), and across batches the stored seq arbitrates.
    """
    K = bank.num_slots
    s, v, q = scatter.sort_by_slot(slots, values, seqs, num_slots=K)
    last = scatter.run_lasts(s) & (s >= 0) & (s < K)
    row = scatter.drop_index(s, K, last)
    seq = torch.cat([bank.seq, bank.seq.new_full((1,), -1)])
    seq.scatter_reduce_(0, row, q.to(seq.dtype), reduce="amax")
    new_seq = seq[:K]
    won = last & (q >= new_seq[s.clamp(0, K - 1).long()])
    row_w = scatter.drop_index(s, K, won)
    value = torch.cat([bank.value, bank.value.new_zeros(1)])
    # at most one winner per slot (one run last), so the write is unique
    value[row_w] = v.to(value.dtype)
    return GaugeBank(value=value[:K], seq=new_seq)
