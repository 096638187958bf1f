"""The default set engine: batched HyperLogLog register banks.

Counterpart of veneur_tpu/sketches/hll_engine.py, an adapter over
`ops/hll.py`. The flush's set estimate reduces the registers through
the `hll_stats` kernel on the card.

Error contract: LogLog-Beta estimation, relative standard error
~1.04/sqrt(m) (~0.81% at the default precision 14).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops import hll


@dataclass(frozen=True)
class HLLEngine:
    precision: int = 14

    id = "hll"
    wire_version = 1

    def init(self, num_slots: int, device):
        return hll.init(num_slots, self.precision, device=device)

    def insert(self, bank, slots, reg_idx, vals):
        return hll.insert(bank, slots, reg_idx, vals)

    def hash_update(self, h: int) -> tuple:
        """(register index, rho) from one 64-bit member hash — the
        per-sample ingest hot path (python ints, no numpy)."""
        p = self.precision
        idx = h >> (64 - p)
        rest = ((h << p) & 0xFFFFFFFFFFFFFFFF) | ((1 << p) - 1)
        rho = 65 - rest.bit_length()   # clz + 1; sentinel caps range
        return idx, rho

    def estimate(self, bank) -> dict:
        return {"s_est": hll.estimate(bank)}
