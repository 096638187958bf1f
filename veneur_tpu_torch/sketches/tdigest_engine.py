"""The default histogram engine: batched merging t-digest banks.

Counterpart of veneur_tpu/sketches/tdigest_engine.py: a thin adapter
over `ops/tdigest.py` presenting the engine surface the pipeline calls.
The compress goes through the kernel wrapper on the card and through its
plain version on the CPU (ops/tdigest._compress_impl). The global tier
lands forwarded digests with the "cluster" strategy: each slot's pile is
clustered by `cluster_rows` (eager torch), then merged and compressed.

Error contract: t-digest bounds ABSOLUTE rank error (~1/compression of
total rank per cluster, k1 tail-dense); count/sum/min/max are exact.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops import tdigest


@dataclass(frozen=True)
class TDigestEngine:
    compression: float = 100.0
    buffer_depth: int = 256

    id = "tdigest"
    wire_version = 1
    import_strategy = "cluster"   # precluster foreign piles (cluster_rows)
    error_contract = ("absolute rank error ~1/compression per cluster "
                      "(k1 tail-dense); exact count/sum/min/max")

    def init(self, num_slots: int, device):
        return tdigest.init(num_slots, self.compression, self.buffer_depth,
                            device=device)

    def add_batch(self, bank, slots, values, weights):
        return tdigest._add_batch_impl(bank, slots, values, weights,
                                       self.compression)

    def compress(self, bank):
        return tdigest._compress_impl(bank, self.compression)

    def merge_centroids(self, bank, slots, means, weights):
        return tdigest.merge_centroids(bank, slots, means, weights)

    def merge_scalars(self, bank, slots, vmins, vmaxs, vsums, counts,
                      recips):
        return tdigest.merge_scalars(bank, slots, vmins, vmaxs, vsums,
                                     counts, recips)

    def quantile(self, bank, qs):
        return tdigest.quantile(bank, qs)

    def aggregates(self, bank):
        return tdigest.aggregates(bank)

    def forward_leaves(self, bank) -> dict:
        """The flush outputs a forwarding engine exports (the centroids
        and the exact scalars with their 2Sum terms)."""
        return dict(
            h_mean=bank.mean, h_weight=bank.weight,
            h_min=bank.vmin, h_max=bank.vmax,
            h_sum=bank.vsum, h_sum_lo=bank.vsum_lo,
            h_count=bank.count, h_count_lo=bank.count_lo,
            h_recip=bank.recip, h_recip_lo=bank.recip_lo)

    def cluster_rows(self, values, weights, num_centroids: int,
                     sorted_prefix: int = 0):
        return tdigest.cluster_rows(values, weights,
                                    compression=self.compression,
                                    num_centroids=num_centroids,
                                    sorted_prefix=sorted_prefix)

    def merge_banks(self, a, b):
        """Bit-commutative union of two whole banks."""
        return tdigest.merge_banks(a, b, compression=self.compression)
