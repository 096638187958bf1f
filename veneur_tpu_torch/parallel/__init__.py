"""Multi-device parallelism: device grids, sharded banks, the merged flush.

Counterpart of veneur_tpu/parallel/. The reference's parallelism (SURVEY
§2.3) maps onto a 2D grid of devices:
  * axis "shard" — hash-space partitioning of the slot axis, the
    analogue of `Workers[Digest % len(Workers)]` and of the proxy's
    consistent-hash ring: each device column owns a slice of the
    metric-key space; no cross-device traffic on the ingest hot path.
  * axis "dp" — ingest data-parallel replicas, the analogue of
    `num_readers`/multiple local veneurs: the same key space replicated
    so independent sample streams can feed independent devices; at
    flush, each shard column's replicas are merged onto the column's
    first device (counters and sums added, extremes and HLL registers
    max-reduced, t-digest centroids gathered and reclustered) — the
    reference's local→global sketch-forwarding tier, collapsed into one
    merge per column.

One process owns the whole grid, as one JAX controller owns its mesh:
the JAX package's collectives become explicit copies onto the column's
owner. A device may stand in the grid more than once, so one card holds
a whole grid (several cards share the grid round-robin); no
torch.distributed process group is involved.
"""
