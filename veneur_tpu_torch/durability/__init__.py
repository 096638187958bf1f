"""Durable state: a crash-safe journal for the forward replay ledger,
the merged spill tier, and the receiver's dedupe watermarks — the
port's copy of veneur_tpu/durability/.

The reference design was crash-only because its state was one interval
deep — a restart lost at most the interval in flight. The exactly-once
forward machinery changed that: the sender now holds a bounded
multi-interval replay ladder plus a merged spill tier, and the receiver
holds per-sender dedupe watermarks; all of it evaporated on restart,
silently reopening the under-/over-count windows the idempotency
envelopes exist to close. This package persists exactly that state:

  * `journal` — the storage layer: an append-only, CRC32C-framed,
    length-prefixed record log with torn-write tolerance (recovery
    truncates at the first bad frame, counted), a configurable fsync
    policy (`always` / `interval` / `never`), and atomic
    snapshot+compaction (write-temp, fsync, rename) at flush
    boundaries.
  * `records` — the typed layer: serializes parked `ForwardEnvelope`
    intervals (reusing `cluster/wire.py`'s sketch codecs — centroids,
    HLL registers, counters, gauges), spill-tier contents with gauge
    ages, and receiver-side per-sender watermarks.
  * `state` — the integration façades: `ForwardJournal` (the sender's
    op log, consumed by `resilience.ResilientForwarder`),
    `WatermarkJournal` (the receiver's per-flush watermark log,
    consumed by `Server` + `cluster.importsrv.DedupeLedger`), and
    `EngineJournal` (the global tier's engine-state log: write-ahead
    import ops + per-engine delta checkpoints at flush boundaries, so
    the fleet's admitted-and-merged interval state survives a crash
    and a restarted global flushes BIT-IDENTICAL state).

Mergeable-sketch semantics are what make the recovered state safe: a
parked interval's t-digest centroids / HLL registers / counter sums
re-merge losslessly after a crash, and replaying them under their
ORIGINAL envelopes lets the receiver's dedupe ledger drop anything it
already Combined before the crash.

All on-disk writes in this package go through the `Journal` append /
snapshot API (journal.py owns the framing, fsync and atomic-rename
contract): no other module under `durability/` opens files for
writing.

The `history` module grows a READ tier on top: a retained
window of committed checkpoint generations (one per closed flush
interval, manifest-indexed by interval-close wall time) and the
time-travel query engine behind `GET /query` — historical percentiles,
counts, and cardinalities reconstructed through the same recovery-
restore path, into scratch engines, never the live banks.
"""

from .history import HistoryStore, QueryError, QueryTier
from .journal import Journal, crc32c
from .state import EngineJournal, ForwardJournal, WatermarkJournal

__all__ = ["Journal", "crc32c", "EngineJournal", "ForwardJournal",
           "WatermarkJournal", "HistoryStore", "QueryTier",
           "QueryError"]
