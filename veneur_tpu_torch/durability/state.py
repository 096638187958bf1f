"""Integration façades: the sender's forward op log and the receiver's
watermark log — the port's copy of veneur_tpu/durability/state.py.

`ForwardJournal` is consumed by `resilience.ResilientForwarder`: each
ladder mutation (write-ahead BEGIN, DONE, partial-tail UPDATE, AGE,
DEMOTE, SPILL_MERGE) appends one typed record, and recovery replays the
ops in order to reconstruct the ladder + spill tier bit-exactly (the
application logic lives with the semantics, in `resilience.py`; this
module only stores and parses). Compaction snapshots the full state
(META + SPILL_STATE + one BEGIN per parked entry) and truncates.

`WatermarkJournal` is consumed by the Server on behalf of the dedupe
ledger: once per flush it appends the per-sender max admitted
interval_seq (skipped when unchanged), and recovery merges every
record by max so a restarted global restores the highest watermark it
ever flushed under. The merged map is bounded (`max_senders`,
oldest-recorded dropped first) so a parade of one-shot sender ids
cannot grow the snapshot without bound.
"""

from __future__ import annotations

import time
from collections import OrderedDict

from . import records
from .journal import Journal


class ForwardJournal:
    """The sender-side op log. One instance per ResilientForwarder;
    appends happen only on the flusher thread (like the forwarder
    itself), `sync()`/`maybe_compact()` on the flush boundary."""

    def __init__(self, directory: str, fsync: str = "interval",
                 fsync_interval_s: float = 1.0,
                 snapshot_journal_bytes: int = 1 << 22,
                 clock=time.monotonic, registry=None,
                 destination: str = "durability"):
        self.journal = Journal(directory, "forward", fsync=fsync,
                               fsync_interval_s=fsync_interval_s,
                               clock=clock, registry=registry,
                               destination=destination)
        self.snapshot_journal_bytes = snapshot_journal_bytes

    def load_ops(self) -> list:
        """All recoverable ops in write order: the snapshot's records
        (themselves valid ops: META, SPILL_STATE, BEGINs) followed by
        the journal's. Truncates any torn tail; never raises."""
        snapshot, journal = self.journal.load()
        return list(snapshot or []) + list(journal)

    # -- append helpers (one per ladder op) --

    def meta(self, sender_id: str, next_seq: int):
        self.journal.append(records.REC_META,
                            records.encode_meta(sender_id, next_seq))

    def begin(self, seq: int, chunk_offset: int, chunk_count: int,
              age: int, export, kind: str = "full"):
        self.journal.append(
            records.REC_BEGIN,
            records.encode_begin(seq, chunk_offset, chunk_count, age,
                                 export, kind))

    def done(self, seq: int):
        self.journal.append(records.REC_DONE, records.encode_done(seq))

    def update(self, seq: int, chunk_offset: int, chunk_count: int,
               export):
        self.journal.append(
            records.REC_UPDATE,
            records.encode_update(seq, chunk_offset, chunk_count,
                                  export))

    def age(self):
        self.journal.append(records.REC_AGE, b"")

    def demote(self):
        self.journal.append(records.REC_DEMOTE, b"")

    def spill_merge(self):
        self.journal.append(records.REC_SPILL_MERGE, b"")

    # -- flush-boundary hooks --

    def sync(self):
        self.journal.sync()

    def maybe_compact(self, snapshot_records_fn) -> bool:
        """Snapshot + truncate when the journal outgrew its budget.
        `snapshot_records_fn()` returns the full-state record list
        (ResilientForwarder.durable_snapshot_records)."""
        if self.journal.size_bytes() < self.snapshot_journal_bytes:
            return False
        self.journal.snapshot(snapshot_records_fn())
        return True

    def size_bytes(self) -> int:
        return self.journal.size_bytes()

    def close(self):
        self.journal.close()


class EngineJournal:
    """The global tier's engine-state log.

    Two record families share one journal+snapshot pair named
    "engine": ENGINE_IMPORT write-ahead ops appended by the import
    handler threads (BEFORE the sender's ack — an admitted interval
    survives a crash), and per-engine checkpoint groups (META + KEYS +
    BANK + STAGED) appended by the flusher at each flush boundary.
    A checkpoint group is SELF-CONTAINED (banks are interval-scoped:
    fresh init + dirty rows is the whole state), so compaction writes
    the latest groups plus the ops the per-engine watermarks haven't
    covered yet, and truncates everything older.

    Storage only — the application semantics (which ops replay, how
    banks rebuild) live with the engine in models/pipeline.py and the
    Server's recovery pass."""

    def __init__(self, directory: str, fsync: str = "interval",
                 fsync_interval_s: float = 1.0,
                 snapshot_journal_bytes: int = 1 << 22,
                 clock=time.monotonic, registry=None,
                 destination: str = "durability"):
        self.journal = Journal(directory, "engine", fsync=fsync,
                               fsync_interval_s=fsync_interval_s,
                               clock=clock, registry=registry,
                               destination=destination)
        self.snapshot_journal_bytes = snapshot_journal_bytes
        self.last_checkpoint_bytes = 0

    def load_records(self) -> list:
        """All recoverable records in write order (snapshot groups
        first, then the journal's). Truncates any torn tail; never
        raises."""
        snapshot, journal = self.journal.load()
        return list(snapshot or []) + list(journal)

    def append_import(self, payload: bytes):
        """Write-ahead one admitted import op (already encoded by
        records.encode_engine_import). Called from handler threads;
        the journal's lock serializes against checkpoint appends."""
        self.journal.append(records.REC_ENGINE_IMPORT, payload)

    def append_checkpoint(self, recs) -> int:
        """Append one flush boundary's checkpoint record groups;
        returns the bytes written (the engine_snapshot_bytes gauge)."""
        n = 0
        for rec_type, payload in recs:
            n += self.journal.append(rec_type, payload)
        self.last_checkpoint_bytes = n
        return n

    def maybe_compact(self, snapshot_records) -> bool:
        """Snapshot + truncate when the journal outgrew its budget.
        `snapshot_records` is the full-state record list (latest
        checkpoint groups + retained uncovered ops)."""
        if self.journal.size_bytes() < self.snapshot_journal_bytes:
            return False
        self.journal.snapshot(snapshot_records)
        return True

    def sync(self):
        self.journal.sync()

    def size_bytes(self) -> int:
        return self.journal.size_bytes()

    def generation(self) -> int:
        return self.journal._generation

    def close(self):
        self.journal.close()


class WatermarkJournal:
    """The receiver-side watermark log. Appends happen on the flusher
    thread (flush boundary); recovery runs in Server.__init__, before
    any listener exists."""

    def __init__(self, directory: str, fsync: str = "interval",
                 fsync_interval_s: float = 1.0,
                 snapshot_journal_bytes: int = 1 << 20,
                 max_senders: int = 4096,
                 clock=time.monotonic, registry=None,
                 destination: str = "durability"):
        self.journal = Journal(directory, "dedupe", fsync=fsync,
                               fsync_interval_s=fsync_interval_s,
                               clock=clock, registry=registry,
                               destination=destination)
        self.snapshot_journal_bytes = snapshot_journal_bytes
        self.max_senders = max_senders
        # merged view of everything recorded so far (recency-ordered:
        # most recently recorded last; the eviction order)
        self._marks: OrderedDict[str, int] = OrderedDict()

    def load(self) -> dict:
        """Recover the merged per-sender watermark map (max across all
        records, snapshot first). Never raises."""
        snapshot, journal = self.journal.load()
        for rec_type, payload in list(snapshot or []) + list(journal):
            if rec_type != records.REC_WATERMARKS:
                continue
            try:
                marks = records.decode_watermarks(payload)
            except Exception:
                continue   # a foreign record kind must not kill recovery
            self._absorb(marks)
        return dict(self._marks)

    def _absorb(self, marks: dict):
        for sender_id, seq in marks.items():
            cur = self._marks.get(sender_id, 0)
            self._marks[sender_id] = max(cur, int(seq))
            self._marks.move_to_end(sender_id)
        while len(self._marks) > self.max_senders:
            self._marks.popitem(last=False)

    def record(self, marks: dict):
        """Append this flush's per-sender max admitted seqs; skipped
        when nothing changed since the last record (idle globals must
        not grow the journal)."""
        changed = {s: q for s, q in marks.items()
                   if int(q) > self._marks.get(s, 0)}
        if not changed:
            return
        self._absorb(changed)
        self.journal.append(records.REC_WATERMARKS,
                            records.encode_watermarks(changed))
        if self.journal.size_bytes() >= self.snapshot_journal_bytes:
            self.journal.snapshot([(
                records.REC_WATERMARKS,
                records.encode_watermarks(dict(self._marks)))])

    def sync(self):
        self.journal.sync()

    def size_bytes(self) -> int:
        return self.journal.size_bytes()

    def close(self):
        self.journal.close()
