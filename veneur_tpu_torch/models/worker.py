"""Host-side key management: interning MetricKeys to device slots (the
port's copy of veneur_tpu.models.worker).

The reference shards metrics onto workers by digest and each worker owns Go
maps keyed by MetricKey (worker.go sym: WorkerMetrics, Worker.ProcessMetric).
Here the device owns fixed-K banks, so the host keeps the (only) string-keyed
structure: MetricKey -> slot, with a free list and idle-interval eviction to
survive unbounded key churn against fixed K (SURVEY §7 "slot management").
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ingest.parser import MetricKey

# Sentinel returned by KeyInterner.lookup when the attached admission
# controller refuses to mint a slot for a new key (over its prefix's
# budget): the caller folds the sample into the prefix's `__other__`
# key instead (models/pipeline.py `_fold`). Distinct from -1 (bank
# full), which remains a counted drop.
FOLD_SLOT = -2


@dataclass
class SlotInfo:
    slot: int
    last_interval: int
    scope: int
    # Flush presentation cache (per-key metric names / split tag lists),
    # owned by the engine's assembly; dies with the entry on eviction.
    pres: object = None


class KeyInterner:
    """MetricKey -> slot map for one bank, with eviction.

    Not thread-safe by design: one interner is owned by one ingest thread,
    mirroring the single-goroutine ownership of WorkerMetrics maps.
    """

    def __init__(self, capacity: int, idle_ttl_intervals: int = 16):
        self.capacity = capacity
        self.idle_ttl = idle_ttl_intervals
        self._map: dict[MetricKey, SlotInfo] = {}
        self._free = list(range(capacity - 1, -1, -1))
        self._by_slot: list[MetricKey | None] = [None] * capacity
        self.interval = 0
        self.dropped_no_slot = 0
        # Overload defense (ingest/admission.py), attached by
        # AggregationEngine.attach_admission: consulted ONLY on the
        # allocation path — a key already holding a slot pays zero
        # admission cost (the map hit above is the whole hot path).
        self.admission = None

    def __len__(self):
        return len(self._map)

    def lookup(self, key: MetricKey, scope: int) -> int:
        """Return the slot for `key`, allocating if new. -1 if the bank is
        full (caller counts the drop — the analogue of worker channel
        backpressure drops, which veneur also counts rather than blocks);
        FOLD_SLOT (-2) if the admission controller refused the slot
        (over-budget key: caller folds into the prefix's other-key)."""
        info = self._map.get(key)
        if info is not None:
            info.last_interval = self.interval
            info.scope = scope
            return info.slot
        adm = self.admission
        if adm is not None and adm.admit_key(key) is None:
            return FOLD_SLOT
        if not self._free:
            if adm is not None:
                adm.release_key(key)   # admitted, but no slot to mint
            self.dropped_no_slot += 1
            return -1
        slot = self._free.pop()
        self._map[key] = SlotInfo(slot, self.interval, scope)
        self._by_slot[slot] = key
        return slot

    def key_of(self, slot: int) -> MetricKey | None:
        return self._by_slot[slot]

    def scope_of(self, slot: int) -> int:
        key = self._by_slot[slot]
        return self._map[key].scope if key is not None else 0

    def active_items(self):
        """(key, slot, scope, info) tuples for keys touched in the
        *current* interval — the set a flush reports (bank state is
        interval-scoped, so stale slots hold zeros and are skipped).
        Returning scope and the SlotInfo directly spares the flush a
        per-key MetricKey hash (scope_of) at 100k keys."""
        cur = self.interval
        return [(k, i.slot, i.scope, i) for k, i in self._map.items()
                if i.last_interval == cur]

    def all_items(self):
        """EVERY interned key, touched or idle (same row shape as
        active_items) — what a FULL forward resync ships:
        idle keys' zero/empty bank rows refresh the receiving tier's
        series liveness, which steady-state deltas deliberately skip.
        Keys idle past the TTL have already evicted and are gone from
        here too — a resync re-ships the interner's world, not
        history."""
        return [(k, i.slot, i.scope, i) for k, i in self._map.items()]

    def snapshot_entries(self) -> list:
        """The full table as (slot, scope, last_interval, name, type,
        joined_tags) rows — the engine checkpoint's ENGINE_KEYS payload
        (durability/). Map order (= insertion order) is
        preserved so a restored interner iterates like the original."""
        return [(info.slot, info.scope, info.last_interval,
                 k.name, k.type, k.joined_tags)
                for k, info in self._map.items()]

    def restore(self, interval: int, entries: list):
        """Rebuild the table from a checkpoint (recovery-before-listen).
        The free list is reconstructed canonically (unused slots,
        allocation resuming from the lowest) — free-list ORDER only
        decides which slot a future key gets, and slots are internal:
        flushed values are keyed by metric name either way. The
        presentation cache starts cold (it re-fills on first flush)."""
        self.interval = int(interval)
        self._map.clear()
        self._by_slot = [None] * self.capacity
        for slot, scope, last_interval, name, mtype, tags in entries:
            key = MetricKey(name, mtype, tags)
            self._map[key] = SlotInfo(int(slot), int(last_interval),
                                      int(scope))
            self._by_slot[int(slot)] = key
        used = {info.slot for info in self._map.values()}
        self._free = [s for s in range(self.capacity - 1, -1, -1)
                      if s not in used]

    def advance_interval(self):
        """Called at each flush boundary: ages entries and evicts those
        idle longer than the TTL, returning their slots to the free list."""
        self.interval += 1
        if self.idle_ttl <= 0:
            return
        horizon = self.interval - self.idle_ttl
        if horizon < 0:
            return
        dead = [k for k, info in self._map.items()
                if info.last_interval < horizon]
        adm = self.admission
        for k in dead:
            info = self._map.pop(k)
            self._by_slot[info.slot] = None
            self._free.append(info.slot)
            if adm is not None:
                adm.release_key(k)   # budget follows bank occupancy
