"""Overload defense: cardinality budgets, fold-to-other, backpressure
(the port's copy of veneur_tpu/ingest/admission.py).

Production ingest at millions of users throws traffic shapes the
reference never defended against: a bad deploy minting a unique tag
per request (unbounded bank growth), one hot key absorbing half a
bank, and sustained ingest above flush capacity (silent queue drops).
This module is the admission-control layer between the parser and the
workers:

  * **Per-prefix metric-key budgets.** Every metric key belongs to a
    prefix/tenant (the name up to the first `.`). A prefix may mint at
    most `max_keys_per_prefix` live bank slots; keys beyond the budget
    are FOLDED into that prefix's per-type `__other__` key — itself an
    ordinary mergeable sketch (t-digest / HLL / counter), so degraded
    keys still aggregate correctly fleet-wide when forwarded (the
    UltraLogLog-mergeability stance of arxiv 2308.16862: degrade into
    something that still merges, never into a lossy scalar). The
    number of tracked prefixes is itself budgeted
    (`max_prefixes`); beyond it, new prefixes fold into one global
    `__other__` key.
  * **Huffman-Bucket cardinality estimator** (arxiv 2603.10930): a
    per-prefix m-bucket register array — one O(1) hash+max per
    distinct key, one O(m) pass per estimate, mergeable by
    elementwise max — so a tag-cardinality explosion is *detected*
    (and reported via `/debug/flush` and
    `veneur.overload.keys_over_budget_total`) at a fixed m bytes per
    prefix, no matter how many keys the storm mints.
  * **Backpressure / adaptive sampling.** When the flush tick overruns
    the interval (the flight-recorder tick duration is the
    signal) or worker queues saturate, the governor multiplicatively
    drops its packet admission rate; the server sheds whole packets
    pre-parse at that rate (cheapest possible shed — no parse, no
    queue) and rate-corrects the surviving counter/timer/histogram
    samples (`sample_rate *= rate`, so flushed totals stay unbiased).
    Healthy ticks recover the rate multiplicatively back to 1.0.

Every degradation decision is *counted* through the owning Server's
TelemetryRegistry (`veneur.overload.*`): never silent drops, never
OOM: a drop verdict (`return None`) in any admit*/fold*/shed* decision
function here increments a registry counter in the same branch.

Placement note: budget enforcement hooks the KeyInterner's slot
*allocation* path (models/worker.py) rather than the per-sample parse
path — a key already holding a slot pays literally zero admission
cost (the interner map hit it already pays). The packet-level governor
check is per-datagram, amortized across its lines.
"""

from __future__ import annotations

import math
import random
import threading

from ..observe.registry import SERVER_SCOPE
from ..utils.hashing import fmix64, metric_digest
from .parser import GLOBAL_ONLY, LOCAL_ONLY, MetricKey, UDPMetric

_M64 = 0xFFFFFFFFFFFFFFFF

# sample kinds whose weights are rate-correctable (weight = 1/rate):
# thinning is statistically lossless for these. Gauges (last-write-
# wins) and sets (distinct counts) cannot be corrected and are never
# fold-sampled; under packet-level shed they are lost WITH the packet,
# counted in shed_packets.
RATE_CORRECTED_TYPES = frozenset(("counter", "timer", "histogram"))


def estimate_registers(regs) -> float:
    """Cardinality estimate from a register array (or an immutable
    bytes snapshot of one — debug_state estimates outside the
    controller lock). Linear counting only in its small-range regime
    (estimate <= 2.5m): past that, a single surviving zero register
    would cap the result at m*ln(m) however large the true count."""
    m = len(regs)
    zeros = 0
    inv_sum = 0.0
    for r in regs:
        if r == 0:
            zeros += 1
        inv_sum += 2.0 ** -r
    if zeros:
        lc = m * math.log(m / zeros)
        if lc <= 2.5 * m:
            return lc
    alpha = 0.7213 / (1.0 + 1.079 / m)
    return alpha * m * m / inv_sum


class HuffmanBucketSketch:
    """Bucketed max-rank cardinality estimator (arxiv 2603.10930's
    bucket-array shape): m u8 registers, update = hash -> bucket gets
    max(register, leading-zero rank), estimate = one O(m) harmonic-mean
    pass with a linear-counting small-range correction, merge =
    elementwise max. The point is the cost profile — O(1) update, m
    bytes of state, O(m) estimate — not tail precision: at m=256 the
    relative error is ~6.5%, plenty to tell "10x over budget" from
    steady state."""

    __slots__ = ("m", "_shift", "regs")

    def __init__(self, m: int = 256):
        if m & (m - 1) or m < 16:
            raise ValueError("sketch buckets must be a power of two >= 16")
        self.m = m
        self._shift = 64 - (m.bit_length() - 1)
        self.regs = bytearray(m)

    def update(self, h64: int) -> bool:
        """Fold one 64-bit hash in; True iff a register grew (the cheap
        proxy for 'a key pattern this window has not seen')."""
        b = (h64 >> self._shift) & (self.m - 1)
        rest = (h64 << (64 - self._shift)) & _M64 | (1 << (64 - self._shift)) - 1
        rho = 65 - rest.bit_length()
        if rho > self.regs[b]:
            self.regs[b] = rho
            return True
        return False

    def estimate(self) -> float:
        return estimate_registers(self.regs)

    def merge(self, other: "HuffmanBucketSketch"):
        for i, r in enumerate(other.regs):
            if r > self.regs[i]:
                self.regs[i] = r

    def reset(self):
        self.regs = bytearray(self.m)


class _PrefixState:
    __slots__ = ("admitted", "sketch", "fold_name")

    def __init__(self, fold_name: str, sketch_buckets: int):
        self.admitted = 0                 # live interned keys (budget use)
        self.sketch = HuffmanBucketSketch(sketch_buckets)
        self.fold_name = fold_name        # this prefix's fold target


class AdmissionController:
    """One per Server, shared by every engine's KeyInterners. Hot-path
    contract: an interner map HIT never reaches this object; only slot
    allocation (admit_key / release_key) and over-budget samples
    (fold_metric) do, plus one per-datagram governor check
    (shed_rate / admit_packet) on the server's ingest path."""

    def __init__(self, *, registry,
                 max_keys_per_prefix: int = 65536,
                 max_prefixes: int = 4096,
                 prefix_separator: str = ".",
                 other_suffix: str = "__other__",
                 fold_sample_rate: float = 1.0,
                 min_sample_rate: float = 0.05,
                 tick_overrun_ratio: float = 0.8,
                 queue_high_watermark: float = 0.75,
                 estimator_window_intervals: int = 64,
                 sketch_buckets: int = 256,
                 rng: random.Random | None = None):
        self._tel = registry
        self.max_keys_per_prefix = int(max_keys_per_prefix)
        self.max_prefixes = int(max_prefixes)
        self._sep = prefix_separator
        self._suffix = other_suffix
        self.fold_sample_rate = float(fold_sample_rate)
        self.min_sample_rate = float(min_sample_rate)
        self.tick_overrun_ratio = float(tick_overrun_ratio)
        self.queue_high_watermark = float(queue_high_watermark)
        self.estimator_window = int(estimator_window_intervals)
        self._sketch_m = int(sketch_buckets)
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._prefixes: dict[str, _PrefixState] = {}
        # the global fold target for keys of over-budget PREFIXES
        self._overflow = _PrefixState(other_suffix, sketch_buckets)
        # fold keys this controller minted: admitted without consuming
        # budget and skipped by release_key. Bounded by
        # (max_prefixes + 1) x metric types. An adversary NAMING a
        # metric "<p>.__other__" is not here, so it just spends its
        # prefix's budget like any other key (and, over budget, merges
        # into the genuine fold key — harmless by construction).
        self._minted: set[MetricKey] = set()
        self._fold_cache: dict[tuple[str, str], tuple[MetricKey, int]] = {}
        # backpressure governor state. shed_rate is read lock-free on
        # the packet hot path (a torn read of a float is impossible in
        # CPython; staleness of one packet is harmless).
        self.shed_rate = 1.0
        self._ticks = 0
        self._last = {"folded": 0, "sampled_out": 0, "shed": 0,
                      "over_budget": 0}

    # ------------- engaged? -------------

    @property
    def engaged(self) -> bool:
        return self.shed_rate < 1.0

    # ------------- packet-level backpressure (server ingest path) ----

    def admit_packet(self):
        """One datagram's shed decision under the adaptive rate. True =
        process it; None = shed (counted). Only called when
        shed_rate < 1.0 (the caller's one-branch fast gate)."""
        if self._rng.random() < self.shed_rate:
            return True
        self._tel.incr(SERVER_SCOPE, "overload.shed_packets")
        return None

    # ------------- key-level budgets (interner allocation path) ------

    def _prefix_of(self, name: str) -> str:
        return name.partition(self._sep)[0]

    def admit_key(self, key: MetricKey):
        """Budget verdict for a key about to mint a bank slot: True =
        admit (budget consumed — the interner calls release_key if the
        allocation then fails), None = fold into the prefix's
        `__other__` key instead. One call per key per interner
        lifetime for in-budget keys; per sample for over-budget keys
        (their samples keep missing the interner map)."""
        with self._lock:
            if key in self._minted:
                return True               # our own fold keys ride free
            prefix = self._prefix_of(key.name)
            st = self._prefixes.get(prefix)
            if st is None:
                if len(self._prefixes) >= self.max_prefixes:
                    st = self._overflow
                else:
                    st = _PrefixState(
                        prefix + self._sep + self._suffix, self._sketch_m)
                    self._prefixes[prefix] = st
            changed = st.sketch.update(fmix64(hash(key) & _M64))
            if st.admitted >= self.max_keys_per_prefix:
                if changed:
                    # estimator-gated: counts (approximately) DISTINCT
                    # over-budget keys, not their per-sample traffic —
                    # folded_samples carries the volume
                    self._tel.incr(SERVER_SCOPE,
                                   "overload.keys_over_budget")
                return None
            st.admitted += 1
            return True

    def release_key(self, key: MetricKey):
        """A previously admitted key left its interner (idle eviction,
        or the allocation it was admitted for failed): return its
        budget slot."""
        with self._lock:
            if key in self._minted:
                return
            st = self._prefixes.get(self._prefix_of(key.name))
            if st is None:
                st = self._overflow
            if st.admitted > 0:
                st.admitted -= 1

    def _fold_key(self, key: MetricKey,
                  local: bool = False) -> tuple[MetricKey, int]:
        """The (cached) fold target for an over-budget key: the
        per-(prefix, type) `__other__` key, tagless so every shard and
        every sender in the fleet folds into the SAME mergeable key.
        `local` selects the `.local` twin — the fold target for
        veneurlocalonly samples, which must never leave the host (it
        needs no fleet mergeability precisely because it never
        forwards) and must not share a slot with forwarded folds (a
        slot's scope is per-key, not per-sample).

        The fast path is LOCK-FREE: both dicts only ever gain entries,
        their values are immutable tuples, and CPython dict reads are
        atomic under the GIL — so the per-sample cost of a sustained
        fold storm is one dict hit, not a controller-lock acquisition
        per worker thread. A racing miss just takes the locked path."""
        st = self._prefixes.get(self._prefix_of(key.name))
        fold_name = st.fold_name if st is not None \
            else self._overflow.fold_name
        if local:
            fold_name = fold_name + self._sep + "local"
        ck = (fold_name, key.type)
        cached = self._fold_cache.get(ck)
        if cached is not None:
            return cached
        with self._lock:
            cached = self._fold_cache.get(ck)
            if cached is None:
                fk = MetricKey(fold_name, key.type, "")
                cached = (fk, metric_digest(fold_name, key.type, ""))
                self._fold_cache[ck] = cached
                self._minted.add(fk)
            return cached

    def fold_metric(self, m: UDPMetric, fwd_out: bool):
        """Rewrite one over-budget sample onto its fold key. The fold
        is SAMPLED for rate-correctable kinds (fold_sample_rate):
        survivors carry `sample_rate *= fold_sample_rate`, so the
        folded counter totals / histogram weights stay unbiased while
        the hot `__other__` slot's ingest cost is bounded. Returns the
        folded UDPMetric, or None when this sample was sampled out
        (counted). The folded_samples counter is NOT incremented here:
        the engine calls count_folded() once the rewrite actually
        leaves for its fold slot (landed locally or re-routed to its
        home engine) — a rewrite the bank then refuses must count as
        the bank drop it is, not as a fold.

        Scope policy: on a forwarding server (`fwd_out`) folds ride to
        the global tier as GLOBAL_ONLY so the fleet's `__other__` rows
        merge there — EXCEPT veneurlocalonly samples, whose values
        must never leave the host: those keep LOCAL_ONLY and fold into
        the prefix's `.local` twin key, so a forwarded fold slot never
        carries (or retroactively rescopes to) local-only data."""
        rate = self.fold_sample_rate
        sample_rate = m.sample_rate
        if rate < 1.0 and m.key.type in RATE_CORRECTED_TYPES:
            if self._rng.random() >= rate:
                self._tel.incr(SERVER_SCOPE, "overload.fold_sampled_out")
                return None
            sample_rate = max(sample_rate * rate, 1e-9)
        local = m.scope == LOCAL_ONLY
        scope = m.scope if (local or not fwd_out) else GLOBAL_ONLY
        fk, digest = self._fold_key(m.key, local)
        return UDPMetric(key=fk, digest=digest, value=m.value,
                         sample_rate=sample_rate, scope=scope, tags=[])

    def fold_key(self, key: MetricKey) -> tuple[MetricKey, int]:
        """(fold target, routing digest) for an over-budget IMPORTED
        metric (the global tier's Combine path — no sampling: a
        forwarded digest is an interval aggregate, not a sample). The
        caller counts via count_folded() once the fold actually goes
        somewhere."""
        return self._fold_key(key)

    def count_folded(self, n: int = 1):
        """One sample (or imported aggregate) was redirected onto its
        fold key — landed in a local slot or re-routed to the fold
        key's home engine. Redirects that later drop (full queue, full
        bank) are counted by the normal worker.dropped /
        dropped_no_slot accounting, like any routed sample."""
        self._tel.incr(SERVER_SCOPE, "overload.folded_samples", n)

    # ------------- governor (flush-tick boundary) -------------

    def on_tick(self, elapsed_s: float, interval_s: float,
                queue_fill: float) -> dict:
        """Adapt the shed rate from this tick's overload signals: the
        tick's wall duration (the flight recorder's tick span) against
        the flush interval, and the worst worker-queue fill fraction.
        Multiplicative decrease under overload, multiplicative
        recovery toward 1.0 when healthy. Also rolls the estimator
        window. Returns this interval's degradation deltas for the
        tick's phase record."""
        overloaded = (
            interval_s > 0
            and elapsed_s > self.tick_overrun_ratio * interval_s
        ) or queue_fill >= self.queue_high_watermark
        if overloaded:
            self.shed_rate = max(self.min_sample_rate,
                                 self.shed_rate * 0.5)
        elif self.shed_rate < 1.0:
            self.shed_rate = min(1.0, self.shed_rate * 1.6)
        with self._lock:
            self._ticks += 1
            if self.estimator_window > 0 and \
                    self._ticks % self.estimator_window == 0:
                for st in self._prefixes.values():
                    st.sketch.reset()
                self._overflow.sketch.reset()
        tel = self._tel
        cum = {
            "folded": tel.total(SERVER_SCOPE, "overload.folded_samples"),
            "sampled_out": tel.total(SERVER_SCOPE,
                                     "overload.fold_sampled_out"),
            "shed": tel.total(SERVER_SCOPE, "overload.shed_packets"),
            "over_budget": tel.total(SERVER_SCOPE,
                                     "overload.keys_over_budget"),
        }
        delta = {k: cum[k] - self._last[k] for k in cum}
        self._last = cum
        delta["rate"] = self.shed_rate
        delta["overloaded"] = overloaded
        return delta

    # ------------- introspection -------------

    def export_sketches(self) -> list:
        """[(prefix, bytes registers)] snapshots of the per-prefix
        cardinality sketches — the forward-wire rows the global tier
        merges by max (fleet-wide cardinality).
        Cheap: one bytes() copy per prefix under the lock."""
        with self._lock:
            out = [(p, bytes(st.sketch.regs))
                   for p, st in self._prefixes.items()]
            if any(self._overflow.sketch.regs):
                out.append((self._suffix, bytes(self._overflow.sketch.regs)))
            return out

    def prefix_count(self) -> int:
        with self._lock:
            return len(self._prefixes)

    def debug_state(self, top: int = 20) -> dict:
        """JSON-ready admission state for GET /debug/flush: budgets,
        the governor, and the top prefixes by estimated cardinality
        (admitted vs estimate is the explosion signature)."""
        tel = self._tel
        # Snapshot (prefix, admitted, regs-bytes) under the lock; the
        # O(m)-per-prefix estimates run AFTER release — admit_key/
        # release_key on the storm's hot path must never wait out a
        # /debug/flush scrape of thousands of prefixes.
        with self._lock:
            snap = [(p, st.admitted, bytes(st.sketch.regs))
                    for p, st in self._prefixes.items()]
            overflow_adm = self._overflow.admitted
            overflow_regs = bytes(self._overflow.sketch.regs)
            nprefix = len(snap)
        rows = [
            {"prefix": p, "admitted": admitted,
             "estimated_keys": round(estimate_registers(regs), 1),
             "over_budget": admitted >= self.max_keys_per_prefix}
            for p, admitted, regs in snap
        ]
        overflow_est = round(estimate_registers(overflow_regs), 1)
        rows.sort(key=lambda r: -r["estimated_keys"])
        return {
            "enabled": True,
            "adaptive_sample_rate": self.shed_rate,
            "engaged": self.engaged,
            "fold_sample_rate": self.fold_sample_rate,
            "max_keys_per_prefix": self.max_keys_per_prefix,
            "max_prefixes": self.max_prefixes,
            "prefix_count": nprefix,
            "prefixes": rows[:top],
            "overflow": {"admitted": overflow_adm,
                         "estimated_keys": overflow_est},
            "counters": {
                "folded_samples": tel.total(
                    SERVER_SCOPE, "overload.folded_samples"),
                "fold_sampled_out": tel.total(
                    SERVER_SCOPE, "overload.fold_sampled_out"),
                "keys_over_budget": tel.total(
                    SERVER_SCOPE, "overload.keys_over_budget"),
                "shed_packets": tel.total(
                    SERVER_SCOPE, "overload.shed_packets"),
            },
        }


def from_config(cfg, registry) -> AdmissionController:
    """Build the Server's controller from the overload_* config keys."""
    return AdmissionController(
        registry=registry,
        max_keys_per_prefix=cfg.overload_max_keys_per_prefix,
        max_prefixes=cfg.overload_max_prefixes,
        prefix_separator=cfg.overload_prefix_separator,
        other_suffix=cfg.overload_other_suffix,
        fold_sample_rate=cfg.overload_fold_sample_rate,
        min_sample_rate=cfg.overload_min_sample_rate,
        tick_overrun_ratio=cfg.overload_tick_overrun_ratio,
        queue_high_watermark=cfg.overload_queue_high_watermark,
        estimator_window_intervals=cfg.overload_estimator_window_intervals,
        sketch_buckets=cfg.overload_sketch_buckets,
    )
