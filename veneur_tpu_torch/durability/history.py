"""Time-travel query tier: serve historical percentiles and
cardinalities from the durability journal — the port's copy of
veneur_tpu/durability/history.py, over the port's AggregationEngine.

The durability subsystem already persists everything a "what was p99 of
`api.latency` at 14:03 yesterday" answer needs: flush-boundary engine
delta checkpoints and write-ahead import ops, over sketch
engines whose merge is bit-commutative — t-digest/REQ
mergeability is exactly what makes cross-interval quantile composition
sound (arxiv 1902.04023 / 2511.17396). This module turns that
crash-safety byte stream into an operator-facing read tier with zero
new write-path information: every byte a query reads was already being
written.

Two halves:

`HistoryStore` — RETENTION. One closed flush interval = one GENERATION:
a self-contained segment file holding the interval's identity record
(REC_HISTORY_META: close wall time, open edge, per-engine RETIRE
watermarks — the op ids the flush swap actually carried), the PREVIOUS
boundary's checkpoint groups (the interval's baseline: banks are
interval-scoped, so `baseline + the interval's ops` IS the interval's
journal-visible flushed state), and the interval's write-ahead import
ops. Segments publish atomically (write-temp/fsync/rename via
journal.write_framed_file — the raw I/O stays single-homed in
journal.py) and COMMIT by appearing in the manifest,
itself rewritten atomically — a crash at any point leaves a consistent
committed prefix, orphan files are swept at open. Pruning (by
generation count and by age against the NEWEST close stamp, so
scripted clocks stay scripted) rewrites the manifest first and only
then unlinks; a generation a running query holds a LEASE on is
deferred, never yanked mid-read.

`QueryTier` — the READ PATH. `GET /query?metric=&q=&t0=&t1=` resolves
the covering generations, reconstructs each one into a SCRATCH
AggregationEngine — a fresh engine from the factory, private interner,
restored through the same `restore_checkpoint` + `import_list` surface
crash recovery uses (per-engine replay cut: baseline watermark < op_id
<= retire watermark), never the live pipeline's banks — then merges
the matched rows across intervals through the engine contract (the
import-landing path routes into merge_centroids / the compactor's
direct re-insert / the set lattice join) inside a single-use MERGE
engine whose configured percentiles are the requested quantiles, and
reads the answers off its flush frame. Counters bypass the wire's
int64 rounding and merge as exact f64 on host. Queries run on a
dedicated executor with a bounded result cache keyed on
(metric, window, generation-range); the query path acquires no live
engine lock and surfaces as
flight-recorder phases `query>query.{resolve,restore,merge,estimate}`
plus `veneur.query.*` self-metrics.

Documented gaps: UDP samples that
landed between checkpoints are not journaled and therefore not
reconstructable (import-path data is exact); LOCAL_ONLY-scoped keys
never export; gauges (last-write-wins) are not served; mesh/native
engines are excluded from durability entirely.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass

from . import journal, records

log = logging.getLogger("veneur_tpu_torch.durability.history")

SEG_MAGIC = b"VTPUHSG1"
MAN_MAGIC = b"VTPUHMN1"

# result tokens a q= spec may name besides numeric quantiles
SCALAR_TOKENS = ("count", "sum", "min", "max", "avg")
HIST_TYPES = ("histogram", "timer")


class HistoryCorrupt(Exception):
    """A committed generation's segment failed validation at read time
    (bit flip under the manifest's feet). Queries touching it fail
    LOUDLY — the tier never silently invents or omits an interval."""


class QueryError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


@dataclass(frozen=True)
class GenerationEntry:
    """One committed generation as the manifest lists it."""
    gen: int
    close_ns: int
    prev_close_ns: int
    nbytes: int
    path: str


def collect_checkpoint_groups(recs):
    """Walk REC_ENGINE_* records into committed checkpoint groups —
    the ONE home of the COMMIT discipline, shared by crash recovery
    (Server._recover_engine_state) and the query tier's generation
    reconstruction, so the two can never drift: a group's META/KEYS/
    BANK/STAGED frames only count once its COMMIT arrived (a torn
    group restored anyway would be silent data loss). BANK payloads
    stay ENCODED here (their leaf order is engine-aware; each caller
    decodes against its own engines). Returns (groups: {engine_idx:
    group}, ops: [encoded ENGINE_IMPORT payloads], torn: uncommitted
    group count, errors: undecodable record count)."""
    latest: dict[int, dict] = {}
    pending: dict[int, dict] = {}
    ops: list = []
    errors = 0
    for rec_type, payload in recs:
        try:
            if rec_type == records.REC_ENGINE_IMPORT:
                ops.append(payload)
            elif rec_type == records.REC_ENGINE_META:
                idx, n_eng, wm, gseq, fpr = \
                    records.decode_engine_meta(payload)
                pending[idx] = {"meta": (n_eng, wm, gseq, fpr),
                                "keys": {}, "banks": [], "staged": {}}
            elif rec_type == records.REC_ENGINE_KEYS:
                idx, kind, interval, entries = \
                    records.decode_engine_keys(payload)
                if idx in pending:
                    pending[idx]["keys"][kind] = (interval, entries)
            elif rec_type == records.REC_ENGINE_BANK:
                idx, kind, _n = records._ENG_BANK_HEAD.unpack_from(
                    payload, 0)
                if idx in pending:
                    pending[idx]["banks"].append(payload)
            elif rec_type == records.REC_ENGINE_STAGED:
                idx, staged = records.decode_engine_staged(payload)
                if idx in pending:
                    pending[idx]["staged"] = staged
            elif rec_type == records.REC_ENGINE_COMMIT:
                idx = records.decode_engine_commit(payload)
                if idx in pending:
                    latest[idx] = pending.pop(idx)
        except Exception:
            errors += 1
    return latest, ops, len(pending), errors


class HistoryStore:
    """The retention half: committed checkpoint generations, indexed by
    interval-close wall time in a small on-disk manifest, pruned
    atomically, leased while queries read them. Appends happen on the
    flusher thread; resolve/load/release on query executor threads —
    one lock covers the in-memory index and lease table (file reads
    run outside it)."""

    def __init__(self, directory: str,
                 retention_generations: int = 64,
                 retention_seconds: float = 0.0,
                 fsync: bool = True, registry=None,
                 scope: str = "_server",
                 name: str = "engine.history"):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.name = name
        self.retention_generations = max(1, int(retention_generations))
        self.retention_seconds = float(retention_seconds)
        self._fsync = fsync
        if registry is None:
            from ..observe.registry import DEFAULT_REGISTRY
            registry = DEFAULT_REGISTRY
        self._registry = registry
        self._scope = scope
        self._lock = threading.Lock()
        self._entries: list[GenerationEntry] = []
        self._leases: dict[int, int] = {}
        self._deferred: dict[int, str] = {}   # pruned-but-leased gens
        self._next_gen = 1
        self._load()

    # ------------------------------------------------------------ files

    def _seg_path(self, gen: int) -> str:
        return os.path.join(self.directory,
                            f"{self.name}.{gen:016d}.seg")

    def _man_path(self) -> str:
        return os.path.join(self.directory, self.name + ".manifest")

    def _count(self, counter: str, n: int = 1):
        self._registry.incr(self._scope, counter, n)

    def _load(self):
        """Recover the committed set: manifest rows whose segment files
        validate end to end (header magic, every frame CRC-good, the
        identity record first). Torn manifests truncate to the last
        good row; rows whose segment is missing/torn are dropped
        (counted, loud) — the committed prefix survives bit-exact.
        Orphan segments/temps (crash between segment publish and
        manifest commit, or a deferred unlink that never ran) are
        swept. Never raises."""
        recs, man_gen, _end, torn = journal.read_framed_file(
            self._man_path(), MAN_MAGIC)
        if torn:
            self._count("durability.history_truncated")
            log.warning("history: torn manifest %s; recovering the "
                        "committed prefix", self._man_path())
        entries = []
        for rec_type, payload in recs:
            if rec_type != records.REC_HISTORY_INDEX:
                continue
            try:
                gen, close_ns, prev_close_ns, nbytes = \
                    records.decode_history_index(payload)
            except Exception:
                self._count("durability.history_truncated")
                continue
            if nbytes == 0:
                # empty generation (coalesced idle window): a manifest
                # row is its whole existence — nothing to validate
                entries.append(GenerationEntry(gen, close_ns,
                                               prev_close_ns, 0, ""))
                continue
            path = self._seg_path(gen)
            if not self._segment_valid(path, gen):
                self._count("durability.history_dropped_generations")
                log.warning(
                    "history: generation %d segment %s missing or "
                    "corrupt; dropping it from the committed set",
                    gen, path)
                continue
            entries.append(GenerationEntry(gen, close_ns, prev_close_ns,
                                           nbytes, path))
        entries.sort(key=lambda e: e.gen)
        self._entries = entries
        self._next_gen = max([man_gen] + [e.gen for e in entries]
                             + [0]) + 1
        known = {os.path.basename(e.path) for e in entries}
        prefix = self.name + "."
        for fn in os.listdir(self.directory):
            if not fn.startswith(prefix):
                continue
            if fn.endswith(".tmp") or (fn.endswith(".seg")
                                       and fn not in known):
                try:
                    os.unlink(os.path.join(self.directory, fn))
                except OSError:
                    pass

    def _segment_valid(self, path: str, gen: int) -> bool:
        """Full read validation (every frame CRC-checked): the open-
        time gate behind 'queries answer only from committed
        generations'."""
        recs, g, _end, torn = journal.read_framed_file(path, SEG_MAGIC)
        return (g == gen and not torn and bool(recs)
                and recs[0][0] == records.REC_HISTORY_META)

    # ---------------------------------------------------------- writes

    def append(self, close_ns: int, prev_close_ns: int, retire_wms,
               baseline_recs, op_recs) -> int:
        """Seal one closed interval as a generation: publish the
        segment atomically, then commit it (and any prune) with one
        atomic manifest rewrite. `baseline_recs` is the PREVIOUS
        boundary's checkpoint record group list; `op_recs` is
        [(op_id, encoded ENGINE_IMPORT payload)] for the interval.
        Called on the flusher thread only (single appender) — the
        lock guards just the in-memory index/lease state shared with
        query threads, so every write+fsync runs OUTSIDE it and a
        slow disk never stalls acquire/release/debug reads."""
        with self._lock:
            gen = self._next_gen
            self._next_gen += 1
        op_ids = [i for i, _p in op_recs]
        meta = records.encode_history_meta(
            gen, close_ns, prev_close_ns, retire_wms,
            min(op_ids) if op_ids else 0,
            max(op_ids) if op_ids else 0)
        recs = [(records.REC_HISTORY_META, meta)]
        recs.extend(baseline_recs)
        recs.extend((records.REC_ENGINE_IMPORT, p)
                    for _i, p in op_recs)
        path = self._seg_path(gen)
        nbytes = journal.write_framed_file(
            path, SEG_MAGIC, gen, recs, fsync=self._fsync)
        with self._lock:
            self._entries.append(GenerationEntry(
                gen, int(close_ns), int(prev_close_ns), nbytes, path))
            dropped = self._prune_locked()
            rows, man_gen = self._manifest_rows_locked()
        self._write_manifest(rows, man_gen)
        # manifest committed: only now do pruned files go away (the
        # lease check runs under the lock; the unlinks themselves are
        # cheap and crash-safe — an orphan is swept at next open)
        with self._lock:
            self._unlink_locked(dropped)
        return gen

    def append_empty(self, close_ns: int, prev_close_ns: int) -> int:
        """Seal a provably-EMPTY interval (fresh baseline, no ops) as
        a zero-cost generation: a manifest row only, no segment file —
        and CONSECUTIVE empty intervals coalesce into one row whose
        close stamp extends (empty + empty = empty, so widening an
        empty generation's window is sound; widening a DATA
        generation's would claim its data for time it doesn't cover).
        An idle import tier therefore pays one small manifest rewrite
        per tick instead of a segment + manifest + ~5 fsyncs, and a
        long idle stretch consumes ONE retention slot instead of
        evicting the generations that hold data. Queries over the
        window still resolve (and answer empty) rather than 404."""
        with self._lock:
            if self._entries and self._entries[-1].nbytes == 0:
                last = self._entries[-1]
                self._entries[-1] = GenerationEntry(
                    last.gen, int(close_ns), last.prev_close_ns, 0, "")
                gen = last.gen
            else:
                gen = self._next_gen
                self._next_gen += 1
                self._entries.append(GenerationEntry(
                    gen, int(close_ns), int(prev_close_ns), 0, ""))
            # prune on BOTH branches: the widened close stamp advances
            # the age floor, so an idle stretch must keep retiring the
            # data generations that age out under it
            dropped = self._prune_locked()
            rows, man_gen = self._manifest_rows_locked()
        self._write_manifest(rows, man_gen)
        with self._lock:
            self._unlink_locked(dropped)
        return gen

    def _prune_locked(self) -> list:
        """Apply both retention bounds; returns the dropped entries
        whose files may be unlinked AFTER the manifest commit. Age is
        measured against the NEWEST generation's close stamp (flush
        timestamps), so scripted clocks prune deterministically."""
        keep = self._entries
        if self.retention_seconds > 0 and keep:
            floor = keep[-1].close_ns \
                - int(self.retention_seconds * 1e9)
            aged = [e for e in keep if e.close_ns < floor]
            keep = [e for e in keep if e.close_ns >= floor]
        else:
            aged = []
        over = len(keep) - self.retention_generations
        dropped = aged + keep[:max(0, over)]
        self._entries = keep[max(0, over):]
        if dropped:
            self._count("durability.history_pruned", len(dropped))
        return dropped

    def _unlink_locked(self, dropped):
        for e in dropped:
            if not e.path:
                continue        # empty generation: no file to remove
            if self._leases.get(e.gen):
                # a running query holds this generation: defer the
                # unlink to its release — pruning never yanks a leased
                # segment mid-read
                self._deferred[e.gen] = e.path
                continue
            try:
                os.unlink(e.path)
            except OSError:
                pass

    def _manifest_rows_locked(self):
        """Snapshot (manifest rows, manifest generation) under the
        lock; the atomic write happens outside it."""
        rows = [(records.REC_HISTORY_INDEX,
                 records.encode_history_index(
                     e.gen, e.close_ns, e.prev_close_ns, e.nbytes))
                for e in self._entries]
        return rows, self._next_gen - 1

    def _write_manifest(self, rows, man_gen):
        journal.write_framed_file(self._man_path(), MAN_MAGIC,
                                  man_gen, rows, fsync=self._fsync)

    # ----------------------------------------------------------- reads

    def acquire(self, t0_ns: int, t1_ns: int) -> list:
        """Generations whose interval (prev_close, close] overlaps
        [t0, t1], lease-held until release() — prune defers their
        unlink while the lease lives."""
        with self._lock:
            out = [e for e in self._entries
                   if e.close_ns >= t0_ns and e.prev_close_ns < t1_ns]
            for e in out:
                self._leases[e.gen] = self._leases.get(e.gen, 0) + 1
            return out

    def release(self, entries):
        with self._lock:
            for e in entries:
                n = self._leases.get(e.gen, 0) - 1
                if n > 0:
                    self._leases[e.gen] = n
                    continue
                self._leases.pop(e.gen, None)
                path = self._deferred.pop(e.gen, None)
                if path is not None:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass

    def load(self, entry: GenerationEntry):
        """Read + parse one generation's segment: (meta tuple, groups
        {engine_idx: group with ENCODED bank payloads}, ops
        [ENGINE_IMPORT payloads]). Raises HistoryCorrupt on any
        validation failure — a bit-flipped generation fails the query
        loudly, it never silently drops an interval from the answer."""
        if entry.nbytes == 0:
            # empty generation: its window is claimed, its content is
            # nothing (fresh baseline + zero ops)
            return ((entry.gen, entry.close_ns, entry.prev_close_ns,
                     [], 0, 0), {}, [])
        recs, gen, _end, torn = journal.read_framed_file(entry.path,
                                                         SEG_MAGIC)
        if torn or gen != entry.gen or not recs \
                or recs[0][0] != records.REC_HISTORY_META:
            self._count("durability.history_dropped_generations")
            raise HistoryCorrupt(
                f"generation {entry.gen} segment failed validation")
        meta = records.decode_history_meta(recs[0][1])
        groups, ops, torn_groups, errors = \
            collect_checkpoint_groups(recs[1:])
        if torn_groups or errors:
            self._count("durability.history_dropped_generations")
            raise HistoryCorrupt(
                f"generation {entry.gen}: {torn_groups} torn baseline "
                f"group(s), {errors} undecodable record(s)")
        return meta, groups, ops

    # ----------------------------------------------------------- intro

    def entries(self) -> list:
        with self._lock:
            return list(self._entries)

    def debug_state(self) -> dict:
        with self._lock:
            es = self._entries
            return {
                "generations": len(es),
                "bytes": sum(e.nbytes for e in es),
                "oldest_close_ns": es[0].close_ns if es else None,
                "newest_close_ns": es[-1].close_ns if es else None,
                "first_gen": es[0].gen if es else None,
                "last_gen": es[-1].gen if es else None,
                "leases": sum(self._leases.values()),
                "deferred_unlinks": len(self._deferred),
                "retention_generations": self.retention_generations,
                "retention_seconds": self.retention_seconds,
            }


# --------------------------------------------------------------- query


def _pct_label(q: float) -> str:
    """The flush frame's percentile suffix for q — MUST mirror the
    pipeline's `f".{p * 100:g}percentile"` presentation."""
    return f"{q * 100:g}"


def parse_qspec(raw: str):
    """q= spec -> (sorted unique quantiles, scalar tokens, want_card,
    want_counter). Tokens: floats in (0,1) are quantiles; count/sum/
    min/max/avg are histogram scalars; `cardinality` the set estimate;
    `value` the counter total. Raises QueryError(400) on junk."""
    quantiles: list[float] = []
    scalars: list[str] = []
    want_card = want_counter = False
    for tok in (t.strip() for t in raw.split(",")):
        if not tok:
            continue
        if tok == "cardinality":
            want_card = True
            continue
        if tok == "value":
            want_counter = True
            continue
        if tok in SCALAR_TOKENS:
            scalars.append(tok)
            continue
        try:
            q = float(tok)
        except ValueError:
            raise QueryError(
                400, f"unknown q token {tok!r} (want a quantile in "
                     "(0,1), count/sum/min/max/avg, cardinality, or "
                     "value)") from None
        if not (0.0 < q < 1.0) or not math.isfinite(q):
            raise QueryError(400, f"quantile {tok!r} out of (0, 1)")
        quantiles.append(q)
    if not (quantiles or scalars or want_card or want_counter):
        raise QueryError(400, "q= names nothing to compute")
    return tuple(sorted(set(quantiles))), tuple(scalars), \
        want_card, want_counter


class QueryTier:
    """The read half: scratch-engine reconstruction + cross-interval
    merge + estimate, on a dedicated executor, behind a bounded result
    cache. Holds NO reference to the live pipeline — engines come from
    `engine_factory(percentiles=, aggregates=, merge=)`, each a fresh
    AggregationEngine with a private interner (this module never
    touches an engine lock or bank)."""

    def __init__(self, store: HistoryStore, engine_factory,
                 n_engines: int, *, flight=None, registry=None,
                 scope: str = "_server", engines_describe=None,
                 max_concurrent: int = 1, cache_entries: int = 64,
                 timeout_s: float = 30.0, clock=time.time):
        self._store = store
        self._factory = engine_factory
        self._n = max(1, int(n_engines))
        self._flight = flight
        if registry is None:
            from ..observe.registry import DEFAULT_REGISTRY
            registry = DEFAULT_REGISTRY
        self._registry = registry
        self._scope = scope
        self._describe = engines_describe or {}
        self._timeout_s = float(timeout_s)
        self._clock = clock
        self._exec = ThreadPoolExecutor(
            max_workers=max(1, int(max_concurrent)),
            thread_name_prefix="query")
        self._cache_entries = max(0, int(cache_entries))
        self._cache: OrderedDict = OrderedDict()
        self._cache_lock = threading.Lock()
        # per-generation reconstruction cache (metric-independent
        # extractions, keyed by immutable generation id) — what makes
        # a dashboard's second metric over the same window cheap.
        # Sized to the retention window so a full-window scan actually
        # fits (each entry is bounded by one interval's export size)
        self._gen_cache: OrderedDict = OrderedDict()
        self._GEN_CACHE = max(16, store.retention_generations)

    def close(self):
        self._exec.shutdown(wait=False)

    def _count(self, counter: str, n: int = 1):
        self._registry.incr(self._scope, counter, n)

    # ------------------------------------------------------ public API

    def query(self, params: dict) -> dict:
        """Validate + run one query on the executor (the read path is
        isolated from HTTP handler threads and from each other), under
        the tier's wall timeout."""
        self._count("query.requests")
        try:
            spec = self._validate(params)
        except QueryError:
            self._count("query.errors")
            raise
        fut = self._exec.submit(self._run, spec)
        try:
            return fut.result(timeout=self._timeout_s)
        except QueryError:
            self._count("query.errors")
            raise
        except FutureTimeout:
            self._count("query.errors")
            # a RUNNING query cannot be killed (it finishes, releases
            # its leases, and seeds the cache for a retry), but cancel
            # frees any queued-not-started successors so one
            # pathological query doesn't make every waiter behind it
            # burn its own timeout before even starting
            fut.cancel()
            raise QueryError(
                503, f"query timed out after {self._timeout_s:g}s "
                     "(still running on the query executor)") from None
        except HistoryCorrupt as e:
            self._count("query.errors")
            raise QueryError(500, str(e)) from None
        except Exception as e:
            self._count("query.errors")
            log.exception("query failed")
            raise QueryError(500, f"query failed: {e}") from None

    def _validate(self, params: dict) -> dict:
        name = (params.get("metric") or "").strip()
        if not name:
            raise QueryError(400, "metric= is required")
        try:
            t0 = float(params["t0"])
            t1 = float(params["t1"])
        except (KeyError, TypeError, ValueError):
            raise QueryError(
                400, "t0= and t1= are required (epoch seconds)") \
                from None
        if not (t1 > t0):
            raise QueryError(400, "t1 must be > t0")
        quantiles, scalars, want_card, want_counter = \
            parse_qspec(params.get("q") or "")
        mtype = params.get("type")
        if mtype is not None and mtype not in (
                "histogram", "timer", "counter", "set"):
            raise QueryError(
                400, f"type {mtype!r} not queryable (histogram/timer/"
                     "counter/set; gauges are last-write-wins and not "
                     "served from history)")
        tags = params.get("tags")
        if tags:
            # canonicalize to the engine's joined form (sorted,
            # comma-joined — wire.metric_key_of / the parser): a
            # caller's unsorted spelling must match the stored key,
            # not silently return matched_keys=0
            tags = ",".join(sorted(t for t in tags.split(",") if t))
        return {
            "name": name, "t0": t0, "t1": t1,
            "tags": tags, "type": mtype,
            "quantiles": quantiles, "scalars": scalars,
            "want_card": want_card, "want_counter": want_counter,
        }

    # ------------------------------------------------------- execution

    def _run(self, spec: dict) -> dict:
        tick = root = None
        if self._flight is not None:
            tick = self._flight.open_tick(int(self._clock()))
            root = tick.start("query")
        entries = []
        try:
            ph = -1 if tick is None else tick.start("query.resolve",
                                                    root)
            entries = self._store.acquire(int(spec["t0"] * 1e9),
                                          int(spec["t1"] * 1e9))
            if tick is not None:
                tick.finish(ph, generations=len(entries))
            if not entries:
                raise QueryError(
                    404, "no retained generations cover "
                         f"[{spec['t0']:g}, {spec['t1']:g}] — the "
                         "window predates the retention horizon or "
                         "postdates the newest flush")
            self._count("query.generations_scanned", len(entries))
            key = (spec["name"], spec["tags"], spec["type"],
                   spec["quantiles"], spec["scalars"],
                   spec["want_card"], spec["want_counter"],
                   entries[0].gen, entries[-1].gen)
            cached = self._cache_get(key)
            if cached is not None:
                self._count("query.cache_hits")
                out = dict(cached)
                # request-specific metadata is NOT part of the cache
                # key (two windows resolving to the same generation
                # range share one entry) — echo THIS request's, not
                # the first one's
                out["t0"], out["t1"] = spec["t0"], spec["t1"]
                out["cache"] = "hit"
                return out
            out = self._execute(spec, entries, tick, root)
            self._cache_put(key, out)
            out = dict(out)
            out["cache"] = "miss"
            return out
        finally:
            if entries:
                self._store.release(entries)
            if tick is not None:
                tick.finish(root)
                self._flight.end_tick(tick)
                self._flight.adopt(tick)

    def _cache_get(self, key):
        with self._cache_lock:
            v = self._cache.get(key)
            if v is not None:
                self._cache.move_to_end(key)
            return v

    def _cache_put(self, key, value):
        if not self._cache_entries:
            return
        with self._cache_lock:
            self._cache[key] = value
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_entries:
                self._cache.popitem(last=False)

    def _match(self, spec, key, kinds) -> bool:
        if key.name != spec["name"] or key.type not in kinds:
            return False
        if spec["type"] is not None and key.type != spec["type"]:
            return False
        tags = spec["tags"]
        return tags is None or key.joined_tags == tags

    def _engine_indices(self, spec) -> list:
        """The engine groups a query must restore: one, when the exact
        key (type + tags) pins the digest route; else all of them."""
        if spec["type"] is not None and spec["tags"] is not None:
            from ..utils.hashing import metric_digest
            return [metric_digest(spec["name"], spec["type"],
                                  spec["tags"]) % self._n]
        return list(range(self._n))

    def _execute(self, spec, entries, tick, root) -> dict:
        from ..cluster import wire
        from ..ingest.parser import MetricKey

        engine_idxs = self._engine_indices(spec)
        # RESTORE: one journal-visible flushed state per generation,
        # via the recovery-restore path into scratch engines
        ph = -1 if tick is None else tick.start("query.restore", root)
        exts = [self._reconstruct(e, engine_idxs) for e in entries]
        if tick is not None:
            tick.finish(ph, generations=len(entries),
                        engines=len(engine_idxs))

        # MERGE: matched rows from every interval land in ONE merge
        # engine through the import contract (merge_centroids / direct
        # compactor re-insert / set lattice join); tag variants
        # canonicalize onto one untagged key so the answer aggregates
        # across them; counters merge as exact f64 on host (the wire
        # row rounds them to int64)
        ph = -1 if tick is None else tick.start("query.merge", root)
        quantiles = spec["quantiles"] or (0.5,)
        merge_eng = self._factory(percentiles=quantiles,
                                  aggregates=("min", "max", "sum",
                                              "count", "avg"),
                                  merge=True)
        matched: set = set()
        counter_total = 0.0
        hkey = MetricKey(spec["name"], "histogram", "")
        skey = MetricKey(spec["name"], "set", "")
        from ..models.pipeline import ForwardExport
        for i, ext in enumerate(exts):
            sub = ForwardExport(set_engine=ext["set_engine"])
            for row in ext["histograms"]:
                if self._match(spec, row[0], HIST_TYPES):
                    matched.add(row[0])
                    sub.histograms.append((hkey,) + tuple(row[1:]))
            for key, regs in ext["sets"]:
                if self._match(spec, key, ("set",)):
                    matched.add(key)
                    sub.sets.append((skey, regs))
            if sub.histograms or sub.sets:
                merge_eng.import_list(i + 1,
                                      wire.export_to_metrics(sub))
            for key, value in ext["counters"].items():
                if self._match(spec, key, ("counter",)):
                    matched.add(key)
                    counter_total += value
        if tick is not None:
            tick.finish(ph, matched=len(matched))

        # ESTIMATE: the merge engine's own flush answers — its
        # configured percentiles ARE the requested quantiles, its
        # aggregates the scalar legs, its set row the cardinality
        ph = -1 if tick is None else tick.start("query.estimate", root)
        fr = merge_eng.flush(timestamp=int(spec["t1"]))
        rows: dict = {}
        from ..metrics import MetricType
        for m in fr.frame:
            if m.tags:
                continue
            rows[(m.name, m.type)] = float(m.value)
        name = spec["name"]
        results: dict = {}
        if spec["quantiles"]:
            results["quantiles"] = {
                _pct_label(q): rows.get(
                    (f"{name}.{_pct_label(q)}percentile",
                     MetricType.GAUGE))
                for q in spec["quantiles"]}
        for agg in spec["scalars"]:
            mt = MetricType.COUNTER if agg == "count" \
                else MetricType.GAUGE
            results[agg] = rows.get((f"{name}.{agg}", mt))
        if spec["want_card"]:
            results["cardinality"] = rows.get((name, MetricType.GAUGE))
        if spec["want_counter"]:
            results["value"] = counter_total if any(
                k.type == "counter" for k in matched) else None
        if tick is not None:
            tick.finish(ph)

        return {
            "metric": name, "t0": spec["t0"], "t1": spec["t1"],
            "tags": spec["tags"], "type": spec["type"],
            "generations": {
                "count": len(entries),
                "first": entries[0].gen, "last": entries[-1].gen,
                "window_ns": [entries[0].prev_close_ns,
                              entries[-1].close_ns],
            },
            "engines": self._describe,
            "matched_keys": len(matched),
            "results": results,
            "gaps": ["udp-between-checkpoints", "local-only-keys",
                     "gauges", "mesh/native-excluded"],
        }

    # -------------------------------------------- per-generation state

    def _reconstruct(self, entry, engine_idxs) -> dict:
        """One generation's journal-visible flushed state, extracted
        metric-independently (so the small per-generation cache serves
        any later query): restore the baseline checkpoint group into a
        fresh scratch engine, replay the interval's ops through the
        per-engine cut (baseline watermark < op_id <= retire
        watermark, the same monotone-per-queue filter recovery uses),
        flush the scratch, and keep the export rows + the frame's
        non-exported counter values."""
        from ..cluster import wire
        from ..ingest.parser import MetricKey
        from ..metrics import MetricType
        from ..utils.hashing import metric_digest

        full = len(engine_idxs) == self._n
        cache_key = entry.gen
        if full:
            with self._cache_lock:
                hit = self._gen_cache.get(cache_key)
                if hit is not None:
                    self._gen_cache.move_to_end(cache_key)
                    return hit
        meta, groups, op_payloads = self._store.load(entry)
        _gen, close_ns, _prev, retire_wms, _lo, _hi = meta
        # the digest modulus is part of a generation's identity: ops
        # route by `digest % n`, watermarks are per-engine — history
        # sealed under a DIFFERENT engine count cannot be re-routed
        # exactly (ops would replay against the wrong baselines,
        # double-counting some and dropping others). Refuse LOUDLY,
        # the same stance crash recovery takes on a count mismatch —
        # never a confidently-wrong answer.
        for g in groups.values():
            if g["meta"][0] != self._n:
                raise HistoryCorrupt(
                    f"generation {entry.gen} was sealed under "
                    f"{g['meta'][0]} engine(s); this server runs "
                    f"{self._n} — re-sharded history cannot answer "
                    "exactly (prune it or restore the original "
                    "num_workers)")
        if op_payloads and len(retire_wms) != self._n:
            raise HistoryCorrupt(
                f"generation {entry.gen} carries {len(retire_wms)} "
                f"retire watermark(s) for a {self._n}-engine server "
                "— engine count changed under retained history")
        ops = [records.decode_engine_import(p) for p in op_payloads]
        # ONE key-extraction/hashing pass routes each op's metrics by
        # the live tier's digest modulus; the per-engine loop below
        # just consumes its bucket (re-walking the ops per engine
        # would pay the protobuf key walk + hash n times over)
        shares_by_engine: dict[int, list] = {i: [] for i in engine_idxs}
        want = set(engine_idxs)
        for op_id, pbs, _env in ops:
            buckets: dict[int, list] = {}
            for pb in pbs:
                try:
                    k = wire.metric_key_of(pb)
                except Exception:
                    continue
                e = metric_digest(k.name, k.type,
                                 k.joined_tags) % self._n
                if e in want:
                    buckets.setdefault(e, []).append(pb)
            for e, share in buckets.items():
                shares_by_engine[e].append((op_id, share))
        ext = {"histograms": [], "sets": [], "set_engine": "hll",
               "counters": {}}
        for idx in engine_idxs:
            g = groups.get(idx)
            retire = retire_wms[idx] if idx < len(retire_wms) else 0
            shares = shares_by_engine[idx]
            if g is None and not shares:
                continue
            if g is not None and not shares \
                    and self._group_is_empty(g):
                continue   # provably empty interval share: no engine
            scratch = self._factory(merge=False)
            wm = 0
            if g is not None:
                _n_eng, wm, gseq, fpr = g["meta"]
                banks = {}
                for payload in g["banks"]:
                    _idx, kind, ids, leaves = \
                        records.decode_engine_bank(
                            payload,
                            leaf_names_of=scratch.bank_leaf_names)
                    banks[kind] = (ids, leaves)
                scratch.restore_checkpoint(fpr, gseq, wm, g["keys"],
                                           banks, g["staged"])
            for op_id, share in shares:
                if op_id <= wm or op_id > retire:
                    continue
                scratch.import_list(op_id, share)
            res = scratch.flush(
                timestamp=max(1, int(close_ns) // 1_000_000_000))
            ext["histograms"].extend(res.export.histograms)
            ext["sets"].extend(res.export.sets)
            ext["set_engine"] = res.export.set_engine
            for key, value in res.export.counters:
                ext["counters"][key] = \
                    ext["counters"].get(key, 0.0) + float(value)
            # counters whose scope kept them out of the export (MIXED/
            # local keys that landed via checkpointed bank rows) flush
            # into the frame instead — fold those in by exact key
            exported = {k for k, _v in res.export.counters}
            for m in res.frame:
                if m.type != MetricType.COUNTER:
                    continue
                key = MetricKey(m.name, "counter", ",".join(m.tags))
                if key in exported:
                    continue
                ext["counters"][key] = \
                    ext["counters"].get(key, 0.0) + float(m.value)
        if full:
            with self._cache_lock:
                self._gen_cache[cache_key] = ext
                self._gen_cache.move_to_end(cache_key)
                while len(self._gen_cache) > self._GEN_CACHE:
                    self._gen_cache.popitem(last=False)
        return ext

    @staticmethod
    def _group_is_empty(g) -> bool:
        """True when a baseline group provably reconstructs to an empty
        interval share: no bank rows, nothing staged, no interned keys
        — restoring it would flush nothing."""
        if g["banks"]:
            return False
        staged = g["staged"]
        if any(staged.get(f) for f in ("centroids", "sets", "counters",
                                       "gauges")):
            return False
        return not any(entries for _iv, entries in g["keys"].values())

    def debug_state(self) -> dict:
        with self._cache_lock:
            return {
                "cache_entries": len(self._cache),
                "cache_capacity": self._cache_entries,
                "generation_cache_entries": len(self._gen_cache),
                "timeout_s": self._timeout_s,
                "requests": self._registry.total(self._scope,
                                                 "query.requests"),
                "errors": self._registry.total(self._scope,
                                               "query.errors"),
                "cache_hits": self._registry.total(self._scope,
                                                   "query.cache_hits"),
            }
