"""Flight recorder: a bounded ring of per-flush-tick phase trees (the
port's copy of veneur_tpu/observe/recorder.py).

Every flush tick records where its milliseconds went — engine drain,
XLA dispatch, device exec (bounded by block_until_ready), MetricFrame
materialize, per-sink fan-out (including skips and still-in-flight
threads), the forward ladder (per-attempt retry/backoff, breaker
rejections, replay entries, journal ops) — into one `TickRecord`.
The last `capacity` ticks live in a preallocated ring; `/debug/flush`
serves them as JSON and `emit_spans` replays each tick as an SSF span
tree through the server's own trace client (flusher.go self-tracing
parity).

Hot-path cost model: one `time.monotonic_ns()` call and one index bump
per phase edge, under a lock held for the bump only; phase slots are
preallocated (`_Phase` objects recycled with their tick slot), so the
steady state allocates nothing per phase. Overflow past `max_phases`
drops the phase (counted on the tick), never grows the slot array.

Recorder state is strictly process-local: no journal interaction, no
persistence — a SimulatedKill/SIGKILL loses the ring and nothing else
(the chaos suite pins that a kill can't corrupt what remains).

Threads that are not flush ticks stamp into `SpanRing`s owned by the
recorder: the native pump's cycles that moved samples, and every
collection of the interpreter's collector (`collector_start` installs a
`gc.callbacks` hook). A ring is a fixed block of int64 columns, start
and end `monotonic_ns` plus a few integer fields, that overwrites its
oldest entry and counts what it overwrote; it allocates nothing per
span. Collections of generation 1 and 2 that ran while a flush tick was
in flight are also grafted into that tick's tree as `gc` phases when the
tick ends (the callback runs on whichever thread allocated, so the tick
is found through the recorder, never the contextvar). `monotonic_ns`
and `perf_counter` read one clock on Linux (CLOCK_MONOTONIC), so these
spans line up with a device trace mapped onto `perf_counter`.

Cross-thread attribution: the flusher thread owns the tick and parks
it in a contextvar (`set_current_tick`) so code it calls synchronously
— the forward ladder, egress retries, journal ops — can attribute
phases without plumbing. Threads the flusher *spawns* (engine flushes,
sink fan-out) do not inherit the contextvar; the server hands them
explicit (tick, parent) handles, and egress calls made from non-flush
threads (span sinks, background pollers) see no current tick and
record nothing — which is the correct attribution.
"""

from __future__ import annotations

import contextvars
import gc
import threading
import time

import numpy as np

from . import registry as _registry

# the tick-tree name of a collection (registry.phase_timer_samples does
# not re-ingest it: a collection is not a flush phase)
GC_PHASE = _registry.GC_PHASE
# the collector's ring: every collection since the hook went in, with its
# generation and the thread it ran on
GC_FIELDS = ("generation", "thread")
GC_SPANS = 1 << 14


class _Scope:
    """What the contextvar carries: the tick plus the phase index new
    child phases should parent under (the server moves the parent as it
    enters its top-level phases, so the forward ladder's attempt/replay
    phases nest under `forward`, not beside it)."""

    __slots__ = ("tick", "parent")

    def __init__(self, tick: "TickRecord", parent: int = -1):
        self.tick = tick
        self.parent = parent


_current_scope: contextvars.ContextVar["_Scope | None"] = \
    contextvars.ContextVar("veneur_flight_scope", default=None)


def current_scope() -> "_Scope | None":
    """The (tick, parent) scope in progress on THIS thread's context
    (None off the flusher thread)."""
    return _current_scope.get()


def current_tick() -> "TickRecord | None":
    sc = _current_scope.get()
    return None if sc is None else sc.tick


def set_current_tick(tick: "TickRecord | None", parent: int = -1):
    return _current_scope.set(
        None if tick is None else _Scope(tick, parent))


def reset_current_tick(token):
    _current_scope.reset(token)


class _Phase:
    """One preallocated phase slot. `t1 == 0` means still in flight."""

    __slots__ = ("name", "parent", "t0", "t1", "meta")

    def __init__(self):
        self.name = ""
        self.parent = -1
        self.t0 = 0
        self.t1 = 0
        self.meta = None


class _PhaseCtx:
    """Context-manager handle from TickRecord.phase()."""

    __slots__ = ("_tick", "idx")

    def __init__(self, tick, idx):
        self._tick = tick
        self.idx = idx

    def __enter__(self):
        return self.idx

    def __exit__(self, exc_type, exc, tb):
        self._tick.finish(self.idx)
        return False


class TickRecord:
    """One flush tick's phase tree (preallocated, reused by the ring).

    Each tick carries its own TRACE IDENTITY (`trace_id`, `span_id`),
    pinned at begin_tick — not minted at span-emission time — so the
    forward path can stamp the identity onto wire envelopes WHILE the
    tick runs (cross-tier span propagation) and `emit_spans` later
    replays the exact same tree the remote tier parented under.
    `close_ns` is the interval-close wall time the tick represents
    (the server stamps it; scripted timestamps stay scripted), riding
    the same envelopes to feed the global's e2e latency accounting."""

    __slots__ = ("tick_id", "ts", "wall_start_ns", "mono_start", "mono_end",
                 "n", "dropped", "_slots", "_lock",
                 "trace_id", "span_id", "close_ns", "cpu_start", "cpu_ns")

    def __init__(self, max_phases: int):
        self._slots = [_Phase() for _ in range(max_phases)]
        self._lock = threading.Lock()
        self.tick_id = -1
        self.ts = 0
        self.wall_start_ns = 0
        self.mono_start = 0
        self.mono_end = 0
        self.n = 0
        self.dropped = 0
        self.trace_id = 0
        self.span_id = 0
        self.close_ns = 0
        # CPU time of the thread that began and ended the tick (the
        # flusher): its wall less the waits for the interpreter lock,
        # the device and the engine lock
        self.cpu_start = 0
        self.cpu_ns = 0

    def _reset(self, tick_id: int, ts: int):
        from ..trace import _span_id   # shared int63 id space
        self.tick_id = tick_id
        self.ts = ts
        self.wall_start_ns = time.time_ns()
        self.mono_start = time.monotonic_ns()
        self.mono_end = 0
        self.n = 0
        self.dropped = 0
        self.trace_id = _span_id()
        self.span_id = _span_id()
        self.close_ns = self.wall_start_ns
        self.cpu_start = time.thread_time_ns()
        self.cpu_ns = 0

    # ---- hot path ----

    def start(self, name: str, parent: int = -1) -> int:
        """Open a phase; returns its index (-1 = slot budget exhausted,
        safe to pass to finish). Thread-safe: the slot's fields are
        initialized BEFORE the index publish (`self.n = i + 1`), all
        under the lock — a reader (snapshot / emit_spans on another
        thread) that observes the new n must never see the recycled
        slot's previous-tick contents (a stale nonzero t1 would read
        as a completed phase with absurd timestamps)."""
        t0 = time.monotonic_ns()
        with self._lock:
            i = self.n
            if i >= len(self._slots):
                self.dropped += 1
                return -1
            s = self._slots[i]
            s.name = name
            s.parent = parent
            s.t0 = t0
            s.t1 = 0
            s.meta = None
            self.n = i + 1
        return i

    def finish(self, idx: int, **meta):
        """Close a phase (single writer per slot — no lock needed)."""
        if idx < 0:
            return
        s = self._slots[idx]
        s.t1 = time.monotonic_ns()
        if meta:
            s.meta = meta

    def phase(self, name: str, parent: int = -1) -> _PhaseCtx:
        """`with tick.phase("drain") as idx:` convenience wrapper."""
        return _PhaseCtx(self, self.start(name, parent))

    def add(self, name: str, t0_ns: int, t1_ns: int, parent: int = -1,
            **meta) -> int:
        """Record a phase whose edges were stamped elsewhere (engine
        flush threads return their stamps in FlushResult.stats).
        Fields-before-publish, like start()."""
        with self._lock:
            i = self.n
            if i >= len(self._slots):
                self.dropped += 1
                return -1
            s = self._slots[i]
            s.name = name
            s.parent = parent
            s.t0 = t0_ns
            s.t1 = t1_ns
            s.meta = meta or None
            self.n = i + 1
        return i

    def annotate(self, idx: int, **meta):
        if idx < 0:
            return
        s = self._slots[idx]
        s.meta = {**(s.meta or {}), **meta}

    # ---- read side ----

    def duration_ns(self) -> int:
        end = self.mono_end or time.monotonic_ns()
        return end - self.mono_start

    def phases(self):
        """[(name, t0_ns, t1_ns, parent)] — t1 of an in-flight phase
        reads 0."""
        return [(s.name, s.t0, s.t1, s.parent)
                for s in self._slots[:self.n]]

    def to_dict(self) -> dict:
        """JSON-ready timeline: offsets are ns from tick start so a
        reader can lay phases on one axis without epoch math."""
        base = self.mono_start
        phases = []
        for s in self._slots[:self.n]:
            d = {"name": s.name, "parent": s.parent,
                 "start_ns": s.t0 - base,
                 "end_ns": (s.t1 - base) if s.t1 else None,
                 "in_flight": s.t1 == 0}
            if s.meta:
                d["meta"] = s.meta
            phases.append(d)
        dur = (self.mono_end - base) if self.mono_end else None
        return {"tick_id": self.tick_id, "timestamp": self.ts,
                "wall_start_ns": self.wall_start_ns,
                "mono_start_ns": base,
                "duration_ns": dur,
                "cpu_ns": self.cpu_ns if self.mono_end else None,
                "phases": phases,
                "dropped_phases": self.dropped}


class SpanRing:
    """A fixed ring of spans for a thread that is not a flush tick:
    start and end `monotonic_ns` and one int64 per name in `fields`, in
    arrays allocated once. `record` writes a row in place; once the ring
    is full it overwrites the oldest row, and `overwritten` counts them.

    One writer at a time (its caller serializes it: the pump's cycle
    lock, the collector's own exclusion); readers take no lock. The
    writer raises `_pending` across a row's stores and bumps `count`
    after them, so a reader drops any row a write may have torn."""

    def __init__(self, capacity: int, fields: tuple = ()):
        self.capacity = max(1, int(capacity))
        self.fields = tuple(fields)
        self._t = np.zeros((self.capacity, 2), np.int64)
        self._f = np.zeros((self.capacity, max(1, len(self.fields))),
                           np.int64)
        self.count = 0          # spans recorded, ever
        self._pending = False

    @property
    def overwritten(self) -> int:
        return max(0, self.count - self.capacity)

    def record(self, t0_ns: int, t1_ns: int, *values) -> None:
        i = self.count % self.capacity
        self._pending = True
        t, f = self._t, self._f
        t[i, 0] = t0_ns
        t[i, 1] = t1_ns
        for j, v in enumerate(values):
            f[i, j] = v
        self.count += 1
        self._pending = False

    def entries(self, last: int | None = None) -> tuple:
        """Copies of the rows kept, oldest first, or of the newest
        `last` of them: ([n, 2] start and end ns, [n, len(fields)]
        fields)."""
        cap = self.capacity
        c0 = self.count
        lo = max(0, c0 - (cap if last is None else min(cap, last)))
        idx = np.arange(lo, c0) % cap
        t, f = self._t[idx], self._f[idx, :len(self.fields)]
        torn = self._pending
        c1 = self.count
        drop = max(0, c1 - cap + (torn or c1 != c0) - lo)
        return t[drop:], f[drop:]

    def window(self, t0_ns: int, t1_ns: int):
        """The rows that overlap [t0_ns, t1_ns], oldest first, as
        `entries` gives them; None where the ring no longer covers
        t0_ns (it has overwritten rows and its oldest kept row starts
        after t0_ns), since a row in the window may be gone."""
        t, f = self.entries()
        if self.overwritten and (not len(t) or t[0, 0] > t0_ns):
            return None
        keep = (t[:, 1] >= t0_ns) & (t[:, 0] <= t1_ns)
        return t[keep], f[keep]

    def summary(self, last: int = 8) -> dict:
        """JSON-ready counts and the newest `last` rows."""
        t, f = self.entries()
        rows = []
        for k in range(max(0, len(t) - last), len(t)):
            row = {"start_ns": int(t[k, 0]), "end_ns": int(t[k, 1])}
            row.update(zip(self.fields, map(int, f[k])))
            rows.append(row)
        return {"capacity": self.capacity, "recorded": self.count,
                "overwritten": self.overwritten,
                "fields": list(self.fields), "last": rows}


class _CollectorHook:
    """The `gc.callbacks` entry: stamps each collection into the ring
    and keeps the totals behind veneur.gc.number and
    veneur.gc.pause_total_ns. Collections never overlap, so the ring
    has one writer at a time."""

    __slots__ = ("ring", "t0", "collections", "pause_ns")

    def __init__(self, ring: SpanRing):
        self.ring = ring
        self.t0 = 0
        self.collections = 0
        self.pause_ns = 0

    def __call__(self, phase, info):
        if phase == "start":
            self.t0 = time.monotonic_ns()
            return
        t0, self.t0 = self.t0, 0
        if not t0:
            return
        t1 = time.monotonic_ns()
        self.ring.record(t0, t1, info["generation"], threading.get_ident())
        self.collections += 1
        self.pause_ns += t1 - t0


class FlightRecorder:
    """The bounded ring. Ticks are serialized (one flusher thread);
    the ring hands out its oldest slot for reuse, so a sink thread
    finishing a phase from `capacity` ticks ago writes into a slot
    about to be recycled — stale but never unsafe (slot objects are
    never freed, and the snapshot tolerates in-flight phases)."""

    def __init__(self, capacity: int = 32, max_phases: int = 192):
        self.capacity = max(1, capacity)
        self.max_phases = max(8, max_phases)
        self._ring = [TickRecord(self.max_phases)
                      for _ in range(self.capacity)]
        self._next = 0          # flusher-thread-only
        self._tick_count = 0
        self._lock = threading.Lock()   # snapshot vs begin_tick
        # the span rings of threads that are not flush ticks, by name
        self._spans: dict[str, SpanRing] = {}
        self._collector: _CollectorHook | None = None

    def begin_tick(self, ts: int) -> TickRecord:
        with self._lock:
            tick = self._ring[self._next]
            self._next = (self._next + 1) % self.capacity
            self._tick_count += 1
            tick._reset(self._tick_count, ts)
        return tick

    def end_tick(self, tick: TickRecord):
        tick.mono_end = time.monotonic_ns()
        tick.cpu_ns = time.thread_time_ns() - tick.cpu_start
        ring = self._spans.get(GC_PHASE)
        if ring is not None:
            self._graft_collections(tick, ring)

    def _graft_collections(self, tick: TickRecord, ring: SpanRing):
        """Add a `gc` phase for each collection of generation 1 or 2
        that ran while `tick` was in flight, under the innermost phase
        it started in (meta: generation, thread). Young collections run
        hundreds of times a flush for a fraction of a millisecond each:
        the ring keeps them, the tree does not, and the tree's
        collections take at most a quarter of its phase slots."""
        n = 256     # the newest rows, widened until they reach back
        while True:
            t, f = ring.entries(last=n)
            if len(t) < n or t[0, 1] < tick.mono_start \
                    or n >= ring.capacity:
                break
            n *= 4
        sel = np.flatnonzero((t[:, 1] >= tick.mono_start)
                             & (t[:, 0] <= tick.mono_end) & (f[:, 0] >= 1))
        if not len(sel):
            return
        phases = tick.phases()
        names = {th.ident: th.name for th in threading.enumerate()}
        for k in sel[:self.max_phases // 4]:
            s0, s1 = int(t[k, 0]), int(t[k, 1])
            parent, start = -1, -1
            for i, (_n, p0, p1, _p) in enumerate(phases):
                if start <= p0 <= s0 and (p1 == 0 or s0 < p1):
                    parent, start = i, p0
            ident = int(f[k, 1])
            tick.add(GC_PHASE, s0, s1, parent=parent,
                     generation=int(f[k, 0]),
                     thread=names.get(ident, str(ident)))

    def span_ring(self, name: str, fields: tuple,
                  capacity: int) -> SpanRing:
        """The ring named `name`, made on first use; /debug/flush
        summarizes every ring."""
        ring = self._spans.get(name)
        if ring is None:
            ring = self._spans[name] = SpanRing(capacity, fields)
        return ring

    def spans(self, name: str) -> SpanRing | None:
        """The ring named `name`, or None where none was made."""
        return self._spans.get(name)

    def collector_start(self):
        """Install the collector hook (once): each collection lands in
        the `gc` ring from here on."""
        if self._collector is None:
            self._collector = _CollectorHook(
                self.span_ring(GC_PHASE, GC_FIELDS, GC_SPANS))
        if self._collector not in gc.callbacks:
            gc.callbacks.append(self._collector)

    def collector_stop(self):
        """Remove the hook; the ring and the totals stay readable."""
        hook = self._collector
        if hook is not None and hook in gc.callbacks:
            gc.callbacks.remove(hook)

    def collector_installed(self) -> bool:
        return self._collector is not None \
            and self._collector in gc.callbacks

    def collector_totals(self) -> tuple | None:
        """(collections, pause ns) since the hook went in; None without
        one."""
        hook = self._collector
        return None if hook is None else (hook.collections, hook.pause_ns)

    def open_tick(self, ts: int) -> TickRecord:
        """A PRIVATE TickRecord outside the ring, for CONCURRENT
        recorders (the import observer's handler threads): record into
        it freely, then publish the finished record with adopt().
        begin_tick would hand concurrent callers recycled ring slots —
        with more in-flight requests than ring capacity, _reset wipes
        a slot out from under the request still writing to it."""
        tick = TickRecord(self.max_phases)
        tick._reset(0, ts)      # tick_id assigned at adopt()
        return tick

    def adopt(self, tick: TickRecord):
        """Publish a COMPLETED open_tick record into the ring (takes
        the next slot; the recycled slot object is dropped). The tick
        must be finished — end_tick first — since ring readers treat
        membership as 'this tick happened'."""
        with self._lock:
            self._tick_count += 1
            tick.tick_id = self._tick_count
            self._ring[self._next] = tick
            self._next = (self._next + 1) % self.capacity

    @property
    def tick_count(self) -> int:
        return self._tick_count

    def last_tick(self) -> TickRecord | None:
        with self._lock:
            if self._tick_count == 0:
                return None
            return self._ring[(self._next - 1) % self.capacity]

    def snapshot(self, limit: int | None = None) -> list[dict]:
        """The ring as JSON-ready dicts, newest tick first."""
        with self._lock:
            n = min(self._tick_count, self.capacity)
            ticks = [self._ring[(self._next - 1 - i) % self.capacity]
                     for i in range(n)]
        out = [t.to_dict() for t in ticks]
        if limit is not None:
            out = out[:max(0, limit)]
        return out

    def emit_spans(self, tick: TickRecord, client, *,
                   trace_id: int | None = None, parent_id: int = 0,
                   namer=None) -> int:
        """Replay one tick as an SSF span tree through the trace
        client (the server's own ingest path — flusher.go parity).
        Returns the number of spans enqueued.

        The root span uses the tick's OWN pinned identity (`trace_id`
        defaults to tick.trace_id, root id is tick.span_id). A receiver
        passes `trace_id`/`parent_id` to graft its tree under a remote
        span, and `namer` to name the tree (defaults to the flush span
        names)."""
        if client is None:
            return 0
        from ..ssf.protos import ssf_pb2
        from ..trace import _span_id

        if namer is None:
            namer = _registry.flush_span_name
        wall0 = tick.wall_start_ns
        mono0 = tick.mono_start
        trace_id = trace_id or tick.trace_id or _span_id()
        root_id = tick.span_id or _span_id()
        end = tick.mono_end or time.monotonic_ns()
        root = ssf_pb2.SSFSpan(
            version=0, trace_id=trace_id, id=root_id,
            parent_id=parent_id,
            name=namer(), service="veneur",
            start_timestamp=wall0,
            end_timestamp=wall0 + (end - mono0))
        root.tags["tick_id"] = str(tick.tick_id)
        sent = 1 if client.record(root) else 0
        ids = {}
        for i, (name, t0, t1, parent) in enumerate(tick.phases()):
            if t1 == 0:
                continue   # in-flight at emission; /debug/flush has it
            sid = _span_id()
            ids[i] = sid
            span = ssf_pb2.SSFSpan(
                version=0, trace_id=trace_id, id=sid,
                parent_id=ids.get(parent, root_id),
                name=namer(name), service="veneur",
                start_timestamp=wall0 + (t0 - mono0),
                end_timestamp=wall0 + (t1 - mono0))
            sent += 1 if client.record(span) else 0
        return sent

    def debug_state(self, limit: int | None = None) -> dict:
        totals = self.collector_totals()
        return {"tick_count": self._tick_count,
                "capacity": self.capacity,
                "max_phases_per_tick": self.max_phases,
                "ticks": self.snapshot(limit),
                "spans": {name: ring.summary()
                          for name, ring in self._spans.items()},
                "collector": {
                    "installed": self.collector_installed(),
                    "collections": totals[0] if totals else 0,
                    "pause_total_ns": totals[1] if totals else 0}}
