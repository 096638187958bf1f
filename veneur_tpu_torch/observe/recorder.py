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
import threading
import time

from . import registry as _registry


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
                 "trace_id", "span_id", "close_ns")

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

    def attributed_ns(self) -> int:
        """Nanoseconds accounted to completed TOP-LEVEL phases —
        the numerator of the >=95% coverage acceptance gate (children
        nest inside their parents, so only roots sum)."""
        return sum(s.t1 - s.t0 for s in self._slots[:self.n]
                   if s.parent == -1 and s.t1 > s.t0)

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
                "duration_ns": dur, "phases": phases,
                "dropped_phases": self.dropped}


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

    def begin_tick(self, ts: int) -> TickRecord:
        with self._lock:
            tick = self._ring[self._next]
            self._next = (self._next + 1) % self.capacity
            self._tick_count += 1
            tick._reset(self._tick_count, ts)
        return tick

    def end_tick(self, tick: TickRecord):
        tick.mono_end = time.monotonic_ns()

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
        return {"tick_count": self._tick_count,
                "capacity": self.capacity,
                "max_phases_per_tick": self.max_phases,
                "ticks": self.snapshot(limit)}
