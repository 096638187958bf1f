"""Fleet view: per-sender e2e latency, freshness, and import tracing (the
port's copy of veneur_tpu/observe/fleet.py).

The receiver-side half of cross-tier tracing. Every forwarded chunk
arrives with an idempotency envelope and (from tracing-enabled
senders) a trace context — the sender's flush-tick trace/span ids plus
the interval-close wall time (wire codecs: cluster/wire.py). Two
consumers live here:

  * `FleetView` — bounded per-sender bookkeeping. Each ADMITTED
    interval's close time parks in a pending set; at the global's next
    flush tick `on_flush(now_ns)` turns the set into close->merged
    latency samples (the `veneur.e2e.*` timers), advances the
    per-sender freshness watermark (newest close time merged), and
    feeds a rolling window serving p50/p99 to `GET /debug/fleet`.
    Close times are COMPARED, never merged: e2e accounting can change
    no flushed tenant state (the exactly-once chaos oracles pin it).

  * `ImportObserver` — per-request import observation. Each import
    request (gRPC SendMetrics/V2, HTTP /import) records its
    dedupe/apply phases as a TickRecord in a bounded ring (the same
    flight-recorder machinery as flush ticks, served under
    /debug/fleet) and — when the sender propagated a trace context —
    replays them as SSF spans PARENTED ON THE REMOTE SENDER'S FLUSH
    SPAN, yielding one span tree per interval across both processes.

Thread model: handler threads call both concurrently; FleetView takes
one lock per call, the import ring reuses the recorder's locking. The
clock is injectable for the fault harness.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from . import registry as _registry
from .recorder import FlightRecorder, TickRecord

# a storm of admissions between two global flushes must not grow the
# pending set unboundedly; overflow drops the OLDEST pending sample
# (observability loss only, counted in debug_state)
MAX_PENDING_INTERVALS = 8192


class _SenderView:
    __slots__ = ("last_seen_ns", "newest_close_ns", "intervals_merged",
                 "window", "sketch_engines", "engine_rejects")

    def __init__(self, window: int):
        self.last_seen_ns = 0
        self.newest_close_ns = 0      # freshness watermark
        self.intervals_merged = 0
        self.window = deque(maxlen=window)   # e2e ms samples
        # sketch-engine/wire stamp the sender last declared (None until
        # a request carried a verdict) + rejected-request count — the
        # mixed-fleet signature an operator reads BEFORE it degrades
        self.sketch_engines = None
        self.engine_rejects = 0


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over a small sorted list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


class FleetView:
    """Bounded per-sender e2e/freshness bookkeeping (receiver side)."""

    def __init__(self, max_senders: int = 1024, window: int = 256,
                 clock=time.time_ns):
        self.max_senders = max(1, max_senders)
        self.window = max(8, window)
        self._clock = clock
        self._lock = threading.Lock()
        self._senders: OrderedDict[str, _SenderView] = OrderedDict()
        # (sender_id, seq) -> close_ns, admitted since the last flush
        self._pending: OrderedDict = OrderedDict()
        self.pending_dropped = 0

    def _touch(self, sender_id: str, now_ns: int) -> _SenderView:
        sv = self._senders.get(sender_id)
        if sv is None:
            while len(self._senders) >= self.max_senders:
                self._senders.popitem(last=False)
            sv = self._senders[sender_id] = _SenderView(self.window)
        else:
            self._senders.move_to_end(sender_id)
        sv.last_seen_ns = now_ns
        return sv

    def observe_interval(self, sender_id: str, seq: int,
                         close_ns: int = 0) -> None:
        """One ADMITTED chunk arrived. Bumps last-seen; with a close
        time, parks the interval for e2e accounting at the next flush
        (chunks of one interval collapse onto one pending sample)."""
        now = self._clock()
        with self._lock:
            self._touch(sender_id, now)
            if close_ns:
                self._pending[(sender_id, int(seq))] = int(close_ns)
                while len(self._pending) > MAX_PENDING_INTERVALS:
                    self._pending.popitem(last=False)
                    self.pending_dropped += 1

    def note_stamp(self, sender_id: str, stamp: str | None,
                   ok: bool) -> None:
        """Record one request's sketch-engine stamp verdict:
        the sender's declared engines (or "(legacy)" for unstamped
        peers) and, on mismatch, the reject count — so /debug/fleet
        shows a MIXED fleet per sender, not just an aggregate counter.

        Liveness discipline: an ACCEPTED stamp only ANNOTATES a row the
        normal admission path created (a request whose body then fails
        decode must not look alive — the rejected-import rule); a
        MISMATCH creates/touches the row — the sender IS alive and
        misconfigured, which is exactly what the page must show."""
        with self._lock:
            if ok:
                sv = self._senders.get(sender_id)
                if sv is None:
                    return
            else:
                sv = self._touch(sender_id, self._clock())
                sv.engine_rejects += 1
            sv.sketch_engines = stamp if stamp is not None else "(legacy)"

    def on_flush(self, now_ns: int) -> dict:
        """Flush boundary: everything admitted since the previous tick
        is now merged into flushed state. Returns {sender_id: [ms]}
        close->merged latency samples (for the e2e timer dogfood) and
        advances each sender's freshness watermark."""
        out: dict = {}
        with self._lock:
            pending, self._pending = self._pending, OrderedDict()
            for (sender_id, _seq), close_ns in pending.items():
                sv = self._senders.get(sender_id)
                if sv is None:
                    sv = self._touch(sender_id, now_ns)
                ms = max(0.0, (now_ns - close_ns) / 1e6)
                sv.window.append(ms)
                sv.intervals_merged += 1
                sv.newest_close_ns = max(sv.newest_close_ns, close_ns)
                out.setdefault(sender_id, []).append(ms)
        return out

    def freshness(self, now_ns: int | None = None) -> dict:
        """{sender_id: age_ns of the newest MERGED interval} — the
        per-sender staleness gauge (senders with no merged close time
        yet are omitted)."""
        now = self._clock() if now_ns is None else now_ns
        with self._lock:
            return {sid: max(0, now - sv.newest_close_ns)
                    for sid, sv in self._senders.items()
                    if sv.newest_close_ns}

    def sender_count(self) -> int:
        with self._lock:
            return len(self._senders)

    def debug_state(self, now_ns: int | None = None) -> dict:
        """JSON-ready per-sender rows for GET /debug/fleet."""
        now = self._clock() if now_ns is None else now_ns
        with self._lock:
            pending_by_sender: dict = {}
            for (sid, _seq) in self._pending:
                pending_by_sender[sid] = pending_by_sender.get(sid, 0) + 1
            senders = {}
            for sid, sv in self._senders.items():
                vals = sorted(sv.window)
                senders[sid] = {
                    "last_seen_age_s": max(0.0,
                                           (now - sv.last_seen_ns) / 1e9),
                    "newest_close_ns": sv.newest_close_ns,
                    "freshness_age_ms": (
                        max(0.0, (now - sv.newest_close_ns) / 1e6)
                        if sv.newest_close_ns else None),
                    "intervals_merged": sv.intervals_merged,
                    "sketch_engines": sv.sketch_engines,
                    "engine_mismatch_rejects": sv.engine_rejects,
                    "pending": pending_by_sender.get(sid, 0),
                    "e2e_ms": {
                        "count": len(vals),
                        "p50": round(_percentile(vals, 0.50), 3),
                        "p99": round(_percentile(vals, 0.99), 3),
                    },
                }
            return {"senders": senders,
                    "pending_intervals": len(self._pending),
                    "pending_dropped": self.pending_dropped}


_NO_STAMP = object()   # "this request carried no stamp verdict"


class _ImportScope:
    """Context for one import request: phases into the import ring,
    spans parented on the remote sender's flush span, fleet feed."""

    __slots__ = ("_obs", "tick", "env", "trace", "admitted", "n_metrics",
                 "kind", "rejected", "stamp")

    def __init__(self, obs: "ImportObserver", env, trace, kind: str,
                 stamp=_NO_STAMP):
        self._obs = obs
        self.env = env
        self.trace = trace
        self.admitted = False
        self.n_metrics = 0
        self.kind = kind
        self.rejected = False       # 4xx'd before a dedupe verdict
        self.stamp = stamp          # accepted engine stamp (None=legacy)
        self.tick = None
        if obs.flight is not None:
            # a PRIVATE record, published at __exit__: handler threads
            # run concurrently, and a ring slot handed out here could
            # be recycled mid-request once in-flight requests exceed
            # ring capacity (one slow client + a burst of fast ones)
            self.tick = obs.flight.open_tick(int(time.time()))

    def start(self, name: str, parent: int = -1) -> int:
        return -1 if self.tick is None else self.tick.start(name, parent)

    def finish(self, idx: int, **meta):
        if self.tick is not None:
            self.tick.finish(idx, **meta)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        obs = self._obs
        if self.tick is not None:
            # zero-length summary phase: the request identity/verdict,
            # readable from the ring and the emitted span tree alike
            self.tick.finish(
                self.tick.start("request"), kind=self.kind,
                sender=(self.env[0] if self.env else None),
                seq=(self.env[1] if self.env else None),
                admitted=self.admitted, n_metrics=self.n_metrics)
            obs.flight.end_tick(self.tick)
            obs.flight.adopt(self.tick)
            if self.trace is not None:
                client = obs.client()
                if client is not None:
                    obs.flight.emit_spans(
                        self.tick, client,
                        trace_id=self.trace[0],
                        parent_id=self.trace[1],
                        namer=_registry.import_span_name)
        if obs.fleet is not None and self.env is not None \
                and exc_type is None and not self.rejected:
            if self.admitted:
                close_ns = self.trace[2] if self.trace is not None else 0
                obs.fleet.observe_interval(self.env[0], self.env[1],
                                           close_ns)
            else:
                # a deduped chunk still proves the sender alive; a
                # REJECTED request (4xx before a dedupe verdict) must
                # not — bumping last-seen for a sender whose every
                # body fails decode would mask it on the very page an
                # operator consults to find it
                obs.fleet.observe_interval(self.env[0], self.env[1], 0)
            if self.stamp is not _NO_STAMP:
                # annotate the row the feed above just created with
                # the ACCEPTED engine stamp (mismatches never get
                # here — the handler rejected before opening a scope)
                obs.fleet.note_stamp(self.env[0], self.stamp, True)
        return False


class ImportObserver:
    """Bundles what the import handlers need to observe one request:
    the bounded import ring (flight-recorder TickRecords), the fleet
    view, and the server's trace client (late-bound — the client only
    exists once an SSF listener is up)."""

    def __init__(self, fleet: FleetView | None = None,
                 flight: FlightRecorder | None = None,
                 client=None):
        self.fleet = fleet
        self.flight = flight
        self._client = client            # callable -> trace client|None

    def client(self):
        c = self._client
        return c() if callable(c) else c

    def request(self, env, trace, kind: str,
                stamp=_NO_STAMP) -> _ImportScope:
        """Open the observation scope for one import request. `env` is
        the decoded envelope tuple (or None), `trace` the decoded
        trace-context tuple (or None), `kind` "grpc"/"http"; `stamp`
        (when the handler checked one) is the ACCEPTED sketch-engine
        stamp, annotated onto the sender's fleet row at scope exit."""
        return _ImportScope(self, env, trace, kind, stamp)

    def debug_state(self, limit: int | None = 16) -> dict | None:
        if self.flight is None:
            return None
        return self.flight.debug_state(limit)
