"""Unified egress resilience: retry, circuit breaking, sketch re-merge —
the port's copy of veneur_tpu/resilience.py.

Every network egress in the pipeline — both cluster forwarders, the
proxy fan-out, discovery — routes its wire calls through an `Egress`
from this module instead of raw urllib/grpc. The layer owns three
behaviors:

  * **Retry with full-jitter exponential backoff** under a per-flush
    deadline budget: a transient failure (timeout, 5xx, connection
    refused, UNAVAILABLE) is retried up to `max_attempts` times with
    `delay ~ U(0, min(cap, base * 2^attempt))`, and the whole call —
    attempts plus backoff sleeps plus per-attempt socket timeouts —
    never exceeds `deadline_s`, so one wedged vendor cannot push the
    flush tick late.

  * **A per-destination circuit breaker**, so a dead endpoint costs one
    fast rejection per flush instead of a full retry ladder:

        closed ──(failure_threshold consecutive failed calls)──▶ open
          ▲                                                   │
          │                              (open_duration_s elapses)
          │                                                   ▼
          └──(half_open_successes probe successes)──── half-open
                       half-open ──(probe failure)──▶ open (timer
                                                      restarts)

    Half-open admits ONE in-flight probe at a time; concurrent callers
    are rejected until the probe resolves.

  * **An exactly-once spill/replay ledger** (`ResilientForwarder` +
    `SpillBuffer`): every interval's forward is stamped with an
    idempotency envelope (`ForwardEnvelope`: stable sender_id,
    monotonic interval_seq, chunk ids). When a forward fails
    terminally, the interval's `ForwardExport` sketches are NOT
    dropped — they are parked in a bounded replay ledger KEEPING their
    original envelope, and replayed oldest-first ahead of the next
    interval's send. The receiving global tier keeps a per-sender
    dedupe ledger (`cluster.importsrv.DedupeLedger`) and drops any
    chunk it already Combined, so an *ambiguous* failure (body
    applied, response lost) followed by a retry or replay cannot
    double-count. Ledger overflow demotes the oldest intervals into
    the same-key-merged `SpillBuffer` overflow tier (centroids
    concatenate, HLL registers fold by max, counters sum — lossless),
    whose contents ride the next interval's fresh envelope: those
    sketches degrade to at-least-once, counted as `reenveloped`.
    Gauges are last-write-wins and only meaningful fresh, so they ride
    along for `gauge_max_age_intervals` failed intervals and are then
    evicted (counted). The sketch budget bounds both tiers; overflow
    evicts oldest sketches first, also counted.

Everything observable is counted per destination in a
`ResilienceRegistry`; the server drains it each flush into
`veneur.resilience.*_total` self-metrics. The clock, sleep, RNG, and
transport are all injectable, so `utils/faults.py` can script every
retry/breaker/re-merge transition deterministically — no sockets, no
real sleeps.
"""

from __future__ import annotations

import logging
import random
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass

import numpy as np

from .observe.recorder import current_scope as _current_scope
from .observe.registry import DEFAULT_REGISTRY  # noqa: F401  (re-export)
from .observe.registry import TelemetryRegistry as ResilienceRegistry

log = logging.getLogger("veneur_tpu_torch.resilience")


# --------------------------------------------------------------- errors

class EgressError(Exception):
    """Base for resilience-layer errors."""


class TransientEgressError(EgressError):
    """Marker for failures the retry loop should retry."""


class TerminalEgressError(EgressError):
    """Marker for failures that must not be retried."""


class CircuitOpenError(EgressError):
    """The destination's breaker is open; the call was not attempted."""


class PartialDeliveryError(EgressError):
    """Part of an export was delivered before a terminal failure; only
    `undelivered` may be spilled for re-merge — re-sending the whole
    export would double-count counters at the receiver's Combine.
    `delivered_chunks`/`chunk_count` record where in the interval's
    chunk sequence the failure hit, so the replay can resend the tail
    under the SAME chunk ids (the receiver's dedupe ledger then drops
    a chunk that was ambiguously applied before the failure)."""

    def __init__(self, undelivered, cause: BaseException | None = None,
                 delivered_chunks: int = 0, chunk_count: int = 0):
        super().__init__(f"partial delivery: {cause}")
        self.undelivered = undelivered
        self.delivered_chunks = delivered_chunks
        self.chunk_count = chunk_count


class DeltaGapRefusedError(TerminalEgressError):
    """The receiver refused a DELTA chunk because the sender's seq
    chain has a gap below it (or the receiver has no baseline for this
    sender at all — a restart without durable watermarks). Raised by
    the leaf forwarders when they recognize the refusal on the wire
    (HTTP 409 / gRPC FAILED_PRECONDITION "delta-over-gap"); the
    ResilientForwarder catches it and, instead of parking a delta that
    would be refused forever, spills the payload into the merged
    overflow tier and forces the next interval to be a FULL resync —
    the refused delta was never applied (refusal precedes decode), so
    no data is lost and nothing double-counts."""


class HTTPStatusError(EgressError):
    """A transport returned an HTTP error status without raising (fake
    transports and non-urllib stacks); retryability follows the code."""

    def __init__(self, destination: str, status: int):
        super().__init__(f"{destination}: HTTP {status}")
        self.status = status


_RETRYABLE_HTTP = (408, 429)


def is_retryable(exc: BaseException) -> bool:
    """Classify one attempt's failure. Retryable: timeouts, connection
    errors, HTTP 5xx/408/429, URLErrors (DNS, refused-inside-urllib),
    and the transient gRPC codes. Terminal: HTTP 4xx (the payload or
    auth is wrong — retrying re-fails), INVALID_ARGUMENT-class gRPC
    codes, and anything unrecognized (fail fast, count, spill)."""
    if isinstance(exc, TransientEgressError):
        return True
    if isinstance(exc, TerminalEgressError):
        return False
    if isinstance(exc, CircuitOpenError):
        # an open breaker is a transient condition for OUTER callers
        # deciding whether to buffer/requeue (Egress.call itself never
        # classifies it — rejection happens before any attempt)
        return True
    if isinstance(exc, HTTPStatusError):
        return exc.status >= 500 or exc.status in _RETRYABLE_HTTP
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code >= 500 or exc.code in _RETRYABLE_HTTP
    # HTTPError subclasses URLError — this arm must come second
    if isinstance(exc, urllib.error.URLError):
        return True
    if isinstance(exc, (TimeoutError, ConnectionError)):
        return True
    try:
        import grpc
    except ImportError:         # pragma: no cover - grpc ships in-image
        grpc = None
    if grpc is not None and isinstance(exc, grpc.RpcError):
        code = exc.code() if callable(getattr(exc, "code", None)) else None
        return code in (grpc.StatusCode.UNAVAILABLE,
                        grpc.StatusCode.DEADLINE_EXCEEDED,
                        grpc.StatusCode.RESOURCE_EXHAUSTED,
                        grpc.StatusCode.ABORTED,
                        grpc.StatusCode.UNKNOWN)
    if isinstance(exc, OSError):
        return True
    return False


# ------------------------------------------------------------ envelope

@dataclass(frozen=True)
class ForwardEnvelope:
    """Idempotency identity of one interval's forward. The leaf
    forwarder stamps every wire chunk it emits with
    (sender_id, interval_seq, chunk_offset + j, chunk_count) — the
    receiver's dedupe ledger drops a chunk it has already Combined, so
    a retry or replay after an ambiguous failure (body applied,
    response lost) cannot double-count. chunk_count == 0 lets the leaf
    compute the total from its own chunking (the whole-interval case);
    a replayed partial tail carries the ORIGINAL total so its chunk ids
    line up with what the receiver already saw.

    `trace_id`/`span_id`/`close_ns` are the fleet-tracing context
    riding ALONGSIDE the identity (cluster/wire.py owns the wire
    encoding): the sender's flush-tick trace + root span id — so the
    receiver's import spans parent on the remote flush — and the
    interval-close wall time feeding the global's e2e latency. Zeros
    mean "no context" (recorder off, legacy sender) and encode to
    nothing; the dedupe path never reads them.

    `kind` is the delta-forwarding marker: "full" (the
    complete active sketch set — encodes to NOTHING, so legacy wire
    chunks stay byte-identical) or "delta" (only the sketches the
    dirty-slot bitmap saw touched this interval; the receiver applies
    it only over an unbroken seq chain)."""

    sender_id: str
    interval_seq: int
    chunk_offset: int = 0
    chunk_count: int = 0
    trace_id: int = 0
    span_id: int = 0
    close_ns: int = 0
    kind: str = "full"


def accepts_envelope(fn) -> bool:
    """Does a forwarder callable take an `envelope=` kwarg? Cached on
    the callable; plain test doubles and legacy forwarders that only
    take (export) keep working — they just forward un-enveloped
    (receiver applies everything: at-least-once, the old contract)."""
    # cache on the underlying function for bound methods — a method
    # object is recreated on every attribute access (and refuses
    # attribute writes), so caching on `fn` itself would re-run
    # signature introspection per call on the proxy fan-out hot path
    target = getattr(fn, "__func__", fn)
    cached = getattr(target, "_veneur_accepts_envelope", None)
    if cached is None:
        import inspect
        try:
            params = inspect.signature(fn).parameters.values()
            cached = any(p.name == "envelope"
                         or p.kind == p.VAR_KEYWORD for p in params)
        except (TypeError, ValueError):
            cached = False
        try:
            target._veneur_accepts_envelope = cached
        except AttributeError:
            pass
    return cached


def new_sender_id(hostname: str = "") -> str:
    """Default forward sender id: unique per process incarnation so a
    restart cannot collide with its predecessor's ledger entries (the
    old id's receiver state just ages out via the dedupe TTL)."""
    import os
    import uuid
    base = hostname or "veneur"
    return f"{base}-{os.getpid()}-{uuid.uuid4().hex[:8]}"


# ------------------------------------------------------------- policies

@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    base_backoff_s: float = 0.2
    max_backoff_s: float = 5.0
    # per-call (≈ per-flush, per-destination) wall budget: attempts,
    # socket timeouts and backoff sleeps all draw from it
    deadline_s: float = 8.0


@dataclass(frozen=True)
class BreakerPolicy:
    failure_threshold: int = 5
    open_duration_s: float = 30.0
    half_open_successes: int = 1


@dataclass(frozen=True)
class EgressPolicy:
    retry: RetryPolicy = RetryPolicy()
    breaker: BreakerPolicy = BreakerPolicy()


DEFAULT_POLICY = EgressPolicy()


def policy_from_config(cfg) -> EgressPolicy:
    """Build the shared egress policy from the Config knobs."""
    from .config import _parse_interval
    return EgressPolicy(
        retry=RetryPolicy(
            max_attempts=max(1, cfg.retry_max_attempts),
            base_backoff_s=_parse_interval(cfg.retry_backoff_base),
            max_backoff_s=_parse_interval(cfg.retry_backoff_cap),
            deadline_s=_parse_interval(cfg.retry_deadline)),
        breaker=BreakerPolicy(
            failure_threshold=max(1, cfg.breaker_failure_threshold),
            open_duration_s=_parse_interval(cfg.breaker_open_duration),
            half_open_successes=max(1, cfg.breaker_half_open_successes)))


# ------------------------------------------------------------- registry
#
# The per-destination counter registry grew into the process-wide
# telemetry spine (observe/registry.py) — one registry class for the
# egress counters here, the durability journal counters, AND the
# server's own accounting, with the veneur.* name mapping owned by the
# observe module. `ResilienceRegistry` (imported at the
# top of this module) stays exported under the historical name; the
# contracts of incr/take/peek are unchanged.


# -------------------------------------------------------------- breaker

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-destination breaker (state diagram in the module docstring).
    Thread-safe: sinks flush on their own threads and the proxy fans
    out concurrently."""

    def __init__(self, destination: str = "", policy: BreakerPolicy
                 | None = None, clock=time.monotonic,
                 registry: ResilienceRegistry | None = None):
        self.destination = destination
        self.policy = policy or BreakerPolicy()
        self._clock = clock
        self._registry = registry or DEFAULT_REGISTRY
        self._lock = threading.Lock()
        self._state = _CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._half_open_successes = 0
        self._probe_inflight = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call proceed now? Open→half-open transition happens
        here (lazily, on the first allow() after the cooldown)."""
        with self._lock:
            if self._state == _CLOSED:
                return True
            if self._state == _OPEN:
                if (self._clock() - self._opened_at
                        >= self.policy.open_duration_s):
                    self._state = _HALF_OPEN
                    self._half_open_successes = 0
                    self._probe_inflight = False
                else:
                    return False
            # half-open: admit one probe at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self):
        with self._lock:
            if self._state == _HALF_OPEN:
                self._probe_inflight = False
                self._half_open_successes += 1
                if (self._half_open_successes
                        >= self.policy.half_open_successes):
                    self._state = _CLOSED
            self._consecutive_failures = 0

    def record_failure(self):
        with self._lock:
            if self._state == _HALF_OPEN:
                self._probe_inflight = False
                self._trip_locked()
                return
            self._consecutive_failures += 1
            if (self._state == _CLOSED and self._consecutive_failures
                    >= self.policy.failure_threshold):
                self._trip_locked()

    def _trip_locked(self):
        self._state = _OPEN
        self._opened_at = self._clock()
        self._consecutive_failures = 0
        self._registry.incr(self.destination, "breaker_opened")


# --------------------------------------------------------------- egress

def _default_transport(req, timeout=None):
    """The layer's single raw HTTP call. urllib raises HTTPError for
    4xx/5xx, which is_retryable classifies by code."""
    return urllib.request.urlopen(req, timeout=timeout)


def grpc_channel(address: str):
    """The project's single gRPC channel constructor: egress channels
    are created here and nowhere else."""
    import grpc
    return grpc.insecure_channel(address)


class Egress:
    """One destination's resilient call wrapper: breaker consult, retry
    with full-jitter backoff, deadline budget, telemetry. Clock/sleep/
    rng/transport are injectable for the fault harness."""

    def __init__(self, destination: str,
                 policy: EgressPolicy | None = None,
                 breaker: CircuitBreaker | None = None,
                 transport=None, clock=time.monotonic,
                 sleep=time.sleep, rng: random.Random | None = None,
                 registry: ResilienceRegistry | None = None):
        self.destination = destination
        self.policy = policy or DEFAULT_POLICY
        self.registry = registry or DEFAULT_REGISTRY
        self._clock = clock
        self._sleep = sleep
        self._rng = rng or random.Random()
        self._transport = transport or _default_transport
        self.breaker = breaker or CircuitBreaker(
            destination, self.policy.breaker, clock=clock,
            registry=self.registry)

    # -- generic call wrapper --

    def deadline(self) -> float:
        """An absolute deadline one policy budget from now — pass it to
        several call()s (e.g. the batches of one flush) so they share
        ONE budget instead of each getting its own."""
        return self._clock() + self.policy.retry.deadline_s

    def call(self, fn, *args, timeout_s: float | None = None,
             deadline: float | None = None, **kwargs):
        """Run fn(*args, **kwargs) under retry/breaker/deadline. When
        `timeout_s` is given, each attempt receives a `timeout=` kwarg
        clamped to min(timeout_s, remaining deadline budget), so socket
        timeouts can never overrun the flush budget.

        The breaker is consulted ONCE, at call start, and records the
        call's FINAL outcome: the retry ladder is one logical delivery,
        so breaker_failure_threshold counts failed deliveries — a
        threshold <= max_attempts cannot cut retries short or mask the
        underlying error with CircuitOpenError mid-ladder."""
        retry = self.policy.retry
        reg, dest = self.registry, self.destination
        # flight-recorder attribution: when a flush tick is in progress
        # on THIS thread (the forward path), every attempt/backoff gets
        # its own phase; egress from other threads (span sinks) sees no
        # tick and records nothing.
        sc = _current_scope()
        tick = sc.tick if sc is not None else None
        par = sc.parent if sc is not None else -1
        if not self.breaker.allow():
            reg.incr(dest, "breaker_rejected")
            if tick is not None:
                tick.finish(tick.start("egress.breaker_rejected", par),
                            destination=dest)
            raise CircuitOpenError(
                f"{dest}: circuit open, call rejected")
        if deadline is None:
            deadline = self._clock() + retry.deadline_s
        attempt = 0
        while True:
            attempt += 1
            reg.incr(dest, "attempts")
            ph = -1 if tick is None else tick.start("egress.attempt",
                                                    par)
            try:
                if timeout_s is not None:
                    remaining = deadline - self._clock()
                    kwargs["timeout"] = max(
                        0.001, min(timeout_s, remaining))
                out = fn(*args, **kwargs)
            except Exception as e:
                if tick is not None:
                    tick.finish(ph, destination=dest, attempt=attempt,
                                outcome=type(e).__name__)
                now = self._clock()
                if (not is_retryable(e) or attempt >= retry.max_attempts
                        or now >= deadline):
                    self.breaker.record_failure()
                    reg.incr(dest, "failures")
                    raise
                delay = self._rng.uniform(0.0, min(
                    retry.max_backoff_s,
                    retry.base_backoff_s * (2 ** (attempt - 1))))
                delay = min(delay, max(0.0, deadline - now))
                reg.incr(dest, "retries")
                if delay > 0:
                    bp = -1 if tick is None else \
                        tick.start("egress.backoff", par)
                    self._sleep(delay)
                    if tick is not None:
                        tick.finish(bp, destination=dest)
                continue
            if tick is not None:
                tick.finish(ph, destination=dest, attempt=attempt,
                            outcome="ok")
            self.breaker.record_success()
            reg.incr(dest, "success")
            return out

    # -- HTTP helpers --

    def _http(self, req, reader, timeout_s, deadline):
        def _send(timeout=None):
            resp = self._transport(req, timeout=timeout)
            try:
                status = getattr(resp, "status", None) or 200
                if status >= 400:
                    raise HTTPStatusError(self.destination, status)
                return reader(resp, status)
            finally:
                close = getattr(resp, "close", None)
                if close is not None:
                    close()

        return self.call(_send, timeout_s=timeout_s, deadline=deadline)

    def post(self, req, timeout_s: float | None = None,
             deadline: float | None = None) -> int:
        """Send one urllib-style Request through the transport with the
        full resilience treatment; returns the final HTTP status. Pass
        one `deadline` (from .deadline()) across a flush's chunked
        bodies so they share a single budget."""
        return self._http(req, lambda resp, status: status, timeout_s,
                          deadline)

    def fetch(self, req, timeout_s: float | None = None,
              deadline: float | None = None) -> bytes:
        """Like post(), but returns the response body (for callers that
        consume what the destination says, e.g. discovery)."""
        return self._http(req, lambda resp, status: resp.read(),
                          timeout_s, deadline)


# ---------------------------------------------------------------- spill

class SpillBuffer:
    """Bounded holding pen for ForwardExport sketches whose delivery
    failed terminally. Same-key sketches merge on spill (so a long
    outage stays O(live keys), not O(intervals)); `merge_into` hands
    everything back to the next interval's export. Not thread-safe by
    itself — the owning ResilientForwarder serializes access (the
    server forwards from the single flusher thread)."""

    # one spilled key's concatenated centroid pile is clustered down
    # when it exceeds this (sum/count stay exact; shape approximate —
    # the same trade the import path's pre-clustering makes)
    CENTROID_CAP = 2048

    def __init__(self, max_sketches: int = 65536,
                 gauge_max_age_intervals: int = 4,
                 destination: str = "forward",
                 registry: ResilienceRegistry | None = None):
        self.max_sketches = max_sketches
        self.gauge_max_age = gauge_max_age_intervals
        self.destination = destination
        self.registry = registry or DEFAULT_REGISTRY
        # key -> [means, weights, min, max, sum, count, recip]
        self._histos: dict = {}
        self._sets: dict = {}      # key -> registers u8[m]
        # which set engine produced the spilled registers (same-key
        # re-merge must use THAT engine's join — elementwise max for
        # HLL, the lattice join for ULL); one server runs one engine,
        # so the latest spilled export's id covers the whole buffer
        self.set_engine = "hll"
        self._counters: dict = {}  # key -> float
        self._gauges: dict = {}    # key -> [value, age_in_failed_flushes]
        # gauge ages at the last merge_into, so a re-spill of the same
        # (still-undelivered) gauges continues their age instead of
        # restarting at 0 — without this, the merge->fail->spill cycle
        # would keep every stale gauge young forever
        self._merged_gauge_ages: dict = {}

    def __len__(self):
        return (len(self._histos) + len(self._sets)
                + len(self._counters) + len(self._gauges))

    @staticmethod
    def _cluster(means: np.ndarray, weights: np.ndarray, cap: int):
        """Weight-preserving cluster-down of a sorted centroid pile to
        <= cap points (equal-cumulative-weight buckets). Keeps sum and
        count exact; receivers re-cluster with k1 anyway."""
        order = np.argsort(means, kind="stable")
        means, weights = means[order], weights[order]
        if len(means) <= cap:
            return means, weights
        cum = np.cumsum(weights)
        edges = np.searchsorted(
            cum, np.linspace(0, cum[-1], cap + 1)[1:-1])
        edges = np.unique(np.concatenate([[0], edges]))
        wsum = np.add.reduceat(weights, edges)
        vsum = np.add.reduceat(means * weights, edges)
        keep = wsum > 0
        return (vsum[keep] / wsum[keep]).astype(means.dtype), \
            wsum[keep].astype(weights.dtype)

    def spill(self, export) -> int:
        """Absorb one failed interval's export; returns entries spilled.
        Ages + evicts stale gauges, then enforces the sketch budget."""
        n = 0
        for key, means, weights, vmin, vmax, vsum, cnt, recip in (
                export.histograms):
            means = np.asarray(means, np.float32)
            weights = np.asarray(weights, np.float32)
            live = weights > 0
            means, weights = means[live], weights[live]
            cur = self._histos.get(key)
            if cur is None:
                self._histos[key] = [means, weights, float(vmin),
                                     float(vmax), float(vsum),
                                     float(cnt), float(recip)]
            else:
                m = np.concatenate([cur[0], means])
                w = np.concatenate([cur[1], weights])
                if len(m) > self.CENTROID_CAP:
                    m, w = self._cluster(m, w, self.CENTROID_CAP)
                cur[0], cur[1] = m, w
                cur[2] = min(cur[2], float(vmin))
                cur[3] = max(cur[3], float(vmax))
                cur[4] += float(vsum)
                cur[5] += float(cnt)
                cur[6] += float(recip)
            n += 1
        self.set_engine = getattr(export, "set_engine", "hll")
        from . import sketches
        for key, regs in export.sets:
            regs = np.asarray(regs, np.uint8)
            cur = self._sets.get(key)
            self._sets[key] = (regs if cur is None
                               else sketches.merge_registers(
                                   self.set_engine, cur, regs))
            n += 1
        for key, value in export.counters:
            self._counters[key] = self._counters.get(key, 0.0) \
                + float(value)
            n += 1
        # gauges: age everything already pending by one failed
        # interval, evict over-age. An incoming gauge that was part of
        # the last merge_into is the SAME still-undelivered value
        # coming back — it continues its age (+1); a key re-reported
        # fresh this interval appears again later in the list (merge
        # prepends stale) and resets to 0 via the consumed-age pop.
        merged_ages, self._merged_gauge_ages = \
            self._merged_gauge_ages, {}
        evicted = 0
        for key in list(self._gauges):
            self._gauges[key][1] += 1
            if self._gauges[key][1] > self.gauge_max_age:
                del self._gauges[key]
                evicted += 1
        for key, value in export.gauges:
            age = merged_ages.pop(key, -1) + 1
            if age > self.gauge_max_age:
                evicted += 1
                continue
            self._gauges[key] = [float(value), age]
            n += 1
        evicted += self._enforce_budget()
        self.registry.incr(self.destination, "spilled", n)
        self.registry.incr(self.destination, "spill_evicted", evicted)
        return n

    def _enforce_budget(self) -> int:
        evicted = 0
        # oldest-inserted first, heaviest type first (dict order is
        # insertion order); counters/gauges are scalars and go last
        for d in (self._histos, self._sets, self._counters,
                  self._gauges):
            while len(self) > self.max_sketches and d:
                d.pop(next(iter(d)))
                evicted += 1
        return evicted

    def merge_into(self, export):
        """Merge everything pending into `export` (in place) and clear.
        Spilled entries PREPEND — they are strictly OLDER than the
        current interval's, and the receiver's import landing clusters
        piles in arrival order, so chronological order keeps a
        spill-carrying interval's merge as close as possible to what
        separate in-order deliveries would have produced (exactly what
        the delta gap-fallback's bit-identity probe pins; for gauges
        prepending is also what makes the current interval's fresher
        value win last-write-wins at the receiver). Gauge ages are
        remembered so that if THIS export fails too, the re-spill
        continues them (reset unconditionally: a successful delivery
        must not leak ages onto later fresh values)."""
        self._merged_gauge_ages = {key: age for key, (_v, age)
                                   in self._gauges.items()}
        if not len(self):
            return export
        n = len(self)
        export.histograms[:0] = (
            (key, h[0], h[1], h[2], h[3], h[4], h[5], h[6])
            for key, h in self._histos.items())
        if self._sets and self.set_engine != getattr(
                export, "set_engine", "hll"):
            # a journal-restored spill from a DIFFERENT set backend
            # (operator switched set_backend across a restart): the
            # outgoing export can only tag one engine, so mis-tagged
            # rows would merge under wrong semantics downstream —
            # drop them loudly instead (counted; registers are the
            # one spill type that cannot cross engines)
            self.registry.incr(self.destination, "spill_evicted",
                               len(self._sets))
            log.warning(
                "dropping %d spilled set sketches: spilled under "
                "set_backend %r, forwarding under %r",
                len(self._sets), self.set_engine,
                getattr(export, "set_engine", "hll"))
            n -= len(self._sets)
        else:
            export.sets[:0] = self._sets.items()
        export.counters[:0] = self._counters.items()
        export.gauges[:0] = [(key, v) for key, (v, _a)
                             in self._gauges.items()]
        self._histos, self._sets = {}, {}
        self._counters, self._gauges = {}, {}
        self.registry.incr(self.destination, "remerged", n)
        return export


def _export_size(export) -> int:
    return (len(export.histograms) + len(export.sets)
            + len(export.counters) + len(export.gauges))


class _ReplayEntry:
    """One failed interval awaiting replay under its ORIGINAL envelope.
    `chunk_offset`/`chunk_count` track partial-delivery progress: a
    tail replay carries the same chunk ids the first send used, so the
    receiver's ledger can drop a chunk that was ambiguously applied."""

    __slots__ = ("seq", "chunk_offset", "chunk_count", "export", "age",
                 "close_ns", "kind")

    def __init__(self, seq, export, chunk_offset=0, chunk_count=0,
                 close_ns=0, kind="full"):
        self.seq = seq
        self.export = export
        self.chunk_offset = chunk_offset
        self.chunk_count = chunk_count
        self.age = 0   # failed flushes survived (gauge eviction clock)
        # ORIGINAL interval-close time: a replay re-stamps the current
        # tick's trace ids (the replay runs inside this tick's span
        # tree) but keeps the close time it was born with, so the
        # global's e2e latency honestly includes replay-ladder delay.
        # 0 = unknown (journal-recovered entries; e2e is skipped).
        self.close_ns = close_ns
        # the full/delta kind the interval was BUILT as, pinned for its
        # whole ladder life: a replay re-declares what the payload IS,
        # not what the current tick would build (a delta re-stamped as
        # full would skip the receiver's gap check while still only
        # carrying the touched subset — harmless to merge, but it
        # would silently reset the gap baseline the check rides on).
        self.kind = kind


class ResilientForwarder:
    """Wraps the server's forwarder callable with the exactly-once
    spill/replay contract. Each interval's export is stamped with a
    fresh `ForwardEnvelope` (monotonic interval_seq under a stable
    sender_id); a failing send (terminal — the inner forwarder owns
    its own retry/breaker) parks the interval in a bounded replay
    ledger KEEPING that envelope. The next flush replays pending
    intervals oldest-first, each under its original ids, before the
    current interval goes out — so the receiver Combines seqs strictly
    in order (the bit-identical re-merge argument needs ordered
    Combine) and its dedupe ledger drops anything it already applied
    during an ambiguous failure. A replay failure stops the ladder:
    the current export is parked unsent rather than delivered out of
    order.

    The ledger holds at most `max_spill_intervals` entries /
    `max_spill_sketches` sketches; overflow demotes the OLDEST entries
    into the same-key-merged SpillBuffer, whose contents ride the
    current interval's fresh envelope instead (`reenveloped` counted:
    those sketches degrade to the old at-least-once contract — a
    duplicate is possible only if their original failure was ambiguous
    AND the outage outlived the ledger). Called only from the flusher
    thread, like the forwarder it wraps."""

    def __init__(self, inner, destination: str = "forward",
                 max_spill_sketches: int = 65536,
                 gauge_max_age_intervals: int = 4,
                 max_spill_intervals: int = 8,
                 sender_id: str | None = None,
                 seq_start: int | None = None,
                 replay_budget_s: float | None = None,
                 clock=time.monotonic,
                 journal=None,
                 delta_enabled: bool = True,
                 full_resync_intervals: int = 60,
                 registry: ResilienceRegistry | None = None):
        """`seq_start` seeds the interval_seq space. Auto-generated
        sender ids are unique per process incarnation, so they start at
        1; a CONFIGURED (stable) sender_id MUST seed from wall time —
        a restart that reset to 1 would put every new seq below the
        receiver ledger's persisted watermark for that sender and
        blackhole all forwards until the dedupe TTL (the sender keeps
        sending, so last_seen stays fresh and idle eviction never
        fires). Wall MILLISECONDS: seqs advance 1/interval per second
        while the seed advances 1000/s, so a restart's seed outruns the
        previous incarnation's watermark for any flush interval > 1ms
        (seconds-granularity seeding would lose that race below 1s
        intervals).

        `journal` (a durability.ForwardJournal, optional) makes the
        ladder crash-safe: every mutation appends one op record, the
        current interval is written ahead of any wire traffic, and
        construction REPLAYS the journal — parked intervals come back
        with their ORIGINAL envelopes (sender_id and seqs restored from
        the journal, overriding the arguments), so the receiver's
        dedupe ledger still drops anything it Combined before the
        crash. With journal=None behavior is bit-identical to the
        pre-durability forwarder."""
        self.inner = inner
        self.destination = destination
        self.registry = registry or DEFAULT_REGISTRY
        if sender_id:
            self.sender_id = sender_id
            if seq_start is None:
                seq_start = int(time.time() * 1000)
        else:
            self.sender_id = new_sender_id()
        self.max_spill_intervals = max(1, max_spill_intervals)
        self.max_spill_sketches = max_spill_sketches
        self.gauge_max_age = gauge_max_age_intervals
        # wall budget for ONE flush's whole replay ladder: without it,
        # max_spill_intervals slow-failing replays could each burn a
        # full inner retry_deadline and stall the flush tick for
        # N x deadline — the exact unbounded-stall shape the egress
        # layer's shared batch deadline exists to prevent. None = no
        # budget (unit-test / library use); the server wires
        # 2 x retry_deadline.
        self.replay_budget_s = replay_budget_s
        self._clock = clock
        self._takes_envelope = accepts_envelope(inner)
        self._next_seq = seq_start if seq_start is not None else 1
        # Delta forwarding: next_forward_kind() tells the
        # flush what to build. The FIRST interval of an incarnation is
        # always full (the receiver has no seq baseline for this
        # sender yet); thereafter deltas flow until a periodic resync
        # is due (`full_resync_intervals` — re-ships idle keys so the
        # global's series liveness refreshes) or a resync is FORCED:
        # a ladder demotion re-envelopes an interval, punching a hole
        # in the seq chain a receiver must never apply a delta over,
        # and a receiver's delta-over-gap refusal means its baseline
        # is gone — both set _force_full.
        self.delta_enabled = bool(delta_enabled)
        self.full_resync_intervals = max(0, int(full_resync_intervals))
        self._force_full = True
        self._since_full = 0
        self._entries: list[_ReplayEntry] = []
        self.spill = SpillBuffer(
            max_sketches=max_spill_sketches,
            gauge_max_age_intervals=gauge_max_age_intervals,
            destination=destination, registry=self.registry)
        self._journal = journal
        if journal is not None:
            self._recover(journal)
            # pin the (possibly recovered) identity so even a compacted
            # or fresh journal is self-describing
            self._jop("meta", self.sender_id, self._next_seq)

    def _jop(self, method: str, *args):
        """Run one journal op. A failing journal (disk full, I/O
        error) must never cost an interval the pre-durability code
        would have delivered or parked losslessly — so the op degrades:
        journaling is disabled for this process (counted, logged
        loudly) and the forward proceeds unjournaled. The on-disk
        journal keeps its last consistent state; a restart recovers
        from it (recovered intervals replay under their envelopes, so
        any that DID deliver after the degradation dedupe at the
        receiver)."""
        jrn = self._journal
        if jrn is None:
            return
        sc = _current_scope()
        tick = sc.tick if sc is not None else None
        ph = -1 if tick is None else tick.start("journal." + method,
                                                sc.parent)
        try:
            getattr(jrn, method)(*args)
            if tick is not None:
                tick.finish(ph)
        except Exception:
            if tick is not None:
                tick.finish(ph, outcome="error")
            self._journal = None
            self.registry.incr(self.destination,
                               "durability.journal_errors")
            log.exception(
                "durability journal %s failed for %s; DISABLING "
                "journaling for this process (forwarding continues "
                "unjournaled — the pre-durability lossless contract); "
                "state parked before this point recovers on restart",
                method, self.destination)
            try:
                jrn.close()
            except Exception:
                pass

    # ------------------------------------------------ durable recovery

    def _recover(self, journal):
        """Rebuild the ladder + spill tier by replaying the journal's
        op records in write order. The ops are deterministic given the
        export payloads stored in BEGIN/UPDATE records, so the
        recovered state matches the crashed incarnation's at its last
        append — counters are NOT re-incremented for sketches the
        previous incarnation already counted (a scratch registry
        absorbs them); only the durability.recovered_* counters fire."""
        from .durability import records as drec

        ops = journal.load_ops()
        scratch = ResilienceRegistry()
        real_reg, self.registry = self.registry, scratch
        real_spill_reg, self.spill.registry = self.spill.registry, scratch
        try:
            for rec_type, payload in ops:
                try:
                    self._apply_op(drec, rec_type, payload)
                except Exception as e:   # pragma: no cover - corrupt op
                    # a record that frames+CRCs clean but fails to parse
                    # (version skew) must not kill startup; everything
                    # before it is kept, it and later state-dependent
                    # drift is surfaced loudly
                    log.warning("durability: unreadable journal record "
                                "type=%d dropped during recovery: %s",
                                rec_type, e)
        finally:
            self.registry = real_reg
            self.spill.registry = real_spill_reg
        if self._entries or len(self.spill):
            self.registry.incr(self.destination,
                               "durability.recovered_intervals",
                               len(self._entries))
            self.registry.incr(self.destination,
                               "durability.recovered_sketches",
                               self.pending_spill)
            log.info(
                "durability: recovered %d parked interval(s) / %d "
                "sketch(es) for %s; replaying under their original "
                "envelopes (sender_id=%s)", len(self._entries),
                self.pending_spill, self.destination, self.sender_id)

    def _apply_op(self, drec, rec_type: int, payload: bytes):
        if rec_type == drec.REC_META:
            sender_id, next_seq = drec.decode_meta(payload)
            self.sender_id = sender_id
            self._next_seq = max(self._next_seq, next_seq)
        elif rec_type == drec.REC_BEGIN:
            seq, off, cnt, age, export, kind = \
                drec.decode_begin(payload)
            entry = _ReplayEntry(seq, export, off, cnt, kind=kind)
            entry.age = age
            self._entries.append(entry)
            self._next_seq = max(self._next_seq, seq + 1)
        elif rec_type == drec.REC_DONE:
            seq = drec.decode_done(payload)
            self._entries = [e for e in self._entries if e.seq != seq]
        elif rec_type == drec.REC_UPDATE:
            seq, off, cnt, export = drec.decode_update(payload)
            for entry in self._entries:
                if entry.seq == seq:
                    entry.export = export
                    entry.chunk_offset = off
                    if cnt:
                        entry.chunk_count = cnt
        elif rec_type == drec.REC_AGE:
            self._age_entries()
        elif rec_type == drec.REC_DEMOTE:
            if self._entries:
                self.spill.spill(self._entries.pop(0).export)
        elif rec_type == drec.REC_SPILL_MERGE:
            # the drained contents ride the current interval, whose
            # BEGIN/UPDATE record follows — here only clear + remember
            # gauge ages, exactly what merge_into did live
            from .models.pipeline import ForwardExport
            self.spill.merge_into(ForwardExport())
        elif rec_type == drec.REC_SPILL_STATE:
            drec.decode_spill_state(payload, self.spill)

    def durable_snapshot_records(self) -> list:
        """Full-state record list for snapshot compaction: replaying
        just these reconstructs the ladder + spill tier."""
        from .durability import records as drec
        out = [(drec.REC_META,
                drec.encode_meta(self.sender_id, self._next_seq)),
               (drec.REC_SPILL_STATE, drec.encode_spill_state(self.spill))]
        out.extend(
            (drec.REC_BEGIN,
             drec.encode_begin(e.seq, e.chunk_offset, e.chunk_count,
                               e.age, e.export, e.kind))
            for e in self._entries)
        return out

    def journal_tick(self):
        """Flush-boundary hook (the server calls it once per tick):
        fsync per policy and compact when the journal outgrew its
        budget. Failures degrade like any other journal op."""
        if self._journal is None:
            return
        self._jop("sync")
        self._jop("maybe_compact", self.durable_snapshot_records)

    @property
    def pending_spill(self) -> int:
        """Sketches awaiting replay or re-merge; the server forwards
        even an otherwise-empty interval while this is nonzero, so
        spilled data cannot strand when traffic stops."""
        return sum(_export_size(e.export) for e in self._entries) \
            + len(self.spill)

    def next_forward_kind(self) -> str:
        """What the NEXT interval's export build should be: "delta"
        (only dirty-bitmap-touched sketches) or "full" (the complete
        active set — the first interval, every `full_resync_intervals`
        thereafter, after any ladder demotion or receiver gap refusal,
        and always when the inner forwarder rotates across multiple
        destinations, where no single receiver sees a contiguous seq
        chain). Read-only: the resync bookkeeping advances in
        __call__, when an interval of that kind actually enters the
        ladder — an idle tick must not eat a scheduled resync."""
        if not self.delta_enabled or self._force_full:
            return "full"
        if not getattr(self.inner, "delta_capable", True):
            return "full"
        if self.full_resync_intervals and \
                self._since_full + 1 >= self.full_resync_intervals:
            return "full"
        return "delta"

    def _send(self, export, envelope: ForwardEnvelope):
        if self._takes_envelope:
            self.inner(export, envelope=envelope)
        else:
            self.inner(export)

    def _park(self, seq, export, chunk_offset=0, chunk_count=0,
              close_ns=0, kind="full"):
        n = _export_size(export)
        if n == 0:
            return 0
        self._entries.append(
            _ReplayEntry(seq, export, chunk_offset, chunk_count,
                         close_ns, kind))
        self.registry.incr(self.destination, "spilled", n)
        self._enforce_ledger_budget()
        return n

    def _demote_front_to_spill(self, counter: str):
        """Move the OLDEST ladder entry into the merged overflow tier
        (the one demotion shape the REC_DEMOTE journal op replays).
        Punches a permanent hole in the seq chain — that seq will
        never be delivered under its own envelope — so the next
        interval is forced to a full resync: a receiver must never be
        asked to apply a delta over the gap."""
        entry = self._entries.pop(0)
        self.registry.incr(self.destination, counter,
                           _export_size(entry.export))
        self._jop("demote")
        # SpillBuffer.spill counts these under "spilled" again;
        # compensate so spilled_total keeps meaning "sketches that
        # entered the resilience layer", not internal shuffles
        added = self.spill.spill(entry.export)
        self.registry.incr(self.destination, "spilled", -added)
        self._force_full = True

    def _enforce_ledger_budget(self):
        """Demote oldest entries to the merged overflow tier until the
        replay ledger fits its interval/sketch bounds."""
        def total():
            return sum(_export_size(e.export) for e in self._entries)
        while self._entries and (
                len(self._entries) > self.max_spill_intervals
                or total() > self.max_spill_sketches):
            self._demote_front_to_spill("reenveloped")

    def _age_entries(self):
        """One failed flush elapsed with these entries still pending:
        age them, and strip over-age gauges (last-write-wins data is
        only meaningful fresh). Gauges sit at the TAIL of the wire
        order, so stripping them never shifts an earlier metric across
        a frozen chunk boundary of a partially-delivered entry."""
        evicted = 0
        for entry in list(self._entries):
            entry.age += 1
            if entry.age > self.gauge_max_age and entry.export.gauges:
                evicted += len(entry.export.gauges)
                entry.export.gauges[:] = []
                if _export_size(entry.export) == 0:
                    self._entries.remove(entry)
                    # the emptied entry's seq will never be delivered —
                    # a hole in the chain, so the next interval must be
                    # a full resync (same rule as a demotion; without
                    # this every later delta eats one avoidable
                    # refusal round-trip)
                    self._force_full = True
        self.registry.incr(self.destination, "spill_evicted", evicted)

    def _note_interval_kind(self, kind: str):
        """Resync bookkeeping, called once per interval that entered
        the ladder or the wire: a FULL interval (even one merely
        parked — it replays under its pinned kind and delivers
        eventually) restarts the resync countdown; a delta advances
        it."""
        if kind == "full":
            self._force_full = False
            self._since_full = 0
        else:
            self._since_full += 1

    def __call__(self, export):
        reg, dest = self.registry, self.destination
        # what the engine actually built this interval ("full" unless
        # the flush consumed the dirty bitmap at the server's request)
        cur_kind = getattr(export, "kind", "full")
        replay_err = None
        # fleet-tracing context from the tick in progress: every wire
        # chunk this call emits (replays included) is stamped with the
        # CURRENT tick's trace identity — the receiver parents its
        # import spans under this flush — while close_ns keeps each
        # interval's ORIGINAL close time (replay honesty). No tick
        # (recorder off, library use) stamps nothing.
        _sc0 = _current_scope()
        _tick0 = _sc0.tick if _sc0 is not None else None
        trace_id = _tick0.trace_id if _tick0 is not None else 0
        span_id = _tick0.span_id if _tick0 is not None else 0
        cur_close = _tick0.close_ns if _tick0 is not None else 0
        # -- durability write-ahead: the current interval enters the
        # journal (seq allocated now) BEFORE any wire traffic, so a
        # hard kill anywhere in this tick — mid-replay-ladder included
        # — cannot lose it; a clean delivery appends DONE below. With
        # no journal the seq is allocated at the same points as before.
        # Journal ops go through _jop: a failing disk degrades to
        # unjournaled forwarding instead of costing the interval.
        cur_seq = None
        if self._journal is not None and _export_size(export):
            cur_seq = self._next_seq
            self._next_seq += 1
            self._jop("begin", cur_seq, 0, 0, 0, export, cur_kind)
        # -- replay phase: pending intervals first, oldest seq first,
        # under their ORIGINAL envelopes; stop at the first failure so
        # the receiver observes seqs strictly in order.
        budget_deadline = (None if self.replay_budget_s is None
                           else self._clock() + self.replay_budget_s)
        while self._entries and replay_err is None:
            if budget_deadline is not None \
                    and self._clock() >= budget_deadline:
                replay_err = TransientEgressError(
                    f"{dest}: replay ladder budget "
                    f"({self.replay_budget_s:.1f}s) exhausted; "
                    f"{len(self._entries)} intervals deferred to the "
                    "next flush")
                break
            entry = self._entries[0]
            env = ForwardEnvelope(self.sender_id, entry.seq,
                                  entry.chunk_offset, entry.chunk_count,
                                  trace_id=trace_id, span_id=span_id,
                                  close_ns=entry.close_ns,
                                  kind=entry.kind)
            sc = _current_scope()
            tick = sc.tick if sc is not None else None
            rp = -1 if tick is None else \
                tick.start("forward.replay", sc.parent)
            if tick is not None:
                tick.annotate(rp, seq=entry.seq)
            try:
                self._send(entry.export, env)
            except DeltaGapRefusedError:
                # the receiver has no unbroken chain below this delta
                # (its baseline died — restart without watermarks — or
                # an earlier demotion holed the chain). Parking it for
                # replay would be a livelock: the same delta refused
                # forever. Its data is intact (refusal precedes any
                # apply), so demote it to the merged tier — it rides
                # the NEXT interval, which _demote_front_to_spill just
                # forced to a full resync — and keep draining the
                # ladder (later deltas above the same gap fall back
                # the same way).
                if tick is not None:
                    tick.finish(rp, outcome="delta_gap")
                reg.incr(dest, "delta_gap_refused")
                log.warning(
                    "forward to %s: receiver refused delta seq %d over "
                    "a seq gap; payload re-routed through the overflow "
                    "tier, next interval forced to a full resync",
                    dest, entry.seq)
                self._demote_front_to_spill("delta_gap_fallback")
                continue
            except PartialDeliveryError as e:
                entry.export = e.undelivered
                entry.chunk_offset += e.delivered_chunks
                if e.chunk_count:
                    entry.chunk_count = e.chunk_count
                if tick is not None:
                    tick.finish(rp, outcome="partial")
                self._jop("update", entry.seq, entry.chunk_offset,
                          entry.chunk_count, entry.export)
                replay_err = e
            except Exception as e:
                if tick is not None:
                    tick.finish(rp, outcome=type(e).__name__)
                replay_err = e
            else:
                if tick is not None:
                    tick.finish(rp, outcome="ok")
                reg.incr(dest, "replayed", _export_size(entry.export))
                self._entries.pop(0)
                self._jop("done", entry.seq)
        if replay_err is not None:
            # park the current interval unsent: delivering it ahead of
            # the failed replay would reorder seqs at the receiver.
            # The overflow tier stays put — absorbing it here would
            # just bounce its sketches back into the ledger.
            if _export_size(export):
                if cur_seq is None:
                    cur_seq = self._next_seq
                    self._next_seq += 1
                self._park(cur_seq, export, close_ns=cur_close,
                           kind=cur_kind)
                self._note_interval_kind(cur_kind)
            self._age_entries()
            self._jop("age")
            log.warning(
                "forward to %s failed on replay; current interval "
                "parked for in-order retry (%d sketches pending)",
                dest, self.pending_spill)
            raise replay_err
        # -- overflow tier: sketches that outlived the replay ledger
        # ride the CURRENT interval's envelope (their at-least-once
        # degradation was already counted as reenveloped)
        had_spill = len(self.spill) > 0
        export = self.spill.merge_into(export)
        if had_spill:
            self._jop("spill_merge")
        if _export_size(export) == 0:
            return
        if cur_seq is None:
            cur_seq = self._next_seq
            self._next_seq += 1
            # the interval only materialized from the spill tier (or
            # journaling is off); write it ahead now
            if self._journal is not None:
                self._jop("begin", cur_seq, 0, 0, 0, export, cur_kind)
        elif had_spill:
            # the spill merge changed the written-ahead payload
            self._jop("update", cur_seq, 0, 0, export)
        seq = cur_seq
        sc = _current_scope()
        tick = sc.tick if sc is not None else None
        sp = -1 if tick is None else tick.start("forward.send",
                                                sc.parent)
        if tick is not None:
            tick.annotate(sp, seq=seq)
        try:
            self._send(export, ForwardEnvelope(
                self.sender_id, seq, trace_id=trace_id,
                span_id=span_id, close_ns=cur_close, kind=cur_kind))
        except DeltaGapRefusedError:
            # same fallback as the replay arm: the refused delta was
            # never applied, so its payload spills to the merged tier
            # and rides the next interval — which the demotion forces
            # to a full resync. NOT re-raised: nothing was lost, the
            # counters carry the signal (delta_gap_refused/_fallback).
            if tick is not None:
                tick.finish(sp, outcome="delta_gap")
            reg.incr(dest, "delta_gap_refused")
            self._park(seq, export, close_ns=cur_close, kind=cur_kind)
            if self._entries and self._entries[0].seq == seq:
                self._demote_front_to_spill("delta_gap_fallback")
            else:
                # _park's budget enforcement already demoted the entry
                # (an export past max_spill_sketches) — the demotion
                # counted it as reenveloped and the resync must still
                # be forced
                self._force_full = True
            log.warning(
                "forward to %s: receiver refused delta seq %d over a "
                "seq gap (no baseline for sender %s); payload rides "
                "the next interval's full resync", dest, seq,
                self.sender_id)
            return
        except PartialDeliveryError as e:
            # some chunks landed: park only what didn't, resuming at
            # the failed chunk's id. The UPDATE record goes first so
            # recovery shrinks the written-ahead payload to the
            # undelivered tail BEFORE any demote the park may trigger.
            if tick is not None:
                tick.finish(sp, outcome="partial")
            self._jop("update", seq, e.delivered_chunks, e.chunk_count,
                      e.undelivered)
            n = self._park(seq, e.undelivered,
                           chunk_offset=e.delivered_chunks,
                           chunk_count=e.chunk_count,
                           close_ns=cur_close, kind=cur_kind)
            self._note_interval_kind(cur_kind)
            self._age_entries()
            self._jop("age")
            log.warning(
                "forward to %s partially failed; %d undelivered "
                "sketches parked for replay under their original "
                "envelope", dest, n)
            raise
        except Exception as e:
            if tick is not None:
                tick.finish(sp, outcome=type(e).__name__)
            n = self._park(seq, export, close_ns=cur_close,
                           kind=cur_kind)
            self._note_interval_kind(cur_kind)
            self._age_entries()
            self._jop("age")
            log.warning(
                "forward to %s failed; %d sketches parked for replay "
                "under their original envelope", dest, n)
            raise
        else:
            if tick is not None:
                tick.finish(sp, outcome="ok")
            self._note_interval_kind(cur_kind)
            self._jop("done", seq)

    def debug_state(self) -> dict:
        """JSON-ready ladder/spill/journal/breaker state for the
        /debug/flush introspection endpoint. Reads only (flusher-thread
        sizes may be one tick stale from another thread — fine for a
        debug surface)."""
        egress = (getattr(self.inner, "egress", None)
                  or getattr(self.inner, "_egress", None))
        breaker = getattr(egress, "breaker", None)
        jrn = self._journal
        return {
            "destination": self.destination,
            "sender_id": self.sender_id,
            "next_seq": self._next_seq,
            "ladder": [{"seq": e.seq, "age": e.age,
                        "chunk_offset": e.chunk_offset,
                        "chunk_count": e.chunk_count,
                        "kind": e.kind,
                        "sketches": _export_size(e.export)}
                       for e in self._entries],
            "spill_sketches": len(self.spill),
            "pending_spill": self.pending_spill,
            "breaker_state": (None if breaker is None
                              else breaker.state),
            "journal": (None if jrn is None else {
                "bytes": jrn.size_bytes()}),
            # delta-forwarding posture: what the next
            # interval will build and why
            "delta": {
                "enabled": self.delta_enabled,
                "next_kind": self.next_forward_kind(),
                "force_full": self._force_full,
                "since_full": self._since_full,
                "full_resync_intervals": self.full_resync_intervals,
            },
        }

    def close(self):
        if self._journal is not None:
            self._journal.close()
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()
