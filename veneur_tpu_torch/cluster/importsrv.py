"""The global tier's gRPC receive path — the port's copy of
veneur_tpu/cluster/importsrv.py.

Parity: importsrv/server.go (sym: importsrv.Server.SendMetrics,
MetricIngester): implements forwardrpc.Forward, re-hashes each received
metric by its key digest onto a worker, whose engine merges it via the
Combine kernels (engine.import_*).

Wired with grpc's generic handler API (no grpcio-tools codegen needed):
method names + message serializers define the service.

Exactly-once: requests carrying an idempotency envelope
(forwardrpc.Envelope on SendMetrics, the `veneur-envelope-bin`
metadata header on the SendMetricsV2 stream) are checked against a
bounded per-sender `DedupeLedger` BEFORE any metric reaches a worker
queue — a chunk the ledger has already admitted is dropped whole, so a
sender's retry or spill-replay after an ambiguous failure (body
Combined, response lost) cannot double-count. Envelope-less requests
(legacy senders) bypass the ledger and keep the old at-least-once
contract.

grpc, the wire and the generated messages are imported inside the calls
that serve an RPC: the dedupe ledger also guards the HTTP /import path
of a server that runs no gRPC listener, and importing this module for
it loads neither grpc nor protobuf.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from concurrent import futures

from ..resilience import DEFAULT_REGISTRY, ResilienceRegistry
from ..utils.hashing import metric_digest

log = logging.getLogger("veneur_tpu_torch.cluster.importsrv")


class ImportedMetric:
    """Worker-queue envelope for a forwarded metricpb.Metric."""

    __slots__ = ("pb",)

    def __init__(self, pb):
        self.pb = pb


class ImportedBatch:
    """Worker-queue envelope for one journaled import op's share of
    metrics for ONE engine (durability/): the worker applies
    the group atomically (engine.import_list) and the op id advances
    that engine's applied-op watermark — the consistent cut the
    engine checkpoint's replay filter depends on. Only the durable
    submit path (Server._submit_import_batch) produces these; the
    per-metric ImportedMetric path is unchanged when the engine
    journal is off."""

    __slots__ = ("op_id", "pbs")

    def __init__(self, op_id, pbs):
        self.op_id = op_id
        self.pbs = pbs


class _SenderState:
    __slots__ = ("watermark", "seqs", "last_seen", "max_seq")

    def __init__(self, now: float):
        self.watermark = 0          # every seq <= watermark is a dup
        # seq -> [set(chunk_idx), expected_chunk_count (0 = unknown)]
        self.seqs: OrderedDict = OrderedDict()
        self.last_seen = now
        # highest seq EVER seen from this sender (admitted or deduped)
        # — the delta gap check's baseline: a delta at seq <= max_seq+1
        # sits on an unbroken chain (the sender emits seqs contiguously
        # and replays in order, so seeing N implies N-1.. were offered)
        self.max_seq = 0


class DedupeLedger:
    """Bounded per-sender replay dedupe for forwarded intervals.

    For each sender the ledger keeps a seq WATERMARK plus the
    chunk-index sets of the most recent `max_seqs_per_sender`
    sequences. `admit()` answers "apply or drop?" for one incoming
    chunk:

      * seq <= watermark          -> drop (an old replay)
      * chunk already recorded    -> drop (retry / replay duplicate)
      * otherwise                 -> record and apply

    Bounds (all eviction is counted and documented in README
    "Exactly-once forward"):

      * per-sender, evicting a seq's chunk set past
        `max_seqs_per_sender` advances the watermark to it — a replay
        arriving AFTER that many newer intervals is dropped unseen
        (bounded under-count, only under a pathological
        replay-starves-while-newer-delivers pattern; the sender
        replays oldest-first, which makes it unreachable in practice);
      * `max_senders` senders, LRU-evicted — a brand-new sender id
        beyond the bound forgets the coldest sender entirely (its
        in-flight replays degrade to at-least-once);
      * a sender idle longer than `ttl_s` is forgotten on the next
        admit (same degradation; restarted senders use a fresh id, so
        idle entries are garbage by construction);
      * one seq's chunk set is capped at MAX_CHUNKS_PER_SEQ (a sane
        sender ships ~1 chunk per 10-25k metrics; thousands of chunk
        ids under one seq is a bug or abuse) — hitting the cap evicts
        the seq to the watermark and rejects the overflow chunk
        (counted `forward.chunk_overflow`), so a network-facing
        receiver's memory stays bounded no matter what arrives.

    Thread-safe: gRPC handler threads and HTTP /import handler threads
    consult the same ledger. The clock is injectable for the fault
    harness."""

    MAX_CHUNKS_PER_SEQ = 4096

    def __init__(self, max_seqs_per_sender: int = 512,
                 max_senders: int = 1024, ttl_s: float = 3600.0,
                 destination: str = "import",
                 clock=time.monotonic,
                 registry: ResilienceRegistry | None = None):
        self.max_seqs_per_sender = max(1, max_seqs_per_sender)
        self.max_senders = max(1, max_senders)
        self.ttl_s = ttl_s
        self.destination = destination
        self._clock = clock
        self._registry = registry or DEFAULT_REGISTRY
        self._lock = threading.Lock()
        self._senders: OrderedDict[str, _SenderState] = OrderedDict()
        self._size = 0              # tracked chunk entries, all senders

    def _drop(self, n_chunks: int = 1) -> bool:
        self._registry.incr(self.destination,
                            "forward.duplicates_dropped", n_chunks)
        return False

    def _forget_sender(self, sender_id: str):
        st = self._senders.pop(sender_id, None)
        if st is not None:
            self._size -= sum(len(s[0]) for s in st.seqs.values())

    def admit(self, sender_id: str, seq: int, chunk_index: int,
              chunk_count: int = 0) -> bool:
        """True = apply this chunk; False = duplicate, drop it whole."""
        with self._lock:
            now = self._clock()
            # TTL: the LRU end of the sender map is the least recently
            # seen sender; evict idle ones (restarts use fresh ids)
            while self._senders:
                oldest = next(iter(self._senders.values()))
                if now - oldest.last_seen <= self.ttl_s:
                    break
                self._forget_sender(next(iter(self._senders)))
            st = self._senders.get(sender_id)
            if st is None:
                while len(self._senders) >= self.max_senders:
                    self._forget_sender(next(iter(self._senders)))
                st = self._senders[sender_id] = _SenderState(now)
            else:
                self._senders.move_to_end(sender_id)
                st.last_seen = now
            if seq <= st.watermark:
                return self._drop()
            st.max_seq = max(st.max_seq, seq)
            entry = st.seqs.get(seq)
            if entry is None:
                entry = st.seqs[seq] = [set(), int(chunk_count or 0)]
                while len(st.seqs) > self.max_seqs_per_sender:
                    evicted_seq, evicted = st.seqs.popitem(last=False)
                    st.watermark = max(st.watermark, evicted_seq)
                    self._size -= len(evicted[0])
            elif chunk_index in entry[0]:
                return self._drop()
            if chunk_count:
                # a replayed tail carries the ORIGINAL total; keep the
                # freshest nonzero claim (completeness feeds
                # max_admitted — partial seqs must not become durable
                # watermarks)
                entry[1] = int(chunk_count)
            chunks = entry[0]
            if len(chunks) >= self.MAX_CHUNKS_PER_SEQ:
                # abuse guard: evict the bloated seq wholesale and
                # reject the overflow chunk, keeping memory bounded
                self._size -= len(chunks)
                del st.seqs[seq]
                st.watermark = max(st.watermark, seq)
                self._registry.incr(self.destination,
                                    "forward.chunk_overflow")
                return False
            chunks.add(chunk_index)
            self._size += 1
            return True

    def check_delta(self, sender_id: str, seq: int) -> bool:
        """May a DELTA chunk at `seq` be applied for this sender? True
        iff the sender's seq chain is unbroken below it: some seq has
        been seen before AND `seq` is at most one past the highest
        (equal-or-below = a replay/extra chunk, dedupe decides). False
        — counted `veneur.forward.delta_gap_refused_total` — when the
        sender is unknown (this receiver has no baseline: a restart
        without durable watermarks, or a brand-new sender whose first
        send should have been full) or `seq` skips ahead (an earlier
        interval was demoted to the sender's re-envelope tier and will
        never arrive under its own seq). The caller refuses the chunk
        LOUDLY before any decode/apply work; the sender's fallback
        spills the payload and forces a full resync, so refusal never
        loses data. Consulted BEFORE admit() — a refusal must not mark
        chunks as seen."""
        with self._lock:
            st = self._senders.get(sender_id)
            if st is not None:
                last = max(st.watermark, st.max_seq)
                if last > 0 and seq <= last + 1:
                    return True
            self._registry.incr(self.destination,
                                "forward.delta_gap_refused")
            return False

    def max_admitted(self) -> dict:
        """Per-sender max COMPLETELY-admitted interval_seq (the
        watermark plus any tracked seq whose every chunk arrived). The
        server journals this at each flush boundary
        (durability.WatermarkJournal) so a restarted global can refuse
        ancient replays of intervals it already flushed downstream
        before the crash. Partially-admitted seqs are excluded: making
        one a durable watermark would permanently refuse the
        undelivered tail the sender is still replaying. A seq with an
        unknown total (chunk_count 0 — single-chunk/legacy stamping)
        counts as complete on first admission."""
        out = {}
        with self._lock:
            for sid, st in self._senders.items():
                mark = st.watermark
                for seq, (chunks, expected) in st.seqs.items():
                    if len(chunks) >= expected:
                        mark = max(mark, seq)
                out[sid] = mark
        return out

    def restore_watermarks(self, marks: dict) -> int:
        """Recovery-before-listen: seed per-sender watermarks from the
        durable journal. Every restored seq becomes a hard floor —
        seq <= watermark is dropped — so a replay of a pre-crash
        interval cannot double-count downstream. Chunk sets are NOT
        restored (they died with the engine state they guarded; a
        replay of a NOT-yet-flushed interval re-admits and re-applies,
        which is correct because its first application was lost with
        the crash). Returns the number of senders restored."""
        n = 0
        with self._lock:
            now = self._clock()
            for sender_id, seq in marks.items():
                st = self._senders.get(sender_id)
                if st is None:
                    if len(self._senders) >= self.max_senders:
                        self._forget_sender(next(iter(self._senders)))
                    st = self._senders[sender_id] = _SenderState(now)
                st.watermark = max(st.watermark, int(seq))
                st.max_seq = max(st.max_seq, int(seq))
                n += 1
        return n

    def size(self) -> int:
        """Tracked chunk entries across all senders (the
        veneur.forward.dedupe_ledger_size gauge)."""
        with self._lock:
            return self._size

    def sender_count(self) -> int:
        with self._lock:
            return len(self._senders)

    def clear(self):
        """Teardown: forget everything (graceful shutdown, after
        in-flight SendMetrics have drained)."""
        with self._lock:
            self._senders.clear()
            self._size = 0


class ForwardHandler:
    """A grpc generic RPC handler (grpc takes any object with a
    `service` method) serving forwardrpc.Forward."""

    def __init__(self, submit, ledger: DedupeLedger | None = None,
                 registry: ResilienceRegistry | None = None,
                 observer=None, submit_batch=None,
                 engine_stamp: str | None = None, note_stamp=None,
                 merge_sketches=None):
        """`submit(worker_index_hash, ImportedMetric)` routes one metric;
        the Server provides a queue-backed implementation. `ledger`
        (optional) dedupes envelope-bearing requests. `observer`
        (optional, an observe.ImportObserver) records each request's
        dedupe/apply phases in the import ring, replays them as SSF
        spans parented on the remote sender's flush span, and feeds
        the per-sender fleet view — observability only, it never
        changes what is admitted or applied. `submit_batch` (optional,
        `submit_batch([(digest, pb), ...])`) routes one request's
        metrics as a unit — the reference's durable path, which
        write-aheads the batch to the engine journal before any worker
        queue sees it (ROADMAP item 11; the port's Server passes None).

        `engine_stamp` (the server's sketch-engine/wire stamp):
        requests whose declared stamp — or implied legacy
        default, for unstamped peers — does not match are ABORTED
        with FAILED_PRECONDITION before any metric reaches a queue;
        incompatible register banks must never merge silently.
        `note_stamp(sender, stamp, ok)` records every verdict
        (counted + per-sender /debug/fleet rows); `merge_sketches`
        receives a request's advisory per-prefix cardinality rows
        (the fleet-wide cardinality satellite)."""
        self._submit = submit
        self._submit_batch = submit_batch
        self._ledger = ledger
        self._registry = registry or DEFAULT_REGISTRY
        self._observer = observer
        self._engine_stamp = engine_stamp
        self._note_stamp = note_stamp
        self._merge_sketches = merge_sketches

    def service(self, details):
        import grpc

        from . import wire
        from .forward import SEND_METRICS, SEND_METRICS_V2
        from .protos import forward_pb2
        if details.method == SEND_METRICS:
            return grpc.unary_unary_rpc_method_handler(
                self._send_metrics,
                request_deserializer=forward_pb2.MetricList.FromString,
                response_serializer=forward_pb2.Empty.SerializeToString)
        if details.method == SEND_METRICS_V2:
            return grpc.stream_unary_rpc_method_handler(
                self._send_metrics_v2,
                request_deserializer=wire.metric_pb2.Metric.FromString,
                response_serializer=forward_pb2.Empty.SerializeToString)
        return None

    def _route(self, m):
        # poison-pill guard: one malformed metric (bad key bytes, a
        # decoder error) must reject THAT metric, not kill the
        # receive path (veneur.import.rejected_total; the worker-side
        # Combine guard in server._worker_loop covers decode errors
        # that only surface at apply time)
        from . import wire
        try:
            key = wire.metric_key_of(m)
            digest = metric_digest(key.name, key.type, key.joined_tags)
        except Exception as e:
            self._registry.incr("import", "import.rejected")
            log.warning("rejected unroutable imported metric: %s", e)
            return
        self._submit(digest, ImportedMetric(m))

    def _route_all(self, metrics, env=None) -> int:
        """Digest + route one request's metrics: a single batch-submit
        call when the server provided one (the write-ahead journal
        must see the request as ONE op — with its admitted envelope —
        before any queue does), else the legacy per-metric submit.
        Returns the routed count."""
        from . import wire
        if self._submit_batch is None:
            n = 0
            for m in metrics:
                self._route(m)
                n += 1
            return n
        pairs = []
        for m in metrics:
            try:
                key = wire.metric_key_of(m)
                digest = metric_digest(key.name, key.type,
                                       key.joined_tags)
            except Exception as e:
                self._registry.incr("import", "import.rejected")
                log.warning("rejected unroutable imported metric: %s", e)
                continue
            pairs.append((digest, m))
        self._submit_batch(pairs, env)
        return len(pairs)

    def _check_stamp(self, remote, env) -> bool:
        """Engine-stamp verdict for one request; on False the verdict
        has already been counted/recorded and the caller must abort
        without applying anything."""
        if self._engine_stamp is None:
            return True      # handler built without an engine context
        from .. import sketches
        ok = sketches.stamp_compatible(self._engine_stamp, remote)
        if not ok:
            # mismatches record + count HERE (the sender is alive and
            # misconfigured — the fleet page must show it); ACCEPTED
            # stamps only annotate via the observer scope, after the
            # normal admission path proves the request decodable
            if self._note_stamp is not None:
                self._note_stamp(env[0] if env else "(unknown)",
                                 remote, False)
            else:
                self._registry.incr("import", "import.engine_mismatch")
            log.warning(
                "rejected forward with incompatible sketch engines: "
                "remote %r, local %r", remote, self._engine_stamp)
        return ok

    def _admit(self, env) -> bool:
        if env is None or self._ledger is None:
            return True
        return self._ledger.admit(*env)

    def _delta_gap(self, env, kind: str) -> bool:
        """Gap verdict for one request, BEFORE any metric is routed: a
        delta may only be applied over an unbroken per-sender seq
        chain (check_delta counts refusals). Envelope-less or
        ledger-less receivers cannot gap-check and apply the delta
        as-is (merge semantics stay sound; documented degradation).
        The caller aborts with the DELTA_GAP_DETAIL marker so the
        sender's fallback (spill + full resync) recognizes it."""
        if kind != "delta" or env is None or self._ledger is None:
            return False
        return not self._ledger.check_delta(env[0], env[1])

    def _apply(self, scope, env, metrics) -> None:
        """The shared admit-then-route tail, phase-attributed."""
        ph = scope.start("dedupe")
        ok = self._admit(env)
        scope.finish(ph, admitted=ok)
        scope.admitted = ok
        if not ok:
            return
        ph = scope.start("apply")
        n = self._route_all(metrics, env)
        scope.finish(ph, n_metrics=n)
        scope.n_metrics = n

    def _send_metrics(self, request, context):
        import grpc

        from . import wire
        from .protos import forward_pb2
        env = wire.envelope_from_metric_list(request)
        trace = wire.trace_from_metric_list(request)
        remote = wire.sketch_stamp_from_metric_list(request)
        if not self._check_stamp(remote, env):
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "sketch engine/wire-format mismatch")
        if self._delta_gap(env,
                           wire.forward_kind_from_metric_list(request)):
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"{wire.DELTA_GAP_DETAIL}: no unbroken seq chain "
                f"below delta seq {env[1]} for sender {env[0]!r}; "
                "send a full resync")
        if self._merge_sketches is not None and request.prefix_sketches:
            self._merge_sketches(wire.prefix_sketches_from_pb(request))
        obs = self._observer
        if obs is None:
            if self._admit(env):
                self._route_all(request.metrics, env)
            return forward_pb2.Empty()
        kw = {} if self._engine_stamp is None else {"stamp": remote}
        with obs.request(env, trace, "grpc", **kw) as scope:
            self._apply(scope, env, request.metrics)
        return forward_pb2.Empty()

    def _send_metrics_v2(self, request_iterator, context):
        import grpc

        from . import wire
        from .protos import forward_pb2
        md = getattr(context, "invocation_metadata", None)
        md = md() if callable(md) else None
        env = wire.envelope_from_metadata(md)
        trace = wire.trace_from_metadata(md)
        remote = wire.sketch_stamp_from_metadata(md)
        if not self._check_stamp(remote, env):
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "sketch engine/wire-format mismatch")
        if self._delta_gap(env, wire.forward_kind_from_metadata(md)):
            # before the stream is consumed: nothing is admitted, the
            # sender's whole-interval fallback re-routes the payload
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"{wire.DELTA_GAP_DETAIL}: no unbroken seq chain "
                f"below delta seq {env[1]} for sender {env[0]!r}; "
                "send a full resync")
        obs = self._observer
        kw = {} if self._engine_stamp is None else {"stamp": remote}
        if env is None or self._ledger is None:
            if obs is None:
                self._route_all(request_iterator)
                return forward_pb2.Empty()
            with obs.request(env, trace, "grpc-stream", **kw) as scope:
                scope.admitted = True
                ph = scope.start("apply")
                n = self._route_all(request_iterator)
                scope.finish(ph, n_metrics=n)
                scope.n_metrics = n
            return forward_pb2.Empty()
        # materialize the stream BEFORE consulting the ledger: if the
        # client connection dies mid-stream the exception aborts the
        # RPC with nothing admitted, so the sender's whole-stream retry
        # under the same envelope still applies (admitting first would
        # record a half-received chunk as delivered and dedupe the
        # retry away). The unary arm gets this for free — its request
        # is fully deserialized before the handler runs.
        metrics = list(request_iterator)
        if obs is None:
            if self._ledger.admit(*env):
                self._route_all(metrics, env)
            return forward_pb2.Empty()
        with obs.request(env, trace, "grpc-stream", **kw) as scope:
            self._apply(scope, env, metrics)
        return forward_pb2.Empty()


def start_import_server(address: str, submit, max_workers: int = 8,
                        ledger: DedupeLedger | None = None,
                        registry: ResilienceRegistry | None = None,
                        observer=None, submit_batch=None,
                        engine_stamp: str | None = None,
                        note_stamp=None, merge_sketches=None):
    """Bind a gRPC server for the Forward service; returns (server, port)."""
    import grpc
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(
        (ForwardHandler(submit, ledger=ledger, registry=registry,
                        observer=observer, submit_batch=submit_batch,
                        engine_stamp=engine_stamp,
                        note_stamp=note_stamp,
                        merge_sketches=merge_sketches),))
    port = server.add_insecure_port(address)
    server.start()
    log.info("importsrv listening on %s", address)
    return server, port


def stop_import_server(server, grace: float = 5.0, *,
                       clock=time.monotonic, sleep=time.sleep) -> bool:
    """Gracefully stop an import server: new RPCs are rejected
    immediately, in-flight SendMetrics get up to `grace` seconds to
    complete (so their metrics reach the worker queues and the dedupe
    ledger records them BEFORE it is torn down). Returns True when the
    server fully stopped within the grace window. clock/sleep are
    injectable (fault harness) so the expiry path is testable without
    real waiting."""
    done = server.stop(grace)
    deadline = clock() + grace
    while not done.is_set() and clock() < deadline:
        sleep(0.01)
    return done.is_set()
