"""The Server: listeners + sharded engines + flush loop + watchdog — the
local and global tiers of veneur_tpu/server.py, over the port's
AggregationEngine.

Parity: server.go (sym: Server, NewFromConfig, Server.Start,
Server.HandleMetricPacket, Server.ReadMetricSocket, Server.Shutdown),
flusher.go (sym: Server.Flush, Server.FlushWatchdog), networking.go.

Threading model (the reference's, unchanged):
  * `num_readers` UDP reader threads per listen address (SO_REUSEPORT
    sockets); TCP, UNIX and TLS stream listeners, a thread per
    connection. SSF listeners: one UDP reader per address (a datagram
    is one span), TCP/UNIX streams of framed spans, a thread per
    connection.
  * Readers parse inline and route each sample by digest to one of
    `num_workers` worker queues (`Workers[Digest % len(Workers)]`).
    Spans go to one span queue; the span worker hands each to every
    span sink, and the always-present ssfmetrics sink routes the
    samples a span carries onto the worker queues like parsed lines.
  * With `overload_defense_enabled`, one admission controller is shared
    by every engine's interners (per-prefix key budgets, folds into
    `<prefix>.__other__`) and by `handle_packet` (the adaptive shed).
  * Each worker thread owns one AggregationEngine — engines own disjoint
    hash-space shards, so flush is a union, never a merge. On the card
    every launch goes to the current (default) stream; the engine's lock
    orders `process` against the flush's bank swap.
  * The global tier's gRPC import handlers and the HTTP POST /import
    handlers only decode, dedupe and enqueue: each imported metric goes
    to the worker queue its digest names, and the worker thread lands
    it in its engine (staged digests every 8192 launch compress there).
    No handler thread touches a bank.
  * One flush thread ticks every `interval`, flushes all engines (in
    threads when there are several), fans out to sinks (a thread per
    sink) and plugins, then hands the merged export to the forwarder
    (a `resilience.ResilientForwarder`: exactly-once envelopes, the
    replay ladder and the spill tier).
  * A watchdog thread counts overdue ticks and, when configured, exits
    the process for its supervisor to restart.

The device is the caller's `device`, else "cpu" when
`aggregation_backend: cpu`, else "cuda" — which raises where there is no
card, as AggregationEngine does. With an SSF UDP listener the server
traces its own flushes through it. With `tpu_num_devices` > 1 the one
worker runs a MeshAggregationEngine (parallel/) over a 1 x n grid of
shards, shard i on cuda:(i mod the number of cards). Pairings the
reference itself fails in are refused at construction with
NotImplementedError naming their ROADMAP entry, never ignored. The
network sinks (Datadog, SignalFx, Kafka, New Relic, Prometheus, the span
sinks), the S3 plugin and the
sentry client are built from the config as the reference builds them.
The forwarders, the import server, the falconer sink and their wire
(grpc, google.protobuf) are imported only when the config needs them.

With `native_ingest` the C++ bridge (ingest/native.py over
native/vtpu_ingest.cpp) takes the Python UDP readers' place: its reader
threads parse and intern into ONE engine's slot space, and a pump thread
lands their batches in that engine's banks on the device. When the
ssfmetrics sink is the only span sink the bridge also decodes SSF
datagrams and stages their samples (the native SSF path);
STATUS-carrying spans fall back to the Python span pipeline.

With `durability_enabled` the server keeps the reference's journals in
`durability_dir` (the port's durability/ package, the same bytes): the
forwarder's op log, the dedupe watermarks and, on an import tier, the
engine journal, whose write-ahead import ops and flush-boundary engine
checkpoints let a restarted global flush what the crashed one would
have. Recovery runs in the constructor, before any listener binds. With
`history_retention_generations` the closed intervals are kept as query
generations behind GET /query, answered by scratch engines on the
server's device.
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import threading
import time

from . import observe, resilience, sketches
from .config import Config, _parse_interval
from .ingest import parser
from .metrics import FrameSet, InterMetric, MetricType
from .models.pipeline import (AggregationEngine, EngineConfig,
                              ForwardExport, _not_ported)
from .sinks import MetricSink
from .sinks.basic import (BlackholeMetricSink, BlackholeSpanSink,
                          DebugMetricSink, LocalFilePlugin)
from .sinks.ssfmetrics import SSFMetricsSink

log = logging.getLogger("veneur_tpu_torch.server")

_STOP = object()

# (config key, refused when, ROADMAP queue A item): the keys whose value
# this port cannot honour yet — none since the multi-device engine and the
# fetch modes (items 14 and 16); what it still refuses, the reference
# refuses too (refuse_unported, the mesh engine's constructor)
REFUSED_KEYS = ()


def _fold_rewrite(pb, fr) -> int:
    """Apply an ImportFoldReroute's rewrite to the pb IN PLACE (the fold
    key is tagless by construction) and return the fold key's digest,
    the single-homed fold routing basis. One definition for both worker
    arms that re-route a fold."""
    pb.name = fr.key.name
    del pb.tags[:]
    return fr.digest


def refuse_unported(cfg: Config) -> None:
    """Raise NotImplementedError for the first config key whose value the
    port cannot honour."""
    for key, refused, item in REFUSED_KEYS:
        v = getattr(cfg, key)
        if refused(v):
            raise _not_ported(f"{key}={v!r}", item)
    if cfg.native_ingest and (cfg.forward_address
                              or cfg.consul_forward_service_name):
        # the reference's native server raises out of every flush in this
        # pairing: a full forward export asks its interner views for
        # all_items(), which they lack
        raise NotImplementedError(
            "native_ingest with forwarding (forward_address or "
            "consul_forward_service_name) is refused by veneur_tpu_torch: "
            "the reference fails every flush of that pairing (ROADMAP "
            "C.11)")
    if cfg.native_ingest and cfg.tpu_num_devices > 1 \
            and cfg.native_pump_batch != cfg.tpu_batch_size:
        # the reference's mesh engine has no pump-width warm-up: its
        # server raises AttributeError ('_kern') out of start() whenever
        # the pump's batch differs from the engine's
        raise NotImplementedError(
            "native_ingest with tpu_num_devices > 1 and native_pump_batch "
            "!= tpu_batch_size is refused by veneur_tpu_torch: the "
            "reference's start() fails in that pairing (ROADMAP C.15)")
    if cfg.tpu_fused_kernels == "off":
        raise NotImplementedError(
            "tpu_fused_kernels='off' is not supported by veneur_tpu_torch: "
            "the port has no path without its hand-written kernels "
            "(ROADMAP queue B)")


class Server:
    def __init__(self, cfg: Config, sinks: list[MetricSink] | None = None,
                 plugins=None, device=None, span_sinks=None,
                 forwarder=None):
        """`forwarder` (optional): a callable(ForwardExport) to forward
        each interval through, in place of the one the config names
        (`forward_address` or `consul_forward_service_name`); either is
        wrapped in a ResilientForwarder unless it already is one."""
        refuse_unported(cfg)
        if not cfg.tpu_flush_double_buffer:
            log.info("tpu_flush_double_buffer: false — the port's flush is "
                     "always double-buffered, which flushes the same rows")
        self.cfg = cfg
        if device is None:
            device = "cpu" if cfg.aggregation_backend == "cpu" else "cuda"
        self.hostname = cfg.hostname or (
            "" if cfg.omit_empty_hostname else socket.gethostname())
        # native ingest: the C++ bridge owns interning over ONE engine's
        # slot space; its reader threads are the parallelism. A mesh
        # engine likewise owns the whole slot space (sharded over devices)
        self._mesh_mode = cfg.tpu_num_devices > 1
        n_workers = (1 if cfg.native_ingest or self._mesh_mode
                     else max(1, cfg.num_workers))
        ecfg_kw = dict(
            histogram_slots=max(256, cfg.tpu_histogram_slots // n_workers),
            counter_slots=max(128, cfg.tpu_counter_slots // n_workers),
            gauge_slots=max(128, cfg.tpu_gauge_slots // n_workers),
            set_slots=max(64, cfg.tpu_set_slots // n_workers),
            batch_size=cfg.tpu_batch_size,
            buffer_depth=cfg.tpu_buffer_depth,
            compression=cfg.tpu_compression,
            hll_precision=cfg.tpu_hll_precision,
            histogram_backend=cfg.histogram_backend,
            set_backend=cfg.set_backend,
            ull_precision=cfg.tpu_ull_precision,
            req_levels=cfg.tpu_req_levels,
            req_capacity=cfg.tpu_req_capacity,
            percentiles=tuple(cfg.percentiles),
            aggregates=tuple(cfg.aggregates),
            idle_ttl_intervals=cfg.tpu_slot_idle_ttl_intervals,
            flush_fetch=cfg.tpu_flush_fetch,
            flush_fetch_f16=cfg.tpu_flush_fetch_f16,
            flush_incremental=cfg.tpu_flush_incremental,
            flush_incremental_threshold=cfg.tpu_flush_incremental_threshold,
            forward_enabled=bool(cfg.forward_address
                                 or cfg.consul_forward_service_name),
            # a server with a gRPC import listener is (also) a global tier
            is_global=cfg.is_global or bool(cfg.grpc_listen_addresses),
            hostname=self.hostname,
        )
        if self._mesh_mode:
            # ONE engine whose banks are sharded over a 1 x n grid: slot
            # routing replaces worker sharding; shard i on cuda:(i mod the
            # cards), all n on the CPU for the CPU backend (ROADMAP C.14).
            # Forwarding and the non-default backends stay refused by the
            # engine's constructor, as the reference's.
            from .parallel.engine import MeshAggregationEngine
            from .parallel.mesh import shard_devices
            self.engines = [MeshAggregationEngine(
                EngineConfig(**ecfg_kw),
                devices=shard_devices(device, cfg.tpu_num_devices))]
        else:
            self.engines = [AggregationEngine(EngineConfig(**ecfg_kw),
                                              device=device)
                            for _ in range(n_workers)]
        self.device = self.engines[0].device
        self.worker_queues: list[queue.Queue] = [
            queue.Queue(maxsize=65536) for _ in range(n_workers)]
        # the sketch-engine/wire stamp, declared on every forwarded chunk
        # and enforced on every import request; the forward centroid
        # codec folds in, so a q16 fleet reads as a distinct wire format
        self.engine_stamp = sketches.stamp_with_codec(
            self.engines[0].engine_stamp, cfg.forward_centroid_codec)
        # fleet-wide per-prefix cardinality: received sketches merge by
        # max here, keyed by prefix; /debug/fleet serves the estimates
        self._fleet_sketch_lock = threading.Lock()
        self._fleet_sketches: dict[str, bytearray] = {}
        self.native_bridge = None
        self.native_pump = None
        if cfg.native_ingest:
            self._setup_native_ingest()
        # per-server telemetry registry (two servers in one process never
        # cross-count); _self_metrics drains it and the process default
        self.telemetry = observe.TelemetryRegistry()
        # overload defense: ONE controller shared by every engine's
        # interners (per-prefix key budgets + fold-to-other) and by
        # handle_packet (adaptive shed); None = defense off
        self.admission = None
        self._rate_corrected_types = None
        if cfg.overload_defense_enabled and self.native_bridge is not None:
            log.warning(
                "overload_defense_enabled has no effect with native_ingest "
                "(the C++ bridge owns interning); defense disabled")
        elif cfg.overload_defense_enabled:
            from .ingest import admission as _admission
            self.admission = _admission.from_config(cfg, self.telemetry)
            self._rate_corrected_types = _admission.RATE_CORRECTED_TYPES
            # index/n/reroute single-home each fold key on the engine
            # its digest routes to: one flush, one row per `__other__`
            # series, however many workers
            for i, eng in enumerate(self.engines):
                eng.attach_admission(self.admission, index=i,
                                     n=len(self.engines),
                                     reroute=self._route_metric)
        # one shared egress policy (retry/breaker knobs) for every
        # config-built sink and forwarder; per-destination breakers live
        # inside each Egress
        self._egress_policy = resilience.policy_from_config(cfg)
        self.sinks = sinks if sinks is not None else self._sinks_from_config()
        if plugins is not None:
            self.plugins = plugins
        else:
            self.plugins = []
            if cfg.flush_file:
                self.plugins.append(LocalFilePlugin(
                    cfg.flush_file, max(1, round(cfg.interval_seconds))))
            if cfg.aws_s3_bucket:
                from .sinks.s3 import S3Plugin
                self.plugins.append(S3Plugin(
                    bucket=cfg.aws_s3_bucket, region=cfg.aws_region,
                    access_key=cfg.aws_access_key_id,
                    secret_key=cfg.aws_secret_access_key,
                    interval_s=max(1, round(cfg.interval_seconds)),
                    egress_policy=self._egress_policy))
        if forwarder is None:
            forwarder = self._forwarder_from_config()
        # Durable state (off by default): crash-safe journals for the
        # sender's replay ladder and spill tier and the receiver's dedupe
        # watermarks. Recovery runs HERE, before start() binds any
        # listener, so a restarted process resumes its ladder under the
        # original envelopes and a restarted global refuses ancient
        # replays before the first request arrives.
        self._forward_journal = None
        self._dedupe_journal = None
        will_wrap = forwarder is not None and not isinstance(
            forwarder, resilience.ResilientForwarder)
        if cfg.durability_enabled and will_wrap:
            from .durability import ForwardJournal
            self._forward_journal = ForwardJournal(
                cfg.durability_dir, fsync=cfg.durability_fsync,
                fsync_interval_s=_parse_interval(
                    cfg.durability_fsync_interval),
                snapshot_journal_bytes=cfg.durability_snapshot_journal_bytes)
        if will_wrap:
            # lossless-forward contract: a failed interval's sketches
            # are parked under their envelope and replayed, or spilled
            # and re-merged into the next flush, never dropped; with the
            # journal the ladder survives a crash
            forwarder = resilience.ResilientForwarder(
                forwarder,
                destination=(cfg.forward_address
                             or cfg.consul_forward_service_name
                             or "forward"),
                max_spill_sketches=cfg.spill_max_sketches,
                gauge_max_age_intervals=cfg.spill_gauge_max_age_intervals,
                max_spill_intervals=cfg.spill_max_intervals,
                sender_id=(cfg.forward_sender_id
                           or resilience.new_sender_id(self.hostname)),
                # one wall budget for the whole replay ladder (plus the
                # current send's own retry_deadline)
                replay_budget_s=2 * _parse_interval(cfg.retry_deadline),
                # the flush asks next_forward_kind() what to build
                delta_enabled=cfg.forward_delta,
                full_resync_intervals=cfg.forward_full_resync_intervals,
                # recovery happens inside the constructor: parked
                # intervals come back with their original envelopes
                journal=self._forward_journal)
        self.forwarder = forwarder   # callable(ForwardExport) or None
        # receiver side of the exactly-once contract: one dedupe ledger
        # shared by the gRPC import server and HTTP POST /import, so a
        # sender that fails over between them still dedupes
        self.dedupe_ledger = None
        receives = bool(cfg.grpc_listen_addresses or cfg.http_address
                        or cfg.is_global)
        if cfg.forward_dedupe_enabled and receives:
            from .cluster.importsrv import DedupeLedger
            self.dedupe_ledger = DedupeLedger(
                max_seqs_per_sender=cfg.forward_dedupe_max_seqs_per_sender,
                max_senders=cfg.forward_dedupe_max_senders,
                ttl_s=_parse_interval(cfg.forward_dedupe_ttl))
            if cfg.durability_enabled:
                # recovery-before-listen: restore the per-sender
                # watermarks the last incarnation flushed under, so an
                # ancient replay is dropped, not double-counted
                from .durability import WatermarkJournal
                self._dedupe_journal = WatermarkJournal(
                    cfg.durability_dir, fsync=cfg.durability_fsync,
                    fsync_interval_s=_parse_interval(
                        cfg.durability_fsync_interval))
                marks = self._dedupe_journal.load()
                if marks:
                    n = self.dedupe_ledger.restore_watermarks(marks)
                    resilience.DEFAULT_REGISTRY.incr(
                        "import", "durability.recovered_watermarks", n)
                # watermarks are journaled ONE TICK BEHIND (see
                # _durability_tick): a seq admitted mid-tick may still
                # sit in a worker queue when this tick's engines swap
                self._pending_watermarks: dict = {}
        # Global-tier engine checkpointing: every admitted import op is
        # write-ahead journaled (in _submit_import_batch, before the
        # worker queues and so before the sender's ack), and each flush
        # boundary appends a self-contained checkpoint group per engine
        # (dirty rows, interner tables, staged imports, the applied-op
        # watermark). Recovery runs here, before any listener binds:
        # the latest committed group per engine, then the ops above its
        # watermark through the normal digest routing, so the restarted
        # global flushes bit for bit what the crashed one would have.
        # Armed on the import tiers (a gRPC import listener or a
        # declared global), not on http_address alone.
        self._engine_journal = None
        self._engine_journal_armed = False
        self._recovery = None            # restore stats for /debug, health
        self._recovering = False         # True until start() completes
        self._next_import_op = 0
        self._recent_import_ops: list = []   # (op_id, bytes), 2-tick window
        self._import_ops_evicted = False     # cap evicted since last seal
        self._ops_at_last_checkpoint = 0
        self._last_checkpoint_sig = None
        self._last_checkpoint_t = None
        self._last_checkpoint_stats = (0, 0)   # (dirty, total) piles
        self._import_submit_lock = threading.Lock()
        # the time-travel query tier (durability/history.py): armed with
        # the engine journal once the flight recorder exists
        self._history = None
        self._query_tier = None
        self._history_baseline = None    # (recs, marks, empty) of the
        #                                  previous boundary
        self._history_prev_close_ns = 0
        engine_journal = (cfg.durability_enabled
                          and cfg.durability_engine_snapshot
                          and (cfg.grpc_listen_addresses or cfg.is_global))
        if engine_journal and (self._mesh_mode
                               or self.native_bridge is not None):
            log.warning(
                "durability_engine_snapshot has no effect with a "
                "mesh engine or native_ingest (the %s owns the "
                "banks/interner); engine checkpointing disabled",
                "mesh" if self._mesh_mode else "native bridge")
        elif engine_journal:
            from .durability import EngineJournal
            self._engine_journal_armed = True
            self._recovering = True
            self._engine_journal = EngineJournal(
                cfg.durability_dir, fsync=cfg.durability_fsync,
                fsync_interval_s=_parse_interval(
                    cfg.durability_fsync_interval),
                snapshot_journal_bytes=cfg.durability_snapshot_journal_bytes)
            for eng in self.engines:
                eng.enable_dirty_tracking(
                    cfg.durability_engine_delta_threshold)
            self._recover_engine_state()
        # the receiving tier's fleet view (per-sender e2e and freshness,
        # behind /debug/fleet) and the import observer that phase-
        # attributes each import request and parents its spans on the
        # sender's flush span: observability only, admission and apply
        # are the same with it on or off
        self.fleet = None
        self.import_observer = None
        if receives:
            self.fleet = observe.FleetView(
                max_senders=cfg.fleet_max_senders,
                window=cfg.fleet_e2e_window)
            import_ring = None
            if cfg.flight_recorder:
                import_ring = observe.FlightRecorder(
                    capacity=cfg.flight_recorder_ticks, max_phases=16)
            self.import_observer = observe.ImportObserver(
                fleet=self.fleet, flight=import_ring,
                client=lambda: self.trace_client)
        self._grpc_servers = []
        self.grpc_port = None     # the last gRPC import listener's port
        # the last interval's forward bytes by destination (under
        # _stats_lock)
        self._last_forward_bytes = None
        self._last_forward_err = None   # sentry dedupe, under _stats_lock
        self._sentry = None
        if cfg.sentry_dsn:
            from .utils.sentry import SentryClient
            self._sentry = SentryClient(cfg.sentry_dsn)
        # tags_exclude strips tag names before key construction; the
        # parser bounds reject over-long names and tags (counted)
        self._exclude_tags = frozenset(cfg.tags_exclude) or None
        self._max_name_len = cfg.metric_max_name_length
        self._max_tag_len = cfg.metric_max_tag_length
        if self.native_bridge is not None:
            if (self._max_name_len != parser.MAX_NAME_LENGTH
                    or self._max_tag_len != parser.MAX_TAG_LENGTH):
                log.warning(
                    "metric_max_name_length/metric_max_tag_length have no "
                    "effect with native_ingest (the C++ bridge parses and "
                    "interns without the bounds)")
            if self._exclude_tags:
                self.native_bridge.set_tags_exclude(
                    sorted(self._exclude_tags))
        # stats_address: ship veneur.* self-metrics there as DogStatsD
        # over UDP instead of injecting them into our own flush
        self._stats_sock = None
        if cfg.stats_address:
            host, _, port = cfg.stats_address.rpartition(":")
            fam = (socket.AF_INET6 if ":" in host.strip("[]")
                   else socket.AF_INET)
            self._stats_sock = socket.socket(fam, socket.SOCK_DGRAM)
            self._stats_dest = (host.strip("[]") or "127.0.0.1", int(port))
        # self-tracing: with an SSF UDP listener, start() points a trace
        # client back at it, so the server traces its own flushes
        # through its own ingest path
        self.trace_client = None
        self._ssf_udp_sock = None
        self.ssf_native_port = None   # set by the native SSF listener
        # in-flight fan-out threads (flusher-thread-only): a sink whose
        # previous flush is still running skips the interval
        self._sink_inflight: dict[tuple, threading.Thread] = {}

        self._threads: list[threading.Thread] = []
        self._sockets: list[socket.socket] = []        # UDP
        self._listen_socks: list[socket.socket] = []   # stream accept socks
        # open stream connections and the thread reading each
        self._stream_conns: dict[socket.socket, threading.Thread] = {}
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()
        self._started = False        # flipped at the end of start()
        self._last_flush_ok = time.monotonic()
        # the bounded ring of per-tick phase trees behind /debug/flush and
        # the veneur.flush.phase.* dogfood timers
        self.flight = None
        if cfg.flight_recorder:
            self.flight = observe.FlightRecorder(
                capacity=cfg.flight_recorder_ticks,
                max_phases=cfg.flight_recorder_max_phases)
            if self.native_pump is not None:
                # the pump's cycles, and the counters drained each flush
                from .ingest.native import PUMP_FIELDS, PUMP_SPANS
                self.native_pump.spans = self.flight.span_ring(
                    "pump", PUMP_FIELDS, PUMP_SPANS)
        # the time-travel query tier: armed with the engine journal
        # (recovery already ran above), built here because its query
        # ticks adopt into the flight ring just created
        if self._engine_journal_armed \
                and cfg.history_retention_generations > 0:
            self._setup_history()
        self.http_api = None
        # on-demand torch.profiler capture around flush ticks (see
        # _maybe_profile_start); written under _stats_lock
        self._profile_ticks = 0
        self._profile_active = False
        self._profiler = None
        self._profile_seq = 0
        self._profile_server = None   # enable_profiling's listener
        self._stats_lock = threading.Lock()
        # SSF span pipeline (SpanWorker + SpanSinks)
        self.span_queue: queue.Queue = queue.Queue(
            maxsize=max(1, cfg.ssf_buffer_size))
        self.span_sinks = (span_sinks if span_sinks is not None
                           else self._span_sinks_from_config())
        # the native SSF path: when the ssfmetrics bridge is the only span
        # consumer, the C++ bridge decodes span datagrams and stages their
        # samples in its rings; spans it cannot express (STATUS samples,
        # which become service checks) fall back a datagram at a time
        self._native_ssf = (self.native_bridge is not None
                            and len(self.span_sinks) == 1
                            and type(self.span_sinks[0]) is SSFMetricsSink)
        if self._native_ssf:
            # the sink's own timer name, so both paths derive the same
            # indicator timer
            timer_name = self.span_sinks[0]._timer_name
            if timer_name:
                self.native_bridge.set_indicator_timer(timer_name)

    # ------------- telemetry accessors (registry-backed) -------------
    # Read-only views over the registry: interval deltas, reset by each
    # flush's drain.

    def _peek(self, name: str) -> int:
        return self.telemetry.peek(observe.SERVER_SCOPE, name)

    def _count(self, name: str, n: int = 1):
        self.telemetry.incr(observe.SERVER_SCOPE, name, n)

    @property
    def packets_received(self) -> int:
        """Datagrams received this interval (reset at each flush)."""
        return self._peek("packet.received")

    @property
    def parse_errors(self) -> int:
        return self._peek("packet.error")

    @property
    def queue_drops(self) -> int:
        return self._peek("worker.dropped")

    @property
    def spans_received(self) -> int:
        return self._peek("ssf.received")

    @property
    def ssf_errors(self) -> int:
        return self._peek("ssf.error")

    @property
    def flush_errors(self) -> int:
        return self._peek("flush.error")

    @property
    def import_rejected(self) -> int:
        """Imported metrics this interval rejected as unroutable or
        corrupt (the poison-pill guards)."""
        return self._peek("import.rejected")

    @property
    def flush_count(self) -> int:
        """Completed flush ticks since start (a level: never drained)."""
        return self.telemetry.level(observe.SERVER_SCOPE, "flush.count")

    def _setup_native_ingest(self):
        """Swap the single engine's interners for views over the C++
        interning bridge, and build the pump that lands its sample rings
        in the engine's banks. Raises NativeUnavailable when the bridge
        cannot be built or loaded: there is no Python-ingest fallback."""
        from .ingest.native import BridgeKeyView, NativeBridge, NativePump

        eng = self.engines[0]
        ecfg = eng.cfg
        self._last_bridge_stats = {}   # the stats at the last flush
        self.native_bridge = NativeBridge(
            histo_slots=ecfg.histogram_slots,
            counter_slots=ecfg.counter_slots,
            gauge_slots=ecfg.gauge_slots,
            set_slots=ecfg.set_slots,
            hll_precision=ecfg.hll_precision,
            idle_ttl=ecfg.idle_ttl_intervals,
            ring_capacity=self.cfg.native_ring_capacity,
            max_packet=self.cfg.metric_max_length)
        views = {b: BridgeKeyView(self.native_bridge, b)
                 for b in ("histo", "counter", "gauge", "set")}
        eng.histo_keys = views["histo"]
        eng.counter_keys = views["counter"]
        eng.gauge_keys = views["gauge"]
        eng.set_keys = views["set"]

        def slow_path(line: bytes):
            """Lines the C++ parser routes to Python: events, service
            checks, CPython float oddities, invalid UTF-8. The same
            tags_exclude as the fast path, or one metric splits in two."""
            try:
                item = parser.parse_packet(line, self._exclude_tags,
                                           self._max_name_len,
                                           self._max_tag_len)
            except parser.ParseError:
                self._count("packet.error")
                return
            self._route_metric(item)

        def ssf_slow_path(payload: bytes):
            """SSF datagrams the native listener routed back (STATUS
            samples become service checks in the Python span path)."""
            from .ssf import framing
            try:
                span = framing.parse_ssf_datagram(payload)
            except framing.FramingError:
                self._count("ssf.error")
                return
            self.handle_ssf_span(span)

        self.native_pump = NativePump(
            self.native_bridge, eng, views, slow_path,
            batch=self.cfg.native_pump_batch, ssf_slow_path=ssf_slow_path,
            ring_capacity=self.cfg.native_ring_capacity,
            writers=self.cfg.num_readers)

    def _sinks_from_config(self) -> list[MetricSink]:
        out: list[MetricSink] = []
        cfg = self.cfg
        # every network sink gets the configured per-attempt timeout
        # (flush_timeout) and the shared retry/breaker policy
        pol = self._egress_policy
        to = cfg.flush_timeout_seconds
        if cfg.datadog_api_key:
            from .sinks.datadog import DatadogMetricSink
            out.append(DatadogMetricSink(
                api_key=cfg.datadog_api_key,
                api_url=cfg.datadog_api_hostname,
                hostname=self.hostname,
                tags=list(cfg.tags),
                interval_s=max(1, round(cfg.interval_seconds)),
                flush_max_per_body=cfg.datadog_flush_max_per_body,
                timeout_s=to, egress_policy=pol))
        if cfg.signalfx_api_key:
            from .sinks.signalfx import SignalFxMetricSink
            out.append(SignalFxMetricSink(
                api_key=cfg.signalfx_api_key,
                endpoint=cfg.signalfx_endpoint_base,
                hostname=self.hostname, tags=list(cfg.tags),
                vary_key_by=cfg.signalfx_vary_key_by,
                timeout_s=to, egress_policy=pol))
        if cfg.kafka_broker and (cfg.kafka_metric_topic or cfg.kafka_topic):
            from .sinks.kafka import KafkaMetricSink
            out.append(KafkaMetricSink(
                broker=cfg.kafka_broker,
                metric_topic=cfg.kafka_metric_topic or cfg.kafka_topic,
                egress_policy=pol))
        if cfg.newrelic_insert_key:
            from .sinks.newrelic import NewRelicMetricSink
            out.append(NewRelicMetricSink(
                insert_key=cfg.newrelic_insert_key,
                account_id=cfg.newrelic_account_id,
                tags=list(cfg.tags),
                interval_s=cfg.interval_seconds,
                timeout_s=to, egress_policy=pol))
        if cfg.prometheus_repeater_address:
            from .sinks.prometheus import PrometheusMetricSink
            out.append(PrometheusMetricSink(
                listen_address=cfg.prometheus_repeater_address,
                # one scrape surface for every veneur.* self-metric: this
                # server's telemetry and the process-default
                # egress/durability registry
                registries=(self.telemetry,
                            resilience.DEFAULT_REGISTRY)))
        if cfg.debug:
            out.append(DebugMetricSink())
        if not out:
            out.append(BlackholeMetricSink())
        return out

    def _span_sinks_from_config(self):
        """Span egress: always the ssfmetrics bridge first, so embedded
        samples reach the metric pipeline, then the network span sinks
        the config names."""
        cfg = self.cfg
        pol = self._egress_policy
        to = cfg.flush_timeout_seconds
        out = [SSFMetricsSink(
            self._route_metric,
            indicator_span_timer_name=cfg.indicator_span_timer_name)]
        if cfg.datadog_trace_api_address:
            from .sinks.datadog import DatadogSpanSink
            out.append(DatadogSpanSink(
                trace_api_address=cfg.datadog_trace_api_address,
                buffer_size=cfg.ssf_buffer_size,
                timeout_s=to, egress_policy=pol))
        if cfg.splunk_hec_address:
            from .sinks.splunk import SplunkSpanSink
            out.append(SplunkSpanSink(
                hec_address=cfg.splunk_hec_address,
                token=cfg.splunk_hec_token,
                hostname=self.hostname,
                timeout_s=to, egress_policy=pol))
        if cfg.xray_address:
            from .sinks.xray import XRaySpanSink
            out.append(XRaySpanSink(daemon_address=cfg.xray_address))
        if cfg.falconer_address:
            from .sinks.grpsink import GrpcSpanSink
            out.append(GrpcSpanSink(cfg.falconer_address,
                                    timeout_s=to, egress_policy=pol))
        if cfg.kafka_broker and cfg.kafka_span_topic:
            from .sinks.kafka import KafkaSpanSink
            out.append(KafkaSpanSink(
                broker=cfg.kafka_broker,
                span_topic=cfg.kafka_span_topic,
                egress_policy=pol))
        if cfg.lightstep_access_token:
            from .sinks.lightstep import LightStepSpanSink
            out.append(LightStepSpanSink(
                access_token=cfg.lightstep_access_token,
                collector_url=cfg.lightstep_collector_host,
                hostname=self.hostname,
                timeout_s=to, egress_policy=pol))
        if cfg.debug:
            out.append(BlackholeSpanSink())
        return out

    def _forwarder_from_config(self):
        """The leaf forwarder the config names: gRPC or HTTP to
        `forward_address`, or a Consul-discovered destination; None
        when the server forwards nothing."""
        cfg = self.cfg
        common = dict(timeout_s=cfg.flush_timeout_seconds,
                      egress_policy=self._egress_policy,
                      engine_stamp=self.engine_stamp,
                      centroid_codec=cfg.forward_centroid_codec)
        if cfg.forward_address:
            if cfg.forward_use_grpc:
                from .cluster.forward import GrpcForwarder
                return GrpcForwarder(cfg.forward_address, **common)
            from .cluster.forward import HttpJsonForwarder
            return HttpJsonForwarder(cfg.forward_address,
                                     max_per_body=cfg.flush_max_per_body,
                                     **common)
        if cfg.consul_forward_service_name:
            # discover the global tier via Consul and re-resolve on the
            # refresh interval (consul.go; Server.RefreshDestinations)
            from .cluster.discovery import ConsulDiscoverer
            from .cluster.forward import DiscoveringForwarder
            return DiscoveringForwarder(
                ConsulDiscoverer(), cfg.consul_forward_service_name,
                refresh_interval_s=_parse_interval(
                    cfg.consul_refresh_interval),
                use_grpc=cfg.forward_use_grpc,
                max_per_body=cfg.flush_max_per_body, **common)
        return None

    # ------------- lifecycle -------------

    def start(self):
        """Warm every engine, then start sinks, listeners, the trace
        client, the span worker, the HTTP API, the native pump, the
        flusher and the watchdog. Each worker thread first runs its
        engine's warmup() (its landings, the hot-slot sidestep and the
        flush body once on scratch banks) and start() waits for every
        one before a sink starts or a listener binds, so neither the
        workers' first landings (under the engine lock) nor the first
        flush pay the first use of their ops. The warm-up runs on the
        thread that lands because part of that first use is per thread
        (on the CPU, a thread's first parallel op builds its thread
        team). Under native ingest the landings also run at the pump's
        width."""
        t0 = time.monotonic()
        warmed = [threading.Event() for _ in self.engines]
        failed: list = []
        for i, q in enumerate(self.worker_queues):
            self._spawn(self._worker_loop, f"worker-{i}", i, q,
                        warmed[i], failed)
        for ev in warmed:
            ev.wait()
        if failed:
            raise failed[0]
        if self.native_pump is not None \
                and self.native_pump.batch != self.engines[0].cfg.batch_size:
            self.engines[0].warm_ingest_kernels(self.native_pump.batch)
        warm_s = time.monotonic() - t0
        if warm_s > 1.0:
            log.info("engine warmup (the device's first use of the "
                     "serving ops): %.1fs", warm_s)
        for s in self.sinks:
            try:
                s.start()
            except Exception as e:
                log.error("sink %s failed to start: %s", s.name(), e)
        for addr in self.cfg.statsd_listen_addresses:
            self._start_statsd_listener(addr)
        for addr in self.cfg.ssf_listen_addresses:
            self._start_ssf_listener(addr)
        trace_port = (self._ssf_udp_sock.getsockname()[1]
                      if self._ssf_udp_sock is not None
                      else self.ssf_native_port)
        if self.trace_client is None and trace_port:
            from . import trace
            self.trace_client = trace.Client(f"udp://127.0.0.1:{trace_port}")
        if self.cfg.enable_profiling:
            self._start_profiling()
        for addr in self.cfg.grpc_listen_addresses:
            self._start_import_listener(addr)
        for ss in self.span_sinks:
            try:
                ss.start()
            except Exception as e:
                log.error("span sink %s failed to start: %s",
                          ss.name(), e)
        self._spawn(self._span_worker, "span-worker")
        if self.cfg.http_address:
            self._start_http_api(self.cfg.http_address)
        if self.native_pump is not None:
            self.native_pump.start()
        if self.flight is not None:
            # each collection into the recorder's gc ring (and the tree
            # of the tick it falls in) until stop()
            self.flight.collector_start()
        self._last_flush_ok = time.monotonic()
        self._spawn(self._flush_loop, "flusher")
        # the watchdog always runs: it counts overdue ticks
        # (veneur.watchdog.stalled_ticks_total, behind /healthz); the
        # crash-only exit stays gated on flush_watchdog_missed_flushes
        self._spawn(self._watchdog, "watchdog")
        # the /ready "recovering" window closes once every listener runs
        self._recovering = False
        self._started = True

    def _spawn(self, target, name, *args):
        t = threading.Thread(target=target, args=args, name=name,
                             daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def stop(self, timeout: float = 10.0, *, grace: float | None = None,
             clock=time.monotonic, sleep=time.sleep):
        """Stop every listener, worker and thread this server started,
        waiting at most `timeout` seconds for them in all. The gRPC
        import listeners reject new RPCs at once and give in-flight ones
        up to `grace` seconds (default: the lesser of 2 s and the
        interval) to reach the worker queues before the dedupe ledger is
        torn down; `clock` and `sleep` are injectable so the grace-expiry
        path is testable without real waiting."""
        deadline = time.monotonic() + timeout
        self._stop.set()
        if self.flight is not None:
            self.flight.collector_stop()
        if self.http_api is not None:
            self.http_api.stop()
        if self._grpc_servers:
            from .cluster.importsrv import stop_import_server
            if grace is None:
                grace = min(2.0, self.cfg.interval_seconds)
            for g in self._grpc_servers:
                try:
                    stop_import_server(g, grace, clock=clock, sleep=sleep)
                except Exception:
                    log.exception("import server failed to stop")
        if self.dedupe_ledger is not None:
            self.dedupe_ledger.clear()   # torn down only after drain
        if self._profile_server is not None:
            self._profile_server.stop()
        with self._conns_lock:
            conns = list(self._stream_conns)
        # shutdown (not just close) wakes the threads blocked in recv(),
        # recvfrom() (UDP too: Linux wakes readers of an unconnected
        # datagram socket) and accept()
        for s in self._sockets + self._listen_socks + conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        if self.native_pump is not None:
            self.native_pump.stop()
        if self.native_bridge is not None:
            self.native_bridge.stop()
        for q in [self.span_queue] + self.worker_queues:
            try:
                q.put(_STOP, timeout=max(0.0, deadline - time.monotonic()))
            except queue.Full:
                log.warning("span or worker queue still full at stop")
        # drain in-flight sink threads (bounded) so the final interval is
        # not cut mid-write, and sinks are not stopped under a flush; the
        # fan-out registers a thread before it starts it
        for t in list(self._sink_inflight.values()):
            while True:
                try:
                    t.join(max(0.0, deadline - time.monotonic()))
                    break
                except RuntimeError:   # registered but not yet started
                    if time.monotonic() >= deadline:
                        break
                    time.sleep(0.005)
        for s in self.sinks + self.span_sinks:
            try:
                s.stop()
            except Exception:
                log.exception("sink %s failed to stop", s.name())
        if self.trace_client is not None:
            self.trace_client.close()
        if self._stats_sock is not None:
            self._stats_sock.close()
        with self._conns_lock:
            readers = list(self._stream_conns.values())
        # the flusher is the forwarder's only caller: close it (its gRPC
        # channel) once that thread is gone
        flusher = [t for t in self._threads if t.name == "flusher"]
        for t in flusher:
            t.join(max(0.0, deadline - time.monotonic()))
        close = getattr(self.forwarder, "close", None)
        if close is not None and not any(t.is_alive() for t in flusher):
            try:
                close()
            except Exception:
                log.exception("forwarder failed to close")
        for t in self._threads + readers:
            t.join(max(0.0, deadline - time.monotonic()))
        # durable shutdown: push every journal record to disk and release
        # the files and their locks, so a restart from the same
        # durability_dir starts clean (a crash skips this: the journals'
        # torn-write tolerance covers it)
        for j in (self._forward_journal, self._dedupe_journal,
                  self._engine_journal):
            if j is not None:
                try:
                    j.close()
                except Exception:
                    log.exception("durability journal close failed")
        if self._query_tier is not None:
            try:
                self._query_tier.close()
            except Exception:
                pass
        alive = [t.name for t in self._threads + readers if t.is_alive()]
        if alive:
            log.warning("threads still running after stop: %s", alive)

    # ------------- ingest -------------

    @staticmethod
    def _resolve_inet(scheme: str, rest: str):
        """'host:port' (+scheme suffix 4/6, brackets allowed) → (family,
        bind_addr). udp6://[::1]:8126 must bind an AF_INET6 socket."""
        host, _, port = rest.rpartition(":")
        host = host.strip("[]")
        if scheme.endswith("6"):
            family = socket.AF_INET6
            host = host or "::"
        elif scheme.endswith("4"):
            family = socket.AF_INET
            host = host or "0.0.0.0"
        else:
            family = socket.AF_INET6 if ":" in host else socket.AF_INET
            host = host or "0.0.0.0"
        return family, (host, int(port))

    def _start_statsd_listener(self, addr: str):
        scheme, _, rest = addr.partition("://")
        if scheme in ("udp", "udp4", "udp6"):
            family, bind_addr = self._resolve_inet(scheme, rest)
            if self.native_bridge is not None:
                # the bridge takes numeric addresses only; resolve here
                host = socket.getaddrinfo(
                    bind_addr[0], bind_addr[1], family,
                    socket.SOCK_DGRAM)[0][4][0]
                self.native_bridge.start_udp(
                    host, bind_addr[1], max(1, self.cfg.num_readers),
                    rcvbuf=self.cfg.read_buffer_size_bytes)
                return
            for ri in range(max(1, self.cfg.num_readers)):
                sock = socket.socket(family, socket.SOCK_DGRAM)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                if hasattr(socket, "SO_REUSEPORT"):
                    sock.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_REUSEPORT, 1)
                try:
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                    self.cfg.read_buffer_size_bytes)
                except OSError:
                    pass
                sock.bind(bind_addr)
                if bind_addr[1] == 0:
                    # the readers after the first share the first's port
                    bind_addr = sock.getsockname()[:2]
                self._sockets.append(sock)
                self._spawn(self._read_metric_socket, f"udp-reader-{ri}",
                            sock)
        elif scheme in ("tcp", "tcp4", "tcp6", "unix"):
            # statsd over streams (networking.go: StartStatsd's TCP/UNIX
            # arms), newline-delimited; TLS (incl. mutual) when the
            # config's tls_* triple is set
            lsock = self._listen_stream(scheme, rest)
            ssl_ctx = self._tls_context() if scheme != "unix" else None
            self._spawn(self._accept_streams, f"statsd-{scheme}-accept",
                        lsock, ssl_ctx, self._read_statsd_stream,
                        "statsd-stream")
        else:
            raise ValueError(f"unsupported statsd listener {addr!r}")

    def _listen_stream(self, scheme: str, rest: str) -> socket.socket:
        """A listening TCP (tcp, tcp4, tcp6) or UNIX stream socket."""
        if scheme != "unix":
            family, bind_addr = self._resolve_inet(scheme, rest)
            lsock = socket.socket(family, socket.SOCK_STREAM)
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lsock.bind(bind_addr)
        else:
            if os.path.exists(rest):
                os.unlink(rest)
            lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            lsock.bind(rest)
        lsock.listen(128)
        self._listen_socks.append(lsock)
        return lsock

    def _tls_context(self):
        """Server-side TLS from the config triple (networking.go: the
        tls_key / tls_certificate pair enables TLS on TCP statsd;
        tls_authority_certificate additionally demands client certs —
        mutual TLS)."""
        if not (self.cfg.tls_key and self.cfg.tls_certificate):
            return None
        import ssl
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(certfile=self.cfg.tls_certificate,
                            keyfile=self.cfg.tls_key)
        if self.cfg.tls_authority_certificate:
            ctx.load_verify_locations(
                cafile=self.cfg.tls_authority_certificate)
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def _accept_streams(self, lsock: socket.socket, ssl_ctx, reader,
                        name: str):
        """Accept connections on `lsock`, each read by `reader` (statsd
        lines or framed SSF spans) in a thread of its own."""
        while not self._stop.is_set():
            try:
                conn, _ = lsock.accept()
            except OSError:
                break
            if ssl_ctx is not None:
                try:
                    conn = ssl_ctx.wrap_socket(conn, server_side=True)
                except (OSError, ValueError):
                    self._count("packet.error")
                    conn.close()
                    continue
            t = threading.Thread(target=reader, args=(conn,), name=name,
                                 daemon=True)
            with self._conns_lock:
                if self._stop.is_set():
                    conn.close()
                    break
                self._stream_conns[conn] = t
            t.start()

    def _read_statsd_stream(self, conn: socket.socket):
        """Newline-delimited metric lines over a stream connection; a
        line split across reads is reassembled. An oversized line is
        dropped IN FULL: after the drop the reader stays in discard
        mode until the line's terminating newline arrives, so the
        line's later bytes can never be parsed as a fresh metric."""
        max_len = self.cfg.metric_max_length
        tail = b""
        discarding = False
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        data = conn.recv(65536)
                    except OSError:
                        return
                    if not data:
                        if tail and not discarding:
                            self.handle_packet(tail)
                        return
                    if discarding:
                        nl = data.find(b"\n")
                        if nl < 0:
                            continue
                        data = data[nl + 1:]
                        discarding = False
                        if not data:
                            continue
                    buf = tail + data
                    nl = buf.rfind(b"\n")
                    if nl < 0:
                        tail = buf
                        if len(tail) > max_len:
                            # oversized garbage line: drop, count, and
                            # swallow the rest of it
                            self._count("packet.error")
                            tail = b""
                            discarding = True
                        continue
                    self.handle_packet(buf[:nl])
                    tail = buf[nl + 1:]
                    if len(tail) > max_len:
                        self._count("packet.error")
                        tail = b""
                        discarding = True
        finally:
            # a stopping server keeps the entry so stop() can join it
            if not self._stop.is_set():
                with self._conns_lock:
                    self._stream_conns.pop(conn, None)

    def _start_ssf_listener(self, addr: str):
        """SSF ingest (Server.StartSSF): udp:// datagrams carry bare
        SSFSpan protobufs; tcp:// and unix:// carry framed streams
        (protocol.ReadSSF)."""
        scheme, _, rest = addr.partition("://")
        if scheme in ("udp", "udp4", "udp6"):
            family, bind_addr = self._resolve_inet(scheme, rest)
            if self._native_ssf and family != socket.AF_INET6:
                # C++ SSF readers: recvmmsg, decode and ring staging; no
                # Python thread owns this socket. Fallback datagrams come
                # back through the pump's ssf_slow_path
                self.ssf_native_port = self.native_bridge.start_ssf_udp(
                    bind_addr[0], bind_addr[1],
                    n_readers=max(1, self.cfg.num_readers),
                    rcvbuf=self.cfg.read_buffer_size_bytes,
                    max_dgram=self.cfg.trace_max_length_bytes)
                log.info("native SSF listener on udp://%s:%d",
                         bind_addr[0], self.ssf_native_port)
                return
            sock = socket.socket(family, socket.SOCK_DGRAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind(bind_addr)
            self._sockets.append(sock)
            if self._ssf_udp_sock is None:
                self._ssf_udp_sock = sock  # self-trace target
            self._spawn(self._read_ssf_packet_socket, "ssf-udp-reader",
                        sock)
        elif scheme in ("tcp", "tcp4", "tcp6", "unix"):
            self._spawn(self._accept_streams, f"ssf-{scheme}-accept",
                        self._listen_stream(scheme, rest), None,
                        self._read_ssf_stream, "ssf-stream")
        else:
            raise ValueError(f"unsupported SSF listener {addr!r}")

    def _read_ssf_packet_socket(self, sock: socket.socket):
        """Server.ReadSSFPacketSocket: one datagram = one SSFSpan."""
        from .ssf import framing

        max_len = self.cfg.trace_max_length_bytes
        native_ssf = self._native_ssf
        while True:
            try:
                data, _ = sock.recvfrom(max_len)
            except OSError:
                break
            if self._stop.is_set():
                break
            if native_ssf:
                rc = self.native_bridge.handle_ssf(data)
                if rc == 1:
                    # staged in the rings; counted by the bridge's
                    # ssf_spans (folded into the telemetry at flush), not
                    # by ssf.received, which would count the span twice
                    continue
                if rc < 0:
                    self._count("ssf.error")
                    continue
                # rc == 0: STATUS samples present, the Python path below
            try:
                span = framing.parse_ssf_datagram(data)
            except framing.FramingError:
                self._count("ssf.error")
                continue
            self.handle_ssf_span(span)

    def _read_ssf_stream(self, conn: socket.socket):
        """Server.HandleTracePacket over a framed stream; a corrupt
        frame poisons only its own connection."""
        from .ssf import framing

        native_ssf = self._native_ssf
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        payload = framing.read_ssf_frame(conn)
                        if payload is None:
                            return
                        if native_ssf:
                            rc = self.native_bridge.handle_ssf(payload)
                            if rc == 1:
                                # counted by the bridge's ssf_spans
                                continue
                            if rc < 0:
                                self._count("ssf.error")
                                return
                        span = framing.parse_ssf_datagram(payload)
                    except (framing.FramingError, EOFError, OSError):
                        self._count("ssf.error")
                        return
                    self.handle_ssf_span(span)
        finally:
            # a stopping server keeps the entry so stop() can join it
            if not self._stop.is_set():
                with self._conns_lock:
                    self._stream_conns.pop(conn, None)

    def handle_ssf_span(self, span):
        """Route one ingested span to the span worker (drop-on-full,
        counted, like the reference's SpanChan)."""
        try:
            self.span_queue.put_nowait(span)
        except queue.Full:
            self._count("worker.dropped")
        # counted after the enqueue so a waiter that observes the count
        # and then drain()s cannot race ahead of the item
        self._count("ssf.received")

    def _span_worker(self):
        """SpanWorker: fan each span out to every span sink; a sink that
        raises is logged and the others still get the span."""
        while True:
            span = self.span_queue.get()
            try:
                if span is _STOP:
                    break
                for ss in self.span_sinks:
                    try:
                        ss.ingest(span)
                    except Exception:
                        log.exception("span sink %s ingest failed",
                                      ss.name())
            finally:
                self.span_queue.task_done()

    def _route_metric(self, item):
        """Digest-route one item onto a worker queue — the single
        dispatch point shared by the packet path and the ssfmetrics
        bridge. Events/service checks have no digest and ride on queue
        0. Drop-on-full is deliberate lossiness under backpressure,
        counted, like veneur's full worker channels."""
        qi = item.digest % len(self.worker_queues) \
            if hasattr(item, "digest") else 0
        try:
            self.worker_queues[qi].put_nowait(item)
        except queue.Full:
            self._count("worker.dropped")

    def _submit_import(self, digest: int, imported):
        """Queue one imported metric (an importsrv.ImportedMetric) on the
        worker its digest names: the handler threads only enqueue, the
        worker lands it in its engine. Drop-on-full, counted."""
        try:
            self.worker_queues[digest % len(self.worker_queues)] \
                .put_nowait(imported)
        except queue.Full:
            self._count("worker.dropped")

    # ---------------- engine checkpoint/restore (durability) -----------

    # in-memory write-ahead retention cap: ops kept for snapshot
    # compaction and the history seal (a two-checkpoint window normally
    # holds a handful; thousands means compaction stopped running)
    MAX_RETAINED_IMPORT_OPS = 65536

    def _engine_journal_failed(self, what: str):
        """A failing disk must not fail imports or the flush tick: the
        process degrades to the in-memory contract, counted and loud."""
        resilience.DEFAULT_REGISTRY.incr("import",
                                         "durability.journal_errors")
        log.exception(
            "engine %s journal op failed; DISABLING engine checkpointing "
            "for this process (in-memory aggregation unaffected; "
            "crash-restart recovery degrades)", what)
        j, self._engine_journal = self._engine_journal, None
        if j is not None:
            try:
                j.close()
            except Exception:
                pass

    def _submit_import_batch(self, pairs, envelope=None):
        """The durable import submit path (the import server's and POST
        /import's when engine checkpointing is armed): one admitted
        request is one journal op, written ahead of any worker queue and
        so of the sender's ack, then grouped per target engine so the
        worker applies each engine's share atomically under the op id.
        The submit lock makes journal order the queue order, so recovery
        replays the original per-engine order. `envelope` rides in the
        op so recovery can re-seed the dedupe ledger."""
        from .cluster.importsrv import ImportedBatch
        from .durability import records as drecords
        nq = len(self.worker_queues)
        with self._import_submit_lock:
            op_id = self._next_import_op = self._next_import_op + 1
            if self._engine_journal is not None:
                try:
                    payload = drecords.encode_engine_import(
                        op_id, [pb for _d, pb in pairs], envelope)
                    self._engine_journal.append_import(payload)
                    self._recent_import_ops.append((op_id, payload))
                    if len(self._recent_import_ops) > \
                            self.MAX_RETAINED_IMPORT_OPS:
                        self._recent_import_ops.pop(0)
                        # the next history generation would under-count:
                        # its seal degrades loudly
                        self._import_ops_evicted = True
                except Exception:
                    self._engine_journal_failed("import write-ahead")
            groups: dict[int, list] = {}
            for digest, pb in pairs:
                groups.setdefault(digest % nq, []).append(pb)
            for qi, pbs in groups.items():
                try:
                    self.worker_queues[qi].put_nowait(
                        ImportedBatch(op_id, pbs))
                except queue.Full:
                    # journaled but shed: recovery replays it, the live
                    # process loses it, counted per metric
                    self._count("worker.dropped", len(pbs))

    def _recover_engine_state(self):
        """Recovery-before-listen: rebuild the engines from the engine
        journal, the latest committed checkpoint group of each, then
        every import op above that engine's applied-op watermark,
        replayed in journal order through the live path's digest routing
        and grouped apply. Never raises on corrupt state: a fingerprint
        or engine-count mismatch, or an undecodable group, drops the
        whole recovery loudly (a fresh start)."""
        from .cluster import wire
        from .durability import records as drecords
        from .durability.history import collect_checkpoint_groups
        from .utils.hashing import metric_digest
        tel, S = self.telemetry, observe.SERVER_SCOPE
        t0 = time.monotonic_ns()
        recs = self._engine_journal.load_records()
        latest, op_payloads, torn, errors = \
            collect_checkpoint_groups(recs)
        ops: list = []
        for payload in op_payloads:
            try:
                ops.append(drecords.decode_engine_import(payload))
            except Exception:
                errors += 1
                log.exception(
                    "engine recovery: undecodable import op skipped")
        if errors:
            tel.incr(S, "durability.engine_recovery_errors", errors)
            log.warning("engine recovery: %d undecodable record(s) "
                        "skipped", errors)
        if torn:
            tel.incr(S, "durability.engine_recovery_errors", torn)
            log.warning(
                "engine recovery: %d torn (uncommitted) checkpoint "
                "group(s) dropped; falling back to the previous complete "
                "group(s), the ops above their watermark replay", torn)
        n = len(self.engines)
        for idx, g in latest.items():
            n_eng = g["meta"][0]
            if idx >= n or n_eng != n:
                log.error(
                    "engine recovery REFUSED: checkpoint was taken under "
                    "%d engine(s), this server runs %d; starting fresh",
                    n_eng, n)
                tel.incr(S, "durability.engine_recovery_errors")
                self._recovery = {"refused": "engine count mismatch"}
                return
        restored = 0
        try:
            for idx, g in latest.items():
                _n_eng, wm, gseq, fpr = g["meta"]
                banks: dict = {}
                for payload in g["banks"]:
                    _i, kind, ids, leaves = drecords.decode_engine_bank(
                        payload,
                        leaf_names_of=self.engines[idx].bank_leaf_names)
                    banks[kind] = (ids, leaves)
                self.engines[idx].restore_checkpoint(
                    fpr, gseq, wm, g["keys"], banks, g["staged"])
                restored += 1
        except Exception as e:
            # a fingerprint mismatch (ValueError) or an undecodable row:
            # a partial restore would flush silently wrong state
            log.error("engine recovery REFUSED: %s; starting fresh", e)
            tel.incr(S, "durability.engine_recovery_errors")
            self._recovery = {"refused": str(e)}
            return
        replayed = metrics_replayed = 0
        for op_id, pbs, env in ops:
            if op_id > self._next_import_op:
                self._next_import_op = op_id
            if env is not None and self.dedupe_ledger is not None:
                # this op's merged state is being recovered, so the
                # sender's ambiguous-failure replay of the same chunk
                # must dedupe, not double-count
                self.dedupe_ledger.admit(*env)
            by_engine: dict[int, list] = {}
            for pb in pbs:
                try:
                    key = wire.metric_key_of(pb)
                    digest = metric_digest(key.name, key.type,
                                           key.joined_tags)
                except Exception:
                    self._count("import.rejected")
                    continue
                by_engine.setdefault(digest % n, []).append(pb)
            applied = False
            reroutes: list = []
            for ei, epbs in by_engine.items():
                eng = self.engines[ei]
                if op_id <= eng.last_import_op:
                    continue   # inside the restored checkpoint already
                rerouted, rejected = eng.import_list(op_id, epbs)
                reroutes.extend(rerouted)
                for _pb, e in rejected:
                    self._count("import.rejected")
                    log.warning("engine recovery: rejected corrupted "
                                "journaled metric: %s", e)
                applied = True
                metrics_replayed += len(epbs)
            # overload-defense folds homed on other engines replay after
            # every direct share: a reroute stamps the target's watermark
            # to op_id, which would make the loop above skip its own share
            for fr, pb in reroutes:
                digest = _fold_rewrite(pb, fr)
                self.engines[digest % n].import_list(op_id, [pb])
            if applied:
                replayed += 1
            # retained for the next compaction: everything not provably
            # inside every checkpoint
            self._recent_import_ops.append(
                (op_id, drecords.encode_engine_import(op_id, pbs, env)))
        restore_ns = time.monotonic_ns() - t0
        tel.incr(S, "durability.engine_recovered_ops", replayed)
        tel.incr(S, "durability.engine_recovered_metrics",
                 metrics_replayed)
        tel.set_gauge(S, "durability.engine_restore_ns", restore_ns)
        self._recovery = {
            "engines_restored": restored,
            "ops_replayed": replayed,
            "metrics_replayed": metrics_replayed,
            "restore_ns": restore_ns,
            "generation": self._engine_journal.generation(),
        }
        if restored or replayed:
            log.info("engine recovery: %d engine checkpoint(s) restored, "
                     "%d import op(s) (%d metrics) replayed in %.1fms",
                     restored, replayed, metrics_replayed,
                     restore_ns / 1e6)

    def _engine_checkpoint(self, ts: int | None = None,
                           retired_wms: list | None = None):
        """The flush-boundary hook: append one self-contained checkpoint
        group per engine (the live banks' dirty rows: the swap re-zeroed
        the rest), skip it when nothing changed (an idle global must not
        grow the journal), and compact when the journal outgrew its
        budget: the latest groups plus the ops of the two-checkpoint
        retention window. With the history tier, the boundary also seals
        the closing interval as a query generation: `ts` is its close
        time, `retired_wms` the engines' swap-time watermarks."""
        from .durability import records as drecords
        tel, S = self.telemetry, observe.SERVER_SCOPE
        recs: list = []
        dirty = total = 0
        staged_any = interned_any = False
        marks = []
        n = len(self.engines)
        for i, eng in enumerate(self.engines):
            snap = eng.checkpoint_state()
            recs.extend(drecords.encode_engine_checkpoint(i, n, snap))
            dirty += snap["piles_dirty"]
            total += snap["piles_total"]
            staged_any = staged_any or any(
                snap["staged"][f] for f in ("centroids", "sets",
                                            "counters", "gauges"))
            interned_any = interned_any or any(
                entries for _iv, entries in snap["interner"].values())
            marks.append(snap["last_import_op"])
        # a baseline with no rows, nothing staged and no interned key
        # reconstructs to nothing: the next interval can seal as an empty
        # generation if it also gets no op
        empty_next = not dirty and not staged_any and not interned_any
        if self._history is not None and ts is not None:
            self._history_seal(ts, retired_wms or [0] * n, recs, marks,
                               empty_next)
        sig = (tuple(marks),
               tuple(len(ki) for eng in self.engines
                     for _k, _a, ki in eng._bank_table()))
        # vlint: disable=TH01 reason=flush-path-only state; flushes are
        # serialized (one flusher thread, tests call flush_once synchronously)
        # and readers (debug/health) tolerate staleness
        self._last_checkpoint_stats = (dirty, total)
        if not dirty and not staged_any \
                and sig == self._last_checkpoint_sig:
            # nothing to persist: every row fresh, nothing staged, no new
            # op, no interner churn
            tel.incr(S, "durability.engine_delta_skipped_piles", total)
            return
        nbytes = self._engine_journal.append_checkpoint(recs)
        self._engine_journal.sync()
        tel.set_gauge(S, "durability.engine_snapshot_bytes", nbytes)
        tel.incr(S, "durability.engine_delta_skipped_piles",
                 total - dirty)
        # vlint: disable=TH01 reason=flush-path-only state; flushes are
        # serialized (one flusher thread, tests call flush_once synchronously)
        self._last_checkpoint_sig = sig
        # vlint: disable=TH01 reason=flush-path-only state; debug-page readers
        # tolerate staleness
        self._last_checkpoint_t = time.monotonic()
        with self._import_submit_lock:
            cut = self._ops_at_last_checkpoint
            self._recent_import_ops = [
                o for o in self._recent_import_ops if o[0] > cut]
            self._ops_at_last_checkpoint = self._next_import_op
            retained = [(drecords.REC_ENGINE_IMPORT, p)
                        for _id, p in self._recent_import_ops]
            # under the submit lock: an op appended between the retention
            # snapshot and the journal truncate would be lost from both
            self._engine_journal.maybe_compact(recs + retained)

    # ---------------- time-travel history and query tier --------------

    def _setup_history(self):
        """Arm the retention store and the query tier (after recovery):
        the post-recovery consistent cut becomes the first generation's
        baseline, and the query tier gets a factory of scratch engines
        of the live engines' shape, on this server's device; it never
        holds a reference to the live pipeline."""
        import dataclasses

        from .durability import HistoryStore, QueryTier
        cfg = self.cfg
        self._history = HistoryStore(
            cfg.durability_dir,
            retention_generations=cfg.history_retention_generations,
            retention_seconds=_parse_interval(
                cfg.history_retention_seconds),
            fsync=cfg.durability_fsync != "never",
            registry=self.telemetry)
        self._history_baseline = self._capture_history_baseline()
        # the next generation's open edge: the newest retained close (a
        # restart continues the timeline), else 0 (the first generation
        # claims everything before its close; flush timestamps may be
        # scripted, so never wall-now)
        retained = self._history.entries()
        self._history_prev_close_ns = (retained[-1].close_ns
                                       if retained else 0)
        ecfg = self.engines[0].cfg
        device = self.device

        def scratch_factory(percentiles=None, aggregates=None,
                            merge=False):
            # merge=False: a generation's reconstruction engine,
            # forward-enabled so its flush builds the export rows the
            # merge consumes; merge=True: the cross-interval merge
            # engine, global so its frame carries the requested
            # quantiles. Neither flag is in the fingerprint.
            kw = dict(forward_enabled=not merge, is_global=merge)
            if percentiles is not None:
                kw["percentiles"] = tuple(percentiles)
            if aggregates is not None:
                kw["aggregates"] = tuple(aggregates)
            return AggregationEngine(dataclasses.replace(ecfg, **kw),
                                     device=device)

        self._query_tier = QueryTier(
            self._history, scratch_factory, len(self.engines),
            flight=self.flight, registry=self.telemetry,
            scope=observe.SERVER_SCOPE,
            engines_describe=self.engines[0].engines_describe(),
            max_concurrent=cfg.query_max_concurrent,
            cache_entries=cfg.query_cache_entries,
            timeout_s=_parse_interval(cfg.query_timeout))

    def _capture_history_baseline(self):
        """(records, per-engine watermarks, provably-empty flag) of a
        consistent cut across every engine: the baseline the next closed
        interval reconstructs on."""
        from .durability import records as drecords
        recs: list = []
        marks: list = []
        empty = True
        n = len(self.engines)
        for i, eng in enumerate(self.engines):
            snap = eng.checkpoint_state()
            recs.extend(drecords.encode_engine_checkpoint(i, n, snap))
            marks.append(snap["last_import_op"])
            if snap["piles_dirty"] or any(
                    snap["staged"][f] for f in ("centroids", "sets",
                                                "counters", "gauges")) \
                    or any(entries for _iv, entries
                           in snap["interner"].values()):
                empty = False
        return recs, marks, empty

    def _history_seal(self, ts: int, retired_wms: list, recs: list,
                      marks: list, empty_next: bool = False):
        """Seal the interval that just flushed as one query generation:
        the previous boundary's checkpoint groups as its baseline, the
        ops write-aheaded above the baseline's lowest watermark (the
        per-engine cut is applied at query time), the flush timestamp as
        its close. A failing disk disables history loudly without
        failing the tick."""
        tel, S = self.telemetry, observe.SERVER_SCOPE
        try:
            base_recs, base_marks, base_empty = self._history_baseline
            min_wm = min(base_marks) if base_marks else 0
            with self._import_submit_lock:
                op_recs = [(i, p) for i, p in self._recent_import_ops
                           if i > min_wm]
                evicted, self._import_ops_evicted = \
                    self._import_ops_evicted, False
            if evicted:
                tel.incr(S, "durability.history_truncated")
                log.warning(
                    "history: MAX_RETAINED_IMPORT_OPS (%d) evicted import "
                    "ops this interval; the sealed generation under-"
                    "counts: raise the cap or shorten the flush interval",
                    self.MAX_RETAINED_IMPORT_OPS)
            close_ns = int(ts) * 1_000_000_000
            if base_empty and not op_recs:
                # a provably empty interval: a manifest row, no segment
                self._history.append_empty(
                    close_ns, self._history_prev_close_ns)
            else:
                self._history.append(close_ns,
                                     self._history_prev_close_ns,
                                     retired_wms, base_recs, op_recs)
            # vlint: disable=TH01 reason=flush-path-only state; flushes are
            # serialized (one flusher thread, tests call flush_once
            # synchronously)
            self._history_baseline = (recs, marks, empty_next)
            # vlint: disable=TH01 reason=flush-path-only state (above)
            self._history_prev_close_ns = close_ns
            hs = self._history.debug_state()
            tel.set_gauge(S, "history.generations", hs["generations"])
            tel.set_gauge(S, "history.bytes", hs["bytes"])
        except Exception:
            tel.incr(S, "durability.journal_errors")
            log.exception(
                "history generation seal failed; DISABLING the time-"
                "travel tier for this process (aggregation and crash "
                "recovery unaffected)")
            # vlint: disable=TH01 reason=monotone one-way degrade on the
            # flusher thread; readers (query path, debug page) tolerate either
            # value across the flip
            self._history = None
            if self._query_tier is not None:
                self._query_tier.close()
                # vlint: disable=TH01 reason=same one-way degrade; the http
                # wiring null-checks per request
                self._query_tier = None

    def _serve_query(self, params: dict) -> dict:
        """GET /query: runs on the query tier's own executor, never on
        the ingest or flush path."""
        from .durability import QueryError
        tier = self._query_tier
        if tier is None:    # disk-error degrade after the listener bound
            raise QueryError(
                503, "time-travel tier disabled after a disk error "
                     "(see veneur.durability.journal_errors_total)")
        return tier.query(params)

    def _durability_tick(self, ts: int, results: list, tick):
        """The flush boundary's durability phase: the engine checkpoint
        (and the history seal), the forward journal's sync and
        compaction, and last tick's dedupe watermarks."""
        dp = -1
        dtok = None
        if tick is not None and (
                self._forward_journal is not None
                or self._engine_journal is not None
                or (self._dedupe_journal is not None
                    and self.dedupe_ledger is not None)):
            dp = tick.start("durability")
            dtok = observe.set_current_tick(tick, dp)
        try:
            if self._engine_journal is not None:
                try:
                    self._engine_checkpoint(
                        ts, [r.stats.get("retired_import_op", 0)
                             for r in results])
                except Exception:
                    self._engine_journal_failed("checkpoint")
            if self._forward_journal is not None:
                jt = getattr(self.forwarder, "journal_tick", None)
                if jt is not None:
                    jt()  # journal failures degrade inside the forwarder
            if self._dedupe_journal is not None and \
                    self.dedupe_ledger is not None:
                try:
                    # record LAST tick's snapshot and capture this one's:
                    # a seq admitted during this tick may not be in the
                    # state it flushed (worker-queue residency)
                    marks = self._pending_watermarks
                    # vlint: disable=TH01 reason=flush-path-only state; flushes
                    # are serialized (one flusher thread, tests call flush_once
                    # synchronously)
                    self._pending_watermarks = \
                        self.dedupe_ledger.max_admitted()
                    self._dedupe_journal.record(marks)
                    self._dedupe_journal.sync()
                except Exception:
                    resilience.DEFAULT_REGISTRY.incr(
                        "import", "durability.journal_errors")
                    log.exception(
                        "dedupe watermark journal failed; DISABLING it "
                        "for this process (in-memory dedupe unaffected)")
                    try:
                        self._dedupe_journal.close()
                    except Exception:
                        pass
                    # vlint: disable=TH01 reason=flush-path-only state; flushes
                    # are serialized (one flusher thread, tests call flush_once
                    # synchronously) and stop() reads it only after the last
                    # tick ended
                    self._dedupe_journal = None
        finally:
            if dtok is not None:
                observe.reset_current_tick(dtok)
            if dp != -1:
                tick.finish(dp)

    def _start_import_listener(self, addr: str):
        """Global-mode gRPC receive path (importsrv): forwarded metrics
        are re-hashed onto the worker queues and merged via Combine;
        with engine checkpointing each request is one journaled op."""
        from .cluster.importsrv import start_import_server

        server, port = start_import_server(
            addr, self._submit_import, ledger=self.dedupe_ledger,
            observer=self.import_observer,
            submit_batch=(self._submit_import_batch
                          if self._engine_journal is not None else None),
            engine_stamp=self.engine_stamp,
            note_stamp=self._note_sketch_stamp,
            merge_sketches=self.merge_prefix_sketches)
        self._grpc_servers.append(server)
        self.grpc_port = port

    def _start_http_api(self, addr: str):
        """The ops HTTP listener (handlers.go): healthchecks, version,
        /debug/flush, /debug/flush/profile, /debug/fleet, and the legacy
        POST /import path, which feeds the same Combine machinery as the
        gRPC import."""
        from .http_api import HttpApi

        def submit(digest, pb):
            from .cluster.importsrv import ImportedMetric
            self._submit_import(digest, ImportedMetric(pb))

        self.http_api = HttpApi(
            addr, debug_state=self._debug_flush_state,
            fleet_state=self._debug_fleet_state,
            health=self.health_state,
            # the profiler trigger exists only when the operator opted
            # in via debug_flush_profile (a capture is a debug action)
            profile=(self.request_profile_capture
                     if self.cfg.debug_flush_profile else None),
            submit=submit, ledger=self.dedupe_ledger,
            observer=self.import_observer,
            submit_batch=(self._submit_import_batch
                          if self._engine_journal is not None else None),
            engine_stamp=self.engine_stamp,
            note_stamp=self._note_sketch_stamp,
            merge_sketches=self.merge_prefix_sketches,
            # the time-travel query tier; absent, GET /query is 404, so
            # an operator can tell "not armed" from "bad query"
            query=(self._serve_query
                   if self._query_tier is not None else None))
        self.http_api.start()
        self._threads.append(self.http_api.thread)

    def bound_port(self) -> int:
        """Port of the first UDP socket (for callers binding port 0)."""
        if self.native_bridge is not None and not self._sockets:
            return self.native_bridge.bound_port()
        return self._sockets[0].getsockname()[1]

    def _read_metric_socket(self, sock: socket.socket):
        """[HOT LOOP 1] recvfrom -> split -> parse -> route
        (Server.ReadMetricSocket + HandleMetricPacket)."""
        max_len = self.cfg.metric_max_length
        while True:
            try:
                data, _ = sock.recvfrom(max_len)
            except OSError:
                break
            if self._stop.is_set():
                break
            self.handle_packet(data)

    def handle_packet(self, data: bytes):
        if self.native_bridge is not None:
            # the bridge counts packets and errors itself; folded into
            # the self-metrics at flush
            self.native_bridge.handle_packet(data)
            return
        # Overload backpressure (ingest/admission.py): when the governor
        # is engaged, shed WHOLE datagrams pre-parse at the adaptive
        # rate (counted as veneur.overload.shed_packets_total) and
        # rate-correct the surviving counter/timer/histogram samples so
        # flushed totals stay unbiased. Disengaged, this costs one
        # attribute load and a None check per datagram.
        adm = self.admission
        shed_rate = 1.0
        if adm is not None and adm.shed_rate < 1.0:
            if adm.admit_packet() is None:
                # the datagram WAS received; its loss is the counted
                # degradation (received == applied + counted_degraded)
                self._count("packet.received")
                return
            shed_rate = adm.shed_rate
        for line in data.split(b"\n"):
            if not line:
                continue
            try:
                item = parser.parse_packet(line, self._exclude_tags,
                                           self._max_name_len,
                                           self._max_tag_len)
            except parser.ParseError:
                self._count("packet.error")
                continue
            if shed_rate < 1.0 and isinstance(item, parser.UDPMetric) \
                    and item.key.type in self._rate_corrected_types:
                # survivor of the shed lottery: weight it up
                item.sample_rate = max(item.sample_rate * shed_rate, 1e-9)
            self._route_metric(item)
        # counted after routing so a waiter that observes the count and
        # then drain()s cannot race ahead of the lines
        self._count("packet.received")

    def _worker_loop(self, idx: int, q: queue.Queue, warmed=None,
                     failed=None):
        """[HOT LOOP 2] queue -> engine (Worker.Work, and
        Worker.ImportMetricGRPC for forwarded metrics). With `warmed`, the
        engine's warmup() runs here first, then the event is set (a
        failure is appended to `failed` and ends the thread)."""
        eng = self.engines[idx]
        if warmed is not None:
            try:
                eng.warmup()
            except Exception as e:
                failed.append(e)
                return
            finally:
                warmed.set()
        while True:
            item = q.get()
            try:
                if item is _STOP:
                    break
                if isinstance(item, parser.UDPMetric):
                    eng.process(item)
                elif isinstance(item, parser.Event):
                    eng.process_event(item)
                elif isinstance(item, parser.ServiceCheck):
                    eng.process_service_check(item)
                else:
                    self._apply_import(eng, item)
            finally:
                q.task_done()

    def _reroute_fold(self, pb, fr, item):
        """Overload defense: the fold key is homed on another engine —
        rewrite the aggregate onto it and queue `item` (carrying the
        rewritten pb) on the fold key's home worker (single-homed folds;
        the home engine admits it as an ordinary import)."""
        digest = _fold_rewrite(pb, fr)
        try:
            self.worker_queues[digest % len(self.worker_queues)] \
                .put_nowait(item)
        except queue.Full:
            self._count("worker.dropped")

    def _apply_import(self, eng, item):
        """The worker's import arms: an ImportedMetric (one forwarded
        metric) or an ImportedBatch (one op's share, applied under one
        lock hold). Only a receiving server queues these, so the wire is
        imported here, not by a DogStatsD-only server."""
        from .cluster.importsrv import ImportedBatch
        from .cluster.wire import apply_metric_to_engine
        from .models import pipeline

        if isinstance(item, ImportedBatch):
            rerouted, rejected = eng.import_list(item.op_id, item.pbs)
            for fr, pb in rerouted:
                # re-routed under the SAME op id
                self._reroute_fold(pb, fr, ImportedBatch(item.op_id, [pb]))
            for pb, e in rejected:
                self._count("import.rejected")
                log.warning("rejected corrupted imported metric %r: %s",
                            getattr(pb, "name", "?"), e)
            return
        # poison-pill guard: a corrupted forwarded payload (bad HLL blob,
        # malformed centroid list) rejects THAT metric, not this worker
        # loop — one bad sender must not starve a whole queue shard
        try:
            apply_metric_to_engine(eng, item.pb)
        except pipeline.ImportFoldReroute as fr:
            self._reroute_fold(item.pb, fr, item)
        except Exception as e:
            self._count("import.rejected")
            log.warning("rejected corrupted imported metric %r: %s",
                        getattr(item.pb, "name", "?"), e)

    def drain(self, timeout: float = 10.0, *, clock=time.monotonic,
              sleep=time.sleep) -> bool:
        """Block until every enqueued span and metric has been fully
        processed by its worker (not merely popped): the queues'
        unfinished-task accounting counts an item mid-`eng.process` as
        in flight. False when `timeout` seconds pass first. `clock` and
        `sleep` are injectable, so the deadline path is testable without
        real waiting."""
        deadline = clock() + timeout
        if self.native_pump is not None:
            # the bridge's rings and slow path first; slow-path items land
            # on the worker queues, which the loop below then settles
            if not self.native_pump.drain(timeout):
                return False
        queues = [self.span_queue] + self.worker_queues
        while True:
            if all(q.unfinished_tasks == 0 for q in queues):
                return True
            if clock() >= deadline:
                return False
            sleep(0.005)

    # ------------- flush -------------

    def _flush_loop(self):
        interval = self.cfg.interval_seconds
        next_t = time.monotonic() + interval
        if self.cfg.synchronize_with_interval:
            # align ticks to wall-clock multiples of the interval
            now = time.time()
            next_t = time.monotonic() + (interval - now % interval)
        while not self._stop.wait(max(0.0, next_t - time.monotonic())):
            next_t += interval
            try:
                self.flush_once()
                self._last_flush_ok = time.monotonic()
            except Exception as e:
                log.exception("flush failed")
                self._count("flush.error")
                if self._sentry is not None:
                    self._sentry.capture(e, "flush failed")

    def flush_once(self, timestamp: int | None = None):
        """One flush tick: flush the engines and fan out (Server.Flush).
        Returns the flush's FrameSet.

        With the flight recorder on, the tick's phase tree (engine flush
        with the engines' own stages, telemetry, per-sink fan-out,
        overload) lands in the ring behind /debug/flush, replays as an
        SSF span tree through the server's own trace client, and its
        top-level durations are re-ingested as LOCAL-ONLY
        veneur.flush.phase.* timers."""
        t0 = time.monotonic()
        ts = int(timestamp if timestamp is not None else time.time())
        tick = token = None
        if self.flight is not None:
            tick = self.flight.begin_tick(ts)
            if timestamp is not None:
                tick.close_ns = int(timestamp * 1_000_000_000)
            token = observe.set_current_tick(tick)
        self._maybe_profile_start()
        try:
            if tick is None and self.trace_client is not None:
                # with the recorder off the flush still traces its root
                # veneur.flush span (the per-phase children need it)
                from . import trace as trace_mod
                from .observe.registry import flush_span_name
                with trace_mod.start_span(self.trace_client,
                                          flush_span_name(),
                                          service="veneur"):
                    frameset = self._flush_tick(ts, t0, tick)
            else:
                frameset = self._flush_tick(ts, t0, tick)
        finally:
            if token is not None:
                observe.reset_current_tick(token)
            if tick is not None:
                self.flight.end_tick(tick)
                if self.trace_client is not None:
                    self.flight.emit_spans(tick, self.trace_client)
            self._maybe_profile_stop()
        if tick is not None and self.cfg.flush_phase_timers:
            # dogfood loop: the NEXT tick's flush serves percentiles of
            # THIS tick's phases, flushed like any tenant metric
            for m in observe.phase_timer_samples(tick):
                self._route_metric(m)
        if tick is not None and tick.dropped:
            self._count("observe.phases_dropped", tick.dropped)
        self.telemetry.incr_level(observe.SERVER_SCOPE, "flush.count")
        return frameset

    def _flush_tick(self, ts: int, t0: float, tick):
        """The tick body. `tick` is the TickRecord or None."""
        frames = []
        merged_export = ForwardExport()
        events, checks = [], []
        status_metrics = []
        eng_stats = {"samples": 0, "dropped_no_slot": 0,
                     "swap_ns": 0, "merge_ns": 0, "assembly_ns": 0}
        results: list = [None] * len(self.engines)
        eng_ph: list = [-1] * len(self.engines)
        # delta forwarding: ask the forwarder what THIS interval's export
        # should be — "delta" (the dirty-bitmap subset) unless a full
        # resync is due or forced, or deltas are off
        fkind = "full"
        nfk = getattr(self.forwarder, "next_forward_kind", None)
        if nfk is not None:
            fkind = nfk()
        ep = -1 if tick is None else tick.start("engine")

        def _one(i, eng):
            ph = -1 if tick is None else tick.start("engine.flush", ep)
            eng_ph[i] = ph
            try:
                results[i] = eng.flush(timestamp=ts, forward_kind=fkind)
            except BaseException as e:
                results[i] = e
            finally:
                if tick is not None:
                    tick.finish(ph, engine=i)

        if len(self.engines) == 1:
            _one(0, self.engines[0])
        else:
            # engines flush concurrently (their host work and fetches
            # overlap); every launch goes to the same default stream
            ths = [threading.Thread(target=_one, args=(i, eng),
                                    daemon=True, name=f"engine-flush-{i}")
                   for i, eng in enumerate(self.engines)]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
        for i, (eng, res) in enumerate(zip(self.engines, results)):
            if isinstance(res, BaseException):
                raise res
            if res is None:   # a flush thread died; surface it
                raise RuntimeError("engine flush failed")
            for k in eng_stats:
                eng_stats[k] += res.stats.get(k, 0)
            if tick is not None:
                # graft the engine's own stamps under its engine.flush
                # phase, with their real edges
                for nm, p0, p1 in res.stats.get("phases", ()):
                    tick.add("engine." + nm, p0, p1, parent=eng_ph[i])
            frames.append(res.frame)
            status_metrics.extend(res.status_metrics)
            merged_export.histograms.extend(res.export.histograms)
            merged_export.sets.extend(res.export.sets)
            merged_export.counters.extend(res.export.counters)
            merged_export.gauges.extend(res.export.gauges)
            merged_export.set_engine = res.export.set_engine
            ev, ch = eng.drain_events()
            events.extend(ev)
            checks.extend(ch)
        # the merged interval is a FULL resync only if EVERY engine built
        # one; any delta share makes the payload incomplete, so it is
        # stamped delta (the safe under-claim the forwarder's resync
        # bookkeeping keys off)
        merged_export.kind = ("delta" if any(
            r.export.kind == "delta" for r in results) else "full")
        if tick is not None:
            tick.finish(ep)

        if self.fleet is not None:
            # e2e boundary: every interval admitted before this drain is
            # now merged into flushed state — its close stamp becomes a
            # close->merged latency sample (LOCAL-ONLY timers, ingested
            # next tick), and per-sender freshness rides the registry
            fp = -1 if tick is None else tick.start("fleet")
            now_ns = (tick.close_ns if tick is not None
                      else int(ts) * 1_000_000_000)
            e2e = self.fleet.on_flush(now_ns)
            for sid, age in self.fleet.freshness(now_ns).items():
                self.telemetry.set_gauge(f"sender:{sid}",
                                         "e2e.freshness_age_ns", age)
            for m in observe.e2e_timer_samples(e2e):
                self._route_metric(m)
            if tick is not None:
                tick.finish(fp, senders=len(e2e),
                            intervals=sum(len(v) for v in e2e.values()))

        tp = -1 if tick is None else tick.start("telemetry")
        frameset = FrameSet(
            frames, status_metrics + self._self_metrics(ts, t0, eng_stats))
        if tick is not None:
            tick.finish(tp)
        fo = -1 if tick is None else tick.start("fanout")
        self._fan_out(frameset, events, checks, tick=tick, parent=fo)
        if tick is not None:
            tick.finish(fo)
        if self.forwarder is not None:
            self._forward(merged_export, tick)
        # durability flush boundary: the engine checkpoint, the forward
        # journal's sync and compaction, the dedupe watermarks
        self._durability_tick(ts, results, tick)

        # Overload governor boundary: adapt the shed rate from this
        # tick's wall duration (overrun = the flush can't keep up with
        # ingest) and the worst worker-queue fill, then record the
        # interval's degradation as phases next to the phases explaining
        # why the tick overran.
        adm = self.admission
        if adm is not None:
            op = -1 if tick is None else tick.start("overload")
            qfill = max((q.qsize() / q.maxsize
                         for q in self.worker_queues), default=0.0)
            delta = adm.on_tick(time.monotonic() - t0,
                                self.cfg.interval_seconds, qfill)
            if tick is not None:
                if delta["folded"] or delta["sampled_out"] \
                        or delta["over_budget"]:
                    tick.finish(
                        tick.start("overload.fold", op),
                        folded=delta["folded"],
                        sampled_out=delta["sampled_out"],
                        keys_over_budget=delta["over_budget"])
                if delta["shed"]:
                    tick.finish(tick.start("overload.shed", op),
                                shed=delta["shed"])
                tick.finish(op, rate=delta["rate"],
                            overloaded=delta["overloaded"])
        return frameset

    def _forward(self, merged_export, tick):
        """Hand the interval's merged export to the forwarder, in a
        `forward` phase. The admission controller's per-prefix
        cardinality sketches ride along (merge-by-max at the receiver,
        advisory). An interval with no export still forwards while
        spilled sketches await re-merge, so they cannot strand when
        traffic stops."""
        if self.admission is not None:
            merged_export.prefix_sketches = self.admission.export_sketches()
        if not (merged_export.histograms or merged_export.sets
                or merged_export.counters or merged_export.gauges
                or getattr(self.forwarder, "pending_spill", 0)):
            return
        fw = -1 if tick is None else tick.start("forward")
        # re-scope the tick so the ladder's attempt/replay phases nest
        # under `forward`
        ftok = observe.set_current_tick(tick, fw) \
            if tick is not None else None
        # bytes on the wire: the leaf forwarders count
        # veneur.forward.bytes* per delivered chunk; the totals sampled
        # around the call give THIS interval's bytes for /debug/fleet
        reg = observe.DEFAULT_REGISTRY
        bytes_before = reg.totals_by_name_prefix("forward.bytes")
        try:
            self.forwarder(merged_export)
            with self._stats_lock:
                self._last_forward_err = None
        except Exception as e:
            # the interval is parked or spilled by the ResilientForwarder;
            # the resilience counters carry the per-tick signal. A
            # sustained outage fails every tick with the same error:
            # sentry gets each distinct failure once
            log.exception("forward failed")
            sig = f"{type(e).__name__}: {e}"
            with self._stats_lock:
                repeat = sig == self._last_forward_err
                self._last_forward_err = sig
            if self._sentry is not None and not repeat:
                self._sentry.capture(e, "forward failed")
        finally:
            if ftok is not None:
                observe.reset_current_tick(ftok)
            if tick is not None:
                tick.finish(fw)
            sample = {}
            for (scope, name), v in reg.totals_by_name_prefix(
                    "forward.bytes").items():
                d = v - bytes_before.get((scope, name), 0)
                if d:
                    sample.setdefault(scope, {})[name] = d
        with self._stats_lock:
            self._last_forward_bytes = {"kind": merged_export.kind,
                                        "by_destination": sample}

    # ------------- on-demand torch.profiler capture -------------
    # GET /debug/flush/profile?ticks=N schedules a capture (gated by
    # debug_flush_profile); the flusher starts the profiler before the
    # next tick and stops it after N ticks, writing one Chrome trace
    # (CPU activity, and the card's kernels when the engines run there)
    # into debug_flush_profile_dir.

    def request_profile_capture(self, ticks: int = 1) -> dict:
        ticks = max(1, int(ticks))
        with self._stats_lock:
            self._profile_ticks = max(self._profile_ticks, ticks)
            pending = self._profile_ticks
        return {"capture_ticks": pending,
                "dir": self.cfg.debug_flush_profile_dir}

    def _profiler_activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def _maybe_profile_start(self):
        with self._stats_lock:
            want = self._profile_ticks > 0 and not self._profile_active
            if want:
                self._profile_active = True
        if not want:
            return
        try:
            from torch.profiler import profile
            prof = profile(activities=self._profiler_activities())
            prof.start()
            # vlint: disable=TH01 reason=flush-path-only state: only the flush
            # that set _profile_active under _stats_lock starts a capture, and
            # flushes are serialized
            self._profiler = prof
            log.info("debug/flush: torch profiler capture started -> %s",
                     self.cfg.debug_flush_profile_dir)
        except Exception as e:
            log.warning("debug/flush: torch profiler unavailable: %s", e)
            with self._stats_lock:
                self._profile_active = False
                self._profile_ticks = 0

    def _maybe_profile_stop(self):
        with self._stats_lock:
            if not self._profile_active:
                return
            self._profile_ticks -= 1
            done = self._profile_ticks <= 0
        if not done:
            return
        prof, self._profiler = self._profiler, None
        try:
            prof.stop()
            # vlint: disable=TH01 reason=flush-path-only state, written by the
            # capture's owner (above)
            self._profile_seq += 1
            d = self.cfg.debug_flush_profile_dir
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"flush-{os.getpid()}-"
                                   f"{self._profile_seq}.pt.trace.json")
            prof.export_chrome_trace(path)
            log.info("debug/flush: torch profiler capture complete -> %s",
                     path)
        except Exception as e:
            log.warning("debug/flush: profiler stop failed: %s", e)
        with self._stats_lock:
            self._profile_active = False

    def _start_profiling(self):
        """enable_profiling: serve torch.profiler captures on
        profile_port — the port's analogue of the reference's profiler
        server (server.go's net/http/pprof wiring): GET
        /profile?seconds=S answers a Chrome trace of the next S seconds.
        mutex_profile_fraction / block_profile_rate are Go-runtime knobs
        with no torch equivalent; they are accepted and warned about."""
        if self.cfg.mutex_profile_fraction or self.cfg.block_profile_rate:
            log.warning("mutex_profile_fraction/block_profile_rate are "
                        "Go-runtime profiling knobs with no effect in "
                        "the torch build; use enable_profiling (torch "
                        "profiler) instead")
        from .http_api import ProfileServer
        try:
            self._profile_server = ProfileServer(
                self.cfg.profile_port, self._profiler_activities())
            self._profile_server.start()
            self._threads.append(self._profile_server.thread)
            log.info("torch profiler captures on :%d",
                     self._profile_server.port)
        except Exception as e:
            log.warning("enable_profiling: torch profiler unavailable: %s",
                        e)

    def _debug_flush_state(self) -> dict:
        """GET /debug/flush payload: the flight-recorder ring plus the
        forward ladder, breaker, journal and dedupe-ledger state, under
        the reference's keys."""
        fwd = self.forwarder
        state = {
            "flush_count": self.flush_count,
            "sketch_engines": self.engines[0].engines_describe(),
            "flight_recorder": (None if self.flight is None
                                else self.flight.debug_state()),
            "forward": (fwd.debug_state()
                        if hasattr(fwd, "debug_state") else None),
            # overload defense: budgets, per-prefix cardinality
            # estimates, governor rate, fold/shed counters
            "admission": (self.admission.debug_state()
                          if self.admission is not None
                          else {"enabled": False}),
            "dedupe_ledger": None,
            "durability": {
                "forward_journal_bytes": (
                    self._forward_journal.size_bytes()
                    if self._forward_journal is not None else None),
                "watermark_journal_bytes": (
                    self._dedupe_journal.size_bytes()
                    if self._dedupe_journal is not None else None),
                "engine_checkpoint": self._engine_checkpoint_state(),
                # the retained generations of the time-travel tier
                "history": (self._history.debug_state()
                            if self._history is not None else None),
            },
            "query": (self._query_tier.debug_state()
                      if self._query_tier is not None else None),
            "registry": {
                "server": self.telemetry.debug_state(),
                "process": observe.DEFAULT_REGISTRY.debug_state(),
            },
        }
        if self.dedupe_ledger is not None:
            state["dedupe_ledger"] = {
                "size": self.dedupe_ledger.size(),
                "senders": self.dedupe_ledger.sender_count(),
                "watermarks": self.dedupe_ledger.max_admitted(),
            }
        return state

    def _engine_checkpoint_state(self) -> dict | None:
        """The /debug/flush checkpoint block: generation, journal and
        last-checkpoint bytes, the dirty/total pile ratio of the last
        boundary, the last checkpoint's age and this incarnation's
        restore stats (None when engine checkpointing is off)."""
        if not self._engine_journal_armed:
            return None
        j = self._engine_journal
        dirty, total = self._last_checkpoint_stats
        return {
            "enabled": j is not None,   # False: degraded (disk error)
            "generation": j.generation() if j is not None else None,
            "journal_bytes": j.size_bytes() if j is not None else None,
            "last_snapshot_bytes": (j.last_checkpoint_bytes
                                    if j is not None else None),
            "piles_dirty": dirty,
            "piles_total": total,
            "dirty_ratio": round(dirty / total, 6) if total else 0.0,
            "last_checkpoint_age_s": (
                round(time.monotonic() - self._last_checkpoint_t, 3)
                if self._last_checkpoint_t is not None else None),
            "pending_import_ops": len(self._recent_import_ops),
            "restore": self._recovery,
        }

    # health verdict threshold: a flush is STALLED once its lag exceeds
    # this many intervals
    HEALTH_STALL_INTERVALS = 1.5

    def health_state(self, now: float | None = None,
                     fwd_state: dict | None = None) -> dict:
        """Structured verdicts for GET /healthz and /ready. `healthy` is
        false only when the flush loop is stalled; an open forward
        breaker, spilled sketches awaiting replay, a journal disabled by
        a disk error, a refused recovery, the governor shedding or a
        worker queue over 90% full flag `status: degraded` without
        failing the probe; /ready is false while recovery runs. `now` is
        injectable; `fwd_state` lets a caller that already computed the
        forwarder's debug_state pass it in."""
        now = time.monotonic() if now is None else now
        interval = self.cfg.interval_seconds
        lag = now - self._last_flush_ok
        started = self._started
        stalled = started and lag > self.HEALTH_STALL_INTERVALS * interval
        checks = {
            "flush": {"ok": not stalled, "lag_s": round(lag, 3),
                      "interval_s": interval,
                      "stalled_ticks_total": self.telemetry.total(
                          observe.SERVER_SCOPE, "watchdog.stalled_ticks")},
        }
        fwd = self.forwarder
        if fwd_state is not None or hasattr(fwd, "debug_state"):
            st = fwd_state if fwd_state is not None else fwd.debug_state()
            bstate = st["breaker_state"]
            pending = st["pending_spill"]
            checks["forward"] = {
                "ok": bstate != "open" and not pending,
                "breaker_state": bstate,
                "pending_spill": pending,
                "ladder_depth": len(st["ladder"]),
            }
        degraded_journals = []
        if self.cfg.durability_enabled:
            if (self._forward_journal is not None
                    and getattr(self.forwarder, "_journal", None) is None
                    and isinstance(self.forwarder,
                                   resilience.ResilientForwarder)):
                degraded_journals.append("forward")
            if self.dedupe_ledger is not None \
                    and self._dedupe_journal is None:
                degraded_journals.append("dedupe_watermarks")
            if self._engine_journal_armed and self._engine_journal is None:
                degraded_journals.append("engine")
            checks["journal"] = {"ok": not degraded_journals,
                                 "degraded": degraded_journals}
        if self._engine_journal_armed or self._recovery is not None:
            # recovery-before-listen: in progress until start() completes,
            # then the restore stats; a REFUSED recovery (journaled state
            # discarded) keeps ok false
            refused = bool((self._recovery or {}).get("refused"))
            checks["recovery"] = {
                "ok": not self._recovering and not refused,
                "in_progress": self._recovering,
                **(self._recovery or {}),
            }
        if self.admission is not None:
            rate = self.admission.shed_rate
            checks["overload"] = {"ok": rate >= 1.0, "shed_rate": rate}
        qfill = max((q.qsize() / q.maxsize for q in self.worker_queues),
                    default=0.0)
        checks["queues"] = {"ok": qfill < 0.9, "fill": round(qfill, 4)}
        degraded = any(not c["ok"] for c in checks.values())
        recovering = self._recovering
        return {
            "healthy": not stalled,
            "ready": started and not recovering
                     and not self._stop.is_set(),
            "status": ("recovering" if recovering
                       else "stalled" if stalled
                       else "degraded" if degraded else "ok"),
            "checks": checks,
        }

    def _note_sketch_stamp(self, sender_id: str, stamp, ok: bool):
        """Record one import request's engine-stamp verdict (the gRPC and
        HTTP paths both route here): the sender's row in the fleet view,
        and veneur.import.engine_mismatch_total on a reject — the loud
        half of the mixed-fleet contract."""
        if self.fleet is not None:
            self.fleet.note_stamp(sender_id, stamp, ok)
        if not ok:
            observe.DEFAULT_REGISTRY.incr("import",
                                          "import.engine_mismatch")

    # distinct prefixes the fleet cardinality map holds (a network-facing
    # receiver stays bounded however many prefixes senders churn
    # through); overflow rows are dropped and counted
    MAX_FLEET_SKETCH_PREFIXES = 4096

    def merge_prefix_sketches(self, items):
        """Merge received per-prefix cardinality rows (merge-by-max,
        idempotent under replays) into the fleet map served at
        /debug/fleet. Prefixes past MAX_FLEET_SKETCH_PREFIXES, and rows
        whose width differs from the held row, are dropped (counted)."""
        dropped = 0
        with self._fleet_sketch_lock:
            for prefix, regs in items:
                cur = self._fleet_sketches.get(prefix)
                if cur is None:
                    if len(self._fleet_sketches) \
                            >= self.MAX_FLEET_SKETCH_PREFIXES:
                        dropped += 1
                        continue
                    self._fleet_sketches[prefix] = bytearray(regs)
                elif len(cur) != len(regs):
                    # senders configured with different sketch_buckets
                    # cannot merge; replacing would flip-flop the
                    # prefix's estimate between single-sender views
                    dropped += 1
                else:
                    for i, r in enumerate(regs):
                        if r > cur[i]:
                            cur[i] = r
        if dropped:
            observe.DEFAULT_REGISTRY.incr(
                "import", "fleet.sketch_prefixes_dropped", dropped)

    def _debug_fleet_state(self) -> dict:
        """GET /debug/fleet payload, under the reference's keys: the
        per-sender fleet view (with each sender's dedupe watermark) on a
        receiving tier, this server's own forward ladder summary on a
        sending tier, the forward bytes, the engine stamps, the fleet
        cardinality, the bounded import ring and the health verdict."""
        now_ns = time.time_ns()
        senders: dict = {}
        if self.fleet is not None:
            senders = self.fleet.debug_state(now_ns)["senders"]
        if self.dedupe_ledger is not None:
            for sid, mark in self.dedupe_ledger.max_admitted().items():
                senders.setdefault(sid, {
                    "last_seen_age_s": None,
                    "newest_close_ns": 0,
                    "freshness_age_ms": None,
                    "intervals_merged": 0,
                    "pending": 0,
                    "e2e_ms": {"count": 0, "p50": 0.0, "p99": 0.0},
                })["dedupe_watermark"] = mark
        forward = None
        fwd_state = None
        fwd = self.forwarder
        if hasattr(fwd, "debug_state"):
            fwd_state = fwd.debug_state()
            ages = [e["age"] for e in fwd_state["ladder"]]
            forward = {
                "sender_id": fwd_state["sender_id"],
                "ladder_depth": len(fwd_state["ladder"]),
                "replay_ages": ages,
                "oldest_replay_age": max(ages, default=0),
                "pending_spill": fwd_state["pending_spill"],
                "breaker_state": fwd_state["breaker_state"],
            }
        fbytes: dict = {}
        for (scope, name), v in observe.DEFAULT_REGISTRY \
                .totals_by_name_prefix("forward.bytes").items():
            fbytes.setdefault(scope, {})[name] = v
        with self._stats_lock:
            last_bytes = self._last_forward_bytes
        obs = self.import_observer
        return {
            "now_ns": now_ns,
            "flush_count": self.flush_count,
            "senders": senders,
            "forward": forward,
            "forward_bytes": {"cumulative": fbytes,
                              "last_interval": last_bytes},
            "sketch_engines": {
                "local": self.engine_stamp,
                "mismatch_rejects": observe.DEFAULT_REGISTRY.total(
                    "import", "import.engine_mismatch"),
            },
            "fleet_cardinality": self._fleet_cardinality(),
            "import_recorder": (obs.debug_state() if obs is not None
                                else None),
            "health": self.health_state(fwd_state=fwd_state),
        }

    def _fleet_cardinality(self, top: int = 50) -> dict:
        """JSON-ready fleet-wide per-prefix cardinality estimates: the
        received sketches merged (at read time) with this server's own
        admission-controller sketches, so a global that also ingests
        locally reports one number per prefix."""
        from .ingest.admission import estimate_registers
        with self._fleet_sketch_lock:
            merged = {p: bytes(r) for p, r in self._fleet_sketches.items()}
        if self.admission is not None:
            for prefix, regs in self.admission.export_sketches():
                cur = merged.get(prefix)
                if cur is None:
                    merged[prefix] = bytes(regs)
                elif len(cur) == len(regs):
                    merged[prefix] = bytes(
                        max(a, b) for a, b in zip(cur, regs))
                # width mismatch: keep the fleet row (the local estimate
                # is a subset of it), never replace
        rows = sorted(
            ((p, round(estimate_registers(r), 1))
             for p, r in merged.items()),
            key=lambda kv: -kv[1])
        return dict(rows[:top])

    def _self_metrics(self, ts: int, t0: float,
                      eng_stats: dict | None = None) -> list[InterMetric]:
        """veneur.* self-telemetry: stage the per-tick gauges/deltas into
        the registry, then drain it and the process default through the
        one name mapping in observe/registry.py."""
        tel, S = self.telemetry, observe.SERVER_SCOPE
        # the core counters report every interval, zeros included, under
        # the reference's names
        for name in ("packet.received", "packet.error", "worker.dropped",
                     "ssf.received", "ssf.error", "flush.error",
                     "import.rejected", "watchdog.stalled_ticks"):
            tel.mark(S, name, 0)
        if self.flight is not None:
            tel.mark(S, "observe.phases_dropped", 0)
        if self.native_bridge is not None:
            self._fold_bridge_stats(eng_stats)
        if self.native_pump is not None \
                and self.native_pump.spans is not None:
            self._fold_pump_stats()
        if self.flight is not None:
            totals = self.flight.collector_totals()
            if totals is not None:
                # upstream's runtime gauges (flusher.go), since the hook
                # went in at start()
                tel.set_gauge(S, "gc.number", totals[0])
                tel.set_gauge(S, "gc.pause_total_ns", totals[1])
        if self.admission is not None:
            # overload counters report every interval, zeros included
            # (a zero IS the steady-state signal), plus the live
            # governor rate
            for name in ("overload.folded_samples",
                         "overload.fold_sampled_out",
                         "overload.keys_over_budget",
                         "overload.shed_packets"):
                tel.mark(S, name, 0)
            tel.set_gauge(S, "overload.adaptive_sample_rate",
                          self.admission.shed_rate)
        tel.set_gauge(S, "flush.total_duration_ns",
                      (time.monotonic() - t0) * 1e9)
        if self.dedupe_ledger is not None:
            tel.set_gauge(S, "forward.dedupe_ledger_size",
                          self.dedupe_ledger.size())
        if self._engine_journal is not None:
            # the engine checkpoint's self-metrics, present at zero while
            # armed; the recovered_* counters were counted during
            # recovery and drain here
            for name in ("durability.engine_delta_skipped_piles",
                         "durability.engine_recovered_ops",
                         "durability.engine_recovered_metrics",
                         "durability.engine_recovery_errors"):
                tel.mark(S, name, 0)
            dirty, total = self._last_checkpoint_stats
            tel.set_gauge(S, "durability.engine_snapshot_piles_dirty",
                          dirty)
            tel.set_gauge(S, "durability.engine_snapshot_piles_total",
                          total)
            tel.set_gauge(S, "durability.engine_snapshot_bytes",
                          self._engine_journal.last_checkpoint_bytes)
            tel.set_gauge(S, "durability.engine_restore_ns",
                          (self._recovery or {}).get("restore_ns", 0))
        journals = [j for j in (self._forward_journal,
                                self._dedupe_journal,
                                self._engine_journal) if j is not None]
        if journals:
            # the counters ride the process registry's drain below; the
            # level-style metrics are gauges read from the journals
            tel.set_gauge(S, "durability.journal_bytes",
                          sum(j.size_bytes() for j in journals))
            tel.set_gauge(S, "durability.snapshot_duration_ns",
                          max(j.journal.last_snapshot_ns
                              for j in journals))
        if eng_stats is not None:
            tel.mark(S, "samples.processed", eng_stats["samples"])
            tel.mark(S, "samples.dropped_no_slot",
                     eng_stats["dropped_no_slot"])
            tel.set_gauge(S, "flush.swap_duration_ns", eng_stats["swap_ns"])
            tel.set_gauge(S, "flush.merge_duration_ns",
                          eng_stats["merge_ns"])
            tel.set_gauge(S, "flush.assembly_duration_ns",
                          eng_stats["assembly_ns"])
        # per-sink counts/durations drain from the PREVIOUS interval's
        # fan-out (the sink threads record them as they finish)
        out = (tel.drain(ts, self.hostname)
               + observe.DEFAULT_REGISTRY.drain(ts, self.hostname))
        if self._stats_sock is not None:
            # scopedstatsd mode: ship veneur.* over the wire to
            # stats_address instead of injecting into this flush
            lines = []
            for m in out:
                kind = "c" if m.type == MetricType.COUNTER else "g"
                tags = ("|#" + ",".join(m.tags)) if m.tags else ""
                lines.append(f"{m.name}:{m.value:g}|{kind}{tags}")
            try:
                self._stats_sock.sendto("\n".join(lines).encode(),
                                        self._stats_dest)
            except OSError:
                pass
            return []
        return out

    def _fold_pump_stats(self):
        """The pump's stamped cycles since the last flush: busy and
        engine-lock wait ns and cycles as counters, and the fullest
        bank's highest fill as a gauge, in samples and as a share of
        what its rings hold."""
        tel, S = self.telemetry, observe.SERVER_SCOPE
        busy, wait, cycles, peak = self.native_pump.take_stats()
        tel.mark(S, "ingest.pump_busy_ns", busy)
        tel.mark(S, "ingest.pump_lock_wait_ns", wait)
        tel.mark(S, "ingest.pump_cycles", cycles)
        tel.set_gauge(S, "ingest.ring_fill_peak", peak)
        tel.set_gauge(S, "ingest.ring_fill_peak_ratio",
                      peak / self.native_pump.ring_samples)

    def _fold_bridge_stats(self, eng_stats):
        """UDP and native SSF are counted in the bridge under native
        ingest: fold its per-interval deltas into the telemetry. Ring
        drops count as worker.dropped; the bridge's bank-full drops
        REPLACE the engine's dropped_no_slot (the views see only the
        slow-path share, which the bridge's counter already holds).
        Flushes are serialized, so the previous snapshot needs no lock."""
        tel, S = self.telemetry, observe.SERVER_SCOPE
        st = self.native_bridge.stats()
        last = self._last_bridge_stats

        def delta(k):
            return int(st[k]) - int(last.get(k, 0))

        tel.incr(S, "packet.received", delta("packets"))
        tel.incr(S, "packet.error", delta("parse_errors"))
        tel.incr(S, "worker.dropped", delta("ring_drops"))
        # natively decoded spans and their decode errors (fallback
        # datagrams re-enter the Python path and are counted there)
        tel.incr(S, "ssf.received", delta("ssf_spans"))
        tel.incr(S, "ssf.error", delta("ssf_errors"))
        if eng_stats is not None:
            eng_stats["dropped_no_slot"] = delta("drops_no_slot")
        # vlint: disable=TH01 reason=flush-path-only state; flushes are
        # serialized (one flusher thread, tests call flush_once synchronously),
        # so no concurrent writer exists
        self._last_bridge_stats = st

    def _fan_out(self, frameset, events, checks, tick=None, parent=-1):
        """Per-sink parallel flush, decoupled from the tick (one thread
        per sink; the flusher never joins them). A sink whose previous
        flush is still in flight skips this interval — counted as
        veneur.sink.flush_skipped_total. With a tick active, every sink
        and plugin flush gets its own phase under `fanout`."""
        tel = self.telemetry
        phase_timers = self.cfg.flush_phase_timers

        def spawn(key, target):
            prev = self._sink_inflight.get(key)
            if prev is not None and prev.is_alive():
                tel.incr(f"{key[0]}:{key[1]}", "sink.flush_skipped")
                if tick is not None:
                    tick.finish(tick.start("sink.skip", parent),
                                kind=key[0], name=key[1])
                return
            t = threading.Thread(target=target, daemon=True,
                                 name=f"{key[0]}-{key[1]}")
            # register BEFORE start so stop()'s drain can never miss it
            # vlint: disable=TH01 reason=flusher-thread-only map; stop() only
            # reads it after _stop is set and the last tick ended
            self._sink_inflight[key] = t
            t.start()

        for s in self.sinks:
            def run(sink=s):
                ph = -1 if tick is None else \
                    tick.start("sink.flush", parent)
                t0 = time.monotonic()
                ok = False
                n = None
                try:
                    n = sink.flush_frames(frameset)
                    if events or checks:
                        sink.flush_other(events, checks)
                    ok = True
                except Exception:
                    log.exception("sink %s flush failed", sink.name())
                finally:
                    # drained in the NEXT interval's veneur.sink.*
                    # self-metrics; a failed flush reports 0 flushed and
                    # an error
                    count = 0
                    if ok:
                        count = n if isinstance(n, int) else len(frameset)
                    dur_s = time.monotonic() - t0
                    scope = f"sink:{sink.name()}"
                    tel.mark(scope, "sink.metrics_flushed", count)
                    tel.set_gauge(scope, "sink.flush_duration_ns",
                                  dur_s * 1e9)
                    tel.mark(scope, "sink.flush_errors", 0 if ok else 1)
                    if tick is not None:
                        tick.finish(ph, sink=sink.name(), ok=ok,
                                    flushed=count)
                        if phase_timers:
                            self._route_metric(observe.fanout_timer_sample(
                                sink.name(), dur_s * 1e3))
            spawn(("sink", s.name()), run)
        for p in self.plugins:
            def runp(plugin=p):
                ph = -1 if tick is None else \
                    tick.start("plugin.flush", parent)
                t0 = time.monotonic()
                ok = True
                try:
                    plugin.flush_frames(frameset, self.hostname)
                except Exception:
                    ok = False
                    log.exception("plugin %s flush failed", plugin.name())
                finally:
                    if tick is not None:
                        tick.finish(ph, plugin=plugin.name(), ok=ok)
                        if phase_timers:
                            self._route_metric(observe.fanout_timer_sample(
                                plugin.name(),
                                (time.monotonic() - t0) * 1e3))
            spawn(("plugin", p.name()), runp)
        for ss in self.span_sinks:
            def runs(sink=ss):
                ph = -1 if tick is None else \
                    tick.start("spansink.flush", parent)
                t0 = time.monotonic()
                ok = True
                try:
                    sink.flush()
                except Exception:
                    ok = False
                    log.exception("span sink %s flush failed",
                                  sink.name())
                finally:
                    if tick is not None:
                        tick.finish(ph, sink=sink.name(), ok=ok)
                        if phase_timers:
                            self._route_metric(observe.fanout_timer_sample(
                                sink.name(),
                                (time.monotonic() - t0) * 1e3))
            spawn(("spansink", ss.name()), runs)

    # ------------- watchdog -------------

    def _watchdog(self):
        """Stall accounting + crash-only supervision. Every interval the
        watchdog compares now against the last COMPLETED flush; an
        overdue tick increments veneur.watchdog.stalled_ticks_total. The
        hard exit (Server.FlushWatchdog) stays opt-in via
        flush_watchdog_missed_flushes."""
        interval = self.cfg.interval_seconds
        max_lag = self.cfg.flush_watchdog_missed_flushes * interval
        while not self._stop.wait(interval):
            lag = time.monotonic() - self._last_flush_ok
            if lag > interval:
                self._count("watchdog.stalled_ticks")
            if max_lag > 0 and lag > max_lag:
                log.critical(
                    "flush watchdog: no completed flush in %.1fs "
                    "(max %.1fs) — exiting for supervisor restart",
                    lag, max_lag)
                if self._sentry is not None:
                    # the event must leave the dying process, so this
                    # send blocks (bounded by the client's timeout)
                    self._sentry.capture(
                        None, "flush watchdog expired; crash-only exit",
                        wait=True)
                os._exit(2)
