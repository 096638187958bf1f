"""The Server: listeners + sharded engines + flush loop + watchdog — the
local tier of veneur_tpu/server.py, over the port's AggregationEngine.

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
  * One flush thread ticks every `interval`, flushes all engines (in
    threads when there are several), fans out to sinks (a thread per
    sink) and plugins.
  * A watchdog thread counts overdue ticks and, when configured, exits
    the process for its supervisor to restart.

The device is the caller's `device`, else "cpu" when
`aggregation_backend: cpu`, else "cuda" — which raises where there is no
card, as AggregationEngine does. With an SSF UDP listener the server
traces its own flushes through it. Config keys this port cannot honour
yet (forwarding and the global tier, durability, the network sinks,
native ingest, several devices, the relayed-backend fetch modes) are
refused at construction with NotImplementedError naming their ROADMAP
item (`REFUSED_KEYS`), never ignored.
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import threading
import time

from . import observe
from .config import Config
from .ingest import parser
from .metrics import FrameSet, InterMetric, MetricType
from .models.pipeline import AggregationEngine, EngineConfig, _not_ported
from .sinks import MetricSink
from .sinks.basic import (BlackholeMetricSink, BlackholeSpanSink,
                          DebugMetricSink, LocalFilePlugin)
from .sinks.ssfmetrics import SSFMetricsSink

log = logging.getLogger("veneur_tpu_torch.server")

_STOP = object()

_ITEM_10 = "item 10.2, forward, import and proxy"
_ITEM_9B2 = "item 9b.2, resilience and the network sinks"

# (config key, refused when, ROADMAP queue A item): the keys whose value
# this port cannot honour yet
REFUSED_KEYS = (
    ("forward_address", bool, _ITEM_10),
    ("consul_forward_service_name", bool, _ITEM_10),
    ("grpc_listen_addresses", bool, _ITEM_10),
    ("is_global", bool, _ITEM_10),
    ("durability_enabled", bool, "item 11, durability and /query"),
    ("history_retention_generations", lambda v: v > 0,
     "item 11, durability and /query"),
    ("native_ingest", bool, "item 13, native ingest"),
    ("tpu_num_devices", lambda v: v > 1, "item 14, multi-device engine"),
    ("tpu_flush_fetch", lambda v: v != "sync", "item 16, flush fetch modes"),
    ("tpu_flush_fetch_f16", bool, "item 16, flush fetch modes"),
    ("datadog_api_key", bool, _ITEM_9B2),
    ("datadog_trace_api_address", bool, _ITEM_9B2),
    ("signalfx_api_key", bool, _ITEM_9B2),
    ("kafka_broker", bool, _ITEM_9B2),
    ("newrelic_insert_key", bool, _ITEM_9B2),
    ("prometheus_repeater_address", bool, _ITEM_9B2),
    ("aws_s3_bucket", bool, _ITEM_9B2),
    ("splunk_hec_address", bool, _ITEM_9B2),
    ("lightstep_access_token", bool, _ITEM_9B2),
    ("xray_address", bool, _ITEM_9B2),
    ("falconer_address", bool, _ITEM_9B2),
    ("sentry_dsn", bool, _ITEM_9B2),
)


def refuse_unported(cfg: Config) -> None:
    """Raise NotImplementedError for the first config key whose value the
    port cannot honour."""
    for key, refused, item in REFUSED_KEYS:
        v = getattr(cfg, key)
        if refused(v):
            raise _not_ported(f"{key}={v!r}", item)
    if cfg.tpu_fused_kernels == "off":
        raise NotImplementedError(
            "tpu_fused_kernels='off' is not supported by veneur_tpu_torch: "
            "the port has no path without its hand-written kernels "
            "(ROADMAP queue B)")


class Server:
    def __init__(self, cfg: Config, sinks: list[MetricSink] | None = None,
                 plugins=None, device=None, span_sinks=None):
        refuse_unported(cfg)
        if not cfg.tpu_flush_double_buffer:
            log.info("tpu_flush_double_buffer: false — the port's flush is "
                     "always double-buffered, which flushes the same rows")
        self.cfg = cfg
        if device is None:
            device = "cpu" if cfg.aggregation_backend == "cpu" else "cuda"
        self.hostname = cfg.hostname or (
            "" if cfg.omit_empty_hostname else socket.gethostname())
        n_workers = max(1, cfg.num_workers)
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
            flush_incremental=cfg.tpu_flush_incremental,
            flush_incremental_threshold=cfg.tpu_flush_incremental_threshold,
            hostname=self.hostname,
        )
        self.engines = [AggregationEngine(EngineConfig(**ecfg_kw),
                                          device=device)
                        for _ in range(n_workers)]
        self.device = self.engines[0].device
        self.worker_queues: list[queue.Queue] = [
            queue.Queue(maxsize=65536) for _ in range(n_workers)]
        # the sketch-engine/wire stamp (no forward codec: forwarding is
        # refused above)
        self.engine_stamp = self.engines[0].engine_stamp
        # per-server telemetry registry (two servers in one process never
        # cross-count); _self_metrics drains it and the process default
        self.telemetry = observe.TelemetryRegistry()
        # overload defense: ONE controller shared by every engine's
        # interners (per-prefix key budgets + fold-to-other) and by
        # handle_packet (adaptive shed); None = defense off
        self.admission = None
        self._rate_corrected_types = None
        if cfg.overload_defense_enabled:
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
        self.sinks = sinks if sinks is not None else self._sinks_from_config()
        if plugins is not None:
            self.plugins = plugins
        else:
            self.plugins = []
            if cfg.flush_file:
                self.plugins.append(LocalFilePlugin(
                    cfg.flush_file, max(1, round(cfg.interval_seconds))))
        # the fleet view behind /debug/fleet, built as the reference
        # builds it for a server with an HTTP listener (a local tier
        # receives no forwards: it stays empty until item 10.2)
        self.fleet = None
        if cfg.http_address:
            self.fleet = observe.FleetView(
                max_senders=cfg.fleet_max_senders,
                window=cfg.fleet_e2e_window)
        # tags_exclude strips tag names before key construction; the
        # parser bounds reject over-long names and tags (counted)
        self._exclude_tags = frozenset(cfg.tags_exclude) or None
        self._max_name_len = cfg.metric_max_name_length
        self._max_tag_len = cfg.metric_max_tag_length
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
        """Always 0: the server has no import path yet (item 10.2)."""
        return self._peek("import.rejected")

    @property
    def flush_count(self) -> int:
        """Completed flush ticks since start (a level: never drained)."""
        return self.telemetry.level(observe.SERVER_SCOPE, "flush.count")

    def _sinks_from_config(self) -> list[MetricSink]:
        # the network sinks are refused above (ROADMAP item 9b.2)
        return [DebugMetricSink() if self.cfg.debug
                else BlackholeMetricSink()]

    def _span_sinks_from_config(self):
        """Span egress: always the ssfmetrics bridge, so embedded samples
        reach the metric pipeline (the network span sinks are refused
        above, ROADMAP item 9b.2)."""
        out = [SSFMetricsSink(
            self._route_metric,
            indicator_span_timer_name=self.cfg.indicator_span_timer_name)]
        if self.cfg.debug:
            out.append(BlackholeSpanSink())
        return out

    # ------------- lifecycle -------------

    def start(self):
        """Start sinks, workers, listeners, the trace client, the span
        worker, the HTTP API, the flusher and the watchdog. No warm-up:
        the port compiles nothing per shape, and each engine ran its
        probe at construction."""
        for s in self.sinks:
            try:
                s.start()
            except Exception as e:
                log.error("sink %s failed to start: %s", s.name(), e)
        for i, q in enumerate(self.worker_queues):
            self._spawn(self._worker_loop, f"worker-{i}", i, q)
        for addr in self.cfg.statsd_listen_addresses:
            self._start_statsd_listener(addr)
        for addr in self.cfg.ssf_listen_addresses:
            self._start_ssf_listener(addr)
        if self.trace_client is None and self._ssf_udp_sock is not None:
            from . import trace
            self.trace_client = trace.Client(
                f"udp://127.0.0.1:{self._ssf_udp_sock.getsockname()[1]}")
        if self.cfg.enable_profiling:
            self._start_profiling()
        for ss in self.span_sinks:
            try:
                ss.start()
            except Exception as e:
                log.error("span sink %s failed to start: %s",
                          ss.name(), e)
        self._spawn(self._span_worker, "span-worker")
        if self.cfg.http_address:
            self._start_http_api(self.cfg.http_address)
        self._last_flush_ok = time.monotonic()
        self._spawn(self._flush_loop, "flusher")
        # the watchdog always runs: it counts overdue ticks
        # (veneur.watchdog.stalled_ticks_total, behind /healthz); the
        # crash-only exit stays gated on flush_watchdog_missed_flushes
        self._spawn(self._watchdog, "watchdog")
        self._started = True

    def _spawn(self, target, name, *args):
        t = threading.Thread(target=target, args=args, name=name,
                             daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def stop(self, timeout: float = 10.0):
        """Stop every listener, worker and thread this server started,
        waiting at most `timeout` seconds for them in all."""
        deadline = time.monotonic() + timeout
        self._stop.set()
        if self.http_api is not None:
            self.http_api.stop()
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
        for t in self._threads + readers:
            t.join(max(0.0, deadline - time.monotonic()))
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
        while True:
            try:
                data, _ = sock.recvfrom(max_len)
            except OSError:
                break
            if self._stop.is_set():
                break
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

        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        payload = framing.read_ssf_frame(conn)
                        if payload is None:
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

    def _start_http_api(self, addr: str):
        """The ops HTTP listener (handlers.go): healthchecks, version,
        /debug/flush, /debug/flush/profile and /debug/fleet; POST /import
        answers 501 until the global tier is ported."""
        from .http_api import HttpApi

        self.http_api = HttpApi(
            addr, debug_state=self._debug_flush_state,
            fleet_state=self._debug_fleet_state,
            health=self.health_state,
            # the profiler trigger exists only when the operator opted
            # in via debug_flush_profile (a capture is a debug action)
            profile=(self.request_profile_capture
                     if self.cfg.debug_flush_profile else None))
        self.http_api.start()
        self._threads.append(self.http_api.thread)

    def bound_port(self) -> int:
        """Port of the first UDP socket (for callers binding port 0)."""
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

    def _worker_loop(self, idx: int, q: queue.Queue):
        """[HOT LOOP 2] queue -> engine (Worker.Work)."""
        eng = self.engines[idx]
        while True:
            item = q.get()
            try:
                if item is _STOP:
                    break
                if isinstance(item, parser.UDPMetric):
                    eng.process(item)
                elif isinstance(item, parser.Event):
                    eng.process_event(item)
                else:
                    eng.process_service_check(item)
            finally:
                q.task_done()

    def drain(self, timeout: float = 10.0, *, clock=time.monotonic,
              sleep=time.sleep) -> bool:
        """Block until every enqueued span and metric has been fully
        processed by its worker (not merely popped): the queues'
        unfinished-task accounting counts an item mid-`eng.process` as
        in flight. False when `timeout` seconds pass first. `clock` and
        `sleep` are injectable, so the deadline path is testable without
        real waiting."""
        deadline = clock() + timeout
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
            except Exception:
                log.exception("flush failed")
                self._count("flush.error")

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
        events, checks = [], []
        status_metrics = []
        eng_stats = {"samples": 0, "dropped_no_slot": 0,
                     "swap_ns": 0, "merge_ns": 0, "assembly_ns": 0}
        results: list = [None] * len(self.engines)
        eng_ph: list = [-1] * len(self.engines)
        ep = -1 if tick is None else tick.start("engine")

        def _one(i, eng):
            ph = -1 if tick is None else tick.start("engine.flush", ep)
            eng_ph[i] = ph
            try:
                results[i] = eng.flush(timestamp=ts)
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
            ev, ch = eng.drain_events()
            events.extend(ev)
            checks.extend(ch)
        if tick is not None:
            tick.finish(ep)

        if self.fleet is not None:
            # e2e boundary of the receiving tier; a local tier has no
            # senders, so this records the phase and nothing else
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
        """GET /debug/flush payload: the flight-recorder ring and the
        registry, under the reference's keys (the parts of a global or
        durable server read None here)."""
        return {
            "flush_count": self.flush_count,
            "sketch_engines": self.engines[0].engines_describe(),
            "flight_recorder": (None if self.flight is None
                                else self.flight.debug_state()),
            "forward": None,
            # overload defense: budgets, per-prefix cardinality
            # estimates, governor rate, fold/shed counters
            "admission": (self.admission.debug_state()
                          if self.admission is not None
                          else {"enabled": False}),
            "dedupe_ledger": None,
            "durability": {
                "forward_journal_bytes": None,
                "watermark_journal_bytes": None,
                "engine_checkpoint": None,
                "history": None,
            },
            "query": None,
            "registry": {
                "server": self.telemetry.debug_state(),
                "process": observe.DEFAULT_REGISTRY.debug_state(),
            },
        }

    # health verdict threshold: a flush is STALLED once its lag exceeds
    # this many intervals
    HEALTH_STALL_INTERVALS = 1.5

    def health_state(self, now: float | None = None) -> dict:
        """Structured verdicts for GET /healthz and /ready. `healthy` is
        false only when the flush loop is stalled; a worker queue over 90%
        full flags `status: degraded` without failing the probe. `now` is
        injectable."""
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
        if self.admission is not None:
            rate = self.admission.shed_rate
            checks["overload"] = {"ok": rate >= 1.0, "shed_rate": rate}
        qfill = max((q.qsize() / q.maxsize for q in self.worker_queues),
                    default=0.0)
        checks["queues"] = {"ok": qfill < 0.9, "fill": round(qfill, 4)}
        degraded = any(not c["ok"] for c in checks.values())
        return {
            "healthy": not stalled,
            "ready": started and not self._stop.is_set(),
            "status": ("stalled" if stalled
                       else "degraded" if degraded else "ok"),
            "checks": checks,
        }

    def _debug_fleet_state(self) -> dict:
        """GET /debug/fleet payload, under the reference's keys: the
        fleet view (empty on a local tier, which receives no forwards),
        the engine stamp and the health verdict."""
        now_ns = time.time_ns()
        return {
            "now_ns": now_ns,
            "flush_count": self.flush_count,
            "senders": self.fleet.debug_state(now_ns)["senders"],
            "forward": None,
            "forward_bytes": {"cumulative": {}, "last_interval": None},
            "sketch_engines": {
                "local": self.engine_stamp,
                "mismatch_rejects": observe.DEFAULT_REGISTRY.total(
                    "import", "import.engine_mismatch"),
            },
            "fleet_cardinality": self._fleet_cardinality(),
            "import_recorder": None,
            "health": self.health_state(),
        }

    def _fleet_cardinality(self, top: int = 50) -> dict:
        """JSON-ready per-prefix cardinality estimates: this server's
        admission-controller sketches (a local tier merges no received
        sketches: those arrive with item 10.2's imports)."""
        if self.admission is None:
            return {}
        from .ingest.admission import estimate_registers
        rows = sorted(
            ((p, round(estimate_registers(r), 1))
             for p, r in self.admission.export_sketches()),
            key=lambda kv: -kv[1])
        return dict(rows[:top])

    def _self_metrics(self, ts: int, t0: float,
                      eng_stats: dict) -> list[InterMetric]:
        """veneur.* self-telemetry: stage the per-tick gauges/deltas into
        the registry, then drain it and the process default through the
        one name mapping in observe/registry.py."""
        tel, S = self.telemetry, observe.SERVER_SCOPE
        # the core counters report every interval, zeros included, under
        # the reference's names (import.rejected stays zero here)
        for name in ("packet.received", "packet.error", "worker.dropped",
                     "ssf.received", "ssf.error", "flush.error",
                     "import.rejected", "watchdog.stalled_ticks"):
            tel.mark(S, name, 0)
        if self.flight is not None:
            tel.mark(S, "observe.phases_dropped", 0)
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
        tel.mark(S, "samples.processed", eng_stats["samples"])
        tel.mark(S, "samples.dropped_no_slot", eng_stats["dropped_no_slot"])
        tel.set_gauge(S, "flush.swap_duration_ns", eng_stats["swap_ns"])
        tel.set_gauge(S, "flush.merge_duration_ns", eng_stats["merge_ns"])
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
                os._exit(2)
