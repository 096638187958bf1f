"""veneur-proxy: consistent-hash fan-out of forwarded metrics across a
pool of global veneurs — the port's copy of veneur_tpu/cluster/proxy.py.

Parity: proxysrv/server.go (sym: proxysrv.Server.SendMetrics — gRPC in,
per-destination re-batch, gRPC out) and proxy.go (sym: Proxy.ProxyMetrics,
Proxy.RefreshDestinations — ring refresh from a Discoverer). The ring uses
the replicated-point construction of the reference's vendored
stathat/consistent library (N virtual points per destination, keys walk
clockwise to the first point), with fnv1a-32 as the point hash. The
wire and grpc are imported inside the calls that use them.
"""

from __future__ import annotations

import bisect
import logging
import threading

from ..resilience import accepts_envelope
from ..utils.hashing import fnv1a_32
from .forward import GrpcForwarder

log = logging.getLogger("veneur_tpu_torch.cluster.proxy")


class ConsistentRing:
    """Consistent-hash ring with virtual replicas."""

    def __init__(self, destinations: list[str] | None = None,
                 replicas: int = 120):
        self.replicas = replicas
        self._points: list[int] = []
        self._owners: dict[int, str] = {}
        if destinations:
            self.set_destinations(destinations)

    def set_destinations(self, destinations: list[str]):
        points: list[int] = []
        owners: dict[int, str] = {}
        for d in destinations:
            for i in range(self.replicas):
                h = fnv1a_32(f"{d}#{i}".encode())
                owners[h] = d
                points.append(h)
        points.sort()
        self._points, self._owners = points, owners

    def get(self, key: bytes) -> str:
        if not self._points:
            raise RuntimeError("ring is empty")
        h = fnv1a_32(key)
        i = bisect.bisect_right(self._points, h)
        if i == len(self._points):
            i = 0
        return self._owners[self._points[i]]

    def __len__(self):
        return len(set(self._owners.values()))


class ProxyServer:
    """Receives forwardrpc batches, splits per metric, consistent-hashes
    each metric key onto a destination, re-batches and forwards."""

    def __init__(self, discoverer, service_name: str = "",
                 refresh_interval_s: float = 30.0, replicas: int = 120,
                 forwarder_factory=GrpcForwarder):
        self.discoverer = discoverer
        self.service_name = service_name
        self.refresh_interval_s = refresh_interval_s
        self.ring = ConsistentRing(replicas=replicas)
        self._forwarders: dict[str, object] = {}
        self._factory = forwarder_factory
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._grpc_server = None
        self.http_front = None   # attached by the CLI when configured
        # delta demotion warn-once set: senders
        # already told their deltas are being demoted; bounded so a
        # parade of one-shot sender ids can't grow it forever
        self._delta_warned: set = set()
        self.refresh_destinations()

    # ---- ring maintenance ----

    def refresh_destinations(self):
        try:
            dests = self.discoverer.get_destinations_for_service(
                self.service_name)
        except Exception:
            log.exception("destination refresh failed; keeping old ring")
            return
        if not dests:
            log.warning("discoverer returned no destinations; keeping ring")
            return
        with self._lock:
            self.ring.set_destinations(dests)
            for d in list(self._forwarders):
                if d not in dests:
                    fw = self._forwarders.pop(d)
                    close = getattr(fw, "close", None)
                    if close:
                        try:
                            close()
                        except Exception:
                            pass

    def _refresh_loop(self):
        while not self._stop.wait(self.refresh_interval_s):
            self.refresh_destinations()

    # ---- routing ----

    def _forwarder_for(self, dest: str):
        with self._lock:
            fw = self._forwarders.get(dest)
            if fw is None:
                fw = self._factory(dest)
                self._forwarders[dest] = fw
        return fw

    def route_metrics(self, metrics) -> dict[str, list]:
        """Group metricpb.Metrics by owning destination."""
        from .wire import metric_key_of
        groups: dict[str, list] = {}
        with self._lock:   # one acquisition per batch, not per metric
            for m in metrics:
                key = metric_key_of(m)
                ring_key = f"{key.name}{key.type}{key.joined_tags}".encode()
                groups.setdefault(self.ring.get(ring_key), []).append(m)
        return groups

    # ---- delta demotion ----
    #
    # Delta forwarding assumes ONE receiver sees a sender's
    # unbroken interval_seq chain. A proxy fanning one sender out to
    # MULTIPLE globals re-shards that chain per metric: each receiver
    # sees only the seqs whose ring share included it, every other seq
    # is a gap, and the receiver-side gap check refuses each delta —
    # the sender then spills + forces a full resync EVERY interval, a
    # refusal/resync livelock that silently eats the delta win. The
    # delta marker only ARMS that belt-check (a delta payload is a
    # full-fidelity touched-key subset of its interval — applying it
    # without the check can never corrupt state), so a multi-
    # destination proxy DEMOTES the marker to full, warns once per
    # sender that gap detection is disabled on this path, and counts
    # veneur.proxy.delta_demoted_total. A single-destination ring
    # keeps the chain contiguous and passes the marker through.

    _MAX_DELTA_WARNED = 1024

    def _note_delta_demotion(self, sender: str):
        from ..resilience import DEFAULT_REGISTRY
        DEFAULT_REGISTRY.incr("proxy", "proxy.delta_demoted")
        with self._lock:
            if sender in self._delta_warned:
                return
            if len(self._delta_warned) >= self._MAX_DELTA_WARNED:
                self._delta_warned.clear()
            self._delta_warned.add(sender)
        log.warning(
            "proxy: sender %r forwards DELTAS through a %d-destination "
            "ring — the per-sender seq chain re-shards, so deltas are "
            "demoted to full sends here (receiver gap detection is "
            "disabled on this path; run delta fleets with a single "
            "destination, or set forward_delta: false at the sender)",
            sender, len(self.ring))

    def _demote_delta_pb(self, envelope):
        """forwardrpc arm: clear Envelope.forward_kind (0 == full) on
        a COPY — the inbound request object is not ours to mutate."""
        if envelope is None or envelope.forward_kind != 1 \
                or len(self.ring) <= 1:
            return envelope
        from .protos import forward_pb2
        self._note_delta_demotion(envelope.sender_id or "(unknown)")
        demoted = forward_pb2.Envelope()
        demoted.CopyFrom(envelope)
        demoted.forward_kind = 0
        return demoted

    def demote_delta_headers(self, env: dict | None) -> dict | None:
        """jsonmetric-v1 arm: drop the kind header (absent == full)."""
        from . import wire
        if not env or len(self.ring) <= 1:
            return env
        if wire.forward_kind_from_headers(env) != wire.KIND_DELTA:
            return env
        self._note_delta_demotion(
            env.get(wire.ENVELOPE_SENDER_HEADER, "(unknown)"))
        return {k: v for k, v in env.items()
                if k != wire.FORWARD_KIND_HEADER}

    def handle_metric_list(self, metric_list):
        """The SendMetrics implementation: fan out groups concurrently
        (one goroutine per destination in the reference). An incoming
        idempotency envelope is passed through UNMODIFIED to every
        destination's share — except a delta kind marker on a multi-
        destination ring, which demotes to full (see above): the ring
        split is deterministic, so a sender replay re-splits
        identically and each global dedupes its own share on the
        original (sender, seq, chunk) ids."""
        from . import wire
        envelope = (metric_list.envelope
                    if metric_list.HasField("envelope") else None)
        envelope = self._demote_delta_pb(envelope)
        # sketch-engine stamp + advisory prefix sketches pass through
        # verbatim to EVERY destination's share (stripping the stamp
        # would make a non-default fleet read as legacy and be refused
        # at the globals; the cardinality rows merge by max, so every
        # destination receiving them is idempotent)
        stamp = metric_list.sketch_engines or None
        sketches_rows = wire.prefix_sketches_from_pb(metric_list)
        groups = self.route_metrics(metric_list.metrics)
        errs: list[Exception] = []
        threads = []
        for dest, ms in groups.items():
            def send(dest=dest, ms=ms):
                try:
                    fw = self._forwarder_for(dest)
                    kw = {}
                    if stamp or sketches_rows:
                        kw = {"sketch_engines": stamp,
                              "prefix_sketches": sketches_rows}
                    if envelope is not None and \
                            accepts_envelope(fw.send_metrics):
                        fw.send_metrics(ms, envelope=envelope, **kw)
                    else:
                        fw.send_metrics(ms, **kw)
                except Exception as e:
                    log.warning("proxy forward to %s failed: %s", dest, e)
                    errs.append(e)
            t = threading.Thread(target=send, daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        return errs

    # ---- gRPC front ----

    def start(self, address: str):
        import grpc

        from .protos import forward_pb2

        # The proxy serves the same Forward contract, forwarding whole
        # batches without aggregating.
        class _BatchHandler(grpc.GenericRpcHandler):
            def service(inner, details):
                from .forward import SEND_METRICS
                if details.method == SEND_METRICS:
                    return grpc.unary_unary_rpc_method_handler(
                        lambda req, ctx: self._serve_batch(req, ctx),
                        request_deserializer=(
                            forward_pb2.MetricList.FromString),
                        response_serializer=(
                            forward_pb2.Empty.SerializeToString))
                return None

        from concurrent import futures
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        server.add_generic_rpc_handlers((_BatchHandler(),))
        port = server.add_insecure_port(address)
        server.start()
        self._grpc_server = server
        t = threading.Thread(target=self._refresh_loop, daemon=True,
                             name="proxy-refresh")
        t.start()
        log.info("proxy listening on %s", address)
        return server, port

    def _serve_batch(self, request, context=None):
        from .protos import forward_pb2
        errs = self.handle_metric_list(request)
        if errs and context is not None:
            # a partially-failed fan-out must NOT be acked: the sender
            # would never replay and the failed destinations' shares
            # would be lost. Abort retryably instead — the sender's
            # retry/replay re-splits identically on the ring, and the
            # destinations that DID succeed dedupe their share on the
            # passed-through envelope, so nothing double-counts (the
            # HTTP front's 502 is this same contract).
            import grpc
            context.abort(
                grpc.StatusCode.UNAVAILABLE,
                f"proxy fan-out failed for {len(errs)} destination(s): "
                f"{errs[0]}")
        return forward_pb2.Empty()

    def stop(self):
        self._stop.set()
        if self._grpc_server is not None:
            self._grpc_server.stop(1.0).wait(5.0)
        if self.http_front is not None:
            self.http_front.stop()
        # release the per-destination channels (their threads would
        # otherwise outlive the proxy)
        with self._lock:
            fws, self._forwarders = list(self._forwarders.values()), {}
        for fw in fws:
            close = getattr(fw, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass


class _JsonDest:
    """POST a JSONMetric batch to one destination's /import
    (the HTTP fan-out arm of proxy.go sym: Proxy.ProxyMetrics).
    Each destination carries its own breaker via its Egress."""

    def __init__(self, dest: str, timeout_s: float = 10.0,
                 egress=None):
        from ..resilience import Egress
        base = dest if "://" in dest else f"http://{dest}"
        self.url = base.rstrip("/") + "/import"
        self.timeout_s = timeout_s
        self._egress = egress or Egress(self.url)

    def send_json(self, dicts: list, envelope: dict | None = None):
        """`envelope` is the sender's idempotency headers, passed
        through UNMODIFIED (see ProxyServer.handle_metric_list — the
        deterministic ring split makes per-destination dedupe on the
        original ids sound)."""
        import json as _json
        import urllib.request
        headers = {"Content-Type": "application/json",
                   "X-Veneur-Forward-Version": "jsonmetric-v1"}
        if envelope:
            headers.update(envelope)
        req = urllib.request.Request(
            self.url, data=_json.dumps(dicts).encode(),
            headers=headers, method="POST")
        self._egress.post(req, timeout_s=self.timeout_s)


class HttpProxyFront:
    """The legacy HTTP face of veneur-proxy (proxy.go sym: Proxy.Handler):
    POST /import bodies are split per metric, consistent-hashed on the
    SAME ring as the gRPC arm (identical key string, so a mixed fleet
    routes identically), re-batched and POSTed concurrently to each
    destination's /import."""

    def __init__(self, proxy: ProxyServer, dest_factory=_JsonDest):
        self.proxy = proxy
        self._dests: dict[str, _JsonDest] = {}
        self._factory = dest_factory
        self._server = None
        self.proxied_total = 0
        self.errors_total = 0
        # handle_batch runs on ThreadingHTTPServer handler threads (one
        # per POST); the counter read-modify-writes need a lock even
        # after the per-batch results are aggregated post-join.
        self._totals_lock = threading.Lock()

    def route_json(self, dicts: list) -> dict[str, list]:
        groups: dict[str, list] = {}
        ring = self.proxy.ring
        with self.proxy._lock:
            for d in dicts:
                joined = ",".join(sorted(d.get("tags", [])))
                ring_key = (f"{d.get('name', '')}{d.get('type', '')}"
                            f"{joined}").encode()
                groups.setdefault(ring.get(ring_key), []).append(d)
        return groups

    def handle_batch(self, dicts: list,
                     envelope: dict | None = None) -> list:
        groups = self.route_json(dicts)
        # per-thread result slots, aggregated after the join; the shared
        # totals are then bumped under _totals_lock (concurrent POSTs)
        results: list = [None] * len(groups)
        threads = []
        for i, (dest, ms) in enumerate(groups.items()):
            def send(i=i, dest=dest, ms=ms):
                try:
                    fw = self._dests.get(dest)
                    if fw is None:
                        fw = self._dests[dest] = self._factory(dest)
                    if envelope and accepts_envelope(fw.send_json):
                        fw.send_json(ms, envelope=envelope)
                    else:
                        fw.send_json(ms)
                except Exception as e:
                    log.warning("http proxy forward to %s failed: %s",
                                dest, e)
                    results[i] = (e, len(ms))
            t = threading.Thread(target=send, daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        errs = [r[0] for r in results if r is not None]
        failed = sum(r[1] for r in results if r is not None)
        with self._totals_lock:
            self.proxied_total += len(dicts) - failed
            self.errors_total += len(errs)
        return errs

    def start(self, address: str):
        import json as _json
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        from . import wire

        front = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.rstrip("/") in ("/healthcheck", ""):
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.write(b"ok")
                    return
                self.send_response(404)
                self.end_headers()

            def do_POST(self):
                if self.path.rstrip("/") != "/import":
                    self.send_response(404)
                    self.end_headers()
                    return
                # jsonmetric-v1 contract (README § HTTP forward
                # contract): reject a declared format we don't speak
                ver = self.headers.get("X-Veneur-Forward-Version")
                if ver is not None and ver != "jsonmetric-v1":
                    self.send_response(400)
                    self.end_headers()
                    self.wfile.write(
                        f"unsupported forward format {ver!r}\n".encode())
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    dicts = _json.loads(self.rfile.read(n))
                    assert isinstance(dicts, list)
                except Exception:
                    self.send_response(400)
                    self.end_headers()
                    return
                # idempotency envelope + trace context: forwarded
                # verbatim to every destination's share (dedupe happens
                # at the globals; dropping the trace headers here would
                # cut the cross-tier span tree in half at the proxy)
                env = {h: self.headers[h] for h in (
                    wire.ENVELOPE_SENDER_HEADER,
                    wire.ENVELOPE_SEQ_HEADER,
                    wire.ENVELOPE_CHUNK_HEADER,
                    # the delta/full marker rides verbatim: a proxy
                    # that stripped it would make every delta read as
                    # full downstream and silently disarm the
                    # receiver's gap check
                    wire.FORWARD_KIND_HEADER,
                    wire.TRACE_HEADER,
                    wire.TRACE_CLOSE_HEADER,
                    # engine stamp + advisory cardinality rows ride
                    # verbatim too — a stamp-stripping proxy would
                    # make a non-default fleet read as legacy and be
                    # refused at the globals
                    wire.SKETCH_HEADER,
                    wire.PREFIX_SKETCH_HEADER)
                    if self.headers.get(h) is not None}
                # delta demotion on the HTTP arm too: a multi-
                # destination ring re-shards the seq chain (see
                # ProxyServer._note_delta_demotion)
                env = front.proxy.demote_delta_headers(env)
                errs = front.handle_batch(dicts, envelope=env or None)
                self.send_response(502 if errs else 200)
                self.end_headers()

        host, _, port = address.rpartition(":")
        self._server = ThreadingHTTPServer(
            (host.strip("[]") or "0.0.0.0", int(port)), Handler)
        threading.Thread(target=self._server.serve_forever,
                         name="proxy-http", daemon=True).start()
        return self._server, self._server.server_address[1]

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
