"""Forwarding clients: local veneur -> (proxy ->) global veneur — the
port's copy of veneur_tpu/cluster/forward.py.

Parity: flusher.go (sym: Server.forwardGRPC) for the gRPC path and the
legacy HTTP POST /import path (sym: Server.flushForward) — here JSON
instead of Go gob, same payload semantics.

Both forwarders route their wire calls through a per-destination
`resilience.Egress` (retry with full-jitter backoff, circuit breaker,
per-flush deadline budget); terminal failures propagate so the
server-side `ResilientForwarder` can spill the interval's sketches for
re-merge instead of dropping them.

The wire (google.protobuf) is imported inside the calls, so importing
this module loads no protobuf until a forward is built.
"""

from __future__ import annotations

import json
import logging
import urllib.request

from ..models.pipeline import ForwardExport
from ..resilience import (DeltaGapRefusedError, Egress, EgressPolicy,
                          ForwardEnvelope, HTTPStatusError,
                          PartialDeliveryError, accepts_envelope,
                          grpc_channel)
log = logging.getLogger("veneur_tpu_torch.cluster.forward")

SEND_METRICS = "/forwardrpc.Forward/SendMetrics"
SEND_METRICS_V2 = "/forwardrpc.Forward/SendMetricsV2"

# what a receiver puts on the wire when it refuses a delta over a seq
# gap (importsrv aborts FAILED_PRECONDITION with this detail prefix;
# the HTTP /import path answers 409) — the leaf forwarders translate
# either into DeltaGapRefusedError so the replay layer falls back to a
# full resync instead of parking an unapplyable delta. The spelling is
# single-homed in wire.py (wire.DELTA_GAP_DETAIL) with the other wire
# literals.


def _is_delta_gap(exc: BaseException) -> bool:
    """Did this egress failure carry the receiver's delta-over-gap
    refusal? HTTP: status 409 (the import path's only 409). gRPC:
    FAILED_PRECONDITION whose details lead with DELTA_GAP_DETAIL
    (FAILED_PRECONDITION alone is also the engine-stamp mismatch)."""
    import urllib.error

    from .wire import DELTA_GAP_DETAIL
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code == 409
    if isinstance(exc, HTTPStatusError):
        return exc.status == 409
    if callable(getattr(exc, "code", None)):
        try:
            import grpc
            details = exc.details() if callable(
                getattr(exc, "details", None)) else ""
            return (exc.code() == grpc.StatusCode.FAILED_PRECONDITION
                    and DELTA_GAP_DETAIL in (details or ""))
        except Exception:
            return False
    return False


# grpc's default receive limit (4 MiB) and the share of it a forward
# chunk may fill: the rest is headroom for the envelope, the engine stamp
# and the first chunk's prefix sketches. A p=14 HLL row is 16 KiB, so a
# count limit alone lets a few hundred sets overrun the receiver.
GRPC_RECEIVE_LIMIT = 4 << 20
MAX_CHUNK_BYTES = 3 << 20


def _chunk_bounds(metrics, max_n: int, max_bytes: int) -> list:
    """[(start, end)] of the chunks a metric list ships in: each holds at
    most `max_n` metrics and, unless one metric alone is larger, at most
    `max_bytes` of encoded metrics (each element's payload plus its tag
    and length prefix). Greedy from the front, so the chunks of a tail
    that starts at a chunk boundary are the original's own: a replayed
    PartialDeliveryError tail resends the same chunks under the same
    chunk ids."""
    bounds, start, size = [], 0, 0
    for i, m in enumerate(metrics):
        n = m.ByteSize()
        n += 1 + max(1, (n.bit_length() + 6) // 7)
        if i > start and (i - start >= max_n or size + n > max_bytes):
            bounds.append((start, i))
            start, size = i, 0
        size += n
    if start < len(metrics):
        bounds.append((start, len(metrics)))
    return bounds


def _count_forward_bytes(egress: Egress, nbytes: int, kind: str):
    """Per-destination bytes-on-the-wire accounting: one
    total plus a per-kind split, counted on successful delivery only
    (retries of a failed chunk are visible as egress attempts). Drains
    as veneur.forward.bytes_total / bytes_full_total /
    bytes_delta_total, tagged destination:<scope>."""
    reg, dest = egress.registry, egress.destination
    reg.incr(dest, "forward.bytes", nbytes)
    reg.incr(dest, "forward.bytes_delta" if kind == "delta"
             else "forward.bytes_full", nbytes)


class GrpcForwarder:
    """Callable handed to Server.forwarder: ships a flush's exports
    upstream over the forwardrpc contract."""

    def __init__(self, address: str, timeout_s: float = 10.0,
                 max_per_batch: int = 10_000,
                 egress: Egress | None = None,
                 egress_policy: EgressPolicy | None = None,
                 engine_stamp: str | None = None,
                 centroid_codec: str = "lossless"):
        self.address = address
        self.timeout_s = timeout_s
        # a chunk closes at whichever limit it reaches first: this metric
        # count, or MAX_CHUNK_BYTES of encoded metrics
        self.max_per_batch = max_per_batch
        # sketch-engine/wire-format stamp declared on every chunk
        # (mixed-fleet safety); None = legacy (unstamped).
        # Callers fold the centroid codec into the stamp
        # (sketches.stamp_with_codec) so a q16 fleet reads as a
        # distinct wire format.
        self.engine_stamp = engine_stamp
        # centroid wire row: "lossless" (repeated Centroid messages)
        # or "q16" (the packed quantized row)
        self.centroid_codec = centroid_codec
        self._egress = egress or Egress(f"grpc://{address}",
                                        policy=egress_policy)
        from .protos import forward_pb2
        self._channel = grpc_channel(address)
        self._send = self._channel.unary_unary(
            SEND_METRICS,
            request_serializer=forward_pb2.MetricList.SerializeToString,
            response_deserializer=forward_pb2.Empty.FromString)

    def __call__(self, export: ForwardExport,
                 envelope: ForwardEnvelope | None = None):
        """Multi-batch exports fail PRECISELY: a terminal failure after
        some batches landed raises PartialDeliveryError carrying only
        the unsent tail (and how many chunks DID land), so the
        spill/replay layer resends only undelivered chunks — under the
        same chunk ids when an `envelope` is given, letting the
        receiver's dedupe ledger drop anything it already Combined
        during an ambiguous failure. All batches share ONE deadline
        budget — N batches cannot stall the flush tick for
        N x retry_deadline."""
        from . import wire
        from .protos import forward_pb2
        metrics = wire.export_to_metrics(export,
                                         codec=self.centroid_codec)
        deadline = self._egress.deadline()
        bounds = _chunk_bounds(metrics, self.max_per_batch,
                               MAX_CHUNK_BYTES)
        n_chunks = len(bounds)
        total = 0
        kind = envelope.kind if envelope is not None else "full"
        if envelope is not None:
            total = envelope.chunk_count or (envelope.chunk_offset
                                             + n_chunks)
        for j, (i, end) in enumerate(bounds):
            batch = forward_pb2.MetricList(metrics=metrics[i:end])
            if self.engine_stamp:
                batch.sketch_engines = self.engine_stamp
            if j == 0 and export.prefix_sketches:
                # advisory cardinality rows ride the first chunk only
                # (merge-by-max is idempotent across replays)
                wire.prefix_sketches_to_pb(batch, export.prefix_sketches)
            if envelope is not None:
                batch.envelope.CopyFrom(wire.envelope_pb(
                    envelope.sender_id, envelope.interval_seq,
                    envelope.chunk_offset + j, total,
                    trace_id=envelope.trace_id,
                    span_id=envelope.span_id,
                    close_ns=envelope.close_ns,
                    kind=kind))
            try:
                self._egress.call(self._send, batch,
                                  timeout_s=self.timeout_s,
                                  deadline=deadline)
            except Exception as e:
                if kind == "delta" and _is_delta_gap(e):
                    # receiver refused the whole seq before applying
                    # anything; the replay layer falls back to full.
                    # Gated on kind: a full send can never be gap-
                    # refused (receivers only gap-check deltas), so a
                    # 409/FAILED_PRECONDITION there is some foreign
                    # intermediary's error and must stay on the
                    # exactly-once park path, not the spill fallback.
                    raise DeltaGapRefusedError(
                        f"{self.address}: {e}") from e
                if j == 0:
                    raise    # nothing delivered: spill the whole export
                raise PartialDeliveryError(
                    _export_tail(export, i), e, delivered_chunks=j,
                    chunk_count=total or n_chunks) from e
            _count_forward_bytes(self._egress, batch.ByteSize(), kind)

    def send_metrics(self, metrics: list, envelope=None,
                     sketch_engines=None, prefix_sketches=None):
        """Ship raw metricpb.Metrics (used by the proxy's re-batching),
        batches retried under one shared deadline budget. `envelope` is
        a received forwardrpc.Envelope passed through UNMODIFIED (the
        proxy must not re-stamp chunks it splits — sub-chunking would
        mint chunk ids the sender never issued and break dedupe). The
        whole group ships as ONE list under the original ids; that is
        size-safe because the group is a subset of a single MetricList
        that already fit through this proxy's inbound gRPC message
        limit, so it cannot exceed a same-configured outbound limit.
        `sketch_engines`/`prefix_sketches` are likewise passed through
        verbatim (a proxy that stripped the engine stamp would make a
        non-default fleet read as legacy and be refused downstream)."""
        from . import wire
        from .protos import forward_pb2
        deadline = self._egress.deadline()
        if envelope is not None:
            batch = forward_pb2.MetricList(metrics=metrics)
            batch.envelope.CopyFrom(envelope)
            if sketch_engines:
                batch.sketch_engines = sketch_engines
            if prefix_sketches:
                wire.prefix_sketches_to_pb(batch, prefix_sketches)
            self._egress.call(self._send, batch,
                              timeout_s=self.timeout_s,
                              deadline=deadline)
            _count_forward_bytes(
                self._egress, batch.ByteSize(),
                "delta" if envelope.forward_kind == 1 else "full")
            return
        for j, (i, end) in enumerate(_chunk_bounds(
                metrics, self.max_per_batch, MAX_CHUNK_BYTES)):
            batch = forward_pb2.MetricList(metrics=metrics[i:end])
            if sketch_engines:
                batch.sketch_engines = sketch_engines
            if j == 0 and prefix_sketches:
                wire.prefix_sketches_to_pb(batch, prefix_sketches)
            self._egress.call(self._send, batch,
                              timeout_s=self.timeout_s,
                              deadline=deadline)
            _count_forward_bytes(self._egress, batch.ByteSize(), "full")

    def close(self):
        self._channel.close()


def _export_tail(export: ForwardExport, start: int) -> ForwardExport:
    """Entries `start`.. of the export in wire order — metric i of
    export_to_metrics corresponds 1:1 to the concatenation of
    (histograms, sets, counters, gauges), so the unsent tail of the
    metric list maps back to an export exactly."""
    out = ForwardExport()
    pos = 0
    for entries, taker in ((export.histograms, out.histograms),
                           (export.sets, out.sets),
                           (export.counters, out.counters),
                           (export.gauges, out.gauges)):
        if start <= pos:
            taker.extend(entries)
        elif start < pos + len(entries):
            taker.extend(entries[start - pos:])
        pos += len(entries)
    return out


class HttpJsonForwarder:
    """Legacy-path forwarder: POST /import with a JSON array (the
    reference's JSONMetric list; digests ride as centroid arrays rather
    than Go gob blobs).

    This is a VERSIONED CONTRACT, not a stopgap: the body is the
    `jsonmetric-v1` format (see README § HTTP forward contract), declared
    on the wire via the X-Veneur-Forward-Version header so a receiver
    can reject a format it does not speak instead of misparsing it.
    The reference's gob-encoded `[]JSONMetric` body (flusher.go sym:
    flushForward) is deliberately NOT emitted — gob is a Go-internal
    reflection format and both ends of this path are ours; mixed fleets
    interoperate over the gRPC metricpb path, which stays
    byte-compatible (tests/test_wire_golden.py)."""

    FORMAT = "jsonmetric-v1"

    def __init__(self, base_url: str, timeout_s: float = 10.0,
                 max_per_body: int = 25_000,
                 egress: Egress | None = None,
                 egress_policy: EgressPolicy | None = None,
                 engine_stamp: str | None = None,
                 centroid_codec: str = "lossless"):
        self.url = base_url.rstrip("/") + "/import"
        self.timeout_s = timeout_s
        self.max_per_body = max_per_body
        self.engine_stamp = engine_stamp
        self.centroid_codec = centroid_codec
        self._egress = egress or Egress(self.url, policy=egress_policy)

    def _flush_headers(self) -> dict:
        """The per-FLUSH static header set (format version + engine/
        wire stamp): computed ONCE per __call__ and copied per chunk —
        the send loop must never recompute the stamp per chunk
        (pinned by a call-count test; the per-chunk work is only the
        envelope fields, which genuinely vary per chunk)."""
        from . import wire
        headers = {"Content-Type": "application/json",
                   "X-Veneur-Forward-Version": self.FORMAT}
        if self.engine_stamp:
            headers[wire.SKETCH_HEADER] = self.engine_stamp
        return headers

    def _body_entries(self, export: ForwardExport) -> list:
        """JSONMetric dicts in WIRE ORDER (histograms, sets, counters,
        gauges) — entry i corresponds 1:1 to metric i of
        wire.export_to_metrics, so `_export_tail` maps a chunk index
        back to an export for both contracts identically. The centroid
        carrier ("centroids" vs the q16 "centroids_q16" row) follows
        self.centroid_codec; the spelling lives in wire.py."""
        from . import wire
        body = []
        for key, means, weights, vmin, vmax, vsum, cnt, recip in (
                export.histograms):
            h = wire.histogram_wire_fragment(means, weights,
                                             codec=self.centroid_codec)
            h.update({"min": float(vmin), "max": float(vmax),
                      "sum": float(vsum), "count": float(cnt),
                      "reciprocal_sum": float(recip)})
            body.append({
                "name": key.name, "type": key.type,
                "tags": wire._split_tags(key.joined_tags),
                "histogram": h})
        for key, regs in export.sets:
            body.append({"name": key.name, "type": "set",
                         "tags": wire._split_tags(key.joined_tags),
                         "set": wire.encode_set_payload(
                             export.set_engine, regs).hex()})
        for key, value in export.counters:
            body.append({"name": key.name, "type": "counter",
                         "tags": wire._split_tags(key.joined_tags),
                         "value": value})
        for key, value in export.gauges:
            body.append({"name": key.name, "type": "gauge",
                         "tags": wire._split_tags(key.joined_tags),
                         "value": value})
        return body

    def __call__(self, export: ForwardExport,
                 envelope: ForwardEnvelope | None = None):
        """Chunked like the gRPC arm (max_per_body entries per POST,
        one shared deadline budget, PartialDeliveryError carrying the
        unsent tail + delivered chunk count); each chunk's envelope
        rides as the X-Veneur-* headers of the jsonmetric-v1
        contract."""
        from . import wire
        body = self._body_entries(export)
        deadline = self._egress.deadline()
        n_chunks = -(-len(body) // self.max_per_body)
        total = 0
        kind = envelope.kind if envelope is not None else "full"
        base_headers = self._flush_headers()
        if envelope is not None:
            total = envelope.chunk_count or (envelope.chunk_offset
                                             + n_chunks)
        for j in range(n_chunks):
            i = j * self.max_per_body
            headers = dict(base_headers)
            if j == 0 and export.prefix_sketches:
                # headers have practical size limits: cap the advisory
                # rows (the pb contract carries the full set)
                headers[wire.PREFIX_SKETCH_HEADER] = \
                    wire.encode_prefix_sketches_header(
                        export.prefix_sketches[:32])
            if envelope is not None:
                headers.update(wire.envelope_headers(
                    envelope.sender_id, envelope.interval_seq,
                    envelope.chunk_offset + j, total,
                    trace_id=envelope.trace_id,
                    span_id=envelope.span_id,
                    close_ns=envelope.close_ns,
                    kind=kind))
            data = json.dumps(body[i:i + self.max_per_body]).encode()
            req = urllib.request.Request(
                self.url, data=data, headers=headers, method="POST")
            try:
                self._egress.post(req, timeout_s=self.timeout_s,
                                  deadline=deadline)
            except Exception as e:
                # kind-gated like the gRPC arm: only a DELTA chunk can
                # be gap-refused; a stray 409 on a full send stays on
                # the exactly-once park path
                if kind == "delta" and _is_delta_gap(e):
                    raise DeltaGapRefusedError(
                        f"{self.url}: {e}") from e
                if j == 0:
                    raise
                raise PartialDeliveryError(
                    _export_tail(export, i), e, delivered_chunks=j,
                    chunk_count=total or n_chunks) from e
            _count_forward_bytes(self._egress, len(data), kind)


class DiscoveringForwarder:
    """Forward via a Consul-discovered destination
    (consul_forward_service_name + consul_refresh_interval in config.go;
    Server.RefreshDestinations). Destinations are re-resolved lazily
    once per refresh interval; flushes rotate through the healthy set so
    a fleet of locals spreads load across the global tier. Each
    destination's forwarder carries its own breaker, so one dead global
    is skipped cheaply while its peers keep receiving."""

    def __init__(self, discoverer, service: str,
                 refresh_interval_s: float = 30.0, use_grpc: bool = True,
                 forwarder_factory=None, timeout_s: float = 10.0,
                 max_per_body: int = 25_000,
                 egress_policy: EgressPolicy | None = None,
                 engine_stamp: str | None = None,
                 centroid_codec: str = "lossless"):
        self.discoverer = discoverer
        self.service = service
        self.refresh_interval_s = refresh_interval_s
        if forwarder_factory is None:
            if use_grpc:
                forwarder_factory = lambda dest: GrpcForwarder(  # noqa: E731
                    dest, timeout_s=timeout_s,
                    egress_policy=egress_policy,
                    engine_stamp=engine_stamp,
                    centroid_codec=centroid_codec)
            else:
                # same body-size knob the direct-address path honors
                forwarder_factory = lambda dest: HttpJsonForwarder(  # noqa: E731
                    dest, timeout_s=timeout_s,
                    max_per_body=max_per_body,
                    egress_policy=egress_policy,
                    engine_stamp=engine_stamp,
                    centroid_codec=centroid_codec)
        self.factory = forwarder_factory
        self._dests: list[str] = []
        self._fwds: dict = {}
        self._next_refresh = 0.0
        self._rr = 0
        self.errors = 0

    @property
    def delta_capable(self) -> bool:
        """Delta forwarding needs ONE stable destination: with several
        discovered globals the seq-deterministic rotation means no
        single receiver observes a contiguous seq chain, so every
        delta would read as a gap. The ResilientForwarder consults
        this before building a delta; a multi-destination fleet keeps
        full sends (documented in README "Wire compression")."""
        return len(self._dests) <= 1

    def _refresh(self):
        import time as _t
        if _t.monotonic() < self._next_refresh and self._dests:
            return
        try:
            dests = self.discoverer.get_destinations_for_service(
                self.service)
        except Exception as e:
            self.errors += 1
            log.warning("discovery refresh failed for %s: %s",
                        self.service, e)
            return
        self._next_refresh = _t.monotonic() + self.refresh_interval_s
        if dests and sorted(dests) != sorted(self._dests):
            log.info("forward destinations for %s: %s", self.service,
                     dests)
            self._dests = dests
            for d in [d for d in self._fwds if d not in dests]:
                fw = self._fwds.pop(d)
                close = getattr(fw, "close", None)
                if close is not None:
                    try:   # a departed gRPC dest must not leak a channel
                        close()
                    except Exception:
                        pass

    def __call__(self, export, envelope: ForwardEnvelope | None = None):
        self._refresh()
        if not self._dests:
            self.errors += 1
            log.warning("no forward destinations for %s", self.service)
            # raise instead of silently dropping the interval: the
            # ResilientForwarder wrapping this spills the export and
            # re-merges it once discovery recovers
            from ..resilience import TransientEgressError
            raise TransientEgressError(
                f"no forward destinations for {self.service}")
        if envelope is not None:
            # seq-deterministic routing: consecutive intervals still
            # rotate through the healthy set, but a REPLAY of seq N
            # lands on the same destination as its first send (as long
            # as the destination set is stable), so the receiver's
            # dedupe ledger can actually see the duplicate. Plain
            # round-robin would replay onto a peer that never saw the
            # original. Trade-off: a dead destination that discovery
            # has not pruned yet pins its seqs' replays (its breaker
            # makes each retry one fast rejection, but the in-order
            # rule parks current intervals behind the stuck replay);
            # bounded, because after spill_max_intervals flushes the
            # stuck entry demotes to the re-enveloped overflow tier —
            # whose fresh seq maps to a (rotating) healthy peer — and
            # forwarding resumes. Consul health-checks prune the dead
            # peer within a refresh interval anyway.
            dest = self._dests[envelope.interval_seq % len(self._dests)]
        else:
            dest = self._dests[self._rr % len(self._dests)]
            self._rr += 1
        fwd = self._fwds.get(dest)
        if fwd is None:
            fwd = self._fwds[dest] = self.factory(dest)
        if envelope is not None and accepts_envelope(fwd):
            fwd(export, envelope=envelope)
        else:
            fwd(export)
