"""gRPC span sink: stream SSF spans to an arbitrary gRPC span service.

Parity: sinks/grpsink/ (sym: GRPCStreamingSpanSink — the "Falconer"
egress: a long-lived gRPC connection over which every ingested span is
sent as an SSFSpan protobuf). The service contract here is a unary
`/ssfspans.SpanSink/SendSpan(SSFSpan) -> SSFSpan-empty`; the reference
uses a client-streaming RPC, but the wire payload (one SSFSpan message
per span) is the same. `serve_capture()` provides the loopback
test-double the reference's sink tests build with a fake gRPC server.

The port's copy of veneur_tpu/sinks/grpsink.py: the same payloads, over the
port's resilience layer. grpc and the SSF protobuf load inside start()
and serve_capture(), so importing the module pulls in neither.
"""

from __future__ import annotations

import logging

from . import SpanSink
from ..resilience import Egress, grpc_channel

log = logging.getLogger("veneur_tpu_torch.sinks.grpsink")

SEND_SPAN = "/ssfspans.SpanSink/SendSpan"


class GrpcSpanSink(SpanSink):
    """Sends happen on a private sender thread behind a bounded queue so
    a slow/hung endpoint stalls only this sink, never the span worker
    (the sink-independence contract of sinks/__init__.py). Each send
    rides the resilience layer: retried on transient gRPC codes, and a
    dead endpoint trips the breaker so the sender drains the queue with
    fast rejections instead of a timeout per span."""

    def __init__(self, address: str, timeout_s: float = 5.0,
                 capacity: int = 8192, egress: Egress | None = None,
                 egress_policy=None):
        import queue
        import threading

        self.address = address
        self.timeout_s = timeout_s
        self._egress = egress or Egress(f"grpc://{address}",
                                        policy=egress_policy)
        self._channel = None
        self._send = None
        self.sent_total = 0
        self.dropped_total = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._queue_mod = queue
        self._stopping = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="grpsink-sender", daemon=True)

    def name(self) -> str:
        return "grpsink"

    def start(self) -> None:
        from ..ssf.protos import ssf_pb2
        # vlint: disable=TH01 reason=set once before any span: the
        # server starts its span sinks before the span worker thread,
        # and ingest's lazy start serves a sink driven from one thread
        self._channel = grpc_channel(self.address)
        # vlint: disable=TH01 reason=same one-time start as the line above
        self._send = self._channel.unary_unary(
            SEND_SPAN,
            request_serializer=ssf_pb2.SSFSpan.SerializeToString,
            response_deserializer=ssf_pb2.SSFSpan.FromString)
        if not self._thread.is_alive():
            self._thread.start()

    def ingest(self, span) -> None:
        if self._send is None:
            self.start()
        try:
            self._q.put_nowait(span)
        except self._queue_mod.Full:
            self.dropped_total += 1

    def _run(self):
        while True:
            try:
                span = self._q.get(timeout=0.25)
            except self._queue_mod.Empty:
                if self._stopping.is_set():
                    return
                continue
            if span is None:
                return
            try:
                self._egress.call(self._send, span,
                                  timeout_s=self.timeout_s)
                self.sent_total += 1
            except Exception as e:
                # never let the sender thread die — a dead thread would
                # silently disable the sink for the process lifetime
                self.dropped_total += 1
                log.debug("grpsink send failed: %s", e)

    def stop(self) -> None:
        self._stopping.set()
        try:
            self._q.put_nowait(None)
        except self._queue_mod.Full:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
        if self._channel is not None:
            self._channel.close()


def serve_capture(address: str = "127.0.0.1:0"):
    """Loopback span-sink service for tests: returns (server, port,
    captured_list)."""
    from concurrent import futures

    import grpc

    from ..ssf.protos import ssf_pb2
    captured: list = []

    class Handler(grpc.GenericRpcHandler):
        def service(self, details):
            if details.method != SEND_SPAN:
                return None

            def send_span(request, context):
                captured.append(request)
                return ssf_pb2.SSFSpan()

            return grpc.unary_unary_rpc_method_handler(
                send_span,
                request_deserializer=ssf_pb2.SSFSpan.FromString,
                response_serializer=ssf_pb2.SSFSpan.SerializeToString)

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((Handler(),))
    port = server.add_insecure_port(address)
    server.start()
    return server, port, captured
