"""Kafka sinks: flushed metrics and/or SSF spans → Kafka topics.

Parity: sinks/kafka/kafka.go (sym: KafkaMetricSink — JSON-encoded
InterMetrics to `kafka_metric_topic`, partition-keyed so one series
always lands on one partition; KafkaSpanSink — spans to
`kafka_span_topic` as protobuf or JSON, keyed by trace id).

No Kafka client library ships in this image, so the producer is
injectable: anything callable as `produce(topic, key: bytes,
value: bytes)`. `start()` tries to build one from `kafka-python` if
installed; without a client the sink stays up but drops (counted),
mirroring veneur's treat-egress-as-lossy stance rather than crashing
the pipeline.

The port's copy of veneur_tpu/sinks/kafka.py: the same payloads, over the
port's resilience layer.
"""

from __future__ import annotations

import json
import logging
import threading

from ..metrics import InterMetric, MetricType
from . import MetricSink, SpanSink

log = logging.getLogger("veneur_tpu_torch.sinks.kafka")


def metric_to_payload(m: InterMetric) -> dict:
    """The JSON shape the reference's sarama encoder produces per
    InterMetric."""
    return {
        "name": m.name,
        "timestamp": m.timestamp,
        "value": m.value,
        "tags": list(m.tags),
        "type": m.type.name.lower(),
        "hostname": m.hostname,
    }


def _produce_batch(egress, producer, msgs):
    """Whole-batch produce under the egress treatment (shared by both
    kafka sinks): the batch retries as a unit, so re-produced messages
    are at-least-once — the reference's sarama producer semantics."""
    def _all():
        for topic, key, value in msgs:
            producer(topic, key, value)

    egress.call(_all)


def _default_producer(broker: str):
    """Build a producer from kafka-python if present, else None."""
    try:
        from kafka import KafkaProducer  # type: ignore
    except ImportError:
        return None
    producer = KafkaProducer(bootstrap_servers=broker)

    def produce(topic: str, key: bytes, value: bytes):
        producer.send(topic, key=key, value=value)

    return produce


class KafkaMetricSink(MetricSink):
    def __init__(self, broker: str, metric_topic: str, producer=None,
                 egress=None, egress_policy=None):
        from ..resilience import Egress
        self.broker = broker
        self.metric_topic = metric_topic
        self.producer = producer
        self._egress = egress or Egress(f"kafka://{broker}",
                                        policy=egress_policy)
        self.dropped_total = 0
        self._lock = threading.Lock()

    def name(self) -> str:
        return "kafka"

    def start(self):
        if self.producer is None:
            self.producer = _default_producer(self.broker)
            if self.producer is None:
                log.warning("kafka: no client library available; "
                            "metrics to %s will be dropped (counted)",
                            self.metric_topic)

    def flush(self, metrics):
        if self.producer is None:
            with self._lock:
                self.dropped_total += len(metrics)
            return
        msgs = []
        for m in metrics:
            if m.type == MetricType.STATUS:
                continue  # service checks are Datadog-shaped; skip
            # key by series identity: one series → one partition, so
            # per-series ordering survives (the reference's partition key)
            key = f"{m.name}|{','.join(m.tags)}".encode()
            value = json.dumps(metric_to_payload(m)).encode()
            msgs.append((self.metric_topic, key, value))
        if not msgs:
            return
        try:
            _produce_batch(self._egress, self.producer, msgs)
        except Exception:
            with self._lock:
                self.dropped_total += len(msgs)
            raise


class KafkaSpanSink(SpanSink):
    def __init__(self, broker: str, span_topic: str, producer=None,
                 encoding: str = "protobuf", max_buffer: int = 16384,
                 egress=None, egress_policy=None):
        from ..resilience import Egress
        if encoding not in ("protobuf", "json"):
            raise ValueError(f"bad kafka span encoding {encoding!r}")
        self.broker = broker
        self.span_topic = span_topic
        self.producer = producer
        self.encoding = encoding
        self.max_buffer = max_buffer
        self._egress = egress or Egress(f"kafka://{broker}",
                                        policy=egress_policy)
        self._buf: list = []
        self._lock = threading.Lock()
        self.dropped_total = 0

    def name(self) -> str:
        return "kafka"

    def start(self):
        if self.producer is None:
            self.producer = _default_producer(self.broker)
            if self.producer is None:
                log.warning("kafka: no client library available; spans "
                            "to %s will be dropped (counted)",
                            self.span_topic)

    def ingest(self, span):
        with self._lock:
            if len(self._buf) >= self.max_buffer:
                self.dropped_total += 1
                return
            self._buf.append(span)

    def _encode(self, span) -> bytes:
        if self.encoding == "protobuf":
            return span.SerializeToString()
        return json.dumps({
            "trace_id": span.trace_id, "id": span.id,
            "parent_id": span.parent_id, "name": span.name,
            "service": span.service, "error": bool(span.error),
            "start_timestamp": span.start_timestamp,
            "end_timestamp": span.end_timestamp,
            "tags": dict(span.tags),
        }).encode()

    def flush(self):
        with self._lock:
            spans, self._buf = self._buf, []
        if self.producer is None:
            with self._lock:
                self.dropped_total += len(spans)
            return
        if not spans:
            return
        msgs = [(self.span_topic, str(s.trace_id).encode(),
                 self._encode(s)) for s in spans]
        try:
            _produce_batch(self._egress, self.producer, msgs)
        except Exception as e:
            with self._lock:
                self.dropped_total += len(msgs)
            log.warning("kafka span flush failed (%d dropped): %s",
                        len(msgs), e)
