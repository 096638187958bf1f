"""New Relic sink: flushed metrics → Metric API, events → Event API.

Parity: sinks/newrelic/ (sym: NewRelicMetricSink — converts InterMetrics
to New Relic's metric payloads via the telemetry SDK, and DogStatsD
events to custom events on the account event stream). The vendor SDK is
replaced with the two public JSON ingest surfaces it wraps:
  * POST {metric_url}/metric/v1 — [{"metrics": [{name, type, value,
    timestamp, attributes}]}] with an Api-Key header; counters carry
    interval.ms like the SDK's count type.
  * POST {event_url}/v1/accounts/{id}/events — custom "VeneurEvent"
    records.
Tests point both URLs at a loopback http.server.

The port's copy of veneur_tpu/sinks/newrelic.py: the same payloads, over the
port's resilience layer.
"""

from __future__ import annotations

import json
import logging
import urllib.request

from ..metrics import InterMetric, MetricType
from . import MetricSink

log = logging.getLogger("veneur_tpu_torch.sinks.newrelic")


def _attrs(m: InterMetric, common_tags: list[str]) -> dict:
    out = {}
    for t in list(common_tags) + list(m.tags):
        k, _, v = t.partition(":")
        out[k] = v
    if m.hostname:
        out["hostname"] = m.hostname
    return out


class NewRelicMetricSink(MetricSink):
    def __init__(self, insert_key: str, account_id: int = 0,
                 metric_url: str = "https://metric-api.newrelic.com",
                 event_url: str = "https://insights-collector.newrelic.com",
                 tags: list[str] | None = None, interval_s: float = 10.0,
                 timeout_s: float = 10.0, egress=None,
                 egress_policy=None):
        from ..resilience import Egress
        self.insert_key = insert_key
        self.account_id = account_id
        self.metric_url = metric_url.rstrip("/") + "/metric/v1"
        self.event_url = (event_url.rstrip("/")
                          + f"/v1/accounts/{account_id}/events")
        self.tags = tags or []
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self._egress = egress or Egress("newrelic",
                                        policy=egress_policy)
        self.flushed_total = 0

    def name(self) -> str:
        return "newrelic"

    def _metric(self, m: InterMetric) -> dict:
        rec = {
            "name": m.name,
            "value": m.value,
            "timestamp": m.timestamp,
            "attributes": _attrs(m, self.tags),
        }
        if m.type == MetricType.COUNTER:
            rec["type"] = "count"
            rec["interval.ms"] = max(1, int(self.interval_s * 1000))
        else:
            rec["type"] = "gauge"
        return rec

    def _post(self, url: str, payload) -> bool:
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/json",
                     "Api-Key": self.insert_key})
        try:
            self._egress.post(req, timeout_s=self.timeout_s)
            return True
        except Exception as e:
            log.error("newrelic post to %s failed: %s", url, e)
            return False

    def flush(self, metrics):
        metrics = [m for m in metrics
                   if m.type != MetricType.STATUS]  # datadog-shaped
        if not metrics:
            return
        payload = [{"metrics": [self._metric(m) for m in metrics]}]
        if self._post(self.metric_url, payload):
            self.flushed_total += len(metrics)

    def flush_other(self, events, checks):
        if not self.account_id:
            # the event API is per-account; without an id the POST can
            # only 4xx every interval
            if events or checks:
                log.warning("newrelic: dropping %d events/checks — "
                            "newrelic_account_id is not configured",
                            len(events) + len(checks))
            return
        records = [{
            "eventType": "VeneurEvent",
            "title": e.title, "text": e.text,
            "timestamp": e.timestamp or 0,
            "alertType": e.alert_type,
            "aggregationKey": e.aggregation_key,
        } for e in events]
        records += [{
            "eventType": "VeneurServiceCheck",
            "name": c.name, "status": c.status,
            "timestamp": c.timestamp or 0,
            "message": c.message,
        } for c in checks]
        if records:
            self._post(self.event_url, records)
