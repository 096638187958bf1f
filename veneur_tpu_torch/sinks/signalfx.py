"""SignalFx metric sink.

Parity: sinks/signalfx/signalfx.go (sym: SignalFxSink.Flush — datapoints
POSTed to /v2/datapoint; per-key API-token routing via `vary_key_by` tag).
JSON body instead of the sfx protobuf (the ingest API accepts both); same
datapoint model: gauge/counter with dimensions.

The port's copy of veneur_tpu/sinks/signalfx.py: the same payloads, over the
port's resilience layer.
"""

from __future__ import annotations

import json
import logging
import urllib.request

from ..metrics import MetricType
from ..resilience import Egress, EgressPolicy
from . import MetricSink

log = logging.getLogger("veneur_tpu_torch.sinks.signalfx")


class SignalFxMetricSink(MetricSink):
    def __init__(self, api_key: str,
                 endpoint: str = "https://ingest.signalfx.com",
                 hostname: str = "", tags: list[str] | None = None,
                 vary_key_by: str = "", per_tag_keys: dict | None = None,
                 timeout_s: float = 10.0, egress: Egress | None = None,
                 egress_policy: EgressPolicy | None = None):
        self.api_key = api_key
        self.endpoint = endpoint.rstrip("/")
        self.hostname = hostname
        self.tags = tags or []
        self.vary_key_by = vary_key_by
        self.per_tag_keys = per_tag_keys or {}
        self.timeout_s = timeout_s
        self._egress = egress or Egress("signalfx",
                                        policy=egress_policy)

    def name(self) -> str:
        return "signalfx"

    def _dims(self, m):
        dims = {"host": m.hostname or self.hostname}
        for t in self.tags + m.tags:
            k, _, v = t.partition(":")
            dims[k] = v
        return dims

    def _token_for(self, m) -> str:
        if self.vary_key_by:
            prefix = self.vary_key_by + ":"
            for t in m.tags:
                if t.startswith(prefix):
                    return self.per_tag_keys.get(t[len(prefix):],
                                                 self.api_key)
        return self.api_key

    def flush(self, metrics):
        by_token: dict[str, dict] = {}
        for m in metrics:
            if m.type == MetricType.STATUS:
                continue  # service checks are Datadog-shaped; skip
            dp = {"metric": m.name, "timestamp": m.timestamp * 1000,
                  "value": m.value, "dimensions": self._dims(m)}
            kind = ("counter" if m.type == MetricType.COUNTER else "gauge")
            by_token.setdefault(self._token_for(m), {}).setdefault(
                kind, []).append(dp)
        deadline = self._egress.deadline()   # one budget, all tokens
        for token, body in by_token.items():
            req = urllib.request.Request(
                f"{self.endpoint}/v2/datapoint",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json",
                         "X-SF-Token": token},
                method="POST")
            self._egress.post(req, timeout_s=self.timeout_s,
                              deadline=deadline)
