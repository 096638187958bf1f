"""Service discovery for the global tier — the port's copy of
veneur_tpu/cluster/discovery.py.

Parity: discovery.go (sym: Discoverer interface —
GetDestinationsForService), consul.go (sym: Consul health-endpoint
implementation), plus the static-list fallback veneur supports via
config. The proxy refreshes its ring from a Discoverer on a ticker
(proxy.go sym: Proxy.RefreshDestinations).
"""

from __future__ import annotations

import json
import logging
from typing import Protocol

log = logging.getLogger("veneur_tpu_torch.cluster.discovery")


class Discoverer(Protocol):
    def get_destinations_for_service(self, service: str) -> list[str]: ...


class StaticDiscoverer:
    def __init__(self, destinations: list[str]):
        self.destinations = list(destinations)

    def get_destinations_for_service(self, service: str) -> list[str]:
        return list(self.destinations)


class ConsulDiscoverer:
    """Query Consul's health API for passing instances
    (GET /v1/health/service/<name>?passing). Queries ride the
    resilience layer (Consul agent restarts are routine) with a short
    retry ladder — callers already tolerate a failed refresh by keeping
    the previous destination set."""

    def __init__(self, consul_url: str = "http://127.0.0.1:8500",
                 timeout_s: float = 5.0, egress=None):
        from ..resilience import (BreakerPolicy, Egress, EgressPolicy,
                                  RetryPolicy)
        self.base = consul_url.rstrip("/")
        self.timeout_s = timeout_s
        self._egress = egress or Egress(
            self.base, policy=EgressPolicy(
                retry=RetryPolicy(max_attempts=2, base_backoff_s=0.1,
                                  max_backoff_s=1.0, deadline_s=5.0),
                breaker=BreakerPolicy()))

    def get_destinations_for_service(self, service: str) -> list[str]:
        url = f"{self.base}/v1/health/service/{service}?passing"
        entries = json.loads(
            self._egress.fetch(url, timeout_s=self.timeout_s))
        out = []
        for e in entries:
            svc = e.get("Service", {})
            addr = svc.get("Address") or e.get("Node", {}).get("Address")
            port = svc.get("Port")
            if addr and port:
                out.append(f"{addr}:{port}")
        return out
