"""Prometheus sink: expose each interval's flush for scraping.

Parity: sinks/prometheus/ (the egress direction of veneur's Prometheus
integration; the ingest direction is the veneur-prometheus CLI). The
reference repeats statsd to a prometheus exporter; here the sink IS the
exporter: it holds the latest flush and serves it in the text
exposition format (0.0.4) on an embedded HTTP listener, with metric
names sanitized to the Prometheus grammar and tags become labels.

Counters are exposed as `counter` with a cumulative value accumulated
across flushes (Prometheus semantics: counters are cumulative, while
veneur counters are per-interval deltas); everything else is a `gauge`.

The port's copy of veneur_tpu/sinks/prometheus.py: the same payloads, over the
port's resilience layer.
"""

from __future__ import annotations

import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..metrics import InterMetric, MetricType
from . import MetricSink

log = logging.getLogger("veneur_tpu_torch.sinks.prometheus")

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def sanitize_label(name: str) -> str:
    name = _LABEL_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def render(metrics: list[InterMetric],
           counter_totals: dict | None = None) -> str:
    """Text exposition (0.0.4) for one flush's metrics."""
    by_name: dict[str, list[InterMetric]] = {}
    for m in metrics:
        by_name.setdefault(sanitize_name(m.name), []).append(m)
    lines: list[str] = []
    for name in sorted(by_name):
        group = by_name[name]
        is_counter = group[0].type == MetricType.COUNTER
        lines.append(f"# TYPE {name} "
                     f"{'counter' if is_counter else 'gauge'}")
        for m in group:
            labels = []
            for t in m.tags:
                k, _, v = t.partition(":")
                labels.append(f'{sanitize_label(k)}="{_escape_value(v)}"')
            if m.hostname:
                labels.append(f'hostname="{_escape_value(m.hostname)}"')
            lstr = "{" + ",".join(labels) + "}" if labels else ""
            value = m.value
            if is_counter and counter_totals is not None:
                key = (name, lstr)
                value = counter_totals.get(key, 0.0) + m.value
                counter_totals[key] = value
            lines.append(f"{name}{lstr} {value:g}")
    return "\n".join(lines) + ("\n" if lines else "")


class _TtlCounterTotals(dict):
    """Cumulative counter state with idle eviction: a series not flushed
    for `idle_flushes` intervals is dropped, so unbounded metric-name
    churn cannot grow the dict forever. `render` touches every live key
    via `__setitem__`, which doubles as the liveness signal; an evicted
    series that reappears restarts from its next delta (a counter reset,
    which Prometheus clients already handle via staleness/rate())."""

    def __init__(self, idle_flushes: int = 60):
        super().__init__()
        self.idle_flushes = idle_flushes
        self._last_seen: dict = {}
        self._flush_idx = 0

    def __setitem__(self, key, value):
        self._last_seen[key] = self._flush_idx
        super().__setitem__(key, value)

    def advance(self):
        self._flush_idx += 1
        horizon = self._flush_idx - self.idle_flushes
        if horizon <= 0:
            return
        dead = [k for k, t in self._last_seen.items() if t < horizon]
        for k in dead:
            del self._last_seen[k]
            self.pop(k, None)


def render_registries(registries, exclude_names=frozenset()) -> str:
    """One scrape's view of the unified telemetry registries
    (observe/registry.py): cumulative counters (native Prometheus
    counter semantics — no delta reconstruction needed), live gauges,
    and levels. Families already present in `exclude_names` (sanitized)
    are skipped so a flush body that carries the same self-metrics
    can't produce duplicate TYPE families in one exposition."""
    import time as _time

    ts = int(_time.time())
    metrics = []
    for reg in registries:
        metrics.extend(m for m in reg.snapshot(ts)
                       if sanitize_name(m.name) not in exclude_names)
    # registry values are already cumulative: render without the
    # flush-path counter_totals accumulator
    return render(metrics, None)


class PrometheusMetricSink(MetricSink):
    """The exposition server. With `registries` (the server wires its
    telemetry spine + the process default), /metrics is ONE scrape
    surface for every veneur.* self-metric — including the counters
    that would otherwise only be visible inside a flush body (or not at
    all when stats_address diverts self-metrics onto the wire)."""

    def __init__(self, listen_address: str = "127.0.0.1:9125",
                 counter_idle_flushes: int = 60, registries=()):
        # parsed in start() so a malformed address disables this sink
        # (the server catches start() errors per-sink) instead of
        # aborting server construction
        self.listen_address = listen_address
        self.host = ""
        self.port = -1
        self._body = b""
        self._body_names: frozenset = frozenset()
        self._lock = threading.Lock()
        self._counter_totals = _TtlCounterTotals(counter_idle_flushes)
        self._registries = tuple(registries)
        self._server: ThreadingHTTPServer | None = None

    def name(self) -> str:
        return "prometheus"

    def start(self):
        host, _, port = self.listen_address.rpartition(":")
        self.host = host.strip("[]") or "0.0.0.0"
        self.port = int(port)
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                with sink._lock:
                    body = sink._body
                    names = sink._body_names
                if sink._registries:
                    # registry state renders at scrape time (fresh),
                    # minus families the flush body already carries
                    body = body + render_registries(
                        sink._registries, names).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         name="prometheus-sink", daemon=True).start()

    def flush(self, metrics):
        metrics = [m for m in metrics
                   if m.type != MetricType.STATUS]  # datadog-shaped
        with self._lock:
            self._body = render(metrics, self._counter_totals).encode()
            self._body_names = frozenset(
                sanitize_name(m.name) for m in metrics)
            self._counter_totals.advance()

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
