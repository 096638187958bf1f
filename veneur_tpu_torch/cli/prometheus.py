"""veneur-prometheus: poll a Prometheus /metrics endpoint and relay the
families to a veneur as DogStatsD.

Parity: cmd/veneur-prometheus/main.go (sym: main): on an interval, GET
the exposition text, translate each family — counters as deltas since
the previous poll (first poll primes the cache), gauges as absolute
values, histogram/summary components as their counter/gauge parts — and
emit statsd lines with the Prometheus labels as tags.

The relay's own telemetry (polls, poll errors, series relayed, send
errors) flows through the unified registry (observe/registry.py) like
every other veneur.* self-metric, and `--self-metrics-address` serves
it as one Prometheus scrape surface — previously the only view was
partial (log lines), invisible to scrapers.

The port's copy of veneur_tpu/cli/prometheus.py; run it as
`python3 -m veneur_tpu_torch.cli.prometheus`.
"""

from __future__ import annotations

import argparse
import logging
import re
import socket
import sys
import time
import urllib.request

log = logging.getLogger("veneur-prometheus")

# the label body must be matched as a sequence of quoted values, not
# [^}]* — an unescaped '}' is legal inside a quoted label value
_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(?:\{(?P<labels>(?:\s*[a-zA-Z_][a-zA-Z0-9_]*\s*=\s*'
    r'"(?:[^"\\]|\\.)*"\s*,?)*)\})?\s+'
    r"(?P<value>[^\s]+)(?:\s+\d+)?$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str):
    """Prometheus text format → [(name, labels dict, value, type)].
    TYPE comments drive counter/gauge classification; untyped series
    default to gauge."""
    types: dict[str, str] = {}
    out = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _LINE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        name = m.group("name")
        labels = dict(_LABEL.findall(m.group("labels") or ""))
        base = name
        for suffix in ("_bucket", "_sum", "_count", "_total"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                base = name[:-len(suffix)]
                break
        ftype = types.get(base, types.get(name, "gauge"))
        out.append((name, labels, value, ftype))
    return out


def to_statsd_lines(samples, prev: dict, prefix: str = "",
                    ignored_labels=()):
    """Translate one poll; `prev` carries last cumulative values for
    delta-ing counters (mutated in place)."""
    lines = []
    for name, labels, value, ftype in samples:
        labels = {k: v for k, v in labels.items()
                  if k not in ignored_labels}
        tagstr = ",".join(f"{k}:{v}" for k, v in sorted(labels.items()))
        key = (name, tagstr)
        mname = prefix + name
        if ftype in ("counter", "histogram", "summary") and (
                name.endswith(("_total", "_count", "_bucket", "_sum"))
                or ftype == "counter"):
            last = prev.get(key)
            prev[key] = value
            if last is None or value < last:   # first poll / reset
                continue
            delta = value - last
            if delta == 0:
                continue
            line = f"{mname}:{delta}|c"
        else:
            line = f"{mname}:{value}|g"
        if tagstr:
            line += f"|#{tagstr}"
        lines.append(line.encode())
    return lines


def poll_once(url: str, prev: dict, prefix: str = "",
              timeout_s: float = 10.0):
    # vlint: disable=RS01 reason=scrape ingest in a one-shot CLI, not
    # server egress: the poll loop already tolerates a failed scrape
    # (skips the interval) and retrying inside would skew counter deltas
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        text = resp.read().decode("utf-8", "replace")
    return to_statsd_lines(parse_exposition(text), prev, prefix)


def start_self_metrics_server(address: str, registry):
    """Expose the relay's own unified-registry telemetry as a
    Prometheus scrape surface: the exposition server IS the sink's
    (one implementation of address parsing / routing / content type),
    just with no flush body — only the live registry snapshot.
    Returns the started sink (.port is the bound port, .stop() tears
    it down)."""
    from ..sinks.prometheus import PrometheusMetricSink

    sink = PrometheusMetricSink(listen_address=address,
                                registries=(registry,))
    sink.start()
    return sink


def main(argv=None) -> int:
    from ..observe import SERVER_SCOPE, TelemetryRegistry

    ap = argparse.ArgumentParser(prog="veneur-prometheus")
    ap.add_argument("-p", "--prometheus-host",
                    default="http://localhost:9090/metrics",
                    help="metrics endpoint to poll")
    ap.add_argument("-s", "--statsd-host", default="127.0.0.1:8126",
                    help="veneur statsd address")
    ap.add_argument("-i", "--interval", type=float, default=10.0)
    ap.add_argument("--prefix", default="", help="metric name prefix")
    ap.add_argument("--once", action="store_true",
                    help="poll twice back-to-back and exit (testing)")
    ap.add_argument("--self-metrics-address", default="",
                    help="serve the relay's own veneur.prometheus.* "
                         "telemetry (unified registry) for scraping, "
                         "e.g. 127.0.0.1:9126")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    host, _, port = args.statsd_host.rpartition(":")
    host = host.strip("[]")
    if not port.isdigit():
        print(f"-s must be host:port, got {args.statsd_host!r}",
              file=sys.stderr)
        return 1
    dest = (host or "127.0.0.1", int(port))
    family = socket.AF_INET6 if ":" in dest[0] else socket.AF_INET
    sock = socket.socket(family, socket.SOCK_DGRAM)

    registry = TelemetryRegistry()
    if args.self_metrics_address:
        start_self_metrics_server(args.self_metrics_address, registry)

    prev: dict = {}
    n_polls = 0
    while True:
        try:
            lines = poll_once(args.prometheus_host, prev, args.prefix)
            sent = 0
            for ln in lines:
                try:
                    sock.sendto(ln, dest)
                    sent += 1
                except OSError:
                    registry.incr(SERVER_SCOPE, "prometheus.send_errors")
            registry.incr(SERVER_SCOPE, "prometheus.polls")
            registry.incr(SERVER_SCOPE, "prometheus.series_relayed",
                          sent)
            log.info("relayed %d series", sent)
        except Exception as e:
            registry.incr(SERVER_SCOPE, "prometheus.poll_errors")
            log.error("poll failed: %s", e)
        n_polls += 1
        if args.once and n_polls >= 2:
            return 0
        time.sleep(args.interval if not args.once else 0.05)


if __name__ == "__main__":
    sys.exit(main())
