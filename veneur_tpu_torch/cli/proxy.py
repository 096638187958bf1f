"""veneur-proxy: consistent-hash metrics across the global tier — the
port's copy of veneur_tpu/cli/proxy.py, run as
`python3 -m veneur_tpu_torch.cli.proxy -f <yaml>`.

Parity: cmd/veneur-proxy/main.go (sym: main) + proxy.go (sym:
NewProxyFromConfig). Reads a YAML config (the reference's proxy config
keys), builds a Discoverer (consul or static `forward_destinations`),
and serves the forwardrpc contract, re-routing each metric by its key
digest onto the owning global veneur. The proxy aggregates nothing, so
it runs on the host alone. SIGINT and SIGTERM stop it; it then exits 0.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys


def proxy_from_config(cfg: dict):
    """Build and start a ProxyServer from proxy YAML keys. Returns the
    running proxy, or raises ValueError on an unusable config."""
    from ..cluster.discovery import ConsulDiscoverer, StaticDiscoverer
    from ..cluster.proxy import ProxyServer
    from ..config import _parse_interval

    service = cfg.get("consul_forward_service_name", "")
    if service:
        disc = ConsulDiscoverer(
            cfg.get("consul_url", "http://127.0.0.1:8500"))
    else:
        static = cfg.get("forward_destinations", [])
        if not static:
            raise ValueError(
                "proxy config needs consul_forward_service_name or "
                "forward_destinations")
        disc = StaticDiscoverer(static)

    refresh = _parse_interval(cfg.get("consul_refresh_interval", "30s"))
    proxy = ProxyServer(disc, service_name=service,
                        refresh_interval_s=refresh)
    addr = cfg.get("grpc_address", "0.0.0.0:8128")
    _server, proxy.grpc_port = proxy.start(addr)
    # legacy HTTP face (proxy.go sym: Proxy.Handler): POST /import
    http_addr = cfg.get("http_address", "")
    if http_addr:
        from ..cluster.proxy import HttpProxyFront
        proxy.http_front = HttpProxyFront(proxy)
        proxy.http_front.start(http_addr)
    logging.getLogger("veneur-proxy").info(
        "proxying on %s -> %d destinations", addr, len(proxy.ring))
    return proxy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="veneur-proxy")
    ap.add_argument("-f", dest="config", required=True,
                    help="path to proxy YAML config")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    import yaml
    with open(args.config) as f:
        cfg = yaml.safe_load(f) or {}

    # blocked before grpc starts a thread, taken by sigwait (as
    # cli/veneur.py does): a Python handler never runs while the main
    # thread blocks and the signal lands on another thread
    stop_signals = {signal.SIGINT, signal.SIGTERM}
    signal.pthread_sigmask(signal.SIG_BLOCK, stop_signals)
    try:
        proxy = proxy_from_config(cfg)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    signal.sigwait(stop_signals)
    proxy.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
