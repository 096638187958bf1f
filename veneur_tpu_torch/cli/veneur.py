"""The main daemon CLI — `python -m veneur_tpu_torch.cli.veneur -f config.yaml`
(the flags of veneur_tpu/cli/veneur.py).

Parity: cmd/veneur/main.go (sym: main): read config, build server, run
until signalled. The server runs on the card, or on the CPU with
`aggregation_backend: cpu`. SIGINT and SIGTERM stop it; it then exits 0.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def main(argv=None):
    ap = argparse.ArgumentParser(prog="veneur-tpu-torch")
    ap.add_argument("-f", dest="config", required=True,
                    help="path to YAML config")
    ap.add_argument("--validate-config", action="store_true",
                    help="parse config and exit")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="enable debug logging")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from ..config import read_config
    cfg = read_config(args.config)
    if args.validate_config:
        print("config ok")
        return 0

    from ..server import Server
    srv = Server(cfg)
    srv.start()
    logging.getLogger("veneur").info(
        "veneur-tpu-torch serving on %s: statsd=%s interval=%ss workers=%d",
        srv.device, cfg.statsd_listen_addresses, cfg.interval_seconds,
        cfg.num_workers)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            # not the main thread (embedded/test use): rely on the
            # caller to stop us instead of signals
            break
    stop.wait()
    srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
