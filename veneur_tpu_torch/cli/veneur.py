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

    # SIGINT and SIGTERM are taken by sigwait below, never by a handler:
    # blocked here, before torch or the server starts a thread (threads
    # inherit the mask), they stay pending for sigwait whichever thread
    # the kernel hands them to. A Python handler runs only in the main
    # thread, which a signal delivered to another thread does not wake
    # from a blocking wait.
    stop_signals = {signal.SIGINT, signal.SIGTERM}
    signal.pthread_sigmask(signal.SIG_BLOCK, stop_signals)
    from ..server import Server
    srv = Server(cfg)
    srv.start()
    logging.getLogger("veneur").info(
        "veneur-tpu-torch serving on %s: statsd=%s interval=%ss workers=%d",
        srv.device, cfg.statsd_listen_addresses, cfg.interval_seconds,
        cfg.num_workers)
    signal.sigwait(stop_signals)
    srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
