"""veneur-emit: compose one metric (or span) from the command line (the
port's copy of veneur_tpu/cli/emit.py) —
`python3 -m veneur_tpu_torch.cli.emit -hostport udp://127.0.0.1:8125
-name my.count -count 1`, with `-ssf` to send an SSF span instead.

Parity: cmd/veneur-emit/main.go (sym: main + its flag set): -hostport,
-count/-gauge/-timing/-set with -name, -tag, -ssf to ship SSF instead of
statsd, and -command to time a subprocess and emit its duration (plus
exit status), exiting with the child's code.
"""

from __future__ import annotations

import argparse
import shlex
import socket
import subprocess
import sys
import time
from urllib.parse import urlparse


def build_statsd_lines(args) -> list[bytes]:
    tags = f"|#{args.tag}" if args.tag else ""
    lines = []
    if args.count is not None:
        lines.append(f"{args.name}:{args.count}|c{tags}")
    if args.gauge is not None:
        lines.append(f"{args.name}:{args.gauge}|g{tags}")
    if args.timing is not None:
        lines.append(f"{args.name}:{args.timing}|ms{tags}")
    if args.set is not None:
        lines.append(f"{args.name}:{args.set}|s{tags}")
    return [ln.encode() for ln in lines]


def build_ssf_span(args):
    from .. import ssf
    from ..ssf.protos import ssf_pb2

    tags = dict(t.split(":", 1) if ":" in t else (t, "")
                for t in (args.tag.split(",") if args.tag else []))
    span = ssf_pb2.SSFSpan(version=0, service=args.service or "veneur-emit")
    if args.count is not None:
        span.metrics.append(ssf.count(args.name, float(args.count), tags))
    if args.gauge is not None:
        span.metrics.append(ssf.gauge(args.name, float(args.gauge), tags))
    if args.timing is not None:
        span.metrics.append(ssf.timing(args.name, float(args.timing) / 1e3,
                                       ssf.MILLISECOND, tags))
    if args.set is not None:
        span.metrics.append(ssf.set_sample(args.name, str(args.set), tags))
    return span


def send_payload(hostport: str, payload: bytes):
    u = urlparse(hostport if "://" in hostport else f"udp://{hostport}")
    if u.scheme in ("udp", ""):
        host = u.hostname or "127.0.0.1"
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        sock = socket.socket(family, socket.SOCK_DGRAM)
        sock.sendto(payload, (host, u.port or 8125))
        sock.close()
    elif u.scheme == "unix":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        sock.sendto(payload, u.path)
        sock.close()
    elif u.scheme == "tcp":
        with socket.create_connection(
                (u.hostname or "127.0.0.1", u.port or 8125),
                timeout=5) as sock:
            sock.sendall(payload)
    else:
        raise ValueError(f"unsupported scheme {u.scheme!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="veneur-emit")
    ap.add_argument("-hostport", default="udp://127.0.0.1:8125",
                    help="destination, e.g. udp://127.0.0.1:8125")
    ap.add_argument("-name", help="metric name")
    ap.add_argument("-count", type=float, default=None)
    ap.add_argument("-gauge", type=float, default=None)
    ap.add_argument("-timing", type=float, default=None,
                    help="timer value (ms)")
    ap.add_argument("-set", default=None, help="set member")
    ap.add_argument("-tag", default="", help="comma-separated k:v tags")
    ap.add_argument("-ssf", action="store_true",
                    help="send as an SSF span instead of statsd")
    ap.add_argument("-service", default="", help="SSF service name")
    ap.add_argument("-command", default="",
                    help="run this command, time it, emit the duration")
    args = ap.parse_args(argv)

    rc = 0
    if args.command:
        if not args.name:
            args.name = "veneur_emit.command"
        t0 = time.perf_counter()
        rc = subprocess.call(shlex.split(args.command))
        args.timing = (time.perf_counter() - t0) * 1000.0
        args.tag = (args.tag + "," if args.tag else "") + f"exit_status:{rc}"
    elif not args.name:
        ap.error("-name is required unless -command is given")

    if args.ssf:
        span = build_ssf_span(args)
        send_payload(args.hostport, span.SerializeToString())
    else:
        for line in build_statsd_lines(args):
            send_payload(args.hostport, line)
    return rc


if __name__ == "__main__":
    sys.exit(main())
