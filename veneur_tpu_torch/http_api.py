"""Debug/ops HTTP server: healthchecks, version and the flush
introspection surface — the ops routes of veneur_tpu/http_api.py.

Parity: handlers.go (sym: Server.Serve / HTTPServe — /healthcheck,
/healthcheck/tcp, /version, /builddate). GET /debug/threads dumps every
thread's stack, GET /debug/flush serves the flight recorder's ring and
GET /debug/fleet the fleet view, GET /healthz and /ready structured
verdicts. GET /debug/flush/profile?ticks=N schedules an on-demand
torch.profiler capture of the next N flush ticks when the server was
configured with debug_flush_profile. POST /import (handlers_global.go)
needs the import server and answers 501 until it is ported (ROADMAP
queue A, item 10.2); /query answers as the reference does on a
server without the time-travel tier.

`ProfileServer` is enable_profiling's listener on profile_port: GET
/profile?seconds=S answers a Chrome trace of the next S seconds.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import __version__

BUILD_DATE = "dev"

IMPORT_NOT_PORTED = (b"POST /import is not ported to veneur_tpu_torch yet "
                     b"(ROADMAP queue A, item 10.2, forward, import and "
                     b"proxy)\n")


class HttpApi:
    """The ops HTTP listener. `debug_state()` serves GET /debug/flush,
    `fleet_state()` GET /debug/fleet and `health()` GET /healthz and
    /ready: a dict with `healthy`/`ready` booleans and a per-check
    breakdown; a failing verdict answers 503, so a wedged flusher is
    detectable from outside the process. `profile(ticks)` (optional)
    schedules a profiler capture; absent, /debug/flush/profile answers
    403."""

    def __init__(self, address: str, debug_state, fleet_state, health,
                 profile=None):
        host, _, port = address.rpartition(":")
        host = host.strip("[]") or "0.0.0.0"
        self._debug_state = debug_state
        self._fleet_state = fleet_state
        self._health = health
        self._profile = profile
        api = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet; logrus-style app logs
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str = "text/plain"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, fn):
                self._reply(200, json.dumps(fn(), default=str).encode(),
                            "application/json")

            def do_GET(self):
                path = urlparse(self.path).path.rstrip("/")
                if self.path in ("/healthcheck", "/healthcheck/tcp"):
                    self._reply(200, b"ok\n")
                elif self.path in ("/healthz", "/ready"):
                    body = api._health()
                    ok = body["ready" if self.path == "/ready"
                              else "healthy"]
                    self._reply(200 if ok else 503,
                                json.dumps(body, default=str).encode(),
                                "application/json")
                elif self.path.rstrip("/") == "/debug/fleet":
                    self._json(api._fleet_state)
                elif self.path == "/version":
                    self._reply(200, __version__.encode() + b"\n")
                elif self.path == "/builddate":
                    self._reply(200, BUILD_DATE.encode() + b"\n")
                elif self.path == "/debug/threads":
                    frames = sys._current_frames()
                    out = []
                    for t in threading.enumerate():
                        out.append(f"--- {t.name} ({t.ident}) ---")
                        f = frames.get(t.ident)
                        if f is not None:
                            out.extend(traceback.format_stack(f))
                    self._reply(200, "\n".join(out).encode())
                elif path == "/debug/flush/profile":
                    self._profile_capture()
                elif path == "/debug/flush" and \
                        self.path.startswith(path):
                    self._json(api._debug_state)
                elif path == "/query":
                    self._reply(404, b"no time-travel query tier on "
                                     b"this server (set "
                                     b"history_retention_generations "
                                     b"with durability enabled)\n")
                else:
                    self._reply(404, b"not found\n")

            def _profile_capture(self):
                if api._profile is None:
                    self._reply(403, b"profiler capture disabled "
                                     b"(set debug_flush_profile)\n")
                    return
                try:
                    ticks = int(parse_qs(urlparse(self.path).query).get(
                        "ticks", ["1"])[0])
                except ValueError:
                    self._reply(400, b"ticks must be an integer\n")
                    return
                self._reply(200, json.dumps(api._profile(ticks)).encode(),
                            "application/json")

            def do_POST(self):
                if self.path != "/import":
                    self._reply(404, b"not found\n")
                    return
                self._reply(501, IMPORT_NOT_PORTED)

        self._httpd = ThreadingHTTPServer((host, int(port or 0)), Handler)
        self.port = self._httpd.server_port
        self.thread = threading.Thread(target=self._httpd.serve_forever,
                                       name="http-api", daemon=True)

    def start(self):
        self.thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


class ProfileServer:
    """enable_profiling's listener on `port` (0 = any free port): GET
    /profile?seconds=S records torch.profiler `activities` for S seconds
    (default 1, at most 60) and answers the Chrome trace as JSON. One
    capture at a time: torch runs one profiler per process, so a capture
    that cannot start answers 503 with the reason."""

    MAX_SECONDS = 60.0

    def __init__(self, port: int, activities):
        acts = list(activities)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, body, ctype="text/plain"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path.rstrip("/") != "/profile":
                    self._reply(404, b"not found\n")
                    return
                try:
                    secs = float(parse_qs(u.query).get("seconds",
                                                       ["1"])[0])
                except ValueError:
                    self._reply(400, b"seconds must be a number\n")
                    return
                secs = min(max(secs, 0.0), ProfileServer.MAX_SECONDS)
                from torch.profiler import profile
                try:
                    with profile(activities=acts) as prof:
                        time.sleep(secs)
                    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
                    os.close(fd)
                    try:
                        prof.export_chrome_trace(path)
                        with open(path, "rb") as f:
                            body = f.read()
                    finally:
                        os.unlink(path)
                except Exception as e:
                    self._reply(503, f"profiler capture failed: {e}\n"
                                .encode())
                    return
                self._reply(200, body, "application/json")

        self._httpd = ThreadingHTTPServer(("", int(port)), Handler)
        self.port = self._httpd.server_port
        self.thread = threading.Thread(target=self._httpd.serve_forever,
                                       name="profile-server", daemon=True)

    def start(self):
        self.thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
