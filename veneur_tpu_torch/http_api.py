"""Debug/ops HTTP server: healthchecks, version and the flush
introspection surface — the ops routes of veneur_tpu/http_api.py.

Parity: handlers.go (sym: Server.Serve / HTTPServe — /healthcheck,
/healthcheck/tcp, /version, /builddate). GET /debug/threads dumps every
thread's stack, GET /debug/flush serves the flight recorder's ring and
GET /debug/fleet the fleet view, GET /healthz and /ready structured
verdicts. POST /import (handlers_global.go) needs the forward wire and
answers 501 until the global tier is ported (ROADMAP queue A, item 10);
/query and /debug/flush/profile answer as the reference does on a server
without the time-travel tier or the profiler trigger.
"""

from __future__ import annotations

import json
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

from . import __version__

BUILD_DATE = "dev"

IMPORT_NOT_PORTED = (b"POST /import is not ported to veneur_tpu_torch yet "
                     b"(ROADMAP queue A, item 10, global tier)\n")


class HttpApi:
    """The ops HTTP listener. `debug_state()` serves GET /debug/flush,
    `fleet_state()` GET /debug/fleet and `health()` GET /healthz and
    /ready: a dict with `healthy`/`ready` booleans and a per-check
    breakdown; a failing verdict answers 503, so a wedged flusher is
    detectable from outside the process."""

    def __init__(self, address: str, debug_state, fleet_state, health):
        host, _, port = address.rpartition(":")
        host = host.strip("[]") or "0.0.0.0"
        self._debug_state = debug_state
        self._fleet_state = fleet_state
        self._health = health
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
                    self._reply(403, b"profiler capture disabled "
                                     b"(set debug_flush_profile)\n")
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
