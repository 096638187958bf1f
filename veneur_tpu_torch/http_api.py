"""Debug/ops HTTP server: healthchecks, version, the legacy JSON import
path and the flush introspection surface — the port's copy of
veneur_tpu/http_api.py.

Parity: handlers.go (sym: Server.Serve / HTTPServe — /healthcheck,
/healthcheck/tcp, /version, /builddate) and handlers_global.go (sym:
Server.handleImport — POST /import with a []JSONMetric body; digests
ride as JSON centroid arrays, as cluster.forward.HttpJsonForwarder
emits them). GET /debug/threads dumps every thread's stack, GET
/debug/flush serves the flight recorder's ring and GET /debug/fleet the
fleet view, GET /healthz and /ready structured verdicts. GET
/debug/flush/profile?ticks=N schedules an on-demand torch.profiler
capture of the next N flush ticks when the server was configured with
debug_flush_profile. GET /query?metric=&q=&t0=&t1= answers from the
time-travel tier of a durable global (durability/history.py), and 404s,
in the reference's words, on a server without it.

The module imports no protobuf: `json_metric_to_pb` and the import
handler load the wire inside the call.

`ProfileServer` is enable_profiling's listener on profile_port: GET
/profile?seconds=S answers a Chrome trace of the next S seconds.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import __version__
from .utils.hashing import metric_digest

log = logging.getLogger("veneur_tpu_torch.http")

BUILD_DATE = "dev"

_TYPE_NAMES = ("counter", "gauge", "histogram", "timer", "set")


def json_metric_to_pb(d: dict):
    """One JSONMetric dict → metricpb.Metric, so the HTTP import path
    reuses the gRPC path's merge machinery (handleImport →
    Worker.ImportMetric equivalence)."""
    from .cluster import wire
    from .cluster.protos import metric_pb2
    mtype = d.get("type", "")
    if mtype not in _TYPE_NAMES:
        raise ValueError(f"unknown metric type {mtype!r}")
    pb_type = {"counter": metric_pb2.Counter, "gauge": metric_pb2.Gauge,
               "histogram": metric_pb2.Histogram,
               "timer": metric_pb2.Timer, "set": metric_pb2.Set}[mtype]
    m = metric_pb2.Metric(name=d["name"], type=pb_type,
                          tags=list(d.get("tags", [])))
    if mtype in ("histogram", "timer"):
        h = d["histogram"]
        td = m.histogram.t_digest
        # both centroid carriers decode through wire.py: the lossless
        # [[mean, weight]] list or the q16 packed row
        means, weights = wire.histogram_centroids_from_json(h)
        for mean, w in zip(means, weights):
            if float(w) > 0:
                td.centroids.add(mean=float(mean), weight=float(w))
        td.min = float(h.get("min", 0.0))
        td.max = float(h.get("max", 0.0))
        td.sum = float(h.get("sum", 0.0))
        td.count = float(h.get("count", 0.0))
        td.reciprocal_sum = float(h.get("reciprocal_sum", 0.0))
    elif mtype == "set":
        m.set.hyper_log_log = bytes.fromhex(d["set"])
    elif mtype == "counter":
        m.counter.value = int(d["value"])
    elif mtype == "gauge":
        m.gauge.value = float(d["value"])
    return m


class HttpApi:
    """The ops HTTP listener. `debug_state()` serves GET /debug/flush,
    `fleet_state()` GET /debug/fleet and `health()` GET /healthz and
    /ready: a dict with `healthy`/`ready` booleans and a per-check
    breakdown; a failing verdict answers 503, so a wedged flusher is
    detectable from outside the process. `profile(ticks)` (optional)
    schedules a profiler capture; absent, /debug/flush/profile answers
    403. Without `debug_state` or `fleet_state` their routes answer 404;
    without `health` the verdict is a bare healthy/ready.

    POST /import: `submit(digest, pb_metric)` routes one imported metric
    onto a worker queue (absent: 503, not a global). `ledger` (a
    cluster.importsrv.DedupeLedger, optional) drops a chunk whose
    envelope it already admitted, and refuses a delta over a seq gap
    with 409. `engine_stamp` is the server's sketch-engine/wire stamp: a
    request whose declared stamp (or implied legacy default) does not
    match is 400'd before any decode, its verdict recorded through
    `note_stamp(sender, stamp, ok)`. `observer` (observe.ImportObserver)
    phase-attributes each request; `merge_sketches(items)` takes the
    advisory per-prefix cardinality rows (X-Veneur-Prefix-Sketches).
    `submit_batch([(digest, pb), ...], envelope)` (optional) takes a whole
    admitted request in place of `submit`: the durable global journals it
    as one op before any worker sees it.

    GET /query: `query(params)` (optional) runs one time-travel query and
    returns its JSON body, or raises an error carrying `status` and
    `detail`; absent, /query answers 404."""

    def __init__(self, address: str, debug_state=None, fleet_state=None,
                 health=None, profile=None, *, submit=None, ledger=None,
                 observer=None, engine_stamp=None, note_stamp=None,
                 merge_sketches=None, submit_batch=None, query=None):
        host, _, port = address.rpartition(":")
        host = host.strip("[]") or "0.0.0.0"
        self._debug_state = debug_state
        self._fleet_state = fleet_state
        self._health = health
        self._profile = profile
        self._submit = submit
        self._ledger = ledger
        self._observer = observer
        self._engine_stamp = engine_stamp
        self._note_stamp = note_stamp
        self._merge_sketches = merge_sketches
        self._submit_batch = submit_batch
        self._query = query
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

            def _json(self, fn, what: bytes):
                if fn is None:
                    self._reply(404, b"no " + what + b" state on this "
                                     b"listener\n")
                    return
                self._reply(200, json.dumps(fn(), default=str).encode(),
                            "application/json")

            def do_GET(self):
                path = urlparse(self.path).path.rstrip("/")
                if self.path in ("/healthcheck", "/healthcheck/tcp"):
                    self._reply(200, b"ok\n")
                elif self.path in ("/healthz", "/ready"):
                    body = (api._health() if api._health is not None
                            else {"healthy": True, "ready": True,
                                  "checks": {}})
                    ok = body["ready" if self.path == "/ready"
                              else "healthy"]
                    self._reply(200 if ok else 503,
                                json.dumps(body, default=str).encode(),
                                "application/json")
                elif self.path.rstrip("/") == "/debug/fleet":
                    self._json(api._fleet_state, b"fleet")
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
                    self._json(api._debug_state, b"flush")
                elif path == "/query":
                    self._serve_query()
                else:
                    self._reply(404, b"not found\n")

            def _serve_query(self):
                """GET /query: time-travel reads from the durability
                journal's retained generations."""
                if api._query is None:
                    self._reply(404, b"no time-travel query tier on "
                                     b"this server (set "
                                     b"history_retention_generations "
                                     b"with durability enabled)\n")
                    return
                # keep_blank_values: `tags=` (empty) means "untagged
                # keys only", distinct from no tags filter at all
                qs = parse_qs(urlparse(self.path).query,
                              keep_blank_values=True)
                params = {k: v[0] for k, v in qs.items() if v}
                try:
                    body = api._query(params)
                except Exception as e:
                    status = getattr(e, "status", 500)
                    detail = getattr(e, "detail", f"query failed: {e}")
                    self._reply(status, json.dumps(
                        {"error": detail}).encode(), "application/json")
                    return
                self._reply(200, json.dumps(body, default=str).encode(),
                            "application/json")

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
                if api._submit is None:
                    self._reply(503, b"not a global veneur\n")
                    return
                from .cluster import wire
                # jsonmetric-v1 contract: reject a declared format we
                # don't speak rather than misparse it; absent header =
                # v1 (curl/operator tooling)
                ver = self.headers.get("X-Veneur-Forward-Version")
                if ver is not None and ver != "jsonmetric-v1":
                    self._reply(400, f"unsupported forward format "
                                     f"{ver!r}\n".encode())
                    return
                # idempotency envelope: decoded up front so a malformed
                # one 400s before any work, but NOT admitted to the
                # ledger until the body has fully decoded — a chunk whose
                # read/parse then failed must not read as applied, or
                # the sender's safe re-send would be dropped
                try:
                    env = wire.envelope_from_headers(self.headers)
                except ValueError as e:
                    self._reply(400, f"bad forward envelope: "
                                     f"{e}\n".encode())
                    return
                # sketch-engine/wire stamp: a mismatched fleet is 400'd
                # before any decode work, its verdict recorded per sender
                obs_kw = {}
                if api._engine_stamp is not None:
                    from . import sketches
                    remote = wire.sketch_stamp_from_headers(self.headers)
                    if not sketches.stamp_compatible(api._engine_stamp,
                                                     remote):
                        if api._note_stamp is not None:
                            api._note_stamp(
                                env[0] if env else "(unknown)",
                                remote, False)
                        self._reply(400, b"sketch engine/wire-format "
                                         b"mismatch\n")
                        return
                    obs_kw["stamp"] = remote
                # delta-over-gap refusal: a delta chunk applies only over
                # an unbroken per-sender seq chain, checked from the
                # headers before any decode; 409 + the marker body is
                # what the sender's fallback recognizes (spill, then a
                # full resync). The refused delta was never applied.
                if (env is not None and api._ledger is not None
                        and wire.forward_kind_from_headers(self.headers)
                        == "delta"
                        and not api._ledger.check_delta(env[0], env[1])):
                    self._reply(409, json.dumps(
                        {"error": wire.DELTA_GAP_DETAIL,
                         "sender": env[0], "seq": env[1]}).encode(),
                        "application/json")
                    return
                if api._merge_sketches is not None:
                    raw = self.headers.get(wire.PREFIX_SKETCH_HEADER)
                    if raw:
                        items = wire.decode_prefix_sketches_header(raw)
                        if items:
                            api._merge_sketches(items)
                if api._observer is not None:
                    trace = wire.trace_from_headers(self.headers)
                    with api._observer.request(env, trace, "http",
                                               **obs_kw) as scope:
                        self._import_body(wire, env, scope)
                else:
                    self._import_body(wire, env, None)

            def _import_body(self, wire, env, scope):
                ph = -1 if scope is None else scope.start("decode")
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n))
                    if not isinstance(body, list):
                        raise ValueError("body must be a JSON array "
                                         "of metrics")
                    # decode the whole batch before submitting any of it
                    # (atomic like handleImport: a 400 means nothing was
                    # imported, so clients may safely re-send)
                    decoded = []
                    for d in body:
                        pb = json_metric_to_pb(d)
                        key = wire.metric_key_of(pb)
                        decoded.append((metric_digest(
                            key.name, key.type, key.joined_tags), pb))
                except (ValueError, KeyError, TypeError) as e:
                    if scope is not None:
                        scope.finish(ph, outcome="error")
                        scope.rejected = True
                    self._reply(400, f"bad import body: {e}\n".encode())
                    return
                if scope is not None:
                    scope.finish(ph, n_metrics=len(decoded))
                # payload fully in hand: NOW consult the ledger — a chunk
                # it already admitted is dropped WHOLE, with a 200 (the
                # sender delivered it, it just cannot know that yet)
                ph = -1 if scope is None else scope.start("dedupe")
                admitted = not (env is not None
                                and api._ledger is not None
                                and not api._ledger.admit(*env))
                if scope is not None:
                    scope.finish(ph, admitted=admitted)
                    scope.admitted = admitted
                if not admitted:
                    self._reply(200, json.dumps(
                        {"imported": 0, "deduped": True}).encode(),
                        "application/json")
                    return
                ph = -1 if scope is None else scope.start("apply")
                if api._submit_batch is not None:
                    api._submit_batch(decoded, env)
                else:
                    for digest, pb in decoded:
                        api._submit(digest, pb)
                if scope is not None:
                    scope.finish(ph, n_metrics=len(decoded))
                    scope.n_metrics = len(decoded)
                self._reply(200, json.dumps(
                    {"imported": len(decoded)}).encode(),
                    "application/json")

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
