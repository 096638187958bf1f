"""The port's ops HTTP routes against the reference's, on a running port
server and a running reference server: status codes and bodies, the JSON
keys of /healthz, /debug/flush and /debug/fleet; POST /import answers
as the reference's does (an empty JSONMetric list imports nothing)."""

import json
import socket
import time
import urllib.error
import urllib.request

import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks.basic import CaptureMetricSink as JCapture
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink

WIDTHS = dict(statsd_listen_addresses=["udp://127.0.0.1:0"],
              http_address="127.0.0.1:0", interval="3600s", hostname="h",
              tpu_histogram_slots=256, tpu_counter_slots=128,
              tpu_gauge_slots=128, tpu_set_slots=64, tpu_batch_size=256)


def _request(port, path, method="GET"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method,
                                 data=b"[]" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _start(server_cls, cfg, cap):
    srv = server_cls(cfg, sinks=[cap])
    srv.start()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.sendto(b"h.t:1|ms\nh.c:2|c", ("127.0.0.1", srv.bound_port()))
    deadline = time.monotonic() + 30
    while srv.packets_received < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.drain()
    srv.flush_once(timestamp=1000)
    assert cap.wait_for_flush(1)
    return srv


@pytest.fixture(scope="module")
def ports():
    jsrv = _start(JServer, JConfig(**WIDTHS), JCapture())
    tsrv = _start(Server, Config(aggregation_backend="cpu", **WIDTHS),
                  CaptureMetricSink())
    yield jsrv.http_api.port, tsrv.http_api.port
    jsrv.stop()
    tsrv.stop()


@pytest.mark.parametrize("path", [
    "/healthcheck", "/healthcheck/tcp", "/version", "/builddate",
    "/query", "/query?metric=x&q=0.5", "/debug/flush/profile",
    "/debug/flush/profile?ticks=2", "/debug/flushx", "/nope"])
def test_plain_routes_answer_as_the_reference(ports, path):
    jport, tport = ports
    assert _request(tport, path) == _request(jport, path)


@pytest.mark.parametrize("path", ["/healthz", "/ready", "/debug/flush",
                                  "/debug/flush/", "/debug/fleet"])
def test_json_routes_have_the_references_keys(ports, path):
    jport, tport = ports
    (jc, jb), (tc, tb) = _request(jport, path), _request(tport, path)
    assert (tc, jc) == (200, 200)
    j, t = json.loads(jb), json.loads(tb)
    assert set(t) == set(j)
    if path in ("/healthz", "/ready"):
        assert t["healthy"] and t["ready"] and t["status"] == "ok"
        assert set(t["checks"]) <= set(j["checks"])
        assert set(t["checks"]["flush"]) == set(j["checks"]["flush"])
    elif path.startswith("/debug/flush"):
        assert set(t["flight_recorder"]) == set(j["flight_recorder"])
        tick, jtick = (x["flight_recorder"]["ticks"][0] for x in (t, j))
        assert set(tick) == set(jtick)
        names = {p["name"] for p in tick["phases"]}
        assert {"engine", "engine.flush", "telemetry", "fanout",
                "engine.swap", "engine.drain", "engine.materialize"} <= names
        # the engine's phases: the reference's names where the port has
        # the stage
        jnames = {p["name"] for p in jtick["phases"]}
        assert {n for n in names if n.startswith("engine.")} == \
            {n for n in jnames if n.startswith("engine.")}
        assert set(t["sketch_engines"]) == set(j["sketch_engines"])
        assert t["sketch_engines"]["stamp"] == j["sketch_engines"]["stamp"]
        # with an HTTP listener both keep a dedupe ledger for POST
        # /import (ROADMAP queue C.5, closed)
        assert t["dedupe_ledger"] is not None
        assert t["dedupe_ledger"] == j["dedupe_ledger"]
    else:
        assert t["senders"] == j["senders"] == {}
        assert set(t["health"]) == set(j["health"])
        # the import recorder is the observer's state on both
        assert t["import_recorder"] is not None
        assert set(t["import_recorder"]) == set(j["import_recorder"])


def test_debug_threads_dumps_every_thread(ports):
    _, tport = ports
    code, body = _request(tport, "/debug/threads")
    assert code == 200
    text = body.decode()
    assert "--- flusher (" in text and "--- http-api (" in text


def test_import_answers_501_naming_item_10(ports):
    """POST /import is ported: the port answers as the reference does
    (it no longer answers 501)."""
    jport, tport = ports
    code, body = _request(tport, "/import", method="POST")
    assert (code, body) == _request(jport, "/import", method="POST")
    assert code == 200 and json.loads(body) == {"imported": 0}
    assert _request(tport, "/other", method="POST") == (404, b"not found\n")
