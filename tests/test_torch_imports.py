"""The port stands apart from the JAX package.

Importing every module of veneur_tpu_torch, and chip_smoke.py, pulls in
neither jax nor any veneur_tpu module (checked in a fresh interpreter).
Only the generated `*_pb2` modules and `cluster/wire.py`, which turns
forward exports into metricpb bytes, import google.protobuf at module
level: every other module imports it inside the functions that handle a
span or an import (the engine imports the wire inside `import_list`), so
importing them all pulls in no yaml, protobuf or grpc, and a
DogStatsD-only server that starts, takes a datagram and flushes imports
no protobuf either. chip_smoke.py refuses to run without a card or
without the package beside it, and then prints no result.
"""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import veneur_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    veneur_tpu_torch.__path__, "veneur_tpu_torch.")]
for name in names:
    if not name.endswith("_pb2") and name != "veneur_tpu_torch.cluster.wire":
        importlib.import_module(name)
import chip_smoke
absent = sorted(m for m in sys.modules
                if m in ("yaml", "grpc") or m.startswith(
                    ("yaml.", "grpc.", "google.protobuf")))
from veneur_tpu_torch.ssf.protos import ssf_pb2
assert ssf_pb2.SSFSpan(name="x").name == "x"
from veneur_tpu_torch.cluster import wire
from veneur_tpu_torch.cluster.protos import forward_pb2, metric_pb2
ml = forward_pb2.MetricList(metrics=[metric_pb2.Metric(name="x")])
assert forward_pb2.MetricList.FromString(
    ml.SerializeToString()).metrics[0].name == "x"
assert wire.metric_pb2 is metric_pb2 and wire.forward_pb2 is forward_pb2
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "veneur_tpu" or m.startswith("veneur_tpu."))
print(",".join(names))
print(",".join(bad))
print(",".join(absent))
"""

# a DogStatsD-only CPU server: started, one datagram, one flush
_STATSD_ONLY = r"""
import socket, sys, time
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink
cap = CaptureMetricSink()
srv = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                    http_address="127.0.0.1:0", tpu_histogram_slots=256,
                    tpu_counter_slots=128, tpu_gauge_slots=128,
                    tpu_set_slots=64, tpu_batch_size=256),
             sinks=[cap], device="cpu")
srv.start()
with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
    s.sendto(b"only.c:3|c", ("127.0.0.1", srv.bound_port()))
deadline = time.monotonic() + 30
while srv.packets_received < 1 and time.monotonic() < deadline:
    time.sleep(0.01)
assert srv.drain()
srv.flush_once(timestamp=1)
assert cap.wait_for_flush(1)
srv.stop()
assert {m.name: m.value for m in cap.flushes[0]}["only.c"] == 3.0
print(",".join(sorted(m for m in sys.modules
                      if m.startswith("google.protobuf"))))
"""

# the server's path: each must be among the modules imported above
SERVER_PATH = ("veneur_tpu_torch.server", "veneur_tpu_torch.http_api",
               "veneur_tpu_torch.config", "veneur_tpu_torch.cli.veneur",
               "veneur_tpu_torch.observe", "veneur_tpu_torch.observe.fleet",
               "veneur_tpu_torch.observe.recorder",
               "veneur_tpu_torch.observe.registry",
               "veneur_tpu_torch.sinks", "veneur_tpu_torch.sinks.basic",
               "veneur_tpu_torch.sinks.ssfmetrics", "veneur_tpu_torch.ssf",
               "veneur_tpu_torch.ssf.framing",
               "veneur_tpu_torch.ssf.protos",
               "veneur_tpu_torch.ssf.protos.ssf_pb2",
               "veneur_tpu_torch.trace", "veneur_tpu_torch.trace.opentracing",
               "veneur_tpu_torch.cli.emit",
               "veneur_tpu_torch.ingest.admission")


# the global tier's engine and wire: each must be among the modules
# imported above
GLOBAL_PATH = ("veneur_tpu_torch.cluster", "veneur_tpu_torch.cluster.wire",
               "veneur_tpu_torch.cluster.protos",
               "veneur_tpu_torch.cluster.protos.metric_pb2",
               "veneur_tpu_torch.cluster.protos.forward_pb2",
               "veneur_tpu_torch.models.pipeline")


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    names, bad, absent = out.stdout.split("\n")[-4:-1]
    names = names.split(",")
    assert len(names) >= 30
    assert set(SERVER_PATH) <= set(names)
    assert set(GLOBAL_PATH) <= set(names)
    assert bad == "", f"JAX-side modules imported: {bad}"
    assert absent == "", f"yaml/protobuf/grpc imported: {absent}"


def test_statsd_only_server_imports_no_protobuf():
    out = subprocess.run([sys.executable, "-c", _STATSD_ONLY], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().split("\n")[-1] == ""


def _run_chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_chip_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_without_card_fails_without_result():
    import torch
    if torch.cuda.is_available():
        return      # the card run is chip_smoke's own job
    out = _run_chip_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr
