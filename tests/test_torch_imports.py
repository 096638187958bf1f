"""The port stands apart from the JAX package.

Importing every module of veneur_tpu_torch, chip_smoke.py and
mesh_cards.py pulls in
neither jax nor any veneur_tpu module (checked in a fresh interpreter).
Only the generated `*_pb2` modules and `cluster/wire.py`, which turns
forward exports into metricpb bytes, import google.protobuf at module
level: every other module imports it, and grpc, inside the functions
that handle a span, forward or import (the engine imports the wire
inside `import_list`, the forwarders, import server and proxy inside
their calls, the falconer span sink in start()), and the Kafka and S3
clients are looked up only when a sink without an injected producer or
uploader starts, so importing them all pulls in no yaml, protobuf, grpc,
kafka or boto3,
and a DogStatsD-only server — its HTTP listener with the dedupe ledger
included — that starts, takes a datagram and flushes imports neither
protobuf nor grpc. The HTTP API no longer carries the "not ported"
answer to POST /import. The durability package (journals, records,
the history and query tier) and the durable server's modules import
neither jax nor veneur_tpu, and protobuf only inside the record codecs'
functions. chip_smoke.py refuses to run without a card or without the
package beside it, and then prints no result.
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
import mesh_cards
absent = sorted(m for m in sys.modules
                if m in ("yaml", "grpc", "kafka", "boto3") or m.startswith(
                    ("yaml.", "grpc.", "google.protobuf", "kafka.",
                     "boto3.", "botocore")))
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
assert srv.dedupe_ledger is not None
print(",".join(sorted(m for m in sys.modules
                      if m.startswith(("google.protobuf", "grpc")))))
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
               "veneur_tpu_torch.ingest.admission",
               "veneur_tpu_torch.ingest.native")


# the global tier's engine and wire: each must be among the modules
# imported above
GLOBAL_PATH = ("veneur_tpu_torch.cluster", "veneur_tpu_torch.cluster.wire",
               "veneur_tpu_torch.cluster.protos",
               "veneur_tpu_torch.cluster.protos.metric_pb2",
               "veneur_tpu_torch.cluster.protos.forward_pb2",
               "veneur_tpu_torch.models.pipeline")

# the global tier over the network: each must be among the modules
# imported above
NETWORK_PATH = ("veneur_tpu_torch.resilience",
                "veneur_tpu_torch.utils.faults",
                "veneur_tpu_torch.cluster.discovery",
                "veneur_tpu_torch.cluster.forward",
                "veneur_tpu_torch.cluster.importsrv",
                "veneur_tpu_torch.cluster.proxy",
                "veneur_tpu_torch.cli.proxy")


# the network sinks, the S3 plugin, the sentry client and the
# Prometheus repeater: each must be among the modules imported above
SINK_PATH = ("veneur_tpu_torch.sinks.datadog",
             "veneur_tpu_torch.sinks.signalfx",
             "veneur_tpu_torch.sinks.kafka",
             "veneur_tpu_torch.sinks.newrelic",
             "veneur_tpu_torch.sinks.splunk",
             "veneur_tpu_torch.sinks.lightstep",
             "veneur_tpu_torch.sinks.xray", "veneur_tpu_torch.sinks.s3",
             "veneur_tpu_torch.sinks.grpsink",
             "veneur_tpu_torch.sinks.prometheus",
             "veneur_tpu_torch.utils.sentry",
             "veneur_tpu_torch.cli.prometheus")


# the multi-device engine: each must be among the modules imported above
PARALLEL_PATH = ("veneur_tpu_torch.parallel",
                 "veneur_tpu_torch.parallel.mesh",
                 "veneur_tpu_torch.parallel.engine")


# durability and /query: each must be among the modules imported above
DURABILITY_PATH = ("veneur_tpu_torch.durability",
                   "veneur_tpu_torch.durability.journal",
                   "veneur_tpu_torch.durability.records",
                   "veneur_tpu_torch.durability.state",
                   "veneur_tpu_torch.durability.history")

# the durability package alone, in a fresh interpreter: a journal, a
# checkpoint record of a CPU engine and a history generation, with
# protobuf absent until a record codec that needs it runs
_DURABILITY_ONLY = r"""
import sys, tempfile
import numpy as np
from veneur_tpu_torch import durability
from veneur_tpu_torch.durability import records
from veneur_tpu_torch.durability.history import HistoryStore, parse_qspec
from veneur_tpu_torch.models.pipeline import AggregationEngine, EngineConfig
d = tempfile.mkdtemp()
j = durability.EngineJournal(d, fsync="never")
j.load_records()
eng = AggregationEngine(EngineConfig(histogram_slots=8, counter_slots=8,
                                     gauge_slots=8, set_slots=8,
                                     hll_precision=6), device="cpu")
eng.enable_dirty_tracking()
recs = records.encode_engine_checkpoint(0, 1, eng.checkpoint_state())
j.append_checkpoint(recs)
j.close()
st = HistoryStore(d, retention_generations=2, fsync=False)
st.append(10**9, 0, [0], recs, [])
assert parse_qspec("0.5,count")[0] == (0.5,)
before = sorted(m for m in sys.modules if m.startswith(
    ("google.protobuf", "grpc")))
from veneur_tpu_torch.durability.records import encode_engine_import
encode_engine_import(1, [])
after = sorted(m for m in sys.modules if m.startswith("google.protobuf"))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "veneur_tpu" or m.startswith("veneur_tpu."))
print(",".join(before))
print(",".join(bad))
print(len(after))
"""


# a native-ingest CPU server in a fresh interpreter: the bridge built and
# loaded from veneur_tpu_torch/_build/, one datagram, one flush; no JAX,
# no veneur_tpu module, and neither library of native/build/ mapped
_NATIVE_ONLY = r"""
import socket, sys, time
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.ingest import native
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink
cap = CaptureMetricSink()
srv = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                    native_ingest=True, tpu_histogram_slots=256,
                    tpu_counter_slots=128, tpu_gauge_slots=128,
                    tpu_set_slots=64, tpu_batch_size=256),
             sinks=[cap], device="cpu")
srv.start()
with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
    s.sendto(b"only.c:3|c", ("127.0.0.1", srv.bound_port()))
deadline = time.monotonic() + 30
while srv.native_bridge.stats()["lines"] < 1 and time.monotonic() < deadline:
    time.sleep(0.01)
assert srv.drain()
srv.flush_once(timestamp=1)
assert cap.wait_for_flush(1)
srv.stop()
assert {m.name: m.value for m in cap.flushes[0]}["only.c"] == 3.0
maps = open("/proc/self/maps").read()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "veneur_tpu" or m.startswith("veneur_tpu."))
print(native.LIB_PATH)
print(",".join(sorted({ln.split()[-1] for ln in maps.splitlines()
                       if "libvtpu_ingest" in ln})))
print(",".join(bad))
"""


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
    assert set(NETWORK_PATH) <= set(names)
    assert set(DURABILITY_PATH) <= set(names)
    assert set(SINK_PATH) <= set(names)
    assert set(PARALLEL_PATH) <= set(names)
    assert bad == "", f"JAX-side modules imported: {bad}"
    assert absent == "", f"yaml/protobuf/grpc/kafka/boto3 imported: {absent}"


def test_statsd_only_server_imports_no_protobuf():
    out = subprocess.run([sys.executable, "-c", _STATSD_ONLY], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().split("\n")[-1] == ""


def test_native_server_loads_the_ports_bridge_and_no_jax():
    out = subprocess.run([sys.executable, "-c", _NATIVE_ONLY], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lib, mapped, bad = out.stdout.split("\n")[-4:-1]
    assert lib == os.path.join(ROOT, "veneur_tpu_torch", "_build",
                               "libvtpu_ingest.so")
    assert mapped == lib
    assert bad == "", f"JAX-side modules imported: {bad}"


def test_durability_imports_no_jax_and_protobuf_only_in_functions():
    out = subprocess.run([sys.executable, "-c", _DURABILITY_ONLY],
                         cwd=ROOT, env=_clean_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    before, bad, after = out.stdout.split("\n")[-4:-1]
    assert before == "", f"protobuf/grpc imported at module level: {before}"
    assert bad == "", f"JAX-side modules imported: {bad}"
    assert int(after) > 0          # the import-op codec loads it itself


def test_parallel_names_no_jax_no_reference_and_no_process_group():
    """Every module of veneur_tpu_torch/parallel/ (walked from the
    package directory) imports neither jax nor any veneur_tpu module and
    never uses torch.distributed: the grid is one process's devices.
    (`import torch` loads torch.distributed itself, so the check reads
    the sources' imports and attributes, not sys.modules.)"""
    import ast
    pkg = os.path.join(ROOT, "veneur_tpu_torch", "parallel")
    files = sorted(f for f in os.listdir(pkg) if f.endswith(".py"))
    assert files == ["__init__.py", "engine.py", "mesh.py"]
    for f in files:
        src = open(os.path.join(pkg, f)).read()
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Attribute):
                assert not (node.attr == "distributed"
                            and isinstance(node.value, ast.Name)
                            and node.value.id == "torch"), f
                continue
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert not m.startswith(("jax", "veneur_tpu",
                                         "torch.distributed")), (f, m)


def test_http_api_no_longer_answers_not_ported():
    """POST /import is ported: the 501 answer and its text are gone."""
    import inspect

    from veneur_tpu_torch import http_api
    src = inspect.getsource(http_api)
    assert "501" not in src and "IMPORT_NOT_PORTED" not in src
    assert "not ported" not in src


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
