"""The port stands apart from the JAX package.

Importing every module of veneur_tpu_torch, and chip_smoke.py, pulls in
neither jax nor any veneur_tpu module, nor yaml, google.protobuf or grpc,
which the card's machine may lack (checked in a fresh interpreter);
chip_smoke.py refuses to run without a card or without the package
beside it, and then prints no result.
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
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "veneur_tpu" or m.startswith("veneur_tpu."))
absent = sorted(m for m in sys.modules
                if m in ("yaml", "grpc") or m.startswith(
                    ("yaml.", "grpc.", "google.protobuf")))
print(",".join(names))
print(",".join(bad))
print(",".join(absent))
"""

# the server's path: each must be among the modules imported above
SERVER_PATH = ("veneur_tpu_torch.server", "veneur_tpu_torch.http_api",
               "veneur_tpu_torch.config", "veneur_tpu_torch.cli.veneur",
               "veneur_tpu_torch.observe", "veneur_tpu_torch.observe.fleet",
               "veneur_tpu_torch.observe.recorder",
               "veneur_tpu_torch.observe.registry",
               "veneur_tpu_torch.sinks", "veneur_tpu_torch.sinks.basic")


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
    assert bad == "", f"JAX-side modules imported: {bad}"
    assert absent == "", f"yaml/protobuf/grpc imported: {absent}"


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
