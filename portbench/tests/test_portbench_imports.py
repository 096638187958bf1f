"""No module of the benchmark loads JAX or the JAX package, and no
module of the reference loads anything of the port."""

import subprocess
import sys

from portbench import run

EVERY = r"""
import importlib, os, pkgutil, sys
import portbench, portbench.run as run
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
for f in os.listdir(os.path.join(run.ROOT, "portbench", "metrics")):
    if f.endswith(".py"):
        run.reader(f[:-3])
top = {m.split(".")[0] for m in sys.modules}
print(sorted(top & {"jax", "jaxlib", "flax", "veneur_tpu"}))
"""

REFERENCE = r"""
import importlib, pkgutil, sys
import portbench.reference as ref
for m in pkgutil.walk_packages(ref.__path__, "portbench.reference."):
    importlib.import_module(m.name)
assert "portbench.reference.local" in sys.modules
top = {m.split(".")[0] for m in sys.modules}
print(sorted(top & {"jax", "jaxlib", "flax", "veneur_tpu",
                    "veneur_tpu_torch"}))
"""


def fresh(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_no_module_of_the_benchmark_loads_jax():
    assert fresh(EVERY) == "[]"


def test_the_reference_loads_nothing_of_the_port():
    assert fresh(REFERENCE) == "[]"


def test_the_harness_names_what_it_finds(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]
