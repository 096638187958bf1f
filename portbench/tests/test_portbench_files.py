"""Every configuration, traffic mix and metric is found by its name, a
new one by adding files and entries only, and each metric reader reads
a canned record.

What a cell brings, found by the names in BENCHMARK.json:

- its configuration's kind, a module `portbench/cells/<kind>.py` with
  `prepare(cell, args)` and `run(cell, args, device, prep)`.
  `prepare` returns a dict whose "procs" has `close()`, which
  `run.main` calls where the cell's devices are not there. `run`
  returns the run's record: "correct", "attempted", "failed",
  "memory_peak_bytes", "checks" ({name: (value, limit)}) and "notes"
  (lines for standard error), which `run.result_of` reads; in a
  `--trace 1` run "trace" with "busy_s", "window_s" and "breakdown";
  and whatever its metrics' readers read;
- its traffic's generator, `portbench/gen/<generator>.py`;
- its reference, a module under `portbench/reference/` that loads
  nothing of the port;
- each new metric, a reader `portbench/metrics/<metric>.py` with
  `read(record)`, which returns None where the record holds nothing to
  read, and its canned answer `portbench/tests/canned/<metric>.json`:
  the record it reads ("record", a file under `canned/records/`) and
  the value it gives there ("value").
"""

import inspect
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
LISTED = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
PB = os.path.join(run.ROOT, "portbench")
METRICS = sorted(f[:-3] for f in os.listdir(os.path.join(PB, "metrics"))
                 if f.endswith(".py"))
CANNED = sorted(f[:-5] for f in os.listdir(os.path.join(PB, "tests",
                                                        "canned"))
                if f.endswith(".json"))
KIND_API = {"prepare": ["cell", "args"],
            "run": ["cell", "args", "device", "prep"]}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(name):
    cell = run.load_cell(name)
    assert cell["config"]["name"] == cell["workload"]["config"]
    kind, gen = cell["config"]["kind"], cell["traffic"]["generator"]
    assert os.path.isfile(os.path.join(PB, "cells", kind + ".py")), kind
    mod = run.driver(cell)
    for fn, params in KIND_API.items():
        assert list(inspect.signature(getattr(mod, fn)).parameters) \
            == params, (kind, fn)
    assert os.path.isfile(os.path.join(PB, "gen", gen + ".py")), gen
    assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        assert any(e["name"] == m["moves"] for e in cell["end_to_end"])


def test_config_entries_match_their_files():
    for c in BENCH["configs"]:
        doc = json.load(open(os.path.join(run.ROOT, c["file"])))
        assert doc["name"] == c["name"] and doc["source"] == c["source"]
        assert doc["reduced"] == c["reduced"]
        assert "assumed" in doc


@pytest.mark.parametrize("name", LISTED)
def test_every_listed_metric_has_a_reader(name):
    assert callable(run.reader(name))


def canned(metric):
    """The record that `metric`'s canned answer names, and the value."""
    with open(os.path.join(PB, "tests", "canned", metric + ".json")) as f:
        answer = json.load(f)
    with open(os.path.join(run.ROOT, answer["record"])) as f:
        return json.load(f), answer["value"]


def test_every_reader_has_a_canned_answer():
    assert not set(METRICS) - set(CANNED), "readers without an answer"
    assert not set(CANNED) - set(METRICS), "answers without a reader"


@pytest.mark.parametrize("name", METRICS)
def test_reader_on_a_canned_record(name):
    rec, want = canned(name)
    assert run.reader(name)(rec) == pytest.approx(want, rel=2e-3)


@pytest.mark.parametrize("name", [m for m in METRICS if m != "setup_s"])
def test_reader_finds_nothing_in_an_empty_record(name):
    assert run.reader(name)({"kind": "local"}) is None


# A cell of a kind of its own, with a generator, a reference and a
# per-layer metric of its own: every file new, beside BENCHMARK.json.
NEW_FILES = {
    "portbench/configs/other-stub.json": json.dumps(
        {"name": "other-stub", "kind": "stub", "source": "a test",
         "reduced": [], "assumed": {}}),
    "portbench/cells/stub.py": '''"""A kind that runs nothing."""

import json
import os


class Procs:
    def close(self):
        print("procs closed")


def prepare(cell, args):
    return {"procs": Procs()}


def run(cell, args, device, prep):
    with open(os.path.join(os.path.dirname(__file__), "..", "tests",
                           "canned", "records", "stub.json")) as f:
        rec = json.load(f)
    rec.update(correct=True, attempted=1, failed=0, memory_peak_bytes=1,
               checks={"stub_off": (0.0, 0.0)}, notes=["a stub"])
    if args.trace:
        rec["trace"] = {"busy_s": 0.5, "window_s": 10.0,
                        "breakdown": {"device_ops": [], "idle_gaps": []}}
    return rec
''',
    "portbench/traffic/trickle.json": json.dumps(
        {"generator": "stubgen", "rate_metrics_per_s": 1000}),
    "portbench/gen/stubgen.py": '"""Sends nothing."""\n',
    "portbench/reference/stub.py": '''"""Judges nothing."""

import numpy as np


def judge(sent, rows):
    return {"stub_off": (float(np.sum(sent) - np.sum(rows)), 0.0)}
''',
    "portbench/metrics/stub.import_ms.py": '''"""The mean import."""


def read(rec):
    x = rec.get("imports_ms")
    return sum(x) / len(x) if x else None
''',
    "portbench/tests/canned/stub.import_ms.json": json.dumps(
        {"record": "portbench/tests/canned/records/stub.json",
         "value": 3.0}),
    "portbench/tests/canned/records/stub.json": json.dumps(
        {"kind": "stub", "setup_s": 1.0, "flush_samples": [1000],
         "window_s": 10.0, "imports_ms": [2.0, 4.0]}),
}
NEW_CELL = "other-stub.trickle"
THIS = "portbench/tests/test_portbench_files.py"
IN_A_COPY = ["--deselect", THIS + "::test_a_new_cell_and_metric_need_new_"
             "files_and_entries_only", "--deselect",
             THIS + "::test_a_copy_that_lacks_a_file_fails_its_tests"]


def with_new_cell(bench):
    """BENCHMARK.json's entries with the new cell's added."""
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": "other-stub", "source": "a test",
                             "file": "portbench/configs/other-stub.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": NEW_CELL, "config": "other-stub",
                               "traffic": "trickle", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "stub.import_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "import", "moves": "samples_per_s",
                               "workloads": [NEW_CELL]})
    for m in bench["end_to_end"]:
        if m["name"] == "samples_per_s":
            m["workloads"].append(NEW_CELL)
    return bench


def copy_with_new_cell(root, leave_out=None):
    shutil.copytree(PB, root / "portbench", ignore=shutil.ignore_patterns(
        "__pycache__", ".pytest_cache"))
    for path, text in NEW_FILES.items():
        assert not (root / path).exists(), path
        if path != leave_out:
            (root / path).write_text(text)
    (root / "BENCHMARK.json").write_text(
        json.dumps(with_new_cell(BENCH), indent=1))


def pytest_in(root, *args):
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         *args, *IN_A_COPY], cwd=root, capture_output=True, text=True,
        timeout=600)


RESULTS = r"""
import json
from portbench import run
assert run.ROOT == %r, run.ROOT
for trace in ("0", "1"):
    args = run.parse(["--workload", %r, "--seed", "1", "--seconds", "1",
                      "--trace", trace])
    cell = run.load_cell(args.workload)
    rec = run.run_cell(cell, args, None, run.driver(cell).prepare(cell, args))
    print(json.dumps(run.result_of(cell, rec, args, {})))
print(run.main(["--workload", %r, "--seed", "1", "--seconds", "1"]))
"""


def test_a_new_cell_and_metric_need_new_files_and_entries_only(tmp_path):
    copy_with_new_cell(tmp_path)
    out = pytest_in(tmp_path, THIS, "portbench/tests/test_portbench_"
                    "imports.py")
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    for case in (f"test_every_cell_loads_by_name[{NEW_CELL}]",
                 "test_reader_on_a_canned_record[stub.import_ms]",
                 "test_every_listed_metric_has_a_reader[stub.import_ms]"):
        assert f"::{case} PASSED" in out.stdout, case

    # the kind's record makes a result: its end-to-end metrics in a
    # plain run, its per-layer ones traced; run.main closes the procs
    # where no device is found
    import torch
    out = subprocess.run([sys.executable, "-c", RESULTS % (
        str(tmp_path), NEW_CELL, NEW_CELL)], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    plain, traced = json.loads(lines[0]), json.loads(lines[1])
    assert plain["metrics"] == {
        "samples_per_s": {"value": 100.0, "unit": "samples/s"},
        "setup_s": {"value": 1.0, "unit": "s"}}
    assert traced["metrics"] == {
        "stub.import_ms": {"value": 3.0, "unit": "ms"}}
    assert traced["device"] == {"memory_peak_bytes": 1, "busy_s": 0.5,
                                "window_s": 10.0}
    assert plain["checks"] == {"stub_off": {"value": 0.0, "limit": 0.0}}
    if torch.cuda.is_available():
        assert json.loads(lines[-2])["correct"] and lines[-1] == "0"
    else:
        assert lines[-2:] == ["procs closed", "2"]

    # and no file of the tree was edited
    for d, dirs, files in os.walk(PB):
        dirs[:] = [x for x in dirs if x not in ("__pycache__",
                                                ".pytest_cache")]
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), run.ROOT)
            with open(os.path.join(run.ROOT, rel), "rb") as a:
                assert a.read() == (tmp_path / rel).read_bytes(), rel
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        del bench[key][len(BENCH[key]):]
    for m in bench["end_to_end"]:
        if NEW_CELL in m.get("workloads", []):
            m["workloads"].remove(NEW_CELL)
    assert bench == BENCH, "BENCHMARK.json gains entries only"


@pytest.mark.parametrize("leave_out, fails", [
    ("portbench/tests/canned/stub.import_ms.json",
     ["test_every_reader_has_a_canned_answer",
      "test_reader_on_a_canned_record[stub.import_ms]"]),
    ("portbench/cells/stub.py",
     [f"test_every_cell_loads_by_name[{NEW_CELL}]"]),
])
def test_a_copy_that_lacks_a_file_fails_its_tests(tmp_path, leave_out,
                                                  fails):
    copy_with_new_cell(tmp_path, leave_out)
    out = pytest_in(tmp_path, THIS)
    assert out.returncode == 1, out.stdout[-4000:] + out.stderr[-2000:]
    for case in fails:
        assert f"::{case} FAILED" in out.stdout, case
