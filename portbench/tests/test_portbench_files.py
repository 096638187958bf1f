"""Every configuration, traffic mix and metric is found by its name, a
new one by adding files and entries only, and each metric reader reads
a canned record."""

import json
import os
import shutil

import pytest

from portbench import run

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
LISTED = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
METRICS = sorted(f[:-3] for f in os.listdir(
    os.path.join(run.ROOT, "portbench", "metrics")) if f.endswith(".py"))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(name):
    cell = run.load_cell(name)
    assert cell["config"]["name"] == cell["workload"]["config"]
    assert cell["config"]["kind"] == "local"
    assert cell["traffic"]["generator"] == "statsd"
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


def canned(kind):
    """Five flushes of 100 ms at 12, 14, .. 20 s; a 50-ms collection
    wholly inside the first, one of 60 ms that starts 20 ms before the
    second and one of 30 ms between the third and the fourth; 13 CPU
    seconds in the window, 9.9 of them the pump's and 0.5 the flushes'."""
    flushes = [{"t0": 10.0 + 2 * k, "t1": 10.1 + 2 * k, "swap_ns": 5e6,
                "merge_ns": 9e6, "assembly_ns": 4e7} for k in range(1, 6)]
    return {"kind": kind, "setup_s": 11.5, "flushes": flushes,
            "window_s": 10.0, "flush_samples": [300000, 290000, 310000,
                                                300000, 300000],
            "gc_spans": [(12.0, 12.05), (13.98, 14.04), (17.0, 17.03)],
            "cpu": {"process_s": 14.0, "main_s": 1.5, "flush_s": 0.5,
                    "window_s": 13.0, "pump_s": 9.9},
            "trace": {"busy_s": 0.5, "window_s": 10.0,
                      "compress": [(32768, 256, 256, True, 0.0006),
                                   (32768, 256, 256, False, 0.0012)]}}


WANT = {
    "setup_s": 11.5,
    "samples_per_s": 150000.0,
    "server.flush_ms": 100.0,
    "server.flush_p90_ms": 100.0,
    "engine.swap_p90_ms.flush": 5.0,
    "engine.assembly_ms": 40.0,
    "gc.flush_pause_ms": (50.0 + 60.0 + 30.0) / 5,
    "kernels.compress_roofline_pct.flush": 100 * 6.01e-5 / 6e-4,
    "device.idle_pct.flush": 95.0,
    "cpu_ns_per_sample": 13e9 / 1.5e6,
    "ingest.pump_cpu_pct": 99.0,
    "server.flush_cpu_pct": 5.0,
}


def test_every_reader_has_a_canned_answer():
    assert sorted(WANT) == METRICS


@pytest.mark.parametrize("name", METRICS)
def test_reader_on_a_canned_record(name):
    want = WANT[name]
    assert run.reader(name)(canned("local")) == pytest.approx(want, rel=2e-3)


@pytest.mark.parametrize("name", [m for m in METRICS if m != "setup_s"])
def test_reader_finds_nothing_in_an_empty_record(name):
    assert run.reader(name)({"kind": "local"}) is None


def test_a_new_cell_and_metric_need_new_files_and_entries_only(tmp_path):
    shutil.copytree(os.path.join(run.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.load(open(os.path.join(run.ROOT, BENCH["configs"][0]["file"])))
    conf["name"] = "local-other"
    (tmp_path / "portbench/configs/local-other.json").write_text(
        json.dumps(conf))
    traffic = json.load(open(os.path.join(
        run.ROOT, "portbench/traffic/steady.json")))
    traffic["rate_lines_per_s"] = 1000
    (tmp_path / "portbench/traffic/trickle.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/metrics/flushes.count.py").write_text(
        "def read(rec):\n    return float(len(rec['flushes']))\n")
    bench["configs"].append(dict(BENCH["configs"][0], name="local-other",
                                 file="portbench/configs/local-other.json"))
    bench["workloads"].append({"name": "local-other.trickle",
                               "config": "local-other",
                               "traffic": "trickle", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "flushes.count", "unit": "flushes",
                               "better": "higher", "source": "host_clock",
                               "layer": "server", "moves": "samples_per_s",
                               "workloads": ["local-other.trickle"]})
    for m in bench["end_to_end"]:
        if m["name"] == "samples_per_s":
            m["workloads"].append("local-other.trickle")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = run.load_cell("local-other.trickle", root=str(tmp_path))
    assert cell["traffic"]["rate_lines_per_s"] == 1000
    assert [m["name"] for m in cell["per_layer"]] == ["flushes.count"]
    read = run.reader("flushes.count", root=str(tmp_path))
    assert read(canned("local")) == 5.0
