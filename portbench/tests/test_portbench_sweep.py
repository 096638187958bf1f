"""The sweep sets the one rate of any kind's traffic, refuses a traffic
without one, and prints the same keys a run whatever the record holds."""

import json
import os

import pytest

from portbench import run, sweep

KEYS = ["rate", "seed", "attempted", "failed", "correct", "samples_per_s",
        "flush_ms", "max_lag_s", "sent_lines", "bridge", "checks"]


def test_the_steady_rate_is_swapped():
    traffic = run.load_cell("local-native.steady")["traffic"]
    got = sweep.with_rate(traffic, 1000.0)
    assert got == dict(traffic, rate_lines_per_s=1000.0)
    assert traffic["rate_lines_per_s"] == 288000


def test_a_stub_rate_is_swapped():
    traffic = {"generator": "stubgen", "rate_metrics_per_s": 10}
    assert sweep.with_rate(traffic, 20) == dict(traffic,
                                                rate_metrics_per_s=20)


@pytest.mark.parametrize("traffic", [
    {"generator": "stubgen", "ramp_s": 2},
    {"generator": "stubgen", "rate_lines_per_s": 1,
     "rate_metrics_per_s": 2}])
def test_a_traffic_without_one_rate_is_refused(traffic):
    with pytest.raises(SystemExit, match="rate_"):
        sweep.with_rate(traffic, 1)


def canned_local():
    with open(os.path.join(run.ROOT, "portbench", "tests", "canned",
                           "records", "local.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("extra", [
    {"max_lag_s": 0.02, "sent_lines": 2880000, "bridge": [1.0, 2.0]},
    {}])
def test_one_prints_the_same_keys(monkeypatch, extra):
    seen = []

    def run_cell(cell, args, device, prep=None):
        seen.append((cell["traffic"]["rate_lines_per_s"], args.seed,
                     args.seconds))
        return dict(canned_local(), attempted=7, failed=0, correct=True,
                    notes=[], checks={"unsettled": (0, 0)}, **extra)

    monkeypatch.setattr(run, "run_cell", run_cell)
    got = sweep.one("local-native.steady", 1000.0, 11, 10.0)
    assert seen == [(1000.0, 11, 10.0)]
    assert got == {"rate": 1000.0, "seed": 11, "attempted": 7, "failed": 0,
                   "correct": True, "samples_per_s": 150000.0,
                   "flush_ms": pytest.approx(100.0),
                   "max_lag_s": extra.get("max_lag_s"),
                   "sent_lines": extra.get("sent_lines"),
                   "bridge": extra.get("bridge"),
                   "checks": {"unsettled": (0, 0)}}
    assert list(got) == KEYS
