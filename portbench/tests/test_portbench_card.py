"""A short run of every cell on the card, through the command the
driver runs, and the same command refused without one."""

import json
import subprocess
import sys

import pytest

from portbench import run

BENCH = json.load(open(f"{run.ROOT}/BENCHMARK.json"))


def command(workload, seed, seconds, trace):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=run.ROOT, capture_output=True, text=True,
        timeout=600)


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_of_each_cell_is_correct(card, name):
    out = command(name, 2 ** 31 + 11, 6, 0)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


def test_without_a_card_the_run_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return
    out = command("local-native.steady", 1, 2, 0)
    assert out.returncode == 2 and out.stdout == ""
