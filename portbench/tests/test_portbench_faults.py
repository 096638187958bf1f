"""Whole runs on the CPU at a small size, past the harness's look for a
card: a sound run comes out correct, and one whose timed path is broken
underneath comes out not correct, for each fault the cell can have (a
step that leaves the state unchanged, half of each batch left out, an
answer altered where the flush produces it; one chip, so no exchange
between chips to leave out). The control, the reference in bfloat16 in
the port's place, comes out not correct too."""

import pytest

from portbench import control, run

SMALL = {
    "local-native.steady": {"timer": 300, "counter": 60, "gauge": 60,
                            "set": 20},
}


def cell_of(name):
    config, traffic = name.split(".")
    return run.cell_from_files(f"portbench/configs/{config}.json", traffic)


def small_cell(name):
    cell = cell_of(name)
    cell["config"]["server"].update(
        tpu_histogram_slots=1024, tpu_counter_slots=256,
        tpu_gauge_slots=256, tpu_set_slots=64)
    cell["config"]["interval_s"] = 1
    t = cell["traffic"]
    for kind, keys in SMALL[name].items():
        t["mix"][kind]["keys"] = keys
    t["rate_lines_per_s"] = 4000
    t["ramp_s"] = 1
    return cell


def run_small(name, seed=2 ** 31 + 3):
    import torch
    args = run.parse(["--workload", name, "--seed", str(seed),
                      "--seconds", "3"])
    return run.run_cell(small_cell(name), args, torch.device("cpu"))


def break_path(monkeypatch, fault):
    from veneur_tpu_torch.models.pipeline import AggregationEngine as E
    if fault == "unchanged":
        monkeypatch.setattr(E, "ingest_histo_batch",
                            lambda self, *a, **k: None)
    elif fault == "half":
        land = E.ingest_histo_batch

        def half_batch(self, slots, values, weights, count=None, mark=None):
            h = len(slots) // 2
            land(self, slots[:h], values[:h], weights[:h], mark=mark)

        monkeypatch.setattr(E, "ingest_histo_batch", half_batch)
    else:
        flush = E.flush

        def altered(self, *a, **k):
            res = flush(self, *a, **k)
            for names, _tags, values, _types in res.frame.blocks:
                mine = [i for i, n in enumerate(names)
                        if values.shape[1] > 1 and n[0].startswith("pb.")]
                if mine:
                    values[mine[0]] *= 1.25
                    break
            return res

        monkeypatch.setattr(E, "flush", altered)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_small_run_is_correct(name):
    rec = run_small(name)
    assert rec["correct"], (rec["checks"], rec["notes"])
    assert rec["failed"] == 0 and rec["attempted"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_broken_path_is_not_correct(monkeypatch, name, fault):
    break_path(monkeypatch, fault)
    rec = run_small(name)
    assert not rec["correct"], rec["checks"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_bfloat16_control_is_not_correct(name):
    v = control.local(small_cell(name), 5, 3.0)
    assert not v["correct"], v["checks"]
