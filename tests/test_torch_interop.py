"""veneur_tpu_torch.interop: bank state handed from the JAX package to
the port (CPU).

A JAX engine's banks, fetched as numpy leaves, become the port's banks
bit for bit and go back unchanged; a port engine flushing those banks
matches the JAX engine's flush of the same state at the contract levels
of test_torch_engine (exact names, tags, types, counts, min, max,
counters and gauges; percentiles within 1% of the key's spread; set
estimates within rtol 1e-5).
"""

import numpy as np
import pytest

from veneur_tpu.ingest.parser import parse_packet as j_parse
from veneur_tpu.models import pipeline as jpipe
from veneur_tpu_torch import interop
from veneur_tpu_torch.ingest.parser import parse_packet as t_parse
from veneur_tpu_torch.models import pipeline as tpipe

CFG = dict(histogram_slots=32, counter_slots=16, gauge_slots=16,
           set_slots=4, buffer_depth=32, batch_size=128,
           flush_incremental=False)


def _stream():
    rng = np.random.default_rng(21)
    out = []
    for i in range(600):
        k = int(rng.integers(0, 6))
        out.append([f"lat.{k}:{rng.lognormal(2, 1):.3f}|ms|#k:{k}",
                    f"hits.{k}:{int(rng.integers(1, 5))}|c",
                    f"temp.{k}:{rng.normal(0, 5):.2f}|g",
                    f"users:{int(rng.integers(0, 200))}|s"][i % 4])
    return [ln.encode() for ln in out]


def _jax_leaves(eng):
    banks = {"histo": eng.histo_bank, "counter": eng.counter_bank,
             "gauge": eng.gauge_bank, "set": eng.set_bank}
    return {kind: {f: np.asarray(getattr(b, f)) for f in b._fields}
            for kind, b in banks.items()}


@pytest.fixture(scope="module")
def engines():
    jeng = jpipe.AggregationEngine(jpipe.EngineConfig(**CFG))
    teng = tpipe.AggregationEngine(tpipe.EngineConfig(**CFG), device="cpu")
    for ln in _stream():
        jeng.process(j_parse(ln))
        teng.process(t_parse(ln))   # the same keys in the same slots
    jeng.drain_all()
    teng.drain_all()
    return jeng, teng


def test_round_trip_is_bit_exact(engines):
    jeng, _ = engines
    leaves = _jax_leaves(jeng)
    back = interop.banks_to_numpy(
        interop.banks_from_jax_numpy(leaves, "cpu"))
    assert back.keys() == leaves.keys()
    for kind in leaves:
        assert back[kind].keys() == leaves[kind].keys()
        for name, a in leaves[kind].items():
            assert back[kind][name].dtype == a.dtype
            np.testing.assert_array_equal(back[kind][name], a,
                                          err_msg=f"{kind}.{name}")


def test_flush_of_jax_state_matches_jax_flush(engines):
    jeng, teng = engines
    (teng.histo_bank, teng.counter_bank, teng.gauge_bank,
     teng.set_bank) = interop.banks_from_jax_numpy(_jax_leaves(jeng), "cpu")
    jr = {(m.name, tuple(m.tags)): m for m in jeng.flush(5).metrics}
    tr = {(m.name, tuple(m.tags)): m for m in teng.flush(5).metrics}
    assert tr.keys() == jr.keys() and len(tr) > 20
    for key, m in tr.items():
        w = jr[key]
        assert m.type == w.type
        if m.name.endswith("percentile"):
            base = m.name.rsplit(".", 1)[0]
            spread = tr[(base + ".max", key[1])].value - \
                tr[(base + ".min", key[1])].value
            assert abs(m.value - w.value) <= 0.01 * spread + 1e-6
        elif m.name == "users":
            assert m.value == pytest.approx(w.value, rel=1e-5)
        else:
            assert m.value == w.value, key


@pytest.mark.parametrize("damage", ["missing", "dtype", "slots"])
def test_bad_leaves_are_refused(engines, damage):
    leaves = _jax_leaves(engines[0])
    h = dict(leaves["histo"])
    if damage == "missing":
        del h["recip_lo"]
    elif damage == "dtype":
        h["buf_n"] = h["buf_n"].astype(np.int64)
    else:
        h["vmin"] = h["vmin"][:-1]
    with pytest.raises(ValueError):
        interop.banks_from_jax_numpy({**leaves, "histo": h}, "cpu")
