"""The engine's set landing buffer (CPU): set updates appended at ingest
land in a few large inserts instead of one per batch.

One script of intervals goes through the port's engine, the JAX engine
and a reference that lands every batch on its own through the plain
insert (`_insert_impl` for ULL, `ops/hll.insert` for HLL), for both set
backends, at batch_size 256 (a buffer of 16 batches, 4096 updates):
appends that stop exactly at the capacity and one past it, a call larger
than the capacity, `process()` set samples mixed with
`ingest_set_batch`, `drain_all()`, a flush with a half-full buffer and a
double flush. Contract levels:

  * exact: the number of set inserts at ingest and in each flush, the
    retired set registers (byte for byte equal to the reference's), the
    flushed set estimates against the reference's estimate of its
    registers, and ULL estimates against the JAX engine's;
  * HLL estimates against the JAX engine's within rtol 1e-5 (JAX's exp2
    is inexact for integer exponents >= 13, as in test_torch_engine).
"""

import numpy as np
import pytest
import torch

from veneur_tpu.ingest.parser import MetricKey as JMetricKey
from veneur_tpu.ingest.parser import parse_packet as j_parse
from veneur_tpu.models import pipeline as jpipe
from veneur_tpu_torch.ingest.parser import MetricKey as TMetricKey
from veneur_tpu_torch.ingest.parser import parse_packet as t_parse
from veneur_tpu_torch.models import pipeline as tpipe
from veneur_tpu_torch.ops import hll
from veneur_tpu_torch.sketches import ull
from veneur_tpu_torch.utils.hashing import set_member_hash

B = 256
CAP = tpipe.SET_LANDING_BATCHES * B
CFG = dict(histogram_slots=16, counter_slots=8, gauge_slots=8, set_slots=8,
           buffer_depth=32, batch_size=B)
BULK_KEYS = 4


def _batch(rng, seng, k):
    """k bulk set updates: (key index, register index, value)."""
    h = rng.integers(0, 2 ** 64, k, dtype=np.uint64)
    idx, vals = seng.host_hash_to_updates(h)
    return rng.integers(0, BULK_KEYS, k), idx, vals


def _lines(rng, k):
    return [f"dg.s.{int(rng.integers(0, 3))}:m{int(rng.integers(0, 900))}|s"
            .encode() for _ in range(k)]


def _script(seng):
    """Intervals of ("batch", keys, idx, vals) / ("lines", [...]) /
    ("drain",) steps, with the set inserts each must make at ingest and
    in its flush."""
    rng = np.random.default_rng(17)

    def batches(n, size=B):
        return [("batch", *_batch(rng, seng, size)) for _ in range(n)]

    return {
        # 16 batches fill the buffer exactly: nothing lands until the flush
        "at_capacity": (batches(16), 0, 1),
        # one row past the capacity lands the full buffer first
        "one_past": (batches(16) + batches(1, 1), 1, 1),
        # a call larger than the whole buffer lands on its own
        "larger_than_capacity": (batches(3) + batches(1, 17 * B), 1, 1),
        # the stage dispatches 256 lines into the buffer twice; the fifth
        # batch after the second dispatch overflows it (3072 + 4 * 256 =
        # 4096); the flush lands the rest with the stage's 88 lines
        "mixed": ([("lines", _lines(rng, 300))] + batches(10)
                  + [("lines", _lines(rng, 300))] + batches(10), 1, 1),
        # drain_all lands the buffer and the stage; the flush lands nothing
        "drain_all": (batches(5) + [("lines", _lines(rng, 100)),
                                    ("drain",)], 1, 0),
        "half_full": (batches(8), 0, 1),
        "double_flush": ([], 0, 0),
    }


class _CountingSetEngine:
    """The set engine with its insert counted (and whether the engine's
    lock was held at each call)."""

    def __init__(self, seng, lock):
        self._seng, self._lock = seng, lock
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._seng, name)

    def insert(self, bank, slots, reg_idx, vals):
        self.calls.append(self._lock.locked())
        return self._seng.insert(bank, slots, reg_idx, vals)


def _plain_insert(seng, bank, slots, idx, vals):
    args = (torch.as_tensor(np.asarray(slots, np.int32)),
            torch.as_tensor(np.asarray(idx, np.int32)),
            torch.as_tensor(np.asarray(vals, np.uint8)))
    if seng.id == "ull":
        return ull._insert_impl(bank, *args)
    return hll.insert(bank, *args)


def _run(backend):
    cfg = dict(CFG, set_backend=backend)
    teng = tpipe.AggregationEngine(tpipe.EngineConfig(**cfg), device="cpu")
    jeng = jpipe.AggregationEngine(jpipe.EngineConfig(**cfg))
    seng = teng._seng
    counting = _CountingSetEngine(seng, teng.lock)
    teng._seng = counting
    retired = []
    flush_device = teng._flush_device

    def capture(snap, dirty=None):
        retired.append(snap[3].registers.clone())
        return flush_device(snap, dirty=dirty)

    teng._flush_device = capture
    bulk = [f"bulk.s.{i}" for i in range(BULK_KEYS)]
    out = {}
    for i, (name, (steps, want_ingest, want_flush)) in enumerate(
            _script(seng).items()):
        # the caller's own lookups, in each interval that has samples
        # (they mark the keys active for the flush)
        names = bulk if steps else []
        tslots = np.array([teng.set_keys.lookup(TMetricKey(n, "set", ""), 0)
                           for n in names], np.int32)
        jslots = np.array([jeng.set_keys.lookup(JMetricKey(n, "set", ""), 0)
                           for n in names], np.int32)
        ref = seng.init(CFG["set_slots"], "cpu")
        rec = {"want": (want_ingest, want_flush),
               "slot_of": {(n, ()): int(s) for n, s in zip(names, tslots)}}
        for step in steps:
            if step[0] == "batch":
                _, keys, idx, vals = step
                teng.ingest_set_batch(tslots[keys], idx, vals)
                jeng.ingest_set_batch(jslots[keys], idx, vals)
                ref = _plain_insert(seng, ref, tslots[keys], idx, vals)
            elif step[0] == "lines":
                upd = []
                for ln in step[1]:
                    tm = t_parse(ln)
                    teng.process(tm)
                    jeng.process(j_parse(ln))
                    slot = teng.set_keys.lookup(tm.key, tm.scope)
                    rec["slot_of"][(tm.key.name, ())] = slot
                    upd.append((slot, *seng.hash_update(
                        set_member_hash(str(tm.value)))))
                ref = _plain_insert(seng, ref, *zip(*upd))
            else:
                teng.drain_all()
                jeng.drain_all()
                rec["drained"] = (teng.set_bank.registers.clone(),
                                  teng._set_landing.n, teng._set_stage.n)
        rec["ingest"] = len(counting.calls)
        counting.calls.clear()
        tres = teng.flush(timestamp=100 + i)
        jres = jeng.flush(timestamp=100 + i)
        rec["flush"] = len(counting.calls)
        rec["flush_under_lock"] = sum(counting.calls)
        counting.calls.clear()
        rec["retired"], rec["ref"] = retired.pop(), ref.registers.clone()
        host = {k: v.numpy() for k, v in seng.estimate_device(ref).items()}
        seng.estimate_finalize(host)
        rec["ref_est"] = host["s_est"]
        rec["rows"] = {(m.name, tuple(m.tags)): m.value
                       for m in tres.metrics if m.name.startswith(
                           ("bulk.s.", "dg.s."))}
        rec["jax_rows"] = {(m.name, tuple(m.tags)): m.value
                           for m in jres.metrics if m.name.startswith(
                               ("bulk.s.", "dg.s."))}
        out[name] = rec
    return out


@pytest.fixture(scope="module", params=["ull", "hll"])
def landed(request):
    return request.param, _run(request.param)


INTERVALS = list(_script(ull.ULLEngine()).keys())


@pytest.mark.parametrize("interval", INTERVALS)
def test_set_inserts_per_interval(landed, interval):
    _, out = landed
    rec = out[interval]
    assert (rec["ingest"], rec["flush"]) == rec["want"]


@pytest.mark.parametrize("interval", INTERVALS)
def test_registers_equal_landing_batch_by_batch(landed, interval):
    """No update is lost or doubled: the retired registers equal the
    reference's, which landed every batch on its own."""
    _, out = landed
    rec = out[interval]
    assert torch.equal(rec["retired"], rec["ref"])
    if interval == "double_flush":
        assert int(rec["retired"].sum()) == 0


@pytest.mark.parametrize("interval", INTERVALS)
def test_flushed_set_rows_match_reference_and_jax(landed, interval):
    backend, out = landed
    rec = out[interval]
    rows, jrows = rec["rows"], rec["jax_rows"]
    assert rows.keys() == jrows.keys()
    if interval == "double_flush":
        assert not rows
        return
    assert len(rows) >= BULK_KEYS
    for key, v in rows.items():
        assert v == float(rec["ref_est"][rec["slot_of"][key]]), key
    for key, v in rows.items():
        if backend == "ull":
            assert v == jrows[key], key
        else:
            assert v == pytest.approx(jrows[key], rel=1e-5), key


def test_flush_lands_outside_the_lock(landed):
    """The flush's lock-held part only swaps the buffer; its landing
    runs after the lock is released."""
    _, out = landed
    assert sum(r["flush"] for r in out.values()) >= 5
    assert all(r["flush_under_lock"] == 0 for r in out.values())


def test_drain_all_lands_the_buffer(landed):
    _, out = landed
    regs, buffered, staged = out["drain_all"]["drained"]
    assert buffered == 0 and staged == 0
    assert torch.equal(regs, out["drain_all"]["ref"])


def test_buffer_capacity_is_sixteen_batches():
    eng = tpipe.AggregationEngine(tpipe.EngineConfig(**CFG), device="cpu")
    assert eng._set_landing.capacity == CAP == 16 * B
