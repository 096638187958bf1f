"""veneur_tpu_torch scatter helpers and scalar banks against veneur_tpu
(CPU).

Contract levels: the scatter helpers (sorted slots, permuted payloads,
ranks, run ends, per-slot counts) and the gauge bank (value and seq)
are exact; 2Sum counter totals read as f64(hi) + f64(lo) are exact for
integer-weighted streams and within rtol 1e-7 for fractional weights
(the port segment-sums each batch in float64, JAX in float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import scalar as jsc
from veneur_tpu.ops import scatter as jsx
from veneur_tpu_torch.ops import scalar as tsc
from veneur_tpu_torch.ops import scatter as tsx


def _slots(rng, n, K):
    s = rng.integers(-1, K, n).astype(np.int32)
    s[rng.random(n) < 0.05] = K + 3          # out-of-range ids drop too
    return s


@pytest.mark.parametrize("n,K", [(1, 4), (300, 7), (4096, 1000)])
def test_scatter_helpers_match_jax(n, K):
    rng = np.random.default_rng(n)
    slots = _slots(rng, n, K)
    vals = rng.normal(0, 1, n).astype(np.float32)
    seqs = np.arange(n, dtype=np.int32)
    js, jv, jq = jsx.sort_by_slot(jnp.asarray(slots), jnp.asarray(vals),
                                  jnp.asarray(seqs), num_slots=K)
    ts, tv, tq = tsx.sort_by_slot(torch.as_tensor(slots),
                                  torch.as_tensor(vals),
                                  torch.as_tensor(seqs), num_slots=K)
    for t, j in ((ts, js), (tv, jv), (tq, jq)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tsx.run_ranks(ts).numpy(),
                                  np.asarray(jsx.run_ranks(js)))
    np.testing.assert_array_equal(tsx.run_lasts(ts).numpy(),
                                  np.asarray(jsx.run_lasts(js)))
    # callers pass masks that exclude padding (`valid & ...`)
    mask = (rng.random(n) < 0.5) & (np.asarray(js) >= 0)
    np.testing.assert_array_equal(
        tsx.segment_count(ts, torch.as_tensor(mask), K).numpy(),
        np.asarray(jsx.segment_count(js, jnp.asarray(mask), K)))


def test_segment_count_wraps_negative_ids_as_jax_does():
    """With a mask that admits negative ids, the port's segment_count
    equals the JAX helper's: an id in [-K, -1] wraps onto id + K (slot
    -1 counts on slot K-1), and what is still outside [0, K) is dropped.
    No caller of either package passes such a mask."""
    K = 3
    slots = np.array([-1, 0, 2, -1, -3, -4, 3, 7, -1, 1], np.int32)
    mask = np.ones(len(slots), bool)
    mask[-2:] = False
    t = tsx.segment_count(torch.as_tensor(slots), torch.as_tensor(mask), K)
    j = jsx.segment_count(jnp.asarray(slots), jnp.asarray(mask), K)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(t.numpy(), [2, 0, 3])


def _totals_t(b):
    return b.hi.double().numpy() + b.lo.double().numpy()


def _totals_j(b):
    return (np.asarray(b.hi, np.float64) + np.asarray(b.lo, np.float64))


@pytest.mark.parametrize("rates", ["integer", "fractional"])
def test_counter_add_matches_jax(rates):
    """Ten batches into 64 counters, enough to carry past 2^24 on a hot
    slot so the 2Sum lo term is live; each batch's per-slot sum stays
    below 2^24, where the JAX package's float32 delta is exact."""
    rng = np.random.default_rng(5)
    K, n = 64, 2048
    jb, tb = jsc.init_counters(K), tsc.init_counters(K, "cpu")
    for i in range(10):
        slots = _slots(rng, n, K)
        slots[:64] = 9
        vals = rng.integers(1, 50, n).astype(np.float32)
        vals[:64] = 2 ** 14
        w = rng.choice([1.0, 2.0, 10 / 3 if rates == "fractional" else 4.0],
                       n).astype(np.float32)
        jb = jsc.counter_add(jb, jnp.asarray(slots), jnp.asarray(vals),
                             jnp.asarray(w))
        tb = tsc.counter_add(tb, torch.as_tensor(slots),
                             torch.as_tensor(vals), torch.as_tensor(w))
    assert _totals_t(tb)[9] > 2 ** 24
    if rates == "integer":
        np.testing.assert_array_equal(_totals_t(tb), _totals_j(jb))
    else:
        np.testing.assert_allclose(_totals_t(tb), _totals_j(jb), rtol=1e-7)


def test_gauge_set_matches_jax():
    """Last write wins within a batch (max seq per slot) and across
    batches (the stored seq arbitrates, so a stale batch loses)."""
    rng = np.random.default_rng(6)
    K, n = 32, 512
    jb, tb = jsc.init_gauges(K), tsc.init_gauges(K, "cpu")
    seq0 = 1000
    for i in range(4):
        slots = _slots(rng, n, K)
        vals = rng.normal(0, 10, n).astype(np.float32)
        base = seq0 - 600 if i == 2 else seq0 + 600 * i
        seqs = (base + np.arange(n)).astype(np.int32)
        jb = jsc.gauge_set(jb, jnp.asarray(slots), jnp.asarray(vals),
                           jnp.asarray(seqs))
        tb = tsc.gauge_set(tb, torch.as_tensor(slots), torch.as_tensor(vals),
                           torch.as_tensor(seqs))
        np.testing.assert_array_equal(tb.value.numpy(), np.asarray(jb.value))
        np.testing.assert_array_equal(tb.seq.numpy(), np.asarray(jb.seq))
    assert (tb.seq.numpy() >= -1).all() and (tb.seq.numpy() > 0).any()


def test_counter_batch_delta_past_2_24_stays_exact():
    """A divergence, recorded in ROADMAP section C: when ONE batch puts
    more than 2^24 on a slot, the JAX package's float32 scatter-add
    delta rounds, while the port's float64 segment sum is exact."""
    n = 4096
    slots = np.zeros(n, np.int32)
    vals = np.full(n, 2 ** 13 + 1, np.float32)
    w = np.ones(n, np.float32)
    want = float(n * (2 ** 13 + 1))
    assert want > 2 ** 24
    tb = tsc.counter_add(tsc.init_counters(2, "cpu"),
                         *(torch.as_tensor(a) for a in (slots, vals, w)))
    jb = jsc.counter_add(jsc.init_counters(2),
                         *(jnp.asarray(a) for a in (slots, vals, w)))
    assert _totals_t(tb)[0] == want
    assert _totals_j(jb)[0] != want
