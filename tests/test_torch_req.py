"""veneur_tpu_torch's REQ engine against veneur_tpu's (CPU).

The same seeded batches go into both packages. Contract levels:

  * exact: the per-level fills `n`, the compaction counter `ncomp`,
    `weight` under integer weights (pair sums of small integers), count
    and min/max;
  * `value` within rtol 1e-5: the geometric-mean survivors go through
    log/exp, which differ by ulps between XLA-CPU and torch-CPU;
  * quantiles within rtol 1e-4: those ulps, plus the order of the
    cumulative sums (ROADMAP "Comparison contract");
  * vsum within rtol 1e-6 (the port segment-sums a batch in float64,
    JAX in float32).

The JAX package's own REQ contract (tests/test_sketches.py) also holds on
the port: p99.9 within 1.5% on a pareto stream, p50 within 1% on a
compact one, count conserved through every compaction.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.sketches import req as jreq
from veneur_tpu_torch.sketches import req as treq

QS = np.array([0.01, 0.1, 0.5, 0.9, 0.99, 0.999], np.float32)


@functools.lru_cache(maxsize=None)
def _jit(eng, name):
    return jax.jit(getattr(eng, name))


def _batches(seed, K, n_batches, width=512):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        slots = rng.integers(-1, K, width).astype(np.int32)
        v = rng.lognormal(0, 2, width).astype(np.float32)
        v[::7] = -v[::7]                       # non-positive values too
        v[3] = -0.0
        w = rng.choice([1.0, 2.0, 8.0], width).astype(np.float32)
        out.append((slots, v, w))
    return out


def _both(seed, K=5, levels=2, capacity=64, n_batches=20):
    jeng = jreq.REQEngine(levels=levels, capacity=capacity)
    teng = treq.REQEngine(levels=levels, capacity=capacity)
    jb, tb = jeng.init(K), teng.init(K, "cpu")
    add = _jit(jeng, "add_batch_impl")
    for s, v, w in _batches(seed, K, n_batches):
        jb = add(jb, jnp.asarray(s), jnp.asarray(v), jnp.asarray(w))
        tb = teng.add_batch(tb, torch.as_tensor(s), torch.as_tensor(v),
                            torch.as_tensor(w))
    return jeng, teng, jb, tb


def _assert_state_matches(jb, tb):
    j = {f: np.asarray(getattr(jb, f)) for f in jb._fields}
    t = {f: getattr(tb, f).numpy() for f in tb._fields}
    for f in ("n", "ncomp", "weight", "count", "count_lo", "vmin", "vmax"):
        assert t[f].dtype == j[f].dtype, f
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)
    np.testing.assert_allclose(t["value"], j["value"], rtol=1e-5)
    np.testing.assert_allclose(
        t["vsum"].astype(np.float64) + t["vsum_lo"],
        j["vsum"].astype(np.float64) + j["vsum_lo"], rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_bank_state_matches_jax(seed):
    """20 batches of 512 over 5 slots at capacity 64: the overflow loop
    and compactions on both levels run many times."""
    jeng, teng, jb, tb = _both(seed)
    assert int(tb.ncomp.sum()) > 20 and int(tb.n[:, 1].min()) > 0
    _assert_state_matches(jb, tb)
    jb = _jit(jeng, "compress_impl")(jb)
    tb = teng.compress(tb)
    _assert_state_matches(jb, tb)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantiles_match_jax(seed):
    jeng, teng, jb, tb = _both(seed)
    jq = np.asarray(_jit(jeng, "quantile_impl")(jb, jnp.asarray(QS)))
    tq = teng.quantile(tb, torch.as_tensor(QS)).numpy()
    np.testing.assert_allclose(tq, jq, rtol=1e-4)


def test_positive_rows_interpolate_in_log_space():
    """Knots at hazen mid-points 1/6, 1/2, 5/6 over 1, 100, 10000: q=0.25
    lies a quarter of the way from 1 to 100 in log space."""
    eng = treq.REQEngine(levels=2, capacity=64)
    b = eng.add_batch(eng.init(2, "cpu"),
                      torch.zeros(3, dtype=torch.int32),
                      torch.tensor([1.0, 100.0, 10000.0]), torch.ones(3))
    q = eng.quantile(b, torch.tensor([0.5, 0.25])).numpy()
    assert q[0, 0] == pytest.approx(100.0, rel=1e-6)
    assert q[0, 1] == pytest.approx(100.0 ** 0.25, rel=1e-6)
    assert q[1].tolist() == [0.0, 0.0]            # an empty row


def test_merge_centroids_matches_jax():
    """The item path without scalars (the hot-slot sidestep's landing)."""
    jeng = jreq.REQEngine(levels=2, capacity=64)
    teng = treq.REQEngine(levels=2, capacity=64)
    jb, tb = jeng.init(4), teng.init(4, "cpu")
    rng = np.random.default_rng(9)
    for _ in range(6):
        s = rng.integers(-1, 4, 300).astype(np.int32)
        v = rng.normal(100, 20, 300).astype(np.float32)
        w = rng.choice([0.0, 1.0, 3.0], 300).astype(np.float32)
        jb = jeng.merge_centroids(jb, jnp.asarray(s), jnp.asarray(v),
                                  jnp.asarray(w))
        tb = teng.merge_centroids(tb, torch.as_tensor(s),
                                  torch.as_tensor(v), torch.as_tensor(w))
    _assert_state_matches(jb, tb)


def test_merge_banks_bit_commutative_and_matches_jax():
    jeng, teng, ja, ta = _both(3, K=3, n_batches=8)
    _, _, jb, tb = _both(4, K=3, n_batches=8)
    ab, ba = teng.merge_banks(ta, tb), teng.merge_banks(tb, ta)
    for f in ab._fields:
        x, y = getattr(ab, f).numpy(), getattr(ba, f).numpy()
        assert x.tobytes() == y.tobytes(), f
    _assert_state_matches(jeng.merge_banks(ja, jb), ab)


def test_fresh_rows_are_a_compress_fixed_point():
    eng = treq.REQEngine(levels=2, capacity=32)
    fresh = eng.init(3, "cpu")
    out = eng.compress(fresh)
    for f in fresh._fields:
        assert torch.equal(getattr(out, f), getattr(fresh, f)), f
    assert eng.quantile(out, torch.tensor([0.5])).abs().sum() == 0.0


def _fill(eng, streams, batch=8192):
    bank = eng.init(len(streams), "cpu")
    for s, vals in streams.items():
        vals = vals.astype(np.float32)
        for i in range(0, len(vals), batch):
            chunk = torch.as_tensor(vals[i:i + batch])
            bank = eng.add_batch(
                bank, torch.full((len(chunk),), s, dtype=torch.int32),
                chunk, torch.ones(len(chunk)))
    return bank


def test_req_contract_on_the_port():
    rng = np.random.default_rng(11)
    n = 50_000
    streams = {0: rng.normal(1000, 10, n),                    # compact
               1: (1.0 / (1.0 - rng.uniform(0, 1, n))) ** (1 / 1.5)}
    eng = treq.REQEngine()
    bank = _fill(eng, streams)
    q = eng.quantile(bank, torch.tensor([0.5, 0.999])).numpy()
    for s, vals in streams.items():
        exact = np.percentile(vals.astype(np.float64), [50, 99.9])
        assert abs(q[s, 1] - exact[1]) / abs(exact[1]) <= 0.015
    exact50 = np.percentile(streams[0], 50)
    assert abs(q[0, 0] - exact50) / exact50 <= 0.01
    cnt = bank.count.double() + bank.count_lo.double()
    assert cnt[:2].tolist() == [n, n]
    np.testing.assert_allclose(bank.weight.double().sum(1)[:2].numpy(),
                               [n, n], rtol=1e-6)


def test_bank_init_and_state_bytes_match_jax():
    j, t = jreq.REQEngine(), treq.REQEngine()
    assert t.state_bytes(7) == j.state_bytes(7)
    jb, tb = j.init(3), t.init(3, "cpu")
    assert tb._fields == jb._fields
    for f in tb._fields:
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)
