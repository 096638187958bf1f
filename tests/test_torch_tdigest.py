"""veneur_tpu_torch.ops.tdigest against veneur_tpu.ops.tdigest (CPU).

Inputs are made from a seed with numpy and handed to both packages.
Contract levels:

  * exact: canonical sort keys, the stable buffer permutation, the
    merged concatenation-order tags, buf_n, sample buffers, count, min
    and max;
  * contract: compressed centroids are compared through quantiles,
    within 1% of each row's spread (the accuracy contract the JAX
    package's own t-digest tests pin against numpy and the Go-algorithm
    oracle), total centroid weight per row within rtol 1e-6 (the port
    sums in float64, JAX's cumsum in float32), and the weighted sums
    (vsum, recip) within rtol 1e-6 (the port segment-sums a batch in
    float64, JAX in float32);
  * the SR02 ordering invariant (positive weights a prefix, their means
    non-decreasing) holds exactly on the port's output.

The JAX side runs its XLA compress (`_compress_impl`), which the JAX
package's own tests pin bit for bit to its Pallas kernel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import tdigest as jtd
from veneur_tpu_torch import kernels
from veneur_tpu_torch.kernels import compress as kc
from veneur_tpu_torch.ops import tdigest as ttd

COMP = 100.0
QS = np.array([0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99], np.float32)


def _mk_inputs(seed, K=37, B=256, adversarial=False):
    """(mean, weight, buf_value, buf_weight) numpy rows: a legal
    cluster-ordered prefix built by the JAX compress itself, then a
    refilled buffer (the JAX package's _mk_bank recipe)."""
    rng = np.random.default_rng(seed)
    bank = jtd.init(K, COMP, B)
    slots = rng.integers(0, K, 4096).astype(np.int32)
    vals = rng.lognormal(3, 1, 4096).astype(np.float32)
    bank = jtd.add_batch(bank, jnp.asarray(slots), jnp.asarray(vals),
                         jnp.ones(4096, jnp.float32), compression=COMP)
    bank = jtd.compress(bank, compression=COMP)
    mean = np.array(bank.mean)
    weight = np.array(bank.weight)
    bv = rng.normal(20, 30, (K, B)).astype(np.float32)
    bw = (np.abs(rng.normal(1, 0.5, (K, B))) + 0.01).astype(np.float32)
    if adversarial:
        bv[:, 0] = -0.0                     # signed-zero key folding
        bv[:, 1] = 0.0
        bv[:, 2] = bv[:, 3]                 # duplicate values
        bv[:, 5] = mean[:, 0]               # duplicates of prefix means
        bv[0, 4] = np.frombuffer(np.uint32(0x7FC01234).tobytes(),
                                 np.float32)[0]   # NaN with a payload
        bw[2, 100:] = 0.0                   # zero-weight buffer tail
        bw[3, :] = 0.0                      # empty buffer, live prefix
        mean[4], weight[4], bw[4] = 0.0, 0.0, 0.0   # fully empty row
    return mean, weight, bv, bw


def _jax_compress(mean, weight, bv, bw):
    K, B = bv.shape
    bank = jtd.init(K, COMP, B)._replace(
        mean=jnp.asarray(mean), weight=jnp.asarray(weight),
        buf_value=jnp.asarray(bv), buf_weight=jnp.asarray(bw),
        buf_n=jnp.full((K,), B, jnp.int32))
    out = jax.jit(functools.partial(jtd._compress_impl,
                                    compression=COMP))(bank)
    return np.asarray(out.mean), np.asarray(out.weight)


def _torch(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _row_extremes(mean, weight, bv, bw):
    vals = np.concatenate([mean, bv], axis=1).astype(np.float64)
    live = np.concatenate([weight, bw], axis=1) > 0
    vmin = np.where(live, vals, np.inf).min(axis=1)
    vmax = np.where(live, vals, -np.inf).max(axis=1)
    return vmin.astype(np.float32), vmax.astype(np.float32)


def _quantiles_np(mean, weight, vmin, vmax, jax_side):
    """Quantiles of compressed rows through either package's quantile."""
    K, C = mean.shape
    if jax_side:
        bank = jtd.init(K, COMP, 8)._replace(
            mean=jnp.asarray(mean), weight=jnp.asarray(weight),
            vmin=jnp.asarray(vmin), vmax=jnp.asarray(vmax))
        return np.asarray(jtd.quantile(bank, QS))
    bank = ttd.init(K, COMP, 8, device="cpu")._replace(
        mean=torch.tensor(mean), weight=torch.tensor(weight),
        vmin=torch.tensor(vmin), vmax=torch.tensor(vmax))
    return ttd.quantile(bank, torch.as_tensor(QS)).numpy()


def assert_sr02(mean, weight, skip=()):
    for r in range(mean.shape[0]):
        if r in skip:
            continue
        pos = weight[r] > 0
        n = int(pos.sum())
        assert pos[:n].all() and not pos[n:].any(), f"row {r}: gaps"
        assert (np.diff(mean[r, :n]) >= 0).all(), f"row {r}: order"


def assert_compress_contract(inputs, got, want, nan_rows=()):
    mean, weight, bv, bw = inputs
    gm, gw = got
    wm, ww = want
    keep = [r for r in range(mean.shape[0]) if r not in nan_rows]
    # total centroid weight per row: rtol 1e-6
    np.testing.assert_allclose(gw.astype(np.float64).sum(1),
                               ww.astype(np.float64).sum(1), rtol=1e-6)
    np.testing.assert_allclose(
        gw.astype(np.float64).sum(1),
        weight.astype(np.float64).sum(1) + bw.astype(np.float64).sum(1),
        rtol=1e-6)
    # quantiles: within 1% of each row's spread
    vmin, vmax = _row_extremes(mean, weight, bv, bw)
    qg = _quantiles_np(gm[keep], gw[keep], vmin[keep], vmax[keep], False)
    qw = _quantiles_np(wm[keep], ww[keep], vmin[keep], vmax[keep], True)
    spread = np.where(np.isfinite(vmax - vmin), vmax - vmin, 0)[keep]
    np.testing.assert_allclose(qg, qw, rtol=0,
                               atol=1e-4 + 0.01 * spread.max())
    assert (np.abs(qg - qw) <= 1e-4 + 0.01 * spread[:, None]).all()
    assert_sr02(gm, gw, skip=nan_rows)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_plain_matches_jax(seed):
    inputs = _mk_inputs(seed, adversarial=(seed == 0))
    got = kc.compress_plain(*_torch(*inputs), COMP)
    got = tuple(t.numpy() for t in got)
    want = _jax_compress(*inputs)
    nan_rows = (0,) if seed == 0 else ()
    assert_compress_contract(inputs, got, want, nan_rows)
    if seed == 0:
        # the NaN payload poisons its row in both packages; the fully
        # empty row is a fixed point
        assert np.isnan(got[0][0]).any() and np.isnan(want[0][0]).any()
        assert not got[1][4].any() and not got[0][4].any()


def test_compress_cluster_overflow_clip():
    """More natural clusters than centroid lanes (C=64 << 2*delta): the
    greedy ids run past C and both packages clip them onto lane C-1."""
    rng = np.random.default_rng(9)
    K, C, B = 5, 64, 512
    mean = np.zeros((K, C), np.float32)
    weight = np.zeros((K, C), np.float32)
    bv = np.sort(rng.normal(0, 100, (K, B))).astype(np.float32)
    bw = np.ones((K, B), np.float32)
    got = tuple(t.numpy() for t in kc.compress_plain(
        *_torch(mean, weight, bv, bw), COMP))
    rm, rw = jax.jit(lambda v, w: jtd._cluster_core(
        v, w, COMP, C, sorted_prefix=C))(
            jnp.concatenate([mean, bv], 1), jnp.concatenate([weight, bw], 1))
    assert float(got[1][:, -1].min()) > 1.0 and float(rw[:, -1].min()) > 1.0
    np.testing.assert_allclose(got[1].sum(1), np.asarray(rw).sum(1),
                               rtol=1e-6)
    assert_sr02(*got)


def test_sort_and_merge_pieces_are_exact():
    """Canonical keys, the stable buffer permutation and the merged
    tags are integer state: equal to the JAX package's bit for bit,
    including +-0.0, duplicates and the NaN payload."""
    mean, weight, bv, bw = _mk_inputs(0, adversarial=True)
    K, C = mean.shape
    vals = np.concatenate([mean, bv], 1)
    wts = np.concatenate([weight, bw], 1)
    vals = np.where(wts > 0, vals, np.float32(np.inf)).astype(np.float32)
    jk = np.asarray(jax.jit(jtd._canonical_sort_key)(jnp.asarray(vals)))
    tk = ttd._canonical_sort_key(torch.as_tensor(vals)).numpy()
    np.testing.assert_array_equal(tk.astype(np.uint32), jk)
    jsk, jperm = jax.jit(jtd._stable_sort_perm)(jnp.asarray(jk[:, C:]))
    tsk, tperm = ttd._stable_sort_perm(torch.as_tensor(tk[:, C:]))
    np.testing.assert_array_equal(tsk.numpy().astype(np.uint32),
                                  np.asarray(jsk))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    M = vals.shape[1]
    jt = jax.jit(jtd._merge_sorted_runs, static_argnums=(2, 3))(
        jnp.asarray(jk[:, :C]), jsk, C, M)
    tt = ttd._merge_sorted_runs(torch.as_tensor(tk[:, :C]), tsk, C, M)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _blocked_cumsum_np(x, chunk):
    """numpy reproduction of the documented blocked order, one row and
    one scalar addition at a time: sequential sums inside chunks of
    `chunk` lanes, a sequential scan of the chunk totals, then each
    lane's chunk offset added to its local sum."""
    M = x.shape[0]
    local = np.empty(M, np.float64)
    offs = []
    off = np.float64(0.0)
    for lo in range(0, M, chunk):
        run = np.float64(0.0)
        for i in range(lo, min(lo + chunk, M)):
            run = run + x[i]
            local[i] = run
        offs.append(off)
        off = off + run
    return np.array([offs[i // chunk] + local[i] for i in range(M)])


@pytest.mark.parametrize("C,B", [(256, 256), (64, 512), (128, 172)])
def test_cluster_tail_sums_follow_the_blocked_order(C, B, monkeypatch):
    """The float64 cumulative weights and weighted values of
    `_cluster_tail` equal, bit for bit, a numpy reproduction of the
    blocked order that the compress kernel also follows: M = 512, the
    C=64/B=512 overflow clip (M = 576), and M = 300, whose last chunk is
    ragged."""
    rng = np.random.default_rng(C + B)
    K, M = 4, C + B
    wts = (np.abs(rng.normal(1, 0.5, (K, M))) + 0.01).astype(np.float32)
    wts[:, M - 40:] = 0.0                      # empty lanes at the tail
    wts[1, 7] = 3e7                            # a sum past 2^24
    vals = np.sort(rng.lognormal(3, 2, (K, M)), axis=1).astype(np.float32)
    vals = np.where(wts > 0, vals, np.float32(np.inf))
    seen = []
    real = ttd._blocked_cumsum

    def spy(x):
        out = real(x)
        seen.append((x.clone(), out.clone()))
        return out

    monkeypatch.setattr(ttd, "_blocked_cumsum", spy)
    ttd._cluster_tail(torch.as_tensor(vals), torch.as_tensor(wts), COMP, C)
    (terms, sums), = seen
    assert terms.shape == (K, 2, M) and terms.dtype == torch.float64
    w64 = wts.astype(np.float64)
    np.testing.assert_array_equal(terms[:, 0].numpy(), w64)
    np.testing.assert_array_equal(
        terms[:, 1].numpy(),
        w64 * np.where(wts > 0, vals, 0).astype(np.float64))
    for r in range(K):
        for a in range(2):
            want = _blocked_cumsum_np(terms[r, a].numpy(), ttd.SUM_CHUNK)
            got = sums[r, a].numpy()
            assert got.tobytes() == want.tobytes(), (r, a)
            # non-decreasing for non-negative terms
            if a == 0:
                assert (np.diff(got) >= 0).all()


def _ballot_boundaries(kl, kr, live):
    """A model of the compress kernel's greedy recurrence, one row, in
    its two steps.

    1. Per 32-lane window, with no k_start: each live lane j links to
       the lowest live lane i > j of the window with kr[i] - kl[j] > 1
       (the shuffle search), and five rounds of pointer doubling turn the
       links into the bit mask of the chain j, link(j), link(link(j)), ...
    2. One warp walks the windows carrying ks: the lowest live lane with
       kr - ks > 1 in the window's ballot is its first boundary, that
       lane's chain mask is the window's boundaries, and ks becomes kl at
       the mask's highest lane."""
    M = kl.shape[0]
    f32 = np.float32
    out = np.zeros(M, bool)
    ks = f32(kl[0]) - f32(2.0)
    for base in range(0, M, 32):
        n = min(32, M - base)
        lv = [bool(live[base + j]) for j in range(n)] + [False] * (32 - n)
        link = [32] * 32
        for j in range(n):
            if lv[j]:
                link[j] = next((i for i in range(j + 1, n) if lv[i]
                                and f32(kr[base + i]) - f32(kl[base + j])
                                > f32(1.0)), 32)
        mask = [(1 << j) if lv[j] else 0 for j in range(32)]
        p = [link[j] if lv[j] else 32 for j in range(32)]
        for _ in range(5):                       # all lanes at once
            mask, p = ([m | mask[q] if q < 32 else m
                        for m, q in zip(mask, p)],
                       [p[q] if q < 32 else q for q in p])
        first = [j for j in range(n)
                 if lv[j] and f32(kr[base + j]) - ks > f32(1.0)]
        if first:
            found = mask[first[0]]
            for j in range(32):
                if found >> j & 1:
                    out[base + j] = True
            ks = f32(kl[base + found.bit_length() - 1])
    return out


def test_ballot_recurrence_model_matches_the_sequential_one():
    """The kernel's window chains and ballots give the same boundaries as
    the sequential recurrence of `_cluster_tail` on rows where the
    shortcut assumptions would fail: k1 rows of a real sorted buffer,
    rows whose kr is non-monotone by hand, and rows with dead lanes in
    the middle."""
    rng = np.random.default_rng(11)
    K, M = 12, 300
    rows_kl, rows_kr, rows_live = [], [], []
    for r in range(K):
        w = (np.abs(rng.normal(1, 0.5, M)) + 0.01)
        if r % 3 == 2:
            w[rng.random(M) < 0.3] = 0.0       # dead lanes in the middle
        cum = np.cumsum(w)
        q = cum / cum[-1]
        kr = COMP * (np.arcsin(2 * q - 1) + np.pi / 2) / np.pi
        kl = COMP * (np.arcsin(2 * (cum - w) / cum[-1] - 1) + np.pi / 2) \
            / np.pi
        if r % 3 == 1:                          # non-monotone kr
            kr = kr + rng.normal(0, 3, M)
            kr[::17] -= 50.0
        rows_kl.append(kl.astype(np.float32))
        rows_kr.append(kr.astype(np.float32))
        rows_live.append(w > 0)
    kl, kr, live = (np.stack(a) for a in (rows_kl, rows_kr, rows_live))
    seq = ttd._greedy_boundaries(torch.as_tensor(kl), torch.as_tensor(kr),
                                 torch.as_tensor(live)).numpy()
    for r in range(K):
        np.testing.assert_array_equal(
            _ballot_boundaries(kl[r], kr[r], live[r]), seq[r],
            err_msg=f"row {r}")
    assert seq.sum(1).min() > 10


def test_compress_wrapper_on_cpu_runs_plain_and_counts_nothing():
    kernels.reset_launches()
    inputs = _torch(*_mk_inputs(1))
    got = kc.fused_compress(*inputs, COMP)
    want = kc.compress_plain(*inputs, COMP)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(n == 0 for n in kernels.launches.values())


def _fresh_pair(K, B):
    return jtd.init(K, COMP, B), ttd.init(K, COMP, B, device="cpu")


def _add_both(jb, tb, slots, vals, wts):
    jb = jtd.add_batch(jb, jnp.asarray(slots), jnp.asarray(vals),
                       jnp.asarray(wts), compression=COMP)
    tb = ttd._add_batch_impl(tb, *_torch(slots, vals, wts), COMP)
    return jb, tb


def _assert_banks_match(jb, tb, exact_count=True):
    for name in ("buf_n", "buf_value", "buf_weight", "vmin", "vmax"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    for hi, lo in (("count", "count_lo"), ("vsum", "vsum_lo"),
                   ("recip", "recip_lo")):
        t = getattr(tb, hi).double() + getattr(tb, lo).double()
        j = (np.asarray(getattr(jb, hi), np.float64)
             + np.asarray(getattr(jb, lo), np.float64))
        if hi == "count" and exact_count:
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-6)


@pytest.mark.parametrize("hot,rates", [(False, "integer"),
                                       (True, "integer"),
                                       (True, "fractional")])
def test_add_batch_matches_jax(hot, rates):
    """The fast path (no buffer overflows) and the overflow loop (one
    slot takes 7x its buffer depth in one batch: six compress passes).
    Counts are exact for integer weights; a 0.3 sample rate's weight
    10/3 is summed in float64 by the port and float32 by JAX."""
    rng = np.random.default_rng(3)
    K, B, n = 16, 32, 512
    jb, tb = _fresh_pair(K, B)
    for _ in range(3):
        slots = rng.integers(-1, K, n).astype(np.int32)
        if hot:
            slots[: 7 * B] = 5
            rng.shuffle(slots)
        else:
            slots = np.where(rng.random(n) < 0.05, slots,
                             -1).astype(np.int32)
        vals = rng.gamma(2, 20, n).astype(np.float32)
        wts = rng.choice([1.0, 2.0, 10 / 3 if rates == "fractional"
                          else 4.0], n).astype(np.float32)
        jb, tb = _add_both(jb, tb, slots, vals, wts)
        _assert_banks_match(jb, tb, exact_count=(rates == "integer"))
    inputs = (np.asarray(jb.mean), np.asarray(jb.weight),
              np.asarray(jb.buf_value), np.asarray(jb.buf_weight))
    jc = jtd.compress(jb, compression=COMP)
    tc = ttd._compress_impl(tb, COMP)
    assert_compress_contract(
        inputs,
        (tc.mean.numpy(), tc.weight.numpy()),
        (np.asarray(jc.mean), np.asarray(jc.weight)))
    assert int(tc.buf_n.sum()) == 0 and float(tc.buf_weight.sum()) == 0.0


def test_merge_centroids_and_scalars_match_jax():
    rng = np.random.default_rng(4)
    K, B, n = 8, 32, 64
    jb, tb = _fresh_pair(K, B)
    slots = rng.integers(-1, K, n).astype(np.int32)
    means = np.sort(rng.normal(10, 3, n)).astype(np.float32)
    wts = rng.choice([0.0, 1.0, 3.0], n).astype(np.float32)
    jb = jtd.merge_centroids(jb, jnp.asarray(slots), jnp.asarray(means),
                             jnp.asarray(wts))
    tb = ttd.merge_centroids(tb, *_torch(slots, means, wts))
    s = np.array([1, 3, -1, 3], np.int32)
    mn = np.array([0.5, -2.0, 9.0, 1.0], np.float32)
    mx = np.array([20.0, 4.0, 9.0, 30.0], np.float32)
    sm = np.array([100.0, 7.0, 1.0, 3.0], np.float32)
    ct = np.array([10.0, 2.0, 1.0, 1.0], np.float32)
    rc = np.array([0.4, 0.1, 0.0, 0.2], np.float32)
    jb = jtd.merge_scalars(jb, *(jnp.asarray(a)
                                 for a in (s, mn, mx, sm, ct, rc)))
    tb = ttd.merge_scalars(tb, *_torch(s, mn, mx, sm, ct, rc))
    _assert_banks_match(jb, tb)


def test_quantile_and_aggregates_match_jax():
    """On the same compressed state the flush's quantile ops agree
    within rtol 1e-4 (the float32 cumsum of the centroid weights runs in
    another order in each package, which moves a knot's quantile by
    ulps of the row total) and the aggregates bit for bit."""
    inputs = _mk_inputs(5)
    wm, ww = _jax_compress(*inputs)
    vmin, vmax = _row_extremes(*inputs)
    qj = _quantiles_np(wm, ww, vmin, vmax, True)
    qt = _quantiles_np(wm, ww, vmin, vmax, False)
    np.testing.assert_allclose(qt, qj, rtol=1e-4, atol=1e-3)
    K = wm.shape[0]
    rng = np.random.default_rng(5)
    leaves = {k: rng.normal(50, 10, K).astype(np.float32)
              for k in ("vsum", "count", "recip")}
    leaves["count"][0] = 0.0
    leaves.update(vsum_lo=np.zeros(K, np.float32),
                  count_lo=np.zeros(K, np.float32),
                  recip_lo=np.zeros(K, np.float32), vmin=vmin, vmax=vmax)
    aj = jtd.aggregates(jtd.init(K, COMP, 8)._replace(
        **{k: jnp.asarray(v) for k, v in leaves.items()}))
    at = ttd.aggregates(ttd.init(K, COMP, 8, device="cpu")._replace(
        **{k: torch.tensor(v) for k, v in leaves.items()}))
    for k in ("min", "max", "sum", "count", "avg", "hmean"):
        np.testing.assert_array_equal(at[k].numpy(), np.asarray(aj[k]),
                                      err_msg=k)
