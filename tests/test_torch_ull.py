"""veneur_tpu_torch's ULL engine and the ull_insert plain version against
veneur_tpu (CPU).

Contract level: exact throughout. Registers are u8 and the join is
integer arithmetic, so the plain insert must equal the JAX package's
`_insert_impl` and its Pallas kernel (`fused_insert`, interpret mode, as
the JAX package's own tests run it) byte for byte; the value histogram
is integer counts; `ml_estimate` is the same numpy code on the same
counts, so the estimate is the same number.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.kernels import ull_insert as j_kinsert
from veneur_tpu.sketches import ull as jull
from veneur_tpu_torch import kernels
from veneur_tpu_torch.kernels import ull_insert as t_kinsert
from veneur_tpu_torch.sketches import ull as tull
from veneur_tpu_torch.utils.hashing import set_member_hash


def _batch(rng, K, m, n, pad=True):
    """A pre-populated bank of random (canonical and non-canonical) bytes
    and a batch with 25% duplicated targets carrying conflicting values,
    packed 4*q values and arbitrary bytes, and slot -1 padding."""
    regs = rng.integers(0, 256, (K, m)).astype(np.uint8)
    regs[0] = 0                                  # a fresh row
    slots = rng.integers(-1 if pad else 0, K, n).astype(np.int32)
    idx = rng.integers(0, m, n).astype(np.int32)
    q = n // 4
    slots[:q] = slots[q:2 * q]
    idx[:q] = idx[q:2 * q]
    vals = (rng.integers(1, 52, n) << 2).astype(np.uint8)
    vals[::5] = rng.integers(0, 256, len(vals[::5]))
    slots[-8:] = K - 1                           # last slot, last register
    idx[-8:] = m - 1
    return regs, slots, idx, vals


def _t_insert(regs, slots, idx, vals):
    bank = tull.ULLBank(registers=torch.tensor(regs))
    t_kinsert.fused_insert(bank, torch.as_tensor(slots),
                           torch.as_tensor(idx), torch.as_tensor(vals))
    return bank.registers.numpy()


def test_join_matches_jax_on_every_byte_pair():
    u, v = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    u, v = u.reshape(-1).astype(np.int32), v.reshape(-1).astype(np.int32)
    want = np.asarray(jull._join_i32(jnp.asarray(u), jnp.asarray(v)))
    got = tull._join_i32(torch.as_tensor(u), torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tull.join_registers_np(u, v),
                                  jull.join_registers_np(u, v))


def test_join_is_associative_and_commutative_on_every_byte():
    """What lets the kernel fold a warp's values before it joins them into
    a word, and land updates in any order: over all 256^3 byte triples,
    join(join(a, b), c) == join(a, join(b, c)) and join(a, b) ==
    join(b, a). It is not idempotent on every byte (join(1, 1) == 0), so
    the kernel never joins the current byte in twice."""
    a = np.arange(256)
    table = tull.join_registers_np(*np.meshgrid(a, a, indexing="ij")) \
        .astype(np.int64)
    np.testing.assert_array_equal(table, table.T)
    for c in range(256):
        np.testing.assert_array_equal(table[table[:, :], c],
                                      table[a[:, None], table[:, c][None, :]])
    assert table[1, 1] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_insert_matches_jax_and_pallas_interpret(seed):
    rng = np.random.default_rng(seed)
    K, p, n = 7, 9, 2048
    regs, slots, idx, vals = _batch(rng, K, 1 << p, n)
    args = (jnp.asarray(slots), jnp.asarray(idx), jnp.asarray(vals))
    want = np.asarray(jull._insert_impl(
        jull.ULLBank(registers=jnp.asarray(regs)), *args).registers)
    pallas = np.asarray(j_kinsert.fused_insert(
        jull.ULLBank(registers=jnp.asarray(regs)), *args,
        interpret=True).registers)
    got = _t_insert(regs, slots, idx, vals)
    np.testing.assert_array_equal(want, pallas)
    np.testing.assert_array_equal(got, want)
    # untouched registers keep their bytes, non-canonical ones included
    touched = np.zeros_like(regs, bool)
    ok = slots >= 0
    touched[slots[ok], idx[ok]] = True
    np.testing.assert_array_equal(got[~touched], regs[~touched])


def test_hot_register_and_shared_word_contention():
    """Many updates on one register and on four neighbouring registers
    of one 32-bit word: the plain version equals JAX's."""
    rng = np.random.default_rng(5)
    K, m, n = 3, 512, 4096
    regs = rng.integers(0, 256, (K, m)).astype(np.uint8)
    slots = np.full(n, 1, np.int32)
    idx = np.where(np.arange(n) < 2000, 77,
                   8 + np.arange(n) % 4).astype(np.int32)
    vals = rng.integers(0, 256, n).astype(np.uint8)
    want = np.asarray(jull._insert_impl(
        jull.ULLBank(registers=jnp.asarray(regs)), jnp.asarray(slots),
        jnp.asarray(idx), jnp.asarray(vals)).registers)
    np.testing.assert_array_equal(_t_insert(regs, slots, idx, vals), want)


def test_relanding_a_batch_changes_nothing():
    rng = np.random.default_rng(3)
    regs, slots, idx, vals = _batch(rng, 5, 256, 1024)
    once = _t_insert(regs, slots, idx, vals)
    np.testing.assert_array_equal(_t_insert(once, slots, idx, vals), once)


def _j_insert(regs, slots, idx, vals):
    return np.asarray(jull._insert_impl(
        jull.ULLBank(registers=jnp.asarray(regs)), jnp.asarray(slots),
        jnp.asarray(idx), jnp.asarray(vals)).registers)


def test_updates_outside_the_bank_are_dropped():
    """Padding, a slot past the bank, the index one past the last
    register and flat keys that wrap past 2^32 name no register."""
    K, m = 4, 64
    regs = np.zeros((K, m), np.uint8)
    slots = np.array([-1, -5, K, K - 1, 0, 1, 2], np.int32)
    idx = np.array([3, 3, 0, m, -1, -2 * m, 5], np.int32)
    vals = np.full(len(slots), 4 * 9, np.uint8)
    got = _t_insert(regs, slots, idx, vals)
    want = regs.copy()
    want[2, 5] = 4 * 9
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _j_insert(regs, slots, idx, vals))


def test_index_past_the_row_lands_in_the_next_row_as_in_jax():
    """Both packages key a register by the uint32 flat index slot * m +
    idx, so idx == m lands in the next row's register 0."""
    K, m = 4, 64
    regs = np.zeros((K, m), np.uint8)
    slots, idx = np.array([1], np.int32), np.array([m], np.int32)
    vals = np.array([4 * 9], np.uint8)
    want = _j_insert(regs, slots, idx, vals)
    assert want[2, 0] == 4 * 9 and want.sum() == 4 * 9
    np.testing.assert_array_equal(_t_insert(regs, slots, idx, vals), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_flat_key_edges_match_jax_on_every_byte(seed):
    """A batch that holds idx == m, idx == -1 (the previous row's last
    register, or no register from slot 0), the last slot's last register
    and padding, over a bank of random bytes: the plain insert equals
    the JAX insert on every byte."""
    rng = np.random.default_rng(seed)
    K, m, n = 6, 128, 1024
    regs, slots, idx, vals = _batch(rng, K, m, n)
    edges = [(1, m), (K - 2, m), (K - 1, m), (0, -1), (3, -1),
             (K - 1, m - 1), (K - 1, -1), (-1, m), (2, 2 * m + 3)]
    for i, (s, c) in enumerate(edges):
        for rep in range(3):           # each edge three times, 3 values
            slots[16 * i + rep], idx[16 * i + rep] = s, c
    got = _t_insert(regs, slots, idx, vals)
    np.testing.assert_array_equal(got, _j_insert(regs, slots, idx, vals))
    assert (got != regs).sum() > n // 8


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    kernels.reset_launches()
    rng = np.random.default_rng(4)
    regs, slots, idx, vals = _batch(rng, 4, 128, 256)
    plain = tull.ULLBank(registers=torch.tensor(regs))
    tull._insert_impl(plain, torch.as_tensor(slots), torch.as_tensor(idx),
                      torch.as_tensor(vals))
    np.testing.assert_array_equal(_t_insert(regs, slots, idx, vals),
                                  plain.registers.numpy())
    assert all(n == 0 for n in kernels.launches.values())


def test_value_counts_and_ml_estimate_match_jax():
    rng = np.random.default_rng(6)
    regs = rng.integers(0, 200, (9, 1 << 10)).astype(np.uint8)
    regs[0] = 0
    regs[1, 100:] = 0
    got = tull._value_counts(torch.as_tensor(regs)).numpy()
    want = np.asarray(jull._value_counts(jnp.asarray(regs)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tull.ml_estimate(got, 1 << 10),
                                  jull.ml_estimate(want, 1 << 10))


def _members(n, tag=""):
    return np.array([set_member_hash(f"member-{tag}-{i}") for i in range(n)],
                    np.uint64)


def _fill(eng, bank, slot, hashes, batch=4096):
    idx, vals = eng.host_hash_to_updates(hashes)
    for i in range(0, len(hashes), batch):
        s = torch.full((len(idx[i:i + batch]),), slot, dtype=torch.int32)
        bank = eng.insert(bank, s, torch.as_tensor(idx[i:i + batch]),
                          torch.as_tensor(vals[i:i + batch]))
    return bank


def _estimate(eng, bank):
    host = {k: v.numpy() for k, v in eng.estimate_device(bank).items()}
    eng.estimate_finalize(host)
    return host["s_est"].astype(np.float64)


@pytest.mark.parametrize("n", [500, 60_000])
def test_estimate_within_the_engine_bound(n):
    """The JAX package's cardinality contract (tests/test_sketches.py)
    on the port: within 4 nominal errors + 0.01 relative; an untouched
    slot estimates 0."""
    eng = tull.ULLEngine(precision=13)
    bank = _fill(eng, eng.init(2, "cpu"), 0, _members(n))
    est = _estimate(eng, bank)
    assert abs(est[0] - n) / n <= 4.0 * eng.nominal_error() + 0.01
    assert est[1] == 0.0


def test_merge_banks_exact_and_commutative():
    eng, jeng = tull.ULLEngine(precision=10), jull.ULLEngine(precision=10)
    a = _fill(eng, eng.init(3, "cpu"), 1, _members(3000, "x"))
    b = _fill(eng, eng.init(3, "cpu"), 1, _members(2000, "y"))
    ab, ba = eng.merge_banks(a, b), eng.merge_banks(b, a)
    assert torch.equal(ab.registers, ba.registers)
    want = jeng.merge_banks(jull.ULLBank(jnp.asarray(a.registers.numpy())),
                            jull.ULLBank(jnp.asarray(b.registers.numpy())))
    np.testing.assert_array_equal(ab.registers.numpy(),
                                  np.asarray(want.registers))


def test_hash_updates_match_jax():
    rng = np.random.default_rng(2)
    h = rng.integers(0, 2 ** 64, 4096, dtype=np.uint64)
    h[:3] = [0, 1, 2 ** 64 - 1]
    for p in (4, 13, 16):
        te, je = tull.ULLEngine(precision=p), jull.ULLEngine(precision=p)
        for t, j in zip(te.host_hash_to_updates(h),
                        je.host_hash_to_updates(h)):
            np.testing.assert_array_equal(t, j)
        for x in h[:64].tolist():
            assert te.hash_update(x) == je.hash_update(x)


# ---- models of the kernel's algorithm (csrc/ull_insert.cu: one CAS
# loop per update) and of its warp pre-join variant
# (variants/ull_insert_fold.cu, timed against it by ull_insert_fold.py)

def _np_proves(x, q, k):
    return ((q >= 1) & (k >= 1)
            & ((q == k) | ((q == k + 1) & ((x >> 1) & 1 == 1))
               | ((q == k + 2) & (x & 1 == 1))))


def _kernel_constant(name):
    import re
    from veneur_tpu_torch.kernels import _build
    src = open(f"{_build.PKG_DIR}/variants/ull_insert_fold.cu").read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _kernel_model(regs, slots, idx, vals, seed=0, stats=None, fold=True):
    """A model of the insert kernel's warp pre-join variant on a u8[K, m]
    bank, in its steps; with `fold=False`, of the kernel itself, where
    every live update joins its own byte (step 2 never folds).

    1. One update a thread: a warp's 32 lanes hold 32 consecutive
       updates. An update past n, or not live under the uint32 flat key,
       carries the dead key.
    2. Per warp: if no live lane's neighbour (lane + 1 mod 32) holds its
       word, every live lane leads its word with its own byte. Otherwise
       a live lane alone on its word still does; where live lanes share
       a word, each distinct register among them folds its values by the
       closed form of the multi-way join (qm = the largest q, b1 / b2 =
       any value proves qm-1 / qm-2), the word ORs its registers' bytes
       into a 4-byte image with a mask of the bytes present, and the
       word's lowest lane leads.
    3. The leaders' word joins, byte by byte, in a shuffled order (the
       CAS loops land in no fixed order); `stats["word_joins"]` counts
       them."""
    K, m = regs.shape
    n, total, u32 = len(slots), K * m, 0xFFFFFFFF
    joins = []                                   # (word, image, present)
    for base in range(0, n, 32):
        i = base + np.arange(32)
        inb = i < n
        ii = np.where(inb, i, 0)
        s = np.where(inb, slots[ii].astype(np.int64), -1)
        c = np.where(inb, idx[ii].astype(np.int64), 0)
        v = np.where(inb, vals[ii].astype(np.int64), 0)
        flat = ((s & u32) * m + (c & u32)) & u32
        live = (s >= 0) & (flat < total)
        word = flat >> 2
        sh = (flat & 3) * 8
        near = fold and (live & np.roll(live, -1)
                         & (word == np.roll(word, -1))).any()
        for w in np.unique(word[live]):
            lanes = np.nonzero(live & (word == w))[0]
            if not near or len(lanes) == 1:
                joins.extend((int(w), int(v[a]) << int(sh[a]),
                              0xFF << int(sh[a])) for a in lanes)
                continue
            image = present = 0
            for r in np.unique(flat[lanes]):
                g = lanes[flat[lanes] == r]
                q = v[g] >> 2
                qm = int(q.max())
                b1 = int(_np_proves(v[g], q, qm - 1).any())
                b2 = int(_np_proves(v[g], q, qm - 2).any())
                byte = (qm << 2) | (b1 << 1) | b2 if qm > 0 else 0
                image |= byte << int(r & 3) * 8
                present |= 0xFF << int(r & 3) * 8
            joins.append((int(w), image, present))
    if stats is not None:
        stats["word_joins"] = len(joins)
    out = regs.reshape(-1).copy()
    for k in np.random.default_rng(seed).permutation(len(joins)):
        w, image, present = joins[k]
        for b in range(4):
            if present >> (8 * b) & 0xFF:
                out[4 * w + b] = tull.join_registers_np(
                    out[4 * w + b], image >> (8 * b) & 0xFF)
    return out.reshape(K, m)


_j_insert_jit = jax.jit(jull._insert_impl)


def _model_cases():
    """(name, regs, slots, idx, vals) for the model tests."""
    rng = np.random.default_rng(12)
    out = []
    for seed in range(2):
        r = np.random.default_rng(seed)
        out.append((f"random{seed}", *_batch(r, 6, 256, 2048)))
    K, m = 4, 128
    regs = rng.integers(0, 256, (K, m)).astype(np.uint8)
    n = 1500
    slots = rng.integers(0, K, n).astype(np.int32)
    idx = rng.integers(0, m, n).astype(np.int32)
    vals = rng.integers(0, 256, n).astype(np.uint8)
    slots[200:1200], idx[200:1200] = 2, 77                # 1000 hits
    vals[200:1200] = (rng.integers(1, 52, 1000) << 2) \
        | rng.integers(0, 4, 1000)
    out.append(("hot_register", regs, slots, idx, vals))
    n = 2048                                             # one word
    out.append(("all_one_word", regs, np.full(n, 1, np.int32),
                (40 + np.arange(n) % 4).astype(np.int32),
                rng.integers(0, 256, n).astype(np.uint8)))
    # a partial last thread, warp and tile: n not a multiple of anything
    regs_p, slots_p, idx_p, vals_p = _batch(rng, 5, 64, 2048)
    out.append(("partial_window", regs_p, slots_p[:1003], idx_p[:1003],
                vals_p[:1003]))
    K, m = 6, 128
    regs, slots, idx, vals = _batch(rng, K, m, 1024)
    edges = [(1, m), (K - 2, m), (K - 1, m), (0, -1), (3, -1),
             (K - 1, m - 1), (K - 1, -1), (-1, m), (2, 2 * m + 3), (K, 0),
             (1, -2 * m)]
    for i, (s, c) in enumerate(edges):
        for rep in range(3):
            slots[16 * i + rep], idx[16 * i + rep] = s, c
    out.append(("key_edges", regs, slots, idx, vals))
    return out


@pytest.mark.parametrize("case", _model_cases(), ids=lambda c: c[0])
def test_kernel_model_matches_both_plain_inserts(case):
    """The kernel's one join per update, and its variant's warp
    grouping, per-register fold, per-word image and word joins, each in
    a shuffled order, give the bytes of the port's plain insert and of
    the JAX insert (jitted: integer ops, the same bytes as eager, one
    compile a shape), on every byte; landing the batch again changes
    nothing."""
    _, regs, slots, idx, vals = case
    want = np.asarray(_j_insert_jit(
        jull.ULLBank(registers=jnp.asarray(regs)), jnp.asarray(slots),
        jnp.asarray(idx), jnp.asarray(vals)).registers)
    np.testing.assert_array_equal(_t_insert(regs, slots, idx, vals), want)
    for fold in (False, True):
        for seed in (0, 1):
            got = _kernel_model(regs, slots, idx, vals, seed, fold=fold)
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            _kernel_model(want, slots, idx, vals, 2, fold=fold), want)


def test_kernel_model_folds_a_warp_to_one_join_per_word():
    """On one word hit by a whole CTA's tile of the variant (each warp's
    lanes on all four of its registers), the variant's model makes one
    word join per warp, the kernel's one per update; where lanes share
    words only with lanes that are not their neighbours, no lane folds
    and every live lane joins on its own."""
    threads = _kernel_constant("kThreads")
    regs = np.zeros((2, 64), np.uint8)
    slots = np.zeros(threads, np.int32)
    idx = (np.arange(threads) % 4).astype(np.int32)
    vals = (np.arange(threads) % 50 << 2).astype(np.uint8)
    stats = {}
    folded = _kernel_model(regs, slots, idx, vals, stats=stats)
    np.testing.assert_array_equal(folded, _t_insert(regs, slots, idx, vals))
    assert (folded != 0).sum() == 4
    assert stats["word_joins"] == threads // 32
    _kernel_model(regs, slots, idx, vals, stats=stats, fold=False)
    assert stats["word_joins"] == threads
    # lanes 0, 2, 4, ... on word 0 and 1, 3, 5, ... on word 1
    idx = (np.arange(threads) % 2 * 4).astype(np.int32)
    apart = _kernel_model(regs, slots, idx, vals, stats=stats)
    np.testing.assert_array_equal(apart, _t_insert(regs, slots, idx, vals))
    assert stats["word_joins"] == threads


def test_fold_tool_counts_updates_that_share_a_word_in_their_warp():
    """ull_insert_fold.py's crowded share: the live updates whose warp of
    32 consecutive updates holds another live update on the same 32-bit
    word (under the uint32 flat key), out of all live updates."""
    from ull_insert_fold import crowded_share
    m, total = 256, 4 * 256
    slots = np.zeros(64, np.int32)
    idx = np.arange(64, dtype=np.int32) * 4       # 64 distinct words
    assert crowded_share(slots, idx, m, total) == 0.0
    idx[1] = idx[0] + 3                            # lane 1 joins 0's word
    slots[2:4] = -1                                # two dead lanes
    idx[5] = idx[4]                                # same register
    slots[40], idx[40] = 1, -m + idx[41]           # key wraps onto 41's
    slots[41] = 0
    assert crowded_share(slots, idx, m, total) == 6 / 62
    assert crowded_share(np.full(3, -1), np.zeros(3), m, total) == 0.0
