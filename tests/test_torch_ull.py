"""veneur_tpu_torch's ULL engine and the ull_insert plain version against
veneur_tpu (CPU).

Contract level: exact throughout. Registers are u8 and the join is
integer arithmetic, so the plain insert must equal the JAX package's
`_insert_impl` and its Pallas kernel (`fused_insert`, interpret mode, as
the JAX package's own tests run it) byte for byte; the value histogram
is integer counts; `ml_estimate` is the same numpy code on the same
counts, so the estimate is the same number.
"""

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
