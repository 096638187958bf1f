"""veneur_tpu_torch HLL ops and the hll_stats plain version against
veneur_tpu (CPU).

Contract levels: the register bytes, the hash decomposition and `ez`
(a count) are exact; `zsum` agrees within rtol 1e-6 (f32 sums of exact
powers of two in another order) and the estimate within rtol 1e-5 (the
JAX package's exp2 is inexact for integer exponents >= 13, torch's is
exact). The JAX side runs its Pallas kernel in interpret mode, as the
JAX package's own tests do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.kernels.hll_stats import hll_stats as j_hll_stats
from veneur_tpu.ops import hll as jhll
from veneur_tpu.sketches.hll_engine import HLLEngine as JHLLEngine
from veneur_tpu_torch import kernels
from veneur_tpu_torch.kernels import hll_stats as kh
from veneur_tpu_torch.ops import hll as thll
from veneur_tpu_torch.sketches.hll_engine import HLLEngine as THLLEngine


def _registers(K, m, seed=0):
    rng = np.random.default_rng(seed)
    fill = rng.random(K)
    live = rng.random((K, m)) < fill[:, None]
    regs = np.where(live, np.minimum(rng.geometric(0.5, (K, m)), 51),
                    0).astype(np.uint8)
    regs[0] = 0                      # all-zero row (an empty set)
    regs[1, : m // 2] = 0            # half-empty row
    return regs


@pytest.mark.parametrize("K,m", [(37, 1024), (5, 512), (32, 16384)])
def test_hll_stats_plain_matches_jax_interpret(K, m):
    """K=37 and K=5 are not multiples of the Pallas row block (32)."""
    regs = _registers(K, m)
    ez_t, zs_t = kh.hll_stats_plain(torch.as_tensor(regs))
    ez_j, zs_j = j_hll_stats(regs, interpret=True)
    np.testing.assert_array_equal(ez_t.numpy(), np.asarray(ez_j))
    np.testing.assert_allclose(zs_t.numpy(), np.asarray(zs_j), rtol=1e-6)
    assert float(ez_t[0]) == m


def test_estimate_matches_jax():
    regs = _registers(16, 1 << 14, seed=1)
    jb = jhll.HLLBank(registers=jnp.asarray(regs))
    tb = thll.HLLBank(registers=torch.as_tensor(regs))
    est_t = thll.estimate(tb).numpy()
    est_j = np.asarray(jhll.estimate(jb))
    np.testing.assert_allclose(est_t, est_j, rtol=1e-5)
    assert est_t[0] == 0.0           # an empty set estimates 0


def test_hll_stats_wrapper_on_cpu_runs_plain_and_counts_nothing():
    kernels.reset_launches()
    regs = torch.as_tensor(_registers(8, 1024))
    got = kh.hll_stats(regs)
    want = kh.hll_stats_plain(regs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(n == 0 for n in kernels.launches.values())


def test_hash_decomposition_matches_jax():
    rng = np.random.default_rng(2)
    h = rng.integers(0, 2 ** 64, 4096, dtype=np.uint64)
    h[:3] = [0, 1, 2 ** 64 - 1]
    for p in (10, 14):
        ti, tr = thll.host_hash_to_updates(h, p)
        ji, jr = jhll.host_hash_to_updates(h, p)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tr, jr)
        te, je = THLLEngine(precision=p), JHLLEngine(precision=p)
        for x in h[:64].tolist():
            assert te.hash_update(x) == je.hash_update(x)


def test_insert_registers_match_jax_exactly():
    """Scatter-max with duplicate targets, conflicting ranks on one
    register, padding (slot -1) and out-of-range slots."""
    rng = np.random.default_rng(3)
    K, p, n = 6, 10, 2048
    m = 1 << p
    jb, tb = jhll.init(K, p), thll.init(K, p, device="cpu")
    for _ in range(3):
        slots = rng.integers(-1, K, n).astype(np.int32)
        slots[:8] = 2
        idx = rng.integers(0, m, n).astype(np.int32)
        idx[:8] = 17                 # eight ranks on one register
        rho = np.minimum(rng.geometric(0.5, n), 64 - p + 1).astype(np.uint8)
        jb = jhll.insert(jb, jnp.asarray(slots), jnp.asarray(idx),
                         jnp.asarray(rho))
        tb = thll.insert(tb, torch.as_tensor(slots), torch.as_tensor(idx),
                         torch.as_tensor(rho))
        np.testing.assert_array_equal(tb.registers.numpy(),
                                      np.asarray(jb.registers))
    # an all-padding batch leaves the bank as it was
    before = tb.registers.clone()
    tb = thll.insert(tb, torch.full((4,), -1, dtype=torch.int32),
                     torch.zeros(4, dtype=torch.int32),
                     torch.ones(4, dtype=torch.uint8))
    assert torch.equal(tb.registers, before)
