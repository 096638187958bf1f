"""UltraLogLog set engine — counterpart of veneur_tpu/sketches/ull.py.

Each u8 register stores ``u = 4*q + 2*b1 + b2``: ``q`` is the largest
update value seen (HLL's rho) and the two low bits record whether
updates at ``q-1`` (b1) and ``q-2`` (b2) were also seen. m = 2^13
registers match the error of HLL's 2^14, so the bank is half the bytes.

Register update and merge are a lattice JOIN, not a max (the state is
only partially ordered). The batched insert is one function with two
implementations: the CUDA scatter-join kernel for registers on the card
(kernels/ull_insert.py, csrc/ull_insert.cu) and the plain torch version
here, `_insert_impl`, for registers on the CPU. The JAX package's plain
insert sorts the batch and collapses duplicates with an associative
scan; torch has no associative scan, so `_insert_impl` computes the
closed form of the multi-way join of each target's current byte with
all its updates instead: qm = the largest q of any operand, b1 / b2 =
whether any operand proves an event at qm-1 / qm-2. The join is
associative, commutative and idempotent, so this equals the iterated
join in any order (bytes exact). Both implementations update the
register tensor in place.

Estimation is the paper's ML estimator, split across the flush: the
device half reduces the registers to a per-slot value histogram
(`_value_counts`, u8[K, m] -> i32[K, 256]); the host half
(`ml_estimate`, numpy, copied verbatim from the JAX package) solves the
1-D Poisson maximum likelihood per slot after the fetch.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops import hll as _hll


class ULLBank(NamedTuple):
    registers: torch.Tensor   # u8[K, m], m = 2^precision

    @property
    def num_slots(self):
        return self.registers.shape[0]

    @property
    def num_registers(self):
        return self.registers.shape[1]


def init(num_slots: int, precision: int = 13, *, device) -> ULLBank:
    return ULLBank(registers=torch.zeros(
        (num_slots, 1 << precision), dtype=torch.uint8, device=device))


def _proves(x, q, k):
    """Does register x (max q) prove an event at level k >= 1?"""
    return ((q >= 1) & (k >= 1)
            & ((q == k) | ((q == k + 1) & (((x >> 1) & 1) == 1))
               | ((q == k + 2) & ((x & 1) == 1))))


def _join_i32(u, v):
    """Elementwise ULL register join on integer tensors (commutative,
    associative, idempotent — the lattice union of retained events)."""
    qu, qv = u >> 2, v >> 2
    qm = torch.maximum(qu, qv)
    b1 = _proves(u, qu, qm - 1) | _proves(v, qv, qm - 1)
    b2 = _proves(u, qu, qm - 2) | _proves(v, qv, qm - 2)
    out = (qm << 2) | (b1.to(qm.dtype) << 1) | b2.to(qm.dtype)
    return torch.where(qm > 0, out, torch.zeros_like(out))


def join_registers_np(a, b) -> np.ndarray:
    """Numpy twin of the register join (host merges, oracle tests)."""
    u = np.asarray(a, np.uint8).astype(np.int32)
    v = np.asarray(b, np.uint8).astype(np.int32)
    qu, qv = u >> 2, v >> 2
    qm = np.maximum(qu, qv)

    def ev(x, q, k):
        return ((q >= 1) & (k >= 1)
                & ((q == k) | ((q == k + 1) & ((x >> 1) & 1 == 1))
                   | ((q == k + 2) & (x & 1 == 1))))

    b1 = ev(u, qu, qm - 1) | ev(v, qv, qm - 1)
    b2 = ev(u, qu, qm - 2) | ev(v, qv, qm - 2)
    out = (qm << 2) | (b1.astype(np.int32) << 1) | b2.astype(np.int32)
    return np.where(qm > 0, out, 0).astype(np.uint8)


def check_flat_range(K: int, m: int) -> None:
    """Refuse a [K, m] bank whose registers a uint32 flat index cannot
    all name (the JAX insert's key; its bound K*m is a uint32 too)."""
    if K * m >= 1 << 32:
        raise ValueError(f"ULL bank of {K} x {m} registers: the insert's "
                         "uint32 flat index covers fewer than 2^32")


def _insert_impl(bank: ULLBank, slots, reg_idx, vals) -> ULLBank:
    """The plain version of the insert kernel: join `vals` (packed 4*q
    register values) into registers[slot, reg_idx], in place.

    Each update is keyed, as in the JAX insert, by the uint32 flat index
    flat = (uint32(slot) * m + uint32(reg_idx)) mod 2^32 of the row-major
    bank, and is live iff slot >= 0 and flat < K*m: slot -1 is padding,
    and an index outside [0, m) lands in a neighbouring row's register
    when that is still inside the bank. A bank of more than 2^32
    registers has no uint32 key and is refused."""
    K, m = bank.registers.shape
    check_flat_range(K, m)
    u32 = 0xFFFFFFFF
    flat = ((slots.long() & u32) * m + (reg_idx.long() & u32)) & u32
    valid = (slots >= 0) & (flat < K * m)
    tgt = flat[valid]
    if tgt.numel() == 0:
        return bank
    regs = bank.registers.view(-1)
    uniq, inv = torch.unique(tgt, return_inverse=True)
    U = uniq.numel()
    # the operands of each target: its current byte, then every update
    x = torch.cat([regs[uniq].long(), vals[valid].long()])
    seg = torch.cat([torch.arange(U, device=tgt.device), inv])
    q = x >> 2
    qm = torch.zeros(U, dtype=torch.int64, device=tgt.device)
    qm.scatter_reduce_(0, seg, q, reduce="amax")
    qs = qm[seg]
    b1 = torch.zeros_like(qm).scatter_reduce_(
        0, seg, _proves(x, q, qs - 1).long(), reduce="amax")
    b2 = torch.zeros_like(qm).scatter_reduce_(
        0, seg, _proves(x, q, qs - 2).long(), reduce="amax")
    out = torch.where(qm > 0, (qm << 2) | (b1 << 1) | b2,
                      torch.zeros_like(qm))
    regs[uniq] = out.to(torch.uint8)
    return bank


def _value_counts(registers) -> torch.Tensor:
    """u8[K, m] -> i32[K, 256] per-slot register-value histogram — the
    ML estimator's sufficient statistic (the device half of estimate)."""
    K = registers.shape[0]
    rows = torch.arange(K, dtype=torch.int32, device=registers.device)
    keys = registers.int() + (rows * 256)[:, None]
    return torch.bincount(keys.reshape(-1), minlength=256 * K) \
        .view(K, 256).int()


@lru_cache(maxsize=None)
def _ml_terms():
    """Per-register-value likelihood terms: Z[256, 4] probability
    weights, OBS[256, 4] observed flags, MASK[256, 4] validity."""
    Z = np.zeros((256, 4))
    OBS = np.zeros((256, 4), bool)
    MASK = np.zeros((256, 4), bool)
    for u in range(256):
        q, b1, b2 = u >> 2, (u >> 1) & 1, u & 1
        terms = []
        if u == 0:
            terms.append((1.0, False))        # no event at any level
        elif q >= 1:
            terms.append((2.0 ** -q, False))  # nothing above q
            terms.append((2.0 ** -q, True))   # the max event itself
            if q >= 2:
                terms.append((2.0 ** -(q - 1), bool(b1)))
            if q >= 3:
                terms.append((2.0 ** -(q - 2), bool(b2)))
        for t, (z, obs) in enumerate(terms):
            Z[u, t] = z
            OBS[u, t] = obs
            MASK[u, t] = True
    return Z, OBS, MASK


def ml_estimate(counts, num_registers: int) -> np.ndarray:
    """Per-slot ML cardinality from register-value histograms
    (i32[K, 256] -> f64[K]). Solves d/dlam log-likelihood = 0 by
    vectorized geometric bisection (the derivative is strictly
    decreasing in lam); estimate = lam * m. Cost is bounded for the
    flush path: only slots with any nonzero register are solved, the
    observed-event terms collapse onto the <= ~60 distinct probability
    weights (z = 2^-k), and 40 bisection steps reach ~1e-8 relative
    resolution — far inside the sketch's own ~1% noise."""
    counts = np.asarray(counts, np.float64)
    K = counts.shape[0]
    m = float(num_registers)
    out = np.zeros(K)
    active = counts[:, 0] < m                 # any nonzero register
    if not active.any():
        return out
    c_all = counts[active]                    # [A, 256]
    Z, OBS, MASK = _ml_terms()
    used = np.nonzero(c_all.sum(axis=0) > 0)[0]
    c = c_all[:, used]                        # [A, U]
    z = Z[used]
    obs = OBS[used] & MASK[used]
    unobs = (~OBS[used]) & MASK[used]
    # constant part of the derivative: -sum of unobserved weights
    neg = -(c @ (z * unobs).sum(axis=1))      # [A]
    # group observed terms by their (few) distinct z values:
    # f(lam) = sum_z wz * z/expm1(lam*z) + neg
    zvals = np.unique(z[obs])                 # [nz]
    A_map = np.zeros((len(used), len(zvals)))
    for t in range(4):
        col = np.searchsorted(zvals, z[:, t])
        ok = obs[:, t] & (col < len(zvals))
        np.add.at(A_map, (np.nonzero(ok)[0], col[ok]), 1.0)
    wz = c @ A_map                            # [A, nz]

    lo = np.full(c.shape[0], 2.0 ** -40)
    hi = np.full(c.shape[0], 2.0 ** 44)
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        for _ in range(40):
            lam = np.sqrt(lo * hi)
            lz = np.minimum(lam[:, None] * zvals[None, :], 700.0)
            f = (wz * (zvals[None, :] / np.expm1(lz))).sum(axis=1) + neg
            bigger = f > 0                    # root is above lam
            lo = np.where(bigger, lam, lo)
            hi = np.where(bigger, hi, lam)
    out[active] = np.sqrt(lo * hi) * m
    return out


@dataclass(frozen=True)
class ULLEngine:
    precision: int = 13

    id = "ull"
    wire_version = 1

    @property
    def num_registers(self) -> int:
        return 1 << self.precision

    def init(self, num_slots: int, device):
        return init(num_slots, self.precision, device=device)

    def insert(self, bank, slots, reg_idx, vals):
        """Batched insert: the scatter-join kernel on the card, the plain
        version on the CPU. Updates the registers in place."""
        from ..kernels import ull_insert as kinsert
        return kinsert.fused_insert(bank, slots, reg_idx, vals)

    def merge_banks(self, a, b):
        return ULLBank(registers=_join_i32(
            a.registers.int(), b.registers.int()).to(torch.uint8))

    def hash_update(self, h: int) -> tuple:
        """(register index, packed 4*q update value) from one 64-bit
        member hash — same index/rank decomposition as HLL, packed into
        the ULL register encoding."""
        p = self.precision
        idx = h >> (64 - p)
        rest = ((h << p) & 0xFFFFFFFFFFFFFFFF) | ((1 << p) - 1)
        q = 65 - rest.bit_length()
        return idx, q << 2

    def host_hash_to_updates(self, hashes64):
        idx, rho = _hll.host_hash_to_updates(hashes64, self.precision)
        return idx, (rho.astype(np.int32) << 2).astype(np.uint8)

    def estimate_device(self, bank) -> dict:
        return {"s_counts": _value_counts(bank.registers)}

    def estimate_finalize(self, host: dict) -> None:
        counts = host.pop("s_counts")
        host["s_est"] = ml_estimate(counts, self.num_registers).astype(
            np.float32)

    def nominal_error(self) -> float:
        # measured ML-estimator stderr constant (~0.76/sqrt(m))
        return 0.76 / (self.num_registers ** 0.5)

    def state_bytes(self, num_slots: int = 1) -> int:
        return num_slots * self.num_registers
