"""SR02 fixture: writes to TDigestBank.mean/weight outside
ops/tdigest.py — code that could silently break the sorted-prefix
invariant the merge-path compress depends on for correctness."""

from veneur_tpu_torch.ops.tdigest import TDigestBank


def rebuild(bank, new_means):
    bank = TDigestBank(mean=new_means, weight=bank.weight,
                       buf_value=bank.buf_value,
                       buf_weight=bank.buf_weight, buf_n=bank.buf_n,
                       vmin=bank.vmin, vmax=bank.vmax, vsum=bank.vsum,
                       count=bank.count, recip=bank.recip,
                       vsum_lo=bank.vsum_lo, count_lo=bank.count_lo,
                       recip_lo=bank.recip_lo)
    return bank


def patch(bank, w):
    return bank._replace(weight=w)


def scalar_patch_is_fine(bank, c):
    # scalar fields carry no ordering invariant — must NOT be flagged
    return bank._replace(vsum=c, count=c)


def suppressed_ok(bank, z):
    # vlint: disable=SR02 reason=all-zero rows are trivially cluster-ordered
    return bank._replace(mean=z, weight=z)


def splat_construction(state):
    return TDigestBank(**state)     # **kwargs is opaque -> flagged


def splat_replace(bank, state):
    return bank._replace(**state)   # likewise
