"""SK01 fixture: sketch banks / sketch-module imports outside the
registry boundary (veneur_tpu_torch/sketches/ + the blessed ops/ kernels).
This docstring may name ops.tdigest and ULLBank freely."""

from veneur_tpu_torch.ops import tdigest                              # SK01

from veneur_tpu_torch.sketches.ull import ULLBank                     # SK01

import veneur_tpu_torch.ops.hll                                       # SK01


def handroll_bank(mean, weight):
    # constructing a bank outside its engine bypasses the cluster
    # ordering / register packing invariants
    return tdigest.TDigestBank(mean=mean, weight=weight)        # SK01


def handroll_ull(regs):
    return ULLBank(registers=regs)                              # SK01


def documented_exception():
    # vlint: disable=SK01 reason=fixture-only: a bench harness may
    # construct a throwaway bank to measure raw kernel cost
    from veneur_tpu_torch.ops import hll
    return hll


def fine_registry_use(cfg):
    from veneur_tpu_torch import sketches
    return sketches.histogram_engine(cfg)
