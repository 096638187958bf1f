"""SK01 good fixture: engines come from the registry; the registry's
module, the scalar banks and the engine objects are fair to name. This
docstring may name ops.tdigest and ULLBank freely."""

from veneur_tpu_torch import sketches
from veneur_tpu_torch.ops.scalar import CounterBank


def histogram_engine(cfg):
    return sketches.histogram_engine(cfg)


def counters(cfg):
    return CounterBank
