"""HK01 good fixture: a module outside kernels/ reaches a kernel only
through its wrapper. This docstring names load_inline, ctypes.CDLL and
veneur_tpu_torch/variants/ freely."""

import ctypes

from veneur_tpu_torch.kernels.hll_stats import hll_stats


def estimate(registers):
    ez, zsum = hll_stats(registers)
    return ez, zsum


def host_types():
    return ctypes.c_uint8
