"""HK02 good fixture: each wrapper takes its plain version on a CPU
tensor, checks its launch and counts it after the launch, as the
port's kernels/ wrappers do."""

import triton

from veneur_tpu_torch.kernels import (count_launch, launch_error, lib,
                                      stream_handle)
from veneur_tpu_torch.ops.tdigest import compress_plain


def add_plain(x):
    return x + 1.0


def add(x):
    if x.is_cpu:
        return add_plain(x)
    dev = x.get_device()
    out = x.clone()
    err = lib().vt_probe(x.data_ptr(), out.data_ptr(), x.numel(), dev,
                         stream_handle(dev))
    if err:
        raise launch_error("probe", err)
    count_launch("probe")
    return out


def compress(mean, weight, buf_value, buf_weight, compression):
    if mean.is_cpu:
        return compress_plain(mean, weight, buf_value, buf_weight,
                              compression)
    dev = mean.get_device()
    err = lib().vt_compress(mean.data_ptr(), weight.data_ptr(), dev,
                            stream_handle(dev))
    if err:
        raise launch_error("compress", err)
    count_launch("compress")
    return mean, weight


def smem_bytes(C, B):
    return lib().vt_compress_smem_bytes(C, B)


@triton.jit
def add_kernel(x_ptr, n):
    pass


def add_triton(x):
    if x.is_cpu:
        return add_plain(x)
    add_kernel[(1,)](x, x.numel())
    count_launch("add")
    return x
