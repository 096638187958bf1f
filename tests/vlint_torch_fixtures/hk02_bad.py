"""HK02 fixture: kernel wrappers without their plain version or their
launch count, and counts where no launch is."""

import triton

from veneur_tpu_torch.kernels import count_launch, lib, stream_handle


def add_plain(x):
    return x + 1.0


def no_plain_branch(x):                                          # HK02
    dev = x.get_device()
    lib().vt_probe(x.data_ptr(), x.numel(), dev, stream_handle(dev))
    count_launch("probe")
    return x


def inline_plain_is_not_a_plain_version(x):                      # HK02
    if x.is_cpu:
        return x + 1.0
    dev = x.get_device()
    lib().vt_probe(x.data_ptr(), x.numel(), dev, stream_handle(dev))
    count_launch("probe")
    return x


def uncounted(x):
    if x.is_cpu:
        return add_plain(x)
    dev = x.get_device()
    lib().vt_probe(x.data_ptr(), x.numel(), dev, stream_handle(dev))  # HK02
    return x


def counts_the_plain_call(x):
    if x.is_cpu:
        count_launch("probe")                                    # HK02
        return add_plain(x)
    dev = x.get_device()
    lib().vt_probe(x.data_ptr(), x.numel(), dev, stream_handle(dev))
    count_launch("probe")
    return x


def counts_without_launching(x):
    count_launch("probe")                                        # HK02
    return add_plain(x)


@triton.jit
def add_kernel(x_ptr, n):
    pass


def triton_uncounted(x):
    if x.is_cpu:
        return add_plain(x)
    add_kernel[(1,)](x, x.numel())                               # HK02
    return x


def documented_wrapper(x):
    if x.is_cpu:
        return add_plain(x)
    dev = x.get_device()
    # vlint: disable=HK02 reason=fixture-only: a launch whose count its
    # caller owns
    lib().vt_probe(x.data_ptr(), x.numel(), dev, stream_handle(dev))
    return x
