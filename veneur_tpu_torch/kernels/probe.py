"""Wrapper of the availability probe kernel (csrc/probe.cu).

Counterpart of veneur_tpu/kernels/__init__.py:probe_interpret: can this
card run a trivial kernel from the built library before the real ones?
`probe_add` computes x + 1; on a CUDA tensor it launches the kernel, on
a CPU tensor it runs the plain version, `probe_plain`.
"""

from __future__ import annotations

import torch

from . import launch_error, launches, lib, require_cuda, stream_handle

SHAPE = (8, 128)


def probe_plain(x):
    return x + 1.0


def probe_add(x):
    """x + 1 for an f32 tensor."""
    if x.is_cpu:
        return probe_plain(x)
    # the checks of require_cuda inline (this call is all host time);
    # require_cuda names the one that failed
    if not (x.is_cuda and x.dtype is torch.float32 and x.dim() == 2
            and x.is_contiguous()):
        require_cuda("probe x", x, torch.float32, 2)
    n = x.numel()
    if n == 0:
        raise ValueError("probe: empty tensor")
    dev = x.get_device()
    out = torch.empty_like(x)
    err = lib().vt_probe(x.data_ptr(), out.data_ptr(), n, dev,
                         stream_handle(dev))
    if err:
        raise launch_error("probe", err)
    launches["probe"] += 1
    return out


def probe(device) -> bool:
    """Build (on first use) and run the probe on `device`: True when
    every element of zeros(8, 128) + 1 reads 1.0."""
    x = torch.zeros(SHAPE, dtype=torch.float32, device=device)
    return bool((probe_add(x) == 1.0).all())
