"""HK01 good fixture inside the kernels' home (the /hk01_kernels_ marker
stands for veneur_tpu_torch/kernels/): the build, the library load and
the launch belong here."""

import ctypes
import importlib.machinery

import triton
from torch.utils.cpp_extension import load_inline

from veneur_tpu_torch.kernels import stream_handle


@triton.jit
def add_kernel(x_ptr, n):
    pass


def build_inline(src):
    return load_inline(name="k", cpp_sources="", cuda_sources=src)


def load_library(path):
    return ctypes.CDLL(path)


def load_extension(name, path):
    return importlib.machinery.ExtensionFileLoader(name, path)


def launch_entry(lib, x, dev):
    return lib.vt_probe(x.data_ptr(), x.numel(), dev, stream_handle(dev))


def launch_triton(x, n):
    add_kernel[(1,)](x, n)
