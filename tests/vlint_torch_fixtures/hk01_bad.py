"""HK01 fixture: kernel entries outside veneur_tpu_torch/kernels/. This
docstring may name load_inline, triton.jit and variants/ freely."""

import ctypes
import os

import triton                                                   # HK01
from torch.utils.cpp_extension import load_inline               # HK01

from veneur_tpu_torch.kernels import stream_handle

SRC = "__global__ void k(float *x) { x[0] += 1.0f; }"
VARIANT = os.path.join("veneur_tpu_torch", "variants", "k.cu")  # HK01


@triton.jit
def add_kernel(x_ptr, n):
    pass


def build_inline():
    return load_inline(name="k", cpp_sources="", cuda_sources=SRC)  # HK01


def load_library(path):
    return ctypes.CDLL(path)                                     # HK01


def launch_entry(lib, x, dev):
    return lib.vt_probe(x.data_ptr(), x.numel(), dev,            # HK01
                        stream_handle(dev))


def launch_triton(x, n):
    add_kernel[(1,)](x, n)                                       # HK01


def documented_host_library(path):
    # vlint: disable=HK01 reason=fixture-only host library with no
    # device code, like the native ingest bridge
    return ctypes.CDLL(path)


def ctypes_types_are_fine():
    return ctypes.c_int32(3)
