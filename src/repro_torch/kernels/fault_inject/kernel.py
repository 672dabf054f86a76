"""Hopper kernel for bit-flip fault injection: launcher.

Counterpart of ``repro.kernels.fault_inject.kernel::fault_inject`` (the
Pallas TPU kernel).  The CUDA source is ``csrc/fault_inject.cu`` (the flip
epilogue in ``kernels/csrc/dla.cuh``); its header says what it computes and
what bounds it.  It is built with ``nvcc`` for ``sm_90a`` at first use and
loaded with ``ctypes``.

``fault_inject`` takes the plain version (``ref.inject_ref``) only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises.  ``fault_inject.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import (build_library, check_operand, launch,
                                      load)
from repro_torch.kernels.fault_inject.ref import inject_ref, threshold

SOURCES = (Path(__file__).with_name("csrc").joinpath("fault_inject.cu"),)
BITS = 8


def build():
    """Compile the kernel (a no-op when it is built); returns the library's
    path and nvcc's report."""
    return build_library("fault_inject", SOURCES)


@functools.cache
def _lib() -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return load("fault_inject", SOURCES,
                [ptr] * 4 + [i32] * 2 + [ctypes.c_uint32])


def fault_inject(x, rnd, protect, ber):
    """x: (M, N) int32 8-bit values; rnd: (8, M, N) int32, the 32-bit
    patterns of uint32 planes (``prng.as_int32_bits``); protect: (N,)
    int32; ``ber`` a Python float.  Returns (M, N) int32."""
    if x.dim() != 2:
        raise ValueError(f"fault_inject: x must be (M, N), got "
                         f"{tuple(x.shape)}")
    M, N = x.shape
    if x.device.type == "cpu":
        return inject_ref(x, rnd, protect, ber, BITS)
    if x.device.type != "cuda":
        raise ValueError("fault_inject runs on CUDA or CPU tensors, not "
                         f"{x.device.type}")
    dev = x.device
    check_operand("fault_inject", "x", x, torch.int32, (M, N), dev)
    check_operand("fault_inject", "rnd", rnd, torch.int32, (BITS, M, N), dev)
    check_operand("fault_inject", "protect", protect, torch.int32, (N,), dev)
    y = torch.empty((M, N), dtype=torch.int32, device=dev)
    launch(_lib(), "fault_inject", dev, x.data_ptr(), rnd.data_ptr(),
           protect.data_ptr(), y.data_ptr(), M, N, threshold(ber))
    fault_inject.launches += 1
    return y


fault_inject.launches = 0
