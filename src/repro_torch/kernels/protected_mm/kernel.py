"""Hopper kernel for the FlexHyCA PE array (protected matmul): launcher.

Counterpart of ``repro.kernels.protected_mm.kernel::protected_mm`` (the
Pallas TPU kernel).  The CUDA source is ``csrc/protected_mm.cu`` (GEMM core
and flip epilogue in ``kernels/csrc/dla.cuh``); its header says what it
computes, how it is laid out across blocks and what bounds it.  It is built
with ``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``.

The launch plan (block tile, K chunk, number of chunks) is
``kernels/plan.py::gemm_plan``'s, for the device's SM count; the launcher
takes it as arguments, so the CPU tests can hold the chunking it implies.

``protected_mm`` takes the plain version (``ref.protected_mm_ref``) only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises.  ``protected_mm.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import (build_library, check_operand, launch,
                                      load, sm_count)
from repro_torch.kernels.fault_inject.ref import threshold
from repro_torch.kernels.plan import gemm_plan
from repro_torch.kernels.protected_mm.ref import protected_mm_ref
from repro_torch.kernels.qmatmul.kernel import check_gemm

SOURCES = (Path(__file__).with_name("csrc").joinpath("protected_mm.cu"),)
BITS = 8


def build():
    """Compile the kernel (a no-op when it is built); returns the library's
    path and nvcc's report."""
    return build_library("protected_mm", SOURCES)


@functools.cache
def _lib() -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return load("protected_mm", SOURCES,
                [ptr] * 6 + [i32] * 4 + [ctypes.c_uint32] + [i32] * 6)


def protected_mm(xq, wq, rnd_ord, rnd_imp, imp, *, t: int, ber, ib: int,
                 nb: int):
    """One protected projection on integer operands.

    Args (as the Pallas kernel's; no tile alignment is needed):
      xq: (M, K) int8.  wq: (K, N) int8.
      rnd_ord, rnd_imp: (8, M, N) int32, the 32-bit patterns of the uint32
        planes of the ordinary and the important (DPPU) fault draws
        (``prng.as_int32_bits``).
      imp: (N,) int32 important-channel mask.
      t: static truncation LSB.  ber: a Python float.  ib, nb: protected
        high bits of important and ordinary channels.
    Returns (M, N) int8.
    """
    M, K, N, t = check_gemm("protected_mm", xq, wq, t)
    if xq.device.type == "cpu":
        return protected_mm_ref(xq, wq, rnd_ord, rnd_imp, imp, t=t, ber=ber,
                                ib=ib, nb=nb, bits=BITS)
    dev = xq.device
    for name, rnd in (("rnd_ord", rnd_ord), ("rnd_imp", rnd_imp)):
        check_operand("protected_mm", name, rnd, torch.int32, (BITS, M, N),
                      dev)
    check_operand("protected_mm", "imp", imp, torch.int32, (N,), dev)
    y = torch.empty((M, N), dtype=torch.int8, device=dev)
    launch(_lib(), "protected_mm", dev, xq.data_ptr(), wq.data_ptr(),
           rnd_ord.data_ptr(), rnd_imp.data_ptr(), imp.data_ptr(),
           y.data_ptr(), M, N, K, t, threshold(ber), int(ib), int(nb),
           *gemm_plan(M, K, N, sm_count(dev)))
    protected_mm.launches += 1
    return y


protected_mm.launches = 0
