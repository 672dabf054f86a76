"""Hopper kernel for the quantized DLA matmul: launcher.

Counterpart of ``repro.kernels.qmatmul.kernel::qmatmul`` (the Pallas TPU
kernel).  The CUDA source is ``csrc/qmatmul.cu`` (GEMM core and epilogue
helpers in ``kernels/csrc/dla.cuh``); its header says what it computes, how
it is laid out across blocks and what bounds it.  It is built with ``nvcc``
for ``sm_90a`` at first use (``repro_torch.kernels.build``) and loaded with
``ctypes``.

The launch plan (block tile, K chunk, number of chunks) is
``kernels/plan.py::gemm_plan``'s for the device's SM count, as for
``protected_mm``: the launcher takes it as arguments.

``qmatmul`` takes the plain version (``ref.qmatmul_ref``) only for tensors
that lie on the CPU; for CUDA tensors it launches the kernel or raises.
``qmatmul.launches`` counts the kernel's launches (one per call).
"""
from __future__ import annotations

import ctypes
import functools
import numbers
from pathlib import Path

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels.build import (build_library, check_operand, launch,
                                      load, sm_count)
from repro_torch.kernels.plan import gemm_plan
from repro_torch.kernels.qmatmul.ref import qmatmul_ref

SOURCES = (Path(__file__).with_name("csrc").joinpath("qmatmul.cu"),)
# the widest static window LSB the kernels' int32 shifts take
MAX_T = 30


def build():
    """Compile the kernel (a no-op when it is built); returns the library's
    path and nvcc's report."""
    return build_library("qmatmul", SOURCES)


@functools.cache
def _lib() -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return load("qmatmul", SOURCES, [ptr] * 3 + [i32] * 8)


def check_gemm(kernel: str, xq, wq, t):
    """The checks every DLA GEMM kernel makes of its operands and of its
    static ``t``; returns (M, K, N, t) with ``t`` a Python int."""
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"{kernel}: xq {tuple(xq.shape)} and wq "
                         f"{tuple(wq.shape)} do not chain")
    if (isinstance(t, bool) or not isinstance(t, numbers.Integral)
            or not 0 <= t <= MAX_T):
        raise ValueError(f"{kernel}: t must be an int in [0, {MAX_T}], "
                         f"got {t!r}")
    (M, K), N = xq.shape, wq.shape[1]
    if K >= Q.MAX_K:
        raise ValueError(f"{kernel}: K={K} overflows the int32 accumulator")
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, not "
                         f"{xq.device.type}")
    if xq.device.type == "cuda":
        check_operand(kernel, "xq", xq, torch.int8, (M, K), xq.device)
        check_operand(kernel, "wq", wq, torch.int8, (K, N), xq.device)
    return M, K, N, int(t)


def qmatmul(xq, wq, t: int):
    """xq: (M, K) int8; wq: (K, N) int8; static ``t`` -> (M, N) int8.  No
    tile alignment is needed."""
    M, K, N, t = check_gemm("qmatmul", xq, wq, t)
    if xq.device.type == "cpu":
        return qmatmul_ref(xq, wq, t)
    dev = xq.device
    y = torch.empty((M, N), dtype=torch.int8, device=dev)
    launch(_lib(), "qmatmul", dev, xq.data_ptr(), wq.data_ptr(), y.data_ptr(),
           M, N, K, t, *gemm_plan(M, K, N, sm_count(dev)))
    qmatmul.launches += 1
    return y


qmatmul.launches = 0
