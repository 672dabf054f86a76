"""Hopper kernel for the fused inject->protect->qmatmul datapath: launcher.

Counterpart of ``repro.kernels.fused_decode.kernel::fused_decode`` (the
Pallas TPU kernel).  The CUDA source is ``csrc/fused_decode.cu``; its header
says what it computes, how it is laid out across blocks, and what bounds it.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface (``build()``, through ``repro_torch.kernels.build``) at
first use, and loaded with ``ctypes``.

The launch plan (block tile, K chunk, number of chunks) is
``kernels/plan.py::gemm_plan``'s, for the device's SM count; the launcher
takes it as arguments, so the CPU tests can hold the chunking it implies.
One int32 scratch tensor carries the row maxima (zeroed by the launcher)
and the accumulators.

``fused_decode`` takes the plain version (``ref.fused_ref``) only for tensors
that lie on the CPU; for CUDA tensors it launches the kernel or raises.
``fused_decode.launches`` counts the kernel's launches (one per call).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels.build import (build_library, check_operand, launch,
                                      load, sm_count)
from repro_torch.kernels.fused_decode.ref import fused_ref
from repro_torch.kernels.plan import gemm_plan

DPPU_SOURCES = ("none", "reuse", "w", "wcl")
SOURCES = (Path(__file__).with_name("csrc").joinpath("fused_decode.cu"),)


def build():
    """Compile the kernel (a no-op when it is built); returns the library's
    path and nvcc's report."""
    return build_library("fused_decode", SOURCES)


@functools.cache
def _lib() -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return load("fused_decode", SOURCES, [ptr] * 11 + [i32] * 9)


_check = functools.partial(check_operand, "fused_decode")


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_decode(xq, wq, oflips, q_scale, *, wq_clean=None, wflips=None,
                 dflips=None, imp=None, per_row: bool = False,
                 dppu_src: str = "none", perrow_wf: bool = False):
    """One fused protected projection on integer operands.

    Args (as the Pallas kernel's; no tile alignment is needed):
      xq: (M, K) int8.  wq: (K, N) int8, pre-faulted in shared-fault mode.
      oflips: (M, N) int32 packed output flip words.
      q_scale: int32 tensor of one element, the minimum truncation LSB.
      wq_clean: (K, N) int8 clean weights (dppu_src="wcl" only).
      wflips: (M, K, N) int32 per-row weight flip words (perrow_wf only).
      dflips: (M, N) int32 DPPU flip words; imp: (N,) or (1, N) int32 mask
        (dppu_src != "none" only).
      per_row: per-row truncation LSB instead of one global t.
      dppu_src: "none" | "reuse" (recompute from the same accumulator) |
        "w" (from ``wq``) | "wcl" (from ``wq_clean``).
    Returns:
      (y, t): (M, N) int8 and (M, 1) int32 (all rows equal unless per_row).
    """
    if dppu_src not in DPPU_SOURCES:
        raise ValueError(f"dppu_src {dppu_src!r} not in {DPPU_SOURCES}")
    if perrow_wf and dppu_src == "reuse":
        raise ValueError("dppu_src='reuse' recomputes from the faulty "
                         "accumulator, which per-row weight flips make "
                         "row-private; use 'w' or 'wcl'")
    if (wflips is not None) != perrow_wf:
        raise ValueError("wflips must be given iff perrow_wf")
    if (wq_clean is not None) != (dppu_src == "wcl"):
        raise ValueError("wq_clean must be given iff dppu_src == 'wcl'")
    dppu = dppu_src != "none"
    if (dflips is not None) != dppu or (imp is not None) != dppu:
        raise ValueError("dflips and imp must be given iff dppu_src != 'none'")
    M, K = xq.shape
    N = wq.shape[1]
    if K >= Q.MAX_K:
        raise ValueError(f"K={K} overflows the int32 accumulator")

    if xq.device.type == "cpu":
        y, t = fused_ref(xq, wq, oflips, q_scale.reshape(()), per_row=per_row,
                         wflips=wflips, wq_clean=wq_clean, dflips=dflips,
                         imp=None if imp is None else imp.reshape(-1))
        return y.to(torch.int8), torch.broadcast_to(
            t.reshape(-1, 1), (M, 1)).contiguous()
    if xq.device.type != "cuda":
        raise ValueError("fused_decode runs on CUDA or CPU tensors, "
                         f"not {xq.device.type}")

    dev = xq.device
    _check("xq", xq, torch.int8, (M, K), dev)
    _check("wq", wq, torch.int8, (K, N), dev)
    _check("oflips", oflips, torch.int32, (M, N), dev)
    _check("q_scale", q_scale.reshape(1), torch.int32, (1,), dev)
    if wq_clean is not None:
        _check("wq_clean", wq_clean, torch.int8, (K, N), dev)
    if wflips is not None:
        _check("wflips", wflips, torch.int32, (M, K, N), dev)
    if dppu:
        _check("dflips", dflips, torch.int32, (M, N), dev)
        imp = imp.reshape(-1)
        _check("imp", imp, torch.int32, (N,), dev)

    y = torch.empty((M, N), dtype=torch.int8, device=dev)
    t = torch.empty((M, 1), dtype=torch.int32, device=dev)
    separate = dppu_src in ("w", "wcl")
    plan = gemm_plan(M, K, N, sm_count(dev))
    # rowmax[M], acc[M, N] (and the DPPU's acc[M, N])
    scratch = torch.empty(M + (2 if separate else 1) * M * N,
                          dtype=torch.int32, device=dev)
    w2 = wq_clean if dppu_src == "wcl" else (wq if separate else None)
    launch(_lib(), "fused_decode", dev,
           _ptr(xq), _ptr(wq), _ptr(w2), _ptr(wflips), _ptr(oflips),
           _ptr(dflips), _ptr(imp), _ptr(q_scale), _ptr(scratch), _ptr(y),
           _ptr(t), M, N, K, int(per_row), 2 if separate else int(dppu),
           *plan)
    fused_decode.launches += 1
    return y, t


fused_decode.launches = 0
