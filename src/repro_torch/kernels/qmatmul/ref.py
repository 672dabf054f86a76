"""Plain version of the quantized DLA matmul kernel.

Counterpart of ``repro.kernels.qmatmul.ref``: int8-valued operands through a
saturating 24-bit accumulator and an 8-bit window at a static LSB ``t``, as
integer torch ops.  ``kernel.qmatmul`` takes it for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel to it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as Q
from repro_torch.core.quantization import saturate

ACC_BITS = Q.ACC_BITS
OUT_BITS = Q.OUT_BITS


def truncate(acc: torch.Tensor, t: int, out_bits: int = OUT_BITS):
    """Round-to-nearest window [t+out_bits-1 : t] at a static ``t``,
    saturated to ``out_bits``; ``>>`` is an arithmetic (floor) shift."""
    half = (1 << (t - 1)) if t > 0 else 0
    r = (acc + half) >> t
    qmax = (1 << (out_bits - 1)) - 1
    return torch.clamp(r, -qmax - 1, qmax)


def qmatmul_ref(xq, wq, t: int, acc_bits: int = ACC_BITS):
    """int8-valued inputs -> int8 output through a saturating ``acc_bits``
    accumulator and an 8-bit window at LSB ``t``."""
    acc = Q.int_matmul(xq.to(torch.int32), wq.to(torch.int32))
    return truncate(saturate(acc, acc_bits), t).to(torch.int8)
