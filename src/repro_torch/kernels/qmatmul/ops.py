"""Float-in/float-out linear through the quantized DLA matmul kernel.

Counterpart of ``repro.kernels.qmatmul.ops``.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels.qmatmul.kernel import qmatmul


def quant_linear(x: torch.Tensor, w: torch.Tensor, t: int) -> torch.Tensor:
    """x: (M, K) float; w: (K, N) float; static truncation LSB ``t``.
    Returns (M, N) float32 ``yq * (sx * sw * 2**t)``."""
    xq, sx = Q.quantize(x)
    wq, sw = Q.quantize(w)
    yq = qmatmul(xq.to(torch.int8), wq.to(torch.int8), t)
    return yq.to(torch.float32) * (sx * sw * (2.0 ** t))
