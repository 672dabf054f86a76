"""Int8 symmetric quantization with Q_scale-constrained accumulator truncation.

Counterpart of ``repro.core.quantization``: the DLA datapath of the paper,

  int8 activations x int8 weights -> int16 products -> 24-bit accumulator
  -> truncate an 8-bit window [t+7 : t] out of the accumulator -> int8 output

with the truncation LSB ``t >= Q_scale``.  Integer results are bitwise those
of the reference; ``quantize`` keeps ``x / scale`` in float32 and rounds half
to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import scalar

INT8_MAX = 127
ACC_BITS = 24          # paper: "the accumulator data width is 24 bits"
MUL_OUT_BITS = 16      # 8b x 8b -> 16b product
OUT_BITS = 8

# |int8 * int8| <= 2**14, so a K-long dot product stays below 2**31 (the
# reference's int32 accumulator) for K below this
MAX_K = 1 << 17


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 8
    acc_bits: int = ACC_BITS
    q_scale: int = 0          # minimum allowed truncation LSB (paper's Q_scale)
    per_channel: bool = True  # per-output-channel weight scales


def quantize(x: torch.Tensor, bits: int = 8, axis=None):
    """Symmetric linear quantization.  Returns (q: int32, scale: float32)."""
    qmax = 2 ** (bits - 1) - 1
    ax = x.abs()
    amax = ax.amax() if axis is None else ax.amax(dim=axis, keepdim=True)
    floor = torch.full((), 1e-8, dtype=amax.dtype, device=amax.device)
    # a device-tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ from IEEE division by
    # one ulp; the reference, and the CPU, divide.  Both constants are
    # device fills, not host-to-device copies, so a CUDA graph can hold them
    scale = torch.maximum(amax, floor) / torch.full(
        (), float(qmax), dtype=amax.dtype, device=amax.device)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product ``a @ b`` of int8-valued tensors, as int32.

    Neither torch's CPU nor its CUDA build has an int32 matmul on every
    device, so the product runs in float64: every operand is an integer of
    magnitude <= 128 and every partial sum an integer below 2**31 < 2**53,
    so each float64 multiply and add is exact whatever the summation order,
    and the result equals the reference's int32 accumulation bit for bit.
    The same route runs on the CPU and the GPU.  ``b`` may carry a leading
    batch dimension (one weight matrix per row of ``a``).
    """
    if a.shape[-1] >= MAX_K:
        raise ValueError(f"K={a.shape[-1]} overflows the int32 accumulator")
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    if b.dim() == 3:
        acc = torch.matmul(a64.unsqueeze(1), b64).squeeze(1)
    else:
        acc = a64 @ b64
    return acc.to(torch.int32)


def saturate(acc: torch.Tensor, bits: int = ACC_BITS) -> torch.Tensor:
    """Saturating arithmetic at ``bits``-wide two's complement."""
    return torch.clamp(acc, -(1 << (bits - 1)), (1 << (bits - 1)) - 1)


def choose_trunc_lsb(acc_absmax: torch.Tensor, out_bits: int = OUT_BITS,
                     q_scale=0, acc_bits: int = ACC_BITS) -> torch.Tensor:
    """Truncation LSB ``t = clip(bit_length(max(a, 1)) - (out_bits-1),
    q_scale, acc_bits-out_bits)``, the bit length a popcount over threshold
    compares as in the reference.  ``q_scale`` may be an int or an int
    tensor (the traced ``dyn`` knob); it never leaves the device."""
    a = torch.clamp(acc_absmax.abs().to(torch.int32), min=1)
    thresholds = 1 << torch.arange(acc_bits, dtype=torch.int32,
                                   device=a.device)
    need = (a.unsqueeze(-1) >= thresholds).sum(-1).to(torch.int32)
    t = torch.clamp(need - (out_bits - 1), min=0)
    t = torch.maximum(t, scalar(q_scale, torch.int32, t.device))
    return torch.minimum(t, scalar(acc_bits - out_bits, torch.int32,
                                   t.device))


def truncate_acc(acc: torch.Tensor, t, out_bits: int = OUT_BITS):
    """Signed window [t+out_bits-1 : t] of the accumulator with round-to-
    nearest and saturation (the DLA requantization step)."""
    t = scalar(t, torch.int32, acc.device)
    half = torch.where(t > 0, 1 << torch.clamp(t - 1, min=0),
                       torch.zeros_like(t))
    rounded = (acc + half) >> t
    qmax = 2 ** (out_bits - 1) - 1
    return torch.clamp(rounded, -qmax - 1, qmax)


def qmatmul(xq: torch.Tensor, wq: torch.Tensor, q_scale=0):
    """Bit-exact DLA matmul: int8 x int8 -> saturating 24-bit acc -> int8
    window.  Returns (yq int32 (M, N), t int32 scalar)."""
    acc = saturate(int_matmul(xq, wq))
    t = choose_trunc_lsb(acc.abs().amax(), q_scale=q_scale)
    return truncate_acc(acc, t), t


def fake_quant_linear(x: torch.Tensor, w: torch.Tensor, q_scale: int = 0):
    """Float-in/float-out linear computed through the quantized DLA datapath.

    Returns (y, aux): aux carries the integer intermediates (xq, wq, t) and
    the scales (sx, sw).  ``2**t`` is formed from an integer shift, exactly
    as the reference's ``2.0 ** t``.
    """
    xq, sx = quantize(x, axis=None)
    wq, sw = quantize(w, axis=None)
    yq, t = qmatmul(xq, wq, q_scale)
    scale = sx * sw * (torch.ones_like(t) << t).to(torch.float32)
    return yq.to(torch.float32) * scale, dict(xq=xq, wq=wq, t=t, sx=sx,
                                              sw=sw)


def quant_error(x: torch.Tensor, q_scale: int) -> torch.Tensor:
    """Relative RMS error introduced by quantizing through the constrained
    datapath (paper Fig. 11, Q_scale vs accuracy)."""
    w = torch.eye(x.shape[-1], dtype=torch.float32, device=x.device)
    y, _ = fake_quant_linear(x, w, q_scale=q_scale)
    return (torch.sqrt(torch.mean((y - x) ** 2))
            / (torch.sqrt(torch.mean(x ** 2)) + 1e-9))
