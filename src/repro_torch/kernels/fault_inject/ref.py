"""Plain version of the bit-flip fault-injection kernel.

Counterpart of ``repro.kernels.fault_inject.ref``: deterministic given the
random planes, so the kernel is held to it bitwise.  The planes are uint32
words, as int64 words (``prng.bits``) or as their 32-bit patterns in int32
(what the CUDA kernels take); both compare unsigned here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_decode.ref import sign_extend8

MASK32 = 0xFFFFFFFF


def threshold(ber) -> int:
    """The uint32 a plane word must fall below to flip its bit:
    ``min(int(ber * 2**32), 2**32 - 1)`` in float64, as the reference
    computes it from a Python float (BER 1.0 clamps to ``2**32 - 1``)."""
    return min(int(float(ber) * (1 << 32)), (1 << 32) - 1)


def inject_ref(x, rnd, protect, ber, bits: int = 8):
    """x: (M, N) int32 values ``bits`` wide; rnd: (bits, M, N) uint32 planes;
    protect: (N,) int32 protected high-bit count per output channel.  Bit
    ``b`` flips where ``rnd[b] < threshold(ber)`` and ``b < bits -
    protect[col]``; the result is sign-extended.  Returns (M, N) int32."""
    thresh = threshold(ber)
    words = rnd.to(torch.int64) & MASK32
    unprot_bits = (bits - protect.to(torch.int32)).reshape(1, -1)
    ux = x.to(torch.int32) & ((1 << bits) - 1)
    flips = torch.zeros_like(ux)
    for b in range(bits):
        hit = (words[b] < thresh) & (b < unprot_bits)
        flips = flips | (hit.to(torch.int32) << b)
    return sign_extend8(ux ^ flips, bits)
