"""Plain version of the fused inject->protect->qmatmul kernel.

Counterpart of ``repro.kernels.fused_decode.ref``: the kernel's contract as
composed integer torch ops on the operands the kernel sees, i.e. quantized
integers plus pre-drawn packed flip words.  All fault randomness is resolved
before this function, so the kernel is held to it bitwise.  The CPU tests
use it, ``kernel.fused_decode`` takes it for CPU tensors, and
``chip_smoke.py`` compares the CUDA kernel with it on the card.

  int8 x int8 -> int32 accumulate -> 24-bit saturate -> truncation LSB ``t``
  from the accumulator's bit length (Q_scale-constrained) -> 8-bit
  round-to-nearest window -> XOR output flip word -> sign-extend
  [-> DPPU clean recompute, same ``t``, own flip word, select important]
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as Q

ACC_BITS = Q.ACC_BITS
OUT_BITS = Q.OUT_BITS


def sign_extend8(u: torch.Tensor, bits: int = OUT_BITS) -> torch.Tensor:
    """Reinterpret the low ``bits`` of int32 ``u`` as two's complement."""
    sign = 1 << (bits - 1)
    return torch.where((u & sign) != 0, u - (1 << bits), u)


def faulty_weights(wq: torch.Tensor, wflips: torch.Tensor,
                   bits: int = OUT_BITS) -> torch.Tensor:
    """Apply packed per-row weight flip words: (K, N) x (M, K, N) -> (M, K, N)."""
    uw = (wq.to(torch.int32).unsqueeze(0) & ((1 << bits) - 1)) ^ wflips
    return sign_extend8(uw, bits)


def fused_ref(xq, wq, oflips, q_scale, *, per_row: bool = False,
              wflips=None, wq_clean=None, dflips=None, imp=None,
              acc_bits: int = ACC_BITS, out_bits: int = OUT_BITS):
    """The fused kernel's exact contract.

    Args:
      xq: (M, K) int8-valued activations.  wq: (K, N) int8-valued weights,
        already weight-faulted in shared-fault mode.
      oflips: (M, N) int32 packed output flip words.
      q_scale: minimum truncation LSB, an int or an int tensor.
      per_row: per-row truncation LSB instead of one global ``t``.
      wflips: optional (M, K, N) per-row weight flip words.
      wq_clean: clean weights for the DPPU recompute (defaults to ``wq``).
      dflips/imp: DPPU flip words (M, N) and important mask (N,); both given
        iff the policy recomputes important channels.
    Returns:
      (yq, t): int32 outputs (M, N) and ``t``, (M, 1) when per_row else 0-d.
    """
    xq = xq.to(torch.int32)
    wq = wq.to(torch.int32)
    if wflips is not None:
        acc = Q.int_matmul(xq, faulty_weights(wq, wflips, out_bits))
    else:
        acc = Q.int_matmul(xq, wq)
    acc = Q.saturate(acc, acc_bits)
    absmax = (acc.abs().amax(dim=1, keepdim=True) if per_row
              else acc.abs().amax())
    t = Q.choose_trunc_lsb(absmax, out_bits=out_bits, q_scale=q_scale,
                           acc_bits=acc_bits)
    mask_all = (1 << out_bits) - 1
    y = sign_extend8((Q.truncate_acc(acc, t, out_bits) & mask_all) ^ oflips,
                     out_bits)
    if dflips is not None:
        wc = wq if wq_clean is None else wq_clean.to(torch.int32)
        acc_d = Q.saturate(Q.int_matmul(xq, wc), acc_bits)
        y_d = sign_extend8(
            (Q.truncate_acc(acc_d, t, out_bits) & mask_all) ^ dflips,
            out_bits)
        y = torch.where(imp.reshape(1, -1) != 0, y_d, y)
    return y, t
