"""Float-in/float-out fault-tolerant linear on the protected-matmul kernel.

Counterpart of ``repro.kernels.protected_mm.ops``.  The truncation LSB ``t``
is per-layer deployment state on the DLA (chosen once at calibration), so it
is a static argument here; ``calibrate_t`` derives it from sample data.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core import quantization as Q
from repro_torch.kernels.fault_inject.ops import random_planes
from repro_torch.kernels.protected_mm.kernel import protected_mm


def calibrate_t(x: torch.Tensor, w: torch.Tensor, q_scale: int = 7) -> int:
    """The per-layer truncation LSB that the clean product of ``x`` and
    ``w`` needs, at least ``q_scale`` (a host sync)."""
    xq, _ = Q.quantize(x)
    wq, _ = Q.quantize(w)
    acc = Q.saturate(Q.int_matmul(xq, wq))
    return int(Q.choose_trunc_lsb(acc.abs().amax(), q_scale=q_scale))


def plane_streams(key: torch.Tensor, shape, m: int, n: int):
    """The ordinary and the important (DPPU) plane streams of one call:
    ``random_planes`` of each half of ``split(key)`` over ``shape`` (the
    shape is part of the stream), their (m, n) corner as the int32 bit
    patterns the kernel takes."""
    return tuple(prng.as_int32_bits(random_planes(k, shape)[:, :m, :n])
                 .contiguous() for k in prng.split(key))


def ft_linear_fused(key, x: torch.Tensor, w: torch.Tensor,
                    important: torch.Tensor, *, t: int, ber, ib: int = 2,
                    nb: int = 1) -> torch.Tensor:
    """x: (M, K) float; w: (K, N) float; important: (N,) bool.  Draws both
    plane streams over the (M, N) output."""
    m, n = x.shape[0], w.shape[1]
    xq, sx = Q.quantize(x)
    wq, sw = Q.quantize(w)
    rnd_o, rnd_i = plane_streams(prng.as_key(key, x.device), (m, n), m, n)
    yq = protected_mm(xq.to(torch.int8), wq.to(torch.int8), rnd_o, rnd_i,
                      important.to(torch.int32), t=t, ber=float(ber), ib=ib,
                      nb=nb)
    return yq.to(torch.float32) * (sx * sw * (2.0 ** t))
