"""Random-plane generation and the fault-injection kernel.

Counterpart of ``repro.kernels.fault_inject.ops``.  ``random_planes`` is the
plane source of ``protect_linear(backend="pallas")`` and ``ft_linear_fused``
too: the same keys give ``jax.random.bits``'s words.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.kernels.fault_inject.kernel import fault_inject


def random_planes(key: torch.Tensor, shape, bits: int = 8) -> torch.Tensor:
    """``jax.random.bits(key, (bits, *shape), uint32)``, as int64 words."""
    return prng.bits(key, (bits, *shape))


def inject(key, x: torch.Tensor, protect: torch.Tensor, ber) -> torch.Tensor:
    """Inject faults into the 8-bit values ``x`` (M, N) at BER ``ber`` (a
    Python float), the top ``protect[col]`` bits immune."""
    rnd = random_planes(prng.as_key(key, x.device), x.shape)
    return fault_inject(x, prng.as_int32_bits(rnd), protect, float(ber))
