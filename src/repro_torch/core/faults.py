"""Soft-error (bit-flip) fault injection: random bit flips at a given BER on
quantized neuron outputs and weights.

Counterpart of ``repro.core.faults``, drawing the same bits from the same
keys through the port's threefry copy (``repro_torch.core.prng``).

A TMR-protected bit only fails if >=2 of 3 replicas flip the same way, so a
protected bit's *residual* flip probability is ``3*ber^2*(1-ber) + ber^3``.

``ber`` is a Python float (static) or a 0-d float32 tensor (the reference's
traced BER: its policies carry ``ber`` as the one pytree leaf, so inside
``jit`` the residual rate is float32 arithmetic).  Keys may be one key
``(2,)`` or a batch ``(..., 2)``; a batch maps over its leading dimensions
as ``jax.vmap`` does.  Flip words are int32, as the fused kernel takes them.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.device import scalar

# one threefry evaluation covers at most this many draws; above it the
# planes of a flip word are drawn in groups to bound the int64 temporaries
_DRAWS_PER_PASS = 1 << 24


def residual_ber(ber):
    """Residual flip probability of a TMR-voted bit.  A float is evaluated in
    Python floats, as the reference does for a static BER; a float32 tensor
    one rounded float32 operation at a time, ``ber ** 3`` as ``(b*b)*b``
    (XLA's ``integer_pow``), as the reference does for a traced BER."""
    if isinstance(ber, torch.Tensor):
        return 3.0 * ber * ber * (1.0 - ber) + ber * ber * ber
    return 3.0 * ber * ber * (1.0 - ber) + ber ** 3


def fold_stream(key: torch.Tensor, *indices) -> torch.Tensor:
    """Fold each index into ``key`` in order (the repo's key-stream path)."""
    for i in indices:
        key = prng.fold_in(key, i)
    return key


def fold_axis_index(key: torch.Tensor, mesh, *axis_names) -> torch.Tensor:
    """Per-shard key stream: fold this rank's coordinate along each named
    dim of ``mesh`` (a DeviceMesh) into ``key``, in the order given, so
    shard ``s`` of one dim draws from ``fold_stream(key, s)`` and a host
    loop over the shards reproduces any shard's stream.  Draws of whole
    tensors need none: the counter-based stream is the same on every
    partition; a draw over a rank's own block of work (its buffers, not a
    block of a whole tensor) does."""
    for ax in axis_names:
        key = prng.fold_in(key, int(mesh.get_local_rank(ax)))
    return key


def _thresholds(ber, r, planes, device):
    """float32 threshold of each drawn plane: ``ber`` for raw planes, the
    residual rate for TMR-voted ones (odd split indices).  Built on the
    device from fills (no host-to-device copy, so a CUDA graph can hold
    it)."""
    lo, hi = (scalar(v, torch.float32, device) for v in (ber, r))
    return torch.stack([hi if j % 2 else lo for j in planes])


def flip_word(key: torch.Tensor, shape, ber, bits: int,
              protected_mask=0) -> torch.Tensor:
    """Packed XOR word of a bit-flip event: bit ``b`` of the result is set iff
    bit ``b`` of a ``shape``-shaped value flips under BER ``ber``.

    The draws match ``repro.core.faults.flip_word``: ``split(key, 2*bits)``,
    plane ``b`` raw from key ``2b`` at ``ber``, residual from key ``2b+1`` at
    the TMR residual rate, the residual one chosen where ``protected_mask``
    has bit ``b``.  Planes whose outcome cannot be used are not drawn (the
    draws are per-key, so skipping one changes no other).
    """
    shape = tuple(shape)
    static_ber = not isinstance(ber, torch.Tensor)
    if static_ber:
        ber = float(ber)
    else:
        ber = ber.to(torch.float32)
    r = residual_ber(ber)
    keys = prng.split(key, 2 * bits)                    # (..., 2*bits, 2)
    static_mask = isinstance(protected_mask, int)
    skip_res = static_ber and r == 0

    def needed(b):
        raw = not (static_mask and protected_mask >> b & 1)
        res = not skip_res and (not static_mask or protected_mask >> b & 1)
        return ([2 * b] if raw else []) + ([2 * b + 1] if res else [])

    planes = [j for b in range(bits) for j in needed(b)]
    numel = 1
    for s in shape:
        numel *= s
    group = max(1, _DRAWS_PER_PASS // max(numel, 1))
    drawn = {}
    for g0 in range(0, len(planes), group):
        sel = planes[g0:g0 + group]
        # a stack of views, not a list index: no host-to-device copy
        u = prng.uniform(torch.stack([keys[..., j, :] for j in sel], dim=-2),
                         shape)                  # (..., P, *shape)
        thr = _thresholds(ber, r, sel, key.device)
        f = u < thr.view(len(sel), *([1] * len(shape)))
        for i, j in enumerate(sel):
            drawn[j] = f.select(f.dim() - len(shape) - 1, i)

    lead = tuple(key.shape[:-1])
    flips = torch.zeros(lead + shape, dtype=torch.int32, device=key.device)
    if not static_mask:
        prot = torch.broadcast_to(torch.as_tensor(
            protected_mask, dtype=torch.int32, device=key.device), shape)
    for b in range(bits):
        raw, res = drawn.get(2 * b), drawn.get(2 * b + 1)
        if static_mask:
            f = res if protected_mask >> b & 1 else raw
        else:
            is_prot = (prot & (1 << b)) != 0
            if res is None:
                res = torch.zeros((), dtype=torch.bool, device=key.device)
            f = torch.where(is_prot, res, raw)
        if f is not None:
            flips = flips | (f.to(torch.int32) << b)
    return flips


def _sign_extend(ux: torch.Tensor, bits: int) -> torch.Tensor:
    sign = 1 << (bits - 1)
    return torch.where((ux & sign) != 0, ux - (1 << bits), ux)


def flip_bits(key: torch.Tensor, x: torch.Tensor, ber, bits: int,
              protected_mask=0, signed: bool = True) -> torch.Tensor:
    """Flip each of the low ``bits`` bits of two's-complement ``x`` with
    probability ``ber``; protected bits flip at the residual rate.  With a
    key batch ``(..., 2)`` the leading dimensions of ``x`` are the batch."""
    x = x.to(torch.int32)
    ux = x & ((1 << bits) - 1)
    ux = ux ^ flip_word(key, ux.shape[key.dim() - 1:], ber, bits,
                        protected_mask)
    return _sign_extend(ux, bits) if signed else ux


def top_bits_mask(n_top: int, bits: int) -> int:
    """Bitmask selecting the high ``n_top`` bits of a ``bits``-wide word."""
    n_top = max(0, min(n_top, bits))
    return ((1 << n_top) - 1) << (bits - n_top)


def protect_mask(protect_top, bits: int = 8):
    """Per-channel bitmask of TMR-protected bits from a protected-top-bits
    count (int, or an int tensor for per-channel IB_TH/NB_TH selection)."""
    if isinstance(protect_top, int):
        return top_bits_mask(protect_top, bits)
    p = torch.clamp(torch.as_tensor(protect_top).to(torch.int32), 0, bits)
    mask = ((1 << p) - 1) << (bits - p)
    return torch.where(p > 0, mask, torch.zeros_like(mask))


def inject_output_faults(key, yq: torch.Tensor, ber, *, bits: int = 8,
                         protect_top=0) -> torch.Tensor:
    """Faults in quantized neuron outputs; ``protect_top`` protected high
    bits, an int or a per-channel int tensor (last-dim broadcast)."""
    return flip_bits(key, yq, ber, bits,
                     protected_mask=protect_mask(protect_top, bits))


def inject_weight_faults(key, wq: torch.Tensor, ber,
                         bits: int = 8) -> torch.Tensor:
    """Faults in weight SRAM (unprotected; the paper protects compute)."""
    return flip_bits(key, wq, ber, bits)
