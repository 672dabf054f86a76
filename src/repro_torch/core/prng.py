"""threefry2x32 in JAX's *partitionable* mode, as plain torch ops.

The reference has no file of its own for this: it calls ``jax.random``
after ``repro.core.faults`` switches on ``jax_threefry_partitionable``
process-wide.  The port draws the same fault bits from the same keys, so it
carries its own copy of the generator, bit for bit:

  * a key is a pair of 32-bit words, here an int64 tensor ``(..., 2)``
    holding values in ``[0, 2**32)`` (torch's CPU build has no shifts on
    ``uint32``, so every word lives in int64 and is masked to 32 bits);
  * ``split(key, n)``: ``threefry2x32(key, (0, i))`` for ``i < n``, stacked
    as ``(bits1, bits2)`` (jax ``_threefry_split_foldlike``);
  * ``fold_in(key, d)``: ``threefry2x32(key, (0, uint32(d)))``
    (jax ``_threefry_fold_in``);
  * ``bits(key, shape)``: ``bits1 ^ bits2`` over the counters
    ``(0, flat_index)`` (jax ``_threefry_random_bits_partitionable``);
  * ``uniform``: ``((bits >> 9) | 0x3F800000)`` viewed as float32, minus 1,
    then scaled to ``[minval, maxval)`` (jax ``_uniform``);
  * ``bernoulli(key, p, shape)``: ``uniform(key, shape) < float32(p)``;
  * ``randint(key, shape, lo, hi)``: two words per draw from ``split(key)``,
    reduced modulo the span in uint32 arithmetic (jax ``_randint``), so
    bitwise;
  * ``normal(key, shape)``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform in
    ``[nextafter(-1, 0), 1)`` (jax ``_normal_real``).  ``erfinv`` is XLA's
    (Giles' single-precision polynomial), evaluated here in the same steps
    with its Horner steps as fused multiply-adds, as XLA compiles them; its
    ``log1p`` is each framework's own, so a draw may sit up to 3 ulps from
    JAX's (1% of draws differ; tests/test_torch_cnn.py states the bound);
  * ``gumbel``: ``-log(-log(uniform(key, shape, tiny, 1)))`` (jax's "low"
    mode), and ``categorical``: the argmax of gumbel noise plus logits (jax's
    ``replace=True`` branch).

Every function accepts a batch of keys ``(..., 2)`` and maps over its leading
dimensions, which is what ``jax.vmap`` over a key batch computes.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r).bitwise_and_(MASK32)).bitwise_or_(x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) on int64 words; all four arguments
    broadcast together.  Returns the two output words.  The rounds update
    the two words in place (they are this function's own tensors), which
    saves an allocation per operation."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1, x2 = (t.contiguous() for t in torch.broadcast_tensors(
        (x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32))
    for i in range(5):
        for r in _ROT[i % 2]:
            x1.add_(x2).bitwise_and_(MASK32)
            x2 = _rotl(x2, r).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x2.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK32)
    return x1, x2


def as_key(key, device=None) -> torch.Tensor:
    """A key (or key batch) as an int64 tensor; accepts numpy uint32 arrays."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device or key.device, dtype=torch.int64)
    return torch.tensor(np.asarray(key).astype(np.int64) & MASK32,
                        device=device)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: with 64-bit types off, jax narrows the
    seed to 32 bits, so the key is ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _hash_counters(key: torch.Tensor, n: int):
    """threefry over the counters ``(0, i)``, ``i < n``, for every key of a
    batch: two ``(..., n)`` words."""
    if n >= 2 ** 32:
        raise NotImplementedError("more than 2**32 draws from one key")
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` -> ``(..., num, 2)``."""
    b1, b2 = _hash_counters(key, num)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` is taken as uint32 (site ids from
    ``crc32`` reach ``2**32 - 1``).  ``data`` may be an int or an int tensor,
    which broadcasts against the key batch: ``fold_in(key, ids)`` with one
    key and a (B,) vector is ``vmap(fold_in, (None, 0))``, and with a (B, 2)
    key batch it folds row by row."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & MASK32
    else:       # a fill, not a host-to-device copy, which would sync
        d = torch.full((), int(data) & MASK32, dtype=torch.int64,
                       device=key.device)
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([o1, o2], dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (uint32) as int64 words: ``(..., *shape)``."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    b1, b2 = _hash_counters(key, n)
    return (b1 ^ b2).reshape(*key.shape[:-1], *shape)


def as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """The 32-bit patterns of uint32 ``words`` (int64 in ``[0, 2**32)``) as
    int32: words of ``2**31`` and above become negative.  What a CUDA kernel
    reads as ``uint32``.  (Subtracting ``2**32`` first: a plain cast of an
    int64 above the int32 range is not guaranteed to wrap.)"""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def uniform(key: torch.Tensor, shape, minval=0., maxval=1.) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top 23
    bits of each word as a mantissa under exponent 0, minus 1, then
    ``max(minval, floats * (maxval - minval) + minval)`` in float32.  At the
    default range that expression is the identity, so it is skipped."""
    words = bits(key, shape)
    f = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = f - 1.0
    if minval == 0. and maxval == 1.:
        return floats
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, _fma32(floats, hi - lo, lo))


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """float32 ``a * b + c`` rounded once, as the compiled reference computes
    it (XLA contracts the expression into a fused multiply-add).  The product
    of two float32 values is exact in float64; the float64 sum ``y`` is
    rounded, so where ``y`` lands on a float32 midpoint its rounding error
    ``err`` (TwoSum) decides the tie."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    y = p + c
    cc = y - p
    err = (p - (y - cc)) + (c - cc)
    r = y.to(torch.float32)
    r64 = r.to(torch.float64)
    n = torch.nextafter(r, torch.where(y > r64, torch.inf, -torch.inf)
                        .to(torch.float32))
    tie = ((r64 + n.to(torch.float64)) * 0.5 == y) & (err != 0)
    return torch.where(tie & ((err > 0) == (n > r)), n, r)


def bernoulli(key: torch.Tensor, p, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` with a float32 ``p`` (a Python
    float, or a float32 tensor broadcastable against the draw)."""
    if not isinstance(p, torch.Tensor):
        p = torch.full((), p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < p


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default "low" mode:
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis (the Gumbel
    max trick).  ``key`` is one key for the whole ``logits`` tensor, or a
    batch of keys ``(..., 2)`` whose leading dims are those of ``logits``
    but the last: one key per row, as ``vmap`` over rows computes.
    Returns int64 indices."""
    noise = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(noise + logits, dim=-1)


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 (the
    reference's default integer type), as int64 values: the high and low
    words of each draw, from ``split(key)``, reduced modulo the span in
    uint32 arithmetic."""
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError("randint bounds outside int32")
    k = split(key, 2)
    hi, lo = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    span = maxval - minval if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & MASK32) % span    # uint32 product wraps
    off = ((hi % span) * mult & MASK32) + lo % span
    return minval + (off & MASK32) % span


# XLA's single-precision erf_inv (M. Giles, "Approximating the erfinv
# function"): Horner coefficients, highest power first, for w < 5 and above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``lax.erf_inv`` as XLA computes it: ``w = -log1p(-x*x)``,
    a degree-8 polynomial in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, times
    ``x``; +-inf at +-1."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(
            lt, torch.full((), _ERFINV_LT5[i], dtype=torch.float32,
                           device=x.device),
            torch.full((), _ERFINV_GE5[i], dtype=torch.float32,
                       device=x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma32(p, w, coef(i))
    inf = torch.full((), torch.inf, dtype=torch.float32, device=x.device)
    return torch.where(x.abs() == 1, x * inf, p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) * erfinv(u)``,
    ``u`` uniform in ``[nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = uniform(key, shape, lo, 1.)
    sqrt2 = torch.full((), float(np.float32(np.sqrt(2))), dtype=torch.float32,
                       device=key.device)
    return sqrt2 * erfinv(u)
