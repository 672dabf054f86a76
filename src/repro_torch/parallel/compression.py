"""Gradient compression for the dp reduce path: int8 quantization with one
scale per shard and error feedback.

Counterpart of ``repro.parallel.compression``.  ``compressed_psum`` reduces
over a mesh dim's process group (``dist.all_reduce``): each rank quantizes
its local gradient to int8 and one float32 scale, the reduce carries the
dequantized values (the reference's ``psum`` of ``q * scale``), and the
error-feedback state carries the quantization residual into the next step,
so the optimizer sees an unbiased long-run gradient.  ``ef`` is shaped like
the gradient.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def quantize_grad(g, ef=None):
    """int8-quantize ``g`` (plus error feedback).  Returns (q, scale,
    new_ef), in the reference's float32 order of operations."""
    if ef is not None:
        g = g + ef
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, g - deq


def compressed_psum(g, group=None, ef=None):
    """int8-compressed mean of ``g`` over ``group``'s ranks.  Returns (mean,
    new_ef)."""
    q, scale, new_ef = quantize_grad(g, ef)
    total = q.to(torch.float32) * scale
    dist.all_reduce(total, group=group)
    return total / dist.get_world_size(group), new_ef


def compressed_psum_test(seed: int = 0, group=None) -> float:
    """Relative error of one compressed mean-reduce against the exact mean
    (test helper): every rank draws the whole (n, 64, 64) gradient stack
    from ``seed`` and reduces its own slice."""
    n = dist.get_world_size(group)
    g = torch.randn((n, 64, 64), generator=torch.Generator().manual_seed(seed))
    out, _ = compressed_psum(g[dist.get_rank(group)], group)
    exact = g.mean(0)
    return float(torch.linalg.norm(out - exact) / torch.linalg.norm(exact))
