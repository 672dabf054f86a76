"""AdamW with warmup and cosine decay and global-norm clipping.

Counterpart of ``repro.optim.adamw``: the same schedule and update, in
float32 on the device, with the moments stored in ``AdamWConfig.dtype``
(float32 by default).  Plain tensor ops: no kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    dtype: str = "float32"


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """float32 learning rate at ``step`` (a device tensor): linear warmup,
    then cosine decay to ``min_lr_frac`` of ``lr``."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.dtype`` beside each parameter, and the step
    counter, a 0-d int32 tensor on the parameters' device."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
    dev = leaves(params)[0].device
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """The norm of every leaf of ``tree`` (a dict tree or a list) as one
    vector."""
    xs = tree if isinstance(tree, list) else leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in xs))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig,
                 inplace: bool = False, grad_norm=None):
    """One AdamW step.  Returns (params, {"m", "v", "step"}, {"grad_norm",
    "lr"}): new tensors (the inputs stay as they were), or with ``inplace``
    the input parameters and moments, overwritten leaf by leaf (the same
    values, with one leaf's temporaries alive at a time instead of a
    second state).  ``grad_norm``: the clipping norm, where ``grads`` are
    one rank's shards of the whole gradients it was taken over."""
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m2 = b1 * m.to(torch.float32) + (1 - b1) * g
        v2 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        decay = cfg.weight_decay * p.to(torch.float32) if p.dim() >= 2 \
            else 0.0
        p2 = p.to(torch.float32) - lr * (u + decay)
        if inplace:
            return p.copy_(p2), m.copy_(m2), v.copy_(v2)
        return p2.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_p, new_m, new_v = (_pick(out, i) for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, {
        "grad_norm": gnorm, "lr": lr}


def _pick(tree, i):
    """The ``i``-th of each leaf tuple of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
