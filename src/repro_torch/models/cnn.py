"""The paper's benchmark CNNs (VGG16-style, ResNet50-style), reduced.

Counterpart of ``repro.models.cnn``.  Every convolution runs as an im2col
GEMM through ``repro_torch.models.common.linear``, as the DLA computes
convs on its MAC array, so the fault-injection / selective-protection stack
(``ftc``) and the importance probe (``probe``) apply to CNNs and LMs through
one code path: under a policy on the ``fused`` backend every conv and the
head are one ``fused_decode`` launch each.  Images are (B, H, W, C), as the
reference's; parameters a dict of ``{"w", "b"}`` dicts of tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch.core import prng
from repro_torch.models.common import dense_init, linear, tag


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    arch: str = "vgg"          # vgg | resnet
    channels: tuple = (16, 32)
    n_classes: int = 8
    hw: int = 16
    in_channels: int = 1


def _im2col(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H, W, k*k*C) patches (SAME padding), each
    patch ordered (channel, row, column) as ``conv_general_dilated_patches``
    orders it."""
    B, H, W, _ = x.shape
    p = F.unfold(x.permute(0, 3, 1, 2), k, padding=k // 2)  # (B, C*k*k, HW)
    return p.transpose(1, 2).reshape(B, H, W, -1)


def conv(params, x, name, probe=None, ftc=None):
    """3x3 conv as an im2col GEMM (the DLA mapping)."""
    y = linear(_im2col(x), params["w"], params.get("b"), ftc=ftc, name=name)
    return tag(probe, f"{name}/out", y)


def _conv_init(g, cin, cout, dev):
    return {"w": dense_init(g, 9 * cin, cout, torch.float32, dev),
            "b": torch.zeros((cout,), dtype=torch.float32, device=dev)}


def init_cnn(generator: torch.Generator, cfg: CNNConfig, device=None
             ) -> dict:
    """Random parameters with the reference's distributions (truncated
    normal, std 1/sqrt(fan_in); zero biases), drawn from ``generator``,
    which must live on ``device`` (default: the GPU)."""
    dev = _device.resolve(device)
    g = generator
    p: dict = {}
    cin = cfg.in_channels
    if cfg.arch == "vgg":
        # VGG-style: [conv, conv, pool] per stage
        for si, c in enumerate(cfg.channels):
            p[f"s{si}_c0"] = _conv_init(g, cin, c, dev)
            p[f"s{si}_c1"] = _conv_init(g, c, c, dev)
            cin = c
    elif cfg.arch == "resnet":
        p["stem"] = _conv_init(g, cin, cfg.channels[0], dev)
        cin = cfg.channels[0]
        for si, c in enumerate(cfg.channels):
            p[f"s{si}_c0"] = _conv_init(g, cin, c, dev)
            p[f"s{si}_c1"] = _conv_init(g, c, c, dev)
            if cin != c:
                p[f"s{si}_proj"] = {"w": dense_init(g, cin, c, torch.float32,
                                                    dev)}
            cin = c
    else:
        raise ValueError(cfg.arch)
    hw = cfg.hw // (2 ** len(cfg.channels))
    p["head"] = {"w": dense_init(g, hw * hw * cin, cfg.n_classes,
                                 torch.float32, dev),
                 "b": torch.zeros((cfg.n_classes,), dtype=torch.float32,
                                  device=dev)}
    return p


def _pool(x):
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax((2, 4))


def apply_cnn(params, cfg: CNNConfig, images, probe=None, ftc=None):
    x = images
    if cfg.arch == "vgg":
        for si in range(len(cfg.channels)):
            x = torch.relu(conv(params[f"s{si}_c0"], x, f"s{si}_c0",
                                probe, ftc))
            x = torch.relu(conv(params[f"s{si}_c1"], x, f"s{si}_c1",
                                probe, ftc))
            x = _pool(x)
    else:
        x = torch.relu(conv(params["stem"], x, "stem", probe, ftc))
        for si in range(len(cfg.channels)):
            h = torch.relu(conv(params[f"s{si}_c0"], x, f"s{si}_c0",
                                probe, ftc))
            h = conv(params[f"s{si}_c1"], h, f"s{si}_c1", probe, ftc)
            sc = x
            if f"s{si}_proj" in params:
                sc = linear(x, params[f"s{si}_proj"]["w"], ftc=ftc,
                            name=f"s{si}_proj")
            x = torch.relu(h + sc)
            x = _pool(x)
    x = x.reshape(x.shape[0], -1)
    return linear(x, params["head"]["w"], params["head"]["b"], ftc=ftc,
                  name="head")


def xent_loss(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[:, None], dim=-1)[:, 0]
    return (lse - ll).mean()


def accuracy(logits, labels) -> torch.Tensor:
    """float32 share of rows whose argmax (the first, on ties) is the label,
    formed as ``jnp.mean`` forms it: the count times the float32 reciprocal
    of the row count (a plain division differs in the last place for 31 of
    the 97 counts of 96 rows)."""
    hits = (torch.argmax(logits, -1) == labels).to(torch.float32).sum()
    inv = np.float32(1) / np.float32(labels.numel())
    return hits * torch.full((), float(inv), dtype=torch.float32,
                             device=hits.device)


def _leaves(params):
    return [t for layer in params.values() for t in layer.values()]


def _rebuild(params, leaves):
    it = iter(leaves)
    return {name: {k: next(it) for k in layer} for name, layer in
            params.items()}


def sgd_step(params, mom, imgs, labels, cfg: CNNConfig, lr: float):
    """One step of SGD with momentum 0.9 on the clean float forward:
    ``mom = 0.9 * mom + grad``, ``params = params - lr * mom``.  Returns
    (params, mom)."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    p = _rebuild(params, leaves)
    loss = xent_loss(apply_cnn(p, cfg, imgs), labels)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        ms = [0.9 * m + g for m, g in zip(_leaves(mom), grads)]
        ps = [t.detach() - lr * m for t, m in zip(leaves, ms)]
    return _rebuild(params, ps), _rebuild(params, ms)


def train_cnn(key, cfg: CNNConfig, steps: int = 300, batch: int = 64,
              lr: float = 3e-3, data_seed: int = 99, noise: float = 1.6):
    """Quick SGD+momentum training on the procedural vision set, on the
    key's device; returns (params, final *clean* accuracy on 512 images).

    The initial weights are ``init_cnn``'s from a generator seeded 0 on
    that device (the port's own draws); step ``i`` trains on
    ``vision_batch(fold_in(key, i), batch)`` (``sgd_step``), as the
    reference's.  ``noise=1.6`` keeps the task off the 1.0 accuracy
    ceiling, where faults would not flip an argmax (see
    ``repro.models.cnn.train_cnn``); keep it equal to ``CnnOracle.noise``.
    Fault-aware training (the reference's ``fat`` arguments) is not ported
    yet.
    """
    from repro_torch.data.pipeline import vision_batch
    key = prng.as_key(key)
    dev = key.device
    params = init_cnn(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    mom = _rebuild(params, [torch.zeros_like(t) for t in _leaves(params)])
    for i in range(steps):
        imgs, labels = vision_batch(prng.fold_in(key, i), batch,
                                    cfg.n_classes, cfg.hw, noise=noise,
                                    seed=data_seed)
        params, mom = sgd_step(params, mom, imgs, labels, cfg, lr)
    imgs, labels = vision_batch(prng.PRNGKey(7, dev), 512, cfg.n_classes,
                                cfg.hw, noise=noise, seed=data_seed)
    with torch.no_grad():
        acc = float(accuracy(apply_cnn(params, cfg, imgs), labels))
    return params, acc
