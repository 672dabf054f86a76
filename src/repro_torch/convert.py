"""Weights across: the JAX ``Model.init`` pytree into the port's parameters.

``params_from_jax(tree, cfg)`` takes the reference's parameter tree exported
leaf by leaf with ``np.asarray`` and returns the port's dict of tensors.  It
reads both of the reference's layouts:

  * ``layers/l{i}`` (unrolled and reduced configs), one dict per layer;
  * ``seg{si}`` (full configs, run under ``lax.scan``): each leaf stacked
    along axis 0 over a segment's super-blocks, one ``s{j}`` per pattern
    position.

Every leaf crosses as it is, whatever the layer's family: the MoE's expert
stacks ``(E, d_in, d_out)`` and float32 router, the SSM's ``A_log``, ``D``,
``dt_bias``, ``conv_w`` and ``norm``, the RG-LRU's block-diagonal
``(heads, bw, bw)`` gates and ``lam``; a config's tail is its own segment
(recurrentgemma's ``seg1`` of R layers), and an encoder-decoder's decoder
layers carry their ``lnx`` and ``xattn``.  Its encoder comes across from
``enc_layers/l{i}`` (unrolled) or ``enc_blocks/s0`` (scanned, stacked
along axis 0), with ``enc_norm``.  The port keeps one dict per layer
either way; which site names key the
fault draws follows ``cfg.unroll`` (``repro_torch.models.transformer``).

``train_state_from_jax(state, cfg)`` takes the reference's train state
(``{"params", "m", "v", "step"}``, as ``repro.train.init_state`` and its
train step make it) and returns the port's: the moments in the parameters'
layout and in their own dtype (bfloat16 where the reference's
``AdamWConfig(dtype=run.adam_dtype)`` made them so, as qwen3-moe's
``RUN``), every family's leaves as ``params_from_jax`` reads them, the
step a 0-d int32 tensor.

``cnn_params_from_jax(tree)`` takes the reference's CNN tree
(``repro.models.cnn.init_cnn`` / ``train_cnn``: ``{"s0_c0": {"w", "b"},
..., "head": {"w", "b"}}``) as it is, leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes, which torch cannot read
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(stack, r, dev):
    """Block ``r`` of a scanned, axis-0-stacked subtree."""
    return _map(stack, lambda a: _tensor(np.asarray(a)[r], dev))


def params_from_jax(tree, cfg, device=None) -> dict:
    dev = _device.resolve(device)
    out = {k: _tensor(tree[k], dev) for k in ("embed", "final_norm",
                                              "unembed", "enc_norm")
           if k in tree}
    if "enc_layers" in tree:
        out["enc_layers"] = _map(tree["enc_layers"],
                                 lambda a: _tensor(a, dev))
    elif "enc_blocks" in tree:
        out["enc_layers"] = {
            f"l{i}": _unstack(tree["enc_blocks"]["s0"], i, dev)
            for i in range(cfg.n_enc_layers)}
    if "layers" in tree:
        out["layers"] = _map(tree["layers"], lambda a: _tensor(a, dev))
        return out
    layers, i = {}, 0
    for si, (pattern, n_rep) in enumerate(cfg.segments):
        seg = tree[f"seg{si}"]
        for r in range(n_rep):
            for j in range(len(pattern)):
                layers[f"l{i}"] = _unstack(seg[f"s{j}"], r, dev)
                i += 1
    out["layers"] = layers
    return out


def train_state_from_jax(state, cfg, device=None) -> dict:
    dev = _device.resolve(device)
    out = {k: params_from_jax(state[k], cfg, dev) for k in ("params", "m",
                                                            "v")}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=dev)
    return out


def cnn_params_from_jax(tree, device=None) -> dict:
    """The reference's CNN parameter tree as the port's, same names and
    layouts (im2col weights (9 * C_in, C_out), biases (C_out,))."""
    dev = _device.resolve(device)
    return _map(tree, lambda a: _tensor(a, dev))
