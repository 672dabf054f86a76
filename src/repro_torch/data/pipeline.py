"""Deterministic synthetic data: the LM stream and the vision set of the
paper's CNN benchmarks.

Counterpart of ``repro.data.pipeline``, drawn through the port's
``jax.random`` copy (``repro_torch.core.prng``):

  * LM stream: each sequence is a repeated random p-gram (p in [4, 16])
    with a small substitution noise rate, a pure function of (seed, step,
    index), so a restart at step N reproduces the stream (a checkpoint
    stores only ``{"step": N}``).  Tokens are bitwise the reference's
    (``randint`` and ``bernoulli`` are), as int64, torch's index type (the
    reference's are int32).
  * The vision and encoder-decoder families' inputs, ``patch_embeds``
    and ``frames``: ``prng.normal`` draws in bfloat16 by default, bitwise
    the reference's.
  * Vision set: class-conditional procedural images, a fixed random
    template per class plus Gaussian noise: the labels bitwise, the images
    within ``prng.normal``'s ulp bound.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as _device
from repro_torch.core import prng


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    noise: float = 0.05
    min_period: int = 4
    max_period: int = 16


def lm_batch(cfg: DataConfig, vocab: int, batch: int, seq: int, step: int,
             process_index: int = 0, process_count: int = 1, device=None):
    """(batch / process_count, seq) tokens of global step ``step`` (this
    process's slice), drawn on ``device`` (default the GPU)."""
    if batch % process_count:
        raise ValueError(f"batch {batch} does not split over "
                         f"{process_count} processes")
    local = batch // process_count
    key = prng.fold_in(prng.PRNGKey(cfg.seed, _device.resolve(device)), step)
    key = prng.fold_in(key, process_index)
    ks = prng.split(key, 4)
    period = prng.randint(ks[0], (local, 1), cfg.min_period,
                          cfg.max_period + 1)
    base = prng.randint(ks[1], (local, cfg.max_period), 1, vocab)
    idx = torch.arange(seq, device=key.device)[None, :] % period
    toks = torch.take_along_dim(base, idx, dim=1)
    noise_mask = prng.bernoulli(ks[2], cfg.noise, (local, seq))
    noise_tok = prng.randint(ks[3], (local, seq), 1, vocab)
    return torch.where(noise_mask, noise_tok, toks)


def make_batch(model_cfg, shape, step: int, data_cfg: DataConfig | None = None,
               process_index: int = 0, process_count: int = 1,
               compute_dtype=torch.bfloat16, device=None):
    """The batch dict of a (ModelConfig, ShapeConfig) cell, drawn on
    ``device`` (default the GPU): ``tokens``, and for the vision family
    ``patch_embeds`` (B / process_count, n_frontend_tokens, d_model) in
    front of ``seq_len - n_frontend_tokens`` tokens, for an encoder-decoder
    ``frames`` (B / process_count, seq_len, d_model).  Both are
    ``normal`` draws in ``compute_dtype`` (bfloat16 by default, as the
    reference's, whatever the model computes in) from
    ``fold_in(PRNGKey(seed + 7), step)`` folded with 1 and 2; as the
    reference's, they are not folded with ``process_index``."""
    d = data_cfg or DataConfig()
    dev = _device.resolve(device)
    B, S = shape.global_batch, shape.seq_len
    n_front = (model_cfg.n_frontend_tokens
               if model_cfg.frontend == "vision" else 0)
    batch = {"tokens": lm_batch(d, model_cfg.vocab, B, S - n_front, step,
                                process_index, process_count, dev)}
    key = prng.fold_in(prng.PRNGKey(d.seed + 7, dev), step)
    if model_cfg.frontend == "vision":
        batch["patch_embeds"] = prng.normal(
            prng.fold_in(key, 1),
            (B // process_count, n_front, model_cfg.d_model), compute_dtype)
    if model_cfg.enc_dec:
        batch["frames"] = prng.normal(
            prng.fold_in(key, 2), (B // process_count, S, model_cfg.d_model),
            compute_dtype)
    return batch


def vision_batch(key: torch.Tensor, n: int, n_classes: int = 8,
                 hw: int = 16, noise: float = 0.4, seed: int = 99):
    """Procedural image classification batch on the key's device:
    (images (n, hw, hw, 1) float32, labels (n,) int64)."""
    templates = prng.normal(prng.PRNGKey(seed, key.device),
                            (n_classes, hw, hw, 1))
    k = prng.split(key, 2)
    labels = prng.randint(k[0], (n,), 0, n_classes)
    imgs = templates[labels] + noise * prng.normal(k[1], (n, hw, hw, 1))
    return imgs, labels


class LMIterator:
    """Stateful, checkpointable iterator over ``make_batch`` (its default
    ``compute_dtype``, as the reference's): its state is the next step."""

    def __init__(self, model_cfg, shape, data_cfg: DataConfig | None = None,
                 start_step: int = 0, device=None):
        self.model_cfg, self.shape = model_cfg, shape
        self.data_cfg = data_cfg or DataConfig()
        self.step = start_step
        self.device = _device.resolve(device)

    def __iter__(self):
        return self

    def __next__(self):
        b = make_batch(self.model_cfg, self.shape, self.step, self.data_cfg,
                       device=self.device)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state.get("step", 0))
