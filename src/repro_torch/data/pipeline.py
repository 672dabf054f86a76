"""Deterministic synthetic data: the vision set of the paper's CNN
benchmarks.

Counterpart of ``repro.data.pipeline::vision_batch``: class-conditional
procedural images, a fixed random template per class plus Gaussian noise,
drawn through the port's ``jax.random`` copy (``repro_torch.core.prng``):
the labels bitwise, the images within ``prng.normal``'s ulp bound.  (The LM
stream, ``lm_batch`` and ``LMIterator``, comes with LM training.)
"""
from __future__ import annotations

import torch

from repro_torch.core import prng


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
