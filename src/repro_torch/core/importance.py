"""Algorithm 1: gradient-based important-neuron selection.

Counterpart of ``repro.core.importance``.  The model's forward is
instrumented with *taps*: identity additions of zero tensors at every
neuron-activation site.  dL/d(tap) is exactly dL/d(activation), so
accumulating |grad| over a calibration set gives the paper's sensitivity
score without modifying model math.  Neurons = output channels.  The taps
require grad and ``torch.autograd.grad`` gives their gradients; the sums
are float64, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch


class Probe:
    """Pass through model forward; `tag(name, x)` marks a neuron site."""

    def __init__(self, taps: Mapping[str, torch.Tensor] | None = None):
        self.taps = taps
        self.shapes: dict[str, tuple] = {}

    def tag(self, name: str, x: torch.Tensor) -> torch.Tensor:
        self.shapes[name] = tuple(x.shape)
        if self.taps is None or name not in self.taps:
            return x
        return x + self.taps[name]


def null_probe() -> Probe:
    return Probe(None)


@dataclasses.dataclass
class ImportanceResult:
    # per-site array of per-channel scores (channel = last axis of the site)
    scores: dict[str, np.ndarray]

    def total_neurons(self) -> int:
        return int(sum(v.size for v in self.scores.values()))

    def select(self, s_th: float, policy: str = "uniform"
               ) -> dict[str, np.ndarray]:
        """Boolean masks of important neurons per site.

        policy:
          "uniform": top s_th fraction *within each site* (paper Table II's
            "uniform proportions": matches DPPU sizing per tile).
          "global": top s_th fraction across all sites pooled.
        """
        masks = {}
        if policy == "uniform":
            for k, v in self.scores.items():
                n = max(int(round(s_th * v.size)), 1) if s_th > 0 else 0
                thr = (-np.inf if n >= v.size else
                       np.partition(v, -n)[-n] if n else np.inf)
                masks[k] = v >= thr if n else np.zeros_like(v, bool)
        elif policy == "global":
            allv = np.concatenate([v.ravel() for v in self.scores.values()])
            n = max(int(round(s_th * allv.size)), 1) if s_th > 0 else 0
            thr = np.partition(allv, -n)[-n] if 0 < n <= allv.size else np.inf
            for k, v in self.scores.items():
                masks[k] = v >= thr
        else:
            raise ValueError(policy)
        return masks


def neuron_importance(apply_fn: Callable, params, batches, loss_fn: Callable,
                      channel_only: bool = True) -> ImportanceResult:
    """Accumulate |dL/da| per neuron over a calibration set (Algorithm 1).

    apply_fn(params, batch, probe) -> model output; the model must route
    every neuron site through probe.tag.  loss_fn(output, batch) -> scalar.
    The taps live on the device of the first batch's first tensor.
    """
    # discover tap sites/shapes with one dry forward
    probe = Probe(None)
    first = batches[0]
    with torch.no_grad():
        apply_fn(params, first, probe)
    site_shapes = dict(probe.shapes)
    dev = first[0].device

    acc = {k: np.zeros(s[-1] if channel_only else s, np.float64)
           for k, s in site_shapes.items()}
    for batch in batches:
        taps = {k: torch.zeros(s, dtype=torch.float32, device=dev,
                               requires_grad=True)
                for k, s in site_shapes.items()}
        loss = loss_fn(apply_fn(params, batch, Probe(taps)), batch)
        grads = torch.autograd.grad(loss, list(taps.values()))
        for k, v in zip(taps, grads):
            a = np.abs(v.detach().cpu().numpy().astype(np.float64))
            if channel_only:
                a = a.reshape(-1, a.shape[-1]).sum(0)
            acc[k] += a
    return ImportanceResult(scores=acc)
