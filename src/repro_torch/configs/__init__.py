"""Architecture registry: ``get_config("<arch-id>")``.

Counterpart of ``repro.configs``: the port registers every architecture
the reference does.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoECfg, RunConfig, SSMCfg, ShapeConfig, SHAPES, reduce_config)

_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "glm4-9b": "glm4_9b",
    "qwen2-7b": "qwen2_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "dbrx-132b": "dbrx_132b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "paligemma-3b": "paligemma_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port knows "
                       f"{list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    m = _module(arch)
    return m.REDUCED if reduced else m.CONFIG


def get_run_config(arch: str) -> RunConfig:
    return _module(arch).RUN


def cells(include_skips: bool = False):
    """All (arch, shape) dry-run cells (``launch/dryrun.py``); a shape an
    architecture does not support (``ModelConfig.supports``: long_500k
    needs sub-quadratic attention) is left out unless ``include_skips``."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if cfg.supports(shape) or include_skips:
                out.append((arch, shape.name))
    return out
