"""Architecture registry: ``get_config("<arch-id>")``.

Counterpart of ``repro.configs``.  The port registers every architecture
whose layers it has; paligemma-3b and seamless-m4t-medium need the vision
frontend and the encoder-decoder stack, which are not ported yet
(ROADMAP.md, queue A item 4), and ``get_config`` says so.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoECfg, RunConfig, SSMCfg, reduce_config)

_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "glm4-9b": "glm4_9b",
    "qwen2-7b": "qwen2_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "dbrx-132b": "dbrx_132b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

# the reference's architectures whose families the port has yet to serve
_NOT_PORTED = {
    "paligemma-3b": "its vision frontend (queue A item 4.5)",
    "seamless-m4t-medium": "its encoder-decoder stack and cross-attention "
                           "(queue A item 4.4)",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet: it needs {_NOT_PORTED[arch]} "
            "(ROADMAP.md)")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port knows "
                       f"{list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    m = _module(arch)
    return m.REDUCED if reduced else m.CONFIG


def get_run_config(arch: str) -> RunConfig:
    return _module(arch).RUN
