"""Architecture registry: ``get_config("<arch-id>")``.

Counterpart of ``repro.configs``.  The port serves one architecture so far;
the others join with their model families.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, RunConfig, reduce_config)

_MODULES = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port knows {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    m = _module(arch)
    return m.REDUCED if reduced else m.CONFIG


def get_run_config(arch: str) -> RunConfig:
    return _module(arch).RUN
