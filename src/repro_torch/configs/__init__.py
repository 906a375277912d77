"""Architecture registry (port of ``repro.configs``): ``get_config(arch)``
returns the published configuration.  Only the architectures the port
serves are registered."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

_ARCH_MODULES = {
    "qwen3-8b": "qwen3_8b",
}

ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG
