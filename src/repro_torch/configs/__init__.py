"""Architecture registry (port of ``repro.configs``): ``get_config(arch)``
returns the published configuration of every architecture the JAX
package serves."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

_ARCH_MODULES = {
    "qwen3-8b": "qwen3_8b",
    "deepseek-7b": "deepseek_7b",
    "starcoder2-3b": "starcoder2_3b",
    "gemma3-12b": "gemma3_12b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "internvl2-76b": "internvl2_76b",
    "whisper-base": "whisper_base",
    "xlstm-350m": "xlstm_350m",
    "zamba2-7b": "zamba2_7b",
}

ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG
