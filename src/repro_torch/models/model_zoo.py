"""Model facade (port of ``repro.models.model_zoo``) for the dense family
(local:global archs included), the MoE family, the VLM backbone
(``transformer``), the encoder-decoder family (``whisper``) and the
recurrent families: ``ssm`` (``xlstm``) and ``hybrid`` (``zamba``).

    model = build_model(cfg)
    params, axes = split(model.init(seed, device="cuda"))
    logits, aux = model.forward(params, batch, overlay=None)
    last, cache = model.prefill(params, batch, max_len)
    logits, cache = model.decode_step(params, token, cache)

``batch`` holds "tokens" (B, S), plus "image_embeds" (B, n_img, d) for the
VLM family and "frames" (B, encoder_frames, d) for the audio family (the
stubbed frontends' outputs).  ``overlay`` (models/delta_overlay.py) is an
optional tree of packed deltas riding alongside ``params``: matmuls with
an entry run the fused delta GEMM.  ``variant_idx`` (B,) int marks the
overlay as BANKED (a bank axis on every leaf, slot 0 = base): each batch
row fuses its own variant's delta, so one call serves a mixed-variant
batch.  The recurrent families' cache is their decode state: xlstm's
ignores ``max_len`` and the dtype; zamba's holds one KV cache per
application point of its shared block besides.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer, whisper, xlstm, zamba

_FAMILY_MODULES = {"dense": transformer, "moe": transformer,
                   "vlm": transformer, "audio": whisper, "ssm": xlstm,
                   "hybrid": zamba}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def _mod(self):
        return _FAMILY_MODULES[self.cfg.family]

    def init(self, seed: int = 0, device=None) -> dict:
        """Param tree drawn from a generator seeded with ``seed`` on
        ``device`` (default ``cuda``)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return self._mod.init(gen, self.cfg)

    def forward(self, params, batch, overlay=None, variant_idx=None):
        return self._mod.forward(params, batch, self.cfg, overlay=overlay,
                                 variant_idx=variant_idx)

    def prefill(self, params, batch, max_len: int,
                cache_dtype=torch.bfloat16, overlay=None, variant_idx=None):
        return self._mod.prefill(params, batch, self.cfg, max_len,
                                 cache_dtype=cache_dtype, overlay=overlay,
                                 variant_idx=variant_idx)

    def decode_step(self, params, token, cache, overlay=None,
                    variant_idx=None):
        return self._mod.decode_step(params, token, cache, self.cfg,
                                     overlay=overlay,
                                     variant_idx=variant_idx)

    def cache_batch_axes(self) -> dict:
        return self._mod.cache_batch_axes(self.cfg)

    def init_cache(self, batch: int, max_len: int, device=None,
                   dtype=torch.bfloat16):
        return self._mod.init_cache(self.cfg, batch, max_len,
                                    resolve_device(device), dtype)


def build_model(cfg: ModelConfig) -> Model:
    """The model of ``cfg``'s family (an unknown family raises)."""
    if cfg.family not in _FAMILY_MODULES:
        raise ValueError(f"unknown family {cfg.family!r}; known: "
                         f"{tuple(_FAMILY_MODULES)}")
    return Model(cfg=cfg)
