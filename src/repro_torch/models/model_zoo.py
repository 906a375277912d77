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

The speculative verify::

    logits, rewind_state = model.verify_step(params, tokens, cache)
    cache = model.verify_rewind(rewind_state, keep)

teacher-forces ``tokens`` (B, T) over the live decode cache and returns
(B, T, V) logits; ``verify_rewind`` leaves the cache each row would hold
after consuming only its first keep[b] tokens.
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


class _ShapeGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``: the initialisers put
    their tensors on ``gen.device``, so they build shapes and draw
    nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def _mod(self):
        return _FAMILY_MODULES[self.cfg.family]

    def init(self, seed: int = 0, device=None) -> dict:
        """Param tree drawn from a generator seeded with ``seed`` on
        ``device`` (default ``cuda``); on ``"meta"`` the tree's shapes
        alone (the port's ``jax.eval_shape(model.init)``)."""
        dev = resolve_device(device)
        gen = _ShapeGenerator() if dev.type == "meta" \
            else torch.Generator(device=dev)
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

    def verify_step(self, params, tokens, cache, overlay=None,
                    variant_idx=None):
        """-> (logits (B, T, V), rewind state).  The attention families run
        one teacher-forced pass (their module's ``verify_step``: the
        cache's K/V written in place, ``pos`` advanced by T); the recurrent
        ones (``ssm``, ``hybrid``) step ``decode_step`` T times, since
        their sequence paths do not round like the stepwise recurrence,
        and keep the state after every step for the rewind."""
        if hasattr(self._mod, "verify_step"):
            logits, new_cache = self._mod.verify_step(
                params, tokens, cache, self.cfg, overlay=overlay,
                variant_idx=variant_idx)
            return logits, ("pos", new_cache, tokens.shape[1])
        logits, snaps, state = [], [], cache
        for j in range(tokens.shape[1]):
            lg, state = self._mod.decode_step(
                params, tokens[:, j], state, self.cfg, overlay=overlay,
                variant_idx=variant_idx)
            logits.append(lg)
            snaps.append(state)
        return torch.stack(logits, dim=1), ("snap", snaps, None)

    def verify_rewind(self, rewind_state, keep: torch.Tensor):
        """keep (B,) int in [1, T]: the tokens each row consumed.  A native
        rewind retreats ``pos``; a snapshot rewind takes, for each row, the
        state after its keep[b]-th step along each leaf's batch axis
        (``cache_batch_axes``)."""
        mode, payload, span = rewind_state
        if mode == "pos":
            return self._mod.rewind_cache(payload, keep, span)
        return _select_snapshot(payload, keep.to(torch.int64) - 1,
                                self.cache_batch_axes())

    def cache_batch_axes(self) -> dict:
        return self._mod.cache_batch_axes(self.cfg)

    def init_cache(self, batch: int, max_len: int, device=None,
                   dtype=torch.bfloat16):
        return self._mod.init_cache(self.cfg, batch, max_len,
                                    resolve_device(device), dtype)


def _select_snapshot(snaps: list, sel: torch.Tensor, axes):
    """Per row b, snapshot sel[b] of ``snaps`` (states, one per step),
    leaf by leaf along the batch axis ``axes`` gives.  A leaf that every
    snapshot holds as one tensor (zamba's KV caches, written in place by
    each step) is returned as it is: it holds every step's writes, and
    those past a row's kept position carry slot positions past its ``pos``,
    so every later read masks them and the next write at a position
    replaces its entry, as after a native rewind."""
    if isinstance(axes, dict):
        return {k: _select_snapshot([s[k] for s in snaps], sel, a)
                for k, a in axes.items()}
    first = snaps[0]
    if all(s is first for s in snaps[1:]):
        return first
    shape = [1] * first.dim()
    shape[axes] = first.shape[axes]
    sel = sel.reshape(shape)
    out = first
    for j in range(1, len(snaps)):
        out = torch.where(sel >= j, snaps[j], out)
    return out


def build_model(cfg: ModelConfig) -> Model:
    """The model of ``cfg``'s family (an unknown family raises)."""
    if cfg.family not in _FAMILY_MODULES:
        raise ValueError(f"unknown family {cfg.family!r}; known: "
                         f"{tuple(_FAMILY_MODULES)}")
    return Model(cfg=cfg)
