"""Decoder-only transformer LM (port of ``repro.models.transformer``):
the dense family, local:global layers (gemma3: ring caches of
``sliding_window`` slots on local layers, per-layer RoPE theta), the
MoE family (expert blocks of ``models/moe.py`` behind ``moe_first_dense``
unrolled dense ``pre_layers``) and the VLM backbone (precomputed image
embeddings in front of the text, ``embed_inputs``).

Parameters keep the JAX tree: per-layer leaves are stacked along a leading
layer dim (``params["layers"]["attn"]["wq"]`` is (L, d_out, d_in); expert
stacks (L, E, d_out, d_in)), and an overlay tree shadows them with the
same leading dims.  Where the JAX module ``lax.scan``s over that dim, the
port loops over the layer index and takes views of the stacked tensors.

``verify_step`` (the speculative verify) runs T teacher-forced tokens a
row over the live decode cache, and ``rewind_cache`` drops the rejected
suffix by retreating ``pos``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models.delta_overlay import oget
from repro_torch.models.layers import (dtype_of, embed_init, embed_lookup,
                                       linear, maybe_remat, mlp_apply,
                                       mlp_init, psel, rmsnorm, rmsnorm_init,
                                       unembed_logits)
from repro_torch.models.param import dense_init, stack_layers
from repro_torch.tree import tree_map


def layer_pattern(cfg) -> list[dict]:
    """Per-super-block layer descriptors: one entry for uniform archs,
    [local x N, global] for local:global archs."""
    if cfg.local_global_pattern > 0:
        local = {"window": cfg.sliding_window, "theta": cfg.rope_theta_local}
        glob = {"window": 0, "theta": cfg.rope_theta}
        return [dict(local) for _ in range(cfg.local_global_pattern)] + [glob]
    return [{"window": cfg.sliding_window, "theta": cfg.rope_theta}]


FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg) -> None:
    """Refuse the families another module serves (``model_zoo``)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a transformer "
                         f"family; this module serves {FAMILIES}")


def n_pre_layers(cfg) -> int:
    """Unrolled dense layers in front of the stacked ones (MoE archs)."""
    return cfg.moe_first_dense if cfg.family == "moe" else 0


def _pre_entry(cfg, decode: bool = False) -> dict:
    """Pattern entry of the ``pre_layers``: the config's window and theta
    in the forward, a windowless full cache in decode (as the JAX
    module)."""
    return {"window": 0 if decode else cfg.sliding_window,
            "theta": cfg.rope_theta}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg, moe_layer: bool) -> dict:
    p = {
        "ln1": rmsnorm_init(cfg.d_model, gen.device),
        "attn": A.attn_init(gen, cfg),
        "ln2": rmsnorm_init(cfg.d_model, gen.device),
    }
    if moe_layer:
        p["moe"] = MOE.moe_init(gen, cfg)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff)
    return p


def init(gen: torch.Generator, cfg) -> dict:
    """Param tree on ``gen``'s device (float32 leaves, as the JAX init)."""
    check_family(cfg)
    is_moe = cfg.family == "moe"
    n_pre = n_pre_layers(cfg)
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model),
        "final_norm": rmsnorm_init(cfg.d_model, gen.device),
        "layers": stack_layers(lambda g: _block_init(g, cfg, is_moe), gen,
                               cfg.num_layers - n_pre),
    }
    if n_pre:
        params["pre_layers"] = stack_layers(
            lambda g: _block_init(g, cfg, False), gen, n_pre)
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                       ("vocab", "embed"),
                                       scale=cfg.d_model ** -0.5)
    return params


def _layer(tree, i: int):
    """Layer ``i`` of a stacked params or overlay subtree (views)."""
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _ffn_part(p, x, cfg, io=None, ov=None, vidx=None):
    """-> (x + FFN(x), MoE aux loss or 0).  An expert layer records no
    calibration pairs for its stacks (as the JAX module: MoE variants stay
    at calibration stage 0)."""
    h = rmsnorm(x, psel(p["ln2"], oget(ov, "ln2"), vidx), cfg.norm_eps)
    if "moe" in p:
        y, aux = MOE.moe_apply(p["moe"], h, cfg, ov=oget(ov, "moe"),
                               vidx=vidx)
        return x + y, aux
    y = mlp_apply(p["mlp"], h, ov=oget(ov, "mlp"), vidx=vidx)
    if io is not None:
        # as the JAX module: gate/up outputs from a second product with the
        # layer's own weights, outside mlp_apply; w_down's input rebuilt
        gate = linear(h, p["mlp"]["w_gate"], waxes=("ffn", "embed"))
        up = linear(h, p["mlp"]["w_up"], waxes=("ffn", "embed"))
        io["mlp.w_gate"] = (h, gate)
        io["mlp.w_up"] = (h, up)
        io["mlp.w_down"] = (F.silu(gate) * up, y)
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


def block_apply(p, x, cfg, positions, theta, window, io=None, ov=None,
                vidx=None):
    """One layer over a full sequence; returns (x, (k, v), MoE aux).
    ``io`` (a dict or None) collects each projection's (input, output)
    pair — the
    calibration cache.  As in the JAX module, the pairs of ``attn.wq`` and
    ``attn.wk`` hold q and k AFTER qk-norm and RoPE, not the bare
    projection outputs."""
    ov_a = oget(ov, "attn")
    h = rmsnorm(x, psel(p["ln1"], oget(ov, "ln1"), vidx), cfg.norm_eps)
    split = A.head_split(cfg, x.shape[1])
    q, k, v = A.qkv_project(p["attn"], h, cfg, positions, theta, ov=ov_a,
                            vidx=vidx, split=split)
    o = A.attn_out(A.attend(q, k, v, cfg, split, x.shape[1], window=window),
                   cfg, split, p["attn"]["wo"])
    wo_out = linear(o, p["attn"]["wo"], oget(ov_a, "wo"), vidx,
                    waxes=("embed", "q_heads"))
    if io is not None:
        b, s, _ = x.shape
        io["attn.wq"] = (h, q.reshape(b, s, -1))
        io["attn.wk"] = (h, k.reshape(b, s, -1))
        io["attn.wv"] = (h, v.reshape(b, s, -1))
        io["attn.wo"] = (o, wo_out)
    x, aux = _ffn_part(p, x + wo_out, cfg, io=io, ov=ov, vidx=vidx)
    return x, (k, v), aux


def embed_inputs(params, batch, cfg, ov=None, vidx=None) -> torch.Tensor:
    """Token embeddings; for the VLM family the batch's ``image_embeds``
    (B, n_img, d), cast to the compute dtype, go in front of them."""
    x = embed_lookup(params["embed"], batch["tokens"], cfg.compute_dtype,
                     bank=oget(ov, "embed"), vidx=vidx)
    if cfg.family == "vlm" and "image_embeds" in batch:
        img = batch["image_embeds"].to(dtype_of(cfg.compute_dtype))
        x = torch.cat([img, x], dim=1)
    return x


def _unembed(params, x, cfg, ov=None, vidx=None):
    key = "embed" if cfg.tie_embeddings else "unembed"
    return unembed_logits(x, params[key], bank=oget(ov, key), vidx=vidx)


# ---------------------------------------------------------------------------
# forward (teacher-forced) and prefill
# ---------------------------------------------------------------------------

def _stack_io(ios: list) -> dict:
    return {proj: tuple(torch.stack([io[proj][j] for io in ios])
                        for j in (0, 1))
            for proj in ios[0]}


def forward(params, batch, cfg, collect_kv: bool = False, overlay=None,
            variant_idx=None, collect_io: bool = False):
    """-> (logits (B,S,V), aux); for the VLM family S counts the image
    prefix too.  aux["moe_aux"] is the summed MoE
    load-balancing loss (0 for dense archs).  aux["kv"] = (k, v) stacked
    (L,B,S,Hkv,hd) over the stacked layers when collect_kv, aux["pre_kv"]
    the same over the ``pre_layers``.  aux["io"] = {projection: (X
    (L,B,S,d_in), Y (L,B,S,d_out))} over the stacked layers' projections
    when collect_io (the calibration cache; see ``block_apply``; an expert
    layer records its attention only), aux["pre_io"] the same over the
    ``pre_layers``.  ``overlay`` (optional) shadows params: matmuls with an
    entry run the fused delta GEMM against the base weight.
    ``variant_idx`` (optional (B,) int) marks the overlay as BANKED (bank
    axis on every leaf, extras included): every batch row serves its own
    variant, slot 0 meaning base."""
    check_family(cfg)
    vidx = variant_idx
    x = embed_inputs(params, batch, cfg, ov=overlay, vidx=vidx)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {}

    def run(stack, ov_stack, n_layers, entry_of, block=block_apply):
        nonlocal x, aux_total
        ks, vs, ios = [], [], []
        for i in range(n_layers):
            entry = entry_of(i)
            io = {} if collect_io else None
            x, (k, v), a = block(_layer(stack, i), x, cfg, positions,
                                 entry["theta"], entry["window"], io=io,
                                 ov=_layer(ov_stack, i), vidx=vidx)
            aux_total = aux_total + a
            if collect_kv:
                ks.append(k)
                vs.append(v)
            ios.append(io)
        kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
        return kv, (_stack_io(ios) if collect_io else None)

    n_pre = n_pre_layers(cfg)
    if n_pre:
        pre_kv, pre_io = run(params["pre_layers"],
                             oget(overlay, "pre_layers"), n_pre,
                             lambda i: _pre_entry(cfg))
        if collect_kv:
            aux["pre_kv"] = pre_kv
        if collect_io:
            aux["pre_io"] = pre_io
    pat = layer_pattern(cfg)
    # the stacked layers rematerialise under training (the JAX scan's
    # jax.checkpoint); the unrolled pre_layers do not, as in the JAX module
    kv, io = run(params["layers"], oget(overlay, "layers"),
                 cfg.num_layers - n_pre, lambda i: pat[i % len(pat)],
                 maybe_remat(block_apply, cfg, collect_io))
    x = rmsnorm(x, psel(params["final_norm"], oget(overlay, "final_norm"),
                        vidx), cfg.norm_eps)
    logits = _unembed(params, x, cfg, ov=overlay, vidx=vidx)
    aux["moe_aux"] = aux_total
    if collect_kv:
        aux["kv"] = kv
    if collect_io:
        aux["io"] = io
    return logits, aux


def _stacked_cache(cfg, n_stack: int, batch: int, size: int, device,
                   dtype) -> dict:
    one = A.make_kv_cache(batch, size, A.local_kv_heads(cfg), cfg.head_dim,
                          device, dtype)
    return {k: v.expand((n_stack,) + v.shape).clone() for k, v in one.items()}


def init_cache(cfg, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> dict:
    """{"pos": (B,) int32, "slots": [stacked (L/len(pattern), B, T, Hkv, hd)
    cache per pattern position], and for MoE archs "pre": the
    ``pre_layers``' stacked (n_pre, B, max_len, Hkv, hd) cache}.  A
    windowed pattern position holds a ring of min(window, max_len)
    slots."""
    pat = layer_pattern(cfg)
    n_pre = n_pre_layers(cfg)
    n_scan = cfg.num_layers - n_pre
    assert n_scan % len(pat) == 0, \
        f"num_layers {cfg.num_layers} incompatible with pattern {len(pat)}"
    sizes = [min(e["window"], max_len) if e["window"] > 0 else max_len
             for e in pat]
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
             "slots": [_stacked_cache(cfg, n_scan // len(pat), batch, sz,
                                      device, dtype) for sz in sizes]}
    if n_pre:
        cache["pre"] = _stacked_cache(cfg, n_pre, batch, max_len, device,
                                      dtype)
    return cache


def cache_batch_axes(cfg) -> dict:
    """Where the batch axis of each ``init_cache`` leaf sits, in the
    cache's own structure: ``pos`` 0; ``k``, ``v`` and ``slot_pos`` 1
    (behind the stacked layer dim), ring caches and the ``pre`` cache
    alike.  Every leaf is row-separable, so the continuous scheduler merges
    freshly prefilled lanes into the live cache by a row select along these
    axes."""
    kv = {"k": 1, "v": 1, "slot_pos": 1}
    axes = {"pos": 0, "slots": [dict(kv) for _ in layer_pattern(cfg)]}
    if n_pre_layers(cfg):
        axes["pre"] = dict(kv)
    return axes


def prefill(params, batch, cfg, max_len: int, cache_dtype=torch.bfloat16,
            overlay=None, variant_idx=None):
    """Teacher-forced pass over the prompt; returns (last_logits, cache).
    Windowed layers keep the prompt's last ``window`` positions in their
    ring (``attention.prefill_ring``); the others are written
    contiguously.  The position count is the embedded sequence's, so a
    VLM's image prefix counts: decoding continues at n_img + S."""
    logits, aux = forward(params, batch, cfg, collect_kv=True,
                          overlay=overlay, variant_idx=variant_idx)
    b, s = logits.shape[:2]
    cache = init_cache(cfg, b, max_len, logits.device, cache_dtype)
    pat = layer_pattern(cfg)
    k_all, v_all = aux["kv"]                  # (L, B, S, Hkv, hd)
    for i in range(k_all.shape[0]):
        j = i % len(pat)
        view = A.cache_layer_view(cache["slots"][j], i // len(pat))
        if pat[j]["window"] > 0:
            A.prefill_ring(view, k_all[i], v_all[i])
        else:
            A.cache_insert(view, k_all[i], v_all[i], 0)
    if "pre_kv" in aux:
        pk, pv = aux["pre_kv"]
        for i in range(pk.shape[0]):
            A.cache_insert(A.cache_layer_view(cache["pre"], i), pk[i], pv[i],
                           0)
    cache["pos"] = torch.full((b,), s, dtype=torch.int32,
                              device=logits.device)
    return logits[:, -1, :], cache


# ---------------------------------------------------------------------------
# decode: single-token step against the stacked cache
# ---------------------------------------------------------------------------

def _decode_block_stacked(p, x, cfg, caches, idx, pat_entry, pos, ov=None,
                          vidx=None):
    window = pat_entry["window"]
    ov_a = oget(ov, "attn")
    h = rmsnorm(x, psel(p["ln1"], oget(ov, "ln1"), vidx), cfg.norm_eps)
    q, k, v = A.qkv_project(p["attn"], h, cfg, pos.to(torch.int32)[:, None],
                            pat_entry["theta"], ov=ov_a, vidx=vidx)
    A.cache_insert_stacked(caches, idx, k, v, pos, ring=window > 0)
    view = A.cache_layer_view(caches, idx)
    o = A.decode_attention(q, A.local_kv(view["k"], cfg),
                           A.local_kv(view["v"], cfg), view["slot_pos"], pos,
                           window=window)
    o = A.attn_out(o, cfg, A.head_split(cfg, 1), p["attn"]["wo"])
    x = x + linear(o, p["attn"]["wo"], oget(ov_a, "wo"), vidx,
                   waxes=("embed", "q_heads"))
    return _ffn_part(p, x, cfg, ov=ov, vidx=vidx)[0]


def decode_step(params, token, cache, cfg, overlay=None, variant_idx=None):
    """token (B,) -> (logits (B,V), cache advanced by one, updated in
    place).  cache["pos"] is (B,) per-lane positions; ``variant_idx`` as in
    ``forward``."""
    check_family(cfg)
    vidx = variant_idx
    pos = cache["pos"]
    x = embed_lookup(params["embed"], token[:, None], cfg.compute_dtype,
                     bank=oget(overlay, "embed"), vidx=vidx)
    n_pre = n_pre_layers(cfg)
    ov_pre = oget(overlay, "pre_layers")
    for i in range(n_pre):
        x = _decode_block_stacked(
            _layer(params["pre_layers"], i), x, cfg, cache["pre"], i,
            _pre_entry(cfg, decode=True), pos, ov=_layer(ov_pre, i),
            vidx=vidx)
    pat = layer_pattern(cfg)
    ov_layers = oget(overlay, "layers")
    for i in range(cfg.num_layers - n_pre):
        j = i % len(pat)
        x = _decode_block_stacked(
            _layer(params["layers"], i), x, cfg, cache["slots"][j],
            i // len(pat), pat[j], pos, ov=_layer(ov_layers, i), vidx=vidx)
    x = rmsnorm(x, psel(params["final_norm"], oget(overlay, "final_norm"),
                        vidx), cfg.norm_eps)
    logits = _unembed(params, x, cfg, ov=overlay, vidx=vidx)
    cache["pos"] = pos + 1
    return logits[:, 0, :], cache


# ---------------------------------------------------------------------------
# speculative verify: T teacher-forced tokens over the live decode cache
# ---------------------------------------------------------------------------

def _verify_block_stacked(p, x, cfg, caches, idx, pat_entry, pos, ov=None,
                          vidx=None):
    """:func:`_decode_block_stacked` over T tokens a row: their K/V land at
    pos..pos+T-1 (``attention.cache_insert_stacked_multi``) and each query
    reads the cache through ``attention.verify_attention``.  Serves the
    stacked layers and, over ``cache["pre"]``, the MoE archs' dense
    ``pre_layers`` (the JAX module's ``_verify_block``)."""
    ov_a = oget(ov, "attn")
    t = x.shape[1]
    h = rmsnorm(x, psel(p["ln1"], oget(ov, "ln1"), vidx), cfg.norm_eps)
    positions = (pos.to(torch.int32)[:, None]
                 + torch.arange(t, dtype=torch.int32, device=x.device))
    # no length here: every q row of the verify reads the whole cache
    # (pos..pos+T-1 against every earlier slot), so the T rows are never
    # split over "model" as sequence-TP would split a prefill; heads
    # that do not divide take "whole", as decode does
    split = A.head_split(cfg)
    q, k, v = A.qkv_project(p["attn"], h, cfg, positions,
                            pat_entry["theta"], ov=ov_a, vidx=vidx,
                            split=split)
    A.cache_insert_stacked_multi(caches, idx, k, v, pos)
    view = A.cache_layer_view(caches, idx)
    o = A.verify_attention(q, A.local_kv(view["k"], cfg),
                           A.local_kv(view["v"], cfg), view["slot_pos"], pos,
                           window=0)
    o = A.attn_out(o, cfg, split, p["attn"]["wo"])
    x = x + linear(o, p["attn"]["wo"], oget(ov_a, "wo"), vidx,
                   waxes=("embed", "q_heads"))
    return _ffn_part(p, x, cfg, ov=ov, vidx=vidx)[0]


def verify_step(params, tokens, cache, cfg, overlay=None, variant_idx=None):
    """tokens (B, T) teacher-forced -> (logits (B, T, V), cache advanced by
    T, updated in place): the verify of speculative decoding.  Each query
    slice repeats ``decode_step``'s arithmetic, so logits[:, t] follows the
    T sequential decode steps that consume tokens[:, :t+1] (within fp32
    summation order); a rejected suffix is dropped by ``rewind_cache``.
    An MoE layer routes all B·T tokens at once, so its capacity is that
    count's, as in the JAX module.

    Windowed (ring) layers are refused: a ring write wraps modulo the
    window, so a rejected token's insert would clobber in-window history
    that a ``pos`` retreat cannot restore."""
    check_family(cfg)
    if any(e["window"] > 0 for e in layer_pattern(cfg)):
        raise ValueError(
            "verify_step requires windowless KV caches (ring buffers "
            "cannot rewind rejected speculative writes)")
    vidx = variant_idx
    pos = cache["pos"]
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype,
                     bank=oget(overlay, "embed"), vidx=vidx)
    ov_pre = oget(overlay, "pre_layers")
    for i in range(n_pre_layers(cfg)):
        x = _verify_block_stacked(
            _layer(params["pre_layers"], i), x, cfg, cache["pre"], i,
            _pre_entry(cfg, decode=True), pos, ov=_layer(ov_pre, i),
            vidx=vidx)
    pat = layer_pattern(cfg)
    ov_layers = oget(overlay, "layers")
    for i in range(cfg.num_layers - n_pre_layers(cfg)):
        j = i % len(pat)
        x = _verify_block_stacked(
            _layer(params["layers"], i), x, cfg, cache["slots"][j],
            i // len(pat), pat[j], pos, ov=_layer(ov_layers, i), vidx=vidx)
    x = rmsnorm(x, psel(params["final_norm"], oget(overlay, "final_norm"),
                        vidx), cfg.norm_eps)
    logits = _unembed(params, x, cfg, ov=overlay, vidx=vidx)
    cache["pos"] = pos + tokens.shape[1]
    return logits, cache


def rewind_cache(cache, keep, span: int) -> dict:
    """Drop the last span - keep[b] verify positions of each row: ``pos``
    retreats and nothing else moves.  Slots are indexed by absolute
    position, so the rejected entries (slot_pos > the new pos) are masked
    out of every later read and overwritten by the next write at their
    position before they could count.  Returns a new dict over the same
    tensors."""
    pos = cache["pos"]
    return dict(cache, pos=pos - (span - keep.to(pos.dtype)))
