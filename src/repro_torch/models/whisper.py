"""Whisper-style encoder-decoder (port of ``repro.models.whisper``,
whisper-base); the conv audio frontend is a stub.

``batch["frames"]`` (B, encoder_frames, d_model) holds precomputed frame
embeddings standing in for the two conv1d layers.  Encoder: bidirectional
self-attention blocks.  Decoder: causal self-attention, then
cross-attention to the encoder output.  Positions: sinusoidal.  GELU
(tanh, ``jax.nn.gelu``'s default) non-gated MLPs.  The embedding is tied.

Parameters keep the JAX tree: ``embed``, ``enc_layers`` and ``dec_layers``
(per-layer leaves stacked along a leading layer dim), ``enc_norm``,
``dec_norm``.  Where the JAX module ``lax.scan``s over the layer dim, the
port loops over it and takes views.  Every projection runs through
``layers.linear``, so an overlay entry puts it through the delta kernels.

The non-causal attentions (the encoder's, the decoder's cross-attention)
take KV chunks of the largest divisor of the frame count up to 512
(``attention.even_chunk``: 500 for 1500 frames) where the JAX module
halves 512 down to a divisor (4 for 1500 frames); only the summation
order differs.

On a mesh every projection names its weight's logical axes (``waxes``,
the JAX module's), so the delta GEMMs run per rank; the attentions take
``attention.head_split``'s layout (head-TP when the heads divide the model
axis, as the JAX ``_qkv``; sequence-TP or whole heads otherwise), the
self and cross K/V caches hold the rank's heads, the tied embedding and
logits are vocab-sharded as the transformer's, and the encoder's frames
stay whole on every rank.

``verify_step`` serves the speculative verify; its rewind is
``transformer.rewind_cache`` (the self cache masks slots past ``pos``).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models.delta_overlay import oget
from repro_torch.models.layers import (dtype_of, embed_init, embed_lookup,
                                       gelu, linear, maybe_remat,
                                       mlp2_apply, mlp2_init, psel, rmsnorm,
                                       rmsnorm_init, sinusoid_table,
                                       sinusoidal_positions, unembed_logits)
from repro_torch.models.param import stack_layers
from repro_torch.models.transformer import _layer, _stack_io
# the self cache rewinds as the transformer's (``Model.verify_rewind``)
from repro_torch.models.transformer import rewind_cache  # noqa: F401


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def enc_block_init(gen: torch.Generator, cfg) -> dict:
    return {"ln1": rmsnorm_init(cfg.d_model, gen.device),
            "attn": A.attn_init(gen, cfg),
            "ln2": rmsnorm_init(cfg.d_model, gen.device),
            "mlp": mlp2_init(gen, cfg.d_model, cfg.d_ff)}


def dec_block_init(gen: torch.Generator, cfg) -> dict:
    return {"ln1": rmsnorm_init(cfg.d_model, gen.device),
            "self_attn": A.attn_init(gen, cfg),
            "ln_x": rmsnorm_init(cfg.d_model, gen.device),
            "cross_attn": A.attn_init(gen, cfg),
            "ln2": rmsnorm_init(cfg.d_model, gen.device),
            "mlp": mlp2_init(gen, cfg.d_model, cfg.d_ff)}


def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return t.reshape(*t.shape[:2], n, hd)


def _qkv(p, xq, xkv, cfg, split, ov=None, vidx=None):
    """q (B,S,Hq,hd) from ``xq``, k/v (B,T,Hkv,hd) from ``xkv``, each
    projection cast to ``xq``'s dtype, in ``split``'s layout on a mesh
    (``attention.head_split`` of the q length: head-TP when the heads
    divide the model axis, as the JAX ``_qkv``; else sequence-TP over the
    q rows or whole heads, with K/V whole)."""
    q = linear(xq, p["wq"], oget(ov, "wq"), vidx,
               waxes=("q_heads", "embed")).to(xq.dtype)
    k = linear(xkv, p["wk"], oget(ov, "wk"), vidx,
               waxes=("kv_heads", "embed")).to(xq.dtype)
    v = linear(xkv, p["wv"], oget(ov, "wv"), vidx,
               waxes=("kv_heads", "embed")).to(xq.dtype)
    q, k, v = A.layout_qkv(p, q, k, v, cfg, split)
    return (_heads(q, -1, cfg.head_dim), _heads(k, -1, cfg.head_dim),
            _heads(v, -1, cfg.head_dim))


def _attention(p, xq, xkv, cfg, causal, ov=None, vidx=None):
    """-> (the ``wo`` product's input (B,S,K-tile), q, k, v): attention of
    ``xq`` over ``xkv``, causal or over every key (:func:`_full_attention`:
    the encoder's and the cross-attention)."""
    s = xq.shape[1]
    split = A.head_split(cfg, s)
    q, k, v = _qkv(p, xq, xkv, cfg, split, ov=ov, vidx=vidx)
    if causal:
        o = A.attend(q, k, v, cfg, split, s)
    else:
        k, v = A.seq_kv(k, v, split)
        o = _full_attention(q, A.local_kv(k, cfg), A.local_kv(v, cfg))
    return A.attn_out(o, cfg, split, p["wo"]), q, k, v


def _full_attention(q, k, v):
    """Non-causal attention over every key (encoder, cross-attention)."""
    return A.flash_attention(q, k, v, causal=False,
                             chunk=A.even_chunk(k.shape[1]))


def _mlp_part(lp, h, cfg, io=None, ov=None, vidx=None):
    """h + MLP(ln2(h)); ``io`` records w_in's pair from a second product
    and w_out's, as the JAX module does."""
    ov_m = oget(ov, "mlp")
    hm = rmsnorm(h, psel(lp["ln2"], oget(ov, "ln2"), vidx), cfg.norm_eps)
    mid = gelu(linear(hm, lp["mlp"]["w_in"], oget(ov_m, "w_in"), vidx,
                      waxes=("ffn", "embed")))
    out = linear(mid, lp["mlp"]["w_out"], oget(ov_m, "w_out"), vidx,
                 waxes=("embed", "ffn"))
    if io is not None:
        io["mlp.w_in"] = (hm, linear(hm, lp["mlp"]["w_in"],
                                     oget(ov_m, "w_in"), vidx,
                                     waxes=("ffn", "embed")))
        io["mlp.w_out"] = (mid, out)
    return h + out


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg) -> dict:
    """Param tree on ``gen``'s device (float32 leaves, as the JAX init)."""
    return {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model),
        "enc_layers": stack_layers(lambda g: enc_block_init(g, cfg), gen,
                                   cfg.encoder_layers),
        "enc_norm": rmsnorm_init(cfg.d_model, gen.device),
        "dec_layers": stack_layers(lambda g: dec_block_init(g, cfg), gen,
                                   cfg.num_layers),
        "dec_norm": rmsnorm_init(cfg.d_model, gen.device),
    }


def _enc_block(lp, x, cfg, io=None, ovl=None, vidx=None):
    """One encoder layer: bidirectional self-attention, then the MLP."""
    ov_a = oget(ovl, "attn")
    hn = rmsnorm(x, psel(lp["ln1"], oget(ovl, "ln1"), vidx), cfg.norm_eps)
    o, q, k, v = _attention(lp["attn"], hn, hn, cfg, False, ov=ov_a,
                            vidx=vidx)
    b, f, _ = hn.shape
    wo_out = linear(o, lp["attn"]["wo"], oget(ov_a, "wo"), vidx,
                    waxes=("embed", "q_heads"))
    if io is not None:
        io["attn.wq"] = (hn, q.reshape(b, f, -1))
        io["attn.wk"] = (hn, k.reshape(b, f, -1))
        io["attn.wv"] = (hn, v.reshape(b, f, -1))
        io["attn.wo"] = (o, wo_out)
    return _mlp_part(lp, x + wo_out, cfg, io=io, ov=ovl, vidx=vidx)


def encode(params, frames: torch.Tensor, cfg, collect_io: bool = False,
           overlay=None, vidx=None):
    """frames (B, F, d) -> (encoder output (B, F, d), stacked IO pairs or
    None)."""
    x = frames.to(dtype_of(cfg.compute_dtype))
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(x.dtype)
    ov_layers = oget(overlay, "enc_layers")
    block = maybe_remat(_enc_block, cfg, collect_io)
    ios = []
    for i in range(cfg.encoder_layers):
        io = {} if collect_io else None
        x = block(_layer(params["enc_layers"], i), x, cfg, io=io,
                  ovl=_layer(ov_layers, i), vidx=vidx)
        ios.append(io)
    out = rmsnorm(x, psel(params["enc_norm"], oget(overlay, "enc_norm"),
                          vidx), cfg.norm_eps)
    return out, (_stack_io(ios) if collect_io else None)


def _dec_block(lp, x, enc_out, cfg, io=None, ovl=None, vidx=None):
    """One decoder layer: causal self-attention, cross-attention to the
    encoder output, the MLP.  Returns (x, self-attention k, v)."""
    b, s, _ = x.shape
    ov_s = oget(ovl, "self_attn")
    hs = rmsnorm(x, psel(lp["ln1"], oget(ovl, "ln1"), vidx), cfg.norm_eps)
    o, q, k, v = _attention(lp["self_attn"], hs, hs, cfg, True, ov=ov_s,
                            vidx=vidx)
    wo_out = linear(o, lp["self_attn"]["wo"], oget(ov_s, "wo"), vidx,
                    waxes=("embed", "q_heads"))
    if io is not None:
        io["self_attn.wq"] = (hs, q.reshape(b, s, -1))
        io["self_attn.wk"] = (hs, k.reshape(b, s, -1))
        io["self_attn.wv"] = (hs, v.reshape(b, s, -1))
        io["self_attn.wo"] = (o, wo_out)
    x = x + wo_out
    ov_x = oget(ovl, "cross_attn")
    hx = rmsnorm(x, psel(lp["ln_x"], oget(ovl, "ln_x"), vidx), cfg.norm_eps)
    ox, qx, kx, vx = _attention(lp["cross_attn"], hx, enc_out, cfg, False,
                                ov=ov_x, vidx=vidx)
    xo_out = linear(ox, lp["cross_attn"]["wo"], oget(ov_x, "wo"), vidx,
                    waxes=("embed", "q_heads"))
    if io is not None:
        f = enc_out.shape[1]
        io["cross_attn.wq"] = (hx, qx.reshape(b, s, -1))
        io["cross_attn.wk"] = (enc_out, kx.reshape(b, f, -1))
        io["cross_attn.wv"] = (enc_out, vx.reshape(b, f, -1))
        io["cross_attn.wo"] = (ox, xo_out)
    return _mlp_part(lp, x + xo_out, cfg, io=io, ov=ovl, vidx=vidx), k, v


def forward(params, batch, cfg, collect_kv: bool = False, overlay=None,
            variant_idx=None, collect_io: bool = False):
    """Teacher-forced: batch = {"tokens" (B,S), "frames" (B,F,d)} ->
    (logits (B,S,V), aux).  aux["enc_out"] is the encoder output,
    aux["kv"] the decoder's self-attention (k, v) stacked (L,B,S,Hkv,hd)
    when collect_kv, aux["enc_io"] / aux["dec_io"] the per-projection
    (X, Y) calibration pairs stacked over layers when collect_io (the
    cross-attention's wk/wv pairs keyed on the encoder output).
    ``overlay`` / ``variant_idx`` as in ``transformer.forward``.  Both
    stacks rematerialise their layers under training when ``cfg.remat``
    (``layers.maybe_remat``)."""
    vidx = variant_idx
    enc_out, enc_io = encode(params, batch["frames"], cfg,
                             collect_io=collect_io, overlay=overlay,
                             vidx=vidx)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype,
                     bank=oget(overlay, "embed"), vidx=vidx)
    x = x + sinusoidal_positions(s, cfg.d_model, x.device).to(x.dtype)
    ov_layers = oget(overlay, "dec_layers")
    block = maybe_remat(_dec_block, cfg, collect_io)
    ks, vs, ios = [], [], []
    for i in range(cfg.num_layers):
        io = {} if collect_io else None
        x, k, v = block(_layer(params["dec_layers"], i), x, enc_out, cfg,
                        io=io, ovl=_layer(ov_layers, i), vidx=vidx)
        if collect_kv:
            ks.append(k)
            vs.append(v)
        ios.append(io)
    x = rmsnorm(x, psel(params["dec_norm"], oget(overlay, "dec_norm"),
                        vidx), cfg.norm_eps)
    logits = unembed_logits(x, params["embed"],           # tied embeddings
                            bank=oget(overlay, "embed"), vidx=vidx)
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32,
                                  device=x.device),
           "enc_out": enc_out}
    if collect_kv:
        aux["kv"] = (torch.stack(ks), torch.stack(vs))
    if collect_io:
        aux["enc_io"] = enc_io
        aux["dec_io"] = _stack_io(ios)
    return logits, aux


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> dict:
    """{"pos": (B,) int32, "self": the decoder's stacked (L, B, max_len,
    Hkv, hd) self-attention cache, "cross_k"/"cross_v": (L, B, F, Hkv,
    hd) projections of the encoder output}.  On a mesh Hkv is the rank's
    (``attention.local_kv_heads``): its own heads under head-TP."""
    hkv = A.local_kv_heads(cfg)
    one = A.make_kv_cache(batch, max_len, hkv, cfg.head_dim, device, dtype)
    cross = (cfg.num_layers, batch, cfg.encoder_frames, hkv, cfg.head_dim)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "self": {k: v.expand((cfg.num_layers,) + v.shape).clone()
                 for k, v in one.items()},
        "cross_k": torch.zeros(cross, dtype=dtype, device=device),
        "cross_v": torch.zeros(cross, dtype=dtype, device=device),
    }


def cache_batch_axes(cfg) -> dict:
    """Batch axis of each ``init_cache`` leaf (``pos`` 0; the rest 1,
    behind the layer dim): every leaf is row-separable, so the continuous
    scheduler merges admitted lanes by a row select."""
    return {"pos": 0, "self": {"k": 1, "v": 1, "slot_pos": 1},
            "cross_k": 1, "cross_v": 1}


def prefill(params, batch, cfg, max_len: int, cache_dtype=torch.bfloat16,
            overlay=None, variant_idx=None):
    """Teacher-forced pass over the prompt and the frames; returns
    (last_logits, cache).  The cross-attention K/V are projected once from
    the encoder output, through the overlay like every projection (the
    rank's heads on a mesh, or every head outside head-TP)."""
    vidx = variant_idx
    logits, aux = forward(params, batch, cfg, collect_kv=True,
                          overlay=overlay, variant_idx=vidx)
    b, s = batch["tokens"].shape
    cache = init_cache(cfg, b, max_len, logits.device, cache_dtype)
    k_all, v_all = aux["kv"]
    for i in range(cfg.num_layers):
        A.cache_insert(A.cache_layer_view(cache["self"], i), k_all[i],
                       v_all[i], 0)
    enc_out = aux["enc_out"]
    ov_layers = oget(overlay, "dec_layers")
    split = A.head_split(cfg)
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)["cross_attn"]
        ov_x = oget(_layer(ov_layers, i), "cross_attn")
        k = linear(enc_out, lp["wk"], oget(ov_x, "wk"), vidx,
                   waxes=("kv_heads", "embed"))
        v = linear(enc_out, lp["wv"], oget(ov_x, "wv"), vidx,
                   waxes=("kv_heads", "embed"))
        k, v = A.whole_kv(lp, k, v, split)
        cache["cross_k"][i] = _heads(k, -1, cfg.head_dim).to(cache_dtype)
        cache["cross_v"][i] = _heads(v, -1, cfg.head_dim).to(cache_dtype)
    cache["pos"] = torch.full((b,), s, dtype=torch.int32,
                              device=logits.device)
    return logits[:, -1, :], cache


def _cached_layers(params, x, cache, cfg, pos, overlay, vidx,
                   verify: bool) -> torch.Tensor:
    """The decoder layers over the live cache for ``x`` (B, T, d) at
    per-row positions ``pos``: T = 1 through ``attention.decode_attention``
    or T teacher-forced queries through ``attention.verify_attention``
    (the self cache written token by token); the cross-attention sees
    every frame (positions 0..F-1 against pos + F + t).  On a mesh every
    q row is the rank's (no sequence-TP over a cache)."""
    b, s, _ = x.shape
    split = A.head_split(cfg)
    read = A.verify_attention if verify else A.decode_attention
    insert = A.cache_insert_stacked_multi if verify \
        else A.cache_insert_stacked
    frame_pos = torch.arange(cfg.encoder_frames, dtype=torch.int32,
                             device=x.device)
    ov_layers = oget(overlay, "dec_layers")
    for i in range(cfg.num_layers):
        lp, ovl = _layer(params["dec_layers"], i), _layer(ov_layers, i)
        ov_s = oget(ovl, "self_attn")
        ov_x = oget(ovl, "cross_attn")
        hs = rmsnorm(x, psel(lp["ln1"], oget(ovl, "ln1"), vidx),
                     cfg.norm_eps)
        q, k, v = _qkv(lp["self_attn"], hs, hs, cfg, split, ov=ov_s,
                       vidx=vidx)
        insert(cache["self"], i, k, v, pos)
        view = A.cache_layer_view(cache["self"], i)
        o = read(q, view["k"], view["v"], view["slot_pos"], pos)
        x = x + linear(A.attn_out(o, cfg, split, lp["self_attn"]["wo"]),
                       lp["self_attn"]["wo"], oget(ov_s, "wo"), vidx,
                       waxes=("embed", "q_heads"))
        hx = rmsnorm(x, psel(lp["ln_x"], oget(ovl, "ln_x"), vidx),
                     cfg.norm_eps)
        qx = linear(hx, lp["cross_attn"]["wq"], oget(ov_x, "wq"), vidx,
                    waxes=("q_heads", "embed"))
        qx = A.whole_q(lp["cross_attn"], qx, split)
        ox = read(_heads(qx, -1, cfg.head_dim), cache["cross_k"][i],
                  cache["cross_v"][i], frame_pos, pos + cfg.encoder_frames)
        x = x + linear(A.attn_out(ox, cfg, split, lp["cross_attn"]["wo"]),
                       lp["cross_attn"]["wo"], oget(ov_x, "wo"), vidx,
                       waxes=("embed", "q_heads"))
        x = x + mlp2_apply(lp["mlp"],
                           rmsnorm(x, psel(lp["ln2"], oget(ovl, "ln2"),
                                           vidx), cfg.norm_eps),
                           ov=oget(ovl, "mlp"), vidx=vidx)
    x = rmsnorm(x, psel(params["dec_norm"], oget(overlay, "dec_norm"),
                        vidx), cfg.norm_eps)
    return unembed_logits(x, params["embed"], bank=oget(overlay, "embed"),
                          vidx=vidx)


def decode_step(params, token, cache, cfg, overlay=None, variant_idx=None):
    """token (B,) -> (logits (B,V), cache advanced by one, updated in
    place).  Self-attention reads the decoder cache; cross-attention sees
    every frame (positions 0..F-1 against pos + F)."""
    vidx = variant_idx
    pos = cache["pos"]
    x = embed_lookup(params["embed"], token[:, None], cfg.compute_dtype,
                     bank=oget(overlay, "embed"), vidx=vidx)
    table = sinusoid_table(cfg.max_seq_len, cfg.d_model, x.device)
    x = x + table[pos.to(torch.int64)][:, None, :].to(x.dtype)
    logits = _cached_layers(params, x, cache, cfg, pos, overlay, vidx,
                            verify=False)
    cache["pos"] = pos + 1
    return logits[:, 0, :], cache


def verify_step(params, tokens, cache, cfg, overlay=None, variant_idx=None):
    """tokens (B, T) teacher-forced over the live decode cache -> (logits
    (B, T, V), cache advanced by T, the self cache updated in place): the
    speculative verify.  ``decode_step`` with T tokens a row: the
    self-attention reads through ``attention.verify_attention``, and the
    cross-attention sees every frame for every query (positions 0..F-1
    against pos + F + t), as decode does.  A rejected suffix is dropped by
    ``rewind_cache`` (the self cache has no window)."""
    vidx = variant_idx
    pos = cache["pos"]
    s = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype,
                     bank=oget(overlay, "embed"), vidx=vidx)
    table = sinusoid_table(cfg.max_seq_len, cfg.d_model, x.device)
    posn = pos.to(torch.int64)[:, None] + torch.arange(s, device=x.device)
    x = x + table[posn].to(x.dtype)
    logits = _cached_layers(params, x, cache, cfg, pos, overlay, vidx,
                            verify=True)
    cache["pos"] = pos + s
    return logits, cache
