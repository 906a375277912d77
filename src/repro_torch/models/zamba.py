"""Zamba2-style hybrid (port of ``repro.models.zamba``): a Mamba2
backbone and ONE shared attention block.

After every ``attn_every``-th Mamba2 block the single shared transformer
block (attention at width 2·d over concat[h, original embedding], output
projected back to d, then a gated MLP) is applied again with the SAME
weights (zamba2-7b: 81 Mamba2 blocks, 13 applications and 3 trailing
blocks).  Weight sharing is what matters for delta compression: the
shared block's targets (``shared.*``) have no layer axis, and one delta
serves every application point.

Parameters keep the JAX tree: ``mamba`` leaves stacked (L, ...),
``shared`` unstacked, plus ``embed``, ``final_norm`` and ``unembed``.
Every projection goes through ``layers.linear`` (an overlay entry puts it
through the delta kernels); ``dt_bias``, ``a_log``, ``d_skip`` and the
convs are extras, selected per row from a bank with ``psel``.  The shared
block's attention is the plain ``attention.flash_attention``, as the JAX
module's is.

On a mesh every projection names its weight's logical axes (``waxes``,
the JAX module's): ``w_z``/``w_xc`` are column-parallel over ``d_inner``
("ssm"), ``w_bc``/``w_dt`` replicated ("ffn_small"), ``w_out``
row-parallel; ``conv_xc`` is channel-local and ``conv_bc`` replicated; the
scan runs the rank's heads with dt, ``a_log``, ``dt_bias`` and ``d_skip``
sliced to them, or every head when the rank's block cuts one
(:func:`_ssd_in`); ``gate_norm`` normalises over the whole ``d_inner``
(:func:`_mamba_post`).  The shared block's attention takes
``attention.head_split``'s layout and its KV caches the rank's heads.

Decode state (``init_state``): per Mamba layer the SSD state and two conv
windows (fp32, O(1) in sequence), plus one KV cache per application point
(``attn_kv``, stacked (n_super, B, max_len, Hkv, hd), updated in place).
``prefill`` computes each application point's q/k/v once and fills its
cache with that k/v; the JAX module projects them twice, once for the
cache and once inside the block, with the same values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention as A
from repro_torch.models import ssm
from repro_torch.models.delta_overlay import oget
from repro_torch.models.layers import (dim_part, embed_init, embed_lookup,
                                       gather_out, head_block, linear,
                                       local_size, maybe_remat, mlp_apply,
                                       mlp_init, narrow_heads, psel,
                                       rank_block, rmsnorm, rmsnorm_init,
                                       unembed_logits, weight_parts)
from repro_torch.models.param import (dense_init, ones_init, stack_layers,
                                      zeros_init)
from repro_torch.models.transformer import _layer
from repro_torch.models.xlstm import (_rowsel, _stack, _tail, causal_conv,
                                      conv_step)
from repro_torch.tree import tree_map

F32 = torch.float32


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _dims(cfg):
    di = 2 * cfg.d_model
    h = cfg.ssm_heads
    return di, h, di // h, cfg.ssm_state


def mamba_block_init(gen: torch.Generator, cfg) -> dict:
    """Projections are separate per role (z / x / B,C / dt), as in the JAX
    module."""
    d = cfg.d_model
    di, h, _, n = _dims(cfg)
    dev = gen.device
    return {
        "ln": rmsnorm_init(d, dev),
        "w_z": dense_init(gen, (di, d), ("ssm", "embed")),
        "w_xc": dense_init(gen, (di, d), ("ssm", "embed")),
        "w_bc": dense_init(gen, (2 * n, d), ("ffn_small", "embed")),
        "w_dt": dense_init(gen, (h, d), ("ffn_small", "embed")),
        "conv_xc": dense_init(gen, (cfg.ssm_conv, di), (None, "ssm"),
                              scale=0.3),
        "conv_bc": dense_init(gen, (cfg.ssm_conv, 2 * n), (None, None),
                              scale=0.3),
        "a_log": zeros_init((h,), (None,), dev),
        "dt_bias": zeros_init((h,), (None,), dev),
        "d_skip": ones_init((h,), (None,), dev),
        "gate_norm": ones_init((di,), (None,), dev),
        "w_out": dense_init(gen, (d, di), ("embed", "ssm")),
    }


def mamba_block_state(cfg, batch: int, device) -> dict:
    """One Mamba2 layer's state; on a mesh the SSD state holds the rank's
    heads (every head when its block of ``d_inner`` cuts one) and
    ``conv_xc`` the rank's channels (``conv_bc`` is replicated)."""
    di, h, p, n = _dims(cfg)
    k = cfg.ssm_conv - 1
    part = dim_part(di, "ssm")
    return {"ssm": ssm.mamba_init_state(batch, head_block(h, part)[1], p, n,
                                        device),
            "conv_xc": torch.zeros((batch, k, local_size(di, part)),
                                   dtype=F32, device=device),
            "conv_bc": torch.zeros((batch, k, 2 * n), dtype=F32,
                                   device=device)}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_WAXES = {"w_z": ("ssm", "embed"), "w_xc": ("ssm", "embed"),
          "w_bc": ("ffn_small", "embed"), "w_dt": ("ffn_small", "embed")}


def _mamba_proj(p, x, cfg, ov=None, vidx=None):
    """z and x_c (the rank's channels of ``d_inner`` on a mesh), B/C and
    dt (replicated: "ffn_small")."""
    xi = rmsnorm(x, psel(p["ln"], oget(ov, "ln"), vidx), cfg.norm_eps)
    return tuple(linear(xi, p[k], oget(ov, k), vidx, waxes=_WAXES[k])
                 for k in ("w_z", "w_xc", "w_bc", "w_dt"))


def _ssd_in(p, xc, bc, dt, cfg, lead, ov=None, vidx=None):
    """The scan's inputs on a mesh: x_c as (..., H_l, P) heads, B/C, and
    dt, ``a_log`` and ``d_skip`` sliced to those heads.  A rank whose block
    of ``d_inner`` holds whole heads scans its own: the replicated B/C,
    dt, ``a_log`` and ``d_skip`` enter its computation there
    (``layers.narrow_heads``, ``sharding.enter``: under grad their
    gradients are summed over the ranks).  One whose block cuts a head
    (zamba's reduced 2 heads over a model axis of 4) gathers x_c whole and
    scans every head, as GSPMD does for JAX's ``act_ssm`` fallback.  ->
    (x heads, B/C, dt, a_log, d_skip, (first head, count))."""
    from repro_torch.distributed import sharding as S
    _, h, pp, _ = _dims(cfg)
    part = weight_parts(p["w_xc"], ("ssm", "embed"))[0]
    h0, hl = head_block(h, part)
    if hl == h:
        xc = gather_out(xc, p["w_xc"], ("ssm", "embed"))
    else:
        bc = S.enter(bc, part)

    def heads(t):
        return narrow_heads(t, (h0, hl), part)
    return (xc.reshape(*lead, hl, pp), bc, heads(dt),
            heads(_rowsel(p, "a_log", ov, vidx)),
            heads(_rowsel(p, "d_skip", ov, vidx)), (h0, hl))


def _mamba_post(p, y, z, x, cfg, heads, ov=None, vidx=None):
    """x + w_out(gate_norm(y ⊙ silu(z))): on a mesh the rank's channels
    (sliced when the rank scanned every head) form ``w_out``'s K-tile, and
    ``gate_norm`` normalises over the whole ``d_inner`` (its sum of squares
    summed over the ranks: ``layers.rmsnorm(part=)``)."""
    b, s, _ = x.shape
    _, h, _, _ = _dims(cfg)
    part = weight_parts(p["w_out"], ("embed", "ssm"))[1]
    y = y.reshape(b, s, -1)
    if heads[1] == h:
        y = rank_block(y, part)
    y = rmsnorm(y * F.silu(z),
                rank_block(psel(p["gate_norm"], oget(ov, "gate_norm"),
                                vidx), part),
                cfg.norm_eps, part=part)
    return x + linear(y, p["w_out"], oget(ov, "w_out"), vidx,
                      waxes=("embed", "ssm"))


def mamba_block_apply(p, x, cfg, state: dict, ov=None, vidx=None):
    """Sequence path: x (B,S,D) -> (y, new state)."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    z, xc_pre, bc_pre, dt_raw = _mamba_proj(p, x, cfg, ov=ov, vidx=vidx)
    xc = F.silu(causal_conv(xc_pre, _rowsel(p, "conv_xc", ov, vidx)))
    bc = F.silu(causal_conv(bc_pre, _rowsel(p, "conv_bc", ov, vidx)))
    dt = _softplus(dt_raw.to(F32) + psel(p["dt_bias"], oget(ov, "dt_bias"),
                                         vidx).to(F32))
    xh, bc, dt, a_log, d_skip, heads = _ssd_in(p, xc, bc, dt, cfg, (b, s),
                                               ov=ov, vidx=vidx)
    y, ssm_state = ssm.mamba_chunkwise(xh, bc[..., :n], bc[..., n:], dt,
                                       a_log, d_skip, state=state["ssm"])
    return (_mamba_post(p, y, z, x, cfg, heads, ov=ov, vidx=vidx),
            {"ssm": ssm_state,
             "conv_xc": _tail(state["conv_xc"], xc_pre, cfg.ssm_conv),
             "conv_bc": _tail(state["conv_bc"], bc_pre, cfg.ssm_conv)})


def mamba_block_step(p, x, cfg, state: dict, ov=None, vidx=None):
    """Decode path: x (B,1,D)."""
    b = x.shape[0]
    n = cfg.ssm_state
    z, xc_pre, bc_pre, dt_raw = _mamba_proj(p, x, cfg, ov=ov, vidx=vidx)
    win_xc, xc1 = conv_step(state["conv_xc"].to(xc_pre.dtype), xc_pre[:, 0],
                            _rowsel(p, "conv_xc", ov, vidx))
    win_bc, bc1 = conv_step(state["conv_bc"].to(bc_pre.dtype), bc_pre[:, 0],
                            _rowsel(p, "conv_bc", ov, vidx))
    xc, bc = F.silu(xc1), F.silu(bc1)
    dt = _softplus(dt_raw[:, 0].to(F32)
                   + _rowsel(p, "dt_bias", ov, vidx).to(F32))
    xh, bc, dt, a_log, d_skip, heads = _ssd_in(p, xc, bc, dt, cfg, (b,),
                                               ov=ov, vidx=vidx)
    ssm_state, y = ssm.mamba_step(state["ssm"], xh, bc[..., :n],
                                  bc[..., n:], dt, a_log, d_skip)
    return (_mamba_post(p, y[:, None], z, x, cfg, heads, ov=ov, vidx=vidx),
            {"ssm": ssm_state, "conv_xc": win_xc.to(F32),
             "conv_bc": win_bc.to(F32)})


# ---------------------------------------------------------------------------
# shared attention block (width 2d in, d out)
# ---------------------------------------------------------------------------

def shared_block_init(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    dev = gen.device
    return {
        "ln1": rmsnorm_init(2 * d, dev),
        "wq": dense_init(gen, (cfg.q_dim, 2 * d), ("q_heads", "embed")),
        "wk": dense_init(gen, (cfg.kv_dim, 2 * d), ("kv_heads", "embed")),
        "wv": dense_init(gen, (cfg.kv_dim, 2 * d), ("kv_heads", "embed")),
        "wo": dense_init(gen, (d, cfg.q_dim), ("embed", "q_heads")),
        "ln2": rmsnorm_init(d, dev),
        "mlp": mlp_init(gen, d, cfg.d_ff),
    }


def _shared_qkv(p, h2, cfg, positions, ov=None, vidx=None):
    """q (B,S,Hq,hd), k/v (B,S,Hkv,hd) of the 2d-wide input, RoPE'd; on a
    mesh in ``attention.head_split``'s layout of this length
    (``attention.qkv_project``)."""
    hi = rmsnorm(h2, psel(p["ln1"], oget(ov, "ln1"), vidx), cfg.norm_eps)
    return A.qkv_project(p, hi, cfg, positions, cfg.rope_theta, ov=ov,
                         vidx=vidx)


def _shared_out(p, x, o, cfg, split, ov=None, vidx=None):
    """x + wo(o), then x + MLP(ln2(x)); ``o`` the attention output in
    ``split``'s layout."""
    x = x + linear(A.attn_out(o, cfg, split, p["wo"]), p["wo"],
                   oget(ov, "wo"), vidx, waxes=("embed", "q_heads"))
    return x + mlp_apply(p["mlp"],
                         rmsnorm(x, psel(p["ln2"], oget(ov, "ln2"), vidx),
                                 cfg.norm_eps),
                         ov=oget(ov, "mlp"), vidx=vidx)


def shared_block_apply(p, x, x0, cfg, positions, ov=None, vidx=None):
    """Sequence path -> (x, (k, v)): the block's output and the k/v its
    attention read (what a prefill caches)."""
    s = x.shape[1]
    split = A.head_split(cfg, s)
    q, k, v = _shared_qkv(p, torch.cat([x, x0], dim=-1), cfg, positions,
                          ov=ov, vidx=vidx)
    o = A.attend(q, k, v, cfg, split, s)
    return _shared_out(p, x, o, cfg, split, ov=ov, vidx=vidx), (k, v)


def shared_block_step(p, x, x0, cfg, caches: dict, idx: int, pos, ov=None,
                      vidx=None):
    """Decode path: ``pos`` (B,) per-lane positions; application point
    ``idx``'s cache of the stacked ``caches`` is updated in place."""
    split = A.head_split(cfg, 1)
    q, k, v = _shared_qkv(p, torch.cat([x, x0], dim=-1), cfg,
                          pos.to(torch.int32)[:, None], ov=ov, vidx=vidx)
    A.cache_insert_stacked(caches, idx, k, v, pos)
    view = A.cache_layer_view(caches, idx)
    o = A.decode_attention(q, A.local_kv(view["k"], cfg),
                           A.local_kv(view["v"], cfg), view["slot_pos"], pos)
    return _shared_out(p, x, o, cfg, split, ov=ov, vidx=vidx)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _layout(cfg) -> tuple[int, int, int]:
    """(n_super, per, n_rem): num_layers = n_super*per + n_rem."""
    per = cfg.attn_every
    n_super = cfg.num_layers // per
    return n_super, per, cfg.num_layers - n_super * per


def init(gen: torch.Generator, cfg) -> dict:
    """Param tree on ``gen``'s device (float32 leaves, as the JAX init)."""
    return {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model),
        "final_norm": rmsnorm_init(cfg.d_model, gen.device),
        "unembed": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                              ("vocab", "embed"), scale=cfg.d_model ** -0.5),
        "mamba": stack_layers(lambda g: mamba_block_init(g, cfg), gen,
                              cfg.num_layers),
        "shared": shared_block_init(gen, cfg),
    }


def _rep(tree, n: int):
    return tree_map(lambda a: a.expand((n,) + a.shape).clone(), tree)


def mamba_only_state(cfg, batch: int, device) -> dict:
    """Sequence-path state: SSD carries only, no KV caches."""
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "mamba": _rep(mamba_block_state(cfg, batch, device),
                          cfg.num_layers),
            "attn_kv": None}


def init_state(cfg, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> dict:
    """{"pos", "mamba": per-layer SSD state and conv windows (fp32),
    "attn_kv": one (B, max_len) KV cache per application point, stacked}."""
    n_super = _layout(cfg)[0]
    kv = A.make_kv_cache(batch, max_len, A.local_kv_heads(cfg),
                         cfg.head_dim, device, dtype)
    st = mamba_only_state(cfg, batch, device)
    st["attn_kv"] = _rep(kv, n_super)
    return st


init_cache = init_state


def cache_batch_axes(cfg) -> dict:
    """Batch axis of each ``init_state`` leaf (the JAX ``state_pspecs``'
    act_batch): ``pos`` 0, every other leaf 1 (behind the layer or
    application dim)."""
    return {"pos": 0,
            "mamba": {"ssm": 1, "conv_xc": 1, "conv_bc": 1},
            "attn_kv": {"k": 1, "v": 1, "slot_pos": 1}}


def _run(params, x, cfg, state, overlay, vidx, *, positions=None,
         pos=None):
    """The blocks in order: ``per`` Mamba2 blocks then the shared block,
    ``n_super`` times, then the trailing Mamba2 blocks.  With ``pos``
    (decode) each block steps and each application point's cache in
    ``state["attn_kv"]`` takes the token; else (sequence) ``positions``
    feed the shared block's RoPE, and each super-block rematerialises
    under training when ``cfg.remat`` (``layers.maybe_remat``; the
    trailing blocks do not, as in the JAX module).  Returns (x, per-layer
    Mamba states stacked, [(k, v)] of the application points; empty when
    stepping)."""
    n_super, per, n_rem = _layout(cfg)
    step = pos is not None
    m_apply = mamba_block_step if step else mamba_block_apply
    m_ov, sh_ov = oget(overlay, "mamba"), oget(overlay, "shared")
    shared = params["shared"]
    x0 = x

    def mamba(li, x):
        return m_apply(_layer(params["mamba"], li), x, cfg,
                       _layer(state["mamba"], li), ov=_layer(m_ov, li),
                       vidx=vidx)

    def body(i, x):
        sts = []
        for j in range(per):
            x, st = mamba(i * per + j, x)
            sts.append(st)
        if step:
            return shared_block_step(shared, x, x0, cfg, state["attn_kv"], i,
                                     pos, ov=sh_ov, vidx=vidx), sts, None
        x, kv = shared_block_apply(shared, x, x0, cfg, positions, ov=sh_ov,
                                   vidx=vidx)
        return x, sts, kv

    block = body if step else maybe_remat(body, cfg)
    new, kvs = [], []
    for i in range(n_super):
        x, sts, kv = block(i, x)
        new += sts
        if not step:
            kvs.append(kv)
    for j in range(n_rem):
        x, st = mamba(n_super * per + j, x)
        new.append(st)
    return x, _stack(new), kvs


def _logits(params, x, cfg, overlay, vidx):
    x = rmsnorm(x, psel(params["final_norm"], oget(overlay, "final_norm"),
                        vidx), cfg.norm_eps)
    return unembed_logits(x, params["unembed"],
                          bank=oget(overlay, "unembed"), vidx=vidx)


def _sequence(params, batch, cfg, state, overlay, vidx):
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype,
                     bank=oget(overlay, "embed"), vidx=vidx)
    positions = torch.arange(tokens.shape[1], device=x.device)
    x, mamba, kvs = _run(params, x, cfg, state, overlay, vidx,
                         positions=positions)
    return _logits(params, x, cfg, overlay, vidx), mamba, kvs


def forward(params, batch, cfg, state: dict | None = None, overlay=None,
            variant_idx=None):
    """batch = {"tokens" (B,S)} -> (logits (B,S,V), aux): aux["state"]
    carries the Mamba states after the sequence and ``state``'s KV caches
    untouched (None from zeros), aux["moe_aux"] 0."""
    b, s = batch["tokens"].shape
    if state is None:
        state = mamba_only_state(cfg, b, batch["tokens"].device)
    logits, mamba, _ = _sequence(params, batch, cfg, state, overlay,
                                 variant_idx)
    new_state = {"pos": state["pos"] + s, "mamba": mamba,
                 "attn_kv": state.get("attn_kv")}
    return logits, {"moe_aux": torch.zeros((), dtype=F32,
                                           device=logits.device),
                    "state": new_state}


def prefill(params, batch, cfg, max_len: int, cache_dtype=torch.bfloat16,
            overlay=None, variant_idx=None):
    """One pass over the prompt: SSD states carried, each application
    point's k/v written into its KV cache.  Returns (last logits (B,V),
    state)."""
    b, s = batch["tokens"].shape
    state = init_state(cfg, b, max_len, batch["tokens"].device, cache_dtype)
    logits, mamba, kvs = _sequence(params, batch, cfg, state, overlay,
                                   variant_idx)
    for i, (k, v) in enumerate(kvs):
        A.cache_insert(A.cache_layer_view(state["attn_kv"], i), k, v, 0)
    state["mamba"] = mamba
    state["pos"] = torch.full((b,), s, dtype=torch.int32,
                              device=logits.device)
    return logits[:, -1, :], state


def decode_step(params, token, state, cfg, overlay=None, variant_idx=None):
    """token (B,) -> (logits (B,V), state advanced by one: new Mamba
    states, the KV caches updated in place)."""
    vidx = variant_idx
    pos = state["pos"]
    x = embed_lookup(params["embed"], token[:, None], cfg.compute_dtype,
                     bank=oget(overlay, "embed"), vidx=vidx)
    x, mamba, _ = _run(params, x, cfg, state, overlay, vidx, pos=pos)
    logits = _logits(params, x, cfg, overlay, vidx)
    return logits[:, 0, :], {"pos": pos + 1, "mamba": mamba,
                             "attn_kv": state["attn_kv"]}
