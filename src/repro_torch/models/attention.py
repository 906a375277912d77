"""Attention (port of ``repro.models.attention``): GQA with a chunked
online-softmax forward, KV caches, single-token decode and the
speculative verify's teacher-forced queries over the decode cache.

Plain PyTorch: the JAX model computes attention with jnp einsums, not a
Pallas kernel.  Numerics follow it: operands stay in their storage dtype
(bf16 in serving) and are upcast to fp32 right before each product — the
counterpart of ``preferred_element_type=float32`` — with fp32 softmax
statistics and the same casts ((q·scale) to k's dtype, probabilities to
v's dtype).

Caches are updated in place (the JAX functions return new caches; here
the returned dict is the same storage, which saves a cache-sized copy per
step).

On a mesh (``distributed/sharding.py``) the head layout follows the JAX
module's strategies by divisibility against the "model" axis
(:func:`head_split`, in the JAX branch order): head-TP when both head
counts divide it (each rank holds whole q and KV heads, and its KV cache
its own KV heads); GQA with q heads sharded and K/V all-gathered once a
layer when only the q heads divide (the cache then holds every KV head,
and rank r's local q head j reads KV head (r·hq/M + j) // group:
:func:`local_kv`); sequence-TP when the q heads do not divide and the
sequence does (forward-only rules, as serving's always are); else the
flat-``q_dim`` shard or, at s = 1, the unconstrained decode case, which
the port lays out alike ("whole").  Under explicit SPMD every branch
needs a concrete layout (:func:`layout_qkv`, :func:`attend`,
:func:`attn_out`):

* "seq": the ``wq`` product's block, cut across head boundaries by the
  divisibility fallback on ``q_dim``, is all-gathered over "model" and the
  rank keeps its q-sequence rows (rows r·S/M .. (r+1)·S/M, whole
  features); K/V are made whole the same way, and each rank attends its
  own rows with the causal mask offset by its first row.  The output rows
  are all-gathered and the rank keeps the ``wo`` product's K-tile before
  the row-parallel psum;
* "whole" (JAX's flat-``q_dim`` branch, a length that does not split,
  and decode at s = 1): q, K and V are gathered whole and every rank
  attends every head — the same numbers as one device, since a contraction over a
  sharded head dim would psum whole logits — and keeps ``wo``'s K-tile.

Outside head-TP the cache holds every KV head (:func:`local_kv_heads`).
The gathers are all-gathers followed by a slice (no all-to-all): the
collectives the port already has, at the price of moving the whole q
once a layer.

Under grad (training under a mesh) every place where a tensor that every
rank of "model" holds whole enters a rank's own heads or rows passes it
through ``sharding.enter`` (its backward sums the ranks' gradients): the
GQA copies of :func:`local_kv`, the rows that "seq" cuts from q, K and V
under "seq", and the ``q_norm``/``k_norm`` scales over local heads; the
gathers' backward keeps the rank's block.  Training takes "seq" only when
``q_dim`` does not divide the model axis (:func:`head_split`).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import _oget, apply_rope, linear, psel, rmsnorm
from repro_torch.models.param import dense_init, ones_init

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    p = {
        "wq": dense_init(gen, (cfg.q_dim, d), ("q_heads", "embed")),
        "wk": dense_init(gen, (cfg.kv_dim, d), ("kv_heads", "embed")),
        "wv": dense_init(gen, (cfg.kv_dim, d), ("kv_heads", "embed")),
        "wo": dense_init(gen, (d, cfg.q_dim), ("embed", "q_heads")),
    }
    if cfg.qk_norm:
        p["q_norm"] = ones_init((cfg.head_dim,), (None,), gen.device)
        p["k_norm"] = ones_init((cfg.head_dim,), (None,), gen.device)
    return p


def head_split(cfg, s=None) -> str:
    """The attention layout on the active mesh, in the JAX module's branch
    order: "none" (no model axis), "heads" (head-TP), "gqa" (q heads
    sharded, K/V whole), "seq" (sequence-TP: the q heads do not divide,
    the length ``s`` > 1 does, and the rules are forward-only or ``q_dim``
    does not divide either) or "whole" (JAX's flat-``q_dim`` shard, s = 1
    or an unknown ``s``: every head on every rank)."""
    from repro_torch.distributed.sharding import (ctx_axis_size,
                                                  ctx_forward_only)
    ms = ctx_axis_size("model") or 1
    if ms == 1:
        return "none"
    if cfg.num_heads % ms == 0 and cfg.num_kv_heads % ms == 0:
        return "heads"
    if cfg.num_heads % ms == 0:
        return "gqa"
    if (s is not None and s > 1 and s % ms == 0
            and (ctx_forward_only() or cfg.q_dim % ms)):
        return "seq"
    return "whole"


def local_kv_heads(cfg) -> int:
    """KV heads a rank's cache holds: its own under head-TP, all of them
    otherwise."""
    from repro_torch.distributed.sharding import ctx_axis_size
    if head_split(cfg) == "heads":
        return cfg.num_kv_heads // ctx_axis_size("model")
    return cfg.num_kv_heads


def local_kv(t: torch.Tensor, cfg) -> torch.Tensor:
    """K or V (B, T, Hkv, hd) as the rank's local q heads read it: under
    the "gqa" layout each local q head j of rank r gets its own copy of KV
    head (r·hq/M + j) // group (B, T, hq/M, hd), so the attention runs one
    q head per KV head; ``t`` itself otherwise."""
    if head_split(cfg) != "gqa":
        return t
    from repro_torch.distributed.sharding import active_mesh, enter
    t = enter(t, "model")
    mesh = active_mesh()
    hq_l = cfg.num_heads // mesh.axis_size("model")
    group = cfg.num_heads // cfg.num_kv_heads
    idx = (mesh.coord("model") * hq_l
           + torch.arange(hq_l, device=t.device)) // group
    return t.index_select(2, idx)


def seq_rows(cfg, s: int, split: str) -> tuple:
    """(first, count) of the q rows a rank attends: its block of the
    ``s`` rows under "seq", every row otherwise."""
    if split != "seq":
        return 0, s
    from repro_torch.distributed.sharding import active_mesh
    mesh = active_mesh()
    n = s // mesh.axis_size("model")
    return mesh.coord("model") * n, n


def whole_kv(p: dict, k: torch.Tensor, v: torch.Tensor, split: str):
    """The ``wk``/``wv`` products (the rank's blocks of their out dims) as
    ``split`` holds K/V: the rank's heads under "none" and "heads", every
    head otherwise."""
    from repro_torch.models.layers import gather_out
    if split in ("none", "heads"):
        return k, v
    return (gather_out(k, p["wk"], ("kv_heads", "embed")),
            gather_out(v, p["wv"], ("kv_heads", "embed")))


def whole_q(p: dict, q: torch.Tensor, split: str) -> torch.Tensor:
    """The ``wq`` product (the rank's block) as ``split`` holds q before
    its rows are cut: the rank's heads under "none", "heads" and "gqa",
    every head otherwise."""
    from repro_torch.models.layers import gather_out
    if split in ("none", "heads", "gqa"):
        return q
    return gather_out(q, p["wq"], ("q_heads", "embed"))


def layout_qkv(p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg, split: str):
    """The flat (B, S, features) products of ``wq``/``wk``/``wv`` (the
    rank's blocks of their out dims) in ``split``'s layout
    (:func:`whole_q`, :func:`whole_kv`), q cut to the rank's rows under
    "seq"."""
    k, v = whole_kv(p, k, v, split)
    q = whole_q(p, q, split)
    if split != "seq":
        return q, k, v
    from repro_torch.distributed.sharding import enter
    lo, n = seq_rows(cfg, q.shape[1], split)
    return enter(q, "model")[:, lo:lo + n], k, v


def qkv_project(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                theta, ov=None, vidx=None, split=None):
    """x (B,S,D) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd), qk-normed, RoPE'd.
    ``vidx`` (B,) selects each row's bank slot of a banked overlay.  On a
    mesh the heads and q rows are those of ``split`` (default
    :func:`head_split` of this length; under "seq" q holds the rank's rows,
    RoPE'd at their positions)."""
    b, s, _ = x.shape
    split = head_split(cfg, s) if split is None else split
    q = linear(x, p["wq"], _oget(ov, "wq"), vidx, waxes=("q_heads", "embed"))
    k = linear(x, p["wk"], _oget(ov, "wk"), vidx,
               waxes=("kv_heads", "embed"))
    v = linear(x, p["wv"], _oget(ov, "wv"), vidx,
               waxes=("kv_heads", "embed"))
    q, k, v = layout_qkv(p, q, k, v, cfg, split)
    lo, n = seq_rows(cfg, s, split)
    q = q.reshape(b, n, -1, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    if cfg.qk_norm:
        from repro_torch.distributed.sharding import enter
        # a norm scale every rank holds whole enters the rank's own heads
        # (or rows) of q, and of k under head-TP
        q_scale = psel(p["q_norm"], _oget(ov, "q_norm"), vidx, lead=2)
        k_scale = psel(p["k_norm"], _oget(ov, "k_norm"), vidx, lead=2)
        if split in ("heads", "gqa", "seq"):
            q_scale = enter(q_scale, "model")
        if split == "heads":
            k_scale = enter(k_scale, "model")
        q = rmsnorm(q, q_scale, cfg.norm_eps)
        k = rmsnorm(k, k_scale, cfg.norm_eps)
    if theta is not None:
        q = apply_rope(q, positions[..., lo:lo + n], theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def seq_kv(k: torch.Tensor, v: torch.Tensor, split: str) -> tuple:
    """Whole-length K/V as they enter the rank's own q rows under "seq"
    (``sharding.enter``: under grad the ranks' gradients are summed);
    themselves otherwise."""
    if split != "seq":
        return k, v
    from repro_torch.distributed.sharding import enter
    return enter(k, "model"), enter(v, "model")


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
           split: str, s: int, window: int = 0) -> torch.Tensor:
    """Causal :func:`flash_attention` of q (the rank's rows and heads of
    ``s`` rows) against whole-length K/V in ``split``'s layout: GQA reads
    its KV heads through :func:`local_kv`, sequence-TP offsets the mask by
    the rank's first row (the backward honours ``q_offset``)."""
    lo, _ = seq_rows(cfg, s, split)
    k, v = seq_kv(k, v, split)
    return flash_attention(q, local_kv(k, cfg), local_kv(v, cfg),
                           window=window, q_offset=lo)


def attn_out(o: torch.Tensor, cfg, split: str, w_o) -> torch.Tensor:
    """The attention output (B, rows, heads, hd) as the ``wo`` product's
    input (B, S, K-tile): the local heads' features under "none", "heads"
    and "gqa"; otherwise the rows made whole (all-gathered under "seq")
    and the rank's K-tile of the features kept."""
    b = o.shape[0]
    o = o.reshape(b, o.shape[1], -1)
    if split in ("none", "heads", "gqa"):
        return o
    from repro_torch.distributed import sharding as S
    from repro_torch.models.layers import rank_block, weight_parts
    if split == "seq":
        o = S.all_gather(o, "model", 1)
    return rank_block(o, weight_parts(w_o, ("embed", "q_heads"))[1])


# ---------------------------------------------------------------------------
# chunked (flash-style) attention forward (prefill)
# ---------------------------------------------------------------------------

def _pick_chunk(t: int, chunk: int) -> int:
    chunk = min(chunk, t)
    while t % chunk:
        chunk //= 2
    return chunk


def even_chunk(t: int, chunk: int = 512) -> int:
    """The largest divisor of ``t`` up to ``chunk``: a KV chunk that
    divides the keys without halving below it (500 for whisper's 1500
    frames, where :func:`_pick_chunk` halves 512 down to 4)."""
    return max(c for c in range(1, min(chunk, t) + 1) if t % c == 0)


def _scaled_q(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(q·hd^-½) rounded to k's dtype, grouped (B,S,Hkv,G,hd), as fp32."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    return ((q.to(torch.float32) * hd ** -0.5).to(k.dtype)
            .reshape(b, s, hkv, hq // hkv, hd).to(torch.float32))


def _chunk_logits(qf, k_blk, idx, chunk, q_pos, kv_offset, causal, window):
    """Masked fp32 logits (B,S,Hkv,G,chunk) of KV chunk ``idx``."""
    dev = qf.device
    logits = torch.einsum("bskgh,bckh->bskgc", qf, k_blk.to(torch.float32))
    k_pos = kv_offset + idx * chunk + torch.arange(chunk, device=dev)
    mask = torch.ones((qf.shape[1], chunk), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(mask[None, :, None, None, :], logits,
                       torch.full((), NEG_INF, device=dev))


def _flash_fwd(q, k, v, causal, window, q_offset, kv_offset, chunk):
    """The chunk loop: -> (normalised fp32 output (B,S,Hkv,G,hd), the
    running max m and denominator l (B,S,Hkv,G))."""
    b, s, hq, hd = q.shape
    _, t, hkv, _ = k.shape
    g = hq // hkv
    dev = q.device
    qf = _scaled_q(q, k)
    q_pos = q_offset + torch.arange(s, device=dev)
    m = torch.full((b, s, hkv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, s, hkv, g), dtype=torch.float32, device=dev)
    o = torch.zeros((b, s, hkv, g, hd), dtype=torch.float32, device=dev)
    for idx in range(t // chunk):
        v_blk = v[:, idx * chunk:(idx + 1) * chunk]
        logits = _chunk_logits(qf, k[:, idx * chunk:(idx + 1) * chunk], idx,
                               chunk, q_pos, kv_offset, causal, window)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - new_m)
        p_exp = torch.exp(logits - new_m[..., None])
        l = l * alpha + p_exp.sum(dim=-1)
        upd = torch.einsum("bskgc,bckh->bskgh",
                           p_exp.to(v.dtype).to(torch.float32),
                           v_blk.to(torch.float32))
        o = o * alpha[..., None] + upd
        m = new_m
    return o / torch.clamp(l, min=1e-30)[..., None], m, l


def _flash_bwd(q, k, v, out, m, l, dout, causal, window, q_offset,
               kv_offset, chunk):
    """FlashAttention-2-style backward (the JAX package's ``_flash_bwd``):
    p is recomputed per KV chunk from the saved (m, l), so no (S × T)
    tensor is ever held.  Operands are rounded where the JAX package
    rounds them (q·scale, p, dO and dS to k's dtype) and every product
    accumulates in fp32; delta = Σ dO ⊙ O uses the fp32 output."""
    b, s, hq, hd = q.shape
    _, t, hkv, _ = k.shape
    g = hq // hkv
    lp = k.dtype
    qf = _scaled_q(q, k)
    q_pos = q_offset + torch.arange(s, device=q.device)
    do = dout.to(torch.float32).reshape(b, s, hkv, g, hd)
    do_lp = do.to(lp).to(torch.float32)
    l_safe = torch.clamp(l, min=1e-30)
    delta = (do * out).sum(dim=-1)                          # (b,s,hkv,g)
    dq = torch.zeros_like(qf)
    dk = torch.empty((b, t, hkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for idx in range(t // chunk):
        sl = slice(idx * chunk, (idx + 1) * chunk)
        k_blk = k[:, sl].to(torch.float32)
        logits = _chunk_logits(qf, k[:, sl], idx, chunk, q_pos, kv_offset,
                               causal, window)
        p = torch.exp(logits - m[..., None]) / l_safe[..., None]
        p_lp = p.to(lp).to(torch.float32)
        dv[:, sl] = torch.einsum("bskgc,bskgh->bckh", p_lp, do_lp)
        dp = torch.einsum("bskgh,bckh->bskgc", do_lp,
                          v[:, sl].to(torch.float32))
        ds_lp = (p * (dp - delta[..., None])).to(lp).to(torch.float32)
        dq += torch.einsum("bskgc,bckh->bskgh", ds_lp, k_blk)
        dk[:, sl] = torch.einsum("bskgc,bskgh->bckh", ds_lp, qf)
    dq = (dq * hd ** -0.5).reshape(b, s, hq, hd).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with the JAX package's ``custom_vjp``: the
    forward saves (q, k, v, fp32 output, m, l), never a chunk's logits."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_offset, chunk):
        out, m, l = _flash_fwd(q, k, v, causal, window, q_offset, kv_offset,
                               chunk)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (causal, window, q_offset, kv_offset, chunk)
        return out.reshape(q.shape).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, m, l, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_offset: int = 0, chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV chunks (what the JAX ``_flash_fwd``
    computes).  q (B,S,Hq,hd); k, v (B,T,Hkv,hd); GQA by head grouping;
    window > 0 keeps the last ``window`` keys.  Returns (B,S,Hq,hd) in
    q.dtype.  The backward recomputes each chunk's probabilities
    (:class:`_FlashAttention`)."""
    chunk = _pick_chunk(k.shape[1], chunk)
    return _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                 kv_offset, chunk)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0,
                  kv_offset: int = 0) -> torch.Tensor:
    """Dense reference attention (tests and comparisons): the full (S, T)
    fp32 logits, masked with ``NEG_INF``, one softmax.  Shapes as
    :func:`flash_attention`."""
    b, s, hq, hd = q.shape
    _, t, hkv, _ = k.shape
    g = hq // hkv
    dev = q.device
    qf = (q.to(torch.float32) * hd ** -0.5).reshape(b, s, hkv, g, hd)
    logits = torch.einsum("bskgh,btkh->bskgt", qf, k.to(torch.float32))
    q_pos = q_offset + torch.arange(s, device=dev)
    k_pos = kv_offset + torch.arange(t, device=dev)
    mask = torch.ones((s, t), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    logits = torch.where(mask[None, :, None, None, :], logits,
                         torch.full((), NEG_INF, device=dev))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bskgt,btkh->bskgh", w, v.to(torch.float32))
    return out.reshape(b, s, hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# decode attention (single new token against a cache)
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """q (B,1,Hq,hd); caches (B,T,Hkv,hd); slot_pos (T,) or (B,T) absolute
    position per slot (-1 empty); pos scalar or (B,) current position."""
    b, _, hq, hd = q.shape
    _, t, hkv, _ = k_cache.shape
    g = hq // hkv
    qf = ((q.to(torch.float32) * hd ** -0.5).to(k_cache.dtype)
          .reshape(b, hkv, g, hd).to(torch.float32))
    logits = torch.einsum("bkgh,btkh->bkgt", qf, k_cache.to(torch.float32))
    sp = torch.broadcast_to(slot_pos.to(torch.int32), (b, t))
    pos_b = torch.broadcast_to(torch.as_tensor(pos, dtype=torch.int32,
                                               device=q.device), (b,))[:, None]
    valid = (sp >= 0) & (sp <= pos_b)
    if window > 0:
        valid &= sp > pos_b - window
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    p_norm = (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", p_norm.to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """:func:`decode_attention` over S teacher-forced queries per row (the
    speculative verify): q (B,S,Hq,hd), query s at absolute position
    pos[b] + s; caches, ``slot_pos`` and ``pos`` as in
    :func:`decode_attention`, whose arithmetic each query slice repeats
    (the same casts, fp32 statistics and ``NEG_INF`` masking: a masked
    slot, stale entries past a rewound ``pos`` included, adds an exact 0)."""
    b, s, hq, hd = q.shape
    _, t, hkv, _ = k_cache.shape
    g = hq // hkv
    qf = ((q.to(torch.float32) * hd ** -0.5).to(k_cache.dtype)
          .reshape(b, s, hkv, g, hd).to(torch.float32))
    logits = torch.einsum("bskgh,btkh->bskgt", qf,
                          k_cache.to(torch.float32))
    sp = torch.broadcast_to(slot_pos.to(torch.int32), (b, t))[:, None, :]
    pos_b = torch.broadcast_to(torch.as_tensor(pos, dtype=torch.int32,
                                               device=q.device), (b,))
    qpos = (pos_b[:, None] + torch.arange(s, dtype=torch.int32,
                                          device=q.device))[:, :, None]
    valid = (sp >= 0) & (sp <= qpos)                        # (B, S, T)
    if window > 0:
        valid &= sp > qpos - window
    logits = torch.where(valid[:, :, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    p_norm = (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype)
    out = torch.einsum("bskgt,btkh->bskgh", p_norm.to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(b, s, hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def make_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  device, dtype=torch.bfloat16) -> dict:
    """One layer's cache; ``slot_pos`` is the absolute position held in
    each slot, per batch row (-1 = empty)."""
    return {
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "slot_pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                               device=device),
    }


def _row_pos(pos, b: int, device) -> torch.Tensor:
    """Normalise a scalar-or-(B,) position to (B,) int64 indices."""
    return torch.broadcast_to(torch.as_tensor(pos, device=device),
                              (b,)).to(torch.int64)


def cache_insert(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos, ring: bool = False) -> dict:
    """Write (B, n, Hkv, hd) at absolute position(s) from ``pos`` in place.
    n > 1 without ``ring`` (prefill) writes contiguously at a scalar
    offset; single tokens scatter per row (``pos`` scalar or (B,)).
    ``ring`` (sliding-window layers) wraps the write to slot ``pos % t``;
    otherwise the slot is ``pos`` clipped to the cache."""
    b, t = cache["k"].shape[:2]
    n = k_new.shape[1]
    dtype = cache["k"].dtype
    if not ring and n > 1:
        p = int(pos)
        cache["k"][:, p:p + n] = k_new.to(dtype)
        cache["v"][:, p:p + n] = v_new.to(dtype)
        cache["slot_pos"][:, p:p + n] = torch.arange(
            p, p + n, dtype=torch.int32, device=k_new.device)
        return cache
    pos_b = _row_pos(pos, b, k_new.device)
    idx = pos_b % t if ring else pos_b.clamp(0, t - 1)
    rows = torch.arange(b, device=k_new.device)
    cache["k"][rows, idx] = k_new[:, 0].to(dtype)
    cache["v"][rows, idx] = v_new[:, 0].to(dtype)
    cache["slot_pos"][rows, idx] = pos_b.to(torch.int32)
    return cache


def prefill_ring(cache: dict, k_all: torch.Tensor, v_all: torch.Tensor
                 ) -> dict:
    """Fill one layer's ring cache of ``w`` slots with the last ``w``
    positions of a prefill's (B, S, Hkv, hd) keys and values, in place:
    position p lands in slot p % w and ``slot_pos`` records it."""
    s = k_all.shape[1]
    w = cache["k"].shape[1]
    start = max(0, s - w)
    n = min(s, w)
    positions = torch.arange(start, start + n, dtype=torch.int32,
                             device=k_all.device)
    slots = (positions % w).to(torch.int64)
    cache["k"][:, slots] = k_all[:, start:start + n].to(cache["k"].dtype)
    cache["v"][:, slots] = v_all[:, start:start + n].to(cache["v"].dtype)
    cache["slot_pos"][:, slots] = positions
    return cache


def cache_layer_view(caches: dict, layer_idx: int) -> dict:
    """One layer's (B, T, H, hd) slice of a stacked cache (a view)."""
    return {name: caches[name][layer_idx] for name in ("k", "v", "slot_pos")}


def cache_insert_stacked(caches: dict, layer_idx: int, k_new: torch.Tensor,
                         v_new: torch.Tensor, pos, ring: bool = False) -> dict:
    """Single-token insert into a STACKED (L, B, T, H, hd) cache at
    (layer_idx, b, pos_b), in place (``ring`` as in :func:`cache_insert`)."""
    cache_insert(cache_layer_view(caches, layer_idx), k_new, v_new, pos,
                 ring=ring)
    return caches


def cache_insert_multi(cache: dict, k_new: torch.Tensor,
                       v_new: torch.Tensor, pos) -> dict:
    """Teacher-forced insert of (B, n, Hkv, hd) at per-row positions
    pos[b]..pos[b]+n-1, in place (the speculative verify; non-ring caches
    only, so a slot's index is its position and a rewind is a ``pos``
    retreat).  Slots are clipped to the cache and ``slot_pos`` records the
    unclipped positions, as JAX's one scatter does; the port writes token
    by token, so where clipping sends several tokens to the last slot the
    last token's entry holds it on every device (a single scatter's order
    among duplicate indices is unspecified on CUDA)."""
    pos_b = _row_pos(pos, k_new.shape[0], k_new.device)
    for j in range(k_new.shape[1]):
        cache_insert(cache, k_new[:, j:j + 1], v_new[:, j:j + 1], pos_b + j)
    return cache


def cache_insert_stacked_multi(caches: dict, layer_idx: int,
                               k_new: torch.Tensor, v_new: torch.Tensor,
                               pos) -> dict:
    """:func:`cache_insert_multi` into layer ``layer_idx`` of a STACKED
    (L, B, T, H, hd) cache, in place."""
    cache_insert_multi(cache_layer_view(caches, layer_idx), k_new, v_new,
                       pos)
    return caches
