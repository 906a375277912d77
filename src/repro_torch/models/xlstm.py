"""xLSTM language model (port of ``repro.models.xlstm``, xlstm-350m):
mLSTM + sLSTM blocks, pattern 7:1.

* mLSTM block: pre-norm → up-projections ×2 (mixer and gate branch) →
  causal conv4 → q/k from the conv path, v from the pre-conv path →
  chunkwise matrix-memory cell → per-head RMS norm → SiLU-gated output →
  down-projection.  O(1) decode state.
* sLSTM block: pre-norm → causal conv4 feeding the i/f gates →
  scalar-memory recurrence with block-diagonal per-head recurrent weights
  → per-head norm → gated 4/3 FFN.  Sequential over time.

Parameters keep the JAX tree: ``mlstm`` leaves stacked (L_m, ...),
``slstm`` leaves (L_s, ...), plus ``embed``, ``final_norm`` and
``unembed``.  Layers run as super-blocks of (``mlstm_ratio`` mLSTM, 1
sLSTM); where the JAX module ``lax.scan``s the super-blocks, the port
loops over layer views.  Every projection goes through ``layers.linear``,
so an overlay entry puts it through the delta kernels; the convs, the
recurrent weights, the gate bias and the norms are extras, selected per
row from a bank with ``psel``.

On a mesh every projection names its weight's logical axes (``waxes``,
the JAX module's): mLSTM's up/gate projections are column-parallel over
``d_inner`` ("ssm"), its conv channel-local, and its cell runs the rank's
heads (:func:`_mlstm_cell_in`: ``xc``/``xm`` gathered whole before the
replicated-in ``wq``/``wk``/``wv``, ``w_if`` summed over the ranks);
sLSTM's gate projections, recurrent weights and cell are replicated, so
every rank runs that cell whole, and its fused gate/up FFN is gathered
before the split (:func:`_slstm_post`).  The state holds the rank's
heads and channels.

The decode state is an explicit tree (``init_state``: fp32, independent
of any length), which ``prefill`` returns and ``decode_step`` advances;
the JAX module's quirks are kept: k is scaled by hd^-½ in the block and q
again inside the cell, v comes from the pre-conv path, sLSTM's step
output is cast to the carry dtype, and ``prefill`` ignores ``max_len``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import ssm
from repro_torch.models.delta_overlay import oget
from repro_torch.models.layers import (dim_part, embed_init, embed_lookup,
                                       gather_out, head_block, linear,
                                       local_size, maybe_remat,
                                       narrow_heads, psel, rank_block,
                                       rmsnorm, rmsnorm_init,
                                       unembed_logits, weight_parts)
from repro_torch.models.param import (dense_init, ones_init, stack_layers,
                                      zeros_init)
from repro_torch.models.transformer import _layer
from repro_torch.tree import tree_map

F32 = torch.float32


def _stack(trees: list):
    """Stack per-layer trees of one structure along a new leading dim."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _weak(x: torch.Tensor, s: float) -> torch.Tensor:
    """x * s with the Python float rounded to x's dtype first, as JAX
    multiplies an array by a weakly typed scalar."""
    return x * torch.full((), s, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,C), w (K,C) depthwise; left-padded causal.  w may also be
    (B,K,C): per-row banked conv weights (mixed-variant batches)."""
    k = w.shape[-2]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    wx = w.to(x.dtype)
    y = 0
    for j in range(k):
        wj = wx[j][None, None, :] if w.dim() == 2 else wx[:, j][:, None, :]
        y = y + xp[:, j:j + s] * wj
    return y


def conv_step(window: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """window (B,K-1,C) past inputs; returns (new window, conv output
    (B,C)).  w (K,C) shared or (B,K,C) per row (banked)."""
    full = torch.cat([window, x_new[:, None, :]], dim=1)     # (B,K,C)
    wf = w.to(x_new.dtype)
    if w.dim() == 2:
        y = torch.einsum("bkc,kc->bc", full, wf)
    else:
        y = torch.einsum("bkc,bkc->bc", full, wf)
    return full[:, 1:], y


def _rowsel(p, key, ov, vidx):
    """An extra used whole (a conv kernel, recurrent weights, an SSD
    vector): ``p[key]``, or each row's bank slot of it (B, ...) when
    banked."""
    return psel(p[key], oget(ov, key), vidx, lead=0)


def _tail(prev: torch.Tensor, new: torch.Tensor, k: int) -> torch.Tensor:
    """The last k-1 inputs of ``prev`` followed by ``new`` (the conv window
    a decode step continues from), in fp32."""
    return torch.cat([prev.to(new.dtype), new], dim=1)[:, -(k - 1):].to(F32)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def mlstm_block_init(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    di = 2 * d
    h = cfg.num_heads
    dev = gen.device
    return {
        "ln": rmsnorm_init(d, dev),
        "w_up": dense_init(gen, (di, d), ("ssm", "embed")),
        "w_gate": dense_init(gen, (di, d), ("ssm", "embed")),
        "conv": dense_init(gen, (cfg.ssm_conv, di), (None, "ssm"),
                           scale=0.3),
        "wq": dense_init(gen, (di, di), ("ssm", None)),
        "wk": dense_init(gen, (di, di), ("ssm", None)),
        "wv": dense_init(gen, (di, di), ("ssm", None)),
        "w_if": dense_init(gen, (2 * h, di), (None, "ssm"), scale=0.02),
        "b_if": zeros_init((2 * h,), (None,), dev),
        "out_norm": ones_init((di,), (None,), dev),
        "w_down": dense_init(gen, (d, di), ("embed", "ssm")),
    }


def _mlstm_heads(cfg):
    di = 2 * cfg.d_model
    return cfg.num_heads, di // cfg.num_heads


def mlstm_block_state(cfg, batch: int, device) -> dict:
    """One mLSTM layer's state; on a mesh the cell holds the rank's heads
    (every head when its block of ``d_inner`` cuts one) and the conv
    window the rank's channels."""
    h, hd = _mlstm_heads(cfg)
    di = 2 * cfg.d_model
    part = dim_part(di, "ssm")
    return {"cell": ssm.mlstm_init_state(batch, head_block(h, part)[1], hd,
                                         device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                                 local_size(di, part)),
                                dtype=F32, device=device)}


def _mlstm_pre(p, x, cfg, ov=None, vidx=None):
    """Projection work shared by the sequence and step paths (pre-conv):
    the rank's channels of ``d_inner`` on a mesh."""
    xi = rmsnorm(x, psel(p["ln"], oget(ov, "ln"), vidx), cfg.norm_eps)
    xm = linear(xi, p["w_up"], oget(ov, "w_up"), vidx,
                waxes=("ssm", "embed"))
    z = linear(xi, p["w_gate"], oget(ov, "w_gate"), vidx,
               waxes=("ssm", "embed"))
    return xm, z


def _mlstm_cell_in(p, xc, xm, x, cfg, lead, ov=None, vidx=None):
    """q, k (scaled by hd^-½), v reshaped to ``lead`` + (H, hd), the
    (i, f) gate pre-activations (..., H) and the (first head, count) they
    hold.  On a mesh ``xc``/``xm`` are the rank's channels: they are
    gathered whole for ``wq``/``wk``/``wv`` (whole in dim, out dim split),
    while ``w_if`` contracts the rank's channels and is summed over the
    ranks; each rank keeps its heads' q, k, v and gates, or every head
    (q, k and v gathered) when its block cuts one."""
    hcount, hd = _mlstm_heads(cfg)
    part = weight_parts(p["wq"], ("ssm", None))[0]
    h0, hl = head_block(hcount, part)
    xc_w = gather_out(xc, p["w_up"], ("ssm", "embed"))
    xm_w = gather_out(xm, p["w_up"], ("ssm", "embed"))

    def proj(key, src):
        y = linear(src, p[key], oget(ov, key), vidx, waxes=("ssm", None))
        if hl == hcount:
            y = gather_out(y, p[key], ("ssm", None))
        return y.reshape(*lead, hl, hd)
    q = proj("wq", xc_w)
    k = _weak(proj("wk", xc_w), hd ** -0.5)
    v = proj("wv", xm_w)
    gates = (linear(xc, p["w_if"], oget(ov, "w_if"), vidx,
                    waxes=(None, "ssm"))
             + psel(p["b_if"], oget(ov, "b_if"), vidx).to(x.dtype))
    ig, fg = (narrow_heads(g, (h0, hl), part)
              for g in gates.chunk(2, dim=-1))
    return q, k, v, ig, fg, (h0, hl)


def _out_norm_scale(p, ov, vidx, b, hcount, hd, heads=None):
    """The per-head output norm's scale (H, hd), or (B, 1, H, hd) per row
    when banked; ``heads`` (first, count) keeps those heads (entering the
    rank's own: ``layers.narrow_heads``)."""
    on = oget(ov, "out_norm")
    if on is None or vidx is None:
        sc = p["out_norm"].reshape(hcount, hd)
    else:
        sc = on.index_select(0, vidx.to(torch.int64)).reshape(b, 1, hcount,
                                                              hd)
    if heads is None:
        return sc
    return narrow_heads(sc, heads, weight_parts(p["wq"], ("ssm", None))[0],
                        dim=-2)


def _mlstm_out(p, h, z, x, cfg, heads, ov=None, vidx=None):
    """x + w_down(norm(h) ⊙ silu(z)) for the cell output h (B,S,H_l,hd):
    per-head norm, then the rank's channels (its block of ``d_inner``,
    sliced when the rank ran every head) as ``w_down``'s K-tile."""
    b, s = x.shape[:2]
    hcount, hd = _mlstm_heads(cfg)
    h = rmsnorm(h, _out_norm_scale(p, ov, vidx, b, hcount, hd, heads),
                cfg.norm_eps).reshape(b, s, -1)
    if heads[1] == hcount:
        h = rank_block(h, weight_parts(p["w_down"], ("embed", "ssm"))[1])
    return x + linear(h * F.silu(z), p["w_down"], oget(ov, "w_down"), vidx,
                      waxes=("embed", "ssm"))


def mlstm_block_apply(p, x, cfg, state: dict, ov=None, vidx=None):
    """Sequence path: x (B,S,D) -> (y, new state)."""
    b, s, d = x.shape
    xm, z = _mlstm_pre(p, x, cfg, ov=ov, vidx=vidx)
    xc = F.silu(causal_conv(xm, _rowsel(p, "conv", ov, vidx)))
    q, k, v, ig, fg, heads = _mlstm_cell_in(p, xc, xm, x, cfg, (b, s),
                                            ov=ov, vidx=vidx)
    h_seq, cell = ssm.mlstm_chunkwise(q, k, v, ig, fg, state=state["cell"])
    return (_mlstm_out(p, h_seq, z, x, cfg, heads, ov=ov, vidx=vidx),
            {"cell": cell, "conv": _tail(state["conv"], xm, cfg.ssm_conv)})


def mlstm_block_step(p, x, cfg, state: dict, ov=None, vidx=None):
    """Decode path: x (B,1,D)."""
    b = x.shape[0]
    xm, z = _mlstm_pre(p, x, cfg, ov=ov, vidx=vidx)
    conv_win, xc1 = conv_step(state["conv"].to(xm.dtype), xm[:, 0],
                              _rowsel(p, "conv", ov, vidx))
    xc = F.silu(xc1)[:, None, :]
    q, k, v, ig, fg, heads = _mlstm_cell_in(p, xc, xm, x, cfg, (b,),
                                            ov=ov, vidx=vidx)
    cell, h_t = ssm.mlstm_step(state["cell"], q, k, v, ig[:, 0], fg[:, 0])
    return (_mlstm_out(p, h_t[:, None], z, x, cfg, heads, ov=ov, vidx=vidx),
            {"cell": cell, "conv": conv_win.to(F32)})


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def slstm_ffn(d: int) -> int:
    """The sLSTM block's FFN width: 4/3·d rounded down to 64 (1344 at
    d=1024)."""
    return max(64, int(4 * d / 3) // 64 * 64)


def slstm_block_init(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    ffn = slstm_ffn(d)
    dev = gen.device
    return {
        "ln": rmsnorm_init(d, dev),
        "conv": dense_init(gen, (cfg.ssm_conv, d), (None, "embed"),
                           scale=0.3),
        "w_zi": dense_init(gen, (2 * d, d), (None, "embed")),  # z,o from x
        "w_if": dense_init(gen, (2 * d, d), (None, "embed")),  # i,f: conv
        "r_z": dense_init(gen, (h, hd, hd), (None, None, None), scale=0.1),
        "r_i": dense_init(gen, (h, hd, hd), (None, None, None), scale=0.1),
        "r_f": dense_init(gen, (h, hd, hd), (None, None, None), scale=0.1),
        "r_o": dense_init(gen, (h, hd, hd), (None, None, None), scale=0.1),
        "out_norm": ones_init((d,), (None,), dev),
        "w_ff1": dense_init(gen, (2 * ffn, d), ("ffn", "embed")),
        "w_ff2": dense_init(gen, (d, ffn), ("embed", "ffn")),
    }


def slstm_block_state(cfg, batch: int, device) -> dict:
    h = cfg.num_heads
    return {"cell": ssm.slstm_init_state(batch, h, cfg.d_model // h, device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_model),
                                dtype=F32, device=device)}


def _slstm_gate_pre(p, xi, xc, cfg, ov=None, vidx=None):
    b, s = xi.shape[:2]
    h = cfg.num_heads
    hd = cfg.d_model // h
    zo = linear(xi, p["w_zi"], oget(ov, "w_zi"), vidx,
                waxes=(None, "embed"))
    if_ = linear(xc, p["w_if"], oget(ov, "w_if"), vidx,
                 waxes=(None, "embed"))
    zx, ox = zo.chunk(2, dim=-1)
    ix, fx = if_.chunk(2, dim=-1)
    return tuple(t.reshape(b, s, h, hd) for t in (zx, ix, fx, ox))


def _slstm_rec(p, ov, vidx):
    """Recurrent weights r_z/r_i/r_f/r_o, per row (B,H,hd,hd) when
    banked."""
    return tuple(_rowsel(p, k, ov, vidx) for k in ("r_z", "r_i", "r_f",
                                                   "r_o"))


def _slstm_post(p, h_seq, x, cfg, ov=None, vidx=None):
    """Per-head norm, then the gated FFN.  ``w_ff1`` is one fused
    (2·ffn, d) gate/up projection, so on a mesh a rank's block of its out
    dim is a contiguous slice of [gate; up], not matching gate and up
    rows: the block is gathered whole, ``silu(gate) * up`` formed whole
    and the rank keeps its K-tile of it for the row-parallel ``w_ff2``."""
    b, s = x.shape[:2]
    hn = rmsnorm(h_seq.reshape(b, s, cfg.d_model),
                 psel(p["out_norm"], oget(ov, "out_norm"), vidx),
                 cfg.norm_eps)
    ff = gather_out(linear(hn, p["w_ff1"], oget(ov, "w_ff1"), vidx,
                           waxes=("ffn", "embed")),
                    p["w_ff1"], ("ffn", "embed"))
    gate, up = ff.chunk(2, dim=-1)
    mid = rank_block(F.silu(gate) * up,
                     weight_parts(p["w_ff2"], ("embed", "ffn"))[1])
    return x + linear(mid, p["w_ff2"], oget(ov, "w_ff2"), vidx,
                      waxes=("embed", "ffn"))


def slstm_block_apply(p, x, cfg, state: dict, ov=None, vidx=None):
    xi = rmsnorm(x, psel(p["ln"], oget(ov, "ln"), vidx), cfg.norm_eps)
    xc = F.silu(causal_conv(xi, _rowsel(p, "conv", ov, vidx)))
    pre = _slstm_gate_pre(p, xi, xc, cfg, ov=ov, vidx=vidx)
    h_seq, cell = ssm.slstm_scan(*pre, *_slstm_rec(p, ov, vidx),
                                 state=state["cell"])
    return (_slstm_post(p, h_seq, x, cfg, ov=ov, vidx=vidx),
            {"cell": cell, "conv": _tail(state["conv"], xi, cfg.ssm_conv)})


def slstm_block_step(p, x, cfg, state: dict, ov=None, vidx=None):
    xi = rmsnorm(x, psel(p["ln"], oget(ov, "ln"), vidx), cfg.norm_eps)
    conv_win, xc1 = conv_step(state["conv"].to(xi.dtype), xi[:, 0],
                              _rowsel(p, "conv", ov, vidx))
    xc = F.silu(xc1)[:, None, :]
    pre = _slstm_gate_pre(p, xi, xc, cfg, ov=ov, vidx=vidx)
    cell, h_t = ssm.slstm_step(state["cell"], *(t[:, 0] for t in pre),
                               *_slstm_rec(p, ov, vidx))
    h_t = h_t.to(x.dtype)   # slstm_step computes fp32; keep carry dtype
    return (_slstm_post(p, h_t[:, None].reshape(x.shape), x, cfg, ov=ov,
                        vidx=vidx),
            {"cell": cell, "conv": conv_win.to(F32)})


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _super_shape(cfg) -> tuple[int, int]:
    """(n_super, mlstm_per_super); layers = n_super * (ratio + 1)."""
    per = cfg.mlstm_ratio + 1
    assert cfg.num_layers % per == 0, (cfg.num_layers, per)
    return cfg.num_layers // per, cfg.mlstm_ratio


def init(gen: torch.Generator, cfg) -> dict:
    """Param tree on ``gen``'s device (float32 leaves, as the JAX init)."""
    n_super, n_m = _super_shape(cfg)
    return {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model),
        "final_norm": rmsnorm_init(cfg.d_model, gen.device),
        "unembed": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                              ("vocab", "embed"), scale=cfg.d_model ** -0.5),
        "mlstm": stack_layers(lambda g: mlstm_block_init(g, cfg), gen,
                              n_super * n_m),
        "slstm": stack_layers(lambda g: slstm_block_init(g, cfg), gen,
                              n_super),
    }


def init_state(cfg, batch: int, device) -> dict:
    """{"pos": (B,) int32, "mlstm"/"slstm": each block's state stacked
    over its layers}, fp32 zeros (sLSTM's normaliser n at one)."""
    n_super, n_m = _super_shape(cfg)

    def rep(tree, n):
        return tree_map(lambda a: a.expand((n,) + a.shape).clone(), tree)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "mlstm": rep(mlstm_block_state(cfg, batch, device), n_super * n_m),
            "slstm": rep(slstm_block_state(cfg, batch, device), n_super)}


def init_cache(cfg, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> dict:
    """The decode state (``init_state``): constant size, so ``max_len``
    and ``dtype`` are ignored, as in the JAX package."""
    return init_state(cfg, batch, device)


def cache_batch_axes(cfg) -> dict:
    """Batch axis of each state leaf (the JAX ``state_pspecs``' act_batch):
    ``pos`` 0, every other leaf 1 (behind the layer dim).  Every leaf is
    row-separable, so the continuous scheduler merges admitted lanes by a
    row select."""
    return {"pos": 0,
            "mlstm": {"cell": {"C": 1, "n": 1, "m": 1}, "conv": 1},
            "slstm": {"cell": {"c": 1, "n": 1, "h": 1, "m": 1}, "conv": 1}}


def _run(params, x, cfg, state, step: bool, overlay=None, vidx=None):
    """Super-blocks for the sequence and decode paths: layer ``i·n_m + j``
    of the mLSTM stack, then sLSTM layer ``i``.  Returns (x, new state).
    On the sequence path each super-block rematerialises under training
    when ``cfg.remat`` (``layers.maybe_remat``), as the JAX scan body."""
    n_super, n_m = _super_shape(cfg)
    m_apply = mlstm_block_step if step else mlstm_block_apply
    s_apply = slstm_block_step if step else slstm_block_apply
    m_ov, s_ov = oget(overlay, "mlstm"), oget(overlay, "slstm")

    def body(i, x):
        m_st = []
        for j in range(n_m):
            li = i * n_m + j
            x, st = m_apply(_layer(params["mlstm"], li), x, cfg,
                            _layer(state["mlstm"], li),
                            ov=_layer(m_ov, li), vidx=vidx)
            m_st.append(st)
        x, s_st = s_apply(_layer(params["slstm"], i), x, cfg,
                          _layer(state["slstm"], i), ov=_layer(s_ov, i),
                          vidx=vidx)
        return x, m_st, s_st

    block = body if step else maybe_remat(body, cfg)
    m_new, s_new = [], []
    for i in range(n_super):
        x, m_st, s_st = block(i, x)
        m_new += m_st
        s_new.append(s_st)
    return x, {"pos": state["pos"] + x.shape[1], "mlstm": _stack(m_new),
               "slstm": _stack(s_new)}


def _logits(params, x, cfg, overlay, vidx):
    x = rmsnorm(x, psel(params["final_norm"], oget(overlay, "final_norm"),
                        vidx), cfg.norm_eps)
    return unembed_logits(x, params["unembed"],
                          bank=oget(overlay, "unembed"), vidx=vidx)


def forward(params, batch, cfg, state: dict | None = None, overlay=None,
            variant_idx=None):
    """batch = {"tokens" (B,S)} -> (logits (B,S,V), aux): aux["state"] is
    the state after the sequence (from ``state`` or zeros), aux["moe_aux"]
    0.  ``overlay`` / ``variant_idx`` as in ``transformer.forward``."""
    vidx = variant_idx
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype,
                     bank=oget(overlay, "embed"), vidx=vidx)
    if state is None:
        state = init_state(cfg, tokens.shape[0], x.device)
    x, new_state = _run(params, x, cfg, state, step=False, overlay=overlay,
                        vidx=vidx)
    logits = _logits(params, x, cfg, overlay, vidx)
    return logits, {"moe_aux": torch.zeros((), dtype=F32, device=x.device),
                    "state": new_state}


def prefill(params, batch, cfg, max_len: int = 0, cache_dtype=None,
            overlay=None, variant_idx=None):
    """(last logits (B,V), state); ``max_len`` and ``cache_dtype`` are
    ignored (the state has no length)."""
    logits, aux = forward(params, batch, cfg, overlay=overlay,
                          variant_idx=variant_idx)
    return logits[:, -1, :], aux["state"]


def decode_step(params, token, state, cfg, overlay=None, variant_idx=None):
    """token (B,) -> (logits (B,V), the state advanced by one: a new
    tree)."""
    vidx = variant_idx
    x = embed_lookup(params["embed"], token[:, None], cfg.compute_dtype,
                     bank=oget(overlay, "embed"), vidx=vidx)
    x, new_state = _run(params, x, cfg, state, step=True, overlay=overlay,
                        vidx=vidx)
    return _logits(params, x, cfg, overlay, vidx)[:, 0, :], new_state
