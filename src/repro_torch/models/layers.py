"""Common building blocks (port of ``repro.models.layers``): the shared
linear, norms, RoPE, sinusoidal positions, embeddings, the gated MLP and
whisper's non-gated MLP.

Cast order follows the JAX package in the reduced-precision data path
(e.g. rmsnorm multiplies in x.dtype after computing fp32 statistics), so
the two packages round at the same places.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core.quantize import is_quant
from repro_torch.models.param import Param, dense_init, ones_init

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# shared linear: every projection routes through here so a delta overlay
# entry swaps the dense GEMM for the fused on-the-fly delta GEMM
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor, ov=None, vidx=None,
           waxes=None) -> torch.Tensor:
    """y = x @ Ŵᵀ where Ŵ = w without an overlay entry, else the variant
    weight v ⊙ unpack(B) + w applied on the fly (never densified).

    With ``vidx`` (per-batch-row variant indices, 0 = base) the overlay
    entry is BANKED — leaves carry a leading bank axis and every row fuses
    its own variant's delta in one mixed-variant GEMM.

    ``w`` may be a ``core/quantize.QuantWeight`` (int8 base, one fp16 scale
    per output channel).  Without an overlay the product factors exactly,
    x @ Ŵᵀ = (x @ qᵀ) ⊙ scale, as the JAX package computes it outside any
    kernel; overlay paths hand the QuantWeight to the kernels, which
    dequantize in the tile pass.

    ``waxes`` — the weight's logical axes as declared at init — places
    the product on a mesh (``distributed/sharding.py``): the delta GEMMs
    route per rank through ``kernels/dispatch``, and the plain product of
    a weight whose in dim is sharded is summed over those axes in fp32,
    since each rank holds a partial contraction (an int8 base's scale
    applies after the sum).  Under grad (training) the plain product of a
    weight whose out dim is sharded takes ``x`` through
    ``sharding.enter``, and the row-parallel sum's backward is the
    identity (``sharding.psum``)."""
    if ov is None:
        i_part = _contracted_axes(w, waxes)
        if i_part is not None:
            # a partial contraction over the rank's K-tile: kept in fp32
            # until the ranks' sum, as one card's product accumulates in
            # fp32 and rounds once; an int8 base's per-row scale (whole on
            # every rank of the in dim) multiplies the sum, the factoring
            # of one card's product
            from repro_torch.distributed import sharding as S
            wq = w.q if is_quant(w) else w
            y = x.to(torch.float32) @ wq.T.to(x.dtype).to(torch.float32)
            y = S.psum(y, i_part).to(x.dtype)
            return y * w.scale.to(x.dtype) if is_quant(w) else y
        if torch.is_grad_enabled():
            # column-parallel: x, whole on every rank of the out dim's
            # axes, enters the rank's block of the product
            from repro_torch.distributed import sharding as S
            x = S.enter(x, weight_parts(w, waxes)[0])
        if is_quant(w):
            return (x @ w.q.T.to(x.dtype)) * w.scale.to(x.dtype)
        return x @ w.T.to(x.dtype)
    from repro_torch.kernels import ops as K
    if vidx is None:
        return K.bitlinear_axes(x, ov.packed, ov.v_row, ov.v_col, w,
                                waxes=waxes)
    return K.bitlinear_axes_banked(x, vidx, ov.packed, ov.v_row, ov.v_col, w,
                                   waxes=waxes)


def _contracted_axes(w, waxes):
    """The mesh axes that shard the weight's in dim under the active mesh
    (each rank then holds a partial contraction), or None."""
    return weight_parts(w, waxes)[1]


def weight_parts(w, waxes) -> tuple:
    """(out part, in part): the mesh axes that split the weight's out and
    in dims under the active mesh (its placement), (None, None) off a
    mesh."""
    from repro_torch.distributed import sharding as S
    lay = S.active_layout()
    if waxes is None or lay is None:
        return None, None
    wq = w.q if is_quant(w) else w
    return lay.lookup(tuple(waxes[-2:]), tuple(wq.shape[-2:]))[1]


def gather_out(y: torch.Tensor, w, waxes) -> torch.Tensor:
    """A product's output made whole over the mesh axes that split its
    weight's out dim (``y`` itself when they split nothing)."""
    from repro_torch.distributed import sharding as S
    o_part = weight_parts(w, waxes)[0]
    return y if o_part is None else S.all_gather(y, o_part, y.dim() - 1)


def rank_block(t: torch.Tensor, part, dim: int = -1) -> torch.Tensor:
    """This rank's block of dim ``dim`` of a tensor every rank holds whole
    — a replicated per-head or per-channel vector, its banked ``psel``
    form (B, ..., n), or an activation made whole — split over the mesh
    axes ``part`` of the active mesh (``t`` itself for None).  Under grad
    ``t`` enters the rank's computation through ``sharding.enter``."""
    from repro_torch.distributed import sharding as S
    if part is None:
        return t
    t = S.enter(t, part)
    mesh = S.active_mesh()
    n = mesh.names_size(part)
    if t.shape[dim] % n:
        raise ValueError(f"dim {t.shape[dim]} does not split over {part}")
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.index(part) * size, size)


def head_block(h: int, part) -> tuple:
    """(first head, count) of the heads a rank runs when a per-head dim of
    ``h`` heads is split over the mesh axes ``part``: its own; every head
    for None, and when the rank's block would cut a head (``h`` does not
    divide), so that the caller gathers the dim whole."""
    from repro_torch.distributed import sharding as S
    if part is None:
        return 0, h
    mesh = S.active_mesh()
    n = mesh.names_size(part)
    if h % n:
        return 0, h
    return mesh.index(part) * (h // n), h // n


def narrow_heads(t: torch.Tensor, heads: tuple, part,
                 dim: int = -1) -> torch.Tensor:
    """Heads ``heads`` ((first, count) of :func:`head_block`) of a
    per-head tensor that every rank of the mesh axes ``part`` holds whole
    (gates after a psum, a replicated per-head vector).  When they are the
    rank's own, ``t`` enters first (``sharding.enter``): each rank's
    gradient covers its heads only, and the ranks' are summed.  When the
    rank runs every head it is ``t`` itself, whose gradient every rank
    already holds whole."""
    h0, hl = heads
    if hl == t.shape[dim]:
        return t
    from repro_torch.distributed import sharding as S
    return S.enter(t, part).narrow(dim, h0, hl)


def dim_part(n: int, axis: str):
    """The mesh axes that the active rules split a dim of ``n`` with
    logical axis ``axis`` over (None off a mesh or when it stays whole):
    the resolution that placed the weights, for the state a model sizes
    before it sees one."""
    from repro_torch.distributed import sharding as S
    mesh, rules = S.active_mesh(), S.active_rules()
    if mesh is None or rules is None:
        return None
    return S.resolve_spec((n,), (axis,), rules, mesh)[0]


def local_size(n: int, part) -> int:
    """The rank's share of a dim of ``n`` split over ``part``."""
    from repro_torch.distributed import sharding as S
    return n if part is None else n // S.active_mesh().names_size(part)


def vocab_shard(table: torch.Tensor):
    """(first global row, mesh axes) of the rank's block of a vocab-sharded
    (vocab, d) table under the active mesh; (0, None) when the table is
    whole."""
    from repro_torch.distributed import sharding as S
    v_part = weight_parts(table, ("vocab", "embed"))[0]
    if v_part is None:
        return 0, None
    return S.active_mesh().index(v_part) * table.shape[-2], v_part


def psel(w: torch.Tensor, bank=None, vidx=None, *,
         lead: int = 1) -> torch.Tensor:
    """Per-row parameter select for BANKED extras (norm scales: fine-tuned
    leaves that are not delta targets).

    ``bank`` is (V, *w.shape) with slot 0 holding the base value; returns
    ``w`` untouched when unbanked, else ``bank[vidx]`` with ``lead``
    singleton axes inserted after the batch dim so the result broadcasts
    against (B, S, ...) activations."""
    if bank is None or vidx is None:
        return w
    sel = bank.index_select(0, vidx.to(torch.int64))
    return sel.reshape(sel.shape[0], *([1] * lead), *sel.shape[1:])


def _oget(ov, key):
    from repro_torch.models.delta_overlay import oget
    return oget(ov, key)


def maybe_remat(fn, cfg, collect_io: bool = False):
    """``fn`` rematerialised in the backward (the JAX package's
    ``jax.checkpoint(body, nothing_saveable)`` around each scanned layer
    body) when ``cfg.remat`` is set, grad is enabled and no calibration IO
    is collected; else ``fn`` itself, so inference runs unchanged.  ``fn``
    must be free of side effects: the backward runs it again, inside the
    mesh context of its forward (``sharding.captured_ctx``), so every rank
    recomputes the same layout and its collectives in the same order."""
    if not (cfg.remat and torch.is_grad_enabled() and not collect_io):
        return fn
    from repro_torch.distributed import sharding as S
    ctx = S.captured_ctx()

    def body(*args, **kwargs):
        with ctx():
            return fn(*args, **kwargs)
    return functools.partial(torch.utils.checkpoint.checkpoint, body,
                             use_reentrant=False)


# ---------------------------------------------------------------------------
# RMSNorm (fp32 statistics, x.dtype data path) — both ways
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device) -> Param:
    return ones_init((d,), (None,), device)


class _RMSNorm(torch.autograd.Function):
    """The JAX package's ``custom_vjp`` (``_rms_bwd``): every (..., D)
    tensor of the backward stays in x.dtype, only the rowwise statistics
    are fp32 (autograd through the fp32 variance branch would hand an fp32
    cotangent to the residual stream)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        xf = x.to(torch.float32)
        inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, inv)      # inv: fp32 1/rms (..., 1)
        return x * inv.to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        return _rms_grads(ctx, dy, dy.shape[-1]) + (None,)


def _rms_grads(ctx, dy, n: int, sum_rows=None) -> tuple:
    """(dx, dscale) of ``y = x · inv · scale`` normalised over ``n``
    features; ``sum_rows`` sums the rowwise fp32 term over the ranks that
    hold the other features (:class:`_RMSNormPart`)."""
    x, scale, inv = ctx.saved_tensors
    sc = scale.to(x.dtype)
    # t = Σ_D dy·scale·x (fp32 rowwise scalar)
    t = ((dy * sc).to(torch.float32) * x.to(torch.float32)).sum(
        dim=-1, keepdim=True)
    if sum_rows is not None:
        t = sum_rows(t)
    coef = (inv ** 3 * (t / n)).to(x.dtype)
    dx = dy * sc * inv.to(x.dtype) - x * coef
    # scale broadcasts as a suffix of x.shape (per-head (H, hd) norms
    # too): reduce the leading broadcast dims
    lead = tuple(range(x.dim() - scale.dim()))
    dscale = ((dy * x).to(torch.float32) * inv).sum(dim=lead)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class _RMSNormPart(torch.autograd.Function):
    """:class:`_RMSNorm` over a feature dim that a mesh group splits: ``x``
    and ``scale`` are the rank's blocks of ``n`` features in all.  The fp32
    sum of squares is summed over ``group`` before the rsqrt, and in the
    backward so is the rowwise term ``t = Σ_D dy·scale·x`` before the
    coefficient is formed (each rank's ``dx`` reads every rank's
    features); ``dscale`` stays the rank's block."""

    @staticmethod
    def forward(ctx, x, scale, eps, n, group, mesh):
        from repro_torch.distributed import sharding as S
        xf = x.to(torch.float32)
        ss = (xf * xf).sum(dim=-1, keepdim=True)
        if group is not None:
            ss = S._all_reduce(ss, group, mesh)
        inv = torch.rsqrt(ss / n + eps)
        ctx.save_for_backward(x, scale, inv)
        ctx.args = (n, group, mesh)
        return x * inv.to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.distributed import sharding as S
        n, group, mesh = ctx.args
        sum_rows = None if group is None else (
            lambda t: S._all_reduce(t, group, mesh))
        return _rms_grads(ctx, dy, n, sum_rows) + (None,) * 4


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6, part=None) -> torch.Tensor:
    """RMSNorm with fp32 statistics and an x.dtype data path; its backward
    is the hand-written one of :class:`_RMSNorm`.

    ``part`` (mesh axes) normalises over a feature dim that those axes
    split: ``x`` and ``scale`` are the rank's blocks, and the fp32 sum of
    squares is summed over the ranks before the rsqrt, so every rank
    divides by the whole dim's mean square, as one device does (zamba's
    ``gate_norm`` over the whole ``d_inner``); the backward sums its
    rowwise term likewise (:class:`_RMSNormPart`)."""
    if part is None:
        return _RMSNorm.apply(x, scale, eps)
    from repro_torch.distributed import sharding as S
    mesh = S.active_mesh()
    return _RMSNormPart.apply(x, scale, eps,
                              x.shape[-1] * mesh.names_size(part),
                              mesh.group(part), mesh)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    exps = -torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # broadcast heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings (S, d), fp32, built as
    the JAX package builds them."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    log_base = torch.full((), math.log(10000.0), dtype=torch.float32,
                          device=device)
    div = torch.exp(-log_base * torch.arange(0, d, 2, dtype=torch.float32,
                                             device=device) / d)
    ang = pos * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


@functools.lru_cache(maxsize=8)
def sinusoid_table(seq_len: int, d: int, device: torch.device
                   ) -> torch.Tensor:
    """:func:`sinusoidal_positions` built once per (length, width,
    device), read-only: the decode step gathers its positions from it every
    step (the JAX package's ``jit`` folds the table into a constant)."""
    return sinusoidal_positions(seq_len, d, device)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d: int) -> Param:
    return dense_init(gen, (vocab, d), ("vocab", "embed"), scale=1.0)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype: str,
                 bank=None, vidx=None) -> torch.Tensor:
    """Token embedding; with a banked extras table (V, vocab, d) and per-row
    variant indices, each batch row looks up its own variant's table.

    On a mesh whose "model" axis shards the vocab, each rank looks up the
    ids in its own range, writes zeros for the others and the ranks sum:
    exact, since one rank contributes each row."""
    src = table if bank is None or vidx is None else bank
    lo, part = vocab_shard(src)
    ids = tokens
    if part is not None:
        n = src.shape[-2]
        mine = (tokens >= lo) & (tokens < lo + n)
        ids = torch.where(mine, tokens - lo, torch.zeros_like(tokens))
    if bank is None or vidx is None:
        x = table[ids]
    else:
        idx = vidx.to(torch.int64).reshape(vidx.shape[0],
                                           *([1] * (tokens.dim() - 1)))
        x = bank[idx, ids]
    if part is not None:
        from repro_torch.distributed import sharding as S
        x = S.psum(torch.where(mine[..., None], x, torch.zeros_like(x)), part)
    return x.to(dtype_of(dtype))


def unembed_logits(x: torch.Tensor, table: torch.Tensor, bank=None,
                   vidx=None) -> torch.Tensor:
    """logits = x @ tableᵀ; with a banked table each row contracts against
    its own variant's (fine-tuned, fp16-rounded) unembedding.

    The banked path is a masked select over the V bank slots: the table is
    read at most V times per step — never gathered per ROW, which would
    cost B copies of (vocab, d) and make the traffic depend on the batch
    mix — and each row's logits come from the same product the per-variant
    path runs, so greedy tokens match it exactly.

    On a mesh that shards the vocab each rank computes its block of the
    logits and the blocks are all-gathered over the vocab's axes, so the
    row is whole on every rank and greedy argmax ties break to the lowest
    global index, as on one device.  Under grad ``x`` enters the rank's
    block of the product through ``sharding.enter``."""
    from repro_torch.distributed import sharding as S
    if bank is None or vidx is None:
        x = S.enter(x, vocab_shard(table)[1])
        logits = x @ table.T.to(x.dtype)
        src = table
    else:
        logits = x @ bank[0].T.to(x.dtype)                 # slot 0 = base
        sel = vidx.reshape(-1, *([1] * (x.dim() - 1)))
        for v in range(1, bank.shape[0]):
            logits = torch.where(sel == v, x @ bank[v].T.to(x.dtype), logits)
        src = bank
    _, part = vocab_shard(src)
    if part is not None:
        logits = S.all_gather(logits, part, logits.dim() - 1)
    return logits


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int) -> dict:
    return {
        "w_gate": dense_init(gen, (d_ff, d), ("ffn", "embed")),
        "w_up": dense_init(gen, (d_ff, d), ("ffn", "embed")),
        "w_down": dense_init(gen, (d, d_ff), ("embed", "ffn")),
    }


def mlp_apply(p: dict, x: torch.Tensor, ov=None, vidx=None,
              ffn_ax: str = "ffn") -> torch.Tensor:
    """``ffn_ax`` names the hidden dim's logical axis — "ffn" for the gated
    MLP, "ffn_small" for MoE shared experts (replicated) — so a mesh sees
    the axes the weights were placed with."""
    h = (F.silu(linear(x, p["w_gate"], _oget(ov, "w_gate"), vidx,
                       waxes=(ffn_ax, "embed")))
         * linear(x, p["w_up"], _oget(ov, "w_up"), vidx,
                  waxes=(ffn_ax, "embed")))
    return linear(h, p["w_down"], _oget(ov, "w_down"), vidx,
                  waxes=("embed", ffn_ax))


# ---------------------------------------------------------------------------
# Non-gated MLP (whisper)
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp2_init(gen: torch.Generator, d: int, d_ff: int) -> dict:
    return {
        "w_in": dense_init(gen, (d_ff, d), ("ffn", "embed")),
        "w_out": dense_init(gen, (d, d_ff), ("embed", "ffn")),
    }


def mlp2_apply(p: dict, x: torch.Tensor, ov=None, vidx=None) -> torch.Tensor:
    return linear(gelu(linear(x, p["w_in"], _oget(ov, "w_in"), vidx,
                              waxes=("ffn", "embed"))),
                  p["w_out"], _oget(ov, "w_out"), vidx,
                  waxes=("embed", "ffn"))
