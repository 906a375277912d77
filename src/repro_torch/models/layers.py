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

def linear(x: torch.Tensor, w: torch.Tensor, ov=None,
           vidx=None) -> torch.Tensor:
    """y = x @ Ŵᵀ where Ŵ = w without an overlay entry, else the variant
    weight v ⊙ unpack(B) + w applied on the fly (never densified).

    With ``vidx`` (per-batch-row variant indices, 0 = base) the overlay
    entry is BANKED — leaves carry a leading bank axis and every row fuses
    its own variant's delta in one mixed-variant GEMM.

    ``w`` may be a ``core/quantize.QuantWeight`` (int8 base, one fp16 scale
    per output channel).  Without an overlay the product factors exactly,
    x @ Ŵᵀ = (x @ qᵀ) ⊙ scale, as the JAX package computes it outside any
    kernel; overlay paths hand the QuantWeight to the kernels, which
    dequantize in the tile pass."""
    if ov is None:
        if is_quant(w):
            return (x @ w.q.T.to(x.dtype)) * w.scale.to(x.dtype)
        return x @ w.T.to(x.dtype)
    from repro_torch.kernels import ops as K
    if vidx is None:
        return K.bitlinear_axes(x, ov.packed, ov.v_row, ov.v_col, w)
    return K.bitlinear_axes_banked(x, vidx, ov.packed, ov.v_row, ov.v_col, w)


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
    must be free of side effects: the backward runs it again."""
    if not (cfg.remat and torch.is_grad_enabled() and not collect_io):
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
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
        x, scale, inv = ctx.saved_tensors
        sc = scale.to(x.dtype)
        # t = Σ_D dy·scale·x (fp32 rowwise scalar)
        t = ((dy * sc).to(torch.float32) * x.to(torch.float32)).sum(
            dim=-1, keepdim=True)
        coef = (inv ** 3 * (t / x.shape[-1])).to(x.dtype)
        dx = dy * sc * inv.to(x.dtype) - x * coef
        # scale broadcasts as a suffix of x.shape (per-head (H, hd) norms
        # too): reduce the leading broadcast dims
        lead = tuple(range(x.dim() - scale.dim()))
        dscale = ((dy * x).to(torch.float32) * inv).sum(dim=lead)
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 statistics and an x.dtype data path; its backward
    is the hand-written one of :class:`_RMSNorm`."""
    return _RMSNorm.apply(x, scale, eps)


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
    variant indices, each batch row looks up its own variant's table."""
    if bank is None or vidx is None:
        return table[tokens].to(dtype_of(dtype))
    idx = vidx.to(torch.int64).reshape(vidx.shape[0],
                                       *([1] * (tokens.dim() - 1)))
    return bank[idx, tokens].to(dtype_of(dtype))


def unembed_logits(x: torch.Tensor, table: torch.Tensor, bank=None,
                   vidx=None) -> torch.Tensor:
    """logits = x @ tableᵀ; with a banked table each row contracts against
    its own variant's (fine-tuned, fp16-rounded) unembedding.

    The banked path is a masked select over the V bank slots: the table is
    read at most V times per step — never gathered per ROW, which would
    cost B copies of (vocab, d) and make the traffic depend on the batch
    mix — and each row's logits come from the same product the per-variant
    path runs, so greedy tokens match it exactly."""
    if bank is None or vidx is None:
        return x @ table.T.to(x.dtype)
    logits = x @ bank[0].T.to(x.dtype)                     # slot 0 = base
    sel = vidx.reshape(-1, *([1] * (x.dim() - 1)))
    for v in range(1, bank.shape[0]):
        logits = torch.where(sel == v, x @ bank[v].T.to(x.dtype), logits)
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


def mlp_apply(p: dict, x: torch.Tensor, ov=None, vidx=None) -> torch.Tensor:
    h = (F.silu(linear(x, p["w_gate"], _oget(ov, "w_gate"), vidx))
         * linear(x, p["w_up"], _oget(ov, "w_up"), vidx))
    return linear(h, p["w_down"], _oget(ov, "w_down"), vidx)


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
    return linear(gelu(linear(x, p["w_in"], _oget(ov, "w_in"), vidx)),
                  p["w_out"], _oget(ov, "w_out"), vidx)
