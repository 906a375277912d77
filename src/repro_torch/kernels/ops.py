"""Public wrappers for the kernels (port of ``repro.kernels.ops``).

Each wrapper dispatches on where its tensors lie: CUDA tensors launch the
hand-written kernel (or the wrapper raises — there is no fallback), CPU
tensors take the plain PyTorch version of ``kernels/ref.py``.  Mode
handling (the per-axis ``v`` reshape), the flattening of leading batch
dims and the split of an int8 base into payload and scale
(``_unwrap_quant``) live here, shared by both routes.

``plain_versions()`` is for comparisons only: inside it the wrappers run
the plain version on any device, so a run can be held against the same
run through the kernels.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.core.quantize import is_quant
from repro_torch.kernels import bitlinear as _bl
from repro_torch.kernels import flash_attn as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import unpack_apply as _ua

_force_plain = False


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch versions even on CUDA tensors (comparisons
    only; never on the serving path)."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def _use_kernel(*tensors) -> bool:
    """Whether the operands (None entries ignored: an absent scale) take
    the kernel; they must lie on one device."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return not _force_plain
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {dev}")


def _unwrap_quant(w):
    """Split a base-weight operand into (payload, scale or None).  An int8
    base arrives as a ``core/quantize.QuantWeight``; a full-precision base
    passes through with no scale.  Every wrapper routes its weight operand here, so both base
    dtypes share one code path."""
    if is_quant(w):
        return w.q, w.scale
    return w, None


def _v2d(v: torch.Tensor, mode: str, lead: tuple, d_out: int,
         d_in: int) -> torch.Tensor:
    """Per-axis scale reshaped to broadcast against (*lead, d_out, d_in):
    row (*lead, d_out, 1) · col (*lead, 1, d_in) · scalar (*lead, 1, 1)."""
    if mode == "row":
        want, shape = lead + (d_out,), lead + (d_out, 1)
    elif mode == "col":
        want, shape = lead + (d_in,), lead + (1, d_in)
    elif mode == "scalar":
        want, shape = lead, lead + (1, 1)
    else:
        raise ValueError(mode)
    if tuple(v.shape) != want:
        raise ValueError(f"{mode} scale has shape {tuple(v.shape)}, "
                         f"expected {want}")
    return v.reshape(shape)


def _routed(name: str, waxes, *args):
    """Under an active mesh context, the per-rank (or gathered) entry
    point of ``kernels/dispatch``; None when there is no mesh, no
    ``waxes`` or a plan that shards nothing (the local operands are then
    the global ones, and the wrapper's own path serves them)."""
    if waxes is None:
        return None
    from repro_torch.kernels import dispatch as D
    st = D.layout()
    if st is None:
        return None
    return getattr(D, name)(st, *args, waxes)


def _unpack_apply_local(packed: torch.Tensor, v: torch.Tensor, w_base,
                        mode: str, out_dtype) -> torch.Tensor:
    wq, ws = _unwrap_quant(w_base)
    out_dtype = out_dtype or (ws.dtype if ws is not None else wq.dtype)
    *lead, d_out, d_in = wq.shape
    v2d = _v2d(v, mode, tuple(lead), d_out, d_in)
    if _use_kernel(packed, v, wq, ws):
        return _ua.unpack_apply_p(packed, v2d, wq, out_dtype, w_scale=ws)
    return _ref.unpack_apply_ref(packed, v, wq, mode, dtype=out_dtype,
                                 w_scale=ws)


def unpack_apply(packed: torch.Tensor, v: torch.Tensor, w_base,
                 mode: str = "row", out_dtype=None,
                 waxes=None) -> torch.Tensor:
    """Ŵ = v ⊙ unpack(B) + W_b (the loader's dense reconstruction).

    ``w_base`` may carry leading stacked dims (layers); ``packed`` and ``v``
    carry the same ones.  One kernel launch covers the whole stack.
    ``w_base`` may be a QuantWeight (int8 base): the kernel dequantizes in
    the same pass and the default output dtype is the scale's (fp16).
    ``waxes`` (the weight's logical axes) routes a rank's tile through
    ``kernels/dispatch`` under a mesh."""
    y = _routed("unpack_apply", waxes, packed, v, w_base, mode, out_dtype)
    if y is not None:
        return y
    return _unpack_apply_local(packed, v, w_base, mode, out_dtype)


def bitlinear(x: torch.Tensor, packed: torch.Tensor, v: torch.Tensor,
              w_base, mode: str = "row") -> torch.Tensor:
    """Static-mode fused y = x @ (v ⊙ unpack(B) + W_b)ᵀ with one per-axis
    vector v ((N,) row, (K,) col or () scalar, by ``mode``).  x may carry
    leading batch dims (flattened into M); ``w_base`` may be a QuantWeight;
    fp32 accumulation, result in x.dtype."""
    wq, ws = _unwrap_quant(w_base)
    *lead, k_dim = x.shape
    n = wq.shape[0]
    x2 = x.reshape(-1, k_dim)
    v2d = _v2d(v, mode, (), n, k_dim)
    if _use_kernel(x, packed, v, wq, ws):
        y = _bl.bitlinear_p(x2.contiguous(), packed, v2d, wq,
                            w_scale=ws).to(x.dtype)
    else:
        y = _ref.bitlinear_ref(x2, packed, v, wq, mode, w_scale=ws)
    return y.reshape(*lead, n)


def _bitlinear_axes_f32(x2: torch.Tensor, packed: torch.Tensor,
                        v_row: torch.Tensor, v_col: torch.Tensor,
                        w_base) -> torch.Tensor:
    """The fused product of 2-D rows x2 (M, K) in fp32, before any cast:
    the kernel's own output, or the plain version over the fp32 rows
    (its first step upcasts them, so the arithmetic is the same)."""
    wq, ws = _unwrap_quant(w_base)
    if _use_kernel(x2, packed, v_row, v_col, wq, ws):
        return _bl.bitlinear_axes_p(x2.contiguous(), packed, v_row, v_col,
                                    wq, w_scale=ws)
    return _ref.bitlinear_axes_ref(x2.to(torch.float32), packed, v_row,
                                   v_col, wq, w_scale=ws)


def bitlinear_axes(x: torch.Tensor, packed: torch.Tensor,
                   v_row: torch.Tensor, v_col: torch.Tensor,
                   w_base, waxes=None) -> torch.Tensor:
    """Fused y = x @ ((v_row ⊕ v_col) ⊙ unpack(B) + W_b)ᵀ.

    v[n,k] = v_row[n] + v_col[k]; the overlay zeroes the unselected axis, so
    one kernel covers row-, col- and scalar-scaled deltas.  x may carry
    leading batch dims (flattened into M); ``w_base`` may be a QuantWeight;
    fp32 accumulation, result in x.dtype.  ``waxes`` (the weight's
    logical axes) routes through ``kernels/dispatch`` under a mesh."""
    y = _routed("bitlinear_axes", waxes, x, packed, v_row, v_col, w_base)
    if y is not None:
        return y
    wq, _ = _unwrap_quant(w_base)
    *lead, k_dim = x.shape
    y = _bitlinear_axes_f32(x.reshape(-1, k_dim), packed, v_row, v_col,
                            w_base)
    return y.to(x.dtype).reshape(*lead, wq.shape[0])


def _bitlinear_axes_stacked_f32(x: torch.Tensor, packed: torch.Tensor,
                                v_row: torch.Tensor, v_col: torch.Tensor,
                                w_base) -> torch.Tensor:
    wq, ws = _unwrap_quant(w_base)
    if _use_kernel(x, packed, v_row, v_col, wq, ws):
        return _bl.bitlinear_axes_stacked_p(
            x.contiguous(), packed, v_row, v_col, wq, w_scale=ws)
    return _ref.bitlinear_axes_stacked_ref(x.to(torch.float32), packed,
                                           v_row, v_col, wq, w_scale=ws)


def bitlinear_axes_stacked(x: torch.Tensor, packed: torch.Tensor,
                           v_row: torch.Tensor, v_col: torch.Tensor,
                           w_base, waxes=None) -> torch.Tensor:
    """``bitlinear_axes`` over a leading expert axis, in one launch:
    x (E, M, K) · packed (E, N, K/8) · v_row (E, N) · v_col (E, K) ·
    w_base (E, N, K) or a QuantWeight with scale (E, N) -> (E, M, N) in
    x.dtype, expert e's rows against expert e's Ŵ (the JAX package vmaps
    its kernel over the experts).  ``waxes`` as in ``bitlinear_axes``."""
    y = _routed("bitlinear_axes_stacked", waxes, x, packed, v_row, v_col,
                w_base)
    if y is not None:
        return y
    return _bitlinear_axes_stacked_f32(x, packed, v_row, v_col,
                                       w_base).to(x.dtype)


def flatten_vidx(variant_idx: torch.Tensor, lead: tuple) -> torch.Tensor:
    """Per-row variant indices -> flattened batch rows (m,) int32.

    ``variant_idx`` has shape ``lead`` (one slot per row) or ``(lead[0],)``
    (broadcast over the remaining lead dims: one variant per batch lane)."""
    m = math.prod(lead)
    if tuple(variant_idx.shape) == tuple(lead):
        return variant_idx.to(torch.int32).reshape(m)
    return variant_idx.reshape(variant_idx.shape[0],
                               *([1] * (len(lead) - 1))).expand(
        tuple(lead)).to(torch.int32).reshape(m)


def _bitlinear_axes_banked_f32(x2: torch.Tensor, vidx: torch.Tensor,
                               packed: torch.Tensor, v_row: torch.Tensor,
                               v_col: torch.Tensor, w_base) -> torch.Tensor:
    wq, ws = _unwrap_quant(w_base)
    if _use_kernel(x2, vidx, packed, v_row, v_col, wq, ws):
        return _bl.bitlinear_axes_banked_p(x2.contiguous(),
                                           vidx.contiguous(), packed, v_row,
                                           v_col, wq, w_scale=ws)
    return _ref.bitlinear_axes_banked_ref(x2.to(torch.float32), vidx,
                                          packed, v_row, v_col, wq,
                                          w_scale=ws)


def bitlinear_axes_banked(x: torch.Tensor, variant_idx: torch.Tensor,
                          packed: torch.Tensor, v_row: torch.Tensor,
                          v_col: torch.Tensor, w_base,
                          waxes=None) -> torch.Tensor:
    """Mixed-variant fused y: row m of x computes against bank slot
    ``variant_idx[m]`` of a stacked overlay (slot 0 = base, zero delta).

    packed (V, N, K/8) · v_row (V, N) · v_col (V, K) stack the per-variant
    overlay leaves along a leading bank axis; ``variant_idx`` is integer
    with shape x.shape[:-1] or (x.shape[0],).  x may carry leading batch
    dims; ``w_base`` may be a QuantWeight (one dequant serves every slot);
    fp32 accumulation, result in x.dtype.  ``waxes`` as in
    ``bitlinear_axes``."""
    y = _routed("bitlinear_axes_banked", waxes, x, variant_idx, packed,
                v_row, v_col, w_base)
    if y is not None:
        return y
    wq, _ = _unwrap_quant(w_base)
    *lead, k_dim = x.shape
    vidx = flatten_vidx(variant_idx, tuple(lead))
    y = _bitlinear_axes_banked_f32(x.reshape(-1, k_dim), vidx, packed,
                                   v_row, v_col, w_base)
    return y.to(x.dtype).reshape(*lead, wq.shape[0])


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0,
                        kv_offset: int = 0) -> torch.Tensor:
    """Forward flash attention: q (B, S, Hq, hd) · k, v (B, T, Hkv, hd) ->
    (B, S, Hq, hd) in q.dtype, query head h reading KV head h // (Hq/Hkv),
    the causal mask by absolute position.  Heads are flattened into the
    kernel's (B·H, S, hd) layout and back, as the JAX wrapper does."""
    b, s, hq, hd = q.shape
    _, t, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} KV "
                         "heads")
    if not _use_kernel(q, k, v):
        return _ref.attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                  kv_offset=kv_offset)
    qf = q.transpose(1, 2).reshape(b * hq, s, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * hkv, t, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * hkv, t, hd).contiguous()
    o = _fa.flash_attention_fwd_p(qf, kf, vf, group=hq // hkv, causal=causal,
                                  q_offset=q_offset, kv_offset=kv_offset)
    return o.reshape(b, hq, s, hd).transpose(1, 2)
