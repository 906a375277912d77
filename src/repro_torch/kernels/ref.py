"""Plain PyTorch versions of the delta kernels (port of
``repro.kernels.ref``).

Each CUDA kernel in this package must match its plain version here to
within dtype tolerance.  The wrappers in ``kernels/ops.py`` take these for
tensors that lie on the CPU; on the card ``chip_smoke.py`` holds each kernel
against them.  All arithmetic is fp32 (bf16 operands are upcast first, the
counterpart of ``preferred_element_type=float32``).
"""
from __future__ import annotations

import torch

from repro_torch.core import delta as D
from repro_torch.models.attention import attention_ref


def _deq(w_base: torch.Tensor, w_scale=None) -> torch.Tensor:
    """fp32 base; with a per-output-channel ``w_scale`` (d_out,) the int8
    payload is dequantized (broadcast over the contracted dim)."""
    wb = w_base.to(torch.float32)
    if w_scale is not None:
        wb = wb * w_scale.to(torch.float32)[..., None]
    return wb


def unpack_apply_ref(packed: torch.Tensor, v: torch.Tensor,
                     w_base: torch.Tensor, mode: str, dtype=torch.float32,
                     w_scale=None) -> torch.Tensor:
    """Ŵ = v ⊙ unpack(B) + W_b — dense reconstruction.  Leading (stacked)
    dims broadcast: packed (..., d_out, d_in/8), v (..., d_out) | (..., d_in)
    | (...), w_base (..., d_out, d_in)."""
    return D.reconstruct(packed, v, _deq(w_base, w_scale), mode, dtype=dtype)


def bitlinear_ref(x: torch.Tensor, packed: torch.Tensor, v: torch.Tensor,
                  w_base: torch.Tensor, mode: str,
                  w_scale=None) -> torch.Tensor:
    """Static-mode fused GEMM y = x @ (v ⊙ unpack(B) + W_b)ᵀ, computed the
    dense way (reconstruct, then one product) in fp32.  x (M, K) ·
    v (N,) | (K,) | () by ``mode`` -> (M, N) in x.dtype."""
    w_hat = D.reconstruct(packed, v, _deq(w_base, w_scale), mode,
                          dtype=torch.float32)
    return (x.to(torch.float32) @ w_hat.T).to(x.dtype)


def bitlinear_axes_ref(x: torch.Tensor, packed: torch.Tensor,
                       v_row: torch.Tensor, v_col: torch.Tensor,
                       w_base: torch.Tensor, w_scale=None) -> torch.Tensor:
    """Dual-axis fused GEMM: v[n,k] = v_row[n] + v_col[k] (the overlay zeroes
    the unselected vector, so the sum IS the selected scale).
    x (M, K) -> (M, N) in x.dtype."""
    d_out, d_in = w_base.shape
    signs = D.unpack_signs(packed, d_in, torch.float32)
    v = (v_row.to(torch.float32)[:, None] + v_col.to(torch.float32)[None, :])
    w_hat = v * signs + _deq(w_base, w_scale)
    return (x.to(torch.float32) @ w_hat.T).to(x.dtype)


def bitlinear_axes_stacked_ref(x: torch.Tensor, packed: torch.Tensor,
                               v_row: torch.Tensor, v_col: torch.Tensor,
                               w_base: torch.Tensor,
                               w_scale=None) -> torch.Tensor:
    """``bitlinear_axes_ref`` over a leading expert axis E: expert e's
    rows of x against expert e's Ŵ.  x (E, M, K) · packed (E, N, K/8) ·
    v_row (E, N) · v_col (E, K) · w_base (E, N, K) · w_scale (E, N) or
    None -> (E, M, N) in x.dtype."""
    return torch.stack([
        bitlinear_axes_ref(x[e], packed[e], v_row[e], v_col[e], w_base[e],
                           w_scale=None if w_scale is None else w_scale[e])
        for e in range(x.shape[0])])


def bitlinear_axes_banked_ref(x: torch.Tensor, variant_idx: torch.Tensor,
                              packed: torch.Tensor, v_row: torch.Tensor,
                              v_col: torch.Tensor, w_base: torch.Tensor,
                              w_scale=None) -> torch.Tensor:
    """Banked version: overlay operands carry a leading bank axis V and row
    m of x computes against bank slot ``variant_idx[m]`` (slot 0 = base:
    its vectors are zero, so Ŵ[0] = W_b exactly).

    x (M, K) · variant_idx (M,) int · packed (V, N, K/8) · v_row (V, N) ·
    v_col (V, K) · w_base (N, K) -> (M, N) in x.dtype.

    The JAX oracle gathers a (M, N, K) Ŵ per row; here each slot's Ŵ is
    built once and its product selected into the rows that name it, which
    computes the same values without M copies of the weight (at the
    serving shapes that would be gigabytes)."""
    d_out, d_in = w_base.shape
    xf = x.to(torch.float32)
    wb = _deq(w_base, w_scale)
    vidx = variant_idx.reshape(-1, 1)
    y = torch.zeros((x.shape[0], d_out), dtype=torch.float32,
                    device=x.device)
    for s in range(packed.shape[0]):
        signs = D.unpack_signs(packed[s], d_in, torch.float32)
        v = (v_row[s].to(torch.float32)[:, None]
             + v_col[s].to(torch.float32)[None, :])
        y = torch.where(vidx == s, xf @ (v * signs + wb).T, y)
    return y.to(x.dtype)


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, group: int,
                            causal: bool = True, q_offset: int = 0,
                            kv_offset: int = 0) -> torch.Tensor:
    """Attention in the flattened-head layout of the flash kernel: q (BH, S,
    hd), k/v (BH/group, T, hd), query head b reading KV head b // group;
    (BH, S, hd) in q.dtype.  The heads become one batch row of the dense
    ``attention_ref``, whose grouping maps head b to KV head b // group."""
    assert q.shape[0] == k.shape[0] * group
    out = attention_ref(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                        v.transpose(0, 1)[None], causal=causal,
                        q_offset=q_offset, kv_offset=kv_offset)
    return out[0].transpose(0, 1)
