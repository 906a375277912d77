"""Core 1-bit delta math (port of ``repro.core.delta``): sign extraction,
bit packing, per-axis scales.

    What = v (.) B + W_b,   B = sign(W_f - W_b) in {-1,+1}^(dout x din)

Conventions match the JAX package exactly, so packed planes are
byte-identical between the two:

* weights are (d_out, d_in); a linear layer computes ``y = x @ W.T``;
* ``row`` mode scales output rows (v is (d_out,)), ``col`` mode input
  columns (v is (d_in,)), ``scalar`` mode one value per matrix;
* signs map {-1 -> 0, +1 -> 1} and pack little-endian along d_in: bit j
  of byte i is column 8i+j, planes are uint8 (..., d_in // 8).
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

AxisMode = Literal["row", "col", "scalar"]

PACK = 8  # bits per uint8 plane


def _shifts(device) -> torch.Tensor:
    return torch.arange(PACK, dtype=torch.uint8, device=device)


def sign_mask(delta: torch.Tensor) -> torch.Tensor:
    """sign(delta) in {-1, +1} as int8; zeros map to +1."""
    one = torch.ones((), dtype=torch.int8, device=delta.device)
    return torch.where(delta >= 0, one, -one)


def pack_signs(signs: torch.Tensor) -> torch.Tensor:
    """Pack a {-1,+1} (..., d_in) tensor into (..., d_in//8) uint8."""
    if signs.shape[-1] % PACK != 0:
        raise ValueError(f"last dim {signs.shape[-1]} not a multiple of {PACK}")
    bits = (signs > 0).to(torch.uint8)
    bits = bits.reshape(*signs.shape[:-1], signs.shape[-1] // PACK, PACK)
    return (bits << _shifts(signs.device)).sum(dim=-1).to(torch.uint8)


def unpack_signs(packed: torch.Tensor, d_in: int,
                 dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_signs`: (..., d_in//8) uint8 -> (..., d_in) ±1."""
    if packed.shape[-1] * PACK != d_in:
        raise ValueError(
            f"packed last dim {packed.shape[-1]} * {PACK} != d_in {d_in}")
    bits = (packed[..., None] >> _shifts(packed.device)) & 1
    bits = bits.reshape(*packed.shape[:-1], d_in)
    return bits.to(dtype) * 2 - 1


def init_scale(delta: torch.Tensor, mode: AxisMode) -> torch.Tensor:
    """v0 = mean(|ΔW|, axis); leading (stacked) dims are preserved."""
    a = delta.abs()
    if mode == "row":
        return a.mean(dim=-1)
    if mode == "col":
        return a.mean(dim=-2)
    if mode == "scalar":
        return a.mean(dim=(-2, -1))
    raise ValueError(mode)


def broadcast_scale(v: torch.Tensor, mode: AxisMode) -> torch.Tensor:
    """Reshape v so it broadcasts against a (..., d_out, d_in) sign matrix."""
    if mode == "row":
        return v[..., :, None]
    if mode == "col":
        return v[..., None, :]
    if mode == "scalar":
        return v[..., None, None] if v.dim() else v
    raise ValueError(mode)


def compress(w_base: torch.Tensor, w_ft: torch.Tensor, mode: AxisMode
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress a fine-tuned weight to (packed_mask, v0 in fp16)."""
    delta = (w_ft - w_base).to(torch.float32)
    packed = pack_signs(sign_mask(delta))
    v0 = init_scale(delta, mode).to(torch.float16)
    return packed, v0


def reconstruct(packed: torch.Tensor, v: torch.Tensor, w_base: torch.Tensor,
                mode: AxisMode, dtype=None) -> torch.Tensor:
    """Ŵ = v ⊙ unpack(B) + W_b in fp32, cast to ``dtype`` (default: the
    base's).  The plain path; ``kernels/unpack_apply`` is the CUDA one."""
    dtype = dtype or w_base.dtype
    signs = unpack_signs(packed, w_base.shape[-1], dtype=torch.float32)
    vb = broadcast_scale(v.to(torch.float32), mode)
    return (vb * signs + w_base.to(torch.float32)).to(dtype)


def delta_matmul(x: torch.Tensor, packed: torch.Tensor, v: torch.Tensor,
                 w_base: torch.Tensor, mode: AxisMode) -> torch.Tensor:
    """y = x @ Ŵᵀ without forming Ŵ, in x.dtype (the plain reference of the
    fused GEMM; ``core/bitdelta.DeltaLinear`` apply mode "ref")::

        row:    y = x @ W_bᵀ + (x @ Sᵀ) * v
        col:    y = x @ W_bᵀ + (x * v) @ Sᵀ
        scalar: y = x @ W_bᵀ + v * (x @ Sᵀ)
    """
    signs = unpack_signs(packed, w_base.shape[-1], dtype=x.dtype)
    base = x @ w_base.T.to(x.dtype)
    if mode == "row":
        return base + (x @ signs.T) * v.to(x.dtype)
    if mode == "col":
        return base + (x * v.to(x.dtype)) @ signs.T
    if mode == "scalar":
        return base + v.to(x.dtype) * (x @ signs.T)
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# incremental update patches (version-to-version wire format)
#
# A patch ships the change between two versions in the WIRE domain, the
# bytes a full publish stores: packed sign planes, fp16 vectors and extras
# (as bit patterns), bool selectors.
#   1. XOR the old and new wire buffers (zero where nothing changed);
#   2. suppress the zero runs: maximal nonzero stretches become (start,
#      length, literal bytes) segments, short zero gaps merged into one.
# Exact at the bit level: a patched version is bit-identical to a full
# publish of it.  Pure numpy, byte-identical to the JAX package's encoding.
# ---------------------------------------------------------------------------

def xor_bytes(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Flat uint8 XOR of two wire buffers (same shape + dtype)."""
    old = np.ascontiguousarray(old)
    new = np.ascontiguousarray(new)
    if old.shape != new.shape or old.dtype != new.dtype:
        raise ValueError(
            f"wire buffers must match, got {old.dtype}{old.shape} vs "
            f"{new.dtype}{new.shape}; incremental patches require an "
            "unchanged module structure (publish full)")
    return old.view(np.uint8).ravel() ^ new.view(np.uint8).ravel()


def zrle_encode(flat: np.ndarray, *, merge_gap: int = 16
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zero-run suppression of a flat uint8 XOR stream ->
    (starts int64, lengths int32, literals uint8).  Nonzero stretches
    separated by at most ``merge_gap`` zero bytes merge into one segment."""
    flat = np.ascontiguousarray(flat, dtype=np.uint8).ravel()
    nz = np.flatnonzero(flat)
    if nz.size == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.uint8))
    brk = np.flatnonzero(np.diff(nz) > merge_gap)
    starts = nz[np.concatenate([[0], brk + 1])]
    ends = nz[np.concatenate([brk, [nz.size - 1]])] + 1
    lits = np.concatenate([flat[s:e] for s, e in zip(starts, ends)])
    return (starts.astype(np.int64), (ends - starts).astype(np.int32), lits)


def zrle_decode(starts: np.ndarray, lens: np.ndarray, lits: np.ndarray,
                size: int) -> np.ndarray:
    """Inverse of :func:`zrle_encode` -> dense flat uint8 of ``size``."""
    out = np.zeros(size, np.uint8)
    off = 0
    for s, n in zip(np.asarray(starts, np.int64), np.asarray(lens)):
        if s + n > size:
            raise ValueError(
                f"XOR segment [{s}, {s + n}) exceeds buffer size {size}")
        out[s:s + n] = lits[off:off + n]
        off += int(n)
    if off != len(lits):
        raise ValueError("XOR literal stream length mismatch")
    return out


def artifact_bytes(d_out: int, d_in: int, mode: AxisMode) -> int:
    """Bytes to store one compressed matrix: packed mask + fp16 vector."""
    mask = d_out * d_in // PACK
    if mode == "row":
        vec = 2 * d_out
    elif mode == "col":
        vec = 2 * d_in
    else:
        vec = 2
    return mask + vec


def fp16_bytes(d_out: int, d_in: int) -> int:
    return 2 * d_out * d_in


def compression_ratio(d_out: int, d_in: int, mode: AxisMode) -> float:
    return fp16_bytes(d_out, d_in) / artifact_bytes(d_out, d_in, mode)
