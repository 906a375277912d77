"""CUDA kernel: forward flash attention with grouped KV heads (port of
``repro.kernels.flash_attn``; source ``csrc/flash_attn.cu``).

``flash_attention_fwd_p`` takes the flattened-head layout of the TPU
kernel — q (BH, S, hd), k/v (BH/group, T, hd), query head b reading KV
head b // group — and returns o (BH, S, hd) in q's dtype.  Scores, softmax
statistics and the accumulator are fp32; the causal mask is by absolute
position (``q_offset``, ``kv_offset``).  Any S and T; hd 64, 128 or 256;
fp32 (CUDA cores) or bf16 (tensor cores, ``wgmma`` fed by TMA; P enters
the second product as two bf16 terms, P_hi + P_lo).  ``plain`` is the
plain PyTorch version of the same function.

``launches`` counts kernel launches (one per call); a caller resets it to
0 to see which path a run took.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.ref import flash_attention_fwd_ref as plain  # noqa: F401

HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
MAX_Q_TILES = 65535          # the kernel's second grid dimension


def block_q(hd: int, dtype: torch.dtype) -> int:
    """Query rows per block: the bf16 (tensor-core) kernel's two
    warpgroups of 64 (csrc/flash_attn.cu ``kWgBQ``), the fp32 kernel's
    ``BQ``."""
    if dtype == torch.bfloat16:
        return 128
    return 32 if hd == 256 else 64


launches = 0


def flash_attention_fwd_p(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, group: int, causal: bool = True,
                          q_offset: int = 0,
                          kv_offset: int = 0) -> torch.Tensor:
    """q (BH, S, hd) · k, v (BH/group, T, hd), one dtype (fp32 or bf16), all
    contiguous on one CUDA device -> o (BH, S, hd) in q.dtype."""
    global launches
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_fwd_p needs q, k and v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"expected q (BH, S, hd) and k, v (BHkv, T, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, hd = q.shape
    bkv, t, _ = k.shape
    if hd not in HEAD_DIMS or k.shape[2] != hd:
        raise ValueError(f"head dim {hd} (k: {k.shape[2]}) is not one of "
                         f"{HEAD_DIMS}")
    if group < 1 or bh != bkv * group:
        raise ValueError(f"{bh} query heads do not form groups of {group} "
                         f"over {bkv} KV heads")
    if s < 1 or t < 1 or -(-s // block_q(hd, q.dtype)) > MAX_Q_TILES:
        raise ValueError(f"S={s}, T={t} out of the kernel's range")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    rc = B.library().repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B.DTYPE_CODES[q.dtype], bh, s, t, hd, group, int(bool(causal)),
        int(q_offset), int(kv_offset), hd ** -0.5, B.stream_handle(dev))
    B.check(rc, "flash_attention_fwd")
    launches += 1
    return out
