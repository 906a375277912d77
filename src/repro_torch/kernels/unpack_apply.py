"""CUDA kernel: fused dense reconstruction Ŵ = v ⊙ unpack(B) + W_b
(port of ``repro.kernels.unpack_apply``, both bodies; source
``csrc/unpack_apply.cu``).

The loader's dense-residency hot path, over a full-precision base or an
int8 one (``w_scale``: one fp16 scale per output row, dequantized in the
same pass).  ``unpack_apply_p`` launches the
kernel over a whole (L, d_out, d_in) stack — the stacked dim is a grid
axis, where the JAX loader vmaps a 2-D kernel.  ``plain`` is the plain
PyTorch version of the same function.

``launches`` counts kernel launches (one per ``unpack_apply_p`` call); a
caller resets it to 0 to see which path a run took.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.bitlinear import check_base
from repro_torch.kernels.ref import unpack_apply_ref as plain  # noqa: F401

PACK = 8

launches = 0


OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def unpack_apply_p(packed: torch.Tensor, v2d: torch.Tensor,
                   w_base: torch.Tensor, out_dtype,
                   w_scale=None) -> torch.Tensor:
    """packed (..., d_out, d_in/8) uint8 · v2d (..., d_out, 1) | (..., 1, d_in)
    | (..., 1, 1) · w_base (..., d_out, d_in) fp32|bf16|int8 (int8 with
    w_scale (..., d_out) fp16) -> (..., d_out, d_in) in ``out_dtype``
    (fp32|bf16|fp16).  Every operand on one CUDA device."""
    global launches
    *lead, d_out, d_in = w_base.shape
    n_stack = math.prod(lead)
    dev = w_base.device
    if dev.type != "cuda" or packed.device != dev or v2d.device != dev or (
            w_scale is not None and w_scale.device != dev):
        raise ValueError("unpack_apply_p needs every operand on one CUDA "
                         f"device, got {packed.device}, {v2d.device}, {dev}")
    if d_in % PACK:
        raise ValueError(f"d_in {d_in} is not a multiple of {PACK}")
    if packed.dtype != torch.uint8 or tuple(packed.shape) != (
            *lead, d_out, d_in // PACK):
        raise ValueError(f"packed {packed.dtype}{tuple(packed.shape)} does "
                         f"not match w_base {tuple(w_base.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"unsupported output dtype {out_dtype}")
    vm, vn = v2d.shape[-2:]
    if tuple(v2d.shape[:-2]) != tuple(lead) or vm not in (1, d_out) \
            or vn not in (1, d_in):
        raise ValueError(f"v2d {tuple(v2d.shape)} does not broadcast against "
                         f"{tuple(w_base.shape)}")
    if not (packed.is_contiguous() and w_base.is_contiguous() and (
            w_scale is None or w_scale.is_contiguous())):
        raise ValueError("packed, w_base and w_scale must be contiguous")
    # the stacked scale (..., d_out) is read flat, as (n_stack * d_out,)
    check_base("unpack_apply_p", w_base,
               None if w_scale is None else w_scale.reshape(-1),
               n_stack * d_out)
    if w_scale is not None and tuple(w_scale.shape) != (*lead, d_out):
        raise ValueError(f"w_scale {tuple(w_scale.shape)} does not match "
                         f"w_base {tuple(w_base.shape)}")
    v32 = v2d.to(torch.float32).contiguous()
    # the scale is read as v[l*vs_l + r*vs_r + c*vs_c]; broadcast dims stride 0
    vs_r = vn if vm > 1 else 0
    vs_c = 1 if vn > 1 else 0
    vs_l = vm * vn
    out = torch.empty(w_base.shape, dtype=out_dtype, device=dev)
    rc = B.library().repro_unpack_apply(
        packed.data_ptr(), v32.data_ptr(), vs_l, vs_r, vs_c,
        w_base.data_ptr(), B.DTYPE_CODES[w_base.dtype],
        None if w_scale is None else w_scale.data_ptr(), out.data_ptr(),
        B.DTYPE_CODES[out_dtype], n_stack, d_out, d_in, B.stream_handle(dev))
    B.check(rc, "unpack_apply")
    launches += 1
    return out
