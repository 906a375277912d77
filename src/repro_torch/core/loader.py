"""Variant loader (port of ``repro.core.loader``): put a packed delta onto
a resident base model, in either residency mode.

* ``apply_artifact`` — swap-then-dense: materialise a full Ŵ copy per
  variant through the ``unpack_apply`` kernel (one launch per target stack
  and axis mode; the stacked layer dim is a grid axis of the kernel).
* ``device_put_overlay`` — on-the-fly: move the packed delta to the base's
  device as a ``models/delta_overlay`` tree; forward fuses it into each GEMM
  and no dense Ŵ is ever built.

Both take a full-precision base or an int8 one (``core/quantize``
QuantWeight leaves) and return byte accounting next to their result.  Mesh
placements, async staging and incremental updates are not ported yet.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.calibration import (DeltaModel, flatten_params,
                                          unflatten_like)
from repro_torch.core.quantize import dequantize, is_quant
from repro_torch.device import synchronize
from repro_torch.tree import tree_leaves


def _reconstruct_entry(entry, w_base, use_kernel: bool):
    """Dense Ŵ from one (possibly stacked) entry.  The kernel path mirrors
    the JAX loader: one ``unpack_apply`` in row mode and one in col mode
    over the whole stack, then a per-matrix select by ``use_row``.

    ``w_base`` may be a QuantWeight (int8 base): the kernel dequantizes in
    the same pass and Ŵ lands in the scale's dtype (fp16).  The plain
    branch dequantizes to that dtype first and reconstructs from it, as the
    JAX loader does (one more fp16 rounding, kept for parity)."""
    quant = is_quant(w_base)
    if use_kernel and not entry.scalar:
        from repro_torch.kernels import ops as K
        odt = w_base.scale.dtype if quant else w_base.dtype
        w_r = K.unpack_apply(entry.packed, entry.v_row.to(torch.float32),
                             w_base, mode="row", out_dtype=torch.float32)
        w_c = K.unpack_apply(entry.packed, entry.v_col.to(torch.float32),
                             w_base, mode="col", out_dtype=torch.float32)
        return torch.where(entry.use_row[..., None, None], w_r,
                           w_c).to(odt)
    if quant:
        w_base = dequantize(w_base, w_base.scale.dtype)
    return entry.reconstruct(w_base)


def apply_artifact(base_params, dm: DeltaModel, *, use_kernel: bool = True):
    """Materialise fine-tuned params on the base's device.
    Returns (params, stats)."""
    t0 = time.perf_counter()
    transferred = 0
    out = {}
    device = None
    for path, wb in flatten_params(base_params).items():
        device = wb.device
        if path in dm.deltas:
            e = dm.deltas[path]
            e = type(e)(packed=e.packed.to(device), v_row=e.v_row.to(device),
                        v_col=e.v_col.to(device),
                        use_row=e.use_row.to(device), scalar=e.scalar)
            transferred += e.packed.numel() + 2 * (e.v_row.numel()
                                                   + e.v_col.numel())
            out[path] = _reconstruct_entry(e, wb, use_kernel)
        elif path in dm.extras:
            v = dm.extras[path].to(device=device, dtype=wb.dtype)
            transferred += 2 * v.numel()
            out[path] = v
        else:
            out[path] = wb
    params = unflatten_like(base_params, out)
    if device is not None:
        synchronize(device)
    stats = {"seconds": time.perf_counter() - t0,
             "transferred_bytes": int(transferred)}
    return params, stats


def device_put_overlay(base_params, dm: DeltaModel, *,
                       vec_dtype=torch.float16, extras_dtype=torch.float16):
    """On-the-fly serving entry point: the variant as a packed overlay tree
    on the base's device — no dense reconstruction.  Extras (norms,
    embeddings) are swapped into a params VIEW that shares every unchanged
    base tensor.  Returns (params_view, overlay, stats)."""
    from repro_torch.models.delta_overlay import from_delta_entry, insert_entry

    t0 = time.perf_counter()
    transferred = 0
    overlay_tree: dict = {}
    out = {}
    device = None
    for path, wb in flatten_params(base_params).items():
        device = wb.device
        if path in dm.deltas:
            e = from_delta_entry(dm.deltas[path], vec_dtype=vec_dtype)
            e = type(e)(packed=e.packed.to(device), v_row=e.v_row.to(device),
                        v_col=e.v_col.to(device))
            transferred += e.nbytes()
            insert_entry(overlay_tree, path, e)
            out[path] = wb                      # base weight, shared
        elif path in dm.extras:
            v = dm.extras[path].to(device=device, dtype=extras_dtype)
            transferred += v.numel() * v.element_size()
            out[path] = v
        else:
            out[path] = wb
    params_view = unflatten_like(base_params, out)
    if device is not None:
        synchronize(device)
    stats = {"seconds": time.perf_counter() - t0,
             "transferred_bytes": int(transferred)}
    return params_view, overlay_tree, stats


def fused_resident_bytes(base_params, params_view, overlay) -> int:
    """Device bytes a fused-resident variant adds on top of the resident
    base: overlay buffers + extras that are not the base's own tensors."""
    from repro_torch.models.delta_overlay import overlay_nbytes
    base_ids = {id(t) for t in tree_leaves(base_params)}
    extra = sum(t.numel() * t.element_size()
                for t in tree_leaves(params_view) if id(t) not in base_ids)
    return overlay_nbytes(overlay) + extra
