"""Variant loader (port of ``repro.core.loader``): put a packed delta onto
a resident base model, in either residency mode.

* ``apply_artifact`` — swap-then-dense: materialise a full Ŵ copy per
  variant through the ``unpack_apply`` kernel (one launch per target stack
  and axis mode; the stacked layer dim is a grid axis of the kernel).
* ``device_put_overlay`` — on-the-fly: move the packed delta to the base's
  device as a ``models/delta_overlay`` tree; forward fuses it into each GEMM
  and no dense Ŵ is ever built.

Both take a full-precision base or an int8 one (``core/quantize``
QuantWeight leaves) and return byte accounting next to their result.

``apply_update`` materialises the next version of a variant from its parent
and a decoded update patch (``core/store``), bit-exactly in the wire domain;
``load_full_checkpoint`` reads the fp16 checkpoint the paper compares load
time against.  ``stage_overlay_transfer`` is the staging half of async
admission (``serving/admission``): host-to-device copies of a variant on
a side stream, through pinned buffers, fenced by one event per module.

On a mesh (``distributed/sharding.py``) ``param_shardings`` is the base's
spec tree and ``mesh`` the rank's place on it: ``place_delta_model`` cuts
a whole variant to the rank's blocks of every leaf (each packed plane to
its weight's block, its K-tile's bytes contiguous), ``device_put_overlay``
and ``apply_artifact`` serve those blocks against the rank's base blocks
(the dense rebuild runs ``unpack_apply`` per tile), and ``apply_update``
applies each XOR patch to the rank's block of its module.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import store as S
from repro_torch.core.calibration import (DeltaModel, flatten_params,
                                          unflatten_like)
from repro_torch.core.quantize import dequantize, is_quant
from repro_torch.device import synchronize
from repro_torch.distributed import sharding as SH
from repro_torch.models.delta_overlay import flatten_axes
from repro_torch.tree import tree_leaves


# ---------------------------------------------------------------------------
# mesh placement of a variant
# ---------------------------------------------------------------------------

def _place_entry(e, wspec: tuple, w_ndim: int, mesh):
    """One DeltaEntry cut to the rank's block of its weight."""
    from repro_torch.models.delta_overlay import entry_shardings_from_weight
    sp = entry_shardings_from_weight(wspec, w_ndim)
    k_part = sp.packed[-1]
    if k_part is not None and e.packed.shape[-1] % mesh.names_size(k_part):
        raise ValueError(
            f"a K-tile of {e.packed.shape[-1] * 8 // mesh.names_size(k_part)}"
            " columns is not a multiple of 8: its packed bytes cannot be cut "
            "per rank")
    lead = sp.packed[:-2]
    return type(e)(
        packed=SH.block(e.packed, sp.packed, mesh),
        v_row=SH.block(e.v_row, lead if e.scalar else sp.v_row, mesh),
        v_col=SH.block(e.v_col, lead if e.scalar else sp.v_col, mesh),
        use_row=SH.block(e.use_row, lead, mesh), scalar=e.scalar)


def place_delta_model(dm: DeltaModel, param_shardings, mesh) -> DeltaModel:
    """The rank's blocks of a whole variant (a placed one passes through):
    every delta entry cut like the weight it shadows, every extra like the
    base leaf it replaces.  ``param_shardings`` is the base's spec tree."""
    if dm.placed is not None:
        if dm.placed != mesh:
            raise ValueError(f"variant placed on {dm.placed}, not {mesh}")
        return dm
    specs = flatten_axes(param_shardings)
    deltas = {p: _place_entry(e, specs[p], e.packed.dim(), mesh)
              for p, e in dm.deltas.items()}
    extras = {p: SH.block(v, specs[p], mesh) for p, v in dm.extras.items()}
    return DeltaModel(deltas=deltas, extras=extras, placed=mesh)


def _placed(dm: DeltaModel, param_shardings, mesh) -> DeltaModel:
    if param_shardings is None:
        return dm
    return place_delta_model(dm, param_shardings, mesh or SH.active_mesh())


def _reconstruct_entry(entry, w_base, use_kernel: bool, waxes=None):
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
                             w_base, mode="row", out_dtype=torch.float32,
                             waxes=waxes)
        w_c = K.unpack_apply(entry.packed, entry.v_col.to(torch.float32),
                             w_base, mode="col", out_dtype=torch.float32,
                             waxes=waxes)
        return torch.where(entry.use_row[..., None, None], w_r,
                           w_c).to(odt)
    if quant:
        w_base = dequantize(w_base, w_base.scale.dtype)
    return entry.reconstruct(w_base)


def apply_artifact(base_params, dm: DeltaModel, *, use_kernel: bool = True,
                   param_shardings=None, param_axes=None, mesh=None):
    """Materialise fine-tuned params on the base's device.  On a mesh
    (``param_shardings``, the base's spec tree; ``base_params`` the rank's
    blocks) the variant is cut to the rank's blocks first and each
    ``unpack_apply`` rebuilds the rank's tile (``param_axes`` names each
    weight's logical axes for the dispatch).  Returns (params, stats)."""
    t0 = time.perf_counter()
    dm = _placed(dm, param_shardings, mesh)
    axes = flatten_axes(param_axes)
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
            out[path] = _reconstruct_entry(e, wb, use_kernel,
                                           waxes=axes.get(path))
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
                       vec_dtype=torch.float16, extras_dtype=torch.float16,
                       param_shardings=None, mesh=None):
    """On-the-fly serving entry point: the variant as a packed overlay tree
    on the base's device — no dense reconstruction.  Extras (norms,
    embeddings) are swapped into a params VIEW that shares every unchanged
    base tensor.  On a mesh (``param_shardings``, the base's spec tree)
    every leaf is the rank's block: the mask, both vectors and the extras.
    Returns (params_view, overlay, stats)."""
    from repro_torch.models.delta_overlay import from_delta_entry, insert_entry

    t0 = time.perf_counter()
    dm = _placed(dm, param_shardings, mesh)
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


# ---------------------------------------------------------------------------
# staged transfers (async admission)
# ---------------------------------------------------------------------------

STAGE_CHUNK_BYTES = 16 << 20    # pinned buffer size of a staged copy


@dataclasses.dataclass
class Transfer:
    """One module's staged copy: its path, its tensors on the device and
    the event recorded on the staging stream after its last copy (None on
    the CPU, where the copies are done when they return)."""
    path: str
    tensors: list
    event: object = None

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def _stage(t: torch.Tensor, device, pool, chunk_bytes: int) -> torch.Tensor:
    """Host tensor ``t`` copied to ``device`` through ``pool`` buffers of
    ``chunk_bytes``, each copy ``non_blocking`` on the current stream (a
    tensor already on a card is used as it is).  Each buffer goes back to
    the pool with the event of the copy that reads it."""
    if t.device.type != "cpu":
        return t
    src = t.detach().contiguous().reshape(-1).view(torch.uint8)
    dst = torch.empty(t.shape, dtype=t.dtype, device=device)
    out = dst.reshape(-1).view(torch.uint8)
    for a in range(0, src.numel(), chunk_bytes):
        n = min(chunk_bytes, src.numel() - a)
        buf = pool.take((chunk_bytes,), torch.uint8)
        buf[:n].copy_(src[a:a + n])
        out[a:a + n].copy_(buf[:n], non_blocking=True)
        pool.give(buf, event=_record(device), live=(dst,))
    return dst


def _record(device):
    """An event recorded on ``device``'s current stream (None on the
    CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def stage_overlay_transfer(dm: DeltaModel, *, device, stream=None,
                           pool=None,
                           chunk_bytes: int = STAGE_CHUNK_BYTES
                           ) -> tuple[DeltaModel, list]:
    """Begin the host-to-device copies of a variant without a fence: every
    leaf (per module packed, v_row, v_col, use_row, then each extra) is
    copied through a ``pool`` buffer (``core/store.StagingPool``, pinned on
    a card, made here when None) with ``non_blocking=True`` on ``stream``
    (default: the current stream), and one event per module is recorded
    after its last copy.  The copies overlap whatever the serving stream
    runs meanwhile; the caller's thread waits only when the pool's buffers
    are all in flight.

    Returns ``(dm_on_device, futures)``: ``futures`` lists one
    :class:`Transfer` per module in JAX's order (deltas, then extras).  A
    consumer on another stream must wait on a module's event before it
    reads that module (``OverlayBank.admit_async`` does) and mark the
    tensors used on its stream (``record_stream``) before it drops them;
    ``wait_transfers`` waits on the host."""
    device = torch.device(device)
    if pool is None:
        pool = S.StagingPool(pin_memory=device.type == "cuda")
    on_stream = (torch.cuda.stream(stream)
                 if device.type == "cuda" and stream is not None
                 else contextlib.nullcontext())
    deltas, extras, futures = {}, {}, []
    with on_stream:
        for path, e in dm.deltas.items():
            leaves = [_stage(t, device, pool, chunk_bytes)
                      for t in (e.packed, e.v_row, e.v_col, e.use_row)]
            deltas[path] = type(e)(packed=leaves[0], v_row=leaves[1],
                                   v_col=leaves[2], use_row=leaves[3],
                                   scalar=e.scalar)
            futures.append(Transfer(path, leaves, _record(device)))
        for path, v in dm.extras.items():
            arr = _stage(v, device, pool, chunk_bytes)
            extras[path] = arr
            futures.append(Transfer(path, [arr], _record(device)))
    return DeltaModel(deltas=deltas, extras=extras), futures


def wait_transfers(futures: list) -> None:
    """Fence a ``stage_overlay_transfer`` future list (all modules)."""
    for f in futures:
        f.wait()


def fused_resident_bytes(base_params, params_view, overlay) -> int:
    """Device bytes a fused-resident variant adds on top of the resident
    base: overlay buffers + extras that are not the base's own tensors."""
    from repro_torch.models.delta_overlay import overlay_nbytes
    base_ids = {id(t) for t in tree_leaves(base_params)}
    extra = sum(t.numel() * t.element_size()
                for t in tree_leaves(params_view) if id(t) not in base_ids)
    return overlay_nbytes(overlay) + extra


# ---------------------------------------------------------------------------
# incremental version updates (store patch artifacts)
# ---------------------------------------------------------------------------

def _xor16(v: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
    """XOR a (possibly fp32-held) fp16 wire buffer with 16-bit XOR bits —
    exact at the bit level, so a patched vector is bit-identical to the new
    version's full publish."""
    bits = v.to(torch.float16).view(torch.int16)
    out = (bits ^ xr.reshape(v.shape)).view(torch.float16)
    return out.to(v.dtype)


def _patch_entry(packed, v_row, v_col, use_row, pk_xor, vr_xor, vc_xor,
                 ur_xor):
    """One module's update: XOR the packed sign plane, the fp16 axis
    vectors and the axis-selector flags with their decoded XOR buffers."""
    return (packed ^ pk_xor.reshape(packed.shape),
            _xor16(v_row, vr_xor),
            _xor16(v_col, vc_xor),
            use_row ^ ur_xor.reshape(use_row.shape))


def _patch_extra(arr: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
    return _xor16(arr, xr).to(torch.float16)


def _wire(buf: np.ndarray, like: torch.Tensor, spec=None,
          mesh=None) -> torch.Tensor:
    """Decoded XOR buffer -> tensor on ``like``'s device, in ``like``'s
    shape; 16-bit patterns travel as int16 (the same bits).  With a
    ``spec`` the buffer is a whole module's and ``like`` the rank's block
    of it: the buffer is cut to that block first."""
    buf = np.ascontiguousarray(buf)
    if buf.dtype == np.uint16:
        buf = buf.view(np.int16)
    t = torch.from_numpy(buf.copy())
    if spec is not None:
        t = SH.block(t.reshape(SH.global_shape(like.shape, spec, mesh)),
                     spec, mesh)
    return t.reshape(like.shape).to(like.device)


def apply_update(dm: DeltaModel, delta_patches: dict,
                 extras_patches: dict, *, param_shardings=None,
                 mesh=None) -> DeltaModel:
    """The next version of a variant from its parent plus a decoded update
    patch.  ``delta_patches``: path -> dict(packed, v_row, v_col, use_row)
    dense XOR buffers (uint8 for the packed planes, uint16 for the fp16
    vectors' bit patterns, bool for the selector); ``extras_patches``: path
    -> uint16 XOR buffer.  Untouched modules are shared with the parent (no
    copy).  The patched leaves land on the parent leaves' devices.  With
    ``param_shardings`` (the base's spec tree) ``dm`` holds the rank's
    blocks (``place_delta_model``) and each XOR buffer — a whole module's —
    is cut to the rank's block before it applies."""
    from repro_torch.models.delta_overlay import entry_shardings_from_weight
    specs = flatten_axes(param_shardings)
    mesh = (mesh or SH.active_mesh()) if param_shardings is not None \
        else None
    if mesh is not None and dm.placed is None:
        raise ValueError("apply_update with param_shardings patches a "
                         "placed parent (loader.place_delta_model)")
    deltas = dict(dm.deltas)
    extras = dict(dm.extras)
    for path, p in delta_patches.items():
        e = deltas[path]
        sp = (entry_shardings_from_weight(specs[path], e.packed.dim())
              if mesh is not None else None)
        lead = sp.packed[:-2] if sp is not None else None
        vr, vc = ((lead, lead) if e.scalar else (sp.v_row, sp.v_col)) \
            if sp is not None else (None, None)
        packed, v_row, v_col, use_row = _patch_entry(
            e.packed, e.v_row, e.v_col, e.use_row,
            _wire(p["packed"], e.packed, sp and sp.packed, mesh),
            _wire(p["v_row"], e.v_row, vr, mesh),
            _wire(p["v_col"], e.v_col, vc, mesh),
            _wire(p["use_row"], e.use_row, lead, mesh))
        deltas[path] = type(e)(packed=packed, v_row=v_row, v_col=v_col,
                               use_row=use_row, scalar=e.scalar)
    for path, xr in extras_patches.items():
        like = extras[path]
        extras[path] = _patch_extra(like, _wire(
            xr, like, specs[path] if mesh is not None else None, mesh))
    return DeltaModel(deltas=deltas, extras=extras, placed=dm.placed)


def load_full_checkpoint(npz_path, template_params):
    """Baseline loader: read a full fp16 checkpoint (``store.
    save_checkpoint_fp16``) into the template's structure, dtypes and
    devices (the paper's full-checkpoint load comparison)."""
    t0 = time.perf_counter()
    data = np.load(npz_path)
    flat = {}
    device = None
    for path, leaf in flatten_params(template_params).items():
        device = leaf.device
        arr = torch.from_numpy(data[path.replace(".", "__")])
        flat[path] = arr.to(device=device, dtype=leaf.dtype)
    params = unflatten_like(template_params, flat)
    if device is not None:
        synchronize(device)
    return params, {"seconds": time.perf_counter() - t0,
                    "transferred_bytes": int(sum(
                        2 * t.numel() for t in tree_leaves(params)))}
