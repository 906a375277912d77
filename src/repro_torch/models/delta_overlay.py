"""Delta overlay: packed per-module deltas that ride alongside the base
params (port of the single-variant part of ``repro.models.delta_overlay``).

A variant kept "fused" lives on the device as a tree of
:class:`OverlayEntry` — packed sign mask + per-axis fp16 vectors — that
mirrors the params tree.  Every matmul whose module has an entry runs the
fused delta GEMM (``kernels/ops.bitlinear_axes``), so the dense Ŵ is never
written to device memory.

Canonical form: v_eff[n, k] = v_row[n] + v_col[k] with the UNSELECTED
axis vector zeroed per matrix (scalar entries broadcast their per-matrix
scalar into v_row), so one kernel serves every axis choice and stacked
entries slice per layer like the weights they shadow.

Banked (mixed-variant) overlays wait for the continuous-scheduler slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class OverlayEntry:
    """One target matrix (stack): packed mask + canonical axis vectors."""
    packed: torch.Tensor         # (..., d_out, d_in//8) uint8
    v_row: torch.Tensor          # (..., d_out) — zero where col-selected
    v_col: torch.Tensor          # (..., d_in) — zero where row-selected

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.packed, self.v_row, self.v_col))


def from_delta_entry(entry, vec_dtype=torch.float16) -> OverlayEntry:
    """Canonicalise a calibration ``DeltaEntry`` for on-the-fly execution:
    row-selected matrices keep v_row and zero v_col (and vice versa);
    scalar entries broadcast the per-matrix scalar into v_row.  Vectors
    are stored in ``vec_dtype`` (fp16, the artifact precision)."""
    packed = entry.packed
    d_out = packed.shape[-2]
    lead = tuple(packed.shape[:-2])
    zero = torch.zeros((), dtype=torch.float32, device=packed.device)
    if entry.scalar:
        v_row = entry.v_row.to(torch.float32)[..., None].expand(
            lead + (d_out,))
        v_col = torch.zeros(lead + (packed.shape[-1] * 8,),
                            dtype=torch.float32, device=packed.device)
    else:
        sel = entry.use_row[..., None]
        v_row = torch.where(sel, entry.v_row.to(torch.float32), zero)
        v_col = torch.where(sel, zero, entry.v_col.to(torch.float32))
    return OverlayEntry(packed=packed,
                        v_row=v_row.to(vec_dtype).contiguous(),
                        v_col=v_col.to(vec_dtype).contiguous())


def insert_entry(tree: dict, path: str, entry) -> None:
    """Insert an entry at a dot-path, mirroring the params tree."""
    node = tree
    parts = path.split(".")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = entry


def overlay_from_deltas(deltas: dict, vec_dtype=torch.float16) -> dict:
    """{flat path -> DeltaEntry} -> nested overlay tree mirroring params."""
    tree: dict = {}
    for path, entry in deltas.items():
        insert_entry(tree, path, from_delta_entry(entry, vec_dtype=vec_dtype))
    return tree


def oget(overlay, key: str):
    """Resolve one level of an overlay tree; None/absent/empty -> None."""
    if not overlay:
        return None
    sub = overlay.get(key) if isinstance(overlay, dict) else None
    if isinstance(sub, dict) and not sub:
        return None
    return sub


def overlay_nbytes(overlay) -> int:
    """Device-resident bytes of an overlay tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(overlay))
