"""Delta overlay: packed per-module deltas that ride alongside the base
params (port of ``repro.models.delta_overlay``).

A variant kept "fused" lives on the device as a tree of
:class:`OverlayEntry` — packed sign mask + per-axis fp16 vectors — that
mirrors the params tree.  Every matmul whose module has an entry runs the
fused delta GEMM (``kernels/ops.bitlinear_axes``), so the dense Ŵ is never
written to device memory.

Canonical form: v_eff[n, k] = v_row[n] + v_col[k] with the UNSELECTED
axis vector zeroed per matrix (scalar entries broadcast their per-matrix
scalar into v_row), so one kernel serves every axis choice and stacked
entries slice per layer like the weights they shadow.

A BANKED overlay (mixed-variant batches) stacks every leaf along a bank
axis of ``size`` slots; see the bank helpers below.
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


# ---------------------------------------------------------------------------
# banked overlays (mixed-variant batches)
#
# A BANKED overlay tree mirrors the params tree like a single-variant
# overlay, but every leaf is stacked along a bank axis of ``size`` slots.
# Slot 0 is the base: zero vectors (zero delta) for OverlayEntry leaves,
# the base leaf value for extras leaves.  Model forwards take a per-batch-
# row ``variant_idx`` selecting the slot each row fuses.
#
# Bank-axis placement: leaves under a stacked layer group keep the layer
# dim leading (the forward takes layer i as ``leaf[i]``), so the bank axis
# sits at position 1 there and at position 0 everywhere else.  Layer i of
# a banked entry is then a contiguous (V, d_out, d_in/8) view, the layout
# the banked kernel takes.
#
# JAX arrays are immutable, so the JAX helpers return updated copies; here
# slot writes update the bank in place (``bank_clear_entry``,
# ``bank_set_extra_base``, ``OverlayBank`` admission), which keeps the bank
# at one allocation for its lifetime.
# ---------------------------------------------------------------------------

STACKED_TOP_KEYS = frozenset({"layers", "pre_layers", "enc_layers",
                              "dec_layers", "mlstm", "slstm", "mamba"})


def bank_axis(path: str) -> int:
    """Bank-axis position for a dot-path: after the stacked layer dim if
    the leaf lives under a stacked top-level group, else leading."""
    return 1 if path.split(".")[0] in STACKED_TOP_KEYS else 0


def entry_slot(entry, v: int):
    """One bank slot of a banked OverlayEntry whose bank axis has become
    leading (after layer slicing) — the per-variant entry shape."""
    if entry is None:
        return None
    return OverlayEntry(packed=entry.packed[v], v_row=entry.v_row[v],
                        v_col=entry.v_col[v])


def _with_bank_dim(t: torch.Tensor, axis: int, size: int) -> tuple:
    return tuple(t.shape[:axis]) + (size,) + tuple(t.shape[axis:])


def bank_index(path: str, slot: int) -> tuple:
    """Index of one bank slot of the leaf at ``path`` (along its bank
    axis)."""
    return (slice(None),) * bank_axis(path) + (slot,)


def bank_zeros(path: str, entry: OverlayEntry, size: int,
               device=None) -> OverlayEntry:
    """All-slots-zero banked entry shaped after one variant's entry (slot 0
    = base stays all-zero forever: zero vectors mean Ŵ = W_b exactly), on
    ``device`` (default: the entry's)."""
    ax = bank_axis(path)

    def z(t):
        return torch.zeros(_with_bank_dim(t, ax, size), dtype=t.dtype,
                           device=t.device if device is None else device)
    return OverlayEntry(packed=z(entry.packed), v_row=z(entry.v_row),
                        v_col=z(entry.v_col))


def bank_extra_base(path: str, base_leaf: torch.Tensor,
                    size: int) -> torch.Tensor:
    """Banked extras leaf with every slot holding the base value (so
    unassigned slots serve base semantics); a contiguous copy."""
    ax = bank_axis(path)
    return base_leaf.unsqueeze(ax).expand(
        _with_bank_dim(base_leaf, ax, size)).contiguous()


def bank_clear_entry(path: str, bank: OverlayEntry,
                     slot: int) -> OverlayEntry:
    """Zero one slot of a banked entry, in place."""
    idx = bank_index(path, slot)
    for t in (bank.packed, bank.v_row, bank.v_col):
        t[idx] = 0
    return bank


def bank_set_extra_base(path: str, bank: torch.Tensor, slot: int,
                        base_leaf: torch.Tensor) -> torch.Tensor:
    """Reset one slot of a banked extras leaf to the base value, in
    place."""
    bank[bank_index(path, slot)] = base_leaf.to(bank.dtype)
    return bank


# ---------------------------------------------------------------------------
# logical axes and placements of overlay leaves (mesh serving)
#
# The packed sign plane keeps the weight's logical axes on its unpacked
# dims with the packed byte dim replicated (the JAX derivation, which the
# resolution tests hold leaf for leaf), v_row / v_col follow the single
# weight axis they scale, extras keep the weight's own axes, and the bank
# axis resolves through the "bank" rule: replicated by default (every rank
# holds every slot of its own weight block, so admission writes in place
# with no collective), or sharded over "pod" under pod-local bank rules
# (``rules_for(..., pod_banks=True)``: each pod holds only its own slot
# range, so an admission writes one pod's ranks).  Where the port
# PLACES a packed plane (``entry_shardings_from_weight``) it departs from
# that on purpose: a rank stores its K-tile's bytes, contiguously, since a
# column slice of a torch tensor is a strided view the kernels refuse.
# ---------------------------------------------------------------------------

def _insert_bank(axes: tuple, path: str) -> tuple:
    ax = bank_axis(path)
    return axes[:ax] + ("bank",) + axes[ax:]


def entry_axes(weight_axes: tuple, *, path: str = "",
               bank: bool = False) -> OverlayEntry:
    """Logical axes for one overlay entry, derived from the shadowed
    weight's ``(*lead, out_ax, in_ax)`` axes."""
    *lead, out_ax, in_ax = weight_axes
    packed = tuple(lead) + (out_ax, None)   # packed byte dim: replicated
    v_row = tuple(lead) + (out_ax,)
    v_col = tuple(lead) + (in_ax,)
    if bank:
        packed, v_row, v_col = (_insert_bank(t, path)
                                for t in (packed, v_row, v_col))
    return OverlayEntry(packed=packed, v_row=v_row, v_col=v_col)


def extra_axes(weight_axes: tuple, *, path: str = "",
               bank: bool = False) -> tuple:
    """Extras leaves are fine-tuned copies of base leaves: same axes, plus
    the replicated bank axis when banked."""
    return _insert_bank(tuple(weight_axes), path) if bank \
        else tuple(weight_axes)


def _is_axes(x) -> bool:
    """A leaf of an axes tree: logical names, or a resolved spec whose
    entries may be tuples of mesh axes."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None), tuple)) for e in x)


def flatten_axes(param_axes) -> dict:
    """{dot-path -> tuple} view of a ``param.split`` axes tree or of its
    resolved spec tree; {} for None.  A quantized leaf's QuantWeight of
    specs (``quantize.quant_sharding``) stands for its weight: its
    payload's spec."""
    out: dict = {}
    if param_axes is None:
        return out

    def walk(node, prefix):
        if getattr(node, "__quant_leaf__", False):
            node = node.q
        if _is_axes(node):
            out[prefix] = node
            return
        for k, v in node.items():
            walk(v, f"{prefix}.{k}" if prefix else k)
    walk(param_axes, "")
    return out


def overlay_pspecs(param_axes, delta_paths, extra_paths=(), *,
                   bank: bool = False) -> dict:
    """Logical-axes tree mirroring an overlay (or banked overlay) tree;
    extras ride in the tree only when banked."""
    flat = flatten_axes(param_axes)
    tree: dict = {}
    for path in delta_paths:
        insert_entry(tree, path, entry_axes(flat[path], path=path, bank=bank))
    for path in extra_paths:
        insert_entry(tree, path, extra_axes(flat[path], path=path, bank=bank))
    return tree


def overlay_struct(flat_shapes: dict, delta_paths, extra_paths=(), *,
                   bank_size=None) -> dict:
    """Shape-only twin of an overlay tree (``meta`` tensors), from the
    BASE weights' shapes; with ``bank_size`` the leaves grow the bank axis
    and the extras join."""
    def sds(shape, dtype):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")

    tree: dict = {}
    for path in delta_paths:
        shape = tuple(flat_shapes[path])
        lead, (d_out, d_in) = shape[:-2], shape[-2:]
        parts = [lead + (d_out, d_in // 8), lead + (d_out,), lead + (d_in,)]
        if bank_size is not None:
            ax = bank_axis(path)
            parts = [t[:ax] + (bank_size,) + t[ax:] for t in parts]
        insert_entry(tree, path, OverlayEntry(
            packed=sds(parts[0], torch.uint8),
            v_row=sds(parts[1], torch.float16),
            v_col=sds(parts[2], torch.float16)))
    if bank_size is not None:
        for path in extra_paths:
            shape = tuple(flat_shapes[path])
            ax = bank_axis(path)
            insert_entry(tree, path, sds(shape[:ax] + (bank_size,)
                                         + shape[ax:], torch.float32))
    return tree


def entry_shardings_from_weight(weight_spec: tuple,
                                w_ndim: int) -> OverlayEntry:
    """Overlay-leaf specs by SPEC SURGERY on the shadowed weight's
    resolved spec: packed keeps the weight's spec — its byte dim carries
    the in dim's axes, so a rank holds its K-tile's bytes (the port's
    layout; the JAX package keeps the byte dim replicated); v_row keeps
    (lead..., d_out)'s entries, v_col (lead..., d_in)'s."""
    spec = (tuple(weight_spec) + (None,) * w_ndim)[:w_ndim]
    return OverlayEntry(packed=spec, v_row=spec[:-1],
                        v_col=spec[:-2] + spec[-1:])
