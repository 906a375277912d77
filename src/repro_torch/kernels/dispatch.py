"""Per-rank dispatch of the delta kernels (port of
``repro.kernels.dispatch``, DESIGN.md §12).

The JAX module wraps each fused delta GEMM in ``shard_map`` so every device
runs the Pallas kernel on its own weight and overlay tile, with the one
required collective — a psum over the contracted axes when the weight's
in dim is sharded — stated in the open.  Under the port's explicit SPMD
(``distributed/sharding.py``) every rank already holds exactly those
tiles, so each entry point here is the existing kernel wrapper of
``kernels/ops`` called on the rank's local operands, then that psum of
the kernel's fp32 output, then the cast to the activations' dtype.

Axis derivation is the JAX module's: the caller names the shadowed
weight's logical axes (``waxes``), ``resolve_spec`` maps them under the
active rules — the resolution that placed the weight, overlay and bank
blocks — and :func:`plan_matmul` turns that into a :class:`Plan`.  A local
block does not carry its global shape; the active ``sharding.Layout``
gives it back.

The packed sign plane is stored per rank as its K-tile's bytes,
contiguously (``delta_overlay.entry_shardings_from_weight``), where the
JAX package stores the byte dim replicated and slices it inside
``shard_map``: a column slice of a torch tensor would be a strided view,
which the kernel wrappers refuse.

An int8 base reaches each entry point as the rank's QuantWeight block:
its int8 payload tile and the scale tile of its rows, sharded like the out
dim (``quantize.quant_sharding``), so every rank launches the q8 body of
the kernel on its own tiles, as JAX's ``in_specs`` hand the scale
``P(o_part)``.  ``S.block`` makes each tile contiguous; a tile that the
kernel wrappers still refuse (off its alignment, or without its scale)
raises there, and nothing is copied around it.

Pod-local banks (DESIGN.md §17): each rank holds its pod's bank slots
only, and the engine hands every model call pod-local slot ids (global -
pod * slots, ``ServingEngine._pod_local``), so the per-rank path indexes
the rank's bank as it stands, where the JAX shard_map path subtracts the
pod's offset inside the kernel's shard function and clips.  An MoE
layer's expert stacks reach the stacked entry point one bank slot at a
time (the slot already taken from the rank's bank), and its shared
experts the banked one with ids of the rank's pod (``models/moe``), so
both run under the pod rules unchanged, in both dispatch modes.

``no_dispatch()`` is the port's ``kernel_dispatch="gspmd"``: every operand
the plan shards is all-gathered, the global kernel runs on every rank and
the rank keeps its block of the output — the A/B reference the per-rank
path is held to.  A pod-local bank is gathered over "pod" too, and the
rows' ids go back to global ones before they are gathered, so the global
kernel reads the whole slot space, as the JAX GSPMD path does.  There is
nothing to trace, so there is no memo of compiled callables (the JAX memo
exists to avoid retracing); :func:`memo_info` counts the entry points'
plans and routes instead.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch

from repro_torch.distributed import sharding as S

PACK = 8

_local = threading.local()
memo_stats = {"per_rank": 0, "gathered": 0, "replicated": 0}


def memo_info() -> dict:
    """Routing counters (the JAX ``memo_info()`` shape, without a memo):
    per-rank launches, gathered (``no_dispatch``) launches and calls whose
    plan shards nothing."""
    return dict(memo_stats)


# ---------------------------------------------------------------------------
# activation
# ---------------------------------------------------------------------------

def layout() -> Optional[tuple]:
    """(mesh, rules, layout) whenever a mesh context is active — also
    under ``no_dispatch()``, whose gathered path needs it too."""
    mesh = S.active_mesh()
    rules = S.active_rules()
    if mesh is None or rules is None:
        return None
    return mesh, rules, S.active_layout()


def state() -> Optional[tuple]:
    """(mesh, rules) when per-rank dispatch engages (a mesh context is
    active and ``no_dispatch()`` is not), else None."""
    if getattr(_local, "off", 0):
        return None
    st = layout()
    return None if st is None else st[:2]


@contextlib.contextmanager
def no_dispatch():
    """Run the gathered global kernels inside an active mesh context (the
    engine's ``kernel_dispatch="gspmd"``)."""
    prev = getattr(_local, "off", 0)
    _local.off = prev + 1
    try:
        yield
    finally:
        _local.off = prev


# ---------------------------------------------------------------------------
# planning (the JAX module's)
# ---------------------------------------------------------------------------

_names = S._names


@dataclasses.dataclass(frozen=True)
class Plan:
    """Resolved partitioning of one fused delta GEMM: ``m_part`` the mesh
    axes of the batch rows, ``o_part`` / ``i_part`` those of the weight's
    out / in dim (at most one non-None); ``psum_axes`` the contracted axes
    to sum over (non-empty exactly when the in dim is sharded)."""
    m_part: object
    o_part: object
    i_part: object

    @property
    def psum_axes(self) -> tuple:
        return _names(self.i_part)


def plan_matmul(mesh, rules: dict, waxes, m: Optional[int], n: int,
                k: int) -> Optional[Plan]:
    """Partitioning plan for y[m, n] = x[m, k] @ Ŵ[n, k]ᵀ over GLOBAL
    dims, or None when nothing is sharded or the local K tile would not
    align to the packing width (a multiple of 8).  ``m=None`` plans
    weight-only ops (``unpack_apply``)."""
    if waxes is None or len(waxes) < 2:
        return None
    o_part, i_part = S.resolve_spec((n, k), tuple(waxes[-2:]), rules, mesh)
    m_part = None
    if m is not None:
        m_part = S.resolve_spec((m,), ("act_batch",), rules, mesh)[0]
        if set(_names(m_part)) & (set(_names(o_part)) | set(_names(i_part))):
            m_part = None
    if i_part is not None and (k // S.names_size(mesh, i_part)) % PACK:
        return None
    if m_part is None and o_part is None and i_part is None:
        return None
    return Plan(m_part=m_part, o_part=o_part, i_part=i_part)


def _local_plan(st, waxes, w_local_shape: tuple, m_local: Optional[int]):
    """The plan of a local weight block, its global dims from the active
    layout; the rows are split as the engine split its lanes (the
    context's batch axes), whatever their count would resolve to."""
    mesh, rules, lay = st
    if lay is None:
        raise RuntimeError("a mesh context without a Layout cannot map "
                           "local blocks to their placement")
    full, _ = lay.lookup(tuple(waxes), tuple(w_local_shape[-len(waxes):]))
    plan = plan_matmul(mesh, rules, waxes, None, *full[-2:])
    rows = S.active_batch_axes()
    if plan is not None and m_local is not None and rows:
        plan = dataclasses.replace(
            plan, m_part=rows if len(rows) > 1 else rows[0])
    return plan


def _gather(t: torch.Tensor, part, dim: int, mesh) -> torch.Tensor:
    return S.all_gather(t, part, dim, mesh) if part is not None else t


def _bank_part(mesh, rules: dict):
    """The mesh axes a bank's slot axis is split over (pod-local banks:
    "pod"), or None for a bank every rank holds whole."""
    for cand in rules.get("bank", ()):
        if all(mesh.axis_size(n) for n in _names(cand)):
            return cand
    return None


# ---------------------------------------------------------------------------
# entry points (kernels/ops routes here under a mesh; None = plan shards
# nothing, so the local operands ARE the global ones)
# ---------------------------------------------------------------------------

def bitlinear_axes(st, x: torch.Tensor, packed: torch.Tensor,
                   v_row: torch.Tensor, v_col: torch.Tensor, w_base,
                   waxes) -> Optional[torch.Tensor]:
    """Per-rank fused y = x @ ((v_row ⊕ v_col) ⊙ unpack(B) + W_b)ᵀ on the
    rank's tiles; the fp32 output is summed over the contracted axes when
    the in dim is sharded, then cast to x.dtype."""
    from repro_torch.kernels import ops as O
    mesh = st[0]
    wq, _ = O._unwrap_quant(w_base)
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    plan = _local_plan(st, waxes, tuple(wq.shape), x2.shape[0])
    if plan is None:
        memo_stats["replicated"] += 1
        return None
    if getattr(_local, "off", 0):
        memo_stats["gathered"] += 1
        mp, op, ip = plan.m_part, plan.o_part, plan.i_part
        xg = _gather(_gather(x2, mp, 0, mesh), ip, 1, mesh)
        y = O._bitlinear_axes_f32(
            xg, _gather(_gather(packed, op, 0, mesh), ip, 1, mesh),
            _gather(v_row, op, 0, mesh), _gather(v_col, ip, 0, mesh),
            _gather_weight(w_base, op, ip, mesh))
        y = S.block(y, (mp, op), mesh)
    else:
        memo_stats["per_rank"] += 1
        y = O._bitlinear_axes_f32(x2, packed, v_row, v_col, w_base)
        if plan.psum_axes:
            y = S.psum(y, plan.psum_axes, mesh)
    return y.to(x.dtype).reshape(*lead, y.shape[-1])


def bitlinear_axes_banked(st, x: torch.Tensor, variant_idx: torch.Tensor,
                          packed: torch.Tensor, v_row: torch.Tensor,
                          v_col: torch.Tensor, w_base,
                          waxes) -> Optional[torch.Tensor]:
    """Per-rank mixed-variant fused GEMM: every rank gathers its rows'
    slots from its own weight tile's bank (``variant_idx`` indexes the bank
    the rank holds: pod-local ids under pod-local banks), then the psum of
    the fp32 output as above.  The gathered twin gathers a pod-local bank
    over its pods and turns the ids back into global ones first."""
    from repro_torch.kernels import ops as O
    mesh, rules = st[0], st[1]
    wq, _ = O._unwrap_quant(w_base)
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    vidx = O.flatten_vidx(variant_idx, tuple(lead))
    plan = _local_plan(st, waxes, tuple(wq.shape), x2.shape[0])
    if plan is None:
        memo_stats["replicated"] += 1
        return None
    if getattr(_local, "off", 0):
        memo_stats["gathered"] += 1
        mp, op, ip = plan.m_part, plan.o_part, plan.i_part
        bp = _bank_part(mesh, rules)
        if bp is not None:
            # this rank's rows index its pod's slots: back to global ids
            vidx = vidx + mesh.index(bp) * packed.shape[0]
        y = O._bitlinear_axes_banked_f32(
            _gather(_gather(x2, mp, 0, mesh), ip, 1, mesh),
            _gather(vidx, mp, 0, mesh),
            _gather(_gather(_gather(packed, bp, 0, mesh), op, 1, mesh), ip,
                    2, mesh),
            _gather(_gather(v_row, bp, 0, mesh), op, 1, mesh),
            _gather(_gather(v_col, bp, 0, mesh), ip, 1, mesh),
            _gather_weight(w_base, op, ip, mesh))
        y = S.block(y, (mp, op), mesh)
    else:
        memo_stats["per_rank"] += 1
        y = O._bitlinear_axes_banked_f32(x2, vidx, packed, v_row, v_col,
                                         w_base)
        if plan.psum_axes:
            y = S.psum(y, plan.psum_axes, mesh)
    return y.to(x.dtype).reshape(*lead, y.shape[-1])


def bitlinear_axes_stacked(st, xe: torch.Tensor, packed: torch.Tensor,
                           v_row: torch.Tensor, v_col: torch.Tensor, w_base,
                           waxes) -> Optional[torch.Tensor]:
    """Per-rank expert-stacked fused GEMMs: xe (E_l, M, D) against the
    rank's local experts' stacks (the experts shard over "model"), one
    launch for the local stack; a psum when the contracted dim is sharded
    instead (experts that do not divide)."""
    from repro_torch.kernels import ops as O
    mesh, rules, lay = st
    if waxes is None or len(waxes) != 3:
        return None
    wq, _ = O._unwrap_quant(w_base)
    (e, f, d), (ep, fp, dp) = lay.lookup(tuple(waxes), tuple(wq.shape))
    if dp is not None and (d // mesh.names_size(dp)) % PACK:
        return None
    if ep is None and fp is None and dp is None:
        memo_stats["replicated"] += 1
        return None
    if getattr(_local, "off", 0):
        memo_stats["gathered"] += 1
        y = O._bitlinear_axes_stacked_f32(
            _gather(_gather(xe, ep, 0, mesh), dp, 2, mesh),
            _gather(_gather(_gather(packed, ep, 0, mesh), fp, 1, mesh),
                    dp, 2, mesh),
            _gather(_gather(v_row, ep, 0, mesh), fp, 1, mesh),
            _gather(_gather(v_col, ep, 0, mesh), dp, 1, mesh),
            _gather_stack(w_base, ep, fp, dp, mesh))
        y = S.block(y, (ep, None, fp), mesh)
    else:
        memo_stats["per_rank"] += 1
        y = O._bitlinear_axes_stacked_f32(xe, packed, v_row, v_col, w_base)
        if _names(dp):
            y = S.psum(y, _names(dp), mesh)
    return y.to(xe.dtype)


def unpack_apply(st, packed: torch.Tensor, v: torch.Tensor, w_base,
                 mode: str, out_dtype, waxes) -> Optional[torch.Tensor]:
    """Per-rank Ŵ = v ⊙ unpack(B) + W_b: a pure per-tile rebuild with no
    contraction, so no collective — every rank rebuilds its own Ŵ tile."""
    from repro_torch.kernels import ops as O
    mesh = st[0]
    wq, _ = O._unwrap_quant(w_base)
    plan = _local_plan(st, waxes, tuple(wq.shape), None)
    if plan is None:
        memo_stats["replicated"] += 1
        return None
    if getattr(_local, "off", 0):
        memo_stats["gathered"] += 1
        op, ip = plan.o_part, plan.i_part
        lead = wq.dim() - 2
        v_part = {"row": op, "col": ip, "scalar": None}[mode]
        w = O._unpack_apply_local(
            _gather(_gather(packed, op, lead, mesh), ip, lead + 1, mesh),
            _gather(v, v_part, v.dim() - 1, mesh),
            _gather_weight(w_base, op, ip, mesh), mode, out_dtype)
        return S.block(w, (None,) * lead + (op, ip), mesh)
    memo_stats["per_rank"] += 1
    return O._unpack_apply_local(packed, v, w_base, mode, out_dtype)


def _gather_weight(w_base, op, ip, mesh):
    """The global base weight (2-D or stacked: the last two dims are
    (out, in)) from the ranks' blocks; an int8 base as a QuantWeight whose
    payload is gathered over (out, in) and its scale over out alone (each
    rank of the in dim holds the whole rows' scales)."""
    from repro_torch.core.quantize import QuantWeight, is_quant
    nd = w_base.dim()
    if is_quant(w_base):
        return QuantWeight(q=_gather_weight(w_base.q, op, ip, mesh),
                           scale=_gather(w_base.scale, op, nd - 2, mesh))
    return _gather(_gather(w_base, op, nd - 2, mesh), ip, nd - 1, mesh)


def _gather_stack(w_base, ep, fp, dp, mesh):
    """The global expert stack (E, N, K) from the ranks' blocks; an int8
    one's scale (E, N) gathered over its (experts, out) parts only."""
    from repro_torch.core.quantize import QuantWeight, is_quant
    if is_quant(w_base):
        return QuantWeight(
            q=_gather_stack(w_base.q, ep, fp, dp, mesh),
            scale=_gather(_gather(w_base.scale, ep, 0, mesh), fp, 1, mesh))
    return _gather(_gather(_gather(w_base, ep, 0, mesh), fp, 1, mesh),
                   dp, 2, mesh)
