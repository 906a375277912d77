"""Symmetric per-output-channel int8 quantization of the shadowed base
weights (port of ``repro.core.quantize``).

Every target matrix the 1-bit delta machinery shadows can be held resident
as int8 plus one fp16 scale per output channel instead of full precision.
The delta kernels dequantize the int8 base in the same pass that applies
the unpacked ±1 sign plane and the per-axis scale, so neither the dense fp
Ŵ nor the dense fp base is ever written to device memory.

For a weight stack ``W[..., d_out, d_in]``::

    scale[..., n] = max(max_k |W[..., n, k]| / 127, 1e-8)     (fp32, then fp16)
    q[..., n, k]  = clip(round(W[..., n, k] / scale), -127, 127)   (int8)

``q`` divides by the fp32 scale before it is rounded to fp16, both
divisions are true divisions on every device, and ``torch.round`` rounds
half to even as ``jnp.round`` does, so both packages produce the same bytes
on the CPU and on the card.  Per output channel, so the no-overlay product
factors exactly: ``x @ W.T == (x @ q.T) * scale``.

:class:`QuantWeight` duck-types the tensor it replaces (``shape``, ``ndim``,
``dim()``, ``dtype`` of the payload, ``device``), so shape-level consumers
(``calibration.is_target``, the loader, the overlay bank) take it as they
take a weight.  ``calibration.flatten_params`` keeps it as one leaf; the
port's ``tree.tree_map`` and ``tree_leaves`` recurse into it (a dataclass),
so ``.to(device)`` and per-layer slicing carry ``q`` and ``scale``
together and the leaves are both tensors, as ``jax.tree.leaves`` sees them.

On a mesh (``distributed/sharding.py``) a QuantWeight of specs is the
placement of a quantized leaf (:func:`quant_sharding`): ``q`` keeps the
weight's spec, ``scale`` the spec of the dims it copies.  The scale is a
property of the WHOLE row, so a rank whose block holds a K-tile of a row
(the in dim sharded: the row-parallel ``wo`` and ``w_down``) takes the row
absmax over every rank of that dim (a MAX all-reduce) before it
quantizes: each rank's ``q`` and ``scale`` blocks are then bit-identical to
its blocks of the single-device quantization.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# floor keeps all-zero channels from dividing by zero; any q on such a
# channel is 0 anyway, so the floor never reaches an output
_SCALE_FLOOR = 1e-8


@dataclasses.dataclass
class QuantWeight:
    """One quantized base weight (stack): int8 payload + fp16 per-output-
    channel scales."""
    q: torch.Tensor              # (..., d_out, d_in) int8
    scale: torch.Tensor          # (..., d_out) fp16

    __quant_leaf__ = True

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    def dim(self) -> int:
        return self.q.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())


def is_quant(x) -> bool:
    """True for a quantized base weight (marker-based, as the kernel
    wrappers and the loader check)."""
    return getattr(x, "__quant_leaf__", False)


def quantize_weight(w: torch.Tensor, in_part=None, mesh=None) -> QuantWeight:
    """Symmetric per-output-channel int8 quantization of one weight
    (stack); scales calibrate from the weight itself (abs-max).  With
    ``mesh``, ``w`` is this rank's block of a weight whose in dim is
    sharded over the mesh axes ``in_part`` (None: not sharded): the row
    absmax is the MAX over those ranks' K-tiles, so the scale is the whole
    row's and the block is the single-device quantization's block."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=-1)
    if mesh is not None:
        from repro_torch.distributed import sharding as SH
        amax = SH.psum(amax, in_part, mesh, op=SH.ReduceOp.MAX)
    # divide by a tensor on w's device: PyTorch's CUDA division by a host
    # scalar multiplies by its reciprocal, which can round differently
    # from the true division the CPU (and jnp) performs
    qmax = torch.full((), 127.0, device=w32.device)
    s = torch.clamp_min(amax / qmax, _SCALE_FLOOR)
    q = torch.clamp(torch.round(w32 / s[..., None]), -127, 127)
    return QuantWeight(q=q.to(torch.int8), scale=s.to(torch.float16))


def dequantize(qw: QuantWeight, dtype=torch.float32) -> torch.Tensor:
    """Dense dequant, off the serving hot path (the dense residency mode's
    non-kernel branch, plain versions and tests)."""
    return (qw.q.to(torch.float32)
            * qw.scale.to(torch.float32)[..., None]).to(dtype)


def quant_sharding(weight_spec, w_ndim: int):
    """QuantWeight-of-specs for one quantized leaf, by spec surgery on the
    fp weight's resolved spec (a tuple, ``sharding.resolve_spec``'s): the
    int8 payload keeps the weight's spec, the scale vector the entries of
    the dims it copies ((lead..., d_out)), the surgery
    ``delta_overlay.entry_shardings_from_weight`` applies to v_row.  A
    spec that is not a tuple (None: a single-device placement; a leaf
    already upgraded) comes back unchanged."""
    if not isinstance(weight_spec, tuple):
        return weight_spec
    spec = (weight_spec + (None,) * w_ndim)[:w_ndim]
    return QuantWeight(q=spec, scale=spec[:-1])


def quantize_base(params, param_shardings=None, mesh=None):
    """Quantize every shadowed target weight of a base params tree.

    Returns ``(qparams, qshardings, stats)``: the tree with target leaves
    replaced by :class:`QuantWeight` (non-targets — embeddings, norms — are
    the same tensors), the spec tree ``param_shardings`` with its target
    leaves upgraded by :func:`quant_sharding` (None in, None out), and byte
    accounting over the targets: ``targets``, ``fp_bytes``, ``int8_bytes``,
    ``ratio``.

    With ``mesh`` the params are this rank's blocks under
    ``param_shardings`` (``sharding.place``): a weight whose in dim is
    sharded takes its row absmax over the ranks of that dim (one MAX
    all-reduce each, in the same order on every rank), so every block is
    the single-device quantization's block; the stats count the global
    leaves, as the JAX function's do."""
    from repro_torch.core.calibration import (flatten_params, is_target,
                                              unflatten_like)
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.delta_overlay import flatten_axes
    if mesh is not None and param_shardings is None:
        raise ValueError("quantizing placed blocks needs their "
                         "param_shardings")
    flat = flatten_params(params)
    targets = {p for p, leaf in flat.items() if is_target(p, leaf)}
    specs = flatten_axes(param_shardings)
    fp_bytes = q_bytes = 0
    out = {}
    for path, leaf in flat.items():
        if path not in targets:
            out[path] = leaf
            continue
        shape = tuple(leaf.shape)
        in_part = None
        if mesh is not None:
            spec = (specs[path] + (None,) * leaf.dim())[:leaf.dim()]
            shape = SH.global_shape(shape, spec, mesh)
            in_part = spec[-1]
        qw = quantize_weight(leaf, in_part, mesh)
        n = math.prod(shape)
        fp_bytes += n * leaf.element_size()
        q_bytes += n + 2 * (n // shape[-1])
        out[path] = qw
    qsh = None
    if param_shardings is not None:
        qsh = SH._map_axes(lambda sp, leaf: quant_sharding(sp, leaf.dim())
                           if is_quant(leaf) else sp, param_shardings,
                           unflatten_like(params, out))
    stats = {"targets": len(targets), "fp_bytes": int(fp_bytes),
             "int8_bytes": int(q_bytes),
             "ratio": q_bytes / max(fp_bytes, 1)}
    return unflatten_like(params, out), qsh, stats


def quantize_struct(flat_shapes: dict, paths) -> dict:
    """Shape-only twin of :func:`quantize_base` over a flat {path ->
    tensor | shape-carrying leaf} view: target leaves become QuantWeights
    of ``meta`` tensors (int8 ``q``, fp16 ``scale`` of the weight's shape
    without its in dim), for the dry-run."""
    out = dict(flat_shapes)
    for p in paths:
        shape = tuple(flat_shapes[p].shape)
        out[p] = QuantWeight(
            q=torch.empty(shape, dtype=torch.int8, device="meta"),
            scale=torch.empty(shape[:-1], dtype=torch.float16,
                              device="meta"))
    return out
