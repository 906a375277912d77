"""Symmetric per-output-channel int8 quantization of the shadowed base
weights (port of ``repro.core.quantize`` without its mesh and abstract
helpers).

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
"""
from __future__ import annotations

import dataclasses

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


def quantize_weight(w: torch.Tensor) -> QuantWeight:
    """Symmetric per-output-channel int8 quantization of one weight
    (stack); scales calibrate from the weight itself (abs-max)."""
    w32 = w.to(torch.float32)
    # divide by a tensor on w's device: PyTorch's CUDA division by a host
    # scalar multiplies by its reciprocal, which can round differently
    # from the true division the CPU (and jnp) performs
    qmax = torch.full((), 127.0, device=w32.device)
    s = torch.clamp_min(w32.abs().amax(dim=-1) / qmax, _SCALE_FLOOR)
    q = torch.clamp(torch.round(w32 / s[..., None]), -127, 127)
    return QuantWeight(q=q.to(torch.int8), scale=s.to(torch.float16))


def dequantize(qw: QuantWeight, dtype=torch.float32) -> torch.Tensor:
    """Dense dequant, off the serving hot path (the dense residency mode's
    non-kernel branch, plain versions and tests)."""
    return (qw.q.to(torch.float32)
            * qw.scale.to(torch.float32)[..., None]).to(dtype)


def quantize_base(params, param_shardings=None):
    """Quantize every shadowed target weight of a base params tree.

    Returns ``(qparams, None, stats)``: the tree with target leaves replaced
    by :class:`QuantWeight` (non-targets — embeddings, norms — are the same
    tensors), no shardings (the port has no mesh yet; ``param_shardings``
    must be None), and byte accounting over the targets: ``targets``,
    ``fp_bytes``, ``int8_bytes``, ``ratio``."""
    from repro_torch.core.calibration import (flatten_params, is_target,
                                              unflatten_like)
    if param_shardings is not None:
        raise ValueError("sharded bases are not ported yet")
    flat = flatten_params(params)
    targets = {p for p, leaf in flat.items() if is_target(p, leaf)}
    fp_bytes = q_bytes = 0
    out = {}
    for path, leaf in flat.items():
        if path in targets:
            qw = quantize_weight(leaf)
            fp_bytes += leaf.numel() * leaf.element_size()
            q_bytes += qw.nbytes()
            out[path] = qw
        else:
            out[path] = leaf
    stats = {"targets": len(targets), "fp_bytes": int(fp_bytes),
             "int8_bytes": int(q_bytes),
             "ratio": q_bytes / max(fp_bytes, 1)}
    return unflatten_like(params, out), None, stats
