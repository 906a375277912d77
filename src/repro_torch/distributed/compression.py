"""1-bit per-axis gradient compression with error feedback (port of
``repro.distributed.compression``).

The paper's representation, a sign mask plus a per-axis scale, applied to
gradients: each compressible gradient travels as its packed sign bits
(``core/delta``'s packing, byte-identical to the JAX package's) and one
fp16 scale per row (the mean |g| over the last dim), 16x fewer bytes than
fp32.  Error feedback carries the residual to the next step, which keeps
SGD converging (1-bit Adam / EF-signSGD).

``make_ef_transform`` is the ``grad_transform`` hook of
``train/step.make_train_step``: it quantises and dequantises every
compressible gradient with persistent error feedback, which simulates the
wire format end to end on one card.  ``compressed_psum`` is the exchange
itself over a mesh axis (explicit SPMD, ``distributed/sharding.py``): the
ranks all-gather the packed bytes and the fp16 scales, not the gradient,
and each dequantises every rank's and takes the fp32 mean in rank order;
``cross_pod_grad_mean`` applies it leaf by leaf over "pod" (gradients
that differ across pods and agree within one).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import delta as D
from repro_torch.distributed import sharding as S


def _compressible(g: torch.Tensor) -> bool:
    return g.dim() >= 2 and g.shape[-1] % 8 == 0


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """g -> (packed sign bits (..., cols/8) uint8, per-row fp16 scale):
    the per-axis scale over the last dim (row mode on (..., rows, cols))."""
    gf = g.to(torch.float32)
    packed = D.pack_signs(D.sign_mask(gf))
    scale = gf.abs().mean(dim=-1).to(torch.float16)
    return packed, scale


def dequantize(packed: torch.Tensor, scale: torch.Tensor, d_last: int
               ) -> torch.Tensor:
    signs = D.unpack_signs(packed, d_last, torch.float32)
    return scale.to(torch.float32)[..., None] * signs


def wire_bytes(g: torch.Tensor) -> tuple[int, int]:
    """(compressed, fp32) bytes of one tensor's exchange."""
    n = g.numel()
    if not _compressible(g):
        return 4 * n, 4 * n
    return n // 8 + 2 * (n // g.shape[-1]), 4 * n


def _map(fn, grads, ef):
    """fn(g, e) over the leaves of two trees of one structure (nested
    dicts); returns the tree of results."""
    if isinstance(grads, dict):
        return {k: _map(fn, grads[k], ef[k]) for k in grads}
    return fn(grads, ef)


def _part(tree, i: int):
    """The i-th element of every (g, e) pair leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _part(v, i) for k, v in tree.items()}
    return tree[i]


def make_ef_transform():
    """Returns (transform(grads, ef_state) -> (grads, ef_state), init_fn).

    transform quantises each compressible leaf of (g + e), dequantises,
    and carries the residual e' = (g + e) - deq: what each replica would
    send and receive.  A leaf that is not compressible passes through and
    its error state stays None."""
    def init(grads_template):
        return _map(lambda g, _: torch.zeros_like(g, dtype=torch.float32)
                    if _compressible(g) else None,
                    grads_template, grads_template)

    def one(g, e):
        if not _compressible(g):
            return g, None
        tot = g.to(torch.float32) + (e if e is not None else 0.0)
        deq = dequantize(*quantize(tot), g.shape[-1])
        return deq.to(g.dtype), tot - deq

    def transform(grads, ef):
        out = _map(one, grads, ef)
        return _part(out, 0), _part(out, 1)

    return transform, init


def compressed_psum(g: torch.Tensor, axis, mesh=None,
                    sent: Optional[list] = None) -> torch.Tensor:
    """Mean of ``g`` over the ranks of the mesh axis ``axis`` exchanging
    only (packed signs, fp16 scales): every rank's pair all-gathered in
    rank order, dequantised, and averaged in fp32 in that order, in
    ``g``'s dtype.  A leaf that is not compressible takes the plain mean
    (a psum).  ``sent`` (a list) gets the bytes this rank put on the wire,
    which ``wire_bytes(g)[0]`` predicts."""
    mesh = mesh or S.active_mesh()
    n = mesh.names_size(axis)
    if not _compressible(g):
        if sent is not None:
            sent.append(4 * g.numel())
        return (S.psum(g.to(torch.float32), axis, mesh) / n).to(g.dtype)
    packed, scale = quantize(g)
    if sent is not None:
        sent.append(packed.numel() * packed.element_size()
                    + scale.numel() * scale.element_size())
    all_packed = S.all_gather(packed[None], axis, 0, mesh)   # (P, ..., c/8)
    all_scale = S.all_gather(scale[None], axis, 0, mesh)
    deq = dequantize(all_packed, all_scale, g.shape[-1])       # (P, ..., c)
    acc = deq[0]
    for p in range(1, deq.shape[0]):
        acc = acc + deq[p]
    return (acc / deq.shape[0]).to(g.dtype)


def cross_pod_grad_mean(grads, mesh, axis_name: str = "pod",
                        sent: Optional[list] = None):
    """:func:`compressed_psum` of every leaf of ``grads`` (a tree of
    tensors) over the mesh axis ``axis_name``; ``sent`` as there, a leaf
    after another."""
    from repro_torch.tree import tree_map
    return tree_map(lambda g: compressed_psum(g, axis_name, mesh, sent),
                    grads)
