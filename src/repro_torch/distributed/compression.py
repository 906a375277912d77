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
wire format end to end on one card.  The collective exchange itself
(``compressed_psum``, ``cross_pod_grad_mean``) needs a mesh of devices and
is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import delta as D


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
