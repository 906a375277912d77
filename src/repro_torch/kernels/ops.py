"""Public wrappers for the delta kernels (port of ``repro.kernels.ops``).

Each wrapper dispatches on where its tensors lie: CUDA tensors launch the
hand-written kernel (or the wrapper raises — there is no fallback), CPU
tensors take the plain PyTorch version of ``kernels/ref.py``.  Mode
handling (the per-axis ``v`` reshape) and the flattening of leading batch
dims live here, shared by both routes.

``plain_versions()`` is for comparisons only: inside it the wrappers run
the plain version on any device, so a run can be held against the same
run through the kernels.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.kernels import bitlinear as _bl
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import unpack_apply as _ua

_force_plain = False


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch versions even on CUDA tensors (comparisons
    only; never on the serving path)."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def _use_kernel(*tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return not _force_plain
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {dev}")


def _v2d(v: torch.Tensor, mode: str, lead: tuple, d_out: int,
         d_in: int) -> torch.Tensor:
    """Per-axis scale reshaped to broadcast against (*lead, d_out, d_in):
    row (*lead, d_out, 1) · col (*lead, 1, d_in) · scalar (*lead, 1, 1)."""
    if mode == "row":
        want, shape = lead + (d_out,), lead + (d_out, 1)
    elif mode == "col":
        want, shape = lead + (d_in,), lead + (1, d_in)
    elif mode == "scalar":
        want, shape = lead, lead + (1, 1)
    else:
        raise ValueError(mode)
    if tuple(v.shape) != want:
        raise ValueError(f"{mode} scale has shape {tuple(v.shape)}, "
                         f"expected {want}")
    return v.reshape(shape)


def unpack_apply(packed: torch.Tensor, v: torch.Tensor, w_base: torch.Tensor,
                 mode: str = "row", out_dtype=None) -> torch.Tensor:
    """Ŵ = v ⊙ unpack(B) + W_b (the loader's dense reconstruction).

    ``w_base`` may carry leading stacked dims (layers); ``packed`` and ``v``
    carry the same ones.  One kernel launch covers the whole stack."""
    out_dtype = out_dtype or w_base.dtype
    *lead, d_out, d_in = w_base.shape
    v2d = _v2d(v, mode, tuple(lead), d_out, d_in)
    if _use_kernel(packed, v, w_base):
        return _ua.unpack_apply_p(packed, v2d, w_base, out_dtype)
    return _ref.unpack_apply_ref(packed, v, w_base, mode, dtype=out_dtype)


def bitlinear_axes(x: torch.Tensor, packed: torch.Tensor,
                   v_row: torch.Tensor, v_col: torch.Tensor,
                   w_base: torch.Tensor) -> torch.Tensor:
    """Fused y = x @ ((v_row ⊕ v_col) ⊙ unpack(B) + W_b)ᵀ.

    v[n,k] = v_row[n] + v_col[k]; the overlay zeroes the unselected axis, so
    one kernel covers row-, col- and scalar-scaled deltas.  x may carry
    leading batch dims (flattened into M); fp32 accumulation, result in
    x.dtype."""
    *lead, k_dim = x.shape
    n = w_base.shape[0]
    x2 = x.reshape(-1, k_dim)
    if _use_kernel(x, packed, v_row, v_col, w_base):
        y = _bl.bitlinear_axes_p(x2.contiguous(), packed, v_row, v_col,
                                 w_base).to(x.dtype)
    else:
        y = _ref.bitlinear_axes_ref(x2, packed, v_row, v_col, w_base)
    return y.reshape(*lead, n)


def flatten_vidx(variant_idx: torch.Tensor, lead: tuple) -> torch.Tensor:
    """Per-row variant indices -> flattened batch rows (m,) int32.

    ``variant_idx`` has shape ``lead`` (one slot per row) or ``(lead[0],)``
    (broadcast over the remaining lead dims: one variant per batch lane)."""
    m = math.prod(lead)
    if tuple(variant_idx.shape) == tuple(lead):
        return variant_idx.to(torch.int32).reshape(m)
    return variant_idx.reshape(variant_idx.shape[0],
                               *([1] * (len(lead) - 1))).expand(
        tuple(lead)).to(torch.int32).reshape(m)


def bitlinear_axes_banked(x: torch.Tensor, variant_idx: torch.Tensor,
                          packed: torch.Tensor, v_row: torch.Tensor,
                          v_col: torch.Tensor,
                          w_base: torch.Tensor) -> torch.Tensor:
    """Mixed-variant fused y: row m of x computes against bank slot
    ``variant_idx[m]`` of a stacked overlay (slot 0 = base, zero delta).

    packed (V, N, K/8) · v_row (V, N) · v_col (V, K) stack the per-variant
    overlay leaves along a leading bank axis; ``variant_idx`` is integer
    with shape x.shape[:-1] or (x.shape[0],).  x may carry leading batch
    dims; fp32 accumulation, result in x.dtype."""
    *lead, k_dim = x.shape
    n = w_base.shape[0]
    x2 = x.reshape(-1, k_dim)
    vidx = flatten_vidx(variant_idx, tuple(lead))
    if _use_kernel(x, variant_idx, packed, v_row, v_col, w_base):
        y = _bl.bitlinear_axes_banked_p(x2.contiguous(), vidx.contiguous(),
                                        packed, v_row, v_col,
                                        w_base).to(x.dtype)
    else:
        y = _ref.bitlinear_axes_banked_ref(x2, vidx, packed, v_row, v_col,
                                           w_base)
    return y.reshape(*lead, n)
