"""CUDA kernels: fused on-the-fly delta GEMMs (port of the
``bitlinear_axes_p`` and ``bitlinear_axes_banked_p`` parts of
``repro.kernels.bitlinear``).

* ``bitlinear_axes_p`` — y = x @ ((v_row ⊕ v_col) ⊙ unpack(B) + W_b)ᵀ for
  one variant (source ``csrc/bitlinear_axes.cu``): every overlaid
  projection of the group scheduler's fused path.
* ``bitlinear_axes_banked_p`` — the same with a bank of V variants and one
  slot index per row (source ``csrc/bitlinear_axes_banked.cu``): every
  overlaid projection of the continuous scheduler's mixed batches.

The dense Ŵ is built tile by tile in shared memory and never written to
device memory.  ``plain`` and ``plain_banked`` are the plain PyTorch
versions of the two functions.

``launches`` and ``banked_launches`` count kernel launches (one per call;
a split-K call's reduction pass belongs to the same launch).

The static-mode and int8-base GEMMs of the JAX module are not ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.ref import bitlinear_axes_ref as plain  # noqa: F401
from repro_torch.kernels.ref import \
    bitlinear_axes_banked_ref as plain_banked  # noqa: F401

PACK = 8
BLOCK_N = 64        # csrc/bitlinear_axes{,_banked}.cu BN
BLOCK_K = 32        # csrc/bitlinear_axes{,_banked}.cu BK
TARGET_BLOCKS = 264  # two blocks per SM of an H100 (132 SMs)

launches = 0
banked_launches = 0


def block_m(m: int) -> int:
    """Output-tile height the kernel picks for ``m`` rows."""
    return 16 if m <= 16 else 64


def split_k(m: int, n: int, k: int) -> tuple[int, int]:
    """(splits, k_per_split): split the contraction across blocks when the
    output tiles alone cannot fill the card (decode-sized M).  Each split
    covers at least four K steps; no split is empty."""
    tiles = math.ceil(m / block_m(m)) * math.ceil(n / BLOCK_N)
    ktiles = math.ceil(k / BLOCK_K)
    splits = max(1, min(math.ceil(TARGET_BLOCKS / tiles), ktiles // 4, 16))
    per = math.ceil(ktiles / splits)
    return math.ceil(ktiles / per), per * BLOCK_K


def _check(name: str, x: torch.Tensor, w_base: torch.Tensor,
           vec: torch.Tensor, ops: tuple) -> None:
    """What both GEMM wrappers refuse: operands off one CUDA device, K not
    a multiple of 8, dtypes the kernels have no instantiation for,
    non-contiguous operands, x or w_base off 16-byte alignment."""
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in ops):
        raise ValueError(f"{name} needs every operand on one CUDA device, "
                         f"got {[str(t.device) for t in (x, *ops)]}")
    if x.shape[1] % PACK:
        raise ValueError(f"K {x.shape[1]} is not a multiple of {PACK}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or w_base.dtype not in (torch.float32, torch.bfloat16) \
            or vec.dtype not in (torch.float16, torch.float32):
        raise ValueError(f"unsupported dtypes x={x.dtype} w_base="
                         f"{w_base.dtype} vectors={vec.dtype}")
    if not all(t.is_contiguous() for t in (x, *ops)):
        raise ValueError(f"{name} operands must be contiguous")
    if x.data_ptr() % 16 or w_base.data_ptr() % 16:
        raise ValueError("x and w_base must be 16-byte aligned")


def _outputs(m: int, n: int, k_dim: int, dev) -> tuple:
    """(splits, k_per_split, y, split-K workspace or None)."""
    splits, k_per_split = split_k(m, n, k_dim)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    return splits, k_per_split, y, work


def bitlinear_axes_p(x: torch.Tensor, packed: torch.Tensor,
                     v_row: torch.Tensor, v_col: torch.Tensor,
                     w_base: torch.Tensor) -> torch.Tensor:
    """x (M, K) fp32|bf16 · packed (N, K/8) uint8 · v_row (N,) · v_col (K,)
    fp16|fp32 · w_base (N, K) fp32|bf16 -> y (M, N) fp32.  Every operand on
    one CUDA device."""
    global launches
    m, k_dim = x.shape
    n = w_base.shape[0]
    dev = x.device
    _check("bitlinear_axes_p", x, w_base, v_row,
           (packed, v_row, v_col, w_base))
    if tuple(w_base.shape) != (n, k_dim) or tuple(packed.shape) != (
            n, k_dim // PACK) or packed.dtype != torch.uint8:
        raise ValueError(f"shapes x{tuple(x.shape)} packed{tuple(packed.shape)}"
                         f" w_base{tuple(w_base.shape)} do not match")
    if tuple(v_row.shape) != (n,) or tuple(v_col.shape) != (k_dim,) \
            or v_row.dtype != v_col.dtype:
        raise ValueError(f"vectors v_row{tuple(v_row.shape)} {v_row.dtype}, "
                         f"v_col{tuple(v_col.shape)} {v_col.dtype} do not "
                         f"match N={n}, K={k_dim}")
    splits, k_per_split, y, work = _outputs(m, n, k_dim, dev)
    rc = B.library().repro_bitlinear_axes(
        x.data_ptr(), B.DTYPE_CODES[x.dtype], packed.data_ptr(),
        v_row.data_ptr(), v_col.data_ptr(), B.DTYPE_CODES[v_row.dtype],
        w_base.data_ptr(), B.DTYPE_CODES[w_base.dtype], y.data_ptr(),
        None if work is None else work.data_ptr(), m, n, k_dim, splits,
        k_per_split, B.stream_handle(dev))
    B.check(rc, "bitlinear_axes")
    launches += 1
    return y


def bitlinear_axes_banked_p(x: torch.Tensor, vidx: torch.Tensor,
                            packed: torch.Tensor, v_row: torch.Tensor,
                            v_col: torch.Tensor,
                            w_base: torch.Tensor) -> torch.Tensor:
    """x (M, K) fp32|bf16 · vidx (M,) int32 · packed (V, N, K/8) uint8 ·
    v_row (V, N) · v_col (V, K) fp16|fp32 · w_base (N, K) fp32|bf16 ->
    y (M, N) fp32; row m computes against bank slot vidx[m].  Every operand
    on one CUDA device.

    Slot 0 is the base and must hold zero vectors (the overlay bank keeps it
    so): the kernel serves its rows from W_b alone.  A vidx outside [0, V)
    makes the kernel trap before it reads the bank, so the launch fails with
    a CUDA error at the next synchronisation; it is never clamped."""
    global banked_launches
    m, k_dim = x.shape
    n = w_base.shape[0]
    nbank = packed.shape[0]
    dev = x.device
    _check("bitlinear_axes_banked_p", x, w_base, v_row,
           (vidx, packed, v_row, v_col, w_base))
    if tuple(w_base.shape) != (n, k_dim) or tuple(packed.shape) != (
            nbank, n, k_dim // PACK) or packed.dtype != torch.uint8:
        raise ValueError(f"shapes x{tuple(x.shape)} "
                         f"packed{tuple(packed.shape)} "
                         f"w_base{tuple(w_base.shape)} do not match")
    if tuple(v_row.shape) != (nbank, n) or tuple(v_col.shape) != (
            nbank, k_dim) or v_row.dtype != v_col.dtype:
        raise ValueError(f"vectors v_row{tuple(v_row.shape)} {v_row.dtype}, "
                         f"v_col{tuple(v_col.shape)} {v_col.dtype} do not "
                         f"match V={nbank}, N={n}, K={k_dim}")
    if tuple(vidx.shape) != (m,) or vidx.dtype != torch.int32:
        raise ValueError(f"vidx must be ({m},) int32, got "
                         f"{tuple(vidx.shape)} {vidx.dtype}")
    if v_col.data_ptr() % 16:
        raise ValueError("v_col must be 16-byte aligned")
    splits, k_per_split, y, work = _outputs(m, n, k_dim, dev)
    rc = B.library().repro_bitlinear_axes_banked(
        x.data_ptr(), B.DTYPE_CODES[x.dtype], vidx.data_ptr(),
        packed.data_ptr(), v_row.data_ptr(), v_col.data_ptr(),
        B.DTYPE_CODES[v_row.dtype], w_base.data_ptr(),
        B.DTYPE_CODES[w_base.dtype], y.data_ptr(),
        None if work is None else work.data_ptr(), m, n, k_dim, nbank,
        splits, k_per_split, B.stream_handle(dev))
    B.check(rc, "bitlinear_axes_banked")
    banked_launches += 1
    return y
