"""CUDA kernels: fused on-the-fly delta GEMMs (port of
``repro.kernels.bitlinear``).

* ``bitlinear_axes_p`` — y = x @ ((v_row ⊕ v_col) ⊙ unpack(B) + W_b)ᵀ for
  one variant (source ``csrc/bitlinear_axes.cu``): every overlaid
  projection of the group scheduler's fused path.
* ``bitlinear_axes_banked_p`` — the same with a bank of V variants and one
  slot index per row (source ``csrc/bitlinear_axes_banked.cu``): every
  overlaid projection of the continuous scheduler's mixed batches.
* ``bitlinear_axes_stacked_p`` — ``bitlinear_axes_p`` over a stack of E
  experts in one launch, expert e's rows against expert e's Ŵ (source
  ``csrc/bitlinear_axes_stacked.cu``): every overlaid expert GEMM of an MoE
  layer.  A block whose rows of x are all zero (an expert no token routes
  to) writes zeros and reads no weight.
* ``bitlinear_p`` — y = x @ (v ⊙ unpack(B) + W_b)ᵀ with one static-mode
  vector v (source ``csrc/bitlinear.cu``): ``core/bitdelta.DeltaLinear``
  in apply mode "onfly".

Each takes W_b in fp32, bf16 or int8; an int8 W_b comes with ``w_scale``,
one fp16 scale per output row (the int8 base of ``core/quantize``), and is
dequantized where Ŵ is formed.  The dense Ŵ never reaches device memory:
at M <= 16 the kernels stream W_b and form Ŵ in registers (the banked one
once per distinct slot its rows name), above it Ŵ is built tile by tile in
shared memory (one tile per distinct slot).  ``gemm_plan`` chooses each
launch's K split from M, N, K and the dtypes alone (``stacked_plan``: and
the expert count, for the stacked kernel's own tiers and tiles).  ``plain``, ``plain_banked``, ``plain_stacked`` and
``plain_static`` are the plain PyTorch versions of the four functions.

``launches``, ``banked_launches``, ``stacked_launches`` and
``static_launches`` count kernel launches (one per call; a split-K call's
reduction pass belongs to the same launch).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.ref import bitlinear_axes_ref as plain  # noqa: F401
from repro_torch.kernels.ref import \
    bitlinear_axes_banked_ref as plain_banked  # noqa: F401
from repro_torch.kernels.ref import \
    bitlinear_axes_stacked_ref as plain_stacked  # noqa: F401
from repro_torch.kernels.ref import bitlinear_ref as plain_static  # noqa: F401

PACK = 8
SM_COUNT = 132           # an H100 SXM
# the delta GEMM of csrc/delta_gemm.cuh (bitlinear_axes_p, bitlinear_p)
STREAM_MAX_M = 16        # M up to this streams W_b (decode); above, tiles
STREAM_ROWS = 32         # output rows per streaming block: 8 warps x 4
STREAM_SPAN = {4: 256, 2: 512, 1: 512}   # K per warp step, by W_b bytes
STREAM_SMEM = 48 * 1024  # a block's x slice and column scales, bytes
STREAM_BLOCKS_PER_SM = 1  # resident (over 128 registers a thread)
TILE_M, TILE_N, TILE_K = 64, 128, 32
TILE_MAX_K = 4096        # a split's column scales stay within 16 KB
TILE_BLOCKS_PER_SM = 2
TILE_MAX_SPLITS = 32
# the banked GEMM of csrc/bitlinear_axes_banked.cu: the same two designs
# with a slot per row (kBankPass, kBankStreamSmem, kBankTiles, kBankTileMaxK)
BANK_GROUP = 4           # rows of x per streaming block (M <= 16)
BANK_PASS = 3            # distinct non-base slots per streaming pass
BANK_STREAM_SMEM = 192 * 1024  # their column scales and the fp32 x slice
BANK_TILES = 3           # Ŵ tiles per tiled pass (the base counts)
BANK_TILE_MAX_K = 512    # a split's column scales: BANK_TILES x 2 KB
SMEM_PER_SM = 228 * 1024  # an SM's shared memory; 1 KB of it per block
# the expert-stacked GEMM of csrc/bitlinear_axes_stacked.cu (StackTier,
# kStackSmem, StackTile).  Its plan counts what splits K least, as
# measured faster on an H100 (tools/stacked_gemm_bench.py): row tiles of
# eight warps' rows by x-row tier (a block streams four of them) on the
# resident blocks an SM, and tile blocks an SM by tile height (two fit;
# counting one splits K less at 128 rows)
STACK_ROWS = {1: 16, 2: 16, 4: 16, 8: 16, 16: 8}
STACK_BLOCKS_PER_SM = {1: 3, 2: 3, 4: 2, 8: 2, 16: 2}
STACK_Q8_BLOCKS_PER_SM = 4   # over an int8 base at 1-2 rows of x
STACK_STREAM_SMEM = 96 * 1024
STACK_TILE_BLOCKS_PER_SM = {64: 2, 128: 1}
# alignment the kernels' vector loads need, per W_b dtype (eight elements
# per load: two 16-byte loads of fp32, one of bf16, one 8-byte load of int8)
W_ALIGN = {torch.float32: 16, torch.bfloat16: 16, torch.int8: 8}

launches = 0
banked_launches = 0
stacked_launches = 0
static_launches = 0


def m_tier(m: int) -> int:
    """Rows of x the streaming kernel computes for ``m`` (4, 8 or 16);
    the rows past ``m`` are zeros in shared memory, not weight traffic."""
    return 4 if m <= 4 else 8 if m <= 8 else 16


def stack_tile_m(m: int) -> int:
    """Rows of x a tile of the stacked GEMM's tiled kernel covers (m > 16
    rows an expert): 64 up to 64 rows, else 128; the tile has 16384 / that
    weight rows."""
    return 64 if m <= 64 else 128


def stack_tier(m: int) -> int:
    """Rows of x the stacked GEMM's streaming kernel computes for ``m``
    rows an expert (1, 2, 4, 8 or 16): a decode row costs one FMA a
    weight."""
    return next(t for t in (1, 2, 4, 8, 16) if m <= t)


def _wave_split(tiles: int, steps: int, slots: int, least: int,
                most: int, cap: int) -> tuple[int, int]:
    """(splits, K steps per split) for ``tiles`` output tiles over
    ``steps`` K steps on ``slots`` resident blocks: the fewest splits whose
    last wave of blocks fills within 5% as many slots as the best choice
    does.  Each split is at least ``least`` steps (unless that leaves one)
    and at most ``most``; at most ``cap`` splits unless ``most`` forces
    more; no split is empty."""
    lo = math.ceil(steps / most)
    hi = max(lo, min(cap, steps // least))
    options = []
    for want in range(lo, hi + 1):
        per = math.ceil(steps / want)
        splits = math.ceil(steps / per)
        blocks = tiles * splits
        options.append((blocks / (math.ceil(blocks / slots) * slots),
                        splits, per))
    best = max(fill for fill, _, _ in options)
    return next((s, p) for fill, s, p in options if fill >= best - 0.05)


def banked_tile_smem(x_size: int, w_size: int, k_per_split: int) -> int:
    """Shared memory of one banked tile block: two raw x and W_b stages
    (row pitch 32 elements + 16 B), ``BANK_TILES`` fp32 Ŵ tiles, the fp32
    x tile and ``BANK_TILES`` slots' column scales over the split."""
    raw = 2 * (TILE_N * (TILE_K * w_size + 16)
               + TILE_M * (TILE_K * x_size + 16))
    return (raw + 4 * (BANK_TILES * TILE_K * TILE_N + TILE_K * TILE_M)
            + 4 * BANK_TILES * k_per_split)


def gemm_plan(m: int, n: int, k: int, x_size: int, w_size: int,
              banked: bool = False) -> tuple[int, int]:
    """(splits, k_per_split) of the delta GEMM for x (m, k) of ``x_size``
    bytes per element against an (n, k) weight of ``w_size``.  M <= 16
    streams: blocks of 32 rows (the banked kernel: one per 32 rows and
    group of ``BANK_GROUP`` rows of x), K split in multiples of the warp
    step (``STREAM_SPAN``), a block's x slice and column scales (banked:
    ``BANK_PASS`` slots', x widened to fp32) within its shared memory.
    Above, 64 x 128 tiles and K split in multiples of 32, each split at
    least four steps and at most ``TILE_MAX_K`` (``BANK_TILE_MAX_K``).
    Either way the split count fills the card's last wave of blocks.  The
    banked plan sees no bank depth and no slot index: the host never reads
    vidx."""
    if m <= STREAM_MAX_M:
        span = STREAM_SPAN[w_size]
        if banked:   # a block per 4 rows: BANK_PASS column scales, x fp32
            tiles = math.ceil(n / STREAM_ROWS) * math.ceil(m / BANK_GROUP)
            most = BANK_STREAM_SMEM // ((BANK_PASS + BANK_GROUP) * 4 * span)
        else:
            tiles = math.ceil(n / STREAM_ROWS)
            most = STREAM_SMEM // ((4 + m_tier(m) * x_size) * span)
        splits, per = _wave_split(tiles, math.ceil(k / span),
                                  SM_COUNT * STREAM_BLOCKS_PER_SM, 1, most, k)
        return splits, per * span
    max_k, per_sm = TILE_MAX_K, TILE_BLOCKS_PER_SM
    if banked:
        max_k = BANK_TILE_MAX_K
        per_sm = max(1, min(per_sm, SMEM_PER_SM // (
            banked_tile_smem(x_size, w_size, max_k) + 1024)))
    splits, per = _wave_split(
        math.ceil(m / TILE_M) * math.ceil(n / TILE_N),
        math.ceil(k / TILE_K),
        SM_COUNT * per_sm, 4, max_k // TILE_K, TILE_MAX_SPLITS)
    return splits, per * TILE_K


def stacked_plan(m: int, n: int, k: int, x_size: int, w_size: int,
                 experts: int) -> tuple[int, int]:
    """(splits, k_per_split) of the stacked GEMM
    (``bitlinear_axes_stacked_p``): ``experts`` products of x (m, k)
    against (n, k) in one launch.  m <= 16 streams at ``stack_tier(m)``
    rows, tiles of ``STACK_ROWS`` weight rows, K split in warp steps
    (``STREAM_SPAN``) within ``STACK_STREAM_SMEM``; above, tiles of
    ``stack_tile_m(m)`` rows by 16384 / that weight rows and K split in
    steps of 32 as ``gemm_plan``'s tiles.  The stack
    counts ``experts`` times the tiles of one product when it fills the
    card's last wave.  The plan sees no routing: whether a block's rows are
    live is decided on the card."""
    if m <= STREAM_MAX_M:
        mt = stack_tier(m)
        span = STREAM_SPAN[w_size]
        per_sm = (STACK_Q8_BLOCKS_PER_SM if w_size == 1 and mt <= 2
                  else STACK_BLOCKS_PER_SM[mt])
        splits, per = _wave_split(
            math.ceil(n / STACK_ROWS[mt]) * experts, math.ceil(k / span),
            SM_COUNT * per_sm, 1,
            STACK_STREAM_SMEM // ((4 + mt * x_size) * span), k)
        return splits, per * span
    tm = stack_tile_m(m)
    splits, per = _wave_split(
        math.ceil(m / tm) * math.ceil(n / (16384 // tm)) * experts,
        math.ceil(k / TILE_K), SM_COUNT * STACK_TILE_BLOCKS_PER_SM[tm], 4,
        TILE_MAX_K // TILE_K, TILE_MAX_SPLITS)
    return splits, per * TILE_K


def check_base(name: str, w_base: torch.Tensor, w_scale, n) -> None:
    """What every kernel refuses of a base weight (N, ...): a dtype it has
    no instantiation for, an int8 payload without its ``n`` fp16 scale (an
    int, (N,), or a shape tuple: (E, N) for an expert stack) (or a
    scale beside a full-precision one), a payload off its dtype's alignment
    (``W_ALIGN``), a non-contiguous scale or one on another device.  A
    misaligned payload raises; it is never copied."""
    if w_base.dtype not in W_ALIGN:
        raise ValueError(f"{name}: unsupported w_base dtype {w_base.dtype}")
    if (w_base.dtype == torch.int8) != (w_scale is not None):
        raise ValueError(f"{name}: an int8 w_base needs its w_scale and a "
                         f"{w_base.dtype} one takes none")
    if w_base.data_ptr() % W_ALIGN[w_base.dtype]:
        raise ValueError(f"{name}: {w_base.dtype} w_base must be "
                         f"{W_ALIGN[w_base.dtype]}-byte aligned")
    want = (n,) if isinstance(n, int) else tuple(n)
    if w_scale is not None and (
            tuple(w_scale.shape) != want or w_scale.dtype != torch.float16
            or not w_scale.is_contiguous()
            or w_scale.device != w_base.device):
        raise ValueError(f"{name}: w_scale must be a contiguous {want} "
                         f"fp16 tensor beside w_base, got "
                         f"{tuple(w_scale.shape)} {w_scale.dtype} on "
                         f"{w_scale.device}")


def _check(name: str, x: torch.Tensor, w_base: torch.Tensor, w_scale,
           vec: torch.Tensor, ops: tuple, scale_shape=None) -> None:
    """What the GEMM wrappers refuse: operands off one CUDA device, K not
    a multiple of 8, dtypes the kernels have no instantiation for,
    non-contiguous operands, x off 16-byte alignment, and what
    ``check_base`` refuses of the base."""
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in ops):
        raise ValueError(f"{name} needs every operand on one CUDA device, "
                         f"got {[str(t.device) for t in (x, *ops)]}")
    if x.shape[-1] % PACK:
        raise ValueError(f"K {x.shape[-1]} is not a multiple of {PACK}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or vec.dtype not in (torch.float16, torch.float32):
        raise ValueError(f"unsupported dtypes x={x.dtype} "
                         f"vectors={vec.dtype}")
    if not all(t.is_contiguous() for t in (x, *ops)):
        raise ValueError(f"{name} operands must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    check_base(name, w_base, w_scale, scale_shape or w_base.shape[0])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _outputs(plan: tuple, m: int, n: int, dev) -> tuple:
    """(splits, k_per_split, y, split-K workspace or None)."""
    splits, k_per_split = plan
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    return splits, k_per_split, y, work


def bitlinear_axes_p(x: torch.Tensor, packed: torch.Tensor,
                     v_row: torch.Tensor, v_col: torch.Tensor,
                     w_base: torch.Tensor, w_scale=None) -> torch.Tensor:
    """x (M, K) fp32|bf16 · packed (N, K/8) uint8 · v_row (N,) · v_col (K,)
    fp16|fp32 · w_base (N, K) fp32|bf16|int8 (int8 with w_scale (N,) fp16)
    -> y (M, N) fp32.  Every operand on one CUDA device."""
    global launches
    m, k_dim = x.shape
    n = w_base.shape[0]
    dev = x.device
    _check("bitlinear_axes_p", x, w_base, w_scale, v_row,
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
    splits, k_per_split, y, work = _outputs(
        gemm_plan(m, n, k_dim, x.element_size(), w_base.element_size()),
        m, n, dev)
    rc = B.library().repro_bitlinear_axes(
        x.data_ptr(), B.DTYPE_CODES[x.dtype], packed.data_ptr(),
        v_row.data_ptr(), v_col.data_ptr(), B.DTYPE_CODES[v_row.dtype],
        w_base.data_ptr(), B.DTYPE_CODES[w_base.dtype], _ptr(w_scale),
        y.data_ptr(), _ptr(work), m, n, k_dim, splits, k_per_split,
        B.stream_handle(dev))
    B.check(rc, "bitlinear_axes")
    launches += 1
    return y


def bitlinear_axes_banked_p(x: torch.Tensor, vidx: torch.Tensor,
                            packed: torch.Tensor, v_row: torch.Tensor,
                            v_col: torch.Tensor, w_base: torch.Tensor,
                            w_scale=None) -> torch.Tensor:
    """x (M, K) fp32|bf16 · vidx (M,) int32 · packed (V, N, K/8) uint8 ·
    v_row (V, N) · v_col (V, K) fp16|fp32 · w_base (N, K) fp32|bf16|int8
    (int8 with w_scale (N,) fp16) -> y (M, N) fp32; row m computes against
    bank slot vidx[m].  Every operand on one CUDA device.

    Slot 0 is the base and must hold zero vectors (the overlay bank keeps it
    so): the kernel serves its rows from W_b alone.  A vidx outside [0, V)
    makes the kernel trap before it reads the bank, so the launch fails with
    a CUDA error at the next synchronisation; it is never clamped."""
    global banked_launches
    m, k_dim = x.shape
    n = w_base.shape[0]
    nbank = packed.shape[0]
    dev = x.device
    _check("bitlinear_axes_banked_p", x, w_base, w_scale, v_row,
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
    splits, k_per_split, y, work = _outputs(
        gemm_plan(m, n, k_dim, x.element_size(), w_base.element_size(),
                  banked=True), m, n, dev)
    rc = B.library().repro_bitlinear_axes_banked(
        x.data_ptr(), B.DTYPE_CODES[x.dtype], vidx.data_ptr(),
        packed.data_ptr(), v_row.data_ptr(), v_col.data_ptr(),
        B.DTYPE_CODES[v_row.dtype], w_base.data_ptr(),
        B.DTYPE_CODES[w_base.dtype], _ptr(w_scale), y.data_ptr(),
        _ptr(work), m, n, k_dim, nbank, splits, k_per_split,
        B.stream_handle(dev))
    B.check(rc, "bitlinear_axes_banked")
    banked_launches += 1
    return y


def bitlinear_axes_stacked_p(x: torch.Tensor, packed: torch.Tensor,
                             v_row: torch.Tensor, v_col: torch.Tensor,
                             w_base: torch.Tensor,
                             w_scale=None) -> torch.Tensor:
    """x (E, M, K) fp32|bf16 · packed (E, N, K/8) uint8 · v_row (E, N) ·
    v_col (E, K) fp16|fp32 · w_base (E, N, K) fp32|bf16|int8 (int8 with
    w_scale (E, N) fp16) -> y (E, M, N) fp32: expert e's rows against
    expert e's Ŵ, one launch for the stack.  Every operand on one CUDA
    device.  An expert whose rows of x are all ±0 gets exact zeros (for
    finite Ŵ) without a read of its weights."""
    global stacked_launches
    e, m, k_dim = x.shape
    n = w_base.shape[1]
    dev = x.device
    _check("bitlinear_axes_stacked_p", x, w_base, w_scale, v_row,
           (packed, v_row, v_col, w_base), scale_shape=(e, n))
    if tuple(w_base.shape) != (e, n, k_dim) or tuple(packed.shape) != (
            e, n, k_dim // PACK) or packed.dtype != torch.uint8:
        raise ValueError(f"shapes x{tuple(x.shape)} "
                         f"packed{tuple(packed.shape)} "
                         f"w_base{tuple(w_base.shape)} do not match")
    if tuple(v_row.shape) != (e, n) or tuple(v_col.shape) != (e, k_dim) \
            or v_row.dtype != v_col.dtype:
        raise ValueError(f"vectors v_row{tuple(v_row.shape)} {v_row.dtype}, "
                         f"v_col{tuple(v_col.shape)} {v_col.dtype} do not "
                         f"match E={e}, N={n}, K={k_dim}")
    splits, k_per_split = stacked_plan(m, n, k_dim, x.element_size(),
                                       w_base.element_size(), e)
    y = torch.empty((e, m, n), dtype=torch.float32, device=dev)
    work = (torch.empty((splits, e, m, n), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    # the tiled kernel's pre-pass flags: one per (expert, M tile, split)
    live = (torch.empty(e * math.ceil(m / stack_tile_m(m)) * splits,
                        dtype=torch.int32, device=dev)
            if m > STREAM_MAX_M else None)
    rc = B.library().repro_bitlinear_axes_stacked(
        x.data_ptr(), B.DTYPE_CODES[x.dtype], packed.data_ptr(),
        v_row.data_ptr(), v_col.data_ptr(), B.DTYPE_CODES[v_row.dtype],
        w_base.data_ptr(), B.DTYPE_CODES[w_base.dtype], _ptr(w_scale),
        y.data_ptr(), _ptr(work), _ptr(live), e, m, n, k_dim, splits,
        k_per_split, B.stream_handle(dev))
    B.check(rc, "bitlinear_axes_stacked")
    stacked_launches += 1
    return y


def bitlinear_p(x: torch.Tensor, packed: torch.Tensor, v2d: torch.Tensor,
                w_base: torch.Tensor, w_scale=None) -> torch.Tensor:
    """x (M, K) fp32|bf16 · packed (N, K/8) uint8 · v2d (N, 1) | (1, K) |
    (1, 1) fp16|fp32 (row, col or scalar mode) · w_base (N, K)
    fp32|bf16|int8 (int8 with w_scale (N,) fp16) -> y (M, N) fp32.  Every
    operand on one CUDA device."""
    global static_launches
    m, k_dim = x.shape
    n = w_base.shape[0]
    dev = x.device
    _check("bitlinear_p", x, w_base, w_scale, v2d, (packed, v2d, w_base))
    if tuple(w_base.shape) != (n, k_dim) or tuple(packed.shape) != (
            n, k_dim // PACK) or packed.dtype != torch.uint8:
        raise ValueError(f"shapes x{tuple(x.shape)} packed{tuple(packed.shape)}"
                         f" w_base{tuple(w_base.shape)} do not match")
    vn, vk = v2d.shape
    if vn not in (1, n) or vk not in (1, k_dim) or (vn > 1 and vk > 1):
        raise ValueError(f"v2d {tuple(v2d.shape)} is not (N, 1), (1, K) or "
                         f"(1, 1) for N={n}, K={k_dim}")
    v32 = v2d.to(torch.float32)
    # the scale is read as v[n*vs_n + k*vs_k]; a broadcast dim strides 0
    vs_n = 1 if vn > 1 else 0
    vs_k = 1 if vk > 1 else 0
    splits, k_per_split, y, work = _outputs(
        gemm_plan(m, n, k_dim, x.element_size(), w_base.element_size()),
        m, n, dev)
    rc = B.library().repro_bitlinear(
        x.data_ptr(), B.DTYPE_CODES[x.dtype], packed.data_ptr(),
        v32.data_ptr(), vs_n, vs_k, w_base.data_ptr(),
        B.DTYPE_CODES[w_base.dtype], _ptr(w_scale), y.data_ptr(), _ptr(work),
        m, n, k_dim, splits, k_per_split, B.stream_handle(dev))
    B.check(rc, "bitlinear")
    static_launches += 1
    return y
