"""Port parity: the kernel wrappers on the CPU (their plain PyTorch
versions) against the JAX wrappers, which run the Pallas kernels in
interpret mode here, as tests/test_kernels.py does.

Tolerances as in tests/test_kernels.py: 1e-5 for fp32 (summation order),
2e-2 for a bf16 x (one bf16 rounding of the output)."""
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import delta as JD  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import bitlinear as BL  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402


def _case(seed, lead, d_out, d_in, mode):
    rng = np.random.default_rng(seed)
    wb = (rng.standard_normal(lead + (d_out, d_in)) * 0.1).astype(np.float32)
    delta = (rng.standard_normal(lead + (d_out, d_in)) * 0.01).astype(
        np.float32)
    packed = np.asarray(JD.pack_signs(JD.sign_mask(jnp.asarray(delta))))
    v = np.asarray(JD.init_scale(jnp.asarray(delta), mode))
    return wb, packed, v


def _t(a):
    return bridge.to_tensor(a, "cpu")


@pytest.mark.parametrize("shape", [(16, 128), (100, 40), (24, 72)])
@pytest.mark.parametrize("mode", ["row", "col", "scalar"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_unpack_apply_matches_jax(shape, mode, dtype):
    wb, packed, v = _case(0, (), *shape, mode)
    jwb = jnp.asarray(wb).astype(dtype)
    want = np.asarray(JK.unpack_apply(jnp.asarray(packed), jnp.asarray(v),
                                      jwb, mode=mode, out_dtype=jnp.float32))
    got = K.unpack_apply(_t(packed), _t(v), _t(np.asarray(jwb)), mode=mode,
                         out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["row", "col", "scalar"])
def test_unpack_apply_stacked_matches_jax(mode):
    wb, packed, v = _case(1, (3,), 32, 64, mode)
    got = K.unpack_apply(_t(packed), _t(v), _t(wb), mode=mode,
                         out_dtype=torch.float32)
    assert got.shape == (3, 32, 64)
    for layer in range(3):
        want = np.asarray(JK.unpack_apply(
            jnp.asarray(packed[layer]), jnp.asarray(v[layer]),
            jnp.asarray(wb[layer]), mode=mode, out_dtype=jnp.float32))
        np.testing.assert_allclose(got[layer].numpy(), want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("lead", [(4,), (2, 3)])
@pytest.mark.parametrize("axis", ["row", "col"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bitlinear_axes_matches_jax(lead, axis, dtype):
    n, k = 48, 64
    wb, packed, v = _case(2, (), n, k, axis)
    # canonical overlay vectors: the unselected axis is zero
    vr = v if axis == "row" else np.zeros(n, np.float32)
    vc = v if axis == "col" else np.zeros(k, np.float32)
    vr, vc = vr.astype(np.float16), vc.astype(np.float16)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(lead + (k,)),
                    dtype)
    want = JK.bitlinear_axes(x, jnp.asarray(packed), jnp.asarray(vr),
                             jnp.asarray(vc), jnp.asarray(wb))
    got = K.bitlinear_axes(_t(np.asarray(x)), _t(packed), _t(vr), _t(vc),
                           _t(wb))
    assert got.shape == lead + (n,) and got.dtype == (
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# qwen3-8b's seven projections (N, K) and ragged ones (K a multiple of 8)
PROJECTIONS = [(4096, 4096), (1024, 4096), (1024, 4096), (4096, 4096),
               (12288, 4096), (12288, 4096), (4096, 12288)]
RAGGED = [(100, 40), (130, 1032), (64, 4096), (33, 8), (4100, 12296)]
PLAN_MS = [1, 2, 3, 4, 5, 8, 9, 16, 17, 33, 64]


@pytest.mark.parametrize("mnk", [(4, 1024, 4096), (4, 12288, 4096),
                                 (64, 4096, 12288), (5, 100, 40),
                                 (4, 64, 4096)]
                         + [(m, n, k) for n, k in sorted(set(PROJECTIONS))
                            + RAGGED for m in PLAN_MS])
@pytest.mark.parametrize("x_size,w_size", [(2, 4), (4, 4), (2, 2), (2, 1),
                                           (4, 1)])
def test_split_k_covers_the_contraction(mnk, x_size, w_size):
    """The delta GEMM's launch plan: every split non-empty, the whole K
    covered once, each split a whole number of the kernel's K steps (the
    streaming kernel's warp step at M <= 16, 32 above), the streaming
    block's x slice and column scales within its shared memory, the tiled
    kernel's split within ``TILE_MAX_K``."""
    m, n, k = mnk
    splits, per = BL.gemm_plan(m, n, k, x_size, w_size)
    assert splits >= 1 and (splits - 1) * per < k <= splits * per
    if m <= BL.STREAM_MAX_M:
        assert per % BL.STREAM_SPAN[w_size] == 0
        assert per * (4 + BL.m_tier(m) * x_size) <= BL.STREAM_SMEM
        assert BL.m_tier(m) >= m
    else:
        assert per % BL.TILE_K == 0 and per <= BL.TILE_MAX_K
        assert splits <= BL.TILE_MAX_SPLITS or per == BL.TILE_MAX_K
        if splits > 1:
            assert per >= 4 * BL.TILE_K


@pytest.mark.parametrize("mnk", [(m, n, k) for n, k in PROJECTIONS[:5:2]
                                 + RAGGED[:2] for m in (1, 4, 16, 17, 64)])
@pytest.mark.parametrize("x_size,w_size", [(2, 4), (4, 4), (2, 2), (2, 1)])
def test_banked_plan_covers_k_and_fits_shared_memory(mnk, x_size, w_size):
    """The banked GEMM's launch plan: the whole K covered once with no
    empty split, each split a whole number of its kernel's K steps, and what
    the block stages within shared memory: at M <= 16 its group of rows of
    the x slice (as fp32) and ``BANK_PASS`` slots' column scales, above it the raw and Ŵ tiles and
    ``BANK_TILES`` slots' column scales (at most 227 KB a block).  The plan
    is a function of M, N, K and the element sizes alone, so it is the same
    for every bank depth and slot mix and the host never reads vidx."""
    m, n, k = mnk
    splits, per = BL.gemm_plan(m, n, k, x_size, w_size, banked=True)
    assert splits >= 1 and (splits - 1) * per < k <= splits * per
    if m <= BL.STREAM_MAX_M:
        assert per % BL.STREAM_SPAN[w_size] == 0
        assert per * 4 * (BL.BANK_PASS + BL.BANK_GROUP) \
            <= BL.BANK_STREAM_SMEM
    else:
        assert per % BL.TILE_K == 0 and per <= BL.BANK_TILE_MAX_K
        assert BL.banked_tile_smem(x_size, w_size, per) <= 227 * 1024
        if splits > 1:
            assert per >= 4 * BL.TILE_K
    assert list(inspect.signature(BL.gemm_plan).parameters) == [
        "m", "n", "k", "x_size", "w_size", "banked"]


@pytest.mark.parametrize("n,k", PROJECTIONS[:5:2])
@pytest.mark.parametrize("m,w_size", [(4, 4), (4, 1), (64, 4)])
def test_plan_fills_the_last_wave(m, n, k, w_size):
    """At qwen3-8b's shapes the plan's blocks fill at least 90% of the
    card's last wave (one streaming block per SM, two tiled ones), or the
    split is as fine as its limits allow."""
    splits, per = BL.gemm_plan(m, n, k, 2, w_size)
    if m <= BL.STREAM_MAX_M:
        tiles, slots = -(-n // BL.STREAM_ROWS), BL.SM_COUNT
        finest = per == BL.STREAM_SPAN[w_size]
    else:
        tiles = -(-m // BL.TILE_M) * -(-n // BL.TILE_N)
        slots = BL.SM_COUNT * BL.TILE_BLOCKS_PER_SM
        finest = per == 4 * BL.TILE_K or splits == BL.TILE_MAX_SPLITS
    blocks = tiles * splits
    assert blocks / (-(-blocks // slots) * slots) >= 0.9 or finest


def test_wrappers_refuse_a_device_without_a_version():
    meta = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError):
        K.bitlinear_axes(meta, torch.empty((8, 2), dtype=torch.uint8,
                                           device="meta"),
                         torch.empty(8, device="meta"),
                         torch.empty(16, device="meta"),
                         torch.empty((8, 16), device="meta"))
    with pytest.raises(ValueError):                 # mixed devices
        K.unpack_apply(meta.to(torch.uint8)[:, :2], torch.zeros(4),
                       torch.zeros((4, 16)), mode="row")


def test_plain_versions_context_restores():
    assert not K._force_plain
    with K.plain_versions():
        assert K._force_plain
    assert not K._force_plain
