"""Port parity: the kernel wrappers on the CPU (their plain PyTorch
versions) against the JAX wrappers, which run the Pallas kernels in
interpret mode here, as tests/test_kernels.py does.

Tolerances as in tests/test_kernels.py: 1e-5 for fp32 (summation order),
2e-2 for a bf16 x (one bf16 rounding of the output)."""
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


@pytest.mark.parametrize("mnk", [(4, 1024, 4096), (4, 12288, 4096),
                                 (64, 4096, 12288), (5, 100, 40),
                                 (4, 64, 4096)])
def test_split_k_covers_the_contraction(mnk):
    """The CUDA wrapper's K split: every split non-empty, whole K covered,
    at most 16 splits, each at least four K steps unless K is short."""
    m, n, k = mnk
    splits, per = BL.split_k(m, n, k)
    assert 1 <= splits <= 16 and per % BL.BLOCK_K == 0
    assert (splits - 1) * per < k <= splits * per
    if splits > 1:
        assert per >= 4 * BL.BLOCK_K


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
