"""Port parity for ``core/bitdelta.DeltaLinear`` and the delta helpers it
stands on, against the JAX package (``bitlinear_p`` in Pallas interpret
mode, as tests/test_bitdelta.py runs it), same weights from a numpy seed.

Tolerances: packed bytes and fp16 scale bits identical; Ŵ within 1e-6
(fp32); the three apply modes within 1e-5 (fp32 summation order); the
Frobenius residual within 1e-5 relative and the same best axis."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bitdelta as JB  # noqa: E402
from repro.core import delta as JD  # noqa: E402
from repro.core import quantize as JQ  # noqa: E402
from repro_torch.core import bitdelta as B  # noqa: E402
from repro_torch.core import delta as D  # noqa: E402
from repro_torch.core import quantize as Q  # noqa: E402
from repro_torch.kernels import bitlinear as BL  # noqa: E402

MODES = ["row", "col", "scalar"]


def _pair(seed, d_out=40, d_in=64, ft_scale=0.01):
    rng = np.random.default_rng(seed)
    wb = (rng.standard_normal((d_out, d_in)) * 0.1).astype(np.float32)
    # a fine-tune whose delta favours one axis: rows scaled unevenly
    row_mag = np.linspace(0.2, 2.0, d_out, dtype=np.float32)[:, None]
    wf = wb + ft_scale * row_mag * rng.standard_normal(
        (d_out, d_in)).astype(np.float32)
    x = rng.standard_normal((2, 3, d_in)).astype(np.float32)
    return wb, wf, x


@pytest.mark.parametrize("mode", MODES)
def test_from_pair_and_reconstruct_match_jax(mode):
    wb, wf, _ = _pair(0)
    jl = JB.DeltaLinear.from_pair(jnp.asarray(wb), jnp.asarray(wf), mode)
    tl = B.DeltaLinear.from_pair(torch.from_numpy(wb), torch.from_numpy(wf),
                                 mode)
    np.testing.assert_array_equal(tl.packed.numpy(), np.asarray(jl.packed))
    np.testing.assert_array_equal(tl.v.numpy().view(np.uint16),
                                  np.asarray(jl.v).view(np.uint16))
    assert tl.shape == tuple(jl.shape) and tl.mode == jl.mode
    np.testing.assert_allclose(tl.reconstruct().numpy(),
                               np.asarray(jl.reconstruct()), rtol=0,
                               atol=1e-6)
    assert tl.artifact_bytes() == jl.artifact_bytes()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("apply_mode", ["ref", "onfly", "dense"])
def test_call_matches_jax(mode, apply_mode):
    wb, wf, x = _pair(1)
    jl = JB.DeltaLinear.from_pair(jnp.asarray(wb), jnp.asarray(wf), mode)
    tl = B.DeltaLinear.from_pair(torch.from_numpy(wb), torch.from_numpy(wf),
                                 mode)
    want = np.asarray(jl(jnp.asarray(x), apply_mode=apply_mode))
    before = BL.static_launches
    got = tl(torch.from_numpy(x), apply_mode=apply_mode)
    assert BL.static_launches == before      # the CPU runs the plain version
    assert got.shape == (2, 3, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_onfly_over_int8_base_matches_jax(mode):
    wb, wf, x = _pair(2)
    jl = JB.DeltaLinear.from_pair(jnp.asarray(wb), jnp.asarray(wf), mode)
    tl = B.DeltaLinear.from_pair(torch.from_numpy(wb), torch.from_numpy(wf),
                                 mode)
    jl.w_base = JQ.quantize_weight(jnp.asarray(wb))
    tl.w_base = Q.quantize_weight(torch.from_numpy(wb))
    want = np.asarray(jl(jnp.asarray(x), apply_mode="onfly"))
    got = tl(torch.from_numpy(x), apply_mode="onfly")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the int8 base is the only approximation: equal to the dequantized one
    deq = B.DeltaLinear(tl.packed, tl.v, Q.dequantize(tl.w_base), mode)
    np.testing.assert_allclose(got.numpy(), deq(
        torch.from_numpy(x), apply_mode="dense").numpy(), rtol=1e-5,
        atol=1e-5)


def test_unknown_apply_mode_raises():
    wb, wf, x = _pair(3)
    tl = B.DeltaLinear.from_pair(torch.from_numpy(wb), torch.from_numpy(wf),
                                 "row")
    with pytest.raises(ValueError):
        tl(torch.from_numpy(x), apply_mode="fast")


@pytest.mark.parametrize("ft_scale", [0.01, 0.2])
def test_reconstruction_error_and_best_axis_match_jax(ft_scale):
    wb, wf, _ = _pair(4, ft_scale=ft_scale)
    for mode in MODES:
        jerr = float(JB.reconstruction_error(JB.DeltaLinear.from_pair(
            jnp.asarray(wb), jnp.asarray(wf), mode), jnp.asarray(wf)))
        terr = float(B.reconstruction_error(B.DeltaLinear.from_pair(
            torch.from_numpy(wb), torch.from_numpy(wf), mode),
            torch.from_numpy(wf)))
        assert terr == pytest.approx(jerr, rel=1e-5)
    axis = B.best_static_axis(torch.from_numpy(wb), torch.from_numpy(wf))
    assert axis == JB.best_static_axis(jnp.asarray(wb), jnp.asarray(wf))
    assert axis == "row"     # the delta's magnitude varies along rows


@pytest.mark.parametrize("mode", MODES)
def test_delta_matmul_matches_jax(mode):
    wb, wf, x = _pair(5)
    packed, v = D.compress(torch.from_numpy(wb), torch.from_numpy(wf), mode)
    jpacked, jv = JD.compress(jnp.asarray(wb), jnp.asarray(wf), mode)
    x2 = x.reshape(-1, x.shape[-1])
    want = np.asarray(JD.delta_matmul(jnp.asarray(x2), jpacked, jv,
                                      jnp.asarray(wb), mode))
    got = D.delta_matmul(torch.from_numpy(x2), packed, v,
                         torch.from_numpy(wb), mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        D.delta_matmul(torch.from_numpy(x2), packed, v,
                       torch.from_numpy(wb), "diag")


@pytest.mark.parametrize("shape", [(4096, 4096), (1024, 4096), (12288, 40)])
@pytest.mark.parametrize("mode", MODES)
def test_byte_accounting_matches_jax(shape, mode):
    assert D.artifact_bytes(*shape, mode) == JD.artifact_bytes(*shape, mode)
    assert D.fp16_bytes(*shape) == JD.fp16_bytes(*shape)
    assert D.compression_ratio(*shape, mode) == JD.compression_ratio(
        *shape, mode)
