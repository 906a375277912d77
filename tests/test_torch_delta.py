"""Port parity: delta math and calibration stage 0 against the JAX package.

Packed sign planes must be byte-identical (zeros map to +1, bit j of byte
i is column 8i+j); scales equal within fp32 rounding (the two frameworks
sum the means in different orders: rtol 1e-6)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _port_helpers import (configs, delta_model_numpy,  # noqa: E402
                           fine_tune_flat, jax_base, jax_tree)

from repro.core import calibration as JC  # noqa: E402
from repro.core import delta as JD  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.core import delta as D  # noqa: E402

SHAPES = [(8, 16), (3, 5, 64), (100, 40)]


def _delta(shape, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(shape).astype(np.float32)
    d[..., ::7] = 0.0                       # exact zeros must map to +1
    return d


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_signs_byte_identical(shape):
    d = _delta(shape)
    want = np.asarray(JD.pack_signs(JD.sign_mask(jnp.asarray(d))))
    got = D.pack_signs(D.sign_mask(torch.from_numpy(d)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    signs = D.unpack_signs(got, shape[-1])
    np.testing.assert_array_equal(signs.numpy(), np.where(d >= 0, 1.0, -1.0))
    np.testing.assert_array_equal(
        signs.numpy(), np.asarray(JD.unpack_signs(jnp.asarray(want),
                                                  shape[-1])))


def test_pack_signs_bit_order():
    signs = -torch.ones((1, 16), dtype=torch.int8)
    signs[0, 0] = 1       # byte 0, bit 0
    signs[0, 11] = 1      # byte 1, bit 3
    np.testing.assert_array_equal(D.pack_signs(signs).numpy(), [[1, 8]])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["row", "col", "scalar"])
def test_init_scale_and_reconstruct_match(shape, mode):
    d = _delta(shape, seed=1)
    want = np.asarray(JD.init_scale(jnp.asarray(d), mode))
    got = D.init_scale(torch.from_numpy(d), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    wb = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jp, jv = JD.compress(jnp.asarray(wb), jnp.asarray(wb + d), mode)
    tp, tv = D.compress(torch.from_numpy(wb), torch.from_numpy(wb + d), mode)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tv.dtype == torch.float16
    np.testing.assert_allclose(tv.float().numpy(), np.asarray(jv, np.float32),
                               rtol=1e-3)          # fp16 rounding of v0
    want_w = np.asarray(JD.reconstruct(jp, jv, jnp.asarray(wb), mode))
    got_w = D.reconstruct(tp, tv, torch.from_numpy(wb), mode).numpy()
    np.testing.assert_allclose(got_w, want_w, rtol=0, atol=1e-6)


def test_calibration_compress_on_qwen3_tree():
    jcfg, _ = configs(num_layers=2)
    _, jparams, flat = jax_base(jcfg)
    ft = fine_tune_flat(flat, seed=3)
    jdm = JC.compress(jparams, jax_tree(jparams, ft))
    dm = C.compress(bridge.params_from_numpy(flat, "cpu"),
                    bridge.params_from_numpy(ft, "cpu"))
    assert set(dm.deltas) == set(jdm.deltas) and set(dm.extras) == set(
        jdm.extras)
    want = delta_model_numpy(jdm)
    got = bridge.delta_model_to_numpy(dm)
    for path, e in want["deltas"].items():
        g = got["deltas"][path]
        np.testing.assert_array_equal(g["packed"], e["packed"])
        np.testing.assert_array_equal(g["use_row"], e["use_row"])
        for key in ("v_row", "v_col"):
            np.testing.assert_allclose(g[key], e[key], rtol=1e-6, atol=0)
    for path, v in want["extras"].items():
        np.testing.assert_array_equal(got["extras"][path], v)
    assert C.artifact_nbytes(dm) == JC.artifact_nbytes(jdm)
    assert C.fp16_checkpoint_nbytes(
        bridge.params_from_numpy(flat, "cpu")) == JC.fp16_checkpoint_nbytes(
        jparams)


def test_flatten_params_paths_match_jax():
    jcfg, _ = configs(num_layers=2)
    _, jparams, flat = jax_base(jcfg)
    tparams = bridge.params_from_numpy(flat, "cpu")
    assert list(C.flatten_params(tparams)) == list(JC.flatten_params(jparams))
    again = C.unflatten_like(tparams, C.flatten_params(tparams))
    assert C.flatten_params(again).keys() == C.flatten_params(tparams).keys()
    back = bridge.params_to_numpy(tparams)
    assert back.keys() == flat.keys()
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr)


def test_bridge_round_trip_bf16_bits():
    rng = np.random.default_rng(4)
    a = jnp.asarray(rng.standard_normal((3, 8)), jnp.bfloat16)
    bits = np.asarray(a).view(np.uint16)
    t = bridge.to_tensor(bits, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32))
    np.testing.assert_array_equal(bridge.to_numpy(t), bits)
    # a numpy array of the ml_dtypes bfloat16 type crosses the same way
    np.testing.assert_array_equal(
        bridge.to_numpy(bridge.to_tensor(np.asarray(a), "cpu")), bits)
