"""Port parity: the dense transformer, overlays, loader and fingerprint on
reduced qwen3-8b (2 layers) against the JAX package, same weights (JAX
``init(PRNGKey(0))`` crossed through ``repro_torch.bridge``).

fp32 compute: logits within 1e-4 (fp32 matmuls summed in another order
by the two frameworks), greedy tokens identical, dense reconstruction
within 1e-6."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _port_helpers import (configs, delta_model_numpy,  # noqa: E402
                           fine_tune_flat, jax_base, jax_tree)

from repro.core import calibration as JC  # noqa: E402
from repro.core import loader as JL  # noqa: E402
from repro.core.store import base_fingerprint as jax_fingerprint  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.core import loader as L  # noqa: E402
from repro_torch.core.store import base_fingerprint  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs(num_layers=2)
    jmodel, jparams, flat = jax_base(jcfg)
    jdm = JC.compress(jparams, jax_tree(jparams, fine_tune_flat(flat, 7)))
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel,
            "jparams": jparams, "flat": flat, "jdm": jdm,
            "model": build_model(tcfg),
            "params": bridge.params_from_numpy(flat, "cpu"),
            "dm": bridge.delta_model_from_numpy(delta_model_numpy(jdm),
                                                "cpu"),
            "tokens": np.random.default_rng(0).integers(
                1, jcfg.vocab_size, size=(2, 12))}


def _both_forward(s, jparams, params, jov=None, ov=None):
    want, _ = s["jmodel"].forward(jparams, {"tokens": jnp.asarray(
        s["tokens"])}, overlay=jov)
    got, _ = s["model"].forward(params, {"tokens": torch.from_numpy(
        s["tokens"])}, overlay=ov)
    return np.asarray(want, np.float32), got.float().numpy()


def test_forward_logits_match(setup):
    want, got = _both_forward(setup, setup["jparams"], setup["params"])
    assert got.shape == (2, 12, setup["tcfg"].padded_vocab)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_forward_with_overlay_matches(setup):
    jview, jov, _ = JL.device_put_overlay(setup["jparams"], setup["jdm"])
    view, ov, _ = L.device_put_overlay(setup["params"], setup["dm"])
    want, got = _both_forward(setup, jview, view, jov, ov)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # and the overlay really changes the model
    base, _ = _both_forward(setup, setup["jparams"], setup["params"])
    assert np.abs(got - base).max() > 1e-3


def test_prefill_decode_greedy_tokens_identical(setup):
    toks = setup["tokens"]
    jlast, jcache = setup["jmodel"].prefill(
        setup["jparams"], {"tokens": jnp.asarray(toks)}, 32)
    last, cache = setup["model"].prefill(
        setup["params"], {"tokens": torch.from_numpy(toks)}, 32)
    assert cache["slots"][0]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4)
    jt = jnp.argmax(jlast, -1).astype(jnp.int32)
    t = torch.argmax(last, -1).to(torch.int32)
    for _ in range(4):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        jlog, jcache = setup["jmodel"].decode_step(setup["jparams"], jt,
                                                   jcache)
        log, cache = setup["model"].decode_step(setup["params"], t, cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4)
        jt = jnp.argmax(jlog, -1).astype(jnp.int32)
        t = torch.argmax(log, -1).to(torch.int32)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_apply_artifact_dense_params_match(setup, use_kernel):
    jdense, _ = JL.apply_artifact(setup["jparams"], setup["jdm"],
                                  use_kernel=use_kernel)
    dense, stats = L.apply_artifact(setup["params"], setup["dm"],
                                    use_kernel=use_kernel)
    want = JC.flatten_params(jdense)
    got = C.flatten_params(dense)
    assert list(got) == list(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path].numpy(), np.asarray(w),
                                   rtol=0, atol=1e-6, err_msg=path)
    assert stats["transferred_bytes"] > 0


def test_fused_resident_bytes_match(setup):
    jview, jov, jst = JL.device_put_overlay(setup["jparams"], setup["jdm"])
    view, ov, st = L.device_put_overlay(setup["params"], setup["dm"])
    assert st["transferred_bytes"] == jst["transferred_bytes"]
    assert L.fused_resident_bytes(setup["params"], view, ov) == \
        JL.fused_resident_bytes(setup["jparams"], jview, jov)


def test_base_fingerprint_matches_jax(setup):
    assert base_fingerprint(setup["params"]) == jax_fingerprint(
        setup["jparams"])


def test_forward_bf16_compute_close():
    """bf16 compute: the port rounds to bf16 after every eager op, while
    XLA's CPU fusions keep bf16 elementwise chains (norm scaling, SiLU
    gating, RoPE) in fp32 and round once, and each bf16 matmul sums in its
    own order.  Those one-ulp differences (0.0156 at |logit| ~3.7) compound
    over two layers: measured at most 0.041 over three seeds, so logits
    must agree within 0.1 (about six bf16 ulps)."""
    jcfg, tcfg = configs(num_layers=2, compute_dtype="bfloat16")
    jmodel, jparams, flat = jax_base(jcfg)
    toks = np.random.default_rng(1).integers(1, jcfg.vocab_size, (2, 12))
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    got, _ = build_model(tcfg).forward(bridge.params_from_numpy(flat, "cpu"),
                                       {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=0.1)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_jax_field_for_field(reduced):
    import dataclasses

    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    want, got = jax_config("qwen3-8b"), get_config("qwen3-8b")
    if reduced:
        want, got = want.reduced(), got.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.padded_vocab, got.q_dim, got.kv_dim) == (
        want.padded_vocab, want.q_dim, want.kv_dim)


def test_model_init_needs_a_card_unless_cpu_is_asked():
    _, tcfg = configs(num_layers=1)
    model = build_model(tcfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            model.init(0)
    params = model.init(0, device="cpu")
    assert params["layers"]["attn"]["wq"].value.shape == (1, 64, 64)
    assert params["layers"]["attn"]["wq"].axes == ("layers", "q_heads",
                                                   "embed")
