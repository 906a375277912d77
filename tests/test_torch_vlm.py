"""Port parity for the VLM backbone: internvl2-76b reduced (2 layers, 8
image tokens, fp32 compute) against the JAX package on the same weights
(JAX ``init(PRNGKey(0))`` crossed through ``repro_torch.bridge``) and
numpy-seeded image embeddings, tokens and fine-tunes.

* configurations equal field for field, full and reduced;
* fp32 logits over the image prefix and the text within 1e-4;
* prefill continues decoding at n_img + S (``cache["pos"]``), as JAX's
  does: the position count is the embedded sequence's, not the token
  count's;
* prefill + 8 greedy steps with ``max_len`` covering the prefix, the
  prompt and the steps: tokens identical, logits within 1e-4, caches
  (fp32 here) within 1e-5 with identical ``slot_pos``;
* the engine's frontend stub (zero fp32 image embeddings) and
  ``Deployment`` tokens equal to JAX's, continuous and group fused.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _port_helpers import (configs, delta_model_numpy,  # noqa: E402
                           fine_tune_flat, jax_base, jax_tree)

from repro.configs import get_config  # noqa: E402
from repro.core import calibration as JC  # noqa: E402
from repro.serving import Deployment as JaxDeployment  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Deployment  # noqa: E402

ARCH = "internvl2-76b"
PROMPT, STEPS = 12, 8


@pytest.fixture(scope="module")
def s():
    jcfg, tcfg = configs(num_layers=2, arch=ARCH)
    jmodel, jparams, flat = jax_base(jcfg)
    rng = np.random.default_rng(0)
    n_img = jcfg.num_image_tokens
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel,
            "jparams": jparams, "flat": flat, "model": build_model(tcfg),
            "params": bridge.params_from_numpy(flat, "cpu"),
            "tokens": rng.integers(1, jcfg.vocab_size, size=(2, PROMPT)),
            "image": rng.standard_normal((2, n_img, jcfg.d_model)).astype(
                np.float32),
            "max_len": n_img + PROMPT + STEPS}


def _batches(s):
    return ({"tokens": jnp.asarray(s["tokens"]),
             "image_embeds": jnp.asarray(s["image"])},
            {"tokens": torch.from_numpy(s["tokens"]),
             "image_embeds": torch.from_numpy(s["image"])})


def test_config_fields_match_jax():
    for reduce in (False, True):
        want, got = get_config(ARCH), TC.get_config(ARCH)
        if reduce:
            want, got = want.reduced(), got.reduced()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.padded_vocab == want.padded_vocab
    assert TC.get_config(ARCH).num_image_tokens == 256


def test_forward_logits_match_with_image_prefix(s):
    jb, tb = _batches(s)
    want, _ = s["jmodel"].forward(s["jparams"], jb)
    with torch.no_grad():
        got, _ = s["model"].forward(s["params"], tb)
    n_img = s["tcfg"].num_image_tokens
    assert got.shape == (2, n_img + PROMPT, s["tcfg"].padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    # the prefix changes the text's logits: it is attended to
    with torch.no_grad():
        text_only, _ = s["model"].forward(s["params"],
                                          {"tokens": tb["tokens"]})
    assert text_only.shape[1] == PROMPT
    assert not torch.allclose(text_only, got[:, n_img:], atol=1e-3)


def test_prefill_position_counts_the_image_prefix(s):
    """Decoding continues at n_img + S: the prefill's position count is
    the embedded sequence's (image prefix included), as in JAX."""
    jb, tb = _batches(s)
    _, jcache = s["jmodel"].prefill(s["jparams"], jb, s["max_len"],
                                    cache_dtype=jnp.float32)
    with torch.no_grad():
        _, cache = s["model"].prefill(s["params"], tb, s["max_len"],
                                      cache_dtype=torch.float32)
    n_img = s["tcfg"].num_image_tokens
    assert cache["pos"].tolist() == [n_img + PROMPT] * 2
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    slot_pos = cache["slots"][0]["slot_pos"]
    assert int(slot_pos.max()) == n_img + PROMPT - 1


def test_prefill_decode_greedy_tokens_identical(s):
    jb, tb = _batches(s)
    jlast, jcache = s["jmodel"].prefill(s["jparams"], jb, s["max_len"],
                                        cache_dtype=jnp.float32)
    with torch.no_grad():
        last, cache = s["model"].prefill(s["params"], tb, s["max_len"],
                                         cache_dtype=torch.float32)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4)
    jt = jnp.argmax(jlast, -1).astype(jnp.int32)
    t = torch.argmax(last, -1).to(torch.int32)
    for _ in range(STEPS):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        jlog, jcache = s["jmodel"].decode_step(s["jparams"], jt, jcache)
        with torch.no_grad():
            log, cache = s["model"].decode_step(s["params"], t, cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4)
        jt = jnp.argmax(jlog, -1).astype(jnp.int32)
        t = torch.argmax(log, -1).to(torch.int32)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for got, want in zip(cache["slots"], jcache["slots"]):
        np.testing.assert_array_equal(got["slot_pos"].numpy(),
                                      np.asarray(want["slot_pos"]))
        assert int(got["slot_pos"].max()) == s["max_len"] - 1
        for key in ("k", "v"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=1e-5)


def test_engine_batch_carries_zero_image_embeds(s):
    dep = Deployment(s["model"], s["params"], device="cpu", batch_size=3,
                     prompt_len=PROMPT, max_len=s["max_len"])
    batch = dep.engine._prompt_batch({1: dep.engine.request(
        dep.submit(np.arange(1, 5)))})
    img = batch["image_embeds"]
    assert img.dtype == torch.float32 and tuple(img.shape) == (
        3, s["tcfg"].num_image_tokens, s["tcfg"].d_model)
    assert not img.any()
    assert batch["tokens"][1, :4].tolist() == [1, 2, 3, 4]


KW = dict(batch_size=2, prompt_len=PROMPT)
BUDGETS = [2, 7, 3, 5, 1]


def _serve(dep, prompts, names):
    rids = [dep.submit(p, variant=names[i % len(names)],
                       max_new_tokens=BUDGETS[i % len(BUDGETS)])
            for i, p in enumerate(prompts)]
    dep.drain()
    return [dep.result(r).out_tokens for r in rids]


@pytest.mark.parametrize("scheduler", ["continuous", "group"])
def test_deployment_tokens_match_jax(s, scheduler):
    jdms = [JC.compress(s["jparams"], jax_tree(s["jparams"], fine_tune_flat(
        s["flat"], seed, scale=0.05))) for seed in (41, 42)]
    kw = dict(KW, scheduler=scheduler, mode="fused", bank_size=3,
              max_len=s["tcfg"].num_image_tokens + PROMPT + max(BUDGETS))
    jdep = JaxDeployment(s["jmodel"], s["jparams"], **kw)
    dep = Deployment(s["model"], s["params"], device="cpu", **kw)
    for i, jdm in enumerate(jdms):
        dm = bridge.delta_model_from_numpy(delta_model_numpy(jdm), "cpu")
        assert jdep.publish(f"v{i}", jdm) == dep.publish(f"v{i}", dm)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, s["jcfg"].vocab_size, size=n)
               for n in (12, 5, 9, 12, 7)]
    names = ["__base__", "v0", "v1"]
    want = _serve(jdep, prompts, names)
    got = _serve(dep, prompts, names)
    assert got == want
    assert [len(t) for t in got] == BUDGETS
    if scheduler == "continuous":
        for key in ("admitted", "retired", "prefills", "decode_steps"):
            assert dep.metrics[key] == jdep.metrics[key], key
    jdep.close()


def test_serve_launcher_runs_the_vlm_on_cpu(capsys):
    from repro_torch.launch import serve as SV
    cfg = SV.make_config(ARCH, reduced=True, num_layers=2)
    assert SV.cache_len(cfg, 16, 4) == cfg.num_image_tokens + 20
    SV.main(["--arch", ARCH, "--reduced", "--num-layers", "2", "--variants",
             "2", "--requests", "4", "--new-tokens", "2", "--mode", "fused",
             "--scheduler", "group", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'tokens_generated': 8" in out
