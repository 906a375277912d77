"""Port parity for the encoder-decoder family: whisper-base reduced (2
encoder + 2 decoder layers, 16 frames, fp32 compute) against the JAX
package on the same weights (JAX ``init(PRNGKey(0))`` crossed through
``repro_torch.bridge``) and numpy-seeded frames, tokens and fine-tunes.

Bounds, and why:

* configurations equal field for field, full and reduced;
* fp32 logits within 1e-4 and the encoder output within 1e-5 (the two
  frameworks sum fp32 products in other orders); the non-causal attention
  at 1500 frames (the port's 500-key chunks against JAX's 4-key ones)
  within 1e-5; the sinusoidal tables within n · 2^-23 at n positions;
* ``collect_io`` pairs within 1e-5, with the same keys;
* prefill + 8 greedy steps: tokens identical, logits within 1e-4, the
  self and cross caches (fp32 here) within 1e-5, ``slot_pos`` identical;
* the fused overlay and a mixed bank [0, v1, v2] within 1e-4 of JAX's;
* ``Deployment`` tokens equal JAX's for group dense, group fused and
  continuous, over an fp32 and an int8 base;
* artifacts byte-identical across the packages, the int8 base bit-equal,
  the bank's layout (``enc_layers``/``dec_layers`` and the tied ``embed``
  as a banked extra) JAX's;
* ``calibrate_encdec`` to ``test_torch_calibration.py``'s bounds.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _port_helpers import (configs, delta_model_numpy,  # noqa: E402
                           fine_tune_flat, jax_base, jax_tree, numpy_flat)

from repro.configs import get_config  # noqa: E402
from repro.core import calibration as JC  # noqa: E402
from repro.core import loader as JL  # noqa: E402
from repro.core import quantize as JQ  # noqa: E402
from repro.core import store as JS  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL_layers  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro.serving import Deployment as JaxDeployment  # noqa: E402
from repro.serving.variants import OverlayBank as JaxBank  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.core import loader as L  # noqa: E402
from repro_torch.core import quantize as Q  # noqa: E402
from repro_torch.core import store as S  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import whisper as W  # noqa: E402
from repro_torch.models.param import split  # noqa: E402
from repro_torch.serving import Deployment  # noqa: E402
from repro_torch.serving.variants import OverlayBank  # noqa: E402

ARCH = "whisper-base"
PROMPT, MAX_LEN, STEPS = 12, 24, 8
LR, EPOCHS, E2E_EPOCHS = 1e-3, 2, 2


def _frames(cfg, b: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((b, cfg.encoder_frames, cfg.d_model))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def s():
    jcfg, tcfg = configs(num_layers=2, arch=ARCH)
    jmodel, jparams, flat = jax_base(jcfg)
    tokens = np.random.default_rng(0).integers(1, jcfg.vocab_size,
                                               size=(2, PROMPT))
    jdms = [JC.compress(jparams, jax_tree(jparams, fine_tune_flat(
        flat, seed, scale=0.05))) for seed in (41, 42)]
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel,
            "jparams": jparams, "flat": flat, "model": build_model(tcfg),
            "params": bridge.params_from_numpy(flat, "cpu"),
            "tokens": tokens, "frames": _frames(jcfg, 2, 1), "jdms": jdms,
            "dms": [bridge.delta_model_from_numpy(delta_model_numpy(d),
                                                  "cpu") for d in jdms]}


def _batches(s):
    """(JAX batch, port batch) of the fixture's tokens and frames."""
    return ({"tokens": jnp.asarray(s["tokens"]),
             "frames": jnp.asarray(s["frames"])},
            {"tokens": torch.from_numpy(s["tokens"]),
             "frames": torch.from_numpy(s["frames"])})


def test_config_fields_match_jax():
    for reduce in (False, True):
        want, got = get_config(ARCH), TC.get_config(ARCH)
        if reduce:
            want, got = want.reduced(), got.reduced()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.padded_vocab == want.padded_vocab == (
            51968 if not reduce else 256)


def test_param_tree_matches_jax(s):
    got = {k: tuple(v.shape) for k, v in C.flatten_params(
        split(s["model"].init(0, device="cpu"))[0]).items()}
    want = {k: v.shape for k, v in s["flat"].items()}
    assert got == want
    assert {k.split(".")[0] for k in got} == {
        "embed", "enc_layers", "enc_norm", "dec_layers", "dec_norm"}


def test_forward_logits_match(s):
    jb, tb = _batches(s)
    want, jaux = s["jmodel"].forward(s["jparams"], jb)
    with torch.no_grad():
        got, aux = s["model"].forward(s["params"], tb)
    assert got.shape == (2, PROMPT, s["tcfg"].padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(aux["enc_out"].numpy(),
                               np.asarray(jaux["enc_out"]), rtol=0, atol=1e-5)


def test_collect_io_matches_jax(s):
    jb, tb = _batches(s)
    _, jaux = JW.forward(s["jparams"], jb, s["jcfg"], collect_io=True)
    with torch.no_grad():
        _, aux = W.forward(s["params"], tb, s["tcfg"], collect_io=True)
    for key, n in (("enc_io", 6), ("dec_io", 10)):
        assert sorted(aux[key]) == sorted(jaux[key]) and len(aux[key]) == n
        for proj, pair in jaux[key].items():
            for want, got in zip(pair, aux[key][proj]):
                assert tuple(got.shape) == want.shape, (key, proj)
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{key} {proj}")
    # the cross-attention's wk/wv pairs are keyed on the encoder output
    x, y = aux["dec_io"]["cross_attn.wk"]
    assert x.shape[2] == s["tcfg"].encoder_frames == y.shape[2]


def test_prefill_decode_greedy_tokens_identical(s):
    jb, tb = _batches(s)
    jlast, jcache = s["jmodel"].prefill(s["jparams"], jb, MAX_LEN,
                                        cache_dtype=jnp.float32)
    with torch.no_grad():
        last, cache = s["model"].prefill(s["params"], tb, MAX_LEN,
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
    assert int(cache["pos"][0]) == PROMPT + STEPS
    np.testing.assert_array_equal(cache["self"]["slot_pos"].numpy(),
                                  np.asarray(jcache["self"]["slot_pos"]))
    for got, want in ((cache["self"]["k"], jcache["self"]["k"]),
                      (cache["self"]["v"], jcache["self"]["v"]),
                      (cache["cross_k"], jcache["cross_k"]),
                      (cache["cross_v"], jcache["cross_v"])):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cache_layout_matches_jax(s):
    want_axes = jax.tree.map(lambda a: a.index("act_batch"),
                             s["jmodel"].cache_pspecs(),
                             is_leaf=lambda x: isinstance(x, tuple))
    assert s["model"].cache_batch_axes() == want_axes
    got = jax.tree.map(lambda a: tuple(a.shape),
                       s["model"].init_cache(3, MAX_LEN, device="cpu"))
    want = jax.tree.map(lambda a: tuple(a.shape),
                        s["jmodel"].init_cache(3, MAX_LEN))
    assert got == want


@pytest.mark.parametrize("n", [16, 1500, 4096])
def test_sinusoidal_positions_match_jax(n):
    """The (n, 512) position table of the encoder (1500 frames) and the
    decoder (up to max_seq_len 4096): fp32 exp, sin and cos of angles up to
    n radians, each library rounding its own way, so within a few ulps of
    the largest angle (n · 2^-23); the decode table is the same values."""
    want = np.asarray(JL_layers.sinusoidal_positions(n, 512))
    got = W.sinusoidal_positions(n, 512).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=n * 2.0 ** -23)
    assert torch.equal(W.sinusoid_table(n, 512, torch.device("cpu")),
                       W.sinusoidal_positions(n, 512))


@pytest.mark.parametrize("s_len", [3, 1500])
def test_full_attention_matches_jax(s_len):
    """The non-causal attention of the encoder and the cross-attention:
    the port's chunk (``even_chunk``) against JAX's (4 keys at 1500)."""
    rng = np.random.default_rng(s_len)
    q = rng.standard_normal((1, s_len, 4, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 1, 1500, 2, 16)).astype(np.float32)
    want = JA.flash_attention(jnp.asarray(q), jnp.asarray(kv[0]),
                              jnp.asarray(kv[1]), causal=False)
    got = W._full_attention(torch.from_numpy(q), torch.from_numpy(kv[0]),
                            torch.from_numpy(kv[1]))
    assert A.even_chunk(1500) == 500 and A._pick_chunk(1500, 512) == 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_fused_and_mixed_bank_forward_match_jax(s):
    jb, tb = _batches(s)
    jbank, bank = JaxBank(s["jparams"], 4), OverlayBank(s["params"], 4)
    slots = []
    for i, (jdm, dm) in enumerate(zip(s["jdms"], s["dms"])):
        js, _ = jbank.admit(f"v{i}", jdm)
        slot, _ = bank.admit(f"v{i}", dm)
        assert slot == js
        slots.append(slot)
        jp, jov, _ = JL.device_put_overlay(s["jparams"], jdm)
        p, ov, _ = L.device_put_overlay(s["params"], dm)
        want = s["jmodel"].forward(jp, jb, overlay=jov)[0]
        with torch.no_grad():
            got = s["model"].forward(p, tb, overlay=ov)[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    vidx = [0, slots[1]]
    want = s["jmodel"].forward(s["jparams"], jb, overlay=jbank.tree,
                               variant_idx=jnp.asarray(vidx, jnp.int32))[0]
    with torch.no_grad():
        got = s["model"].forward(s["params"], tb, overlay=bank.tree,
                                 variant_idx=torch.tensor(vidx))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # the bank's layout: the stacked groups put the bank axis behind the
    # layer dim, the tied embedding is a banked extra with it in front
    assert _bank_shapes(bank.tree) == _bank_shapes(jbank.tree)
    assert _bank_shapes(bank.tree)["embed"] == (4, 256, 64)
    assert _bank_shapes(bank.tree)["enc_layers.attn.wq.packed"][:2] == (2, 4)


def _bank_shapes(tree) -> dict:
    """{dot path: shape} of a banked tree of either package (overlay
    entries expanded into their three fields)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        elif hasattr(node, "packed"):
            for f in ("packed", "v_row", "v_col"):
                out[".".join(prefix + (f,))] = tuple(getattr(node, f).shape)
        else:
            out[".".join(prefix)] = tuple(node.shape)
    walk(tree, ())
    return out


KW = dict(batch_size=2, prompt_len=PROMPT, max_len=MAX_LEN)
BUDGETS = [2, 7, 3, 5, 1]


def _serve(dep, prompts, names):
    rids = [dep.submit(p, variant=names[i % len(names)],
                       max_new_tokens=BUDGETS[i % len(BUDGETS)])
            for i, p in enumerate(prompts)]
    dep.drain()
    return [dep.result(r).out_tokens for r in rids]


@pytest.mark.parametrize("base_dtype", ["fp", "int8"])
@pytest.mark.parametrize("scheduler,mode", [("group", "dense"),
                                            ("group", "fused"),
                                            ("continuous", "fused")])
def test_deployment_tokens_match_jax(s, scheduler, mode, base_dtype):
    """Every request's tokens equal JAX's, frames from both engines' zero
    stub.  Group dense over an int8 base serves variants only (the JAX
    engine's step cache cannot follow a base request there; ROADMAP §3)."""
    kw = dict(KW, scheduler=scheduler, mode=mode, base_dtype=base_dtype,
              bank_size=4)
    jdep = JaxDeployment(s["jmodel"], s["jparams"], **kw)
    dep = Deployment(s["model"], s["params"], device="cpu", **kw)
    for i, (jdm, dm) in enumerate(zip(s["jdms"], s["dms"])):
        assert jdep.publish(f"v{i}", jdm) == dep.publish(f"v{i}", dm)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, s["jcfg"].vocab_size, size=n)
               for n in (12, 5, 9, 12, 7)]
    names = ["v0", "v1"] if (mode, base_dtype) == ("dense", "int8") else \
        ["__base__", "v0", "v1"]
    want = _serve(jdep, prompts, names)
    got = _serve(dep, prompts, names)
    assert got == want
    assert [len(t) for t in got] == BUDGETS
    if scheduler == "continuous":
        for key in ("admitted", "retired", "prefills", "decode_steps",
                    "tokens_generated"):
            assert dep.metrics[key] == jdep.metrics[key], key
    jdep.close()


def test_artifacts_identical_across_packages(s, tmp_path):
    jdm, dm = s["jdms"][0], s["dms"][0]
    assert "embed" in dm.extras and "embed" not in dm.deltas
    assert {k.split(".")[0] for k in dm.deltas} == {"enc_layers",
                                                    "dec_layers"}
    fp = S.base_fingerprint(s["params"])
    assert fp == JS.base_fingerprint(s["jparams"])
    m_t = S.save_artifact(dm, tmp_path / "t", base_fp=fp, meta={"name": "w"})
    m_j = JS.save_artifact(jdm, tmp_path / "j", base_fp=fp,
                           meta={"name": "w"})
    for key in ("deltas", "extras", "files", "artifact_bytes",
                "base_fingerprint"):
        assert m_t[key] == m_j[key], key
    for a, b in zip(sorted((tmp_path / "t").iterdir()),
                    sorted((tmp_path / "j").iterdir())):
        assert a.name == b.name and a.read_bytes() == b.read_bytes(), a.name
    for src in ("t", "j"):
        got = S.load_artifact(tmp_path / src, expect_base_fp=fp)
        want = JS.load_artifact(tmp_path / src, expect_base_fp=fp)
        assert list(got.deltas) == list(want.deltas)
        for path, w in want.deltas.items():
            for f in ("packed", "v_row", "v_col", "use_row"):
                np.testing.assert_array_equal(
                    bridge.to_numpy(getattr(got.deltas[path], f)),
                    np.asarray(getattr(w, f)))
        for path, w in want.extras.items():
            np.testing.assert_array_equal(
                bridge.to_numpy(got.extras[path]).view(np.uint16),
                np.asarray(w).view(np.uint16))


def test_int8_base_and_dense_load_match_jax(s):
    jq, _, jstats = JQ.quantize_base(s["jparams"])
    q, _, stats = Q.quantize_base(s["params"])
    assert stats == {k: jstats[k] for k in stats}
    assert stats["targets"] == 6 + 10       # stacks: encoder, decoder
    want_flat, got_flat = numpy_flat(jq), bridge.params_to_numpy(q)
    for path, want in want_flat.items():
        got = got_flat[path]
        if isinstance(want, dict):
            np.testing.assert_array_equal(got["q"], want["q"])
            np.testing.assert_array_equal(got["scale"].view(np.uint16),
                                          want["scale"].view(np.uint16))
        else:
            np.testing.assert_array_equal(got, want)
    for jbase, base in ((s["jparams"], s["params"]), (jq, q)):
        jview, _ = JL.apply_artifact(jbase, s["jdms"][0])
        view, _ = L.apply_artifact(base, s["dms"][0])
        want = JC.flatten_params(jview)
        for path, t in C.flatten_params(view).items():
            if path in s["dms"][0].deltas:
                np.testing.assert_allclose(
                    t.float().numpy(), np.asarray(want[path], np.float32),
                    rtol=0, atol=1e-6)


def _moved_alike(got, want, start, what):
    moved = np.linalg.norm(np.asarray(want) - start)
    np.testing.assert_array_less(
        np.linalg.norm(np.asarray(got) - np.asarray(want)),
        1e-2 * moved + 1e-12, err_msg=what)
    return moved


def test_calibrate_encdec_matches_jax(s):
    """Stages 0-3 on a numpy-seeded fine-tune, two batches of tokens and
    frames: the bounds of ``test_torch_calibration.py`` (near-ties read
    from the port's held-out MSEs: the JAX report keeps none)."""
    ft_flat = fine_tune_flat(s["flat"], 11)
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(1, s["jcfg"].vocab_size, (2, 8)),
                "frames": _frames(s["jcfg"], 2, 20 + i)} for i in range(2)]
    kw = dict(epochs=EPOCHS, e2e_epochs=E2E_EPOCHS, lr=LR, e2e_lr=LR)
    jdm, jrep = JC.calibrate_encdec(
        s["jmodel"], s["jparams"], jax_tree(s["jparams"], ft_flat),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches], **kw)
    base, ft = s["params"], bridge.params_from_numpy(ft_flat, "cpu")
    dm, rep = C.calibrate_encdec(s["model"], base, ft, batches, **kw)
    want, got = delta_model_numpy(jdm), bridge.delta_model_to_numpy(dm)
    assert sorted(got["deltas"]) == sorted(want["deltas"])
    bound = LR * (EPOCHS + E2E_EPOCHS * len(batches))
    start = bridge.delta_model_to_numpy(C.compress(base, ft))["deltas"]
    for path, w in want["deltas"].items():
        g = got["deltas"][path]
        np.testing.assert_array_equal(g["packed"], w["packed"])
        for f in ("v_row", "v_col"):
            np.testing.assert_allclose(g[f], w[f], rtol=0, atol=bound,
                                       err_msg=f"{path}.{f}")
            assert _moved_alike(g[f], w[f], start[path][f],
                                f"{path}.{f}") > 0
    assert sorted(rep["axis"]) == sorted(jrep["axis"])
    assert {k.split(".")[0] for k in rep["axis"]} == {"enc_layers",
                                                      "dec_layers"}
    for proj, axes in jrep["axis"].items():
        for li, want_axis in enumerate(axes):
            mr, mc = rep["val_mse"][proj][li]
            if abs(mr - mc) > 1e-6 * max(mr, mc):
                assert rep["axis"][proj][li] == want_axis, (proj, li)
    np.testing.assert_allclose(rep["e2e_losses"], jrep["e2e_losses"],
                               rtol=5e-2)
    assert len(rep["e2e_losses"]) == E2E_EPOCHS * len(batches)
    jb, tb = _batches(s)
    j_mse = float(((s["jmodel"].forward(JC.apply_delta(s["jparams"], jdm),
                                        jb)[0]
                    - s["jmodel"].forward(jax_tree(s["jparams"], ft_flat),
                                          jb)[0]) ** 2).mean())
    with torch.no_grad():
        t_mse = float(((s["model"].forward(C.apply_delta(base, dm), tb)[0]
                        - s["model"].forward(ft, tb)[0]) ** 2).mean())
    np.testing.assert_allclose(t_mse, j_mse, rtol=5e-2)


def test_serve_launcher_runs_whisper_on_cpu(capsys):
    from repro_torch.launch import serve as SV
    SV.main(["--arch", ARCH, "--reduced", "--variants", "2", "--requests",
             "4", "--new-tokens", "2", "--mode", "fused", "--scheduler",
             "continuous", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'tokens_generated': 8" in out
