"""Port parity for the decoder archs beyond qwen3-8b: deepseek-7b and
starcoder2-3b (dense), gemma3-12b (local:global layers with ring caches)
and deepseek-moe-16b / moonshot-v1-16b-a3b (MoE behind a dense first
layer), each reduced, against the JAX package on the same weights (JAX
``init(PRNGKey(0))`` crossed through ``repro_torch.bridge``).

* configurations equal field for field, full and reduced;
* fp32 logits within 1e-4 (the two frameworks sum fp32 products in other
  orders) and the MoE aux loss within 1e-6;
* prefill + greedy decode: tokens identical and the last logits within
  1e-4; for gemma3 the prompt (20) and the decode (to position 28) run past
  the reduced window of 16, so the local layers' ring wraps in prefill and
  again in decode, and the caches (fp32 here) equal JAX's within 1e-5 with
  identical ``slot_pos``;
* ``prefill_ring`` equal to JAX's bit for bit at S < w, S = w and S > w;
* the continuous-scheduled ``Deployment`` (a bank of 4 slots, two
  variants) serves JAX's tokens for reduced gemma3 and deepseek-moe-16b,
  and the group scheduler's fused mode does for deepseek-moe-16b (its
  dense mode is the dense load below);
* a MoE DeltaModel (expert stacks (L, E, F, D), the router an extra) saved
  by either package loads in the other with equal manifests and arrays,
  its int8 base quantizes bit-equal, and the dense load through
  ``unpack_apply`` over the (L, E) stack equals JAX's within 1e-6.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

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
from repro.serving import Deployment as JaxDeployment  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.core import loader as L  # noqa: E402
from repro_torch.core import quantize as Q  # noqa: E402
from repro_torch.core import store as S  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Deployment  # noqa: E402

ARCHS = ("deepseek-7b", "starcoder2-3b", "gemma3-12b", "deepseek-moe-16b",
         "moonshot-v1-16b-a3b")
# 2 layers: gemma3's [local, global] pattern once; MoE: the dense first
# layer and two expert layers
LAYERS = {"deepseek-moe-16b": 3, "moonshot-v1-16b-a3b": 3}
PROMPT, MAX_LEN, STEPS = 20, 32, 8


def _setup(arch):
    jcfg, tcfg = configs(num_layers=LAYERS.get(arch, 2), arch=arch)
    jmodel, jparams, flat = jax_base(jcfg)
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel,
            "jparams": jparams, "flat": flat, "model": build_model(tcfg),
            "params": bridge.params_from_numpy(flat, "cpu"),
            "tokens": np.random.default_rng(0).integers(
                1, jcfg.vocab_size, size=(2, PROMPT))}


_CACHE: dict = {}


@pytest.fixture(params=ARCHS)
def arch(request):
    if request.param not in _CACHE:
        _CACHE[request.param] = _setup(request.param)
    return _CACHE[request.param]


@pytest.mark.parametrize("name", ARCHS)
def test_config_fields_match_jax(name):
    for reduce in (False, True):
        want, got = get_config(name), TC.get_config(name)
        if reduce:
            want, got = want.reduced(), got.reduced()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.expert_d_ff == want.expert_d_ff
        assert got.padded_vocab == want.padded_vocab


def test_forward_logits_match(arch):
    s = arch
    want, jaux = s["jmodel"].forward(s["jparams"], {"tokens": jnp.asarray(
        s["tokens"])})
    got, aux = s["model"].forward(s["params"], {"tokens": torch.from_numpy(
        s["tokens"])})
    assert got.shape == (2, PROMPT, s["tcfg"].padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert abs(float(aux["moe_aux"]) - float(jaux["moe_aux"])) <= 1e-6
    if s["tcfg"].family == "moe":
        assert float(aux["moe_aux"]) > 0


def test_prefill_decode_greedy_tokens_identical(arch):
    s = arch
    toks = s["tokens"]
    jlast, jcache = s["jmodel"].prefill(
        s["jparams"], {"tokens": jnp.asarray(toks)}, MAX_LEN,
        cache_dtype=jnp.float32)
    last, cache = s["model"].prefill(
        s["params"], {"tokens": torch.from_numpy(toks)}, MAX_LEN,
        cache_dtype=torch.float32)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4)
    jt = jnp.argmax(jlast, -1).astype(jnp.int32)
    t = torch.argmax(last, -1).to(torch.int32)
    for _ in range(STEPS):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        jlog, jcache = s["jmodel"].decode_step(s["jparams"], jt, jcache)
        log, cache = s["model"].decode_step(s["params"], t, cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4)
        jt = jnp.argmax(jlog, -1).astype(jnp.int32)
        t = torch.argmax(log, -1).to(torch.int32)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    pairs = list(zip(cache["slots"], jcache["slots"]))
    if "pre" in jcache:
        pairs.append((cache["pre"], jcache["pre"]))
    else:
        assert "pre" not in cache
    for got, want in pairs:
        np.testing.assert_array_equal(got["slot_pos"].numpy(),
                                      np.asarray(want["slot_pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=1e-5)
    if s["tcfg"].sliding_window:
        # the local ring (16 slots) holds the last 16 positions: wrapped
        ring = cache["slots"][0]["slot_pos"]
        assert ring.shape[-1] == s["tcfg"].sliding_window
        assert int(ring.max()) == PROMPT + STEPS - 1
        assert int(ring.min()) == PROMPT + STEPS - ring.shape[-1]


@pytest.mark.parametrize("s_len", [9, 16, 23])
def test_prefill_ring_matches_jax(s_len):
    rng = np.random.default_rng(s_len)
    w, b, h, hd = 16, 2, 2, 8
    k = rng.standard_normal((b, s_len, h, hd)).astype(np.float32)
    v = rng.standard_normal((b, s_len, h, hd)).astype(np.float32)
    want = JA.prefill_ring(JA.make_kv_cache(b, w, h, hd, jnp.float32),
                           jnp.asarray(k), jnp.asarray(v), w)
    got = A.prefill_ring(A.make_kv_cache(b, w, h, hd, "cpu", torch.float32),
                         torch.from_numpy(k), torch.from_numpy(v))
    for key in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    # one more token wraps to slot s_len % w, per row
    pos = np.array([s_len, s_len + 5], np.int32)
    k1 = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    want = JA.cache_insert(want, jnp.asarray(k1), jnp.asarray(k1),
                           jnp.asarray(pos), ring=True)
    got = A.cache_insert(got, torch.from_numpy(k1), torch.from_numpy(k1),
                         torch.from_numpy(pos), ring=True)
    for key in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

KW = dict(batch_size=2, prompt_len=PROMPT, max_len=MAX_LEN)
BUDGETS = [2, 9, 3, 5, 1]


def _serve(dep, prompts, names):
    rids = [dep.submit(p, variant=names[i % len(names)],
                       max_new_tokens=BUDGETS[i % len(BUDGETS)])
            for i, p in enumerate(prompts)]
    dep.drain()
    return [dep.result(r).out_tokens for r in rids]


def _variants(s):
    jdms = [JC.compress(s["jparams"], jax_tree(s["jparams"], fine_tune_flat(
        s["flat"], seed, scale=0.05))) for seed in (41, 42)]
    return jdms, [bridge.delta_model_from_numpy(delta_model_numpy(d), "cpu")
                  for d in jdms]


@pytest.mark.parametrize("name,scheduler,mode", [
    ("gemma3-12b", "continuous", "fused"),
    ("deepseek-moe-16b", "continuous", "fused"),
    ("deepseek-moe-16b", "group", "fused")])
def test_deployment_tokens_match_jax(name, scheduler, mode):
    s = _CACHE.setdefault(name, _setup(name))
    jdms, dms = _variants(s)
    kw = dict(KW, scheduler=scheduler, mode=mode)
    if scheduler == "continuous":
        kw["bank_size"] = 4
    jdep = JaxDeployment(s["jmodel"], s["jparams"], **kw)
    dep = Deployment(s["model"], s["params"], device="cpu", **kw)
    for i, (jdm, dm) in enumerate(zip(jdms, dms)):
        assert jdep.publish(f"v{i}", jdm) == dep.publish(f"v{i}", dm)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, s["jcfg"].vocab_size, size=n)
               for n in (20, 7, 18, 12, 20)]
    names = ["__base__", "v0", "v1"]
    want = _serve(jdep, prompts, names)
    got = _serve(dep, prompts, names)
    assert got == want
    assert [len(t) for t in got] == BUDGETS
    if scheduler == "continuous":
        for key in ("admitted", "retired", "prefills", "decode_steps",
                    "tokens_generated"):
            assert dep.metrics[key] == jdep.metrics[key], key
    jdep.close()


# ---------------------------------------------------------------------------
# MoE artifacts, int8 expert stacks and the dense load
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe():
    s = _CACHE.setdefault("deepseek-moe-16b", _setup("deepseek-moe-16b"))
    jdms, dms = _variants(s)
    return dict(s, jdm=jdms[0], dm=dms[0])


def test_moe_artifacts_identical_across_packages(moe, tmp_path):
    jdm, dm = moe["jdm"], moe["dm"]
    e = moe["tcfg"].num_experts
    n_moe = moe["tcfg"].num_layers - moe["tcfg"].moe_first_dense
    ent = dm.deltas["layers.moe.w_down"]
    assert tuple(ent.packed.shape[:2]) == (n_moe, e)
    assert tuple(ent.use_row.shape) == (n_moe, e)
    assert "layers.moe.router" in dm.extras
    assert "layers.moe.router" not in dm.deltas
    fp = S.base_fingerprint(moe["params"])
    assert fp == JS.base_fingerprint(moe["jparams"])
    m_t = S.save_artifact(dm, tmp_path / "t", base_fp=fp, meta={"name": "m"})
    m_j = JS.save_artifact(jdm, tmp_path / "j", base_fp=fp,
                           meta={"name": "m"})
    for key in ("deltas", "extras", "files", "artifact_bytes",
                "base_fingerprint"):
        assert m_t[key] == m_j[key], key
    for src in ("t", "j"):
        got = S.load_artifact(tmp_path / src, expect_base_fp=fp)
        want = JS.load_artifact(tmp_path / src, expect_base_fp=fp)
        assert list(got.deltas) == list(want.deltas)
        for path, w in want.deltas.items():
            for f in ("packed", "v_row", "v_col", "use_row"):
                a = bridge.to_numpy(getattr(got.deltas[path], f))
                b = np.asarray(getattr(w, f))
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a.view(np.uint8),
                                              b.view(np.uint8))
        for path, w in want.extras.items():
            np.testing.assert_array_equal(
                bridge.to_numpy(got.extras[path]).view(np.uint16),
                np.asarray(w).view(np.uint16))
    for a, b in zip(sorted((tmp_path / "t").iterdir()),
                    sorted((tmp_path / "j").iterdir())):
        assert a.name == b.name


def test_moe_int8_base_and_dense_load_match_jax(moe):
    jq, _, jstats = JQ.quantize_base(moe["jparams"])
    q, _, stats = Q.quantize_base(moe["params"])
    assert stats == {k: jstats[k] for k in stats}
    flat_q = numpy_flat(jq)
    got_flat = bridge.params_to_numpy(q)
    w = got_flat["layers.moe.w_gate"]
    assert w["scale"].shape == flat_q["layers.moe.w_gate"]["scale"].shape \
        == w["q"].shape[:-1]
    for path, want in flat_q.items():
        got = got_flat[path]
        if isinstance(want, dict):
            np.testing.assert_array_equal(got["q"], want["q"])
            np.testing.assert_array_equal(got["scale"].view(np.uint16),
                                          want["scale"].view(np.uint16))
        else:
            np.testing.assert_array_equal(got, want)
    for jbase, base in ((moe["jparams"], moe["params"]), (jq, q)):
        jview, _ = JL.apply_artifact(jbase, moe["jdm"])
        view, _ = L.apply_artifact(base, moe["dm"])
        want = JC.flatten_params(jview)
        for path, t in C.flatten_params(view).items():
            if path in moe["dm"].deltas:
                np.testing.assert_allclose(
                    t.float().numpy(), np.asarray(want[path], np.float32),
                    rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["gemma3-12b", "deepseek-moe-16b"])
def test_cache_layout_matches_jax(name):
    """The cache's structure, shapes and batch axes equal JAX's: the ring
    slots of a local layer (min(window, max_len)), the full slots of a
    global one and the MoE ``pre`` cache, each merged by the continuous
    scheduler along its batch axis."""
    import jax
    s = _CACHE.setdefault(name, _setup(name))
    want_axes = jax.tree.map(lambda a: a.index("act_batch"),
                             s["jmodel"].cache_pspecs(),
                             is_leaf=lambda x: isinstance(x, tuple))
    assert s["model"].cache_batch_axes() == want_axes
    jcache = s["jmodel"].init_cache(3, MAX_LEN)
    cache = s["model"].init_cache(3, MAX_LEN, device="cpu")
    got = jax.tree.map(lambda a: tuple(a.shape), cache)
    want = jax.tree.map(lambda a: tuple(a.shape), jcache)
    assert got == want


@pytest.mark.parametrize("name,scheduler", [("gemma3-12b", "continuous"),
                                            ("deepseek-moe-16b", "group")])
def test_serve_launcher_runs_the_new_archs_on_cpu(name, scheduler, capsys):
    from repro_torch.launch import serve as SV
    SV.main(["--arch", name, "--reduced", "--num-layers", "2", "--variants",
             "2", "--requests", "4", "--new-tokens", "2", "--mode", "fused",
             "--scheduler", scheduler, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'tokens_generated': 8" in out
