"""Port parity for the recurrent families: xlstm-350m (``ssm``: mLSTM +
sLSTM at 3:1, 4 layers) and zamba2-7b (``hybrid``: Mamba2 with the shared
attention block every 3 layers, 7 layers: 2 applications and 1 trailing
block), each reduced with fp32 compute, against the JAX package on the
same weights (JAX ``init(PRNGKey(0))`` crossed through
``repro_torch.bridge``) and numpy-seeded tokens and fine-tunes.

Bounds, and why:

* configurations equal field for field, full and reduced; the parameter
  trees path for path and shape for shape;
* fp32 logits within 1e-4 and the carried states within 1e-4 of their
  largest |value| (the two frameworks sum fp32 products in other
  orders);
* prefill + 6 greedy steps without an overlay, through one fused variant
  and through a bank over rows [0, v0, v1]: tokens identical, logits
  within 1e-4; over an int8 base too;
* zamba's prefill projects each application point's q/k/v once and
  caches that k/v, where JAX projects twice: a second projection gives
  the cached values bit for bit;
* ``Deployment`` tokens equal JAX's per request for group dense, group
  fused and continuous over an fp32 base, and continuous over an int8 base;
* artifacts byte-identical across the packages, ``shared.*``'s rank-0
  axis selector included; the dense load of the shared block's matrices
  (``unpack_apply`` over a 2-D entry) within 1e-6 of JAX's;
* ``e2e_calibrate`` (the one calibration stage the JAX package runs on
  these families) over stage-0 variants for 2 epochs: each selected scale
  within lr x steps of JAX's and moved alike, losses within 5% relative.
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
from repro.serving import Deployment as JaxDeployment  # noqa: E402
from repro.serving.variants import OverlayBank as JaxBank  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.core import loader as L  # noqa: E402
from repro_torch.core import quantize as Q  # noqa: E402
from repro_torch.core import store as S  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import zamba as Z  # noqa: E402
from repro_torch.models.param import split  # noqa: E402
from repro_torch.serving import Deployment  # noqa: E402
from repro_torch.serving.variants import OverlayBank  # noqa: E402

ARCHS = ("xlstm-350m", "zamba2-7b")
PROMPT, MAX_LEN, STEPS = 12, 24, 6
LR, EPOCHS = 1e-3, 2


def _setup(arch):
    jcfg, tcfg = configs(num_layers=get_config(arch).reduced().num_layers,
                         arch=arch)
    jmodel, jparams, flat = jax_base(jcfg)
    jdms = [JC.compress(jparams, jax_tree(jparams, fine_tune_flat(
        flat, seed, scale=0.05))) for seed in (41, 42)]
    return {"arch": arch, "jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel,
            "jparams": jparams, "flat": flat, "model": build_model(tcfg),
            "params": bridge.params_from_numpy(flat, "cpu"),
            "tokens": np.random.default_rng(0).integers(
                1, jcfg.vocab_size, size=(3, PROMPT)),
            "jdms": jdms,
            "dms": [bridge.delta_model_from_numpy(delta_model_numpy(d),
                                                  "cpu") for d in jdms]}


_CACHE: dict = {}


@pytest.fixture(params=ARCHS)
def s(request):
    if request.param not in _CACHE:
        _CACHE[request.param] = _setup(request.param)
    return _CACHE[request.param]


def _batches(s):
    return ({"tokens": jnp.asarray(s["tokens"])},
            {"tokens": torch.from_numpy(s["tokens"])})


def _state_close(got, want):
    """Every leaf of a state tree within 1e-4 of its largest |value|;
    the same structure (JAX's ``None`` where a tree holds no caches)."""
    if want is None:
        assert got is None
        return
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _state_close(got[k], want[k])
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and str(got.dtype).endswith(
        str(want.dtype))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", ARCHS)
def test_config_fields_match_jax(name):
    for reduce in (False, True):
        want, got = get_config(name), TC.get_config(name)
        if reduce:
            want, got = want.reduced(), got.reduced()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_param_tree_matches_jax(s):
    got = {k: tuple(v.shape) for k, v in C.flatten_params(
        split(s["model"].init(0, device="cpu"))[0]).items()}
    assert got == {k: v.shape for k, v in s["flat"].items()}


def test_forward_logits_and_state_match(s):
    jb, tb = _batches(s)
    want, jaux = jax.jit(s["jmodel"].forward)(s["jparams"], jb)
    with torch.no_grad():
        got, aux = s["model"].forward(s["params"], tb)
    assert got.shape == (3, PROMPT, s["tcfg"].padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    _state_close(aux["state"], jaux["state"])


def _overlays(s, kind):
    """(JAX (params, overlay, vidx), port (params, overlay, vidx)) for no
    overlay, v0 fused, or a 4-slot bank over rows [0, v0, v1]."""
    if kind == "none":
        return (s["jparams"], None, None), (s["params"], None, None)
    if kind == "fused":
        jp, jov, _ = JL.device_put_overlay(s["jparams"], s["jdms"][0])
        p, ov, _ = L.device_put_overlay(s["params"], s["dms"][0])
        return (jp, jov, None), (p, ov, None)
    jbank, bank = JaxBank(s["jparams"], 4), OverlayBank(s["params"], 4)
    slots = []
    for i, (jdm, dm) in enumerate(zip(s["jdms"], s["dms"])):
        js, _ = jbank.admit(f"v{i}", jdm)
        assert bank.admit(f"v{i}", dm)[0] == js
        slots.append(js)
    vidx = [0] + slots
    return ((s["jparams"], jbank.tree, jnp.asarray(vidx, jnp.int32)),
            (s["params"], bank.tree, torch.tensor(vidx)))


def _jax_steps(jmodel):
    """JAX's prefill and decode step, jitted (eager JAX would run the
    Pallas kernels op by op in interpret mode)."""
    def prefill(p, b, ov, v):
        return jmodel.prefill(p, b, MAX_LEN, cache_dtype=jnp.float32,
                              overlay=ov, variant_idx=v)

    def decode(p, t, st, ov, v):
        return jmodel.decode_step(p, t, st, overlay=ov, variant_idx=v)
    return jax.jit(prefill), jax.jit(decode)


def _greedy(s, jside, tside):
    jb, tb = _batches(s)
    (jp, jov, jv), (p, ov, v) = jside, tside
    jprefill, jdecode = _jax_steps(s["jmodel"])
    jlast, jst = jprefill(jp, jb, jov, jv)
    with torch.no_grad():
        last, st = s["model"].prefill(p, tb, MAX_LEN,
                                      cache_dtype=torch.float32, overlay=ov,
                                      variant_idx=v)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4)
    jt = jnp.argmax(jlast, -1).astype(jnp.int32)
    t = torch.argmax(last, -1).to(torch.int32)
    for _ in range(STEPS):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        jlog, jst = jdecode(jp, jt, jst, jov, jv)
        with torch.no_grad():
            log, st = s["model"].decode_step(p, t, st, overlay=ov,
                                              variant_idx=v)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4)
        jt = jnp.argmax(jlog, -1).astype(jnp.int32)
        t = torch.argmax(log, -1).to(torch.int32)
    assert int(st["pos"][0]) == PROMPT + STEPS
    _state_close(st, jst)


@pytest.mark.parametrize("kind", ["none", "fused", "banked"])
def test_prefill_decode_greedy_tokens_identical(s, kind):
    jside, tside = _overlays(s, kind)
    _greedy(s, jside, tside)


def test_int8_base_greedy_tokens_and_bytes_identical(s):
    """The int8 base quantizes bit-equal (``shared.*`` unstacked), then
    serves JAX's tokens through a fused variant."""
    jq, _, jstats = JQ.quantize_base(s["jparams"])
    q, _, stats = Q.quantize_base(s["params"])
    assert stats == {k: jstats[k] for k in stats}
    for path, want in numpy_flat(jq).items():
        got = bridge.params_to_numpy(q)[path]
        if isinstance(want, dict):
            np.testing.assert_array_equal(got["q"], want["q"])
            np.testing.assert_array_equal(got["scale"].view(np.uint16),
                                          want["scale"].view(np.uint16))
    jp, jov, _ = JL.device_put_overlay(jq, s["jdms"][0])
    p, ov, _ = L.device_put_overlay(q, s["dms"][0])
    _greedy(s, (jp, jov, None), (p, ov, None))


def test_cache_layout_matches_jax(s):
    """``cache_batch_axes`` is JAX's state pspecs' batch axis, leaf for
    leaf, and the state trees match in structure and shape."""
    want_axes = jax.tree.map(lambda a: a.index("act_batch"),
                             s["jmodel"].cache_pspecs(),
                             is_leaf=lambda x: isinstance(x, tuple))
    assert s["model"].cache_batch_axes() == want_axes
    got = jax.tree.map(lambda a: tuple(a.shape),
                       s["model"].init_cache(3, MAX_LEN, device="cpu"))
    want = jax.tree.map(lambda a: tuple(a.shape),
                        s["jmodel"].init_cache(3, MAX_LEN))
    assert got == want
    assert jax.tree.structure(s["model"].cache_batch_axes()) == \
        jax.tree.structure(s["model"].init_cache(3, MAX_LEN, device="cpu"))


def test_zamba_prefill_caches_the_projected_kv_bit_for_bit(monkeypatch):
    """The port projects each application point's q/k/v once in prefill
    (JAX twice): projecting the same input again gives the cached k/v bit
    for bit, and every application point's cache holds it."""
    s = _CACHE.get("zamba2-7b") or _setup("zamba2-7b")
    seen = []
    project = Z._shared_qkv

    def twice(p, h2, cfg, positions, ov=None, vidx=None):
        out = project(p, h2, cfg, positions, ov=ov, vidx=vidx)
        again = project(p, h2, cfg, positions, ov=ov, vidx=vidx)
        assert all(torch.equal(a, b) for a, b in zip(out, again))
        seen.append(out)
        return out

    monkeypatch.setattr(Z, "_shared_qkv", twice)
    p, ov, _ = L.device_put_overlay(s["params"], s["dms"][0])
    with torch.no_grad():
        _, st = s["model"].prefill(p, _batches(s)[1], MAX_LEN,
                                   cache_dtype=torch.float32, overlay=ov)
    assert len(seen) == Z._layout(s["tcfg"])[0] == 2
    for i, (_, k, v) in enumerate(seen):
        assert torch.equal(st["attn_kv"]["k"][i, :, :PROMPT], k)
        assert torch.equal(st["attn_kv"]["v"][i, :, :PROMPT], v)


KW = dict(batch_size=2, prompt_len=PROMPT, max_len=MAX_LEN, bank_size=4)
BUDGETS = [2, 6, 3, 5, 1]


def _serve(dep, prompts, names):
    rids = [dep.submit(p, variant=names[i % len(names)],
                       max_new_tokens=BUDGETS[i % len(BUDGETS)])
            for i, p in enumerate(prompts)]
    dep.drain()
    return [dep.result(r).out_tokens for r in rids]


@pytest.mark.parametrize("scheduler,mode,base_dtype", [
    ("group", "dense", "fp"), ("group", "fused", "fp"),
    ("continuous", "fused", "fp"), ("continuous", "fused", "int8")])
def test_deployment_tokens_match_jax(s, scheduler, mode, base_dtype):
    kw = dict(KW, scheduler=scheduler, mode=mode, base_dtype=base_dtype)
    jdep = JaxDeployment(s["jmodel"], s["jparams"], **kw)
    dep = Deployment(s["model"], s["params"], device="cpu", **kw)
    for i, (jdm, dm) in enumerate(zip(s["jdms"], s["dms"])):
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
        for key in ("admitted", "retired", "prefills", "decode_steps",
                    "tokens_generated"):
            assert dep.metrics[key] == jdep.metrics[key], key
    jdep.close()


def test_artifacts_and_dense_load_identical_across_packages(s, tmp_path):
    """A published variant, byte for byte (zamba's ``shared.*`` carry a
    rank-0 ``use_row``), and the dense load of every target."""
    jdm, dm = s["jdms"][0], s["dms"][0]
    shared = [p for p in dm.deltas if p.startswith("shared.")]
    assert bool(shared) == (s["arch"] == "zamba2-7b")
    for p in shared:
        assert dm.deltas[p].use_row.dim() == 0
    fp = S.base_fingerprint(s["params"])
    assert fp == JS.base_fingerprint(s["jparams"])
    m_t = S.save_artifact(dm, tmp_path / "t", base_fp=fp, meta={"name": "r"})
    m_j = JS.save_artifact(jdm, tmp_path / "j", base_fp=fp,
                           meta={"name": "r"})
    for key in ("deltas", "extras", "files", "artifact_bytes",
                "base_fingerprint"):
        assert m_t[key] == m_j[key], key
    for a, b in zip(sorted((tmp_path / "t").iterdir()),
                    sorted((tmp_path / "j").iterdir())):
        assert a.name == b.name and a.read_bytes() == b.read_bytes(), a.name
    for src in ("t", "j"):
        got = S.load_artifact(tmp_path / src, expect_base_fp=fp)
        want = JS.load_artifact(tmp_path / src, expect_base_fp=fp)
        for path, w in want.deltas.items():
            for f in ("packed", "v_row", "v_col", "use_row"):
                np.testing.assert_array_equal(
                    bridge.to_numpy(getattr(got.deltas[path], f)),
                    np.asarray(getattr(w, f)))
    jview, _ = JL.apply_artifact(s["jparams"], jdm)
    view, _ = L.apply_artifact(s["params"], dm)
    want = JC.flatten_params(jview)
    for path, t in C.flatten_params(view).items():
        if path in dm.deltas:
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(want[path], np.float32),
                                       rtol=0, atol=1e-6, err_msg=path)


def test_e2e_calibrate_matches_jax(s):
    """Stage 3 over a stage-0 variant (the only calibration the JAX
    package runs on these families): 2 epochs over 2 batches at lr 1e-3.
    Each selected (row) scale within lr x steps of JAX's and moved alike
    (the two differ by under 1% of how far JAX's moved), the unread col
    scales unmoved, losses within 5%."""
    ft_flat = fine_tune_flat(s["flat"], 11)
    rng = np.random.default_rng(5)
    batches = [rng.integers(1, s["jcfg"].vocab_size, (2, 8))
               for _ in range(2)]
    jft = jax_tree(s["jparams"], ft_flat)
    jdm0 = JC.compress(s["jparams"], jft)
    jfwd = (lambda p, b: s["jmodel"].forward(p, b)[0])
    jb = [{"tokens": jnp.asarray(t)} for t in batches]
    jdm, jlosses = JC.e2e_calibrate(jfwd, s["jparams"], jdm0,
                                    [jfwd(jft, b) for b in jb], jb,
                                    epochs=EPOCHS, lr=LR)
    base, ft = s["params"], bridge.params_from_numpy(ft_flat, "cpu")
    dm0 = C.compress(base, ft)

    def fwd(p, b):
        return s["model"].forward(p, b)[0]
    tb = [{"tokens": torch.from_numpy(t)} for t in batches]
    with torch.no_grad():
        teacher = [fwd(ft, b) for b in tb]
    dm, losses = C.e2e_calibrate(fwd, base, dm0, teacher, tb, epochs=EPOCHS,
                                 lr=LR)
    want, got = delta_model_numpy(jdm), bridge.delta_model_to_numpy(dm)
    jstart = delta_model_numpy(jdm0)["deltas"]
    start = bridge.delta_model_to_numpy(dm0)["deltas"]
    assert sorted(got["deltas"]) == sorted(want["deltas"])
    bound = LR * EPOCHS * len(batches)
    for path, w in want["deltas"].items():
        g = got["deltas"][path]
        np.testing.assert_array_equal(g["packed"], w["packed"])
        # stage 0 selects the row axis everywhere; the col vectors are not
        # read, so neither package moves them
        assert g["use_row"].all() and w["use_row"].all()
        np.testing.assert_array_equal(g["v_col"], start[path]["v_col"])
        np.testing.assert_array_equal(w["v_col"], jstart[path]["v_col"])
        np.testing.assert_allclose(g["v_row"], w["v_row"], rtol=0,
                                   atol=bound, err_msg=path)
        moved = np.linalg.norm(w["v_row"] - jstart[path]["v_row"])
        assert moved > 0, path
        assert np.linalg.norm(g["v_row"] - w["v_row"]) <= 1e-2 * moved, path
    np.testing.assert_allclose(losses, jlosses, rtol=5e-2)
    assert len(losses) == EPOCHS * len(batches)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_launcher_runs_the_recurrent_archs_on_cpu(name, capsys):
    from repro_torch.launch import serve as SV
    SV.main(["--arch", name, "--reduced", "--variants", "2", "--requests",
             "4", "--new-tokens", "2", "--mode", "fused", "--scheduler",
             "continuous", "--device", "cpu"])
    assert "'tokens_generated': 8" in capsys.readouterr().out
