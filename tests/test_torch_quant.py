"""Port parity for the int8 base: quantization, the kernel wrappers' plain
versions over a QuantWeight, the no-overlay factored product, the model
forward and the three serving paths, against the JAX package (Pallas in
interpret mode, as tests/test_quantized_base.py runs it) on reduced
qwen3-8b (2 layers, fp32 compute), same weights and delta models.

Tolerances: int8 bytes and fp16 scale bits identical; GEMMs within 1e-5
(fp32 summation order); the fp16 dense reconstruction within one fp16 ulp
(one rounding of the same fp32 value); logits within 1e-4 with identical
greedy tokens; served tokens and byte accounting identical."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _port_helpers import (configs, delta_model_numpy,  # noqa: E402
                           fine_tune_flat, jax_base, jax_tree, numpy_flat)

from repro.core import calibration as JC  # noqa: E402
from repro.core import loader as JL  # noqa: E402
from repro.core import quantize as JQ  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.models import build_model as build_jax_model  # noqa: E402
from repro.models import layers as JLY  # noqa: E402
from repro.serving import Deployment as JaxDeployment  # noqa: E402
from repro.serving.variants import OverlayBank as JaxOverlayBank  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.core import loader as L  # noqa: E402
from repro_torch.core import quantize as Q  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as LY  # noqa: E402
from repro_torch.serving import Deployment  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.variants import (OverlayBank,  # noqa: E402
                                          VariantRegistry)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

KW = dict(batch_size=2, prompt_len=16, max_len=32)


def _t(a):
    return bridge.to_tensor(a, "cpu")


def _qpair(rng, *shape):
    """A QuantWeight of a random weight, built by both packages."""
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return JQ.quantize_weight(jnp.asarray(w)), Q.quantize_weight(_t(w))


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 24), (4, 16, 24), (2, 3, 8, 16)])
def test_quantize_weight_is_bit_identical(shape):
    rng = np.random.default_rng(len(shape))
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    w.reshape(-1, shape[-1])[0] = 0.0              # an all-zero channel
    w.reshape(-1)[1] = 0.5 * w.reshape(-1)[2]      # some ties to round
    jq = JQ.quantize_weight(jnp.asarray(w))
    tq = Q.quantize_weight(_t(w))
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float16
    assert tq.shape == shape and tq.scale.shape == shape[:-1]
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy().view(np.uint16),
                                  np.asarray(jq.scale).view(np.uint16))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.float16, jnp.float16)):
        np.testing.assert_array_equal(
            Q.dequantize(tq, dt).numpy(),
            np.asarray(JQ.dequantize(jq, jdt)))
    assert tq.nbytes() == jq.nbytes()


def test_quant_weight_duck_types_and_is_one_leaf():
    rng = np.random.default_rng(1)
    _, qw = _qpair(rng, 3, 16, 24)
    assert Q.is_quant(qw) and not Q.is_quant(qw.q)
    assert (qw.ndim, qw.dim(), qw.dtype, qw.device) == (
        3, 3, torch.int8, torch.device("cpu"))
    assert C.is_target("layers.attn.wq", qw)
    flat = C.flatten_params({"layers": {"attn": {"wq": qw}}})
    assert list(flat) == ["layers.attn.wq"] and flat["layers.attn.wq"] is qw
    leaves = tree_leaves({"w": qw})
    assert len(leaves) == 2 and leaves[0] is qw.q and leaves[1] is qw.scale
    layer = tree_map(lambda a: a[1], qw)           # the model's layer view
    assert Q.is_quant(layer) and torch.equal(layer.q, qw.q[1])
    assert layer.scale.is_contiguous() and torch.equal(layer.scale,
                                                       qw.scale[1])


def test_quantize_base_matches_jax():
    jcfg, _ = configs(num_layers=2)
    _, jparams, flat = jax_base(jcfg)
    jq, jsh, jstats = JQ.quantize_base(jparams)
    tq, tsh, tstats = Q.quantize_base(bridge.params_from_numpy(flat, "cpu"))
    assert jsh is None and tsh is None
    assert tstats == jstats and tstats["targets"] == 7   # stacks
    assert tstats["ratio"] < 0.3
    want, got = numpy_flat(jq), bridge.params_to_numpy(tq)
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        if isinstance(w, dict):
            np.testing.assert_array_equal(got[path]["q"], w["q"])
            np.testing.assert_array_equal(got[path]["scale"].view(np.uint16),
                                          w["scale"].view(np.uint16))
        else:
            np.testing.assert_array_equal(got[path], w)
    # the bridge carries a JAX QuantWeight across unchanged
    crossed = bridge.params_from_numpy(want, "cpu")
    qw = crossed["layers"]["mlp"]["w_up"]
    assert Q.is_quant(qw)
    assert torch.equal(qw.q, tq["layers"]["mlp"]["w_up"].q)


def test_quantize_base_upgrades_shardings_as_jax():
    """With a spec tree (resolved for a (1, 2) mesh) ``quantize_base``
    returns it upgraded as JAX's returns its NamedSharding tree: each
    target a QuantWeight of the payload's and the scale's specs, every
    other leaf as it was; the bytes and stats are those without it."""
    from repro.distributed import sharding as JS
    from repro.models.param import split as jax_split
    from repro_torch.distributed import sharding as S
    from repro_torch.models.param import split
    jcfg, tcfg = configs(num_layers=2)
    _, jparams, flat = jax_base(jcfg)
    _, jaxes = jax_split(jax.eval_shape(
        build_jax_model(jcfg).init, jax.random.PRNGKey(0)))
    _, taxes = split(build_model(tcfg).init(0, device="cpu"))
    params = bridge.params_from_numpy(flat, "cpu")
    mesh = S.Mesh(("data", "model"), (1, 2))
    specs = S.tree_pspecs(params, taxes, S.rules_for("decode"), mesh)
    # a one-device mesh of the same axis names holds the (1, 2) specs
    one = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                            ("data", "model"))

    class _Fake:
        axis_names = ("data", "model")
        devices = np.empty((1, 2), object)
    jsh = jax.tree.map(lambda p: jax.sharding.NamedSharding(one, p),
                       JS.tree_pspecs(jparams, jaxes, JS.rules_for("decode"),
                                      _Fake()),
                       is_leaf=lambda x: isinstance(
                           x, jax.sharding.PartitionSpec))
    jq, jqsh, jstats = JQ.quantize_base(jparams, jsh)
    tq, tqsh, tstats = Q.quantize_base(params, specs)
    assert tstats == jstats
    got = _spec_leaves(tqsh)
    n = 0
    for path, jl in JC.flatten_params(jqsh).items():
        if isinstance(jl, JQ.QuantWeight):
            n += 1
            assert got[path] == Q.QuantWeight(q=tuple(jl.q.spec),
                                              scale=tuple(jl.scale.spec))
        else:
            assert got[path] == tuple(jl.spec), path
    assert n == tstats["targets"] == 7
    plain, no_specs, _ = Q.quantize_base(params)
    assert no_specs is None
    tflat = C.flatten_params(tq)
    for path, w in C.flatten_params(plain).items():
        if Q.is_quant(w):
            assert torch.equal(w.q, tflat[path].q)
            assert torch.equal(w.scale, tflat[path].scale)


def _spec_leaves(spec_tree, prefix="") -> dict:
    """{path: spec or QuantWeight of specs} of a spec tree."""
    out = {}
    for k, v in spec_tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_spec_leaves(v, path) if isinstance(v, dict) else {path: v})
    return out


# ---------------------------------------------------------------------------
# kernel wrappers (plain versions here) over a QuantWeight
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(4,), (2, 3)])
@pytest.mark.parametrize("axis", ["row", "col"])
def test_bitlinear_axes_on_int8_base_matches_jax(lead, axis):
    n, k = 48, 64
    rng = np.random.default_rng(2)
    jqw, qw = _qpair(rng, n, k)
    packed = rng.integers(0, 256, (n, k // 8)).astype(np.uint8)
    vr = np.abs(rng.normal(size=n) * 0.01).astype(np.float16)
    vc = np.abs(rng.normal(size=k) * 0.01).astype(np.float16)
    (vr if axis == "col" else vc)[:] = 0
    x = rng.standard_normal(lead + (k,)).astype(np.float32)
    want = JK.bitlinear_axes(jnp.asarray(x), jnp.asarray(packed),
                             jnp.asarray(vr), jnp.asarray(vc), jqw)
    got = K.bitlinear_axes(_t(x), _t(packed), _t(vr), _t(vc), qw)
    assert got.shape == lead + (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("m,nbank", [(4, 3), (6, 5)])
def test_bitlinear_axes_banked_on_int8_base_matches_jax(m, nbank):
    n, k = 32, 64
    rng = np.random.default_rng(m + nbank)
    jqw, qw = _qpair(rng, n, k)
    packed = rng.integers(0, 256, (nbank, n, k // 8)).astype(np.uint8)
    v_row = (rng.normal(size=(nbank, n)) * 0.01).astype(np.float16)
    v_col = (rng.normal(size=(nbank, k)) * 0.01).astype(np.float16)
    packed[0], v_row[0], v_col[0] = 0, 0, 0        # slot 0 = base
    x = rng.standard_normal((m, k)).astype(np.float32)
    vidx = rng.integers(0, nbank, m).astype(np.int32)
    want = JK.bitlinear_axes_banked(
        jnp.asarray(x), jnp.asarray(vidx), jnp.asarray(packed),
        jnp.asarray(v_row), jnp.asarray(v_col), jqw)
    got = K.bitlinear_axes_banked(_t(x), _t(vidx), _t(packed), _t(v_row),
                                  _t(v_col), qw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["row", "col", "scalar"])
@pytest.mark.parametrize("quant", [False, True])
def test_bitlinear_matches_jax(mode, quant):
    n, k = 40, 64
    rng = np.random.default_rng(3)
    jqw, qw = _qpair(rng, n, k)
    wb = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    jw, tw = (jqw, qw) if quant else (jnp.asarray(wb), _t(wb))
    packed = rng.integers(0, 256, (n, k // 8)).astype(np.uint8)
    v = {"row": rng.normal(size=n), "col": rng.normal(size=k),
         "scalar": rng.normal(size=())}[mode]
    v = np.asarray(np.abs(v) * 0.01, np.float16)
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    want = JK.bitlinear(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(v),
                        jw, mode=mode)
    got = K.bitlinear(_t(x), _t(packed), _t(v), tw, mode=mode)
    assert got.shape == (2, 3, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["row", "col"])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_unpack_apply_on_int8_base_matches_jax(mode, lead):
    d_out, d_in = 24, 64
    rng = np.random.default_rng(4)
    jqw, qw = _qpair(rng, *lead, d_out, d_in)
    packed = rng.integers(0, 256, lead + (d_out, d_in // 8)).astype(np.uint8)
    v = np.abs(rng.normal(size=lead + ((d_out,) if mode == "row"
                                       else (d_in,))) * 0.01
               ).astype(np.float32)
    got = K.unpack_apply(_t(packed), _t(v), qw, mode=mode)
    assert got.dtype == torch.float16 and got.shape == qw.shape
    for i in np.ndindex(*lead):
        want = np.asarray(JK.unpack_apply(
            jnp.asarray(packed[i]), jnp.asarray(v[i]),
            JQ.QuantWeight(q=jqw.q[i], scale=jqw.scale[i]), mode=mode))
        assert want.dtype == np.float16
        g = got[i].numpy()
        ulp = np.spacing(np.abs(want)).astype(np.float32)
        assert (np.abs(g.astype(np.float32) - want.astype(np.float32))
                <= ulp).all()


def test_linear_without_overlay_factors_the_scale():
    rng = np.random.default_rng(5)
    jqw, qw = _qpair(rng, 40, 64)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    want = np.asarray(JLY.linear(jnp.asarray(x), jqw))
    got = LY.linear(_t(x), qw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    dense = _t(x) @ Q.dequantize(qw).T
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# model forward and serving over an int8 base
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs(num_layers=2)
    jmodel, jparams, flat = jax_base(jcfg)
    jdms = [JC.compress(jparams, jax_tree(jparams, fine_tune_flat(
        flat, s, scale=0.05))) for s in (31, 32)]
    jq, _, _ = JQ.quantize_base(jparams)
    rng = np.random.default_rng(6)
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel,
            "jparams": jparams, "jq": jq, "flat": flat, "jdms": jdms,
            "model": build_model(tcfg),
            "params": bridge.params_from_numpy(flat, "cpu"),
            "dms": [bridge.delta_model_from_numpy(delta_model_numpy(d), "cpu")
                    for d in jdms],
            "tokens": rng.integers(1, jcfg.vocab_size, size=(3, 10)),
            "prompts": [rng.integers(1, jcfg.vocab_size, size=n)
                        for n in (8, 16, 5, 12, 3)]}


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(np.abs(want).max(), 1.0))
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_int8_forward_plain_fused_banked_match_jax(setup):
    s = setup
    tq, _, _ = Q.quantize_base(s["params"])
    toks = {"tokens": jnp.asarray(s["tokens"])}
    ttoks = {"tokens": torch.from_numpy(s["tokens"])}
    # plain: no overlay, the factored product
    want, _ = s["jmodel"].forward(s["jq"], toks)
    got, _ = s["model"].forward(tq, ttoks)
    _close(got, want)
    # fused overlay over the int8 base
    jview, jov, _ = JL.device_put_overlay(s["jq"], s["jdms"][0])
    view, ov, _ = L.device_put_overlay(tq, s["dms"][0])
    assert view["layers"]["attn"]["wq"] is tq["layers"]["attn"]["wq"]
    want, _ = s["jmodel"].forward(jview, toks, overlay=jov)
    got, _ = s["model"].forward(view, ttoks, overlay=ov)
    _close(got, want)
    # banked: rows on base, v0, v1
    jbank, bank = JaxOverlayBank(s["jq"], 3), OverlayBank(tq, 3)
    for i in range(2):
        jbank.admit(f"v{i}", s["jdms"][i])
        bank.admit(f"v{i}", s["dms"][i])
    vidx = np.array([0, 1, 2], np.int32)
    want, _ = s["jmodel"].forward(s["jq"], toks, overlay=jbank.tree,
                                  variant_idx=jnp.asarray(vidx))
    got, _ = s["model"].forward(tq, ttoks, overlay=bank.tree,
                                variant_idx=torch.from_numpy(vidx))
    _close(got, want)


def test_int8_dense_load_matches_jax(setup):
    s = setup
    tq, _, _ = Q.quantize_base(s["params"])
    jp, _ = JL.apply_artifact(s["jq"], s["jdms"][1])
    for use_kernel in (True, False):
        tp, _ = L.apply_artifact(tq, s["dms"][1], use_kernel=use_kernel)
        want = JC.flatten_params(jp)
        got = C.flatten_params(tp)
        for path, w in want.items():
            w = np.asarray(w)
            g = bridge.to_numpy(got[path])
            assert g.dtype == w.dtype, path
            if path in s["dms"][1].deltas:
                assert g.dtype == np.float16
            np.testing.assert_allclose(g.astype(np.float32),
                                       w.astype(np.float32), rtol=0,
                                       atol=1e-3, err_msg=path)


RUNS = [("group", "dense"), ("group", "fused"), ("continuous", "fused")]


def _serve(dep, prompts, names):
    rids = [dep.submit(p, variant=names[i % len(names)],
                       max_new_tokens=[2, 4, 3][i % 3])
            for i, p in enumerate(prompts)]
    dep.drain()
    return [dep.result(r).out_tokens for r in rids]


@pytest.mark.parametrize("scheduler,mode", RUNS)
def test_int8_deployment_matches_jax(setup, scheduler, mode):
    s = setup
    jdep = JaxDeployment(s["jmodel"], s["jparams"], mode=mode,
                         scheduler=scheduler, bank_size=3, base_dtype="int8",
                         **KW)
    dep = Deployment(s["model"], s["params"], mode=mode, scheduler=scheduler,
                     bank_size=3, device="cpu", base_dtype="int8", **KW)
    reg, jreg = dep.registry, jdep.registry
    assert reg.base_fp == jreg.base_fp
    assert reg.base_fp == VariantRegistry(s["params"]).base_fp
    assert reg.quant_stats == jreg.quant_stats
    assert reg.base_nbytes() == jreg.base_nbytes()
    assert reg.base_per_device_nbytes() == {"cpu": reg.base_nbytes()}
    for i, (jdm, dm) in enumerate(zip(s["jdms"], s["dms"])):
        assert jdep.publish(f"v{i}", jdm) == dep.publish(f"v{i}", dm)
    # the JAX engine keys its compiled steps on the overlay's structure
    # only, so one JAX engine cannot serve an int8-base request (QuantWeight
    # params) after a dense variant (fp16 params), both without an overlay:
    # the dense case holds variants only (base requests: the fused case)
    names = ["v0", "v1"] if mode == "dense" else ["__base__", "v0", "v1"]
    want = _serve(jdep, s["prompts"], names)
    got = _serve(dep, s["prompts"], names)
    assert got == want
    for key in ("swaps", "hits", "evictions", "resident_bytes",
                "transferred_bytes"):
        assert dep.stats[key] == jdep.stats[key], key
    hbm, jhbm = dep.status()["hbm"], jdep.status()["hbm"]
    for key in ("base_dtype", "base_bytes", "bank_bytes"):
        assert hbm[key] == jhbm[key], key
    assert hbm["base_dtype"] == "int8"
    jdep.close()


def test_int8_bank_admit_evict(setup):
    s = setup
    reg = VariantRegistry(s["params"], mode="fused", bank_size=3,
                          base_dtype="int8")
    for i, dm in enumerate(s["dms"]):
        reg.set_version(f"v{i + 1}", None, dm)
    s1, s2 = reg.bank_resolve("v1"), reg.bank_resolve("v2")
    assert {s1, s2} == {1, 2}
    reg.evict("v1")
    assert reg.bank.resident() == ["v2"]
    assert reg.bank_resolve("v2") == s2
    assert reg.bank_resolve("v1") == s1
    eng = ServingEngine(s["model"], reg, scheduler="continuous", **KW)
    rids = [eng.submit(np.arange(1, 7), variant=v, max_new_tokens=4)
            for v in ("v1", "v2")]
    eng.run_until_drained()
    assert all(len(eng.result(r).out_tokens) == 4 for r in rids)


def test_unknown_base_dtype_raises(setup):
    with pytest.raises(ValueError):
        Deployment(setup["model"], setup["params"], device="cpu",
                   base_dtype="fp8", **KW)
    with pytest.raises(ValueError):
        VariantRegistry(setup["params"], base_dtype="int4")


def test_serve_launcher_int8_on_cpu(capsys):
    from repro_torch.launch import serve as SV
    SV.main(["--arch", "qwen3-8b", "--reduced", "--num-layers", "1",
             "--variants", "1", "--requests", "3", "--new-tokens", "2",
             "--mode", "fused", "--base-dtype", "int8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "int8 base: 7 targets, 147456 -> 37888 bytes (ratio 0.257)" in out
    assert "hbm: {'base_dtype': 'int8'" in out
    assert "'tokens_generated': 6" in out


def test_jax_leaves_of_quant_weight_are_q_and_scale():
    """The port's tree_leaves sees what jax.tree.leaves sees."""
    rng = np.random.default_rng(7)
    jqw, qw = _qpair(rng, 8, 16)
    jl = jax.tree.leaves({"w": jqw})
    tl = tree_leaves({"w": qw})
    assert [tuple(a.shape) for a in jl] == [tuple(t.shape) for t in tl]


def test_int8_group_dense_serves_base_and_variants_in_one_engine(setup):
    """The port's eager engine serves an int8-base request between dense
    variants (where one JAX engine cannot); base tokens equal those the
    fused-mode deployment serves from the same int8 base."""
    s = setup

    def run(mode):
        dep = Deployment(s["model"], s["params"], mode=mode,
                         scheduler="group", device="cpu", base_dtype="int8",
                         **KW)
        for i, dm in enumerate(s["dms"]):
            dep.publish(f"v{i}", dm)
        return _serve(dep, s["prompts"], ["v0", "__base__", "v1"])

    dense, fused = run("dense"), run("fused")
    assert dense[1::3] == fused[1::3]
    assert all(len(t) == [2, 4, 3][i % 3] for i, t in enumerate(dense))
