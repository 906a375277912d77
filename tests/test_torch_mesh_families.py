"""The audio, VLM, xLSTM and Zamba families under a mesh, and sequence-TP
attention, on spawned gloo ranks on the CPU.

The contract is the JAX package's own
(``tests/test_shard_map_dispatch.py:303-364``): sharding is a layout
change only.  Every rank of a (1, 2), (2, 2) or (1, 4) group serves the
greedy tokens of JAX's single-device ``Deployment`` — continuous and
group fused, per-rank kernels and their gathered twins — and its
prefill and decode logits lie within 1e-4·max(|logit|, 1) of JAX's and
of the unsharded port's, fused and banked.  On (1, 4) reduced zamba2-7b
and a 2-head xlstm-350m cut their 2 SSM or mLSTM heads over 4 ranks, and
xlstm-350m's fused sLSTM ``w_ff1`` splits 4 ways; a reduced starcoder2-3b with 6 q
heads on (1, 4) takes the sequence-TP branch (a prompt length that is a
multiple of 4), JAX's flat-``q_dim`` branch (one that is not) and the
decode at s = 1, which the port lays out alike (every head on every
rank).  The speculative scheduler serves every family on (1, 2) and
(2, 2), and the 2-head xlstm-350m and the 6-head config on (1, 4) (its
verify at T = k+1 rows takes "whole"): every rank serves JAX's
single-device continuous tokens, the variant's greedy chain, with the
same ladder snapshot.  The 6-head config trains under a mesh on (1, 4)
too (every head on every rank, the "whole" layout), held to JAX's
single-device train step.  One module fixture starts every group while the
parent runs JAX (``tests/_mesh_ranks.py``'s pattern); the rank side is
``tests/_mesh_family_ranks.py``.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_helpers import (configs, delta_model_numpy, fine_tune_flat,
                           jax_base, jax_train_reference, jax_tree,
                           train_data)
from repro.configs import get_config
from repro.core import calibration as JC
from repro.core import loader as JL
from repro.distributed import sharding as JS
from repro.kernels import dispatch as JD
from repro.models import build_model as jax_build_model
from repro.models import delta_overlay as JDO
from repro.models.param import split as jax_split
from repro.serving import Deployment as JaxDeployment
from repro.serving.variants import OverlayBank as JaxBank

import _mesh_family_ranks as F
import repro_torch.configs as TC
from repro_torch.core import calibration as C
from repro_torch.distributed import sharding as S
from repro_torch.kernels import dispatch as D
from repro_torch.kernels import ops as K
from repro_torch.launch import mesh as LM
from repro_torch.models import build_model
from repro_torch.models import delta_overlay as DO
from repro_torch.models import layers as LY
from repro_torch.models.param import split

jax.config.update("jax_platforms", "cpu")

SCHEDS = tuple(F.SCHEDULERS)
QUAD = ("zamba2-7b", "xlstm-350m", "xlstm-350m-2h")
TIMEOUT_S = 300
MESHES = {
    (1, 2): {"tokens": {a: SCHEDS for a in F.ARCHS}, "logits": F.ARCHS,
             "spec": F.ARCHS, "train": F.ARCHS},
    (2, 2): {"tokens": {a: SCHEDS for a in F.ARCHS}, "logits": F.ARCHS,
             "spec": F.ARCHS, "train": F.ARCHS},
    # reduced zamba2-7b and the 2-head xlstm-350m: 2 SSM or mLSTM heads
    # over 4 ranks (a rank's block of d_inner cuts a head); xlstm-350m:
    # its fused w_ff1 cut 4 ways; the 6-head config: sequence-TP attention
    (1, 4): {"tokens": {a: SCHEDS for a in QUAD},
             "logits": QUAD, "seq": True,
             "spec": ("xlstm-350m-2h", F.SEQ_ARCH),
             "train": F.TRAIN_QUAD},
}
TOKEN_CASES = [(m, a, s, kd) for m, plan in MESHES.items()
               for a, scheds in plan["tokens"].items() for s in scheds
               for kd in F.KDS]
LOGIT_CASES = [(m, a, mode) for m, plan in MESHES.items()
               for a in plan["logits"] for mode in ("fused", "banked")]
SPEC_CASES = [(m, a, kd) for m, plan in MESHES.items() for a in plan["spec"]
              for kd in F.KDS]


def _ids(cases):
    return ["x".join(map(str, c[0])) + "-" + "-".join(map(str, c[1:]))
            for c in cases]


def _arch_data(case: str) -> dict:
    jcfg, _ = configs(arch=F.arch_of(case), **F.FIELDS[case])
    jmodel, jparams, flat = jax_base(jcfg)
    jdms = [JC.compress(jparams, jax_tree(jparams, fine_tune_flat(
        flat, seed, scale=0.05))) for seed in (41, 42)]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n)
               for n in (12, 7, 10, 12, 5, 9)]
    batch = {"tokens": rng.integers(1, jcfg.vocab_size,
                                    size=(F.BATCH, F.LOGIT_LEN))}
    if jcfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (F.BATCH, jcfg.encoder_frames, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (F.BATCH, jcfg.num_image_tokens, jcfg.d_model)).astype(
                np.float32)
    return {"jmodel": jmodel, "jparams": jparams, "jdms": jdms,
            "ship": {"flat": flat, "dms": [delta_model_numpy(d)
                                           for d in jdms],
                     "prompts": prompts, "batch": batch}}


class _Spawns:
    """Every mesh shape's group, started at once, joined on first use."""

    def __init__(self, path: str):
        self.groups, self.done = {}, {}
        for shape, plan in MESHES.items():
            self.groups[shape] = LM.start(
                F.run, shape, device="cpu", timeout_s=TIMEOUT_S,
                args=(path, plan), threads=1)

    def get(self, shape) -> list:
        if shape not in self.done:
            try:
                self.done[shape] = self.groups[shape].join()
            except LM.RankFailure as e:
                self.done[shape] = e
        got = self.done[shape]
        if isinstance(got, Exception):
            raise got
        return got

    def close(self) -> None:
        for shape in self.groups:
            if shape not in self.done:
                try:
                    self.get(shape)
                except LM.RankFailure:
                    pass


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    data = {a: _arch_data(a) for a in F.ARCHS + QUAD[2:] + (F.SEQ_ARCH,)}
    data.update({f"train {c}": train_data(F.arch_of(c), **fields)
                 for c, fields in F.TRAIN_FIELDS.items()})
    path = str(tmp / "data.pkl")
    with open(path, "wb") as f:
        pickle.dump({a: d["ship"] for a, d in data.items()}, f)
    spawns = _Spawns(path)
    yield {"data": data, "spawns": spawns}
    spawns.close()


_JAX_TOKENS: dict = {}


def _jax_tokens(world, arch: str, sched: str,
                prompt_len: int = F.PROMPT) -> list:
    """JAX's single-device Deployment over the same weights and requests
    (one run per arch, scheduler and prompt length, for every mesh)."""
    key = (arch, sched, prompt_len)
    if key not in _JAX_TOKENS:
        d = world["data"][arch]
        dep = JaxDeployment(d["jmodel"], d["jparams"], batch_size=F.BATCH,
                            prompt_len=prompt_len, max_len=F.MAX_LEN,
                            **F.SCHEDULERS[sched])
        for i, dm in enumerate(d["jdms"]):
            dep.publish(f"v{i}", dm)
        rids = [dep.submit(p, variant=F.NAMES[i % len(F.NAMES)],
                           max_new_tokens=F.BUDGETS[i % len(F.BUDGETS)])
                for i, p in enumerate(d["ship"]["prompts"])]
        dep.drain()
        _JAX_TOKENS[key] = [dep.result(r).out_tokens for r in rids]
        dep.close()
    return _JAX_TOKENS[key]


@pytest.mark.parametrize("shape,arch,sched,kd", TOKEN_CASES,
                         ids=_ids(TOKEN_CASES))
def test_family_tokens_on_mesh_match_jax_single_device(world, shape, arch,
                                                       sched, kd):
    want = _jax_tokens(world, arch, sched)
    assert [len(t) for t in want] == F.BUDGETS
    for got in world["spawns"].get(shape):
        assert got[("tokens", arch)][(kd, sched)] == want, got["coords"]


@pytest.mark.parametrize("shape,arch,kd", SPEC_CASES, ids=_ids(SPEC_CASES))
def test_family_speculative_tokens_on_mesh_match_jax_single_device(
        world, shape, arch, kd):
    """Speculative rounds under a mesh for every windowless family: the
    drafts on the base and the banked verify of T = k+1 tokens a lane run
    on the rank's lanes and heads (the recurrent families step T times and
    keep a snapshot a step; the 6 q heads on (1, 4) take "whole" in
    verify), and every rank serves JAX's single-device continuous tokens
    with the same ladder snapshot."""
    want = _jax_tokens(world, arch, "continuous")
    assert [len(t) for t in want] == F.BUDGETS
    ranks = world["spawns"].get(shape)
    for got in ranks:
        assert got[("spec", arch, kd)][0] == want, got["coords"]
    snaps = [g[("spec", arch, kd)][1] for g in ranks]
    assert all(sn == snaps[0] for sn in snaps) and snaps[0]["rounds"] > 0


_REF_LOGITS: dict = {}


def _jax_logits(d: dict, mode: str) -> tuple:
    """JAX single-device (prefill, decode) logits, jitted, fp32 caches."""
    model, params = d["jmodel"], d["jparams"]
    batch = {k: jnp.asarray(v) for k, v in d["ship"]["batch"].items()}
    if mode == "fused":
        params, ov, _ = JL.device_put_overlay(params, d["jdms"][0])
        vidx = None
    else:
        bank = JaxBank(params, 4)
        slots = [bank.admit(f"v{i}", dm)[0] for i, dm in enumerate(d["jdms"])]
        ov = bank.tree
        vidx = jnp.asarray([0, slots[0], slots[1], slots[0]], jnp.int32)
    pf = jax.jit(lambda p, o, v, b: model.prefill(
        p, b, F.MAX_LEN, cache_dtype=jnp.float32, overlay=o, variant_idx=v))
    dc = jax.jit(lambda p, o, v, t, c: model.decode_step(
        p, t, c, overlay=o, variant_idx=v))
    lg, cache = pf(params, ov, vidx, batch)
    dl, _ = dc(params, ov, vidx, jnp.argmax(lg, -1).astype(jnp.int32), cache)
    return np.asarray(lg), np.asarray(dl)


def _ref_logits(world, arch: str, mode: str) -> dict:
    if (arch, mode) not in _REF_LOGITS:
        d = world["data"][arch]
        _REF_LOGITS[(arch, mode)] = {
            "jax": _jax_logits(d, mode),
            "port": F.unsharded_logits(arch, d["ship"])[mode]}
    return _REF_LOGITS[(arch, mode)]


@pytest.mark.parametrize("shape,arch,mode", LOGIT_CASES,
                         ids=_ids(LOGIT_CASES))
def test_family_logits_on_mesh_match_jax_and_unsharded_port(world, shape,
                                                            arch, mode):
    """Prefill and one decode step's logits of every rank (its rows made
    whole) within 1e-4·max(|logit|, 1) of JAX's single-device and of the
    unsharded port's, with the same greedy tokens (the JAX
    ``test_family_logits_parity_per_shard_vs_global``)."""
    ref = _ref_logits(world, arch, mode)
    for got in world["spawns"].get(shape):
        for step, lg in enumerate(got[("logits", arch)][mode]):
            for want in (ref["jax"][step], ref["port"][step]):
                tol = 1e-4 * max(float(np.abs(want).max()), 1.0)
                assert float(np.abs(lg - want).max()) < tol, (
                    got["coords"], step)
                np.testing.assert_array_equal(lg.argmax(-1),
                                              want.argmax(-1))


@pytest.mark.parametrize("kd", F.KDS)
@pytest.mark.parametrize("prompt_len", F.SEQ_PROMPTS)
def test_sequence_tp_tokens_match_jax_single_device(world, prompt_len, kd):
    """6 q heads over a model axis of 4: the prefill attends each rank's
    q rows (a length that splits: sequence-TP) or every head on every
    rank (one that does not: JAX's flat-``q_dim`` branch, "whole" here),
    and decode every head (s = 1); every rank serves JAX's single-device
    tokens."""
    want = _jax_tokens(world, F.SEQ_ARCH, "continuous", prompt_len)
    assert [len(t) for t in want] == F.BUDGETS
    for got in world["spawns"].get((1, 4)):
        assert got["seq"][(kd, prompt_len)] == want, got["coords"]
        assert got["seq layouts"][prompt_len] == (
            {"seq", "whole"} if prompt_len % 4 == 0 else {"whole"})


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)],
                         ids=["1x2", "1x4"])
def test_sharded_rmsnorm_matches_whole(world, shape):
    """The rmsnorm over a feature dim the model axis splits (the fp32 sum
    of squares summed over the ranks) is within 1e-6 of the whole one."""
    for got in world["spawns"].get(shape):
        assert got["rmsnorm"] < 1e-6, got["coords"]


@pytest.mark.parametrize("shape", sorted(MESHES),
                         ids=["x".join(map(str, m)) for m in sorted(MESHES)])
def test_sharded_rmsnorm_backward_matches_whole(world, shape):
    """``layers.rmsnorm(part=)`` under grad (zamba's ``gate_norm`` in
    training): the rank's ``dx`` and ``dscale`` within 1e-6 of its blocks
    of the whole norm's gradients, relative to their largest |value| (the
    rowwise term summed over the ranks), and its forward without grad
    bit-identical to the forward-only formula."""
    for got in world["spawns"].get(shape):
        g = got["rmsnorm grad"]
        assert g["dx"] < 1e-6 and g["dscale"] < 1e-6, (got["coords"], g)
        assert g["forward bits"], got["coords"]


def test_head_split_branch_order():
    """``head_split`` follows the JAX ``qkv_project`` branch order on a
    model axis of 4 (no processes: resolution reads names and sizes)."""
    from repro_torch.models import attention as A
    mesh = S.Mesh(("data", "model"), (1, 4))
    cfg = F.port_config(F.SEQ_ARCH)
    with S.shard_ctx(mesh, S.rules_for("decode")):
        assert [A.head_split(cfg, s) for s in (12, 10, 1, None)] == [
            "seq", "whole", "whole", "whole"]
        assert A.local_kv_heads(cfg) == cfg.num_kv_heads
        assert A.head_split(dataclasses.replace(cfg, num_heads=8)) == "gqa"
        assert A.head_split(dataclasses.replace(
            cfg, num_heads=8, num_kv_heads=4)) == "heads"
    with S.shard_ctx(mesh, S.rules_for("train")):
        # not forward-only, and q_dim divides: JAX's flat shard
        assert A.head_split(cfg, 12) == "whole"
    assert A.head_split(cfg, 12) == "none"


@pytest.mark.parametrize("case", ["zamba2-7b", "xlstm-350m-2h"])
def test_quad_cases_cut_a_head_on_four_ranks(case):
    """On a model axis of 4 the (1, 4) group's 2-head cases split
    ``d_inner`` while a rank's block cuts a head, so every rank runs every
    head (``layers.head_block``); xlstm-350m's 4 heads do not."""
    mesh = S.Mesh(("data", "model"), (1, 4))
    for c, cut in ((case, True), ("xlstm-350m", False)):
        cfg = F.port_config(c)
        heads = cfg.ssm_heads or cfg.num_heads
        with S.shard_ctx(mesh, S.rules_for("decode")):
            part = LY.dim_part(2 * cfg.d_model, "ssm")
            assert part is not None, c
            assert (LY.head_block(heads, part) == (0, heads)) == cut, c


# ---------------------------------------------------------------------------
# no processes: resolution against JAX, the waxes drift guard
# ---------------------------------------------------------------------------

FULL_LAYERS = {"whisper-base": 2, "internvl2-76b": 2, "xlstm-350m": 8,
               "zamba2-7b": 7}
FAKE = {"2x2": (2, 2), "1x4": (1, 4)}


class _FakeMesh:
    axis_names = ("data", "model")

    def __init__(self, shape):
        self.devices = np.empty(shape, object)


_FULL: dict = {}


def _full(arch: str):
    """JAX full-width shapes and axes (eval_shape: nothing allocated)."""
    if arch not in _FULL:
        jcfg = dataclasses.replace(get_config(arch),
                                   num_layers=FULL_LAYERS[arch])
        _FULL[arch] = jax_split(jax.eval_shape(
            jax_build_model(jcfg).init, jax.random.PRNGKey(0)))
    return _FULL[arch]


def _leaves(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(_leaves(getattr(tree, f.name), f"{prefix}:{f.name}"))
    else:
        out[prefix] = tuple(tree)
    return out


@pytest.mark.parametrize("mesh", sorted(FAKE))
@pytest.mark.parametrize("arch", F.ARCHS)
def test_family_overlay_pspecs_equal_jax(arch, mesh):
    """Param, fused-overlay and bank axes of each family at full width —
    conv kernels, recurrent weights and per-head vectors included —
    resolve leaf for leaf as JAX's."""
    jshapes, jaxes = _full(arch)
    tcfg = dataclasses.replace(TC.get_config(arch).reduced(),
                               num_layers=FULL_LAYERS[arch])
    _, taxes = split(build_model(tcfg).init(0, device="cpu"))
    assert DO.flatten_axes(taxes) == JDO.flatten_axes(jaxes)
    jm, tm = _FakeMesh(FAKE[mesh]), S.Mesh(("data", "model"), FAKE[mesh])
    jr, tr = JS.rules_for("decode"), S.rules_for("decode")
    flat = JC.flatten_params(jshapes)
    deltas = sorted(p for p, a in flat.items() if JC.is_target(p, a))
    extras = sorted(set(flat) - set(deltas))
    for bank in (None, 4):
        ja = JDO.overlay_pspecs(jaxes, deltas, extras if bank else (),
                                bank=bank is not None)
        js = JDO.overlay_struct(flat, deltas, extras, bank_size=bank)
        ta = DO.overlay_pspecs(taxes, deltas, extras if bank else (),
                               bank=bank is not None)
        ts = DO.overlay_struct({p: a.shape for p, a in flat.items()},
                               deltas, extras, bank_size=bank)
        want = _leaves(JS.tree_pspecs(js, ja, jr, jm))
        got = _leaves(S.tree_pspecs(ts, ta, tr, tm))
        assert got == want and len(got) >= 3 * len(deltas)
        # a sharded non-matrix leaf (a conv kernel's channels) is the
        # rank's block; the per-head vectors are replicated
        if bank and arch in ("xlstm-350m", "zamba2-7b"):
            assert any("conv" in p and "model" in s for p, s in got.items())


@pytest.mark.parametrize("mesh", sorted(FAKE))
@pytest.mark.parametrize("arch", F.ARCHS)
def test_family_plan_matmul_equal_jax(arch, mesh):
    """Every projection's plan, waxes with a None side included
    ((ssm, None), (None, ssm), (None, embed), (ffn_small, embed))."""
    jshapes, jaxes = _full(arch)
    jm, tm = _FakeMesh(FAKE[mesh]), S.Mesh(("data", "model"), FAKE[mesh])
    fax = JDO.flatten_axes(jaxes)
    seen = set()
    for path, leaf in JC.flatten_params(jshapes).items():
        if not JC.is_target(path, leaf):
            continue
        n, k = leaf.shape[-2:]
        seen.add(tuple(fax[path][-2:]))
        for m in (None, 4, 64):
            want = JD.plan_matmul(jm, JS.rules_for("decode"), fax[path], m,
                                  n, k)
            got = D.plan_matmul(tm, S.rules_for("decode"), fax[path], m, n,
                                k)
            if want is None:
                assert got is None, (path, m)
                continue
            assert (got.m_part, got.o_part, got.i_part) == (
                want.m_part, want.o_part, want.i_part), (path, m)
    none_sides = {("ssm", None), (None, "ssm"), (None, "embed"),
                  ("ffn_small", "embed")}
    if arch in ("xlstm-350m", "zamba2-7b"):
        assert seen & none_sides


@pytest.mark.parametrize("arch", ("whisper-base", "xlstm-350m",
                                  "zamba2-7b"))
def test_family_waxes_literals_match_param_declarations(arch, monkeypatch):
    """Every axes tuple the family's call sites pass (into the delta
    kernels and the plain products) agrees with the ``Param.axes``
    declared at init for a weight of that shape; none is missing (the JAX
    ``test_waxes_literals_match_param_declarations``)."""
    from repro_torch.serving.variants import OverlayBank
    from repro_torch.core import loader as L
    model = build_model(F.port_config(arch))
    base, axes = split(model.init(0, device="cpu"))
    pert, _ = split(model.init(1, device="cpu"))
    fp = C.flatten_params(pert)
    dm = C.compress(base, C.unflatten_like(base, {
        k: v + 0.05 * fp[k] for k, v in C.flatten_params(base).items()}))
    flat_axes = DO.flatten_axes(axes)
    declared: dict = {}
    for p, w in C.flatten_params(base).items():
        if w.dim() >= 2:
            declared.setdefault(tuple(w.shape[-2:]), set()).add(
                tuple(flat_axes[p][-2:]))
    recorded = []
    orig, orig_ps = K._routed, LY._contracted_axes

    def probe(name, waxes, *args):
        recorded.append((name, tuple(args[-1].shape[-2:]), waxes))
        return orig(name, waxes, *args)

    def probe_ps(w, waxes):
        recorded.append(("plain", tuple(w.shape[-2:]), waxes))
        return orig_ps(w, waxes)
    monkeypatch.setattr(K, "_routed", probe)
    monkeypatch.setattr(LY, "_contracted_axes", probe_ps)
    cfg = model.cfg
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                                     size=(4, 8)))}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((4, cfg.encoder_frames, cfg.d_model))
    with torch.no_grad():
        pv, ov, _ = L.device_put_overlay(base, dm)
        lg, cache = model.prefill(pv, batch, 16, overlay=ov)
        model.decode_step(pv, lg.argmax(-1).to(torch.int32), cache,
                          overlay=ov)
        bank = OverlayBank(base, 3)
        s1, _ = bank.admit("v1", dm)
        model.prefill(base, batch, 16, overlay=bank.tree,
                      variant_idx=torch.tensor([0, s1, s1, 0]))
        model.prefill(base, batch, 16)
    kinds = {name for name, _, _ in recorded}
    assert {"bitlinear_axes", "bitlinear_axes_banked", "plain"} <= kinds
    for name, shape, waxes in recorded:
        assert waxes is not None, (name, shape)
        assert tuple(waxes) in declared[shape], (name, shape, waxes,
                                                 declared[shape])


TRAIN_CASES = [(m, c) for m, plan in MESHES.items()
               for c in plan.get("train", ())]
_JAX_TRAIN: dict = {}


@pytest.mark.parametrize("shape,case", TRAIN_CASES,
                         ids=["x".join(map(str, m)) + f"-{c}"
                              for m, c in TRAIN_CASES])
def test_mesh_train_steps_match_jax_single_device(world, shape, case):
    """Every family trained under a mesh: whisper-base (its encoder stack,
    the cross-attention's K/V from the replicated encoder output), the
    VLM (the replicated image rows in front of the embedding's psum),
    xLSTM (mLSTM's gates and out-norm scale entering the rank's heads,
    sLSTM's gathered ``w_ff1``) and Zamba (dt, ``a_log``, ``d_skip`` and
    B/C entering the rank's heads, ``gate_norm``'s split backward, the
    shared block's gradient summed over its application points) on (1, 2)
    and (2, 2); on (1, 4) the cases whose rank's block cuts a head (every
    head scanned on every rank) and the 6-head starcoder2-3b, whose q heads
    do not divide the model axis while ``q_dim`` does (the "whole"
    layout).  Every rank's metrics, step-1 gradients and final params
    within ``assert_train_matches``'s bar of JAX's single-device step (one
    reference a case, shared by its meshes; xLSTM's later metrics and
    step-1 gradients to ``TRAIN_LIMITS``), the metrics the same on every
    rank."""
    d = world["data"][f"train {case}"]
    if case not in _JAX_TRAIN:
        _JAX_TRAIN[case] = jax_train_reference(d["jmodel"],
                                               d["ship"]["batches"])
    ranks = world["spawns"].get(shape)
    for got in ranks:
        F.R.assert_train_matches(got[("train", case)], _JAX_TRAIN[case],
                                 F.TRAIN_LIMITS.get(case, (1e-5, 1e-5)))
        assert got[("train", case)]["metrics"] == \
            ranks[0][("train", case)]["metrics"]
