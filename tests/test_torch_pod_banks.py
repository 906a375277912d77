"""Pod-local overlay banks and affinity routing of the port, on the CPU:
the counterpart of the JAX package's ``tests/test_pod_banks.py``, case for
case.

Two tiers:

* host-only (a ``Mesh`` without processes): the bank rule's resolution
  against the JAX package's, the global slot convention of a one-pod bank,
  the refusals (a registry without a pod axis, speculative decoding,
  lanes that do not split over the pods, the launcher's argument errors,
  a lane slot outside its pod's range), and the MoE layer on a rank of
  pod 1 whose gathered rows carry pod 0's ids (the collectives stood in
  for): no row of pod 0 reaches the rank's bank, and the rank's rows
  equal the global bank's;
* one spawned (pod, data, model) = (2, 1, 2) gloo group of 4 ranks
  (``launch.mesh.start``, the rank side in ``tests/_mesh_ranks.py``),
  started by the module fixture while the parent runs the JAX package:
  every rank's greedy tokens under pod-local banks equal JAX's
  single-device continuous tokens and the global bank's on the same mesh
  (both kernel dispatch modes, sync and async admission, an int8 base);
  the router's hits and misses and the admission bytes in and across
  pods; the per-pod bank semantics; async admission's agreement (every
  rank commits each ticket at the same step, a failure on one rank fails
  it on every rank, no ticket no collective); the launcher with
  ``--pod-banks``; MoE (deepseek-moe-16b) under pod-local banks, its tokens
  JAX's and the global bank's, in both dispatch modes, sync and async, over
  fp32 and int8; ``warmup()`` on the pod mesh (JAX's outcome keys, each
  "eager", then JAX's tokens) and a compile cache the ranks share;
  the compressed cross-pod gradient exchange (``cross_pod_grad_mean``):
  each rank's packed signs and fp16 scales JAX's ``quantize``'s, its mean
  JAX's dequantized mean over the pods in rank order, bit for bit, and
  its bytes on the wire ``wire_bytes``'s.

Contract (DESIGN.md §17): pod-local banking is a layout and routing
decision, so the tokens are the global bank's whether a request was an
affinity hit or a miss; slot ids are global (pod p owns [p*size,
(p+1)*size), its base slot is p*size); an admission writes one pod's
ranks.
"""
import dataclasses
import pickle
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _port_helpers import (configs, delta_model_numpy, fine_tune_flat,
                           jax_base, jax_tree, train_data)
from repro.core import calibration as JC
from repro.distributed import sharding as JS
from repro.models import build_model as jax_build_model
from repro.models import delta_overlay as JDO
from repro.models.param import split as jax_split
from repro.serving import Deployment as JaxDeployment

import _mesh_ranks as R
from repro_torch import bridge
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as LM
from repro_torch.launch import serve as SV
from repro_torch.models import build_model
from repro_torch.models import delta_overlay as DO
from repro_torch.models.param import split
from repro_torch.serving import Deployment
from repro_torch.serving.variants import OverlayBank, VariantRegistry

jax.config.update("jax_platforms", "cpu")

ARCH = "deepseek-7b"
MOE = "deepseek-moe-16b"
SHAPE = (2, 1, 2)
NAMES = ("pod", "data", "model")
TIMEOUT_S = 300


def _fake_mesh(shape, names):
    class M:
        axis_names = names
        devices = np.empty(shape, object)
    return M()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pods")
    state = {}
    for arch in (ARCH, MOE):
        jcfg, _ = configs(num_layers=R.LAYERS.get(arch, 2), arch=arch)
        jmodel, jparams, flat = jax_base(jcfg)
        jdms = [JC.compress(jparams, jax_tree(jparams, fine_tune_flat(
            flat, seed, scale=0.05))) for seed in (41, 42)]
        state[arch] = {"jmodel": jmodel, "jparams": jparams, "jdms": jdms,
                       "ship": {"flat": flat, "dms": [delta_model_numpy(d)
                                                      for d in jdms]}}
    state["train"] = train_data(ARCH)
    path = str(tmp / "data.pkl")
    with open(path, "wb") as f:
        pickle.dump({**{a: state[a]["ship"] for a in (ARCH, MOE)},
                     f"train {ARCH}": state["train"]["ship"]}, f)
    group = LM.start(R.run, SHAPE, device="cpu", timeout_s=TIMEOUT_S,
                     args=(path, {"pods": True, "moe_pods": True,
                                  "warm": str(tmp / "compile-cache"),
                                  "cross_pod": True}),
                     threads=1)
    state.update(state[ARCH], group=group)
    yield state
    if "group results" not in state:
        try:
            group.join()
        except LM.RankFailure:
            pass


def _group(world) -> list:
    """Every rank's results (the group joined on first use)."""
    if "group results" not in world:
        try:
            world["group results"] = world["group"].join()
        except LM.RankFailure as e:
            world["group results"] = e
    if isinstance(world["group results"], Exception):
        raise world["group results"]
    return world["group results"]


def _ranks(world) -> list:
    """Every rank's pod checks."""
    return [g["pods"] for g in _group(world)]


_JAX_TOKENS: dict = {}


def _jax_tokens(world, base_dtype: str, arch: str = ARCH) -> list:
    """JAX's single-device continuous Deployment over the pod traffic."""
    if (arch, base_dtype) not in _JAX_TOKENS:
        w = world[arch]
        dep = JaxDeployment(w["jmodel"], w["jparams"],
                            base_dtype=base_dtype, **R.POD_DEP)
        for i, dm in enumerate(w["jdms"]):
            dep.publish(f"v{i}", dm)
        rids = [dep.submit(R.POD_PROMPT, variant=v,
                           max_new_tokens=R.POD_NEW_TOKENS)
                for v in R.POD_TRAFFIC]
        dep.drain()
        assert all(dep.result(r).status == "done" for r in rids)
        _JAX_TOKENS[(arch, base_dtype)] = [dep.result(r).out_tokens
                                           for r in rids]
        dep.close()
    return _JAX_TOKENS[(arch, base_dtype)]


def _port_setup(world):
    model = build_model(R.port_config(ARCH))
    _, axes = split(model.init(0, device="cpu"))
    params = bridge.params_from_numpy(world["ship"]["flat"], "cpu")
    return model, params, axes


# ---------------------------------------------------------------------------
# rule resolution (no processes)
# ---------------------------------------------------------------------------

_RULE_CASES = {
    # the bank over "pod" under pod-bank rules; replicated by default
    "pod sharded": ((2, 2, 2), NAMES, True, (10,), ("bank",), ("pod",)),
    "default replicated": ((2, 2, 2), NAMES, False, (10,), ("bank",),
                           (None,)),
    # no pod axis: the divisibility fallback skips the absent axis
    "no pod axis": ((2, 2), ("data", "model"), True, (10,), ("bank",),
                    (None,)),
    # 2 pods cannot split 7 slots: replicated, not an error
    "indivisible": ((2, 2, 2), NAMES, True, (7,), ("bank",), (None,)),
    # lanes block-partition pod-major
    "act_batch": ((2, 2, 2), NAMES, False, (8,), ("act_batch",),
                  (("pod", "data"),)),
}


@pytest.mark.parametrize("case", sorted(_RULE_CASES))
def test_bank_rule_resolution_equal_jax(case):
    shape, names, pods, dims, axes, want = _RULE_CASES[case]
    got = S.resolve_spec(dims, axes, S.rules_for("decode", pod_banks=pods),
                         S.Mesh(names, shape))
    jgot = JS.resolve_spec(dims, axes, JS.rules_for("decode",
                                                    pod_banks=pods),
                           _fake_mesh(shape, names))
    assert got == want == tuple(jgot)
    assert jgot == P(*want)


def _leaves(tree, prefix="") -> dict:
    """{path: spec tuple} of a spec tree (dicts and OverlayEntry nodes of
    either package)."""
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


def test_banked_overlay_specs_under_pod_rules_equal_jax():
    """Every leaf of a banked overlay resolves under the pod-bank rules as
    in JAX: the bank axis over "pod", the weight's axes beside it."""
    jcfg, _ = configs(num_layers=2, arch=ARCH)
    jshapes, jaxes = jax_split(jax.eval_shape(
        jax_build_model(jcfg).init, jax.random.PRNGKey(0)))
    _, taxes = split(build_model(R.port_config(ARCH)).init(0, device="cpu"))
    flat = JC.flatten_params(jshapes)
    deltas = sorted(p for p, a in flat.items() if JC.is_target(p, a))
    extras = sorted(set(flat) - set(deltas))
    jm, tm = _fake_mesh(SHAPE, NAMES), S.Mesh(NAMES, SHAPE)
    js = JDO.overlay_struct(flat, deltas, extras, bank_size=8)
    ts = DO.overlay_struct({p: a.shape for p, a in flat.items()}, deltas,
                           extras, bank_size=8)
    want = _leaves(JS.tree_pspecs(
        js, JDO.overlay_pspecs(jaxes, deltas, extras, bank=True),
        JS.rules_for("decode", pod_banks=True), jm))
    got = _leaves(S.tree_pspecs(
        ts, DO.overlay_pspecs(taxes, deltas, extras, bank=True),
        S.rules_for("decode", pod_banks=True), tm))
    assert got == want and len(got) == 3 * len(deltas) + len(extras)
    assert all("pod" in spec for spec in got.values())


# ---------------------------------------------------------------------------
# bank and registry on the host
# ---------------------------------------------------------------------------

def test_global_slot_convention_host_only(world):
    model, params, _ = _port_setup(world)
    dm = bridge.delta_model_from_numpy(world["ship"]["dms"][0], "cpu")
    bank = OverlayBank(params, 4, pods=1)
    s1, p1 = bank.admit("a@v1", dm)
    assert s1 == 1 and p1 > 0
    assert bank.base_slot() == 0
    assert bank.slot_of("a@v1") == 1
    assert bank.admit("a@v1", None) == (1, 0)       # an LRU touch
    assert bank.stats["admit_bytes_in_pod"] == p1
    assert bank.stats["admit_bytes_cross_pod"] == 0


def test_registry_pod_banks_requires_pod_mesh(world):
    _, params, axes = _port_setup(world)
    with pytest.raises(ValueError, match="pod"):
        VariantRegistry(params, pod_banks=True)         # no mesh at all
    mesh = S.Mesh(("data", "model"), (1, 2))
    specs = S.tree_pspecs(params, axes, S.rules_for("decode"), mesh)
    with pytest.raises(ValueError, match="no 'pod' axis"):
        VariantRegistry(S.place(params, specs, mesh), pod_banks=True,
                        mesh=mesh, param_shardings=specs, param_axes=axes)


_REFUSALS = {
    "speculative": (SHAPE, dict(speculative=True), ValueError,
                    "speculative"),
    "no pod axis": ((1, 2), {}, ValueError, "no 'pod' axis"),
    "batch": (SHAPE, dict(batch_size=3), ValueError, "divide"),
    "lanes": ((2, 2, 1), dict(batch_size=2), ValueError,
              "pod and data axes"),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_pod_banks_refusals(world, case):
    """What pod-local banks do not serve raises before any collective (a
    mesh object without processes), naming why."""
    shape, kw, exc, match = _REFUSALS[case]
    names = NAMES if len(shape) == 3 else ("data", "model")
    mesh = S.Mesh(names, shape)
    arch = kw.pop("arch", ARCH)
    model = build_model(R.port_config(arch))
    params, axes = split(model.init(0, device="cpu"))
    kw = {"batch_size": 4, **kw}
    with pytest.raises(exc, match=match):
        Deployment(model, params, device="cpu", mesh=mesh, param_axes=axes,
                   graphs=False, pod_banks=True, **kw)


_ARG_ERRORS = {
    "no mesh": [],
    "two-value mesh": ["--mesh", "1,2"],
    "group scheduler": ["--mesh", "2,1,2", "--scheduler", "group"],
    "speculative": ["--mesh", "2,1,2", "--scheduler", "continuous",
                    "--speculative"],
}


@pytest.mark.parametrize("case", sorted(_ARG_ERRORS) + ["bad mesh"])
def test_launcher_pod_banks_argument_errors(case, capsys):
    base = ["--arch", ARCH, "--reduced", "--mode", "fused", "--device",
            "cpu"]
    if case == "bad mesh":
        argv = base + ["--mesh", "2,x"]
        want = "POD,DATA,MODEL"
    else:
        argv = base + _ARG_ERRORS[case] + ["--pod-banks"]
        if "--scheduler" not in argv:
            argv += ["--scheduler", "continuous"]
        want = "--pod-banks"
    ap = SV._parser()
    with pytest.raises(SystemExit) as e:
        SV._mesh_shape(ap, ap.parse_args(argv))
    assert e.value.code == 2
    assert want in capsys.readouterr().err


def test_launcher_mesh_shapes():
    ap = SV._parser()
    base = ["--arch", ARCH]
    assert SV._mesh_shape(ap, ap.parse_args(base)) is None
    assert SV._mesh_shape(ap, ap.parse_args(base + ["--mesh", "1,2"])) \
        == (1, 2)
    assert SV._mesh_shape(ap, ap.parse_args(
        base + ["--mesh", "2,1,2", "--pod-banks", "--mode", "fused",
                "--scheduler", "continuous"])) == (2, 1, 2)


def test_lane_slot_outside_its_pod_raises_on_the_host(world):
    """The engine translates the lanes' global slot ids to their pod's
    bank once a step; a lane whose slot lies in another pod's range
    raises there, before any kernel sees it."""
    model, params, axes = _port_setup(world)
    dep = Deployment(model, params, device="cpu", mesh=S.Mesh(NAMES, SHAPE),
                     param_axes=axes, graphs=False, pod_banks=True,
                     **R.POD_DEP)
    eng = dep.engine
    assert list(eng._base_vidx) == [0, 0, 4, 4]
    assert list(eng._pod_local(np.array([0, 3, 4, 7], np.int32))) == [
        0, 3, 0, 3]
    with pytest.raises(ValueError, match=r"lane 1 \(pod 0\).*slot 4"):
        eng._pod_local(np.array([0, 4, 4, 5], np.int32))
    with pytest.raises(ValueError, match=r"lane 2 \(pod 1\).*\[4, 8\)"):
        eng._pod_local(np.array([0, 1, 2, 5], np.int32))


# ---------------------------------------------------------------------------
# the (2, 1, 2) group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", sorted(R.POD_RUNS))
def test_pod_banks_tokens_match_jax_and_global_bank(world, run):
    """Every rank serves JAX's single-device continuous tokens, and the
    global bank's on the same mesh, over the skewed traffic: both kernel
    dispatch modes, sync and async admission, an fp32 and an int8 base."""
    bd = "int8" if run.endswith("int8") else "fp"
    want = _jax_tokens(world, bd)
    assert [len(t) for t in want] == [R.POD_NEW_TOKENS] * len(want)
    for got in _ranks(world):
        res = got["runs"][run]
        assert res["status"] == ["done"] * len(want)
        assert res["tokens"] == want, (got["coords"], run)
        glob = got["runs"]["global int8" if bd == "int8" else "global"]
        assert res["tokens"] == glob["tokens"]


@pytest.mark.parametrize("run", sorted(r for r in R.POD_RUNS
                                       if r.startswith("pods")))
def test_pod_banks_affinity_and_admission_bytes(world, run):
    """The router reports 2 pods, hits (v0 re-routes warm) and misses
    (first touches), one of the two for each variant request; the bank's
    bytes and residents come per pod; a pod-local bank crosses no pod
    boundary on admission, a global one does on the same traffic.  Under
    async admission every request is routed at its first sight, before
    any variant lands, so each is a miss (the route sticks to it)."""
    n_variant = sum(v != "__base__" for v in R.POD_TRAFFIC)
    for got in _ranks(world):
        res = got["runs"][run]
        af = res["affinity"]
        assert af["pods"] == 2 and af["misses"] > 0
        assert af["hits"] + af["misses"] == n_variant
        assert (af["hits"] == 0) if "async" in run else (af["hits"] > 0)
        assert af["hit_rate"] == af["hits"] / (af["hits"] + af["misses"])
        assert sorted(res["bank_per_pod"]) == [0, 1]
        assert set(res["resident_per_pod"]) == {0, 1}
        assert res["admit_bytes"][0] > 0 and res["admit_bytes"][1] == 0
        glob = got["runs"]["global"]
        assert glob["affinity"]["pods"] == 1
        assert glob["admit_bytes"][1] == glob["admit_bytes"][0] > 0
        # a pod-local bank of bank_size slots a pod holds the global
        # bank's bytes on every rank: twice the variant slots in all
        assert res["bank_per_pod"] == glob["bank_per_pod"] or \
            run.endswith("int8")


def test_pod_banks_async_commits_agree(world):
    """Async admission under pod-local banks: every rank commits each
    (version, pod) ticket at the same decode step, also when the ranks
    load at different speeds and each version is bound for both pods, with
    the sync run's tokens."""
    ranks = _ranks(world)
    for key in ("pods async",):
        commits = [g["runs"][key]["commits"] for g in ranks]
        assert commits[0] and all(c == commits[0] for c in commits)
        assert all(g["runs"][key]["async_admits"] == len(commits[0])
                   for g in ranks)
    paced = [g["async"]["paced"] for g in ranks]
    assert all(p["commits"] == paced[0]["commits"] for p in paced)
    assert sorted((vkey, pod) for _, vkey, pod in paced[0]["commits"]) == [
        ("v0@v1", 0), ("v0@v1", 1), ("v1@v1", 0), ("v1@v1", 1)]
    assert all(p["tokens"] == ranks[0]["runs"]["pods"]["tokens"]
               for p in paced)
    assert all(p["agreements"] > 0 for p in paced)


def test_pod_banks_async_failure_on_one_rank_fails_everywhere(world):
    """A variant whose load fails on one rank of its pod fails its request
    on every rank, with that rank's error, and the ranks serve on in step;
    base traffic with no ticket live makes no agreement."""
    ranks = _ranks(world)
    fail = [g["async"]["failure"] for g in ranks]
    assert all(f == fail[0] for f in fail)
    statuses = [s for s, _, _ in fail[0]]
    assert statuses == ["done"] * 3 + ["failed", "done", "done"]
    assert "artifact unreadable on rank" in fail[0][3][1]
    assert all(g["async"]["base_agreements"] == 0 for g in ranks)


def test_pod_bank_per_pod_slots_and_eviction(world):
    """Per-pod slot tables of a 3-slot bank on every rank: global ids,
    per-pod base slots, per-pod pins and staging marks with their
    refusals, per-pod LRU; each rank writes its own pod's slot only."""
    for got in _ranks(world):
        b = got["bank"]
        pod = got["coords"][0]
        assert b["total_slots"] == 6 and b["base_slots"] == (0, 3)
        assert b["slots"] == (1, 4)
        # the rank writes the admission into its own pod alone
        assert b["payload"] == ((b["slot_bytes"], 0) if pod == 0
                                else (0, b["slot_bytes"]))
        assert b["wrote"]
        assert b["pods_holding"] == [0, 1] and b["slot_of_pod1"] == 4
        assert b["resident"] == ["a@v1"]
        assert b["pod_resident"] == {0: ["a@v1"], 1: ["a@v1"]}
        assert b["admit_bytes"] == (2 * b["slot_bytes"], 0)
        assert "pinned" in b["evict_pinned_pod0"]
        assert "pinned" in b["evict_pinned_any"]
        assert b["after_evict"] == [0]
        assert b["cleared"] is (True if pod == 1 else None)
        assert b["staging"] == (True, True, False)
        assert "staging" in b["evict_staging"]
        assert b["lru_slot"] in (1, 2) and b["lru_evictions"] == 1
        assert b["lru_holding"] in ([1], [0, 1])
        assert b["merged"]
        assert b["pod1_table"] == [("a@v1", 1)]


def test_per_device_and_per_pod_nbytes(world):
    """Each rank holds its pod's slot range of every leaf: per-rank bytes
    are even, and the per-pod rollup covers every rank."""
    for got in _ranks(world):
        b = got["bank"]
        assert len(b["per_device"]) == 4
        assert len(set(b["per_device"].values())) == 1
        assert sorted(b["per_pod"]) == [0, 1]
        assert sum(b["per_pod"].values()) == sum(b["per_device"].values())


def test_launcher_pod_banks_equals_one_process(world):
    """``launch.serve --mesh 2,1,2 --pod-banks`` serves, on every rank, the
    tokens of the same run in one process without a mesh."""
    argv = [a for a in R.POD_LAUNCH_ARGV
            if a not in ("--mesh", "2,1,2", "--pod-banks")]
    want = SV._serve(SV._parser().parse_args(argv), None,
                     time.perf_counter())
    assert len(want) == 6
    for got in _ranks(world):
        assert got["launcher"] == want


# ---------------------------------------------------------------------------
# MoE under pod-local banks; warmup and the compile cache on the pod mesh
# ---------------------------------------------------------------------------

def test_moe_rows_of_another_pod_never_reach_the_rank_bank(world,
                                                          monkeypatch):
    """The MoE layer on a rank of pod 1 whose capacity groups cross the
    lanes' split (the collectives stood in for by pod 0's rows): pod 0's
    and pod 1's banks hold different variants under the same local id.
    Pod 0's rows reach neither the rank's router slots nor its expert
    slots (-1) nor the shared experts' (the base slot), and the rank's
    rows equal the whole batch's over the global bank, whose ids name
    each pod's slots."""
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import _layer
    from repro_torch.core import calibration as C
    model, params, axes, dms = R.setup(MOE, world[MOE]["ship"])
    cfg = model.cfg
    p = _layer(params["layers"], 0)["moe"]
    trees = []
    for dm in (dms[0], dms[1]):        # pod 0: v0 at 1; pod 1: v1 at 1
        bank = OverlayBank(params, 2)
        bank.admit("v", dm)
        trees.append(_layer(bank.tree["layers"], 0)["moe"])

    def cat(a, b):
        if isinstance(a, dict):
            return {k: cat(a[k], b[k]) for k in a}
        if isinstance(a, DO.OverlayEntry):
            return DO.OverlayEntry(*(torch.cat([getattr(a, f), getattr(b, f)])
                                     for f in ("packed", "v_row", "v_col")))
        return torch.cat([a, b])
    glob = cat(*trees)
    gen = torch.Generator().manual_seed(3)
    b, seq = 2, 5
    x = torch.randn((2 * b, seq, cfg.d_model), generator=gen)
    local = torch.tensor([1, 0, 1, 0], dtype=torch.int32)   # each pod's ids
    want, _ = M._moe(p, x, cfg, glob, local + torch.tensor([0, 0, 2, 2],
                                                           dtype=torch.int32))
    mesh = S.Mesh(NAMES, (2, 1, 1), coords=(1, 0, 0))
    inner_router, inner_moe = M._router_logits, M._moe
    inner_mlp, inner_gather = M.mlp_apply, S.all_gather
    # pod 0's blocks of what the rank gathers over the lanes' axes: its
    # rows, their ids and their scores from pod 0's router slots
    pod0 = {torch.float32: lambda t: (
        x[:b] if t.shape[-1] == cfg.d_model else
        inner_router(p, x[:b], trees[0], local[:b])),
        torch.int32: lambda t: local[:b]}
    seen = {"router": [], "moe": [], "shared": []}

    def gather(t, axis, dim, mesh=None):
        if S._names(axis) != ("pod", "data"):
            return inner_gather(t, axis, dim, mesh)
        return torch.cat([pod0[t.dtype](t), t], dim=dim)

    def router(p_, x_, ov, vidx):
        seen["router"].append(vidx.clone())
        return inner_router(p_, x_, ov, vidx)

    def moe(p_, x_, cfg_, ov, vidx, logits=None):
        seen["moe"].append(vidx.clone())
        return inner_moe(p_, x_, cfg_, ov, vidx, logits)

    def mlp(p_, x_, ov=None, vidx=None, ffn_ax="ffn"):
        seen["shared"].append(vidx.clone())
        return inner_mlp(p_, x_, ov=ov, vidx=vidx, ffn_ax=ffn_ax)
    monkeypatch.setattr(S, "all_gather", gather)
    monkeypatch.setattr(M, "_router_logits", router)
    monkeypatch.setattr(M, "_moe", moe)
    monkeypatch.setattr(M, "mlp_apply", mlp)
    rules = S.rules_for("decode", pod_banks=True)
    lay = S.Layout.from_params(
        {k: tuple(t.shape) for k, t in C.flatten_params(params).items()},
        DO.flatten_axes(axes), mesh, rules)
    with S.shard_ctx(mesh, rules, lay, ("pod", "data")):
        got, _ = M.moe_apply(p, x[b:], cfg, ov=trees[1], vidx=local[b:])
    assert [v.tolist() for v in seen["router"]] == [local[b:].tolist()]
    assert [v.tolist() for v in seen["moe"]] == [[-1, -1, 1, 0]]
    assert all(v.min() >= 0 and v.reshape(-1)[:b * seq].eq(0).all()
               for v in seen["shared"]) and seen["shared"]
    torch.testing.assert_close(got, want[b:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("run", sorted(R.POD_RUNS))
def test_moe_pod_banks_tokens_match_jax_and_global_bank(world, run):
    """deepseek-moe-16b under pod-local banks on (2, 1, 2): every rank
    serves JAX's single-device continuous tokens and the global bank's on
    the same mesh, over both dispatch modes, sync and async admission, an
    fp32 and an int8 base; every budget is met; a pod-local bank admits
    nothing across pods."""
    bd = "int8" if run.endswith("int8") else "fp"
    want = _jax_tokens(world, bd, MOE)
    assert [len(t) for t in want] == [R.POD_NEW_TOKENS] * len(want)
    for got in _group(world):
        runs = got["moe pods"]
        res = runs[run]
        assert res["status"] == ["done"] * len(want)
        assert res["tokens"] == want, (got["coords"], run)
        assert res["tokens"] == runs["global int8" if bd == "int8"
                                     else "global"]["tokens"]
        if run.startswith("pods"):
            assert res["admit_bytes"][0] > 0 and res["admit_bytes"][1] == 0


def test_pod_mesh_warmup_keys_and_tokens_match_jax(world):
    """``warmup()`` on the (2, 1, 2) pod mesh: JAX's outcome keys for the
    continuous scheduler, each "eager"; then JAX's single-device tokens
    over the pod traffic."""
    jdep = JaxDeployment(world["jmodel"], world["jparams"], **R.POD_DEP)
    jdep.engine._get_exe = lambda kind, args: None
    want_keys = set(jdep.warmup())
    jdep.close()
    want = _jax_tokens(world, "fp")
    for got in _group(world):
        w = got["warm"]["continuous"]
        assert set(w["outcomes"]) == want_keys
        assert set(w["outcomes"].values()) == {"eager"}
        assert w["tokens"] == want, got["coords"]


def test_pod_mesh_ranks_share_one_compile_cache(world):
    """Four ranks over one fresh compile-cache directory: in turns, one
    build between them and three hits; all at once, each builds or hits;
    nothing corrupt, nothing quarantined."""
    ranks = _group(world)
    caches = [g["warm"]["continuous"]["cache"] for g in ranks]
    assert [c["builds"] for c in caches] == [1, 0, 0, 0]
    assert [c["hits"] for c in caches] == [0, 1, 1, 1]
    for g in ranks:
        race, report = g["warm"]["race"]
        assert report == "stand-in report"
        assert race["builds"] + race["hits"] == 1
        assert race["corrupt"] == race["env_mismatch"] == 0
        assert g["warm"]["quarantined"] == []


def test_cross_pod_grad_mean_equals_jax_quantized_mean(world):
    """``cross_pod_grad_mean`` over "pod" on (2, 1, 2), each pod's step-1
    gradients of its own batch: every compressible leaf's packed signs
    are JAX's ``quantize`` bytes and its fp16 scales JAX's bits; the mean
    equals JAX's mean of the pods' dequantized gradients in rank order
    (the plain mean for a leaf that is not compressible), bit for bit;
    the bytes a rank sent equal ``wire_bytes``'s sum."""
    import jax.numpy as jnp
    from repro.distributed import compression as JGC
    ranks = [g["cross pod"] for g in _group(world)]
    coords = [g["coords"] for g in _group(world)]
    for r, (got, c) in enumerate(zip(ranks, coords)):
        assert got["sent"] == got["wire"]
        for k, (packed, scale) in got["quantized"].items():
            jp, js = JGC.quantize(jnp.asarray(got["grads"][k]))
            np.testing.assert_array_equal(packed, np.asarray(jp))
            np.testing.assert_array_equal(scale.view(np.uint16),
                                          np.asarray(js).view(np.uint16))
        pods = [ranks[coords.index((p,) + c[1:])]["grads"]
                for p in range(SHAPE[0])]
        for k, mean in got["mean"].items():
            g = jnp.stack([jnp.asarray(p[k]) for p in pods])
            if JGC._compressible(g[0]):
                deq = jnp.stack([JGC.dequantize(*JGC.quantize(x),
                                                x.shape[-1]) for x in g])
                want = np.asarray(jnp.mean(deq, axis=0))
            else:
                want = np.asarray(jnp.mean(g, axis=0))
            np.testing.assert_array_equal(mean.view(np.uint32),
                                          want.view(np.uint32), err_msg=k)
