"""Mesh-sharded serving of the port on spawned gloo ranks, on the CPU.

Each mesh shape is ONE spawned group (``launch.mesh.start``) that runs
every rank-side check of the module (``tests/_mesh_ranks.run``) while the
parent runs the JAX package; the tests then assert on what the ranks sent
back.  The groups start when the module's data fixture is built and are
joined on first use, each with its own deadline, so a hung group fails
its own tests and never the suite's time limit.

Contracts (the JAX package's own mesh tests, ``tests/test_sharded_serving
.py:1-13`` and ``tests/test_shard_map_dispatch.py:303-310``): sharding is
a layout change only — a sharded Deployment serves the greedy tokens of
JAX's single-device Deployment on every rank, for both kernel dispatch
modes, over an fp32 and an int8 base — and each rank launches its kernels
on its own tiles, within the GEMM bound of the unsharded op.  Over an int8
base every rank's q and scale blocks are the blocks of JAX's single-device
``quantize_base``, bit for bit, row-parallel weights included.

The speculative scheduler serves under (1, 2) and (2, 2) too: its tokens
are the variant's greedy chain, so every rank serves JAX's single-device
continuous tokens, whatever k the ladder walks, and every rank reports
the same ladder snapshot.  ``warmup()`` runs on (1, 2) with JAX's outcome
keys, every outcome "eager", and the ranks load a compile cache they
share without a corrupt entry.

Training rides the same groups: ``make_train_step(param_axes=)`` under
``rules_for("train")`` takes 3 steps of deepseek-7b and deepseek-moe-16b
on (1, 2), (2, 1) and (2, 2) and of qwen3-8b (the GQA layout) on (1, 4),
each held to one JAX single-device run per arch
(``_mesh_ranks.assert_train_matches``); on (2, 2) a drop to (1, 2)
after 2 steps continues with the uninterrupted losses.
"""
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_helpers import (configs, delta_model_numpy, fine_tune_flat,
                           jax_base, jax_train_reference, jax_tree,
                           train_data)
from repro.core import calibration as JC
from repro.core import loader as JL
from repro.core import quantize as JQ
from repro.serving import Deployment as JaxDeployment

import _mesh_ranks as R
from repro_torch import bridge
from repro_torch.core import loader as L
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as LM
from repro_torch.launch import serve as SV
from repro_torch.models import build_model

jax.config.update("jax_platforms", "cpu")

ARCHS = ("deepseek-7b", "deepseek-moe-16b")
KDS = ("shard_map", "gspmd")
TIMEOUT_S = 300
MESHES = {
    (1, 2): {"dispatch": True, "logits": ARCHS, "bank": True,
             "tokens": {a: tuple(R.SCHEDULERS) for a in ARCHS},
             "int8": R.INT8_RUNS, "launcher": True, "async": True,
             "spec": {"deepseek-7b": {**R.SPEC_RUNS, **R.SPEC_EXTRA},
                      "deepseek-moe-16b": R.SPEC_RUNS},
             "train": ARCHS},
    (2, 1): {"logits": ARCHS,
             "tokens": {a: tuple(R.SCHEDULERS) for a in ARCHS},
             "train": ARCHS, "train_wide": ("deepseek-moe-16b",)},
    (2, 2): {"dispatch": True, "logits": ARCHS, "bank": True,
             "tokens": {a: tuple(R.SCHEDULERS) for a in ARCHS},
             "int8": R.INT8_RUNS,
             "spec": {a: R.SPEC_RUNS for a in ARCHS},
             "train": ARCHS, "drop": "deepseek-7b"},
    # reduced qwen3-8b keeps 4 q heads and 2 KV heads: under model=4 the
    # GQA branch (q heads sharded, K/V gathered) with a KV head cut over
    # two ranks
    (1, 4): {"dispatch": True, "logits": ("qwen3-8b",),
             "tokens": {"qwen3-8b": ("continuous", "group-fused")},
             "train": ("qwen3-8b",)},
}
TRAIN_ARCHS = ARCHS + ("qwen3-8b",)
TOKEN_CASES = [(m, a, s, kd) for m, plan in MESHES.items()
               for a, scheds in plan["tokens"].items() for s in scheds
               for kd in KDS]
LOGIT_CASES = [(m, a) for m, plan in MESHES.items() for a in plan["logits"]]
INT8_CASES = [(m, a, s, kd) for m, plan in MESHES.items()
              for a, scheds in plan.get("int8", {}).items() for s in scheds
              for kd in KDS]
INT8_MESHES = [m for m, p in MESHES.items() if p.get("int8")]
SPEC_CASES = [(m, a, label) for m, plan in MESHES.items()
              for a, runs in plan.get("spec", {}).items() for label in runs]
TRAIN_CASES = [(m, a) for m, plan in MESHES.items()
               for a in plan.get("train", ())]


def _arch_data(arch: str) -> dict:
    jcfg, _ = configs(num_layers=R.LAYERS.get(arch, 2), arch=arch)
    jmodel, jparams, flat = jax_base(jcfg)
    jdms = [JC.compress(jparams, jax_tree(jparams, fine_tune_flat(
        flat, seed, scale=0.05))) for seed in (41, 42)]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n)
               for n in (12, 7, 10, 12, 5, 9)]
    tokens = rng.integers(1, jcfg.vocab_size, size=(R.BATCH, 10))
    return {"jmodel": jmodel, "jparams": jparams, "jdms": jdms,
            "ship": {"flat": flat, "dms": [delta_model_numpy(d)
                                           for d in jdms],
                     "prompts": prompts, "tokens": tokens}}


class _Spawns:
    """Every mesh shape's group, started at once, joined on first use."""

    def __init__(self, path: str, store_root: str):
        self.groups, self.done = {}, {}
        for shape, plan in MESHES.items():
            plan = dict(plan)
            if shape == (1, 2):
                plan["store"] = store_root
                plan["warm"] = f"{store_root}-compile-cache"
            self.groups[shape] = LM.start(
                R.run, shape, device="cpu", timeout_s=TIMEOUT_S,
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
    tmp = tmp_path_factory.mktemp("mesh")
    data = {a: _arch_data(a) for a in ARCHS + ("qwen3-8b",)}
    data.update({f"train {a}": train_data(a) for a in TRAIN_ARCHS})
    data["train wide deepseek-moe-16b"] = {"ship": R.port_train_data(
        "deepseek-moe-16b", seq=R.WIDE_SEQ, steps=1)}
    path = str(tmp / "data.pkl")
    with open(path, "wb") as f:
        pickle.dump({a: d["ship"] for a, d in data.items()}, f)
    spawns = _Spawns(path, str(tmp / "store"))
    yield {"data": data, "spawns": spawns, "tmp": tmp}
    spawns.close()


_JAX_TOKENS: dict = {}


def _jax_tokens(world, arch: str, sched: str, base_dtype: str = "fp"
                ) -> list:
    """JAX's single-device Deployment over the same weights and
    requests."""
    key = (arch, sched, base_dtype)
    if key not in _JAX_TOKENS:
        d = world["data"][arch]
        dep = JaxDeployment(d["jmodel"], d["jparams"], batch_size=R.BATCH,
                            prompt_len=R.PROMPT, max_len=R.MAX_LEN,
                            base_dtype=base_dtype, **R.SCHEDULERS[sched])
        for i, dm in enumerate(d["jdms"]):
            dep.publish(f"v{i}", dm)
        names = R.names_for(sched, base_dtype)
        rids = [dep.submit(p, variant=names[i % len(names)],
                           max_new_tokens=R.BUDGETS[i % len(R.BUDGETS)])
                for i, p in enumerate(d["ship"]["prompts"])]
        dep.drain()
        _JAX_TOKENS[key] = [dep.result(r).out_tokens for r in rids]
        dep.close()
    return _JAX_TOKENS[key]


@pytest.mark.parametrize("shape,arch,sched,kd", TOKEN_CASES,
                         ids=["x".join(map(str, m)) + f"-{a}-{s}-{kd}"
                              for m, a, s, kd in TOKEN_CASES])
def test_mesh_deployment_tokens_match_jax_single_device(world, shape, arch,
                                                        sched, kd):
    want = _jax_tokens(world, arch, sched)
    assert [len(t) for t in want] == R.BUDGETS
    for r, got in enumerate(world["spawns"].get(shape)):
        assert got[("tokens", arch)][(kd, sched)] == want, (r, got["coords"])


@pytest.mark.parametrize("shape,arch,sched,kd", INT8_CASES,
                         ids=["x".join(map(str, m)) + f"-{a}-{s}-{kd}"
                              for m, a, s, kd in INT8_CASES])
def test_mesh_int8_tokens_match_jax_single_device(world, shape, arch, sched,
                                                  kd):
    """An int8 base under a mesh: each rank quantizes its blocks and its
    kernels run their int8 bodies on its tiles (or, gathered, on the whole
    payload and scale), and every rank serves JAX's single-device int8
    tokens."""
    want = _jax_tokens(world, arch, sched, "int8")
    assert [len(t) for t in want] == R.BUDGETS
    for got in world["spawns"].get(shape):
        assert got[("int8 tokens", arch)][(kd, sched)] == want, (
            got["coords"])


@pytest.mark.parametrize("shape", INT8_MESHES,
                         ids=["x".join(map(str, m)) for m in INT8_MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_int8_blocks_equal_jax_quantize_base(world, shape, arch):
    """Every rank's q and scale blocks of a column-parallel weight, a
    row-parallel one (its row absmax all-reduced over the model axis) and
    an expert stack are the blocks of JAX's single-device
    ``quantize_base``, bit for bit; the scale's placement is the
    payload's without its in dim; ``quant_stats`` counts the global
    leaves, as JAX's do."""
    jq, _, jstats = JQ.quantize_base(world["data"][arch]["jparams"])
    jflat = JC.flatten_params(jq)
    in_sharded = 0
    for got in world["spawns"].get(shape):
        mine = got[("int8 blocks", arch)]
        assert mine["stats"] == jstats
        mesh = S.Mesh(("data", "model"), shape, coords=got["coords"])
        for path, (spec, q, scale) in mine["blocks"].items():
            want_q = np.asarray(jflat[path].q)
            want_s = np.asarray(jflat[path].scale)
            np.testing.assert_array_equal(
                q, want_q[S.block_slices(want_q.shape, spec, mesh)])
            np.testing.assert_array_equal(
                scale.view(np.uint16), want_s.view(np.uint16)[
                    S.block_slices(want_s.shape, spec[:-1], mesh)])
            in_sharded += spec[-1] is not None
    assert in_sharded > 0


def test_launcher_updates_int8_on_mesh_equal_one_process(world):
    """``launch.serve`` over an int8 base with ``--updates 1`` on (1, 2)
    (inside the group): every rank serves the single-process run's
    tokens, update and rollback waves included."""
    import time
    want = SV._serve(SV._parser().parse_args(R.LAUNCH_ARGV), None,
                     time.perf_counter())
    assert len(want) == 3 + 2 + 1
    for got in world["spawns"].get((1, 2)):
        assert got["launcher"] == want


_PORT_LOGITS: dict = {}


def _port_and_jax_logits(world, arch: str) -> dict:
    """Unsharded port and JAX logits, base and fused overlay."""
    if arch not in _PORT_LOGITS:
        d = world["data"][arch]
        model = build_model(R.port_config(arch))
        params = bridge.params_from_numpy(d["ship"]["flat"], "cpu")
        dm = bridge.delta_model_from_numpy(d["ship"]["dms"][0], "cpu")
        tokens = d["ship"]["tokens"]
        with torch.no_grad():
            base, _ = model.forward(params, {"tokens": torch.from_numpy(
                tokens)})
            pv, ov, _ = L.device_put_overlay(params, dm)
            fused, _ = model.forward(pv, {"tokens": torch.from_numpy(
                tokens)}, overlay=ov)
        jb = {"tokens": jnp.asarray(tokens)}
        jbase, _ = d["jmodel"].forward(d["jparams"], jb)
        jpv, jov, _ = JL.device_put_overlay(d["jparams"], d["jdms"][0])
        jfused, _ = d["jmodel"].forward(jpv, jb, overlay=jov)
        _PORT_LOGITS[arch] = {"port": {"base": base.numpy(),
                                       "fused": fused.numpy()},
                              "jax": {"base": np.asarray(jbase),
                                      "fused": np.asarray(jfused)}}
    return _PORT_LOGITS[arch]


@pytest.mark.parametrize("shape,arch", LOGIT_CASES,
                         ids=["x".join(map(str, m)) + f"-{a}"
                              for m, a in LOGIT_CASES])
def test_mesh_logits_match_unsharded_port_and_jax(world, shape, arch):
    ref = _port_and_jax_logits(world, arch)
    for got in world["spawns"].get(shape):
        for kind in ("base", "fused"):
            lg = got[("logits", arch)][kind]
            np.testing.assert_allclose(lg, ref["port"][kind], rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(lg, ref["jax"][kind], rtol=0,
                                       atol=1e-4)


DISPATCH_MESHES = [m for m, p in MESHES.items() if p.get("dispatch")]


@pytest.mark.parametrize("shape", DISPATCH_MESHES,
                         ids=["x".join(map(str, m)) for m in DISPATCH_MESHES])
def test_per_rank_dispatch_within_gemm_bound(world, shape):
    """Per-rank kernels (and their gathered twins) on row-sharded (wq),
    column-sharded (wo, w_down: the fp32 psum) weights, banked over three
    slots, expert-stacked over the local experts, and the per-tile
    ``unpack_apply`` (bit-exact: no contraction)."""
    for got in world["spawns"].get(shape):
        checks = got["dispatch"]
        kinds = {name.split()[0] for name in checks}
        assert kinds == {"axes", "banked", "unpack", "stacked"}
        for name, ratio in checks.items():
            if name.startswith("unpack"):
                assert ratio == 0.0, name
            else:
                assert ratio <= 1.0, (name, ratio)


BANK_MESHES = [m for m, p in MESHES.items() if p.get("bank")]


@pytest.mark.parametrize("shape", BANK_MESHES,
                         ids=["x".join(map(str, m)) for m in BANK_MESHES])
def test_bank_admit_evict_readmit_on_local_blocks(world, shape):
    for got in world["spawns"].get(shape):
        b = got["bank"]
        assert b["bank_blocks_equal"]
        assert b["slots"][0] == b["slots"][1]


@pytest.mark.parametrize("shape", BANK_MESHES,
                         ids=["x".join(map(str, m)) for m in BANK_MESHES])
def test_apply_update_patches_local_blocks(world, shape):
    for got in world["spawns"].get(shape):
        assert got["bank"]["update_blocks_equal"]
        assert got["bank"]["patched_modules"] > 0


@pytest.mark.parametrize("shape", BANK_MESHES,
                         ids=["x".join(map(str, m)) for m in BANK_MESHES])
def test_per_device_nbytes_per_rank(world, shape):
    """Each rank reports every rank's bank bytes, keyed by rank: its own
    blocks' bytes (blocks are even), which tile the whole bank over the
    model axis and repeat it over data."""
    ranks = world["spawns"].get(shape)
    n = shape[0] * shape[1]
    for got in ranks:
        b = got["bank"]
        assert b["per_device"] == {r: b["bank_nbytes"] for r in range(n)}
        assert b["bank_nbytes"] < b["whole_nbytes"]
        assert b["bank_nbytes"] * shape[1] >= b["whole_nbytes"]


_SINGLE_STORE: dict = {}


def _single_store(world) -> dict:
    """The store lifecycle in one process, without a mesh."""
    if not _SINGLE_STORE:
        _SINGLE_STORE.update(R.store_tokens(
            None, world["data"]["deepseek-7b"]["ship"],
            str(world["tmp"] / "single")))
    return _SINGLE_STORE


def test_store_lifecycle_on_mesh_writes_once(world):
    """publish, update (a patch), serve, rollback, serve through one store
    directory under (1, 2): rank 0 writes, both ranks read, and the
    tokens and versions are the single-process port's."""
    got = world["spawns"].get((1, 2))
    want = _single_store(world)
    for g in got:
        assert g["store"] == want
    assert want["versions"] == [1, 2] and want["rollback"] == 1
    store = world["tmp"] / "store" / "v0"
    assert sorted(p.name for p in store.iterdir()) == [
        "v0001", "v0002", "versions.json"]


def test_store_refusals_raise_on_every_rank(world):
    """A write the store refuses — a rollback to a version that does not
    exist, an update or a rollback of an unknown variant — raises rank
    0's error on every rank of (1, 2), as in one process, and the ranks
    then serve on in step."""
    got = world["spawns"].get((1, 2))
    want = _single_store(world)
    assert [r and r[0] for r in want["refused"]] == [
        "KeyError", "KeyError", "KeyError"]
    for g in got:
        assert g["store"]["refused"] == want["refused"]
        assert g["store"]["after_refusals"] == want["after_rollback"]


def test_rank_failure_ends_group_within_timeout():
    """A rank that raises (here: a world that is not the mesh's size)
    ends its group with an error well inside the deadline."""
    t0 = time.perf_counter()
    with pytest.raises(LM.RankFailure, match="needs 4 ranks"):
        LM.spawn(R.refuse_world, (1, 2), device="cpu", timeout_s=60,
                 threads=1)
    assert time.perf_counter() - t0 < 60


def test_every_rank_named_its_backend(world):
    for shape in MESHES:
        got = world["spawns"].get(shape)
        assert sorted(g["coords"] for g in got) == sorted(
            (d, m) for d in range(shape[0]) for m in range(shape[1]))
        assert {g["backend"] for g in got} == {"gloo"}


def test_mesh_async_admission_equals_sync(world):
    """Async admission on (1, 2): the ranks load each variant at different
    speeds, and every rank still commits each ticket at the same decode
    step (``async_admits`` equals the commits), with the sync run's
    tokens."""
    ranks = world["spawns"].get((1, 2))
    commits = [g["async"]["async"]["paced"]["commits"] for g in ranks]
    assert commits[0] and all(c == commits[0] for c in commits)
    for g in ranks:
        paced = g["async"]["async"]["paced"]
        assert paced["tokens"] == g["async"]["sync"]["tokens"]
        assert paced["status"] == ["done"] * len(R.POD_TRAFFIC)
        assert paced["async_admits"] == len(paced["commits"]) == 2
        assert paced["agreements"] > 0
        assert g["async"]["sync"]["agreements"] == 0


def test_mesh_async_failure_on_one_rank_fails_every_rank(world):
    """A variant whose load fails on rank 0 alone fails its request on
    both ranks, with rank 0's error, and the ranks serve on in step; base
    traffic with no ticket live makes no agreement."""
    ranks = world["spawns"].get((1, 2))
    fail = [g["async"]["async"]["failure"] for g in ranks]
    assert all(f == fail[0] for f in fail)
    assert [s for s, _, _ in fail[0]] == ["done"] * 3 + [
        "failed", "done", "done"]
    assert fail[0][3][1] == "artifact unreadable on rank 0"
    assert all(g["async"]["async"]["base_agreements"] == 0 for g in ranks)


@pytest.mark.parametrize("shape,arch,label", SPEC_CASES,
                         ids=["x".join(map(str, m)) + f"-{a}-"
                              + "-".join(label) for m, a, label in SPEC_CASES])
def test_mesh_speculative_tokens_match_jax_single_device(world, shape, arch,
                                                         label):
    """The speculative scheduler under a mesh (each round's drafts and
    verify on the rank's lanes and blocks, the lanes' results gathered
    once a round): every rank serves JAX's single-device continuous
    tokens (the variant's greedy chain) with every budget, over both
    dispatch modes and bases, adaptive k up to 4, a fixed k = 1 and async
    admission; every rank reports the same ladder snapshot, so the ranks
    picked the same k in every round."""
    want = _jax_tokens(world, arch, "continuous", label[1])
    assert [len(t) for t in want] == R.BUDGETS
    ranks = world["spawns"].get(shape)
    snaps = [g[("spec", arch)][label][1] for g in ranks]
    for got in ranks:
        assert got[("spec", arch)][label][0] == want, got["coords"]
    assert all(sn == snaps[0] for sn in snaps)
    assert snaps[0]["rounds"] > 0 and snaps[0]["drafted"] > 0
    assert snaps[0]["ladder"] == ([1] if "k1" in label else [1, 2, 4])


def _jax_warmup_keys(world, scheduler: str) -> set:
    """JAX's ``warmup()`` keys for the scheduler, on one device (its
    executables stubbed: the keys come from its registry)."""
    d = world["data"]["deepseek-7b"]
    jdep = JaxDeployment(d["jmodel"], d["jparams"], batch_size=R.BATCH,
                         prompt_len=R.PROMPT, max_len=R.MAX_LEN,
                         bank_size=4, scheduler=scheduler)
    jdep.engine._get_exe = lambda kind, args: None
    keys = set(jdep.warmup())
    jdep.close()
    return keys


@pytest.mark.parametrize("scheduler", ["continuous", "speculative"])
def test_mesh_warmup_keys_and_tokens_match_jax(world, scheduler):
    """``warmup()`` on (1, 2): every rank runs JAX's entries (the outcome
    keys of JAX's ``warmup()`` for the scheduler), each "eager" (no graph
    under a mesh), and then serves JAX's single-device continuous
    tokens."""
    want_keys = _jax_warmup_keys(world, scheduler)
    want = _jax_tokens(world, "deepseek-7b", "continuous")
    for got in world["spawns"].get((1, 2)):
        w = got["warm"][scheduler]
        assert set(w["outcomes"]) == want_keys
        assert set(w["outcomes"].values()) == {"eager"}
        assert w["warmed"] is True
        assert w["tokens"] == want, got["coords"]


def test_mesh_ranks_share_one_compile_cache(world):
    """Ranks that share one fresh compile-cache directory: loading in
    turns (rank 0 first, the others after a barrier) builds once between
    them and the others hit; loading one key at once, each rank builds or
    hits and gets the library; nothing counts as corrupt and nothing is
    quarantined.  ``status()["compile_cache"]`` is the rank's own."""
    ranks = world["spawns"].get((1, 2))
    caches = [g["warm"]["continuous"]["cache"] for g in ranks]
    assert sum(c["builds"] for c in caches) == 1
    assert caches[0]["builds"] == 1 and caches[1]["hits"] == 1
    for g in ranks:
        race, report = g["warm"]["race"]
        assert report == "stand-in report"
        assert race["builds"] + race["hits"] == 1
        assert race["corrupt"] == race["env_mismatch"] == 0
        assert g["warm"]["continuous"]["cache"]["corrupt"] == 0
        assert g["warm"]["quarantined"] == []


@pytest.mark.parametrize("case", ["no_axes", "pod"])
def test_mesh_refusals_name_their_slice(world, case):
    """What mesh serving does not serve raises, naming why; nothing is
    switched off silently.  (A mesh object without processes: every
    refusal comes before the first collective.)"""
    from repro_torch.distributed import sharding as S
    from repro_torch.models.param import split
    mesh = S.Mesh(("data", "model"), (1, 2))
    arch = "deepseek-7b"
    d = world["data"][arch]["ship"]
    model = build_model(R.port_config(arch))
    params = bridge.params_from_numpy(d["flat"], "cpu")
    _, axes = split(model.init(0, device="cpu"))
    if case == "no_axes":
        with pytest.raises(ValueError, match="param_axes"):
            R.Deployment(model, params, device="cpu", mesh=mesh)
        return
    # pod-local banks still refuse speculative decoding, as JAX does
    pmesh = S.Mesh(("pod", "data", "model"), (2, 1, 2))
    with pytest.raises(ValueError, match="speculative"):
        R.Deployment(model, params, device="cpu", mesh=pmesh,
                     param_axes=axes, batch_size=4, pod_banks=True,
                     speculative=True)


_JAX_TRAIN: dict = {}


def _jax_train(world, arch: str) -> dict:
    """JAX's single-device train steps of one arch, shared by every
    mesh."""
    if arch not in _JAX_TRAIN:
        d = world["data"][f"train {arch}"]
        _JAX_TRAIN[arch] = jax_train_reference(d["jmodel"],
                                               d["ship"]["batches"])
    return _JAX_TRAIN[arch]


@pytest.mark.parametrize("shape,arch", TRAIN_CASES,
                         ids=["x".join(map(str, m)) + f"-{a}"
                              for m, a in TRAIN_CASES])
def test_mesh_train_steps_match_jax_single_device(world, shape, arch):
    """``make_train_step(param_axes=)`` under ``rules_for("train")`` (TP
    over "model", FSDP over "data", the batch's rows over "data"): every
    rank's metrics, step-1 gradients and final params, made whole, at the
    bar of ``assert_train_matches`` against JAX's single-device step on the
    same params and batches; the metrics the same on every rank, bit for
    bit."""
    want = _jax_train(world, arch)
    ranks = world["spawns"].get(shape)
    for got in ranks:
        R.assert_train_matches(got[("train", arch)], want)
        assert got[("train", arch)]["metrics"] == \
            ranks[0][("train", arch)]["metrics"]


def test_drop_and_continue_matches_uninterrupted_steps(world):
    """2 steps on (2, 2), ``remesh`` to (1, 2) and ``drop_and_continue``
    onto the first two ranks, 1 more step there: the losses within 1e-5
    rel of JAX's 3 uninterrupted single-device steps; the dropped ranks
    stop after 2."""
    want = [m["loss"] for m in _jax_train(world, "deepseek-7b")["metrics"]]
    for got in world["spawns"].get((2, 2)):
        kept = got["coords"][0] == 0
        assert len(got["drop"]) == (3 if kept else 2), got["coords"]
        np.testing.assert_allclose(got["drop"], want[:len(got["drop"])],
                                   rtol=1e-5)


def test_mesh_train_moe_groups_within_each_rank_match_one_process(world):
    """deepseek-moe-16b on (2, 1) with 2 x 2048 tokens a data rank: each
    rank's rows hold whole capacity groups (4096 tokens), so the layer
    routes its own rows and the aux loss is each rank's share (the
    batch's token fractions times its rows' probabilities); one step's
    metrics, gradients and params within ``assert_train_matches``'s bar of
    the port's single-process step (itself held to JAX's at 16 tokens a
    row)."""
    d = world["data"]["train wide deepseek-moe-16b"]["ship"]
    want = R.mesh_train(None, d, "deepseek-moe-16b", steps=1)
    assert want["metrics"][0]["moe_aux"] > 0
    for got in world["spawns"].get((2, 1)):
        R.assert_train_matches(got[("train wide", "deepseek-moe-16b")], want)
