"""Compile-once serving in the port: the warmup registry, the compile
cache of the kernel library and the static live state CUDA-graph replay
needs, on the CPU (where every step runs eagerly through the same code),
against the JAX package on reduced configs with fp32 compute (JAX
``init(PRNGKey(0))`` weights crossed through ``repro_torch.bridge``;
numpy-seeded prompts and fine-tunes).

What is held, and how:

* storage stays put: the live cache, the pending tokens, the device bank
  slots, the speculative output buffers and every leaf of the (reserved)
  overlay bank keep their ``data_ptr`` over drains with admission waves
  (the first included), retirements, a hot swap, an eviction and a walk
  of the speculative ladder;
* tokens: continuous and speculative tokens after ``warmup()`` equal the
  JAX package's continuous tokens exactly, on qwen3-8b and xlstm-350m;
* warmup keys: the port's ``warmup()`` returns the JAX engine's outcome
  keys for the same scheduler and config (the JAX side resolves no
  executable: its ``_get_exe`` is stubbed, so the keys come from its
  registry without a compile); the group scheduler's omit the banked
  entries, which would allocate a bank that scheduler never reads;
* the compile cache: fingerprints change with a source; a truncated,
  unlabelled or foreign library counts as ``corrupt`` / ``env_mismatch``,
  is moved aside and reads as a miss, whose rebuild raises the build's
  "nvcc not found" error on a host without the compiler; two processes
  that load one key at once both get the library, none corrupt;
* ``status()`` carries the JAX engine's ``steps`` keys, ``warmed`` and
  the kernel library's ``compile_cache`` counters.
"""
import json
import shutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _port_helpers import (configs, delta_model_numpy,  # noqa: E402
                           fine_tune_flat, jax_base, jax_tree)

from repro.configs import get_config  # noqa: E402
from repro.core import calibration as JC  # noqa: E402
from repro.serving import Deployment as JaxDeployment  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import compile_cache as CC  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Deployment  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

KW = dict(batch_size=2, prompt_len=8, max_len=48, bank_size=4)
BUDGETS = [3, 6, 4, 7, 2, 5]
NAMES = ["__base__", "v0", "v1"]


def _setup(arch):
    layers = get_config(arch).reduced().num_layers \
        if arch == "xlstm-350m" else 2
    jcfg, tcfg = configs(num_layers=layers, arch=arch)
    jmodel, jparams, flat = jax_base(jcfg)
    jdms = [JC.compress(jparams, jax_tree(jparams, fine_tune_flat(
        flat, seed, scale=0.05))) for seed in (21, 22, 23)]
    rng = np.random.default_rng(9)
    return {"jcfg": jcfg, "jmodel": jmodel, "jparams": jparams,
            "jdms": jdms, "model": build_model(tcfg),
            "params": bridge.params_from_numpy(flat, "cpu"),
            "dms": [bridge.delta_model_from_numpy(delta_model_numpy(d),
                                                  "cpu") for d in jdms],
            "prompts": [rng.integers(1, jcfg.vocab_size, size=n)
                        for n in (8, 5, 12, 3, 8, 6)]}


_SETUPS: dict = {}


def _get(arch):
    if arch not in _SETUPS:
        _SETUPS[arch] = _setup(arch)
    return _SETUPS[arch]


def _serve(dep, s, names=NAMES):
    rids = [dep.submit(p, variant=names[i % len(names)],
                       max_new_tokens=BUDGETS[i % len(BUDGETS)])
            for i, p in enumerate(s["prompts"])]
    dep.drain()
    return [dep.result(r).out_tokens for r in rids]


def _port(s, **kw):
    dep = Deployment(s["model"], s["params"], device="cpu", **KW, **kw)
    for i, dm in enumerate(s["dms"][:2]):
        dep.publish(f"v{i}", dm)
    return dep


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX package's continuous tokens, once per arch."""
    out = {}

    def get(arch):
        if arch not in out:
            s = _get(arch)
            jdep = JaxDeployment(s["jmodel"], s["jparams"], **KW)
            for i, jdm in enumerate(s["jdms"][:2]):
                jdep.publish(f"v{i}", jdm)
            out[arch] = _serve(jdep, s)
            jdep.close()
        return out[arch]
    return get


# ---------------------------------------------------------------------------
# static live state
# ---------------------------------------------------------------------------

def _addresses(dep) -> dict:
    eng = dep.engine
    return {"cache": [t.data_ptr() for t in tree_leaves(eng._cache)],
            "next_tok": eng._next_tok.data_ptr(),
            "vidx": eng._variant_idx_dev.data_ptr(),
            "spec_out": [t.data_ptr() for t in tree_leaves(eng._spec_out)],
            "bank": [t.data_ptr()
                     for t in tree_leaves(dep.registry.bank._tree)]}


def test_live_state_and_bank_never_move():
    s = _get("qwen3-8b")
    dep = Deployment(s["model"], s["params"], device="cpu",
                     speculative=True, draft_k=4,
                     **dict(KW, bank_size=3))      # base + 2 variant slots
    for i, dm in enumerate(s["dms"]):
        dep.publish(f"v{i}", dm)
    dep.warmup()                  # reserves the bank before any admit
    assert dep.registry.bank.tree is None       # no variant has landed
    before = _addresses(dep)
    assert len(before["bank"]) > 0 and len(before["cache"]) > 0
    ks = []
    observe = dep.engine.spec.observe

    def record(k, accepted, lanes):
        ks.append(k)
        observe(k, accepted, lanes)
    dep.engine.spec.observe = record
    _serve(dep, s, ["v0", "__base__", "v1"])
    assert dep.registry.bank.tree is dep.registry.bank._tree
    dep.update("v0", s["dms"][2])                 # hot swap: a new version
    _serve(dep, s, ["v0", "v2", "v1"])            # the third variant evicts
    m = dep.metrics
    assert dep.stats["evictions"] > 0 and m["prefills"] > 2
    assert m["admitted"] == m["retired"] == 2 * len(s["prompts"])
    assert len(set(ks)) > 1, ks                   # the ladder walked
    assert _addresses(dep) == before


@pytest.mark.parametrize("arch", ["qwen3-8b", "xlstm-350m"])
def test_tokens_after_warmup_equal_jax(arch, jax_tokens):
    s = _get(arch)
    want = jax_tokens(arch)
    for kw in ({}, {"speculative": True, "draft_k": 2}):
        dep = _port(s, warmup=True, **kw)
        assert dep.engine.warmed and not dep.engine.graphs
        assert _serve(dep, s) == want, kw


def test_first_variant_must_match_the_reserved_template():
    """A bank reserved from the base takes a compressed variant of it;
    a variant of another structure is refused."""
    s = _get("qwen3-8b")
    dep = _port(s)
    dep.registry.reserve_bank()
    good = s["dms"][0]
    partial = type(good)(deltas=dict(list(good.deltas.items())[1:]),
                         extras=good.extras)
    with pytest.raises(ValueError, match="bank template"):
        dep.registry.bank.admit("partial", partial)
    assert dep.registry.bank_resolve("v0") == 1


# ---------------------------------------------------------------------------
# the warmup registry
# ---------------------------------------------------------------------------

def _jax_keys(s, scheduler, draft_k=2) -> set:
    kw = dict(KW, scheduler=scheduler, draft_k=draft_k)
    if scheduler == "group":
        kw["mode"] = "fused"
    jdep = JaxDeployment(s["jmodel"], s["jparams"], **kw)
    jdep.engine._get_exe = lambda kind, args: None
    keys = set(jdep.warmup())
    jdep.close()
    return keys


@pytest.mark.parametrize("scheduler", ["continuous", "speculative", "group"])
def test_warmup_keys_match_jax(scheduler):
    s = _get("qwen3-8b")
    kw = {"scheduler": scheduler, "draft_k": 2}
    if scheduler == "group":
        kw["mode"] = "fused"
    dep = _port(s, **kw)
    got = dep.warmup()
    want = _jax_keys(s, scheduler)
    if scheduler == "group":
        want = {k for k in want if not k.startswith("banked")}
        assert dep.registry.bank is None
    assert set(got) == want
    assert set(got.values()) == {"eager"}
    assert dep.status()["steps"]["compiles"] == 0


def test_warmup_refuses_unknown_entries_and_registers_new_ones():
    s = _get("qwen3-8b")
    dep = _port(s)
    with pytest.raises(ValueError, match="unknown warmup pairs"):
        dep.engine.warmup(pairs=("nope",))
    seen = []
    dep.engine.register_warmup("mine", lambda ctx: seen.append(
        ctx["eager"]("mine", "noop", lambda: 1)))
    assert dep.engine.warmup(pairs=("mine",)) == {"mine/noop": "eager"}
    assert seen == [1] and dep.engine.warmed


def test_status_has_the_jax_step_and_cache_keys():
    s = _get("qwen3-8b")
    dep = _port(s)
    st = dep.status()
    assert st["warmed"] is False
    jdep = JaxDeployment(s["jmodel"], s["jparams"], **KW)
    jst = jdep.status()
    jdep.close()
    assert set(st["steps"]) == set(jst["steps"])
    for key in ("steps", "warmed", "compile_cache"):
        assert key in st and key in jst
    assert set(st["compile_cache"]) == {"hits", "misses", "builds",
                                        "build_seconds", "corrupt",
                                        "env_mismatch"}
    assert "warmup_seconds" in st["metrics"]
    dep.warmup()
    st = dep.status()
    assert st["warmed"] is True and st["metrics"]["warmup_seconds"] > 0
    assert st["steps"] == {"executables": 0, "compiles": 0, "cache_hits": 0,
                           "compile_seconds": 0.0}


# ---------------------------------------------------------------------------
# the compile cache
# ---------------------------------------------------------------------------

def test_code_fingerprint_follows_every_source(tmp_path):
    root = tmp_path / "pkg"
    (root / "csrc").mkdir(parents=True)
    (root / "a.py").write_text("x = 1\n")
    (root / "csrc" / "k.cu").write_text("// kernel\n")
    first = CC.code_fingerprint(root)
    assert CC.code_fingerprint(root) == first
    (root / "a.py").write_text("x = 2\n")
    second = CC.code_fingerprint(root)
    (root / "csrc" / "k.cu").write_text("// kernel, edited\n")
    third = CC.code_fingerprint(root)
    assert len({first, second, third}) == 3
    assert CC.code_fingerprint() == CC.code_fingerprint()
    env = CC.env_fingerprint()
    assert env[0] == torch.__version__ and len(env) == 5


def _entry(cache, key, *, lib=b"\x7fELF truncated", meta="default"):
    cache.path.mkdir(parents=True, exist_ok=True)
    so, meta_path, report = cache._files(key)
    so.write_bytes(lib)
    report.write_text("report")
    if meta == "default":
        meta = {"format": 1, "env": list(CC.env_fingerprint())}
    if meta is not None:
        meta_path.write_text(json.dumps(meta))
    return so


@pytest.mark.parametrize("broken,reason", [
    ("truncated", "corrupt"), ("no metadata", "corrupt"),
    ("foreign", "env_mismatch")])
def test_broken_library_is_moved_aside_and_rebuilt(tmp_path, monkeypatch,
                                                   broken, reason):
    """The cache the kernel build goes through: a broken entry under the
    library's own key is a counted miss, moved into ``quarantine/``; the
    rebuild then needs ``nvcc``, absent here (PATH and CUDA_HOME point
    nowhere), and raises the build's own error."""
    cache = CC.CompileCache(tmp_path / "cache")
    key = cache.key("kernel-library", tuple(build.NVCC_FLAGS),
                    tuple(build.SOURCES), build._digest())
    meta = {"truncated": "default", "no metadata": None,
            "foreign": {"format": 1, "env": ["another", "machine"]}}[broken]
    so = _entry(cache, key, meta=meta)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    prev = CC.set_default(cache)
    build._loaded.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.library()
    finally:
        CC.set_default(prev)
        build._loaded.cache_clear()
    assert not so.exists()
    moved = [p.name for p in (cache.path / "quarantine").iterdir()]
    assert any(n.startswith(so.name) and reason in n for n in moved), moved
    assert cache.stats[reason] == 1 and cache.stats["misses"] == 1
    assert cache.stats["hits"] == cache.stats["builds"] == 0
    assert not [p for p in cache.path.iterdir() if p.name.startswith("tmp")]


def test_a_stored_library_is_a_hit(tmp_path):
    """A loadable library under its key loads without a build (one of
    torch's own shared objects stands in for the kernel library)."""
    import pathlib
    stand_in = sorted((pathlib.Path(torch.__file__).parent / "lib")
                      .glob("libc10.so*"))[0]
    cache = CC.CompileCache(tmp_path / "cache")
    so = _entry(cache, cache.key("stand-in"))
    shutil.copyfile(stand_in, so)

    def never(_dir):
        raise AssertionError("a hit must not build")
    lib, report = cache.load(("stand-in",), never)
    assert report == "report" and lib is not None
    assert cache.stats["hits"] == 1 and cache.stats["misses"] == 0


def test_two_processes_load_one_key_at_once(tmp_path):
    """Two processes that miss one key of one fresh cache at the same
    moment: each builds or hits, both load the library with its report,
    and nothing is counted corrupt or moved aside (each file of an entry
    lands whole, the library last)."""
    import multiprocessing as mp
    import _mesh_ranks as R
    ctx = mp.get_context("spawn")
    barrier, queue = ctx.Barrier(2), ctx.Queue()
    procs = [ctx.Process(target=R.cache_race,
                         args=(str(tmp_path / "cache"), barrier, queue))
             for _ in range(2)]
    for p in procs:
        p.start()
    got = [queue.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(60)
    assert [p.exitcode for p in procs] == [0, 0]
    for stats, report, loaded in got:
        assert loaded and report == "stand-in report"
        assert stats["builds"] + stats["hits"] == 1
        assert stats["corrupt"] == stats["env_mismatch"] == 0
    assert not (tmp_path / "cache" / "quarantine").exists()
    assert not [q for q in (tmp_path / "cache").iterdir()
                if q.name.startswith("tmp")]


def test_env_var_and_deployment_name_the_default_cache(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("REPRO_COMPILE_CACHE_DIR", str(tmp_path / "c"))
    prev = CC.set_default(None)
    try:
        assert CC.get_default().path == tmp_path / "c"
        dep = _port(_get("qwen3-8b"), compile_cache_dir=tmp_path / "d")
        assert CC.get_default() is dep.compile_cache
        assert dep.compile_cache.path == tmp_path / "d"
    finally:
        CC.set_default(prev)
