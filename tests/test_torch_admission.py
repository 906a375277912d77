"""Async admission in the port (``serving/admission``, the streamed and
paced store read, staged transfers, the bank's staging marks and the
engine's drain hook) against the JAX package, on the CPU: twins of
``tests/test_async_admission.py`` and of the lifecycle case of
``tests/test_lifecycle_api.py``.

Reduced deepseek-7b, 2 layers, fp32 compute, weights from JAX
``init(PRNGKey(0))`` crossed through ``bridge``; two fine-tunes (base plus
0.05 and 0.08 of the ``PRNGKey(1)`` init) compressed by the JAX package.
One JAX ``Deployment(async_admission=True)`` lifecycle (publish, update,
rollback through a store) is run once per module; every port run must
give its tokens exactly: async equals the port's synchronous path equals
JAX.  On the CPU the pipeline's worker stages on the host (no stream, no
events), so these tests hold its control flow, its guards and its
tokens; the card's ordering (events, pinned buffers, capture while a
ticket stages) is held in ``tests/test_torch_cuda.py``.
"""
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from _port_helpers import configs, delta_model_numpy, jax_base  # noqa: E402

from repro.core import calibration as JC  # noqa: E402
from repro.core import loader as JL  # noqa: E402
from repro.core import store as JS  # noqa: E402
from repro.models.param import split  # noqa: E402
from repro.serving import Deployment as JaxDeployment  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.core import loader as L  # noqa: E402
from repro_torch.core import store as S  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Deployment  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.variants import VariantRegistry  # noqa: E402

PROMPT = np.arange(1, 7)
KW = dict(batch_size=2, prompt_len=8, max_len=96, bank_size=4)


@pytest.fixture(scope="module")
def s():
    jcfg, tcfg = configs(num_layers=2, arch="deepseek-7b")
    jmodel, jbase, flat = jax_base(jcfg)
    pert, _ = split(jmodel.init(jax.random.PRNGKey(1)))
    jdms = [JC.compress(jbase, jax.tree.map(lambda b, p, a=a: b + a * p,
                                            jbase, pert))
            for a in (0.05, 0.08)]
    return {"jmodel": jmodel, "jbase": jbase, "jdms": jdms,
            "model": build_model(tcfg),
            "base": bridge.params_from_numpy(flat, "cpu"),
            "dms": [bridge.delta_model_from_numpy(delta_model_numpy(d),
                                                  "cpu") for d in jdms]}


def _serve(dep, variant, n=4):
    rid = dep.submit(PROMPT, variant=variant, max_new_tokens=n)
    dep.drain()
    assert dep.result(rid).status == "done", dep.result(rid).error
    return dep.result(rid).out_tokens


def _lifecycle(dep, dm1, dm2, wait):
    """publish v1, serve; update to v2, serve; roll back, serve: the
    tokens of each (5 a request)."""
    dep.publish("prod", dm1)
    t1 = _serve(dep, "prod", 5)
    dep.update("prod", dm2)
    t2 = _serve(dep, "prod", 5)
    if wait is not None:
        wait()                   # no live ticket across the rollback
    dep.rollback("prod")
    t3 = _serve(dep, "prod", 5)
    dep.close()
    return t1, t2, t3


@pytest.fixture(scope="module")
def jax_ref(s, tmp_path_factory):
    """JAX's async Deployment through the lifecycle, once."""
    jdep = JaxDeployment(s["jmodel"], s["jbase"],
                         root_dir=tmp_path_factory.mktemp("jax"),
                         async_admission=True, **KW)
    return _lifecycle(jdep, *s["jdms"], wait=lambda: jdep.admission.wait())


def _dep(s, root=None, **kw):
    return Deployment(s["model"], s["base"], root_dir=root, device="cpu",
                      **KW, **kw)


# ---------------------------------------------------------------------------
# parity: async-admitted variants give the synchronous path's tokens
# ---------------------------------------------------------------------------

def test_async_admission_token_parity(s, jax_ref, tmp_path):
    """Store-backed publish and update served through the pipeline give
    the sync path's tokens and JAX's, and commit off the inline path."""
    tokens = {}
    for mode in ("sync", "async"):
        dep = _dep(s, root=tmp_path / mode,
                   async_admission=(mode == "async"))
        dep.publish("prod", s["dms"][0])
        t1 = _serve(dep, "prod", 5)
        dep.update("prod", s["dms"][1])
        t2 = _serve(dep, "prod", 5)
        tokens[mode] = (t1, t2)
        if mode == "async":
            assert dep.metrics["async_admits"] == 2
            assert dep.admission.stats["failures"] == 0
            assert dep.admission.stats["commits"] == 2
        else:
            assert dep.metrics["async_admits"] == 0
        dep.close()
    assert tokens["async"] == tokens["sync"] == jax_ref[:2]


def test_async_admission_overlaps_inflight_decode(s, jax_ref):
    """While two base lanes decode, a slow variant ingests on the worker:
    steps run with the admission in flight, one commit lands, and the
    variant's tokens are JAX's."""
    dep = _dep(s, async_admission=True)

    def slow_artifact():
        time.sleep(0.15)          # a long store read, off the thread
        return s["dms"][0]
    dep.registry.set_version("slow", 1, slow_artifact)
    dep.engine.record_step_times = True
    r_base = [dep.submit(PROMPT, variant="__base__", max_new_tokens=64)
              for _ in range(2)]
    rid = dep.submit(PROMPT, variant="slow", max_new_tokens=5)
    dep.drain()
    assert all(dep.result(r).status == "done" for r in r_base)
    assert dep.result(rid).status == "done"
    assert any(busy for _, _, busy in dep.engine.step_times)
    assert all(dt > 0 for _, dt, _ in dep.engine.step_times)
    assert dep.metrics["async_admits"] == 1
    assert dep.result(rid).out_tokens == jax_ref[0]
    dep.close()


# ---------------------------------------------------------------------------
# control plane: non-blocking verbs, the wait= escape hatch, status
# ---------------------------------------------------------------------------

def test_publish_nonblocking_with_wait_escape_hatch(s, tmp_path):
    dep = _dep(s, root=tmp_path / "s", async_admission=True)
    v1 = dep.publish("prod", s["dms"][0])
    # enqueued, not resident: the commit happens between steps or in wait
    assert not dep.registry.bank.holds(f"prod@v{v1}")
    dep.admission.wait("prod")
    assert dep.registry.bank.holds(f"prod@v{v1}")
    v2 = dep.update("prod", s["dms"][1], wait=True)
    assert dep.registry.bank.holds(f"prod@v{v2}")
    assert dep.admitting() == []
    dep.close()


def test_admitting_status_surfaced(s):
    """A request queued behind ingest reports ``admitting``, and the
    pipeline lists its version until the drain commits it."""
    dep = _dep(s, async_admission=True)

    def slow_artifact():
        time.sleep(0.2)
        return s["dms"][0]
    dep.registry.set_version("prod", 1, slow_artifact)
    dep.admission.prefetch("prod")
    rid = dep.submit(PROMPT, variant="prod", max_new_tokens=3)
    # one admission pass, no drain: the commit happens only in the drain
    # hook, so the request is skipped and surfaced as admitting
    assert dep.engine._admit_free_slots() == []
    assert dep.engine.status(rid) == "admitting"
    assert dep.status(rid)["status"] == "admitting"
    assert dep.admitting() == ["prod@v1"]
    dep.drain()
    assert dep.engine.status(rid) == "done"
    assert dep.admitting() == []
    dep.close()


def test_skipped_requests_keep_fifo_order(s):
    """Requests behind ingest go back to the front in their order, ahead
    of what the free lanes could not take: once the variant lands they
    are admitted before later arrivals."""
    dep = _dep(s, async_admission=True)

    def slow_artifact():
        time.sleep(0.2)
        return s["dms"][0]
    dep.registry.set_version("prod", 1, slow_artifact)
    waiting = [dep.submit(PROMPT, variant="prod", max_new_tokens=2)
               for _ in range(2)]
    bases = [dep.submit(PROMPT, max_new_tokens=2) for _ in range(3)]
    # two lanes: both go to base requests, the variant's two are skipped
    assert len(dep.engine._admit_free_slots()) == 2
    assert [r.rid for r in dep.engine._queue] == waiting + bases[2:]
    dep.drain()
    assert all(dep.result(r).status == "done" for r in waiting + bases)
    dep.close()


# ---------------------------------------------------------------------------
# lifecycle guards under concurrency
# ---------------------------------------------------------------------------

def test_evict_while_staging_raises(s):
    dep = _dep(s, async_admission=True)

    def slow_artifact():
        time.sleep(0.2)
        return s["dms"][0]
    dep.registry.set_version("prod", 1, slow_artifact)
    dep.admission.prefetch("prod")
    with pytest.raises(RuntimeError, match="staging"):
        dep.registry.evict("prod")
    with pytest.raises(RuntimeError, match="staging"):
        dep.registry.bank.evict("prod@v1")
    dep.admission.wait("prod")            # the admission lands ...
    dep.registry.evict("prod")            # ... then eviction is clean
    assert not dep.registry.bank.holds("prod@v1")
    dep.close()


def test_rollback_while_staging_raises(s, jax_ref):
    dep = _dep(s, async_admission=True)
    dep.publish("prod", s["dms"][0], wait=True)
    t1 = _serve(dep, "prod", 4)

    def slow_v2():
        time.sleep(0.2)
        return s["dms"][1]
    dep.registry.set_version("prod", 2, slow_v2)
    dep.admission.prefetch("prod")
    with pytest.raises(RuntimeError, match="mid-admission"):
        dep.rollback("prod")
    dep.admission.wait("prod")
    assert dep.rollback("prod") == 1      # clean once the admission lands
    assert _serve(dep, "prod", 4) == t1 == jax_ref[0][:4]
    dep.close()


@pytest.mark.parametrize("max_retries", [0, 2])
def test_ingest_failure_respects_retry_budget(s, tmp_path, max_retries):
    """A corrupt artifact failing on the worker fails its request after
    exactly ``max_retries`` retries (one ingest each), as the sync path's
    budget does, leaves no staging mark, and the node serves on."""
    st = S.VariantStore(tmp_path / "s",
                        base_fp=S.base_fingerprint(s["base"]))
    st.publish("bad", s["dms"][0])
    blob = tmp_path / "s" / "bad" / "v0001" / "deltas.npz"
    blob.write_bytes(blob.read_bytes()[: blob.stat().st_size // 2])
    dep = _dep(s, root=tmp_path / "s", async_admission=True,
               max_retries=max_retries)
    dep.publish("good", C.compress(s["base"], s["base"]))
    rid_bad = dep.submit(PROMPT, variant="bad", max_new_tokens=3)
    rid_good = dep.submit(PROMPT, variant="good", max_new_tokens=3)
    dep.drain()
    bad = dep.result(rid_bad)
    assert bad.status == "failed" and "truncated" in bad.error
    assert bad.retries == max_retries + 1
    assert dep.admission.stats["failures"] == max_retries + 1
    assert dep.stats["load_failures"] == max_retries + 1
    assert dep.result(rid_good).status == "done"
    assert not dep.registry.bank.staging("bad@v1")
    dep.close()


def test_version_pinning_survives_async_hot_swap(s, jax_ref):
    """A lane decoding v1 when an async update lands finishes on v1's
    pinned slot; requests admitted after the swap serve v2."""
    dep = _dep(s, async_admission=True)
    dep.publish("prod", s["dms"][0], wait=True)
    rid_old = dep.submit(PROMPT, variant="prod", max_new_tokens=5)
    dep.engine._prefill_admitted(dep.engine._admit_free_slots())
    assert dep.registry.bank.pinned("prod@v1")
    dep.update("prod", s["dms"][1])       # non-blocking hot swap
    rid_new = dep.submit(PROMPT, variant="prod", max_new_tokens=5)
    dep.drain()
    assert dep.status(rid_old)["version"] == 1
    assert dep.status(rid_new)["version"] == 2
    assert dep.result(rid_old).out_tokens == jax_ref[0]
    assert dep.result(rid_new).out_tokens == jax_ref[1]
    dep.close()


@pytest.mark.parametrize("scheduler", ["continuous", "speculative"])
def test_full_lifecycle_parity_under_async_admission(s, jax_ref, tmp_path,
                                                     scheduler):
    """Publish, update (a patch) and rollback, replayed with the pipeline,
    give the synchronous control plane's tokens and JAX's async
    Deployment's, under either slot scheduler; rollback re-serves v1."""
    runs = {}
    for mode in ("sync", "async"):
        dep = _dep(s, root=tmp_path / mode, scheduler=scheduler,
                   async_admission=(mode == "async"))
        runs[mode] = _lifecycle(
            dep, *s["dms"],
            wait=dep.admission.wait if dep.admission else None)
        assert dep.metrics["async_admits"] == (2 if mode == "async" else 0)
    assert runs["async"] == runs["sync"] == jax_ref
    assert jax_ref[2] == jax_ref[0]


# ---------------------------------------------------------------------------
# the store: pacing, the staging pool, the lock, meta
# ---------------------------------------------------------------------------

def test_pacer_runs_once_per_module_and_chain_step(s, tmp_path):
    """The pacer runs after every module of a full artifact's streamed
    read and after every chain step, as the JAX store calls it, on the
    same artifacts."""
    st = S.VariantStore(tmp_path, base_fp=S.base_fingerprint(s["base"]))
    st.publish("prod", s["dms"][0])
    st.publish_update("prod", s["dms"][1])
    n_modules = len(s["dms"][0].deltas) + len(s["dms"][0].extras)
    counts = {}
    for pkg in (S, JS):
        n = [0]

        def pacer(n=n):
            n[0] += 1
        pkg.VariantStore(tmp_path).load("prod", 2, pacer=pacer)
        counts[pkg.__name__] = n[0]
        n[0] = 0
        pkg.load_artifact(tmp_path / "prod" / "v0001", pacer=pacer)
        counts[pkg.__name__ + " full"] = n[0]
    assert counts == {"repro_torch.core.store": n_modules + 2,
                      "repro.core.store": n_modules + 2,
                      "repro_torch.core.store full": n_modules,
                      "repro.core.store full": n_modules}


def test_staging_pool_reuse_drops_and_alias_refusal():
    pool = S.StagingPool(max_buffers=2)
    a = pool.take((4, 8), torch.float32)
    assert a.shape == (4, 8) and a.dtype == torch.float32
    pool.give(a)
    b = pool.take((32,), np.float32)          # same 128 bytes, numpy dtype
    assert b.data_ptr() == a.data_ptr() and b.dtype == torch.float32
    assert pool.stats["reuses"] == 1
    # a class keeps at most max_buffers; the rest are dropped
    bufs = [pool.take((16,), torch.uint8) for _ in range(3)]
    for t in bufs:
        pool.give(t)
    assert pool.stats["drops"] == 1
    # a buffer that shares memory with live data is never recycled: the
    # CPU's zero-copy "transfer" returns the buffer itself
    c = pool.take((64,), torch.uint8)
    staged = c.to("cpu")
    assert staged.data_ptr() == c.data_ptr()
    pool.give(c, live=(staged,))
    assert pool.stats["drops"] == 2
    d = pool.take((64,), torch.uint8)
    assert d.data_ptr() != staged.data_ptr()
    # a disjoint live tensor does not stop the recycle
    pool.give(d, live=(torch.zeros(64, dtype=torch.uint8),))
    assert pool.take((64,), torch.uint8).data_ptr() == d.data_ptr()
    assert pool.stats["peak_bytes"] >= pool.stats["bytes"] > 0


def test_iter_artifact_modules_through_a_pool(s, tmp_path):
    """Streaming through pool buffers (the consumer copies a module and
    gives its buffers back) reuses them across modules and reads what
    ``load_artifact`` reads; ``verify=False`` skips the sha check that
    ``verify=True`` raises on."""
    S.save_artifact(s["dms"][0], tmp_path / "v1")
    want = S.load_artifact(tmp_path / "v1")
    pool = S.StagingPool(max_buffers=2)
    got = {}
    for kind, p, _, payload in S.iter_artifact_modules(
            tmp_path / "v1", pool=pool, chunk_bytes=1 << 10):
        arrays = payload if kind == "extra" else payload["packed"]
        got[p] = np.array(arrays)
        for arr in ([payload] if kind == "extra" else payload.values()):
            pool.give(arr)
    assert pool.stats["reuses"] > 0
    for p, e in want.deltas.items():
        np.testing.assert_array_equal(got[p], e.packed.numpy())
    for p, v in want.extras.items():
        np.testing.assert_array_equal(got[p], v.numpy())
    data = dict(np.load(tmp_path / "v1" / "deltas.npz"))
    key = next(k for k in data if k.endswith("__packed"))
    data[key] = data[key] ^ 1
    np.savez(tmp_path / "v1" / "deltas.npz", **data)
    m = (tmp_path / "v1" / "manifest.json")
    m.write_text(m.read_text().replace('"files"', '"files_unchecked"'))
    with pytest.raises(IOError, match="corrupt"):
        S.load_artifact(tmp_path / "v1")
    S.load_artifact(tmp_path / "v1", verify=False)


def test_store_publish_and_load_threads(s, tmp_path):
    """A publish thread and a load thread on one store (the control
    thread and the ingest worker) give the versions a serial run gives:
    the store's lock keeps the index, the artifacts and the cache
    whole."""
    dms = [s["dms"][i % 2] for i in range(6)]
    serial = S.VariantStore(tmp_path / "serial")
    serial.publish("prod", dms[0])
    for dm in dms[1:]:
        serial.publish_update("prod", dm)
    want = {v: serial.load("prod", v) for v in serial.versions("prod")}

    st = S.VariantStore(tmp_path / "threads", cache_versions=2)
    st.publish("prod", dms[0])
    loaded, errors = [], []

    def publisher():
        try:
            for dm in dms[1:]:
                st.publish_update("prod", dm)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def loader():
        try:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                v = st.latest("prod")
                loaded.append((v, st.load("prod", v,
                                          pacer=lambda: time.sleep(0))))
                if v == len(dms):
                    return
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=f) for f in (publisher, loader)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert st.versions("prod") == serial.versions("prod")
    assert loaded and loaded[-1][0] == len(dms)
    for v, dm in loaded:
        for p, e in dm.deltas.items():
            assert torch.equal(e.packed, want[v].deltas[p].packed), (v, p)
            assert torch.equal(e.v_row, want[v].deltas[p].v_row), (v, p)
        for p, x in dm.extras.items():
            assert torch.equal(x, want[v].extras[p]), (v, p)


def test_publish_meta_lands_in_the_manifest_as_in_jax(s, tmp_path):
    """``publish(meta=)`` and ``update(meta=)`` store ``meta`` in the
    manifest as the JAX store does, full artifact and patch alike."""
    meta1, meta2 = {"run": "a", "step": 3}, {"run": "b"}
    dep = _dep(s, root=tmp_path / "port")
    dep.publish("prod", s["dms"][0], meta=meta1)
    dep.update("prod", s["dms"][1], meta=meta2)
    jst = JS.VariantStore(tmp_path / "jax")
    jst.publish("prod", s["jdms"][0], meta=meta1)
    jst.publish_update("prod", s["jdms"][1], meta=meta2)
    for v, meta in ((1, meta1), (2, meta2)):
        got = S.read_manifest(tmp_path / "port" / "prod" / f"v{v:04d}")
        want = JS.read_manifest(tmp_path / "jax" / "prod" / f"v{v:04d}")
        assert got["meta"] == want["meta"] == meta
        assert got["deltas"] == want["deltas"]
        assert got["extras"] == want["extras"]
    dep.close()


# ---------------------------------------------------------------------------
# staged transfers, refusals, the launcher
# ---------------------------------------------------------------------------

def test_stage_overlay_transfer_on_the_cpu(s):
    """The staged DeltaModel holds copies of every leaf (no alias of the
    host source, in chunks through the pool), its futures list the
    modules in JAX's order, and on the CPU no event is needed."""
    dm = s["dms"][0]
    pool = S.StagingPool()
    staged, futures = L.stage_overlay_transfer(dm, device="cpu", pool=pool,
                                               chunk_bytes=1 << 12)
    L.wait_transfers(futures)
    _, jfutures = JL.stage_overlay_transfer(s["jdms"][0])
    assert [f.path for f in futures] == [p for p, _ in jfutures]
    assert all(f.event is None for f in futures)
    for p, e in dm.deltas.items():
        got = staged.deltas[p]
        assert got.scalar == e.scalar
        for f in ("packed", "v_row", "v_col", "use_row"):
            a, b = getattr(got, f), getattr(e, f)
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    for p, v in dm.extras.items():
        assert torch.equal(staged.extras[p], v)
        assert staged.extras[p].data_ptr() != v.data_ptr()
    assert pool.stats["reuses"] > 0 and pool.stats["drops"] == 0


def test_drain_max_steps_returns_with_lanes_live(s):
    """``drain(max_steps=)`` serves that many steps and returns with the
    lanes live; draining on gives the tokens of one drain."""
    want = _serve(_dep(s), "__base__", 6)
    dep = _dep(s)
    rid = dep.submit(PROMPT, max_new_tokens=6)
    dep.drain(max_steps=2)
    assert dep.metrics["decode_steps"] == 2 and dep.engine.active() == 1
    dep.drain()
    assert dep.result(rid).out_tokens == want


def test_async_admission_refusals(s):
    with pytest.raises(ValueError, match="async_admission"):
        _dep(s, scheduler="group", async_admission=True)
    reg = VariantRegistry(s["base"], mode="fused")
    with pytest.raises(ValueError, match="async admission"):
        ServingEngine(s["model"], reg, scheduler="group",
                      admission=object())
    dep = _dep(s, scheduler="group")
    with pytest.raises(ValueError, match="max_steps"):
        dep.drain(max_steps=1)
    with pytest.raises(SystemExit):
        SV.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                 "--mode", "fused", "--async-admission"])
    dep = _dep(s, async_admission=True)
    dep.close()
    with pytest.raises(RuntimeError, match="closed"):
        dep.publish("prod", s["dms"][0])


def test_serve_launcher_async_admission_on_cpu(capsys, tmp_path):
    """``--async-admission`` with a store: every variant commits through
    the pipeline, every request gets its budget, and each variant
    request's tokens are the synchronous launcher's."""
    args = ["--arch", "qwen3-8b", "--reduced", "--device", "cpu", "--mode",
            "fused", "--scheduler", "continuous", "--variants", "2",
            "--requests", "6", "--new-tokens", "4"]
    lines = {}
    for mode in ("sync", "async"):
        extra = ["--async-admission", "--max-retries", "2",
                 "--admission-pacing", "0"] if mode == "async" else []
        SV.main(args + ["--store-dir", str(tmp_path / mode)] + extra)
        lines[mode] = {k: v for k, _, v in (
            ln.partition(": ") for ln in capsys.readouterr().out.splitlines())}
    import ast
    import json
    stats = ast.literal_eval(lines["async"]["admission"])
    assert stats["commits"] == 2 and stats["failures"] == 0
    assert "admission" not in lines["sync"]
    toks = {m: json.loads(lines[m]["tokens"]) for m in lines}
    assert all(len(t) == 4 for t in toks["async"])
    # requests round-robin over base, v0, v1: the variant requests were
    # admitted only after their commit, with the bank in place
    assert [t for i, t in enumerate(toks["async"]) if i % 3] == \
        [t for i, t in enumerate(toks["sync"]) if i % 3]
