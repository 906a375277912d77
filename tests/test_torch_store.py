"""Port parity: the artifact store, update patches and the loader's patch
path, against the JAX package (mirrors tests/test_store_loader.py).

* Artifacts and patch chains written by either package load in the other:
  manifests agree on paths, shapes, sha, axis counts and sizes, and the
  arrays are equal (the npz files themselves carry zip timestamps).
* The wire encodings (XOR, zero-run suppression) are byte-identical.
* ``loader.apply_update`` gives a DeltaModel bit-equal to JAX's.
* A truncated file, a corrupt sha and a wrong base fingerprint raise as in
  JAX; so do a torn manifest, a bad variant name and a changed structure.

Reduced qwen3-8b, 2 layers, fp32; a numpy-seeded fine-tune pair.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _port_helpers import (configs, delta_model_numpy,  # noqa: E402
                           fine_tune_flat, jax_base, jax_tree)

from repro.core import calibration as JC  # noqa: E402
from repro.core import delta as JD  # noqa: E402
from repro.core import loader as JL  # noqa: E402
from repro.core import store as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.core import delta as D  # noqa: E402
from repro_torch.core import loader as L  # noqa: E402
from repro_torch.core import store as S  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.variants import VariantRegistry  # noqa: E402

ATTN = ("wq", "wk", "wv", "wo")


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs(num_layers=2)
    _, jbase, flat = jax_base(jcfg)
    ft1 = fine_tune_flat(flat, 11)
    # an attention-only refresh of ft1 (the localized update regime) and a
    # second, MLP-only one on top of it
    rng = np.random.default_rng(12)
    ft2 = {k: v + (0.003 * rng.standard_normal(v.shape).astype(v.dtype)
                   if k.split(".")[-1] in ATTN else 0)
           for k, v in ft1.items()}
    ft3 = {k: v + (0.003 * rng.standard_normal(v.shape).astype(v.dtype)
                   if k.split(".")[-1] in ("w_up", "w_down") else 0)
           for k, v in ft2.items()}
    jdms = [JC.compress(jbase, jax_tree(jbase, f)) for f in (ft1, ft2, ft3)]
    return {"tcfg": tcfg, "jbase": jbase, "flat": flat,
            "base": bridge.params_from_numpy(flat, "cpu"), "jdms": jdms,
            "dms": [bridge.delta_model_from_numpy(delta_model_numpy(d),
                                                  "cpu") for d in jdms],
            "ft1": ft1}


def _np(x):
    """An array of either package as numpy (bf16 as its bits)."""
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(x)


def _assert_dm_equal(got, want):
    """Two DeltaModels (either package) hold equal arrays, bit for bit."""
    assert list(got.deltas) == list(want.deltas)
    assert list(got.extras) == list(want.extras)
    for p, w in want.deltas.items():
        g = got.deltas[p]
        assert g.scalar == w.scalar
        for f in ("packed", "v_row", "v_col", "use_row"):
            a, b = _np(getattr(g, f)), _np(getattr(w, f))
            assert a.dtype == b.dtype and a.shape == b.shape, (p, f)
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                          err_msg=f"{p}.{f}")
    for p, w in want.extras.items():
        a, b = _np(got.extras[p]), _np(w)
        assert a.dtype == b.dtype == np.float16
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


def _manifest_view(m):
    """What two packages' manifests of the same content must share."""
    return {"version": m["version"], "kind": m["kind"],
            "base_fingerprint": m["base_fingerprint"],
            "lineage": m["lineage"], "deltas": m["deltas"],
            "extras": m["extras"], "files": m["files"],
            "artifact_bytes": m["artifact_bytes"]}


# ---------------------------------------------------------------------------
# wire helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gap", [0, 1, 16])
def test_wire_encodings_byte_identical(gap):
    rng = np.random.default_rng(gap)
    old = rng.integers(0, 256, size=5000, dtype=np.uint8)
    new = old.copy()
    for s in (3, 40, 41, 900, 4990):
        new[s:s + rng.integers(1, 9)] ^= 0x5A
    for a, b in ((old, new), (old.view(np.uint16), new.view(np.uint16)),
                 (old, old)):
        x_t, x_j = D.xor_bytes(a, b), JD.xor_bytes(a, b)
        np.testing.assert_array_equal(x_t, x_j)
        enc_t = D.zrle_encode(x_t, merge_gap=gap)
        enc_j = JD.zrle_encode(x_j, merge_gap=gap)
        for t, j in zip(enc_t, enc_j):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(D.zrle_decode(*enc_t, x_t.size),
                                      JD.zrle_decode(*enc_j, x_j.size))
        np.testing.assert_array_equal(D.zrle_decode(*enc_t, x_t.size), x_t)


def test_wire_helpers_refuse_what_jax_refuses():
    with pytest.raises(ValueError):
        D.xor_bytes(np.zeros(4, np.uint8), np.zeros(5, np.uint8))
    with pytest.raises(ValueError):
        D.zrle_decode(np.array([3]), np.array([4]), np.zeros(4, np.uint8), 5)
    with pytest.raises(ValueError):
        D.zrle_decode(np.array([0]), np.array([2]), np.zeros(3, np.uint8), 5)


# ---------------------------------------------------------------------------
# full artifacts across packages
# ---------------------------------------------------------------------------

def test_base_fingerprints_agree(pair):
    assert S.base_fingerprint(pair["base"]) == \
        JS.base_fingerprint(pair["jbase"])


def test_full_artifact_written_by_jax_loads_in_port(pair, tmp_path):
    fp = JS.base_fingerprint(pair["jbase"])
    JS.save_artifact(pair["jdms"][0], tmp_path / "a", base_fp=fp,
                     meta={"name": "a"})
    got = S.load_artifact(tmp_path / "a",
                          expect_base_fp=S.base_fingerprint(pair["base"]))
    _assert_dm_equal(got, JS.load_artifact(tmp_path / "a",
                                           expect_base_fp=fp))
    assert all(t.device.type == "cpu" for e in got.deltas.values()
               for t in (e.packed, e.v_row))


def test_full_artifact_written_by_port_loads_in_jax(pair, tmp_path):
    fp = S.base_fingerprint(pair["base"])
    m_t = S.save_artifact(pair["dms"][0], tmp_path / "t", base_fp=fp,
                          meta={"name": "a"})
    m_j = JS.save_artifact(pair["jdms"][0], tmp_path / "j", base_fp=fp,
                           meta={"name": "a"})
    assert _manifest_view(m_t) == _manifest_view(m_j)
    assert json.loads((tmp_path / "t" / "manifest.json").read_text()) == m_t
    got = JS.load_artifact(tmp_path / "t", expect_base_fp=fp)
    _assert_dm_equal(got, JS.load_artifact(tmp_path / "j"))
    _assert_dm_equal(S.load_artifact(tmp_path / "t"),
                     S.load_artifact(tmp_path / "j"))


def test_scalar_artifact_round_trips_across_packages(pair, tmp_path):
    jdm = JC.compress(pair["jbase"], jax_tree(pair["jbase"], pair["ft1"]),
                      scalar=True)
    dm = bridge.delta_model_from_numpy(delta_model_numpy(jdm), "cpu")
    S.save_artifact(dm, tmp_path / "t")
    got = JS.load_artifact(tmp_path / "t")
    assert all(e.scalar for e in got.deltas.values())
    JS.save_artifact(jdm, tmp_path / "j")
    _assert_dm_equal(got, JS.load_artifact(tmp_path / "j"))


# ---------------------------------------------------------------------------
# patch chains across packages
# ---------------------------------------------------------------------------

def _publish_chain(store, dms):
    assert store.publish("task", dms[0]) == 1
    assert store.publish_update("task", dms[1]) == 2
    assert store.publish_update("task", dms[2]) == 3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_patch_chain_loads_in_the_other_package(pair, tmp_path, writer):
    fp = S.base_fingerprint(pair["base"])
    if writer == "jax":
        _publish_chain(JS.VariantStore(tmp_path, base_fp=fp), pair["jdms"])
    else:
        _publish_chain(S.VariantStore(tmp_path, base_fp=fp), pair["dms"])
    jstore = JS.VariantStore(tmp_path, base_fp=fp)
    tstore = S.VariantStore(tmp_path, base_fp=fp)
    assert tstore.versions("task") == jstore.versions("task") == [1, 2, 3]
    assert tstore.lineage("task") == jstore.lineage("task") == [1, 2, 3]
    for v in (3, 2, 1):            # the chain walk, then cached ancestors
        _assert_dm_equal(tstore.load("task", v), jstore.load("task", v))
        assert tstore.artifact_bytes("task", v) == \
            jstore.artifact_bytes("task", v)
    # a patch of an attention-only refresh is a small fraction of a full
    # publish and names only the attention modules
    m2 = JS.read_manifest(tmp_path / "task" / "v0002")
    assert m2["kind"] == "patch" and m2["lineage"]["parent_version"] == 1
    assert {p.split(".")[-1] for p in m2["deltas"]} <= set(ATTN)
    assert tstore.artifact_bytes("task", 2) < \
        0.5 * tstore.artifact_bytes("task", 1)


def test_patch_manifests_agree_between_packages(pair, tmp_path):
    fp = S.base_fingerprint(pair["base"])
    _publish_chain(JS.VariantStore(tmp_path / "j", base_fp=fp), pair["jdms"])
    _publish_chain(S.VariantStore(tmp_path / "t", base_fp=fp), pair["dms"])
    for v in ("v0001", "v0002", "v0003"):
        m_j = JS.read_manifest(tmp_path / "j" / "task" / v)
        m_t = S.read_manifest(tmp_path / "t" / "task" / v)
        assert _manifest_view(m_t) == _manifest_view(m_j), v
    assert json.loads((tmp_path / "t" / "task" / "versions.json").read_text()
                      ) == json.loads((tmp_path / "j" / "task" /
                                       "versions.json").read_text())


def test_apply_update_is_bit_equal_to_jax(pair, tmp_path):
    S.save_update_patch(pair["dms"][0], pair["dms"][1], tmp_path)
    _, dp, ep = S.load_update_patch(tmp_path)
    _, jdp, jep = JS.load_update_patch(tmp_path)
    parent_t = S.load_artifact(_full(pair, tmp_path / "full"))
    parent_j = JS.load_artifact(tmp_path / "full")
    got = L.apply_update(parent_t, dp, ep)
    _assert_dm_equal(got, JL.apply_update(parent_j, jdp, jep))
    # untouched modules are shared with the parent, not copied
    same = [p for p in got.deltas if p not in dp]
    assert same and all(got.deltas[p] is parent_t.deltas[p] for p in same)


def _full(pair, path):
    S.save_artifact(pair["dms"][0], path)
    return path


# ---------------------------------------------------------------------------
# VariantStore semantics
# ---------------------------------------------------------------------------

def test_variant_store_lineage_rollback_and_lru(pair, tmp_path):
    store = S.VariantStore(tmp_path, cache_versions=2)
    _publish_chain(store, pair["dms"])
    assert store.names() == ["task"] and store.latest("task") == 3
    assert store.rollback("task") == 2 and store.latest("task") == 2
    assert store.rollback("task", 1) == 1
    with pytest.raises(ValueError):
        store.rollback("task")                 # nothing below version 1
    with pytest.raises(KeyError):
        store.rollback("task", 9)
    # version ids stay monotonic after a rollback
    assert store.publish_update("task", pair["dms"][2]) == 4
    assert store.version_info("task", 4)["parent"] == 1
    assert store.lineage("task", 4) == [1, 4]
    # bounded LRU cache: a hit returns the cached object
    a = store.load("task", 4)
    assert store.load("task", 4) is a
    store.load("task", 2)
    store.load("task", 3)
    assert len(store._cache) == 2 and ("task", 4) not in store._cache
    _assert_dm_equal(store.load("task", 4), a)
    for bad in ("", ".", "..", "a/b", "x@v1"):
        with pytest.raises(ValueError):
            store.publish(bad, pair["dms"][0])
    with pytest.raises(KeyError):
        store.latest("nope")


def test_patch_refuses_a_changed_structure(pair, tmp_path):
    dm = pair["dms"][0]
    fewer = C.DeltaModel(deltas=dict(list(dm.deltas.items())[1:]),
                         extras=dm.extras)
    with pytest.raises(ValueError):
        S.save_update_patch(dm, fewer, tmp_path)
    with pytest.raises(ValueError):
        JS.save_update_patch(pair["jdms"][0],
                             JC.DeltaModel(deltas=dict(list(
                                 pair["jdms"][0].deltas.items())[1:]),
                                 extras=pair["jdms"][0].extras), tmp_path)


# ---------------------------------------------------------------------------
# failures raise as in JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_truncated_file_raises(pair, tmp_path, pkg):
    S.save_artifact(pair["dms"][0], tmp_path / "v1")
    f = tmp_path / "v1" / "deltas.npz"
    f.write_bytes(f.read_bytes()[:-64])
    with pytest.raises(IOError):
        (S if pkg == "port" else JS).load_artifact(tmp_path / "v1")


def test_truncated_member_raises_per_chunk(pair, tmp_path):
    """A member cut short inside a file whose size the manifest no longer
    records (a v1 manifest) is caught by the chunked read."""
    S.save_artifact(pair["dms"][0], tmp_path / "v1")
    mpath = tmp_path / "v1" / "manifest.json"
    m = json.loads(mpath.read_text())
    del m["files"]
    mpath.write_text(json.dumps(m))
    f = tmp_path / "v1" / "extras.npz"
    f.write_bytes(f.read_bytes()[:-4000])
    for pkg in (S, JS):
        with pytest.raises(Exception):
            pkg.load_artifact(tmp_path / "v1")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_corrupt_sha_raises(pair, tmp_path, pkg):
    S.save_artifact(pair["dms"][0], tmp_path / "v1")
    data = dict(np.load(tmp_path / "v1" / "deltas.npz"))
    key = next(k for k in data if k.endswith("__packed"))
    data[key] = data[key] ^ 1
    np.savez(tmp_path / "v1" / "deltas.npz", **data)
    with pytest.raises(IOError):
        (S if pkg == "port" else JS).load_artifact(tmp_path / "v1")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_wrong_base_fingerprint_raises(pair, tmp_path, pkg):
    mod = S if pkg == "port" else JS
    mod.save_artifact(pair["dms"][0] if pkg == "port" else pair["jdms"][0],
                      tmp_path / "v1", base_fp="deadbeef00000000")
    with pytest.raises(ValueError):
        mod.load_artifact(tmp_path / "v1", expect_base_fp="badc0ffee0000000")
    store = mod.VariantStore(tmp_path / "s", base_fp="deadbeef00000000")
    store.publish("t", pair["dms"][0] if pkg == "port" else pair["jdms"][0])
    other = mod.VariantStore(tmp_path / "s", base_fp="badc0ffee0000000")
    with pytest.raises(ValueError):
        other.load("t")


def test_torn_manifest_and_patched_mismatch_raise(pair, tmp_path):
    store = S.VariantStore(tmp_path)
    _publish_chain(store, pair["dms"])
    # a patch whose recorded result sha does not match what it produces
    mpath = tmp_path / "task" / "v0002" / "manifest.json"
    m = json.loads(mpath.read_text())
    first = next(iter(m["deltas"]))
    m["deltas"][first]["sha"] = "0" * 16
    mpath.write_text(json.dumps(m))
    with pytest.raises(IOError):
        S.VariantStore(tmp_path).load("task", 2)
    with pytest.raises(IOError):
        JS.VariantStore(tmp_path).load("task", 2)
    mpath.write_text('{"deltas": {')
    with pytest.raises(IOError):
        S.read_manifest(mpath.parent)


# ---------------------------------------------------------------------------
# checkpoint baseline and the registry's artifact paths
# ---------------------------------------------------------------------------

def test_fp16_checkpoint_round_trip_and_size(pair, tmp_path):
    ft = bridge.params_from_numpy(pair["ft1"], "cpu")
    n_t = S.save_checkpoint_fp16(ft, tmp_path / "t.npz")
    n_j = JS.save_checkpoint_fp16(jax_tree(pair["jbase"], pair["ft1"]),
                                  tmp_path / "j.npz")
    assert n_t == n_j
    params, stats = L.load_full_checkpoint(str(tmp_path / "j.npz"), ft)
    for p, t in C.flatten_params(params).items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(
            t.numpy(), pair["ft1"][p].astype(np.float16).astype(np.float32))
    _, delta_stats = L.apply_artifact(pair["base"], pair["dms"][0],
                                      use_kernel=False)
    assert delta_stats["transferred_bytes"] * 1.3 < \
        stats["transferred_bytes"]


def test_registry_serves_artifact_dirs_and_survives_a_bad_one(pair,
                                                              tmp_path):
    S.save_artifact(pair["dms"][0], tmp_path / "task_a",
                    base_fp=S.base_fingerprint(pair["base"]))
    reg = VariantRegistry(pair["base"], max_resident=1)
    reg.set_version("task_a", None, tmp_path / "task_a")
    reg.set_version("broken", None, tmp_path / "nonexistent")
    eng = ServingEngine(build_model(pair["tcfg"]), reg, batch_size=2,
                        prompt_len=8, max_len=32, max_retries=1,
                        scheduler="group")
    ok = [eng.submit(np.arange(1, 6), variant=v, max_new_tokens=3)
          for v in ("__base__", "task_a", "task_a")]
    bad = eng.submit(np.arange(1, 6), variant="broken", max_new_tokens=3)
    eng.run_until_drained()
    assert all(eng.result(r).status == "done" and
               len(eng.result(r).out_tokens) == 3 for r in ok)
    assert eng.result(bad).status == "failed"
    assert eng.metrics["failed"] == 1
    assert reg.stats["swaps"] == 1            # task_a loaded once
    assert reg.stats["load_failures"] == 2    # first try + one retry
    # a lazy callable serves what the directory served
    reg2 = VariantRegistry(pair["base"], max_resident=1)
    reg2.set_version("task_a", None,
                     lambda: S.load_artifact(tmp_path / "task_a"))
    eng2 = ServingEngine(build_model(pair["tcfg"]), reg2, batch_size=2,
                         prompt_len=8, max_len=32, scheduler="group")
    r2 = eng2.submit(np.arange(1, 6), variant="task_a", max_new_tokens=3)
    eng2.run_until_drained()
    assert eng2.result(r2).out_tokens == eng.result(ok[1]).out_tokens
