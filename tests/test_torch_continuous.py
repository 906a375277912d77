"""Port parity for mixed-variant continuous batching: the banked GEMM's
plain version and wrapper, the overlay bank, banked prefill/decode and the
continuous-scheduled Deployment, against the JAX package on reduced
qwen3-8b (2 layers, fp32 compute), same weights and delta models.

Tolerances: the banked GEMM within 1e-5 (fp32 summation order; the JAX
kernel runs in Pallas interpret mode, as tests/test_continuous_batching.py
runs it); banked logits within 1e-4·max(|logit|, 1) of the JAX package and
of the port's own per-variant fused path, with identical greedy tokens;
served tokens and registry/engine counters identical."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _port_helpers import (configs, delta_model_numpy,  # noqa: E402
                           fine_tune_flat, jax_base, jax_tree)

from repro.core import calibration as JC  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.serving import Deployment as JaxDeployment  # noqa: E402
from repro.serving.variants import OverlayBank as JaxOverlayBank  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import loader as L  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import delta_overlay as DO  # noqa: E402
from repro_torch.serving import Deployment  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.variants import (OverlayBank,  # noqa: E402
                                          VariantRegistry)

KW = dict(batch_size=2, prompt_len=16, max_len=32)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs(num_layers=2)
    jmodel, jparams, flat = jax_base(jcfg)
    # fine-tunes far enough from the base that every variant changes the
    # greedy tokens, so a lane served from the wrong slot shows
    jdms = [JC.compress(jparams, jax_tree(jparams, fine_tune_flat(
        flat, s, scale=0.05))) for s in (21, 22)]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n)
               for n in (8, 16, 5, 12, 20, 8, 3)]
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel,
            "jparams": jparams, "flat": flat, "jdms": jdms,
            "model": build_model(tcfg),
            "params": bridge.params_from_numpy(flat, "cpu"),
            "dms": [bridge.delta_model_from_numpy(delta_model_numpy(d), "cpu")
                    for d in jdms],
            "prompts": prompts}


# ---------------------------------------------------------------------------
# banked GEMM: plain version and wrapper vs the JAX oracle and kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_shape,vidx_len,n,v", [
    ((4, 32), 4, 16, 2), ((8, 64), 8, 32, 5), ((6, 40), 6, 24, 3),
    ((2, 4, 32), 2, 16, 3)])
def test_banked_gemm_matches_jax(x_shape, vidx_len, n, v):
    k = x_shape[-1]
    rng = np.random.default_rng(sum(x_shape) + n + v)
    packed = rng.integers(0, 256, (v, n, k // 8)).astype(np.uint8)
    v_row = rng.normal(size=(v, n)).astype(np.float16)
    v_col = rng.normal(size=(v, k)).astype(np.float16)
    v_row[0] = 0
    v_col[0] = 0
    wb = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=x_shape).astype(np.float32)
    vidx = rng.integers(0, v, vidx_len).astype(np.int32)
    ops = (packed, v_row, v_col, wb)
    want_k = np.asarray(JK.bitlinear_axes_banked(
        jnp.asarray(x), jnp.asarray(vidx), *map(jnp.asarray, ops)))
    got_k = K.bitlinear_axes_banked(torch.from_numpy(x),
                                    torch.from_numpy(vidx),
                                    *map(torch.from_numpy, ops))
    assert got_k.shape == x_shape[:-1] + (n,) and got_k.dtype == torch.float32
    np.testing.assert_allclose(got_k.numpy(), want_k, rtol=1e-5, atol=1e-5)
    # the oracles on flattened rows
    x2 = x.reshape(-1, k)
    v2 = np.array(JK.flatten_vidx(jnp.asarray(vidx), x_shape[:-1]))
    np.testing.assert_array_equal(
        K.flatten_vidx(torch.from_numpy(vidx), x_shape[:-1]).numpy(), v2)
    want = np.asarray(JR.bitlinear_axes_banked_ref(
        jnp.asarray(x2), jnp.asarray(v2), *map(jnp.asarray, ops)))
    got = R.bitlinear_axes_banked_ref(torch.from_numpy(x2),
                                      torch.from_numpy(v2),
                                      *map(torch.from_numpy, ops))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_banked_gemm_rows_equal_single_variant_gemm():
    """Each row of a mixed batch equals the single-variant fused GEMM of
    its slot; slot-0 rows equal the plain base product."""
    rng = np.random.default_rng(0)
    v, n, k, m = 4, 32, 64, 8
    packed = torch.from_numpy(rng.integers(0, 256, (v, n, k // 8)
                                           ).astype(np.uint8))
    v_row = torch.from_numpy(rng.normal(size=(v, n)).astype(np.float16))
    v_col = torch.from_numpy(rng.normal(size=(v, k)).astype(np.float16))
    v_row[0] = 0
    v_col[0] = 0
    wb = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    vidx = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3], dtype=torch.int32)
    y = K.bitlinear_axes_banked(x, vidx, packed, v_row, v_col, wb)
    for s in range(v):
        rows = vidx == s
        want = K.bitlinear_axes(x, packed[s], v_row[s], v_col[s], wb)
        torch.testing.assert_close(y[rows], want[rows], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y[vidx == 0], (x @ wb.T)[vidx == 0],
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# overlay bank
# ---------------------------------------------------------------------------

def test_bank_admit_pin_evict_slot_reuse(setup):
    s = setup
    bank = OverlayBank(s["params"], 3)           # base + 2 variant slots
    jbank = JaxOverlayBank(s["jparams"], 3)
    dm1, dm2 = s["dms"]
    s1, payload = bank.admit("a", dm1)
    assert (s1, payload) == jbank.admit("a", s["jdms"][0])
    assert s1 == 1 and payload > 0
    s2, _ = bank.admit("b", dm2)
    assert s2 == 2
    jbank.admit("b", s["jdms"][1])
    assert bank.nbytes() == jbank.nbytes() > 0
    # layer 0 of the banked w_up, slot s1: variant a's canonical entry
    e = bank.tree["layers"]["mlp"]["w_up"]
    got = DO.entry_slot(DO.OverlayEntry(e.packed[0], e.v_row[0],
                                        e.v_col[0]), s1)
    want = DO.from_delta_entry(dm1.deltas["layers.mlp.w_up"])
    for g, w in ((got.packed, want.packed), (got.v_row, want.v_row),
                 (got.v_col, want.v_col)):
        assert torch.equal(g, w[0])
    assert bank.admit("a", dm1) == (1, 0)        # re-admit: a hit
    bank.pin("a")
    bank.pin("b")
    with pytest.raises(RuntimeError):            # full, everything pinned
        bank.admit("c", dm1)
    with pytest.raises(RuntimeError):            # pinned eviction refuses
        bank.evict("b")
    bank.unpin("b")
    s3, _ = bank.admit("c", dm1)                 # evicts "b" (LRU unpinned)
    assert s3 == 2 and bank.resident() == ["a", "c"]
    assert bank.stats["evictions"] == 1
    bank.unpin("a")
    bank.evict("a")                              # slot 1 back to the base
    assert bank.slot_of("c") == 2 and not bank.holds("a")
    emb = bank.tree["embed"]
    assert torch.equal(emb[1], s["params"]["embed"])
    assert not bank.tree["layers"]["attn"]["wq"].v_row[:, 1].any()


# ---------------------------------------------------------------------------
# banked prefill / decode
# ---------------------------------------------------------------------------

def test_mixed_prefill_decode_matches_jax_and_per_variant(setup):
    s = setup
    model, params = s["model"], s["params"]
    bank = OverlayBank(params, 4)
    jbank = JaxOverlayBank(s["jparams"], 4)
    slots = [bank.admit(f"v{i}", dm)[0] for i, dm in enumerate(s["dms"])]
    for i, jdm in enumerate(s["jdms"]):
        jbank.admit(f"v{i}", jdm)
    toks = np.random.default_rng(7).integers(1, s["jcfg"].vocab_size, (3, 8))
    vidx = np.array([0] + slots, np.int32)

    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 32,
                              overlay=bank.tree,
                              variant_idx=torch.from_numpy(vidx))
    tok = torch.argmax(lg, -1).to(torch.int32)
    dl, _ = model.decode_step(params, tok, cache, overlay=bank.tree,
                              variant_idx=torch.from_numpy(vidx))
    jlg, jcache = s["jmodel"].prefill(
        s["jparams"], {"tokens": jnp.asarray(toks)}, 32, overlay=jbank.tree,
        variant_idx=jnp.asarray(vidx))
    jdl, _ = s["jmodel"].decode_step(
        s["jparams"], jnp.asarray(tok.numpy()), jcache, overlay=jbank.tree,
        variant_idx=jnp.asarray(vidx))

    # per-variant fused serving of each row, through the port's own path
    want_pre, want_dec = [], []
    for row, dm in enumerate([None] + s["dms"]):
        if dm is None:
            view, ov = params, None
        else:
            view, ov, _ = L.device_put_overlay(params, dm)
        pl, pc = model.prefill(view, {"tokens": torch.from_numpy(toks)}, 32,
                               overlay=ov)
        pd, _ = model.decode_step(view, torch.argmax(pl, -1).to(torch.int32),
                                  pc, overlay=ov)
        want_pre.append(pl[row])
        want_dec.append(pd[row])
    want_pre, want_dec = torch.stack(want_pre), torch.stack(want_dec)

    tol = 1e-4 * max(float(want_pre.abs().max()), 1.0)
    for got, jax_want, own in ((lg, jlg, want_pre), (dl, jdl, want_dec)):
        jax_want = torch.from_numpy(np.array(jax_want))
        assert float((got - jax_want).abs().max()) < tol
        assert float((got - own).abs().max()) < tol
        assert torch.equal(got.argmax(-1), jax_want.argmax(-1))
        assert torch.equal(got.argmax(-1), own.argmax(-1))
    # the variants really change the model
    assert float((lg[1:] - lg[0]).abs().max()) > 1e-3


def test_cache_batch_axes_match_jax_cache_pspecs(setup):
    import jax
    s = setup
    spec = s["jmodel"].cache_pspecs()
    want = jax.tree.map(lambda a: a.index("act_batch"), spec,
                        is_leaf=lambda x: isinstance(x, tuple))
    assert s["model"].cache_batch_axes() == want
    cache = s["model"].init_cache(3, 16, device="cpu")
    assert cache["pos"].shape[want["pos"]] == 3
    for slot, axes in zip(cache["slots"], want["slots"]):
        assert all(slot[k].shape[ax] == 3 for k, ax in axes.items())


# ---------------------------------------------------------------------------
# continuous-scheduled Deployment
# ---------------------------------------------------------------------------

BUDGETS = [2, 5, 3, 4, 1, 3, 2]


def _serve(dep, prompts, names, budgets=BUDGETS):
    rids = [dep.submit(p, variant=names[i % len(names)],
                       max_new_tokens=budgets[i % len(budgets)])
            for i, p in enumerate(prompts)]
    dep.drain()
    return [dep.result(r).out_tokens for r in rids]


@pytest.mark.parametrize("bank_size", [4, 2])
def test_continuous_deployment_matches_jax(setup, bank_size):
    """bank_size 2 holds one variant: admissions wait for pinned lanes to
    retire and evict the other variant's slot."""
    s = setup
    jdep = JaxDeployment(s["jmodel"], s["jparams"], bank_size=bank_size,
                         **KW)
    dep = Deployment(s["model"], s["params"], bank_size=bank_size,
                     device="cpu", **KW)
    assert dep.engine.scheduler == jdep.engine.scheduler == "continuous"
    for i, (jdm, dm) in enumerate(zip(s["jdms"], s["dms"])):
        assert jdep.publish(f"v{i}", jdm) == dep.publish(f"v{i}", dm)
    names = ["__base__", "v0", "v1"]
    want = _serve(jdep, s["prompts"], names)
    got = _serve(dep, s["prompts"], names)
    assert got == want
    assert [len(t) for t in got] == BUDGETS
    for key in ("swaps", "hits", "evictions", "resident_bytes",
                "transferred_bytes"):
        assert dep.stats[key] == jdep.stats[key], key
    for key in ("admitted", "retired", "prefills", "decode_steps",
                "tokens_generated", "failed"):
        assert dep.metrics[key] == jdep.metrics[key], key
    if bank_size == 2:
        assert dep.stats["evictions"] > 0
    st = dep.status()
    assert st["scheduler"] == "continuous" and st["active"] == 0
    assert dep.status(0)["status"] == "done"
    jdep.close()


def _registry(s, bank_size=4):
    reg = VariantRegistry(s["params"], mode="fused", max_resident=4,
                          bank_size=bank_size)
    for i, dm in enumerate(s["dms"]):
        reg.set_version(f"v{i}", None, dm)
    return reg


def test_continuous_tokens_equal_group_fused_tokens(setup):
    s = setup

    def run(scheduler):
        eng = ServingEngine(s["model"], _registry(s), scheduler=scheduler,
                            **KW)
        rids = [eng.submit(p, variant=v, max_new_tokens=3)
                for p, v in zip(s["prompts"],
                                ["v0", "__base__", "v1", "v0", "v1"])]
        eng.run_until_drained()
        return [eng.result(r).out_tokens for r in rids]

    assert run("continuous") == run("group")


def test_lane_reuse_keeps_isolation(setup):
    """A request admitted into a REUSED lane decodes exactly what it
    decodes in a fresh engine (the cache-row merge isolates lanes)."""
    s = setup
    p = s["prompts"]
    eng = ServingEngine(s["model"], _registry(s), scheduler="continuous",
                        **KW)
    eng.submit(p[0], variant="v0", max_new_tokens=2)
    eng.submit(p[1], variant="__base__", max_new_tokens=6)
    late = eng.submit(p[2], variant="v1", max_new_tokens=3)
    eng.run_until_drained()
    assert eng.metrics["prefills"] == 2

    solo = ServingEngine(s["model"], _registry(s), scheduler="continuous",
                         **KW)
    ref = solo.submit(p[2], variant="v1", max_new_tokens=3)
    solo.run_until_drained()
    assert eng.result(late).out_tokens == solo.result(ref).out_tokens


def test_evicting_a_pinned_variant_mid_flight_raises(setup):
    s = setup
    reg = _registry(s)
    eng = ServingEngine(s["model"], reg, scheduler="continuous", **KW)
    rid = eng.submit(s["prompts"][0], variant="v0", max_new_tokens=4)
    eng._prefill_admitted(eng._admit_free_slots())   # admitted, not drained
    assert eng.status(rid) == "running" and eng.active() == 1
    with pytest.raises(RuntimeError):
        reg.evict("v0")
    eng.run_until_drained()                          # retires: unpinned
    assert eng.result(rid).status == "done"
    reg.evict("v0")
    assert "v0" not in reg.bank.resident()
    assert reg.stats["evictions"] == 1


def test_deployment_scheduler_guards(setup):
    s = setup
    with pytest.raises(ValueError):
        Deployment(s["model"], s["params"], mode="dense", device="cpu", **KW)
    with pytest.raises(ValueError):          # the bank is fused-only
        Deployment(s["model"], s["params"], scheduler="speculative",
                   mode="dense", device="cpu", **KW)
    with pytest.raises(ValueError):
        Deployment(s["model"], s["params"], scheduler="lockstep",
                   device="cpu", **KW)
    dep = Deployment(s["model"], s["params"], device="cpu", **KW)
    with pytest.raises(ValueError):
        dep.publish("d", s["dms"][0], mode="dense")
    assert dep.publish("a", s["dms"][0], wait=True) == 1
    assert dep.registry.bank.holds("a@v1") and dep.stats["swaps"] == 1
    assert dep.update("a", s["dms"][1], wait=True) == 2
    assert dep.registry.bank.resident() == ["a@v1", "a@v2"]
    assert dep.rollback("a", wait=True) == 1 and dep.stats["hits"] == 1


def test_serve_launcher_continuous_on_cpu(capsys):
    SV.main(["--arch", "qwen3-8b", "--reduced", "--num-layers", "1",
             "--variants", "2", "--requests", "5", "--new-tokens", "2",
             "--mode", "fused", "--scheduler", "continuous",
             "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'tokens_generated': 10" in out and "'swaps': 2" in out
    assert "'admitted': 5" in out and "'retired': 5" in out
    with pytest.raises(SystemExit):
        SV.main(["--arch", "qwen3-8b", "--reduced", "--mode", "dense",
                 "--scheduler", "continuous", "--device", "cpu"])


def test_budgets_cycle_over_requests(setup):
    dep = Deployment(setup["model"], setup["params"], device="cpu", **KW)
    rids = SV.submit_requests(dep, setup["tcfg"], 5, [1, 3])
    dep.drain()
    assert [len(dep.result(r).out_tokens) for r in rids] == [1, 3, 1, 3, 1]
