"""Port parity for base-as-draft speculative decoding: the ladder and the
acceptance tracker, ``attention.verify_attention``, ``Model.verify_step``
and ``verify_rewind``, the round, and ``Deployment(speculative=True)``,
against the JAX package and the port's own sequential decode, on reduced
configs with fp32 compute (JAX ``init(PRNGKey(0))`` weights crossed
through ``repro_torch.bridge``; numpy-seeded tokens, frames, image
embeddings and fine-tunes).

Bounds, and why:

* ``default_k_ladder`` and ``AcceptanceTracker`` equal JAX's over the same
  ``observe`` calls (plain Python on both sides);
* ``verify_attention`` within 1e-5 of JAX's, each query slice within 1e-6
  of the port's ``decode_attention`` (fp32 sums in other orders);
* ``verify_step`` logits within 1e-4 of JAX's from the same cache, and
  within 1e-5 of the port's T sequential ``decode_step`` calls (through a
  bank over rows [0, v0, v1]) with the same argmax: the T-token pass runs
  its matmuls at B·T rows, so its sums are not ordered like decode's
  (JAX's own bit-equality test fails for three archs for that reason);
* a rewind ([1, T, 2] kept a row) and the draft's in-place K/V writes:
  the next decode step bit-equal to a cache that never saw the rejected
  suffix or the draft;
* a base-only round accepts all k drafts and returns the greedy chain;
* ``Deployment`` tokens: speculative equal to continuous for seven archs
  (one per family, the decoder family twice), for draft_k 1 and 4, over
  an int8 base, and equal to JAX's speculative ``Deployment`` on
  deepseek-7b and zamba2-7b (a native and a snapshot rewind), with the
  same round and acceptance counts.
"""
import copy

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _port_helpers import (configs, delta_model_numpy,  # noqa: E402
                           fine_tune_flat, jax_base, jax_tree)

from repro.configs import get_config  # noqa: E402
from repro.core import calibration as JC  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.serving import Deployment as JaxDeployment  # noqa: E402
from repro.serving import speculative as JSP  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.param import split  # noqa: E402
from repro_torch.serving import Deployment  # noqa: E402
from repro_torch.serving import speculative as SP  # noqa: E402
from repro_torch.serving.variants import OverlayBank  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.variants import VariantRegistry  # noqa: E402

ARCHS = ("qwen3-8b", "deepseek-7b", "deepseek-moe-16b", "internvl2-76b",
         "whisper-base", "xlstm-350m", "zamba2-7b")
B, PROMPT, T, MAX_LEN = 3, 6, 3, 48
KW = dict(batch_size=3, prompt_len=8, max_len=MAX_LEN, bank_size=4)


def _setup(arch):
    layers = get_config(arch).reduced().num_layers \
        if arch in ("xlstm-350m", "zamba2-7b") else 2
    jcfg, tcfg = configs(num_layers=layers, arch=arch)
    jmodel, jparams, flat = jax_base(jcfg)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(1, jcfg.vocab_size, size=(B, PROMPT))}
    if jcfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, jcfg.encoder_frames, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, jcfg.num_image_tokens, jcfg.d_model)).astype(np.float32)
    model = build_model(tcfg)
    params = bridge.params_from_numpy(flat, "cpu")
    fts = [fine_tune_flat(flat, seed, scale=0.05) for seed in (41, 42)]
    # the port's compress is byte-identical to JAX's (test_torch_delta);
    # JAX compresses only for its Deployment (``_jax_dms``)
    dms = [C.compress(params, bridge.params_from_numpy(ft, "cpu"))
           for ft in fts]
    bank = OverlayBank(params, 4)
    vidx = torch.tensor([0] + [bank.admit(f"v{i}", dm)[0]
                               for i, dm in enumerate(dms)])
    return {"arch": arch, "jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel,
            "jparams": jparams, "fts": fts, "model": model,
            "params": params, "dms": dms, "batch": batch, "bank": bank.tree,
            "vidx": vidx}


_CACHE: dict = {}


def _get(arch):
    if arch not in _CACHE:
        _CACHE[arch] = _setup(arch)
    return _CACHE[arch]


@pytest.fixture(params=ARCHS)
def s(request):
    return _get(request.param)


def _clone(tree):
    return copy.deepcopy(tree)


def _to_jax(tree):
    """A port cache as the JAX package's (same structure: dicts, lists)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _prefill(s, bank=False):
    """(first greedy token, cache) of the port's prefill over the module's
    batch, fp32 caches; ``bank`` serves rows [0, v0, v1]."""
    batch = {k: torch.from_numpy(v) for k, v in s["batch"].items()}
    ov, vidx = (s["bank"], s["vidx"]) if bank else (None, None)
    with torch.no_grad():
        last, cache = s["model"].prefill(s["params"], batch, MAX_LEN,
                                         cache_dtype=torch.float32,
                                         overlay=ov, variant_idx=vidx)
    return torch.argmax(last, -1).to(torch.int32), cache


def _sequential(s, tok, cache, n, bank=False):
    """n greedy decode steps from a clone of ``cache`` -> (logits (B, n,
    V), tokens (B, n+1) starting with ``tok``)."""
    ov, vidx = (s["bank"], s["vidx"]) if bank else (None, None)
    c, toks, logits = _clone(cache), [tok], []
    with torch.no_grad():
        for _ in range(n):
            lg, c = s["model"].decode_step(s["params"], toks[-1], c,
                                           overlay=ov, variant_idx=vidx)
            logits.append(lg)
            toks.append(torch.argmax(lg, -1).to(torch.int32))
    return torch.stack(logits, 1), torch.stack(toks, 1)


# ---------------------------------------------------------------------------
# the ladder and the acceptance tracker
# ---------------------------------------------------------------------------

def test_default_k_ladder_matches_jax():
    for k in range(1, 10):
        assert SP.default_k_ladder(k) == JSP.default_k_ladder(k)
    with pytest.raises(ValueError):
        SP.default_k_ladder(0)


@pytest.mark.parametrize("kw", [{}, {"cooldown": 2},
                                {"adaptive": False, "cooldown": 1},
                                {"ema_decay": 0.5, "low": 0.3, "high": 0.9}])
def test_acceptance_tracker_matches_jax(kw):
    rng = np.random.default_rng(7)
    got, want = SP.AcceptanceTracker(4, **kw), JSP.AcceptanceTracker(4, **kw)
    for i in range(60):
        lanes = int(rng.integers(0, 5))
        # runs of low, then high, then mixed acceptance walk the ladder
        frac = 0.1 if i < 20 else (1.0 if i < 40 else rng.random())
        acc = int(round(frac * got.current_k * lanes))
        k = got.current_k
        got.observe(k, acc, lanes)
        want.observe(k, acc, lanes)
        assert got.snapshot() == want.snapshot(), i
    assert got.acceptance == want.acceptance


# ---------------------------------------------------------------------------
# verify_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 5])
def test_verify_attention_matches_jax_and_decode_attention(window):
    """Per-row positions, slots holding stale entries past ``pos`` (a
    rewound draft's) and empty ones (-1): JAX's result within 1e-5, each
    query slice the port's decode attention at pos + s within 1e-6."""
    rng = np.random.default_rng(window)
    b, s, hq, hkv, hd, t = 3, 4, 4, 2, 8, 16
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, hd)).astype(np.float32)
    pos = np.array([3, 7, 10], np.int32)
    slot_pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    slot_pos[0, 12:] = -1
    got = A.verify_attention(*map(torch.from_numpy, (q, k, v, slot_pos,
                                                     pos)), window=window)
    want = JA.verify_attention(*map(jnp.asarray, (q, k, v, slot_pos, pos)),
                               window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    for j in range(s):
        one = A.decode_attention(torch.from_numpy(q[:, j:j + 1]),
                                 torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(slot_pos),
                                 torch.from_numpy(pos + j), window=window)
        np.testing.assert_allclose(got[:, j:j + 1].numpy(), one.numpy(),
                                   rtol=0, atol=1e-6)


def test_cache_insert_multi_equals_sequential_inserts():
    """The teacher-forced insert lands where T single-token decode
    inserts land, clipped to the last slot with unclipped ``slot_pos``."""
    rng = np.random.default_rng(1)
    kn = torch.from_numpy(rng.standard_normal((2, 4, 2, 8)).astype(
        np.float32))
    vn = kn + 1
    pos = torch.tensor([2, 6])               # row 1 runs past 8 slots
    got = A.make_kv_cache(2, 8, 2, 8, "cpu", torch.float32)
    want = _clone(got)
    A.cache_insert_multi(got, kn, vn, pos)
    for j in range(4):
        A.cache_insert(want, kn[:, j:j + 1], vn[:, j:j + 1], pos + j)
    for key in ("k", "v", "slot_pos"):
        assert torch.equal(got[key], want[key]), key
    assert got["slot_pos"][1].tolist() == [-1] * 6 + [6, 9]


# ---------------------------------------------------------------------------
# verify_step and the rewind
# ---------------------------------------------------------------------------

def test_verify_step_matches_jax_and_sequential_decode(s):
    """From one prefilled cache: the port's verify logits within 1e-4 of
    JAX's (no overlay; JAX runs it eagerly), and through the bank within
    1e-5 of the port's T sequential decode steps, the same argmax."""
    tok, cache = _prefill(s)
    _, toks = _sequential(s, tok, cache, T)
    seq = toks[:, :T]
    want, _ = s["jmodel"].verify_step(s["jparams"], jnp.asarray(seq.numpy()),
                                      _to_jax(cache))
    with torch.no_grad():
        got, _ = s["model"].verify_step(s["params"], seq, _clone(cache))
    assert got.shape == (B, T, s["tcfg"].padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)

    tok, cache = _prefill(s, bank=True)
    ref, toks = _sequential(s, tok, cache, T, bank=True)
    with torch.no_grad():
        got, _ = s["model"].verify_step(s["params"], toks[:, :T],
                                        _clone(cache), overlay=s["bank"],
                                        variant_idx=s["vidx"])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(torch.argmax(got, -1), torch.argmax(ref, -1))


def _scrub(tree, before, pos, keep):
    """A verified cache made to look as if each row consumed only its first
    keep[b] tokens: slots at positions pos[b]+keep[b]..pos[b]+T-1 get back
    their pre-verify entries, and ``pos`` advances by keep."""
    if isinstance(tree, list):
        return [_scrub(a, b, pos, keep) for a, b in zip(tree, before)]
    if set(tree) >= {"k", "v", "slot_pos"}:
        for r in range(pos.shape[0]):
            lo, hi = int(pos[r] + keep[r]), int(pos[r]) + T
            for key in ("k", "v", "slot_pos"):
                tree[key][:, r, lo:hi] = before[key][:, r, lo:hi]
        return tree
    out = {k: (_scrub(v, before[k], pos, keep) if isinstance(v, (dict, list))
               else v) for k, v in tree.items()}
    if "pos" in out:
        out["pos"] = pos + keep
    return out


def test_rewind_continues_like_a_cache_without_the_rejected_suffix(s):
    """Rows keep [1, T, 2] of a banked verify.  The next decode step from
    the rewound cache is bit-equal to one from a cache that never held the
    rejected tokens: for a native rewind, the same verify with the
    rejected slots restored; for a snapshot rewind, ``keep`` decode steps
    from the prefilled cache (zamba's KV caches, which every snapshot
    shares and which hold all T steps' writes, included)."""
    tok, cache = _prefill(s, bank=True)
    _, toks = _sequential(s, tok, cache, T, bank=True)
    keep = torch.tensor([1, T, 2], dtype=torch.int32)
    nxt = toks[torch.arange(B), keep]
    m, ov, vidx = s["model"], s["bank"], s["vidx"]
    with torch.no_grad():
        _, state = m.verify_step(s["params"], toks[:, :T], _clone(cache),
                                 overlay=ov, variant_idx=vidx)
        rewound = m.verify_rewind(state, keep)
        assert torch.equal(rewound["pos"], cache["pos"] + keep)
        got, _ = m.decode_step(s["params"], nxt, rewound, overlay=ov,
                               variant_idx=vidx)
        if state[0] == "pos":
            ref = _clone(cache)
            m.verify_step(s["params"], toks[:, :T], ref, overlay=ov,
                          variant_idx=vidx)
            ref = _scrub(ref, cache, cache["pos"], keep)
            want, _ = m.decode_step(s["params"], nxt, ref, overlay=ov,
                                    variant_idx=vidx)
        else:
            want = torch.empty_like(got)
            for j in set(keep.tolist()):
                c = _clone(cache)
                for i in range(j):
                    _, c = m.decode_step(s["params"], toks[:, i], c,
                                         overlay=ov, variant_idx=vidx)
                lg, _ = m.decode_step(s["params"], nxt, c, overlay=ov,
                                      variant_idx=vidx)
                want[keep == j] = lg[keep == j]
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["deepseek-7b", "whisper-base",
                                  "zamba2-7b"])
def test_draft_leaves_the_live_cache_to_the_verify(arch):
    """The draft decodes on a shallow copy of the cache dict: ``pos`` and
    the dict stay as they were, and its in-place K/V writes at
    pos..pos+k-1 are overwritten by the verify before anything reads
    them: a verify after a draft is bit-equal to one without."""
    s = _get(arch)
    tok, cache = _prefill(s, bank=True)
    live = _clone(cache)
    pos0 = live["pos"].clone()
    with torch.no_grad():
        drafts = SP.draft(s["model"], s["params"], tok, live, 3)
        assert drafts.shape == (B, 3) and drafts.dtype == torch.int32
        assert torch.equal(live["pos"], pos0) and set(live) == set(cache)
        seq = torch.cat([tok[:, None], drafts], 1)
        got, _ = s["model"].verify_step(s["params"], seq, live,
                                        overlay=s["bank"],
                                        variant_idx=s["vidx"])
        want, _ = s["model"].verify_step(s["params"], seq, _clone(cache),
                                         overlay=s["bank"],
                                         variant_idx=s["vidx"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["deepseek-7b", "xlstm-350m"])
def test_base_only_round_accepts_every_draft(arch):
    """Without an overlay the draft and the verify are one model: all k
    drafts accepted, ``ver`` the greedy chain, the next token its (k+1)-th,
    and the rewound cache continues it."""
    s, k = _get(arch), 3
    tok, cache = _prefill(s)
    ref, chain = _sequential(s, tok, cache, k + 2)
    with torch.no_grad():
        ver, n_acc, next_tok, new = SP.make_round_fn(s["model"], k)(
            s["params"], None, torch.zeros(B, dtype=torch.int32), tok,
            _clone(cache))
        lg, _ = s["model"].decode_step(s["params"], next_tok, new)
    assert n_acc.tolist() == [k] * B
    assert torch.equal(ver, chain[:, 1:k + 2])
    assert torch.equal(next_tok, chain[:, k + 1])
    np.testing.assert_allclose(lg.numpy(), ref[:, k + 1].numpy(), rtol=0,
                               atol=1e-5)
    assert torch.equal(torch.argmax(lg, -1).to(torch.int32), chain[:, k + 2])


# ---------------------------------------------------------------------------
# the engine and Deployment
# ---------------------------------------------------------------------------

VARIANTS = ["__base__", "v0", "v1", "v0", "__base__", "v1"]


def _serve(dep, s, dms):
    for i, dm in enumerate(dms):
        dep.publish(f"v{i}", dm)
    rng = np.random.default_rng(0)
    rids = [dep.submit(rng.integers(1, s["jcfg"].vocab_size, size=6),
                       variant=v, max_new_tokens=6 + (i % 3))
            for i, v in enumerate(VARIANTS)]
    dep.drain()
    return [dep.result(r).out_tokens for r in rids], rids


def _port(s, **kw):
    dep = Deployment(s["model"], s["params"], device="cpu", **KW, **kw)
    return (*_serve(dep, s, s["dms"]), dep)


def test_speculative_tokens_equal_continuous(s):
    cont, _, _ = _port(s)
    spec, rids, dep = _port(s, speculative=True, draft_k=3)
    assert spec == cont
    assert [len(t) for t in spec] == [6 + (i % 3) for i in range(6)]
    snap = dep.status()["speculative"]
    assert snap["ladder"] == [1, 2, 3] and snap["rounds"] > 0
    assert 0.0 <= snap["acceptance"] <= 1.0
    assert snap["rounds"] == dep.metrics["spec_rounds"]
    assert snap["accepted"] == dep.metrics["spec_accepted"]
    for rid in rids:
        st = dep.status(rid)
        assert 0.0 <= st["acceptance"] <= 1.0
        assert st["ttft_seconds"] is not None and st["ttft_seconds"] >= 0.0


@pytest.mark.parametrize("draft_k", [1, 4])
def test_speculative_parity_any_draft_k(draft_k):
    s = _get("deepseek-7b")
    cont, _, _ = _port(s)
    spec, _, dep = _port(s, speculative=True, draft_k=draft_k)
    assert spec == cont
    assert dep.status()["speculative"]["ladder"] == \
        SP.default_k_ladder(draft_k)


def test_fixed_draft_length_engine():
    """``spec_adaptive=False`` keeps every round at ``draft_k`` whatever
    the acceptance; the tokens stay the continuous scheduler's."""
    s = _get("deepseek-7b")
    cont, _, _ = _port(s)
    reg = VariantRegistry(s["params"], mode="fused", bank_size=4)
    for i, dm in enumerate(s["dms"]):
        reg.set_version(f"v{i}", 1, dm)
    eng = ServingEngine(s["model"], reg, batch_size=3, prompt_len=8,
                        max_len=MAX_LEN, scheduler="speculative", draft_k=4,
                        spec_adaptive=False)
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(1, s["jcfg"].vocab_size, size=6),
                       variant=v, max_new_tokens=6 + (i % 3))
            for i, v in enumerate(VARIANTS)]
    eng.run_until_drained()
    assert [eng.result(r).out_tokens for r in rids] == cont
    snap = eng.status()["speculative"]
    assert snap["current_k"] == 4 and snap["acceptance_ema"] < 0.4
    assert snap["drafted"] == eng.metrics["spec_drafted"] > 0
    assert eng.metrics["spec_drafted"] % 4 == 0


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-moe-16b",
                                  "zamba2-7b"])
def test_speculative_int8_base_tokens_equal_continuous(arch):
    s = _get(arch)
    cont, _, _ = _port(s, base_dtype="int8")
    spec, _, _ = _port(s, base_dtype="int8", speculative=True, draft_k=3)
    assert spec == cont


@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-7b"])
def test_speculative_deployment_matches_jax(arch):
    """One native and one snapshot family: per-request tokens and the
    round, draft and acceptance counts equal JAX's speculative
    ``Deployment`` (same adaptive ladder walk)."""
    s = _get(arch)
    jdms = [JC.compress(s["jparams"], jax_tree(s["jparams"], ft))
            for ft in s["fts"]]
    for jdm, dm in zip(jdms, s["dms"]):
        want_bytes = delta_model_numpy(jdm)["deltas"]
        for path, e in bridge.delta_model_to_numpy(dm)["deltas"].items():
            np.testing.assert_array_equal(e["packed"],
                                          want_bytes[path]["packed"])
    jdep = JaxDeployment(s["jmodel"], s["jparams"], mode="fused",
                         speculative=True, draft_k=3, **KW)
    want, _ = _serve(jdep, s, jdms)
    got, _, dep = _port(s, speculative=True, draft_k=3)
    assert got == want
    for key in ("spec_rounds", "spec_drafted", "spec_accepted",
                "tokens_generated", "prefills", "admitted", "retired"):
        assert dep.metrics[key] == jdep.metrics[key], key
    assert dep.status()["speculative"] == jdep.status()["speculative"]
    jdep.close()


def test_speculative_refusals():
    """Ring caches (gemma3-12b) are refused by the engine, the Deployment
    and ``verify_step``; speculative=True refuses the group scheduler and
    dense residency."""
    _, tcfg = configs(num_layers=2, arch="gemma3-12b")
    model = build_model(tcfg)
    base, _ = split(model.init(0, device="cpu"))
    reg = VariantRegistry(base, mode="fused", bank_size=2)
    with pytest.raises(ValueError, match="windowless"):
        ServingEngine(model, reg, scheduler="speculative")
    with pytest.raises(ValueError, match="windowless"):
        Deployment(model, base, speculative=True, device="cpu")
    cache = model.init_cache(1, 8, device="cpu")
    with pytest.raises(ValueError, match="windowless"):
        model.verify_step(base, torch.zeros((1, 2), dtype=torch.int64),
                          cache)
    s = _get("deepseek-7b")
    with pytest.raises(ValueError, match="group"):
        Deployment(s["model"], s["params"], scheduler="group",
                   speculative=True, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        Deployment(s["model"], s["params"], mode="dense", speculative=True,
                   device="cpu")
    with pytest.raises(ValueError, match="fused"):
        Deployment(s["model"], s["params"], mode="dense",
                   scheduler="speculative", device="cpu")


def test_serve_launcher_speculative_on_cpu(capsys):
    from repro_torch.launch import serve as SV
    SV.main(["--arch", "deepseek-7b", "--reduced", "--variants", "2",
             "--requests", "4", "--new-tokens", "3", "--mode", "fused",
             "--speculative", "--draft-k", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'tokens_generated': 12" in out
    assert "speculative: {'current_k'" in out and "'ladder': [1, 2]" in out
