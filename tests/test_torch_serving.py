"""Port parity: the group-scheduled Deployment against the JAX Deployment
(no store), dense and fused residency, same base and the same two delta
models, reduced qwen3-8b (2 layers, fp32 compute).  Per-request greedy
tokens must be identical and the registries must count the same swaps
and hits.  The registry's accessors (``register``, ``params_for``,
``resident``, ``resident_nbytes``), the engine's TTFT reservoir and the
Deployment's ``pending``/``active`` behave as the JAX package's.  The
continuous scheduler's parity tests are in tests/test_torch_continuous.py;
the launcher's in tests/test_torch_launch.py."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _port_helpers import (configs, delta_model_numpy,  # noqa: E402
                           fine_tune_flat, jax_base, jax_tree)

from repro.core import calibration as JC  # noqa: E402
from repro.serving import Deployment as JaxDeployment  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.variants import \
    VariantRegistry as JaxVariantRegistry  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Deployment  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402
from repro_torch.serving.variants import VariantRegistry  # noqa: E402

KW = dict(batch_size=4, prompt_len=16, max_len=32)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs(num_layers=2)
    jmodel, jparams, flat = jax_base(jcfg)
    jdms = [JC.compress(jparams, jax_tree(jparams, fine_tune_flat(flat, s)))
            for s in (11, 12)]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n)
               for n in (8, 16, 20, 5, 8, 12)]
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel,
            "jparams": jparams, "flat": flat, "jdms": jdms,
            "dms": [delta_model_numpy(d) for d in jdms], "prompts": prompts}


def _serve(dep, prompts, names):
    rids = [dep.submit(p, variant=names[i % len(names)], max_new_tokens=4)
            for i, p in enumerate(prompts)]
    dep.drain()
    return [dep.result(r).out_tokens for r in rids]


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_deployment_tokens_and_stats_match_jax(setup, mode):
    s = setup
    jdep = JaxDeployment(s["jmodel"], s["jparams"], mode=mode,
                         scheduler="group", **KW)
    dep = Deployment(build_model(s["tcfg"]),
                     bridge.params_from_numpy(s["flat"], "cpu"), mode=mode,
                     scheduler="group", device="cpu", **KW)
    for i, (jdm, dm) in enumerate(zip(s["jdms"], s["dms"])):
        assert jdep.publish(f"v{i}", jdm) == dep.publish(
            f"v{i}", bridge.delta_model_from_numpy(dm, "cpu"))
    names = ["__base__", "v0", "v1"]
    want = _serve(jdep, s["prompts"], names)
    got = _serve(dep, s["prompts"], names)
    assert got == want
    assert all(len(t) == 4 for t in got)
    for key in ("swaps", "hits", "evictions"):
        assert dep.stats[key] == jdep.stats[key], key
    assert dep.metrics["tokens_generated"] == jdep.metrics["tokens_generated"]
    assert dep.status(0)["status"] == "done"
    jdep.close()


def test_deployment_lifecycle_versions(setup):
    s = setup
    dep = Deployment(build_model(s["tcfg"]),
                     bridge.params_from_numpy(s["flat"], "cpu"),
                     mode="dense", scheduler="group", device="cpu", **KW)
    dms = [bridge.delta_model_from_numpy(d, "cpu") for d in s["dms"]]
    assert dep.publish("a", dms[0], wait=True) == 1
    assert dep.update("a", dms[1]) == 2
    rid = dep.submit(s["prompts"][0], variant="a", max_new_tokens=2)
    dep.drain()
    assert dep.status(rid)["version"] == 2
    assert dep.rollback("a") == 1 and dep.current("a") == 1
    rid = dep.submit(s["prompts"][0], variant="a@v2", max_new_tokens=2)
    dep.drain()
    assert dep.status(rid)["version"] == 2
    assert dep.versions("a") == [1, 2]
    assert dep.status(999) == {"status": "unknown", "rid": 999}
    with pytest.raises(KeyError):
        dep.update("missing", dms[0])


def test_deployment_needs_a_card_unless_cpu_is_asked(setup):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        Deployment(build_model(setup["tcfg"]),
                   bridge.params_from_numpy(setup["flat"], "cpu"))


def test_serve_launcher_runs_on_cpu(capsys):
    SV.main(["--arch", "qwen3-8b", "--reduced", "--num-layers", "1",
             "--variants", "1", "--requests", "3", "--new-tokens", "2",
             "--mode", "fused", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'tokens_generated': 6" in out and "'swaps': 1" in out


def _accessors(reg, dm) -> list:
    """The JAX package's registry accessor contract
    (tests/test_fused_serving.py:125-152) run on ``reg``; returns what it
    saw, to hold the two packages against each other."""
    seen = []
    reg.register("a", dm)
    reg.register("b", dm)
    _, ov_a = reg.resolve("a")
    assert ov_a is not None
    bytes_a = reg.stats["resident_bytes"]
    assert bytes_a == reg.resident_nbytes("a") > 0
    seen.append(bytes_a)
    reg.resolve("b")                     # evicts "a" (LRU, capacity 1)
    assert reg.resident() == ["b"]
    assert reg.stats["evictions"] == 1
    assert reg.stats["resident_bytes"] == reg.resident_nbytes("b")
    reg.evict("b")
    assert reg.resident() == [] and reg.stats["resident_bytes"] == 0
    # params_for is dense-only, and its refusal loads nothing, admits no
    # resident and counts no swap
    swaps = reg.stats["swaps"]
    with pytest.raises(ValueError):
        reg.params_for("a")
    assert reg.stats["swaps"] == swaps and reg.resident() == []
    with pytest.raises(KeyError):
        reg.resident_nbytes("a")
    seen.append({k: v for k, v in reg.stats.items() if k != "swap_seconds"})
    return seen


def test_registry_accessors_match_jax(setup):
    s = setup
    dm = bridge.delta_model_from_numpy(s["dms"][0], "cpu")
    params = bridge.params_from_numpy(s["flat"], "cpu")
    want = _accessors(JaxVariantRegistry(s["jparams"], max_resident=1,
                                         mode="fused"), s["jdms"][0])
    assert _accessors(VariantRegistry(params, max_resident=1,
                                      mode="fused"), dm) == want
    # max_resident=0 caches nothing: it still serves, never retains
    for reg, d in ((JaxVariantRegistry(s["jparams"], max_resident=0,
                                       mode="fused"), s["jdms"][0]),
                   (VariantRegistry(params, max_resident=0, mode="fused"),
                    dm)):
        reg.register("a", d)
        _, ov = reg.resolve("a")
        assert ov is not None and reg.resident() == []
        assert reg.stats["resident_bytes"] == 0
        assert reg.stats["evictions"] == 1


def test_registry_params_for_and_resident_nbytes_dense_vs_fused(setup):
    """``params_for`` materialises a dense variant (JAX's values within
    fp32 rounding); a fused resident costs under a quarter of a dense one
    (tests/test_system.py:76-90), with the JAX registry's byte counts."""
    s = setup
    dm = bridge.delta_model_from_numpy(s["dms"][0], "cpu")
    params = bridge.params_from_numpy(s["flat"], "cpu")
    nbytes = {}
    for mode in ("dense", "fused"):
        jreg = JaxVariantRegistry(s["jparams"], mode=mode)
        reg = VariantRegistry(params, mode=mode)
        jreg.register("v", s["jdms"][0])
        reg.register("v", dm)
        if mode == "dense":
            got = C.flatten_params(reg.params_for("v"))
            want = JC.flatten_params(jreg.params_for("v"))
            assert sorted(got) == sorted(want)
            for path, w in want.items():
                np.testing.assert_allclose(got[path].numpy(), np.asarray(w),
                                           rtol=0, atol=1e-5, err_msg=path)
            assert reg.params_for("__base__") is reg.base_params
        else:
            reg.resolve("v")
            jreg.resolve("v")
        nbytes[mode] = reg.resident_nbytes("v")
        assert nbytes[mode] == jreg.resident_nbytes("v"), mode
        assert reg.resident() == jreg.resident() == ["v"]
    assert nbytes["fused"] < nbytes["dense"] / 4


def test_ttft_reservoir_and_percentiles_match_jax(setup):
    """The bounded TTFT reservoir: the first ``cap`` samples fill it, each
    later one overwrites slot n % cap in arrival order (no RNG), and
    status()["ttft"] reports p50/p99 over it beside the count, mean and
    max over every request, as the JAX engine does."""
    import time
    s = setup
    jdep = JaxDeployment(s["jmodel"], s["jparams"], scheduler="group", **KW)
    dep = Deployment(build_model(s["tcfg"]),
                     bridge.params_from_numpy(s["flat"], "cpu"),
                     scheduler="group", device="cpu", **KW)
    assert dep.engine._ttft_cap == jdep.engine._ttft_cap == 1024
    delays = [0.5, 0.1, 0.3, 0.2, 0.4, 0.6, 0.05]
    for d, cls in ((dep, Request), (jdep, JaxRequest)):
        d.engine._ttft_cap = 4
        now = time.perf_counter()
        for i, late in enumerate(delays):
            d.engine._note_first_token(cls(rid=i, tokens=np.arange(3),
                                           submitted_at=now - late))
    got, want = dep.status()["ttft"], jdep.status()["ttft"]
    assert sorted(got) == sorted(want) == [
        "count", "max_seconds", "mean_seconds", "p50_seconds",
        "p99_seconds"]
    # slots 0, 1, 2 were overwritten by the 5th, 6th and 7th samples
    assert np.round(dep.engine._ttft_samples, 2).tolist() == \
        np.round(jdep.engine._ttft_samples, 2).tolist() == [
            0.4, 0.6, 0.05, 0.2]
    assert got["count"] == want["count"] == len(delays)
    for key in ("max_seconds", "mean_seconds", "p50_seconds",
                "p99_seconds"):
        assert abs(got[key] - want[key]) < 0.05, key
    assert 0 < got["p50_seconds"] <= got["p99_seconds"] <= got["max_seconds"]
    jdep.close()


def test_deployment_pending_and_active_match_jax(setup):
    """``Deployment.pending()``/``active()`` delegate to the engine: queued
    requests before a drain, none of either after it."""
    s = setup
    jdep = JaxDeployment(s["jmodel"], s["jparams"], scheduler="continuous",
                         mode="fused", **KW)
    dep = Deployment(build_model(s["tcfg"]),
                     bridge.params_from_numpy(s["flat"], "cpu"),
                     scheduler="continuous", mode="fused", device="cpu",
                     **KW)
    for d in (dep, jdep):
        assert (d.pending(), d.active()) == (0, 0)
        for p in s["prompts"][:3]:
            d.submit(p, max_new_tokens=2)
    assert (dep.pending(), dep.active()) == (jdep.pending(),
                                             jdep.active()) == (3, 0)
    dep.drain(max_steps=1)
    assert dep.pending() == 0 and dep.active() == 3
    dep.drain()
    assert (dep.pending(), dep.active()) == (0, 0)
    ttft = dep.status()["ttft"]
    assert ttft["count"] == 3
    assert 0 < ttft["p50_seconds"] <= ttft["p99_seconds"] \
        <= ttft["max_seconds"]
    jdep.close()
