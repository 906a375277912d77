"""Port parity: the group-scheduled Deployment against the JAX Deployment
(no store), dense and fused residency, same base and the same two delta
models, reduced qwen3-8b (2 layers, fp32 compute).  Per-request greedy
tokens must be identical and the registries must count the same swaps
and hits.  The continuous scheduler's parity tests are in
tests/test_torch_continuous.py."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _port_helpers import (configs, delta_model_numpy,  # noqa: E402
                           fine_tune_flat, jax_base, jax_tree)

from repro.core import calibration as JC  # noqa: E402
from repro.serving import Deployment as JaxDeployment  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Deployment  # noqa: E402

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
