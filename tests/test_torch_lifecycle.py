"""Port parity: the paper's lifecycle — calibrate, publish, serve from the
store, update by patch, roll back, restart over the same directory — as
``examples/quickstart.py`` runs it, on both packages.

The base/fine-tune pair is trained by the JAX package (as the quickstart
trains it) and crosses to the port through ``bridge``; each package then
calibrates, publishes into its own store root and serves with the
continuous scheduler.  Versions, ``artifact_bytes`` and every request's
greedy tokens must equal JAX's; a second Deployment over the same
directory hydrates lazily and serves the same tokens.  Also
``launch/serve.py --store-dir`` on the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _port_helpers import numpy_flat  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import calibration as JC  # noqa: E402
from repro.core import loader as JL  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import Deployment as JaxDeployment  # noqa: E402
from repro.train.step import init_train_state, make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.core import loader as L  # noqa: E402
from repro_torch.core import store as S  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import Deployment  # noqa: E402

KW = dict(batch_size=4, prompt_len=16, max_len=64)
CAL = dict(epochs=2, e2e_epochs=2, lr=1e-3, e2e_lr=1e-3)
ATTN = ("wq", "wk", "wv", "wo")


@pytest.fixture(scope="module")
def trained():
    """Quickstart steps 1 and 4: a trained base, a fine-tune on a shifted
    distribution, and an attention-only refresh of it (JAX training)."""
    kw = dict(num_layers=2, compute_dtype="float32", remat=False)
    jcfg = dataclasses.replace(get_config("qwen3-8b").reduced(), **kw)
    tcfg = dataclasses.replace(TC.get_config("qwen3-8b").reduced(), **kw)
    jmodel = jax_build_model(jcfg)
    step = jax.jit(make_train_step(jmodel, peak_lr=5e-3, warmup=5))
    state = init_train_state(jmodel, jax.random.PRNGKey(0))
    src = SyntheticLM(jcfg.vocab_size, seed=0)
    for i in range(30):
        state, _ = step(state, src.lm_batch(i, 4, 32))
    base = state.params
    ft_src = SyntheticLM(jcfg.vocab_size, seed=7)
    for i in range(15):
        state, _ = step(state, ft_src.lm_batch(i, 4, 32))
    ft = state.params
    for i in range(15, 19):
        state, _ = step(state, ft_src.lm_batch(i, 4, 32))
    old_flat = JC.flatten_params(ft)
    new_flat = JC.flatten_params(state.params)
    refreshed = JC.unflatten_like(base, {
        p: new_flat[p] if p.split(".")[-1] in ATTN else v
        for p, v in old_flat.items()})
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel, "jbase": base,
            "jft": ft, "jrefreshed": refreshed,
            "base": numpy_flat(base), "ft": numpy_flat(ft),
            "refreshed": numpy_flat(refreshed),
            "calib": [ft_src.lm_batch(1000 + i, 4, 32) for i in range(3)],
            "held_out": ft_src.lm_batch(9999, 4, 32)}


def _serve(dep, requests):
    rids = [dep.submit(tokens, variant=v, max_new_tokens=n)
            for tokens, v, n in requests]
    dep.drain()
    return ([dep.result(r).out_tokens for r in rids],
            [dep.status(r)["version"] for r in rids])


def _requests(variant, vocab):
    rng = np.random.default_rng(3)
    return [(np.arange(1, 9), variant, 8),
            (rng.integers(1, vocab, size=12), "__base__", 5),
            (rng.integers(1, vocab, size=6), variant, 6)]


def test_quickstart_lifecycle_matches_jax(trained, tmp_path):
    t = trained
    reqs = _requests("task_a", t["jcfg"].vocab_size)
    # -- JAX, as examples/quickstart.py runs it ---------------------------
    jdm, _ = JC.calibrate_transformer(t["jmodel"], t["jbase"], t["jft"],
                                      t["calib"], **CAL)
    jdep = JaxDeployment(t["jmodel"], t["jbase"],
                         root_dir=tmp_path / "jax", **KW)
    jv1 = jdep.publish("task_a", jdm)
    want = {"v1": _serve(jdep, reqs)}
    jv2 = jdep.update("task_a", JC.compress(t["jbase"], t["jrefreshed"]))
    want["v2"] = _serve(jdep, reqs)
    jdep.rollback("task_a")
    want["rollback"] = _serve(jdep, reqs)
    jdep.close()
    jdep2 = JaxDeployment(t["jmodel"], t["jbase"],
                          root_dir=tmp_path / "jax", **KW)
    want["restart"] = _serve(jdep2, reqs)
    jdep2.close()

    # -- the port ----------------------------------------------------------
    model = build_model(t["tcfg"])
    base = bridge.params_from_numpy(t["base"], "cpu")
    ft = bridge.params_from_numpy(t["ft"], "cpu")
    dm, report = C.calibrate_transformer(model, base, ft, t["calib"], **CAL)
    assert set(report["axis"]) == {"attn." + a for a in ATTN} | {
        "mlp.w_gate", "mlp.w_up", "mlp.w_down"}
    dep = Deployment(model, base, root_dir=tmp_path / "port", device="cpu",
                     **KW)
    v1 = dep.publish("task_a", dm)
    assert v1 == jv1 == 1
    assert dep.store.artifact_bytes("task_a", 1) == \
        jdep.store.artifact_bytes("task_a", 1)
    got = {"v1": _serve(dep, reqs)}
    v2 = dep.update("task_a", C.compress(
        base, bridge.params_from_numpy(t["refreshed"], "cpu")))
    assert v2 == jv2 == 2
    patch = dep.store.artifact_bytes("task_a", 2)
    assert patch == jdep.store.artifact_bytes("task_a", 2)
    assert patch < 0.5 * dep.store.artifact_bytes("task_a", 1)
    assert dep.store.version_info("task_a", 2)["kind"] == "patch"
    got["v2"] = _serve(dep, reqs)
    assert dep.rollback("task_a") == 1 and dep.current("task_a") == 1
    got["rollback"] = _serve(dep, reqs)
    assert dep.versions("task_a") == [1, 2]

    # a restarted node over the same directory hydrates lazily
    dep2 = Deployment(model, base, root_dir=tmp_path / "port", device="cpu",
                      **KW)
    assert dep2.registry.registered() == ["__base__"]
    assert dep2.variants() == ["__base__", "task_a"]
    got["restart"] = _serve(dep2, reqs)
    assert dep2.current("task_a") == 1
    pinned, _ = _serve(dep2, [(np.arange(1, 9), "task_a@v2", 8)])
    assert pinned[0] == got["v2"][0][0]

    # eager hydration registers the whole lineage at construction; a
    # caller-made store serves the same
    dep3 = Deployment(model, base, store=S.VariantStore(tmp_path / "port"),
                      eager=True, device="cpu", **KW)
    assert dep3.registry.registered() == ["__base__", "task_a"]
    assert dep3.registry.versions("task_a") == [1, 2]
    assert dep3.current("task_a") == 1
    assert _serve(dep3, reqs[:1])[0] == got["rollback"][0][:1]
    with pytest.raises(ValueError):
        Deployment(model, base, root_dir=tmp_path / "port",
                   store=dep3.store, device="cpu", **KW)

    assert got == want
    assert [v for v in got["v1"][1]] == [1, None, 1]
    assert got["v2"][1] == [2, None, 2] and got["rollback"][1] == [1, None, 1]
    assert got["restart"][0] == got["rollback"][0]
    for d in (dep, dep2):
        assert d.stats["load_failures"] == 0

    # quickstart step 5: the served weights beat the base on held-out logits
    tokens = {"tokens": torch.from_numpy(t["held_out"]["tokens"]).long()}
    with torch.no_grad():
        student, _ = L.apply_artifact(base, dep.store.load("task_a", 1),
                                      use_kernel=False)
        teacher = T.forward(ft, tokens, t["tcfg"])[0]
        err = float(((teacher - T.forward(student, tokens,
                                          t["tcfg"])[0]) ** 2).mean())
        base_err = float(((teacher - T.forward(base, tokens,
                                               t["tcfg"])[0]) ** 2).mean())
    jstudent, _ = JL.apply_artifact(t["jbase"],
                                    jdep.store.load("task_a", 1))
    jfwd = jax.jit(lambda p, b: t["jmodel"].forward(p, b)[0])
    jb = {"tokens": t["held_out"]["tokens"]}
    jerr = float(((jfwd(t["jft"], jb) - jfwd(jstudent, jb)) ** 2).mean())
    np.testing.assert_allclose(err, jerr, rtol=5e-2)
    assert err < base_err


def test_serve_cli_with_a_store_dir(tmp_path, capsys):
    SV.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
             "--mode", "fused", "--scheduler", "continuous",
             "--variants", "2", "--requests", "6", "--new-tokens", "3",
             "--store-dir", str(tmp_path / "store")])
    out = capsys.readouterr().out
    assert "store:" in out and "'load_failures': 0" in out
    for name in ("v0", "v1"):
        assert (tmp_path / "store" / name / "versions.json").exists()
        assert (tmp_path / "store" / name / "v0001" / "manifest.json").exists()
    assert "'tokens_generated': 18" in out
