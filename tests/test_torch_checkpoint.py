"""Port parity: ``checkpoint/manager`` and the fault-tolerant
``train/loop.Trainer``.

The port writes the JAX package's on-disk format (the same flat keys,
dtypes and sha prefixes), so a checkpoint written by either package
restores in the other bit for bit.  Round trip, retention, a corrupt
checkpoint skipped for the previous valid one, and preemption then resume
equal to an uninterrupted run bit for bit on the CPU (data is a pure
function of the step and every CPU op is deterministic).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _port_helpers import configs, numpy_flat  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JaxManager  # noqa: E402,E501
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import TemplateMismatch  # noqa: E402
from repro_torch.checkpoint.manager import _flat  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamWState, adamw_init  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from repro_torch.train.loop import LoopConfig, Trainer  # noqa: E402


def _tiny_model(num_layers: int = 2):
    cfg = dataclasses.replace(TC.get_config("starcoder2-3b").reduced(),
                              num_layers=num_layers, remat=False,
                              compute_dtype="float32")
    return build_model(cfg)


def _trained_state(model, steps: int = 2) -> S.TrainState:
    state = S.init_train_state(model, 0, "cpu")
    step = S.make_train_step(model, peak_lr=1e-3, warmup=1)
    src = SyntheticLM(model.cfg.vocab_size, seed=0)
    for i in range(steps):
        state, _ = step(state, src.lm_batch(i, 2, 16))
    return state


def _assert_states_equal(a: S.TrainState, b: S.TrainState):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype, k
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert type(fa[k]) is type(fb[k]) and fa[k] == fb[k], k


def test_checkpoint_roundtrip(tmp_path):
    model = _tiny_model()
    state = _trained_state(model)
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(10, state)
    manifest = json.loads((tmp_path / "step_00000010" / "manifest.json")
                          .read_text())
    assert manifest["tensors"][".step"] == {
        "shape": [], "dtype": "int32", "sha": manifest["tensors"][".step"][
            "sha"]}
    assert manifest["tensors"][".opt__.count"]["dtype"] == "int32"
    template = S.init_train_state(model, 1, "cpu")
    step, restored = mgr.restore_latest(template)
    assert step == 10 and restored.step == 2 and restored.opt.count == 2
    _assert_states_equal(state, restored)


def test_write_arrays_streams_what_a_save_writes(tmp_path):
    """The archive writer also takes a stream (the card smoke test times a
    save's host work into one that keeps nothing): same manifest entries,
    and the archive reads back as the saved one."""
    import io
    from repro_torch.checkpoint.manager import write_arrays
    state = _trained_state(_tiny_model(), 1)
    path = CheckpointManager(tmp_path).save(1, state)
    manifest = json.loads((path / "manifest.json").read_text())
    buf = io.BytesIO()
    assert write_arrays(buf, state) == manifest["tensors"]
    buf.seek(0)
    with np.load(buf) as got, np.load(path / "arrays.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].tobytes() == want[k].tobytes(), k


def test_retention_keeps_last_n(tmp_path):
    state = S.init_train_state(_tiny_model(), 0, "cpu")
    mgr = CheckpointManager(tmp_path, keep=2)
    (tmp_path / ".tmp_step_00000005_1").mkdir()        # a dead writer's
    for s in (10, 20, 30, 40):
        mgr.save(s, state)
    assert mgr.list_steps() == [30, 40]
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_corrupt_checkpoint_skipped(tmp_path):
    state = S.init_train_state(_tiny_model(), 0, "cpu")
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(10, state)
    mgr.save(20, state)
    # corrupt the newest
    path = tmp_path / "step_00000020" / "arrays.npz"
    arrs = dict(np.load(path))
    k = ".params__embed"
    arrs[k] = arrs[k] + 1.0
    np.savez(path, **arrs)
    step, _ = mgr.restore_latest(state)
    assert step == 10   # fell back past the corrupt one
    # a torn archive and a missing manifest are skipped too
    path.write_bytes(path.read_bytes()[:1000])
    (tmp_path / "step_00000010" / "manifest.json").unlink()
    step, restored = mgr.restore_latest(state)
    assert step is None and restored is state


def _tree_bytes(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_checkpoint_of_another_model_raises_and_stays(tmp_path):
    """A whole checkpoint that does not fit the template (written at 2
    layers, restored at 3) is no torn one: restore raises, and so does a
    Trainer resuming there, before any save could replace or retire the
    checkpoint; the directory is left byte for byte as it was."""
    lcfg = LoopConfig(total_steps=2, ckpt_every=1, batch_size=2, seq_len=16,
                      peak_lr=1e-3)
    Trainer(_tiny_model(2), tmp_path, lcfg, device="cpu").run()
    before = _tree_bytes(tmp_path)
    assert sorted(before) == [
        f"step_0000000{i}/{f}" for i in (1, 2)
        for f in ("arrays.npz", "manifest.json")]
    deeper = _tiny_model(3)
    with pytest.raises(TemplateMismatch, match="params__layers"):
        CheckpointManager(tmp_path).restore_latest(
            S.init_train_state(deeper, 0, "cpu"))
    with pytest.raises(TemplateMismatch):
        Trainer(deeper, tmp_path, dataclasses.replace(lcfg, total_steps=4),
                device="cpu").run()
    # a key the checkpoint lacks, and an int leaf where a float one was
    state = S.init_train_state(_tiny_model(2), 0, "cpu")
    extra = dataclasses.replace(state, params={**state.params,
                                               "extra": torch.zeros(3)})
    with pytest.raises(TemplateMismatch, match="extra"):
        CheckpointManager(tmp_path).restore(2, extra)
    ints = dataclasses.replace(state, params={
        **state.params, "embed": state.params["embed"].to(torch.int32)})
    with pytest.raises(TemplateMismatch, match="embed"):
        CheckpointManager(tmp_path).restore(2, ints)
    assert _tree_bytes(tmp_path) == before


@pytest.fixture(scope="module")
def pair():
    """A JAX TrainState after 2 steps of reduced qwen3-8b and the port's
    after the same 2 steps from the same initial params."""
    jcfg, tcfg = configs(2)
    jmodel = jax_build_model(jcfg)
    jstate = JS.init_train_state(jmodel, jax.random.PRNGKey(0))
    init_flat = numpy_flat(jstate.params)
    jstep = jax.jit(JS.make_train_step(jmodel, peak_lr=1e-3, warmup=1))
    src = SyntheticLM(jcfg.vocab_size, seed=0)
    for i in range(2):
        jstate, _ = jstep(jstate, src.lm_batch(i, 2, 16))
    model = build_model(tcfg)
    params = bridge.params_from_numpy(init_flat, "cpu")
    state = S.TrainState(0, params, adamw_init(params))
    step = S.make_train_step(model, peak_lr=1e-3, warmup=1)
    for i in range(2):
        state, _ = step(state, src.lm_batch(i, 2, 16))
    return jmodel, jstate, model, state


def _jax_leaves(jstate) -> dict:
    """The JAX state's leaves by the checkpoint's flat keys."""
    from repro.checkpoint.manager import _flat as jax_flat
    return {k: np.asarray(v) for k, v in jax_flat(jstate).items()}


def test_jax_checkpoint_restores_in_the_port(tmp_path, pair):
    jmodel, jstate, model, _ = pair
    JaxManager(tmp_path).save(2, jstate)
    template = S.init_train_state(model, 0, "cpu")
    step, restored = CheckpointManager(tmp_path).restore_latest(template)
    assert step == 2 and restored.step == 2 and restored.opt.count == 2
    want = _jax_leaves(jstate)
    got = _flat(restored)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        v = np.asarray(v if not isinstance(v, torch.Tensor) else v.numpy())
        assert v.dtype == want[k].dtype or k in (".step", ".opt__.count"), k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
        if isinstance(got[k], torch.Tensor):
            assert v.tobytes() == want[k].tobytes(), k


def test_port_checkpoint_restores_in_jax(tmp_path, pair):
    jmodel, jstate, _, state = pair
    CheckpointManager(tmp_path).save(2, state)
    template = JS.init_train_state(jmodel, jax.random.PRNGKey(1))
    step, restored = JaxManager(tmp_path).restore_latest(template)
    assert step == 2
    want = _flat(state)
    got = _jax_leaves(restored)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v,
                       dtype=got[k].dtype)
        assert got[k].tobytes() == v.tobytes(), k
    assert isinstance(state.opt, AdamWState)


def test_preemption_resume_bit_exact(tmp_path):
    """30 steps straight vs (preempt at 13 -> resume): the same losses after
    the resume point and the same final state, bit for bit."""
    model = _tiny_model()
    lcfg = LoopConfig(total_steps=30, ckpt_every=10, batch_size=2,
                      seq_len=32, peak_lr=1e-3)
    res_a = Trainer(model, tmp_path / "a", lcfg, device="cpu").run()
    res_b1 = Trainer(model, tmp_path / "b", lcfg, device="cpu").run(
        interrupt_at=13)
    assert res_b1["interrupted"] and res_b1["completed"] == 13
    mgr = CheckpointManager(tmp_path / "b")
    assert mgr.list_steps() == [10, 13]
    _assert_states_equal(mgr.restore(13, res_b1["state"]), res_b1["state"])
    res_b2 = Trainer(model, tmp_path / "b", lcfg, device="cpu").run()
    assert res_b2["completed"] == 30 and not res_b2["interrupted"]
    assert len(res_b2["losses"]) == 17
    assert res_a["losses"][13:] == res_b2["losses"]
    assert res_a["losses"][:13] == res_b1["losses"]
    _assert_states_equal(res_a["state"], res_b2["state"])


def test_sigterm_saves_and_stops_then_resumes(tmp_path):
    """The handler the Trainer installs for SIGTERM (called here as the
    interpreter would call it, after step 3) ends the run after that step
    with a save; the handler in place before ``run`` is put back, and a
    new Trainer resumes from the saved step."""
    import signal
    model = _tiny_model()
    lcfg = LoopConfig(total_steps=6, ckpt_every=100, batch_size=2,
                      seq_len=16, peak_lr=1e-3)
    before = signal.getsignal(signal.SIGTERM)
    trainer = Trainer(model, tmp_path, lcfg, device="cpu")
    step = trainer._step

    def step_then_sigterm(state, batch):
        out = step(state, batch)
        if out[0].step == 3:
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler) and handler is not before
            handler(signal.SIGTERM, None)
        return out
    trainer._step = step_then_sigterm
    res = trainer.run()
    assert res["interrupted"] and res["completed"] == 3
    assert signal.getsignal(signal.SIGTERM) is before
    assert CheckpointManager(tmp_path).list_steps() == [3]
    res2 = Trainer(model, tmp_path, lcfg, device="cpu").run()
    assert res2["completed"] == 6 and len(res2["losses"]) == 3
