"""Port parity: the training side (``optim/schedule``, the RMSNorm and
flash-attention backward passes, ``train/step``, ``distributed/
compression``, ``train/loop``'s gradient compression, ``launch/train``).

Inputs are made from a seed with numpy; JAX's initial params cross to the
port through ``bridge``.  Tolerances:

* ``cosine_schedule``: bit-equal (both evaluate the C library's cosf).
* RMSNorm and flash backward against ``jax.vjp`` of the JAX package's
  ``custom_vjp``s: fp32 within 1e-5 abs + 1e-5 rel (the same products
  summed in another order); bf16 within one bf16 step, 2^-7 rel + 1e-6
  abs (both round the same fp32 sums to bf16 at the same points).
* ``lm_loss``: 1e-6 rel.
* 3 train steps from JAX's initial params (Adam at lr 5e-3): fp32 losses
  within 1e-5 rel and the parameters within 1e-3 abs (a gradient that
  sits at the rounding noise moves a weight by up to 2·lr either way in
  Adam's first steps); bf16 losses within 5e-3 abs and the parameters'
  difference at most 0.1 of the update's norm (bf16 rounding noise: JAX
  with and without remat differ by 0.02 of it on this config).
* the gradient-compression wire format: packed signs equal, fp16 scales
  equal (one fp32 mean rounded to fp16), ``wire_bytes`` equal.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _port_helpers import (configs, jax_base, numpy_flat,  # noqa: E402
                           with_frontend)

import repro_torch.configs as TC  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.distributed import compression as JGC  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.optim.schedule import cosine_schedule as jax_cosine  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.distributed import compression as GC  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.param import split  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from repro_torch.train.loop import LoopConfig, Trainer  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


# ---------------------------------------------------------------------------
# schedule, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total,peak", [(10, 100, 3e-4), (5, 50, 5e-3),
                                               (0, 30, 1e-3),
                                               (100, 10_000, 3e-4)])
def test_cosine_schedule_bit_equal_to_jax(warmup, total, peak):
    steps = np.arange(total + 6, dtype=np.int32)
    want = np.asarray(jax_cosine(jnp.asarray(steps), warmup, total, peak))
    got = cosine_schedule(torch.from_numpy(steps), warmup, total, peak)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert cosine_schedule(7, warmup, total, peak).item() == float(want[7])


def test_lm_loss_ignores_minus_100_labels():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 6, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (2, 6)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, 5] = -100
    want = float(JS.lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = S.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    # the ignored positions do not move the loss
    logits[0, :3] += 100.0 * rng.standard_normal((3, 32)).astype(np.float32)
    moved = S.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(moved.item(), got.item(), rtol=1e-6)
    none = S.lm_loss(torch.from_numpy(logits),
                     torch.full((2, 6), -100, dtype=torch.int32))
    assert none.item() == 0.0


# ---------------------------------------------------------------------------
# backward passes against jax.vjp of the JAX package's custom_vjps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale_shape", [(64,), (4, 16)])
def test_rmsnorm_backward_matches_jax_vjp(dtype, scale_shape):
    tdt, jdt = DT[dtype]
    rng = np.random.default_rng(1)
    shape = (2, 8) + ((64,) if len(scale_shape) == 1 else (4, 16))
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(scale_shape)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    y, vjp = jax.vjp(lambda a, s: JL.rmsnorm(a, s, 1e-6),
                     jnp.asarray(x).astype(jdt), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(dy).astype(jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    yt = L.rmsnorm(xt, st, 1e-6)
    yt.backward(torch.from_numpy(dy).to(tdt))
    assert xt.grad.dtype == tdt and st.grad.dtype == torch.float32
    _close(yt, y, dtype)
    _close(xt.grad, jdx, dtype)
    _close(st.grad, jds, "float32")
    # the forward is the serving arithmetic, bit for bit
    with torch.no_grad():
        inv = torch.rsqrt((xt.float() * xt.float()).mean(-1, keepdim=True)
                          + 1e-6)
        assert torch.equal(xt * inv.to(tdt) * st.to(tdt), yt)
        assert torch.equal(L.rmsnorm(xt, st, 1e-6), yt)


FLASH_CASES = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "window": dict(causal=True, window=5),
    "offset": dict(causal=True, q_offset=8),
    "masked_rows": dict(causal=True, kv_offset=4, chunk=4),
    "chunk_lt_t": dict(causal=True, chunk=4),
    "window_offsets_chunks": dict(causal=True, window=3, q_offset=4,
                                  kv_offset=2, chunk=4),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_matches_jax_vjp(case, heads, dtype):
    tdt, jdt = DT[dtype]
    hq, hkv = heads
    rng = np.random.default_rng(2)
    b, s, t, hd = 2, 8, 16, 16
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    kw = dict(FLASH_CASES[case])
    out, vjp = jax.vjp(lambda *a: JA.flash_attention(*a, **kw),
                       *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do).astype(jdt))
    ts = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    got = A.flash_attention(*ts, **kw)
    got.backward(torch.from_numpy(do).to(tdt))
    with torch.no_grad():
        assert torch.equal(A.flash_attention(*ts, **kw), got)
        ch = A._pick_chunk(t, kw.get("chunk", 512))
        plain, _, _ = A._flash_fwd(*ts, kw["causal"], kw.get("window", 0),
                                   kw.get("q_offset", 0),
                                   kw.get("kv_offset", 0), ch)
        assert torch.equal(plain.reshape(got.shape).to(tdt), got)
    _close(got, out, dtype)
    for t_, w in zip(ts, want):
        assert t_.grad.dtype == tdt
        _close(t_.grad, w, dtype)


def test_flash_backward_saves_no_s_by_t_tensor():
    """The forward keeps (q, k, v, the fp32 output, m, l) for the backward:
    every saved tensor is far smaller than the (S × T) logits of one head,
    while autograd through the bare chunk loop keeps each chunk's."""
    rng = np.random.default_rng(3)
    b, s, t, hq, hkv, hd = 1, 64, 64, 4, 2, 4
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, n, h, hd)).astype(np.float32)).requires_grad_(True)
        for n, h in ((s, hq), (t, hkv), (t, hkv)))

    def saved_numels(fn):
        sizes = []

        def pack(x):
            sizes.append(x.numel())
            return x
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            fn()
        return sizes

    logits = b * s * hq * t
    sizes = saved_numels(lambda: A.flash_attention(q, k, v, chunk=16))
    assert len(sizes) == 6 and max(sizes) < logits / 4, sizes
    bare = saved_numels(lambda: A._flash_fwd(q, k, v, True, 0, 0, 0, 16))
    assert sum(n for n in bare if n == b * s * hq * 16) >= logits


# ---------------------------------------------------------------------------
# train steps against the JAX package's make_train_step
# ---------------------------------------------------------------------------

STEP_CASES = {
    "qwen3-8b-fp32": ("qwen3-8b", "float32", False),
    "qwen3-8b-fp32-remat": ("qwen3-8b", "float32", True),
    "qwen3-8b-bf16-remat": ("qwen3-8b", "bfloat16", True),
    "deepseek-moe-16b-fp32": ("deepseek-moe-16b", "float32", False),
}
LR = dict(peak_lr=5e-3, warmup=2, total_steps=10)


def _batches(vocab: int, n: int = 3):
    src = SyntheticLM(vocab, seed=0)
    return [src.lm_batch(i, 2, 16) for i in range(n)]


@pytest.fixture(scope="module")
def jax_steps():
    """Per case: JAX's initial params (numpy), per-step losses and final
    params after 3 steps of ``make_train_step``."""
    out = {}
    for name, (arch, dtype, remat) in STEP_CASES.items():
        jcfg, tcfg = (dataclasses.replace(c, remat=remat)
                      for c in configs(2, dtype, arch=arch))
        jmodel, _, flat = jax_base(jcfg)
        state = JS.init_train_state(jmodel, jax.random.PRNGKey(0))
        step = jax.jit(JS.make_train_step(jmodel, **LR))
        losses = []
        for batch in _batches(jcfg.vocab_size):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out[name] = (tcfg, flat, losses, numpy_flat(state.params))
    return out


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax(jax_steps, case):
    tcfg, flat, jax_losses, jax_final = jax_steps[case]
    model = build_model(tcfg)
    params = bridge.params_from_numpy(flat, "cpu")
    state = S.TrainState(step=0, params=params, opt=adamw_init(params))
    step = S.make_train_step(model, **LR)
    losses = []
    for batch in _batches(tcfg.vocab_size):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        assert m["lr"].dtype == torch.float32
    assert state.step == 3 and state.opt.count == 3
    got = bridge.params_to_numpy(state.params)
    if tcfg.compute_dtype == "float32":
        np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
        for k in jax_final:
            np.testing.assert_allclose(got[k], jax_final[k], atol=1e-3,
                                       err_msg=k)
    else:
        np.testing.assert_allclose(losses, jax_losses, atol=5e-3)
        num = sum(float(np.sum((got[k] - jax_final[k].astype(np.float64))
                               ** 2)) for k in jax_final)
        den = sum(float(np.sum((jax_final[k].astype(np.float64) - flat[k])
                               ** 2)) for k in jax_final)
        assert (num / den) ** 0.5 < 0.1, (num / den) ** 0.5


OTHER_FAMILIES = ("deepseek-7b", "starcoder2-3b", "gemma3-12b",
                  "moonshot-v1-16b-a3b", "internvl2-76b", "whisper-base",
                  "xlstm-350m", "zamba2-7b")


def _family_batch(cfg, rng) -> dict:
    """The batch each family's forward takes: tokens and labels, plus the
    audio frames or the image embeddings of the stubbed frontends
    (``with_frontend``, drawn from ``rng`` after the tokens)."""
    toks = rng.integers(0, cfg.vocab_size, (2, 17))
    return with_frontend([{"tokens": toks[:, :-1], "labels": toks[:, 1:]}],
                         cfg, rng)[0]


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_one_step_of_every_family(arch):
    """Finite loss, a nonzero gradient on every float leaf, and the same
    gradients, bit for bit, with the layer bodies rematerialised."""
    cfg = dataclasses.replace(TC.get_config(arch).reduced(), num_layers=(
        7 if arch == "zamba2-7b" else 8 if arch == "xlstm-350m" else 2),
        compute_dtype="float32")
    model = build_model(cfg)
    params = S.init_train_state(model, 0, "cpu").params
    batch = _family_batch(cfg, np.random.default_rng(4))
    loss_fn = S.make_loss_fn(model)
    total, metrics, grads = S.value_and_grad(loss_fn, params, batch)
    assert torch.isfinite(total) and total.item() > 0
    flat = bridge.params_to_numpy(grads)
    zero = [k for k, g in flat.items() if not np.any(g)]
    assert not zero, zero
    remat = build_model(dataclasses.replace(cfg, remat=True))
    total_r, _, grads_r = S.value_and_grad(S.make_loss_fn(remat), params,
                                           batch)
    assert torch.equal(total, total_r)
    for k, g in bridge.params_to_numpy(grads_r).items():
        np.testing.assert_array_equal(g, flat[k], err_msg=k)


def test_eval_step_and_param_axes():
    jcfg, tcfg = configs(2)
    model = build_model(tcfg)
    params = S.init_train_state(model, 0, "cpu").params
    batch = _batches(tcfg.vocab_size, 1)[0]
    metrics = S.make_eval_step(model)(params, batch)
    assert set(metrics) == {"loss", "moe_aux"}
    assert not metrics["loss"].requires_grad
    # off a mesh param_axes is a no-op, as JAX's sharding constraint is
    # outside one: the same step, bit for bit
    _, axes = split(model.init(0, device="meta"))
    state = S.TrainState(step=0, params=params, opt=adamw_init(params))
    plain, pm = S.make_train_step(model, **LR)(state, batch)
    axed, am = S.make_train_step(model, param_axes=axes, **LR)(state, batch)
    assert set(pm) == set(am)
    for k in pm:
        assert torch.equal(torch.as_tensor(pm[k]), torch.as_tensor(am[k])), k
    assert (axed.step, axed.opt.count) == (plain.step, plain.opt.count)
    for got, want in ((axed.params, plain.params), (axed.opt.mu, plain.opt.mu),
                      (axed.opt.nu, plain.opt.nu)):
        got, want = bridge.params_to_numpy(got), bridge.params_to_numpy(want)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ("serving-rules",))
def test_mesh_train_refusals_name_their_slice(arch):
    """A train step under a mesh with forward-only (serving) rules raises,
    naming the train rules it needs.  (A mesh without processes: the
    refusal comes before the first collective.)"""
    from repro_torch.distributed import sharding as SH
    cfg = dataclasses.replace(TC.get_config("deepseek-7b").reduced(),
                              num_layers=2, compute_dtype="float32")
    model = build_model(cfg)
    params, axes = split(model.init(0, device="cpu"))
    state = S.TrainState(step=0, params=params, opt=adamw_init(params))
    batch = _family_batch(cfg, np.random.default_rng(4))
    step = S.make_train_step(model, param_axes=axes)
    mesh = SH.Mesh(("data", "model"), (1, 2))
    with SH.shard_ctx(mesh, SH.rules_for("decode")), \
            pytest.raises(ValueError, match="train rules"):
        step(state, batch)


# ---------------------------------------------------------------------------
# 1-bit gradient compression with error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 128), (3, 16, 40), (8, 12), (96,)])
def test_ef_wire_format_equals_jax(shape):
    g = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    gt = torch.from_numpy(g)
    assert GC.wire_bytes(gt) == JGC.wire_bytes(jnp.asarray(g))
    assert GC._compressible(gt) == JGC._compressible(jnp.asarray(g))
    if not GC._compressible(gt):
        return
    jp, js = JGC.quantize(jnp.asarray(g))
    tp, ts = GC.quantize(gt)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy().view(np.uint16),
                                  np.asarray(js).view(np.uint16))
    np.testing.assert_array_equal(
        GC.dequantize(tp, ts, shape[-1]).numpy(),
        np.asarray(JGC.dequantize(jp, js, shape[-1])))


def test_ef_transform_matches_jax_and_beats_memoryless():
    g = np.random.default_rng(6).standard_normal((64, 128)).astype(np.float32)
    jt, jinit = JGC.make_ef_transform()
    tt_, tinit = GC.make_ef_transform()
    grads = {"w": torch.from_numpy(g), "b": torch.from_numpy(g[0])}
    jgrads = {"w": jnp.asarray(g), "b": jnp.asarray(g[0])}
    ef, jef = tinit(grads), jinit(jgrads)
    assert ef["b"] is None
    applied = torch.zeros_like(grads["w"])
    for _ in range(8):
        out, ef = tt_(grads, ef)
        jout, jef = jt(jgrads, jef)
        np.testing.assert_array_equal(out["w"].numpy(), np.asarray(jout["w"]))
        np.testing.assert_allclose(ef["w"].numpy(), np.asarray(jef["w"]),
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(out["b"], grads["b"])
        applied += out["w"]
    target = 8 * grads["w"]
    rel = float(torch.linalg.norm(applied - target) / torch.linalg.norm(
        target))
    one_shot, _ = tt_(grads, tinit(grads))
    rel_one = float(torch.linalg.norm(one_shot["w"] - grads["w"])
                    / torch.linalg.norm(grads["w"]))
    assert rel < rel_one


def test_grad_compression_preserves_convergence(tmp_path):
    cfg = dataclasses.replace(TC.get_config("starcoder2-3b").reduced(),
                              num_layers=2, compute_dtype="float32")
    model = build_model(cfg)
    base = LoopConfig(total_steps=25, ckpt_every=100, batch_size=2,
                      seq_len=32, peak_lr=1e-3)
    res_fp = Trainer(model, tmp_path / "fp", base, device="cpu").run()
    res_c = Trainer(model, tmp_path / "c",
                    dataclasses.replace(base, grad_compress=True),
                    device="cpu").run()
    assert res_fp["losses"][-1] < res_fp["losses"][0]
    assert res_c["losses"][-1] < res_c["losses"][0]
    assert res_c["losses"][-1] < res_fp["losses"][-1] * 1.25


def test_train_launcher_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-8b", "--reduced", "--device", "cpu", "--steps", "4",
           "--batch", "2", "--seq", "16", "--ckpt-every", "2",
           "--ckpt-dir", str(tmp_path)]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "completed=4" in out.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004"]
    again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300)
    assert again.returncode == 0 and "nothing left" in again.stdout
    # another depth on the same directory stops with the checkpoints kept
    deeper = subprocess.run(cmd + ["--num-layers", "5"], env=env,
                            capture_output=True, text=True, timeout=300)
    assert deeper.returncode != 0 and "TemplateMismatch" in deeper.stderr
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004"]
