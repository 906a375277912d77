"""Port parity: calibration stages 1-3 and the AdamW they step with, against
the JAX package on reduced qwen3-8b (2 layers, fp32 compute), the same
base and a numpy-seeded fine-tune pair, the same SyntheticLM batches.

Bounds, and why:

* ``collect_io`` tensors within 1e-5 (fp32, other summation order);
* one AdamW update within 1e-6 relative;
* axis choices equal, except where JAX's two held-out MSEs lie within 1e-6
  relative of each other (a near-tie may fall either way);
* every scale within ``lr × total_steps`` absolute of JAX's: one Adam step
  moves a value by at most about lr, and a near-zero gradient may flip the
  step's sign between two summation orders;
* that bound holds for scales left at stage 0 as well, so each scale's
  movement from stage 0 is held to JAX's: within 1e-2 of the norm of JAX's
  movement (the two agree to about 1e-5 here), and every scale JAX moved
  must have moved;
* held-out teacher-student logit MSE and every e2e loss within 5%
  relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _port_helpers import (configs, delta_model_numpy,  # noqa: E402
                           fine_tune_flat, jax_base, jax_tree)

from repro.core import calibration as JC  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402

LR = 1e-3
EPOCHS, E2E_EPOCHS = 2, 2


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs(num_layers=2)
    jmodel, jbase, flat = jax_base(jcfg)
    ft_flat = fine_tune_flat(flat, 11)
    src = SyntheticLM(jcfg.vocab_size, seed=7)
    batches = [src.lm_batch(1000 + i, 4, 32) for i in range(2)]
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel, "jbase": jbase,
            "jft": jax_tree(jbase, ft_flat),
            "base": bridge.params_from_numpy(flat, "cpu"),
            "ft": bridge.params_from_numpy(ft_flat, "cpu"),
            "batches": batches,
            "held_out": src.lm_batch(9999, 4, 32)}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    for clip, wd in ((1.0, 0.1), (1e9, 0.0)):
        jp = jax.tree.map(jnp.asarray, tree)
        tp = {"w": _t(tree["w"]), "b": [_t(tree["b"][0])]}
        js, ts = JO.adamw_init(jp), TO.adamw_init(tp)
        for step in range(3):
            g = {"w": rng.standard_normal((6, 5)).astype(np.float32) * 3,
                 "b": [rng.standard_normal(5).astype(np.float32)]}
            jp, js, jm = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                         lr=1e-2, weight_decay=wd,
                                         grad_clip_norm=clip)
            tp, ts, tm = TO.adamw_update(
                tp, {"w": _t(g["w"]), "b": [_t(g["b"][0])]}, ts, lr=1e-2,
                weight_decay=wd, grad_clip_norm=clip)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-6)
            for want, got in ((jp["w"], tp["w"]), (jp["b"][0], tp["b"][0]),
                              (js.mu["w"], ts.mu["w"]),
                              (js.nu["b"][0], ts.nu["b"][0])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-12)
        assert ts.count == int(js.count) == 3


def test_collect_io_matches_jax(pair):
    p = pair
    tokens = np.concatenate([b["tokens"] for b in p["batches"]])
    _, jaux = JT.forward(p["jft"], {"tokens": jnp.asarray(tokens)}, p["jcfg"],
                         collect_io=True)
    _, taux = T.forward(p["ft"], {"tokens": _t(tokens).long()}, p["tcfg"],
                        collect_io=True)
    assert sorted(taux["io"]) == sorted(jaux["io"]) and len(taux["io"]) == 7
    for proj, (jx, jy) in jaux["io"].items():
        tx, ty = taux["io"][proj]
        for want, got in ((jx, tx), (jy, ty)):
            assert tuple(got.shape) == want.shape, proj
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5, err_msg=proj)


def test_fit_layer_matches_jax(pair):
    """Stage 1/2 on layer 1's w_down: the (X, Y) cache of the stage-0
    student and the teacher, both modes, the axis choice.  (Every other
    projection's fits are held in test_calibrate_transformer_matches_jax.)"""
    p = pair
    tokens = np.concatenate([b["tokens"] for b in p["batches"]])
    jdm = JC.compress(p["jbase"], p["jft"])
    dm = C.compress(p["base"], p["ft"])
    io = jax.jit(lambda prm, b: JT.forward(prm, b, p["jcfg"],
                                           collect_io=True)[1]["io"])
    j_s = io(JC.apply_delta(p["jbase"], jdm), {"tokens": jnp.asarray(tokens)})
    j_t = io(p["jft"], {"tokens": jnp.asarray(tokens)})
    jflat = JC.flatten_params(p["jbase"])
    tflat = C.flatten_params(p["base"])
    for proj in ("mlp.w_down",):
        key = "layers." + proj
        x = np.asarray(j_s[proj][0][1]).reshape(-1, j_s[proj][0].shape[-1])
        y = np.asarray(j_t[proj][1][1]).reshape(-1, j_t[proj][1].shape[-1])
        jr = JC.fit_layer(jdm.deltas[key], jflat[key][1], jnp.asarray(x),
                          jnp.asarray(y), 1, epochs=3, lr=LR)
        tr = C.fit_layer(dm.deltas[key], tflat[key][1], _t(x), _t(y), 1,
                         epochs=3, lr=LR)
        steps = 3        # 3 epochs of one slice: n_train < 1024 rows
        entry = dm.deltas[key]
        for j_v, t_v, v0 in ((jr[0], tr[0], entry.v_row[1]),
                             (jr[1], tr[1], entry.v_col[1])):
            np.testing.assert_allclose(t_v.numpy(), np.asarray(j_v), rtol=0,
                                       atol=LR * steps)
            assert _assert_moved_alike(t_v.numpy(), j_v, v0.numpy(),
                                       key) > 0
        np.testing.assert_allclose(tr[3], jr[3], rtol=1e-4)
        if abs(jr[3][0] - jr[3][1]) > 1e-6 * max(jr[3]):
            assert tr[2] == bool(jr[2]), (proj, jr[3], tr[3])


def _assert_moved_alike(got, want, start, what):
    """``got`` moved from ``start`` as JAX's ``want`` did, within 1e-2 of the
    norm of JAX's movement; returns that norm."""
    moved = np.linalg.norm(np.asarray(want) - start)
    np.testing.assert_array_less(
        np.linalg.norm(np.asarray(got) - np.asarray(want)),
        1e-2 * moved + 1e-12, err_msg=what)
    return moved


def _logit_mse(model_fwd, student, teacher, batch):
    return float(((model_fwd(teacher, batch) - model_fwd(student, batch))
                  ** 2).mean())


@pytest.mark.parametrize("mode", ["sequential", "scalar"])
def test_calibrate_transformer_matches_jax(pair, mode):
    p = pair
    kw = dict(epochs=EPOCHS, e2e_epochs=E2E_EPOCHS, lr=LR, e2e_lr=LR,
              sequential=True, scalar=mode == "scalar")
    jdm, jrep = JC.calibrate_transformer(p["jmodel"], p["jbase"], p["jft"],
                                         p["batches"], **kw)
    dm, rep = C.calibrate_transformer(build_model(p["tcfg"]), p["base"],
                                      p["ft"], p["batches"], **kw)
    want = delta_model_numpy(jdm)
    got = bridge.delta_model_to_numpy(dm)
    assert sorted(got["deltas"]) == sorted(want["deltas"])
    # per-layer steps (one slice per epoch at this size; scalar: 1 epoch)
    # plus the e2e steps, each moving a scale by at most about lr
    layer_steps = 1 if mode == "scalar" else EPOCHS
    bound = LR * (layer_steps + E2E_EPOCHS * len(p["batches"]))
    start = bridge.delta_model_to_numpy(
        C.compress(p["base"], p["ft"], scalar=mode == "scalar"))["deltas"]
    for path, w in want["deltas"].items():
        g = got["deltas"][path]
        np.testing.assert_array_equal(g["packed"], w["packed"])
        for f in ("v_row", "v_col"):
            np.testing.assert_allclose(g[f], w[f], rtol=0, atol=bound,
                                       err_msg=f"{path}.{f}")
            moved = _assert_moved_alike(g[f], w[f], start[path][f],
                                        f"{path}.{f}")
            assert moved > 0 or (mode == "scalar" and f == "v_col"), (
                path, f)
    if mode != "scalar":
        for proj, mses in jrep["val_mse"].items():
            for li, (mr, mc) in enumerate(mses):
                tr, tc = rep["val_mse"][proj][li]
                np.testing.assert_allclose([tr, tc], [mr, mc], rtol=5e-2)
                if abs(mr - mc) > 1e-6 * max(mr, mc):
                    assert rep["axis"][proj][li] == jrep["axis"][proj][li], (
                        proj, li, (mr, mc), (tr, tc))
    np.testing.assert_allclose(rep["e2e_losses"], jrep["e2e_losses"],
                               rtol=5e-2)
    assert len(rep["e2e_losses"]) == E2E_EPOCHS * len(p["batches"])

    held = p["held_out"]
    jfwd = jax.jit(lambda prm, b: JT.forward(prm, b, p["jcfg"])[0])
    j_mse = _logit_mse(jfwd, JC.apply_delta(p["jbase"], jdm), p["jft"],
                       {"tokens": jnp.asarray(held["tokens"])})
    with torch.no_grad():
        t_mse = _logit_mse(lambda prm, b: T.forward(prm, b, p["tcfg"])[0],
                           C.apply_delta(p["base"], dm), p["ft"],
                           {"tokens": _t(held["tokens"]).long()})
    np.testing.assert_allclose(t_mse, j_mse, rtol=5e-2)
    # calibration beats the uncalibrated base on held-out logits
    with torch.no_grad():
        base_mse = _logit_mse(lambda prm, b: T.forward(prm, b, p["tcfg"])[0],
                              p["base"], p["ft"],
                              {"tokens": _t(held["tokens"]).long()})
    assert t_mse < base_mse


def test_with_scales_round_trip(pair):
    dm = C.compress(pair["base"], pair["ft"])
    s = dm.scale_params()
    s2 = {k: {f: t + 1 for f, t in v.items()} for k, v in s.items()}
    dm2 = dm.with_scales(s2)
    for k, e in dm2.deltas.items():
        assert torch.equal(e.v_row, dm.deltas[k].v_row + 1)
        assert e.packed is dm.deltas[k].packed
        assert dataclasses.replace(e).scalar == dm.deltas[k].scalar
