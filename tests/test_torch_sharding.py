"""The port's sharding resolution held against the JAX package's, with no
processes: the rule sets, ``resolve_spec`` (a property over shapes and
axes), ``tree_pspecs`` of the param, overlay and bank axes of every arch
of the mesh slice at full width, ``plan_matmul`` for every projection,
and the drift guard of the ``waxes`` literals the port's models pass.

Meshes are fake (the idiom of ``tests/test_sharded_serving.py:42-46``):
resolution reads only the axis names and sizes.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _port_helpers import configs
from repro.configs import get_config
from repro.core import calibration as JC
from repro.core import quantize as JQ
from repro.distributed import sharding as JS
from repro.kernels import dispatch as JD
from repro.models import build_model as jax_build_model
from repro.models import delta_overlay as JDO
from repro.models.param import split as jax_split

import repro_torch.configs as TC
from repro_torch.core import calibration as C
from repro_torch.core import quantize as Q
from repro_torch.core import loader as L
from repro_torch.distributed import sharding as S
from repro_torch.kernels import dispatch as D
from repro_torch.kernels import ops as K
from repro_torch.models import build_model
from repro_torch.models import delta_overlay as DO
from repro_torch.models import layers as LY
from repro_torch.models.param import split
from repro_torch.serving.variants import OverlayBank

ARCHS = ("qwen3-8b", "deepseek-7b", "deepseek-moe-16b")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _fake_mesh(shape, names):
    class M:
        axis_names = names
        devices = np.empty(shape, object)
    return M()


def _port_mesh(shape, names):
    return S.Mesh(tuple(names), tuple(shape))


def _spec(p) -> tuple:
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(p)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("pod_banks", [False, True])
def test_rules_for_equal_jax(kind, long_context, pod_banks):
    want = JS.rules_for(kind, long_context=long_context, pod_banks=pod_banks)
    got = S.rules_for(kind, long_context=long_context, pod_banks=pod_banks)
    assert got == want


_AXES = ["embed", "ffn", "ffn_small", "q_heads", "kv_heads", "vocab",
         "experts", "bank", "layers", "act_batch", "act_seq", "act_heads",
         "act_kv", "act_groups", None]


@settings(max_examples=60, deadline=None)
@given(d0=st.integers(1, 96).map(lambda i: i * 4),
       d1=st.integers(1, 96).map(lambda i: i * 8),
       d2=st.integers(1, 24),
       ax0=st.sampled_from(_AXES), ax1=st.sampled_from(_AXES),
       ax2=st.sampled_from(_AXES),
       mesh=st.sampled_from(sorted(MESHES)),
       kind=st.sampled_from(["train", "decode"]),
       long_context=st.booleans())
def test_resolve_spec_equal_jax(d0, d1, d2, ax0, ax1, ax2, mesh, kind,
                                long_context):
    shape, names = MESHES[mesh]
    rules = JS.rules_for(kind, long_context=long_context)
    want = JS.resolve_spec((d0, d1, d2), (ax0, ax1, ax2), rules,
                           _fake_mesh(shape, names))
    got = S.resolve_spec((d0, d1, d2), (ax0, ax1, ax2),
                         S.rules_for(kind, long_context=long_context),
                         _port_mesh(shape, names))
    assert got == _spec(want)
    # and the fake mesh resolves in the port as the port's own mesh does
    assert S.resolve_spec((d0, d1, d2), (ax0, ax1, ax2),
                          S.rules_for(kind, long_context=long_context),
                          _fake_mesh(shape, names)) == got


_FULL: dict = {}


def _full(arch: str):
    """JAX full-width shapes and axes (eval_shape: nothing allocated) and
    the port's axes of the same config (at reduced widths: the axes tree
    does not depend on widths)."""
    if arch not in _FULL:
        jcfg = dataclasses.replace(get_config(arch), num_layers=4)
        jshapes, jaxes = jax_split(jax.eval_shape(
            jax_build_model(jcfg).init, jax.random.PRNGKey(0)))
        tcfg = dataclasses.replace(TC.get_config(arch).reduced(),
                                   num_layers=4)
        _, taxes = split(build_model(tcfg).init(0, device="cpu"))
        _FULL[arch] = (jshapes, jaxes, taxes)
    return _FULL[arch]


def _leaves(tree, prefix="") -> dict:
    """{path: spec tuple} of a spec tree (dicts and OverlayEntry nodes of
    either package)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(_leaves(getattr(tree, f.name), f"{prefix}:{f.name}"))
    else:
        out[prefix] = tuple(tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tree_pspecs_equal_jax(arch, mesh):
    """Param, overlay and bank axes resolve leaf for leaf as in JAX."""
    jshapes, jaxes, taxes = _full(arch)
    shape, names = MESHES[mesh]
    jm, tm = _fake_mesh(shape, names), _port_mesh(shape, names)
    jr, tr = JS.rules_for("decode"), S.rules_for("decode")
    # the port declares the JAX package's logical axes
    assert DO.flatten_axes(taxes) == JDO.flatten_axes(jaxes)
    want = _leaves(JS.tree_pspecs(jshapes, jaxes, jr, jm))
    got = _leaves(S.tree_pspecs(jshapes, taxes, tr, tm))
    assert got == want and len(got) > 10
    flat = JC.flatten_params(jshapes)
    deltas = sorted(p for p, a in flat.items() if JC.is_target(p, a))
    extras = sorted(set(flat) - set(deltas))
    for bank in (None, 4):
        ja = JDO.overlay_pspecs(jaxes, deltas, extras if bank else (),
                                bank=bank is not None)
        js = JDO.overlay_struct(flat, deltas, extras, bank_size=bank)
        ta = DO.overlay_pspecs(taxes, deltas, extras if bank else (),
                               bank=bank is not None)
        ts = DO.overlay_struct({p: a.shape for p, a in flat.items()},
                               deltas, extras, bank_size=bank)
        want = _leaves(JS.tree_pspecs(js, ja, jr, jm))
        got = _leaves(S.tree_pspecs(ts, ta, tr, tm))
        assert got == want and len(got) >= 3 * len(deltas)


def _meta(tree):
    """The port's twin of a JAX shape tree: ``meta`` tensors, nothing
    allocated."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), dtype=torch.float32,
                       device="meta")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_quant_sharding_equal_jax(arch, mesh):
    """An int8 base's placements: ``quantize_base``'s upgraded spec tree
    (full width, ``meta`` tensors) holds, at every target, the JAX
    ``quant_sharding`` of the weight's resolved sharding — the payload's
    spec and the scale's — and every other leaf's spec unchanged."""
    jshapes, jaxes, taxes = _full(arch)
    shape, names = MESHES[mesh]
    jm, tm = _fake_mesh(shape, names), _port_mesh(shape, names)
    # quant_sharding is spec surgery: a one-device mesh of the same axis
    # names holds any of the specs
    one = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(
        (1,) * len(names)), names)
    jspecs = JC.flatten_params(JS.tree_pspecs(jshapes, jaxes,
                                              JS.rules_for("decode"), jm))
    params = _meta(jshapes)
    specs = S.tree_pspecs(params, taxes, S.rules_for("decode"), tm)
    qparams, qsh, _ = Q.quantize_base(params, specs)
    got = _leaves(qsh)
    flat = C.flatten_params(qparams)
    n_targets = 0
    for path, jspec in jspecs.items():
        if not Q.is_quant(flat[path]):
            assert got[path] == _spec(jspec), path
            continue
        n_targets += 1
        want = JQ.quant_sharding(jax.sharding.NamedSharding(one, jspec),
                                 len(flat[path].shape))
        assert got[f"{path}:q"] == _spec(want.q.spec), path
        assert got[f"{path}:scale"] == _spec(want.scale.spec), path
        assert Q.quant_sharding(_spec(jspec), len(flat[path].shape)) == \
            Q.QuantWeight(q=got[f"{path}:q"], scale=got[f"{path}:scale"])
    assert n_targets >= 7


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_struct_equal_jax(arch):
    """The shape-only int8 base (the dry-run's): int8 payloads and fp16
    scales of the same shapes as JAX's ``quantize_struct``."""
    jshapes, _, _ = _full(arch)
    jflat = JC.flatten_params(jshapes)
    paths = sorted(p for p, a in jflat.items() if JC.is_target(p, a))
    want = JQ.quantize_struct(jflat, paths)
    got = Q.quantize_struct(C.flatten_params(_meta(jshapes)), paths)
    assert sorted(got) == sorted(want)
    for path in paths:
        assert got[path].q.device.type == "meta"
        for f, dt, ndt in (("q", torch.int8, np.int8),
                           ("scale", torch.float16, np.float16)):
            g, w = getattr(got[path], f), getattr(want[path], f)
            assert tuple(g.shape) == tuple(w.shape)
            assert g.dtype == dt and np.dtype(w.dtype) == ndt


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_plan_matmul_equal_jax(arch, mesh):
    """Every projection's plan (rows: none, decode lanes, a prefill)."""
    jshapes, jaxes, _ = _full(arch)
    shape, names = MESHES[mesh]
    jm, tm = _fake_mesh(shape, names), _port_mesh(shape, names)
    flat = JC.flatten_params(jshapes)
    fax = JDO.flatten_axes(jaxes)
    n_plans = 0
    for path, leaf in flat.items():
        if not JC.is_target(path, leaf):
            continue
        n, k = leaf.shape[-2:]
        for m in (None, 64, 4096):
            want = JD.plan_matmul(jm, JS.rules_for("decode"), fax[path], m,
                                  n, k)
            got = D.plan_matmul(tm, S.rules_for("decode"), fax[path], m, n,
                                k)
            if want is None:
                assert got is None, (path, m)
                continue
            n_plans += 1
            assert (got.m_part, got.o_part, got.i_part) == (
                want.m_part, want.o_part, want.i_part), (path, m)
            assert got.psum_axes == want.psum_axes
    assert n_plans > 0


def test_plan_refuses_unaligned_local_k():
    """A local K tile that is not a multiple of 8 stays off the per-rank
    path, as in the JAX module (``dispatch.py:146-150``)."""
    mesh = _port_mesh((1, 4), ("data", "model"))
    jmesh = _fake_mesh((1, 4), ("data", "model"))
    rules = S.rules_for("decode")
    for k, aligned in ((48, False), (64, True)):    # local K 12, 16
        got = D.plan_matmul(mesh, rules, ("embed", "ffn"), 8, 64, k)
        want = JD.plan_matmul(jmesh, JS.rules_for("decode"),
                              ("embed", "ffn"), 8, 64, k)
        assert (got is not None) == aligned == (want is not None)


def test_entry_shardings_keep_k_tile_bytes():
    """The port's deliberate layout difference: a packed plane whose
    weight shards its in dim keeps its K-tile's bytes per rank."""
    mesh = _fake_mesh((1, 2), ("data", "model"))
    spec = S.resolve_spec((4096, 12288), ("embed", "ffn"),
                          S.rules_for("decode"), mesh)
    assert spec == (None, "model")
    ent = DO.entry_shardings_from_weight(spec, 2)
    assert ent.packed == (None, "model")
    assert ent.v_row == (None,) and ent.v_col == ("model",)
    jent = DO.entry_axes(("embed", "ffn"))
    assert jent.packed == ("embed", None)        # logical: JAX's axes


# ---------------------------------------------------------------------------
# the waxes drift guard (JAX: tests/test_shard_map_dispatch.py:241-300)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_waxes_literals_match_param_declarations(arch, monkeypatch):
    """Every axes tuple a model call site passes (into the delta kernels
    and the plain products) agrees with the ``Param.axes`` declared at
    init for a weight of that shape; at least one kernel site fires."""
    _, tcfg = configs(num_layers=3 if arch == "deepseek-moe-16b" else 2,
                      arch=arch)
    model = build_model(tcfg)
    base, axes = split(model.init(0, device="cpu"))
    pert, _ = split(model.init(1, device="cpu"))
    ft = {k: v for k, v in C.flatten_params(base).items()}
    fp = C.flatten_params(pert)
    dm = C.compress(base, C.unflatten_like(
        base, {k: v + 0.05 * fp[k] for k, v in ft.items()}))
    flat_axes = DO.flatten_axes(axes)
    declared: dict = {}
    for p, w in ft.items():
        for n in (2, 3):
            if w.dim() >= n:
                declared.setdefault(tuple(w.shape[-n:]), set()).add(
                    tuple(flat_axes[p][-n:]))
    recorded = []
    orig = K._routed

    def probe(name, waxes, *args):
        w = args[-1]
        recorded.append((name, tuple(w.shape[-len(waxes):]), waxes))
        return orig(name, waxes, *args)

    orig_ps = LY._contracted_axes

    def probe_ps(w, waxes):
        recorded.append(("plain", tuple(w.shape[-2:]), waxes))
        return orig_ps(w, waxes)

    monkeypatch.setattr(K, "_routed", probe)
    monkeypatch.setattr(LY, "_contracted_axes", probe_ps)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(7).integers(
        1, tcfg.vocab_size, size=(4, 8)))}
    with torch.no_grad():
        pv, ov, _ = L.device_put_overlay(base, dm)
        lg, cache = model.prefill(pv, batch, 16, overlay=ov)
        model.decode_step(pv, lg.argmax(-1).to(torch.int32), cache,
                          overlay=ov)
        bank = OverlayBank(base, 3)
        s1, _ = bank.admit("v1", dm)
        model.prefill(base, batch, 16, overlay=bank.tree,
                      variant_idx=torch.tensor([0, s1, s1, 0]))
        model.prefill(base, batch, 16)
    kinds = {name for name, _, w in recorded if w is not None}
    assert {"bitlinear_axes", "bitlinear_axes_banked", "plain"} <= kinds
    if tcfg.family == "moe":
        assert "bitlinear_axes_stacked" in kinds
    for name, shape, waxes in recorded:
        assert waxes is not None, (name, shape)
        assert shape in declared, (name, shape, waxes)
        assert tuple(waxes) in declared[shape], (name, shape, waxes,
                                                 declared[shape])


def test_context_helpers_match_jax_without_and_with_a_mesh():
    """``logical_constraint`` returns its input (explicit SPMD: a reshard
    is a collective at its call site), ``local_top_k`` is ``lax.top_k``
    (ties: lower index first), and the context accessors read the active
    mesh and rules as JAX's do."""
    score = np.array([[0.5, 0.1, 0.5, 0.9], [0.0, 0.0, 0.0, 0.0]],
                     np.float32)
    jv, ji = JS.local_top_k(jax.numpy.asarray(score), 3, (None, None))
    tv, ti = S.local_top_k(torch.from_numpy(score), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    x = torch.ones(2, 3)
    assert S.logical_constraint(x, "act_batch", None) is x
    assert S.active_mesh() is None and S.ctx_axis_size("model") is None
    assert not S.ctx_forward_only()
    mesh = _port_mesh((2, 4), ("data", "model"))
    with S.shard_ctx(mesh, S.rules_for("decode")):
        assert S.active_mesh() is mesh and S.ctx_axis_size("model") == 4
        assert S.ctx_axis_size("pod") is None and S.ctx_forward_only()
        assert S.active_rules() == JS.rules_for("decode")
        assert S.logical_constraint(x, "act_batch", None) is x
    assert S.active_mesh() is None


# ---------------------------------------------------------------------------
# remesh: the state's spec tree on a resized mesh
# ---------------------------------------------------------------------------

REMESH_ARCHS = ("starcoder2-3b", "deepseek-moe-16b", "whisper-base",
                "internvl2-76b", "xlstm-350m", "zamba2-7b")
REMESH_SHAPES = {"1x1": (1, 1), "1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
# depths that hold every block kind (an xLSTM super-block is 4 layers; a
# Zamba shared-block application and a trailing Mamba2 block)
REMESH_LAYERS = {"xlstm-350m": 4, "zamba2-7b": 4}


def _jax_specs(tree) -> dict:
    from jax.sharding import PartitionSpec
    flat = JC.flatten_params(tree, is_leaf=lambda x: isinstance(
        x, PartitionSpec) or hasattr(x, "spec"))
    return {k: tuple(getattr(v, "spec", v)) for k, v in flat.items()}


@pytest.mark.parametrize("shape", sorted(REMESH_SHAPES))
@pytest.mark.parametrize("arch", REMESH_ARCHS)
def test_remesh_spec_tree_equal_jax(arch, shape):
    """``train.loop.remesh``'s state spec tree under the train rules: the
    params' specs for the params and both moments, () for the step and the
    count.  On (1, 1) against JAX's ``remesh`` itself (its shardings'
    specs); on the larger shapes, which need more devices than the JAX
    tests have, against JAX's ``tree_pspecs`` of ``eval_shape(init)`` on a
    fake mesh of that shape, the resolution JAX's ``remesh`` runs."""
    from repro.train import loop as JTL
    from repro_torch.train import loop as TL
    d, m = REMESH_SHAPES[shape]
    jcfg, tcfg = configs(REMESH_LAYERS.get(arch, 2), arch=arch)
    model = build_model(tcfg)
    got_shape, got = TL.remesh(model, None, None, d, m, S.rules_for("train"))
    assert got_shape == (d, m)
    assert got.step == () and got.opt.count == ()
    flat = DO.flatten_axes(got.params)
    assert DO.flatten_axes(got.opt.mu) == flat == DO.flatten_axes(got.opt.nu)
    jmodel = jax_build_model(jcfg)
    if (d, m) == (1, 1):
        jmesh, jsh = JTL.remesh(jmodel, None, None, 1, 1, JS.rules_for("train"))
        assert tuple(jmesh.devices.shape) == (1, 1)
        assert tuple(jsh.step.spec) == tuple(jsh.opt.count.spec) == ()
        want = _jax_specs(jsh.params)
        assert _jax_specs(jsh.opt.mu) == want == _jax_specs(jsh.opt.nu)
    else:
        shapes, axes = jax_split(jax.eval_shape(jmodel.init,
                                                jax.random.PRNGKey(0)))
        want = _jax_specs(JS.tree_pspecs(shapes, axes, JS.rules_for("train"),
                                         _fake_mesh((d, m),
                                                    ("data", "model"))))
    assert flat == want


# ---------------------------------------------------------------------------
# block: a placed block owns its storage
# ---------------------------------------------------------------------------

def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


@pytest.mark.parametrize("coord", [0, 1])
def test_block_copies_whenever_the_spec_shards(coord):
    """``sharding.block`` on a (1, 2) mesh without processes: a cut of a
    leading dim (whose slice is a contiguous view) and a ``d_out`` cut of
    a (1, d_out, d_in) stack are copies that share no storage with the
    whole tensor, so placing a tree frees it (also when ``place`` moves it
    to a device, here the one it is on); a spec that shards nothing
    returns the tensor itself."""
    mesh = S.Mesh(("data", "model"), (1, 2), coords=(0, coord))
    t = torch.arange(24.0).reshape(4, 6)
    rows = S.block(t, ("model", None), mesh)
    assert not _shares_storage(rows, t) and rows.is_contiguous()
    assert torch.equal(rows, t[2 * coord:2 * coord + 2])
    stack = torch.arange(48.0).reshape(1, 8, 6)
    d_out = S.block(stack, (None, "model", None), mesh)
    assert not _shares_storage(d_out, stack)
    assert torch.equal(d_out, stack[:, 4 * coord:4 * coord + 4])
    assert S.block(t, (None, None), mesh) is t
    specs = {"a": ("model", None), "b": (None, None, None)}
    placed = S.place({"a": t, "b": stack}, specs, mesh)
    assert not _shares_storage(placed["a"], t) and placed["b"] is stack
    # a "move" to the device the leaf is on copies the block too
    moved = S.place({"a": t, "b": stack}, specs, mesh, device="cpu")
    assert not _shares_storage(moved["a"], t)
    assert moved["a"].is_contiguous() and torch.equal(moved["a"], rows)
    assert moved["b"] is stack
