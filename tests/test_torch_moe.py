"""Port parity: the MoE layer (``models/moe.py``) and the expert-stacked
delta GEMM's plain version against the JAX package, on reduced
deepseek-moe-16b (8 experts, top-2, two shared experts' worth of hidden).

``moe_apply`` within 1e-5 of JAX and its aux loss within 1e-6, in four
cases over an fp32 and an int8 base (core/quantize): dropless (the reduced
capacity factor 8), tight capacity (0.25: tokens are dropped), one overlay
on every expert stack and the shared experts, and a banked overlay with a
mixed per-row vidx (base, two variants; the router banked as an extra).
The JAX kernels run in Pallas interpret mode, as the JAX package's own
tests run them.  Tie order: a zero router makes every gate equal, and the
capacity selection then ranks tied tokens; ``moe.top_k`` must order ties
as ``lax.top_k`` does (lower index first), which ``torch.topk`` does not
promise.  The stacked plain version is held against JAX's vmapped
``ops.bitlinear_axes`` with K = 264 (not a whole number of the streaming
kernel's 256- or 512-element warp steps) within 1e-5.  The delta path
hands the stacked GEMM its capacity fillers as zero rows (the JAX module
does not; the rows' outputs are discarded, so ``moe_apply`` is unchanged
bit for bit when they hold anything else).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _port_helpers import configs, numpy_flat  # noqa: E402

from repro.core import calibration as JC  # noqa: E402
from repro.core import quantize as JQ  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.models import delta_overlay as JDO  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.param import split  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.models import delta_overlay as DO  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

CASES = ("dropless", "tight", "overlay", "banked")


def _fine_tune(flat: dict, seed: int, scale: float = 0.05) -> dict:
    rng = np.random.default_rng(seed)
    return {k: v + scale * rng.standard_normal(v.shape).astype(v.dtype)
            for k, v in flat.items()}


@pytest.fixture(scope="module")
def unit():
    jcfg, tcfg = configs(arch="deepseek-moe-16b")
    p, _ = split(JM.moe_init(jax.random.PRNGKey(0), jcfg))
    flat = numpy_flat(p)
    fts = [_fine_tune(flat, s) for s in (31, 32)]
    jdms = [JC.compress(p, JC.unflatten_like(p, {k: jnp.asarray(v)
                                                 for k, v in ft.items()}))
            for ft in fts]
    qp, _, _ = JQ.quantize_base(p)
    x = 0.5 * np.random.default_rng(1).standard_normal(
        (3, 8, jcfg.d_model)).astype(np.float32)
    return {"jcfg": jcfg, "tcfg": tcfg, "x": x, "jdms": jdms,
            "bases": {"fp": (p, bridge.params_from_numpy(flat, "cpu")),
                      "int8": (qp, bridge.params_from_numpy(numpy_flat(qp),
                                                            "cpu"))}}


def _overlays(jdm):
    """(JAX overlay, port overlay) of one DeltaModel over the MoE subtree:
    every expert stack and the shared experts."""
    jov = JDO.overlay_from_deltas(jdm.deltas)
    dm = bridge.delta_model_from_numpy(
        {"deltas": {k: {"packed": np.asarray(e.packed),
                        "v_row": np.asarray(e.v_row),
                        "v_col": np.asarray(e.v_col),
                        "use_row": np.asarray(e.use_row),
                        "scalar": e.scalar}
                    for k, e in jdm.deltas.items()},
         "extras": {}}, "cpu")
    return jov, DO.overlay_from_deltas(dm.deltas)


def _bank(unit, jbase):
    """Banked overlays of 3 slots (slot 0 = base: zero entries, the base
    router) over both fine-tunes, built alike in both packages."""
    pairs = [_overlays(d) for d in unit["jdms"]]
    routers = [np.asarray(jbase["router"], np.float32)] + [
        np.asarray(d.extras["router"]).astype(np.float32)
        for d in unit["jdms"]]
    jbank, bank = {"router": jnp.asarray(np.stack(routers))}, {
        "router": torch.from_numpy(np.stack(routers))}
    keys = [k for k in pairs[0][0] if k != "router"]
    for key in keys:
        for pkg, tree in ((0, jbank), (1, bank)):
            ents = [pr[pkg][key] for pr in pairs]
            if isinstance(ents[0], dict):     # the shared experts
                tree[key] = {}
                for sub in ents[0]:
                    tree[key][sub] = _stack_entries(
                        pkg, [e[sub] for e in ents])
            else:
                tree[key] = _stack_entries(pkg, ents)
    return jbank, bank


def _stack_entries(pkg, ents):
    """Slot 0 zeros, then the given entries, along a new leading axis."""
    fields = ("packed", "v_row", "v_col")
    arrs = {f: [np.asarray(getattr(e, f)) for e in ents] for f in fields}
    stacked = {f: np.stack([np.zeros_like(a[0])] + a) for f, a in arrs.items()}
    if pkg == 0:
        return JDO.OverlayEntry(**{f: jnp.asarray(v)
                                   for f, v in stacked.items()})
    return DO.OverlayEntry(**{f: torch.from_numpy(v)
                              for f, v in stacked.items()})


@pytest.mark.parametrize("base", ["fp", "int8"])
@pytest.mark.parametrize("case", CASES)
def test_moe_apply_matches_jax(unit, case, base):
    import dataclasses
    jcfg, tcfg = unit["jcfg"], unit["tcfg"]
    if case == "tight":
        jcfg = dataclasses.replace(jcfg, capacity_factor=0.25)
        tcfg = dataclasses.replace(tcfg, capacity_factor=0.25)
    jp, p = unit["bases"][base]
    x = unit["x"]
    jov = ov = jvidx = vidx = None
    if case == "overlay":
        jov, ov = _overlays(unit["jdms"][0])
    elif case == "banked":
        jov, ov = _bank(unit, unit["bases"]["fp"][0])
        jvidx, vidx = jnp.asarray([0, 2, 1]), torch.tensor([0, 2, 1])
    want, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg, ov=jov, vidx=jvidx)
    got, aux = M.moe_apply(p, torch.from_numpy(x), tcfg, ov=ov, vidx=vidx)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    if case in ("overlay", "banked"):
        plain, _ = M.moe_apply(p, torch.from_numpy(x), tcfg)
        assert float((got - plain).abs().max()) > 1e-3
    if case == "tight":
        dropless, _ = M.moe_apply(p, torch.from_numpy(x), unit["tcfg"])
        assert float((got - dropless).abs().max()) > 1e-3


def test_banked_rows_equal_their_single_variant_pass(unit):
    """Each row of the banked pass equals the same row served alone with
    its own variant (the router swapped in as the fused path swaps
    extras), or the plain base for slot 0: a dropless group of one row."""
    tcfg = unit["tcfg"]
    _, p = unit["bases"]["fp"]
    _, bank = _bank(unit, unit["bases"]["fp"][0])
    x = torch.from_numpy(unit["x"])
    vidx = torch.tensor([0, 2, 1])
    got, _ = M.moe_apply(p, x, tcfg, ov=bank, vidx=vidx)
    for row, slot in enumerate(vidx.tolist()):
        if slot == 0:
            want, _ = M.moe_apply(p, x[row:row + 1], tcfg)
        else:
            _, ov = _overlays(unit["jdms"][slot - 1])
            pv = dict(p, router=bank["router"][slot])
            want, _ = M.moe_apply(pv, x[row:row + 1], tcfg, ov=ov)
        torch.testing.assert_close(got[row:row + 1], want, rtol=0,
                                   atol=1e-5)


def test_top_k_orders_ties_as_lax_top_k():
    rng = np.random.default_rng(5)
    score = rng.integers(0, 3, size=(4, 6, 40)).astype(np.float32) / 4
    jv, ji = jax.lax.top_k(jnp.asarray(score), 7)
    tv, ti = M.top_k(torch.from_numpy(score), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_tied_gates_dispatch_as_jax(unit):
    """A zero router: every token's gates tie, its top-k experts are the
    lowest indices, and the tight capacity picks among tied tokens."""
    import dataclasses
    jcfg = dataclasses.replace(unit["jcfg"], capacity_factor=0.5)
    tcfg = dataclasses.replace(unit["tcfg"], capacity_factor=0.5)
    jp, p = unit["bases"]["fp"]
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = unit["x"]
    want, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    got, aux = M.moe_apply(p, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    # tokens past capacity were dropped: the routed part of a later token
    # is zero, only its shared experts remain
    from repro_torch.models.layers import mlp_apply
    g = torch.from_numpy(x).reshape(1, -1, x.shape[-1])
    shared = mlp_apply(p["shared"], g).reshape(x.shape)
    assert bool(torch.isclose(got, shared, atol=1e-6).all(-1).any())


@pytest.mark.parametrize("cap", [1, 3, 10])
def test_combine_matches_a_scatter_add(cap):
    """The fixed-order combine equals the JAX module's scatter-add over a
    real dispatch: routed tokens an expert dropped (cap 1, 3) and the
    zero-score filler of every list (cap 10 of 10 tokens)."""
    g, n, e, k, d = 2, 10, 6, 2, 5
    gen = torch.Generator().manual_seed(3)
    probs = torch.softmax(torch.randn((g, n, e), generator=gen), -1)
    top_val, top_idx = M.top_k(probs, k)
    sel = torch.nn.functional.one_hot(top_idx, e).float() * top_val[..., None]
    c_val, c_idx = M.top_k(sel.sum(2).transpose(1, 2), cap)
    yd = torch.randn((g, e, cap, d), generator=gen, dtype=torch.float64)
    yd = torch.where((c_val > 0)[..., None], yd * c_val[..., None], 0.0)
    want = torch.zeros((g, n, d), dtype=torch.float64).scatter_add_(
        1, c_idx.reshape(g, e * cap, 1).expand(g, e * cap, d),
        yd.reshape(g, e * cap, d))
    got = M._combine(yd, c_idx, top_idx)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    assert torch.equal(got, M._combine(yd, c_idx, top_idx))


@pytest.mark.parametrize("base", ["fp", "int8"])
@pytest.mark.parametrize("case", ["overlay", "banked"])
def test_capacity_fillers_reach_the_expert_pass_as_zeros(unit, case, base,
                                                          monkeypatch):
    """The delta path hands the stacked GEMM zero rows for its capacity
    fillers (slots whose c_val is 0: no token routed there), in the
    single-overlay and the banked branch, for every projection; the
    fillers' outputs are discarded, so filling those rows with random
    values before the GEMM leaves ``moe_apply`` bit-identical."""
    tcfg = unit["tcfg"]
    _, p = unit["bases"][base]
    x = torch.from_numpy(unit["x"])
    if case == "overlay":
        _, ov = _overlays(unit["jdms"][0])
        vidx = None
    else:
        _, ov = _bank(unit, unit["bases"]["fp"][0])
        vidx = torch.tensor([0, 2, 1])
    c_vals, seen = [], []
    top_k, stacked = M.top_k, K.bitlinear_axes_stacked

    def record_top_k(score, k):
        vals, idx = top_k(score, k)
        if score.shape[1] == tcfg.num_experts:    # the capacity selection
            c_vals.append(vals)
        return vals, idx

    def wrapped(fill):
        gen = torch.Generator().manual_seed(9)

        def call(xe, *args):
            g, e, cap = c_vals[-1].shape
            filler = (c_vals[-1] == 0).transpose(0, 1).reshape(e, g * cap)
            assert bool(filler.any())
            seen.append(bool((xe[filler] == 0).all()))
            if fill:
                xe = torch.where(filler[..., None], torch.randn(
                    xe.shape, generator=gen, dtype=xe.dtype), xe)
            return stacked(xe, *args)
        return call

    monkeypatch.setattr(M, "top_k", record_top_k)
    monkeypatch.setattr(K, "bitlinear_axes_stacked", wrapped(False))
    got, aux = M.moe_apply(p, x, tcfg, ov=ov, vidx=vidx)
    calls = 3 * (1 if vidx is None else 3)
    assert seen == [True] * calls
    monkeypatch.setattr(K, "bitlinear_axes_stacked", wrapped(True))
    again, aux_again = M.moe_apply(p, x, tcfg, ov=ov, vidx=vidx)
    assert len(seen) == 2 * calls
    assert torch.equal(got, again) and torch.equal(aux, aux_again)


@pytest.mark.parametrize("quant", [False, True])
def test_stacked_plain_version_matches_jax_vmapped_kernel(quant):
    e, m, n, k = 3, 5, 16, 264
    rng = np.random.default_rng(7)
    x = rng.standard_normal((e, m, k)).astype(np.float32)
    packed = rng.integers(0, 256, (e, n, k // 8)).astype(np.uint8)
    v_row = rng.standard_normal((e, n)).astype(np.float16) * 0.01
    v_col = rng.standard_normal((e, k)).astype(np.float16) * 0.01
    v_col[1] = 0
    v_row[2] = 0
    wb = rng.standard_normal((e, n, k)).astype(np.float32) * k ** -0.5
    if quant:
        jw = JQ.quantize_weight(jnp.asarray(wb))
        w = bridge.to_leaf({"q": np.asarray(jw.q),
                            "scale": np.asarray(jw.scale)}, "cpu")
    else:
        jw, w = jnp.asarray(wb), torch.from_numpy(wb)
    want = jax.vmap(JK.bitlinear_axes)(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(v_row),
        jnp.asarray(v_col), jw)
    got = K.bitlinear_axes_stacked(
        torch.from_numpy(x), torch.from_numpy(packed),
        torch.from_numpy(v_row), torch.from_numpy(v_col), w)
    assert got.shape == (e, m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # each expert equals the single-matrix wrapper on its slice
    for i in range(e):
        wi = (bridge.to_leaf({"q": np.asarray(jw.q[i]),
                              "scale": np.asarray(jw.scale[i])}, "cpu")
              if quant else torch.from_numpy(wb[i]))
        torch.testing.assert_close(got[i], K.bitlinear_axes(
            torch.from_numpy(x[i]), torch.from_numpy(packed[i]),
            torch.from_numpy(v_row[i]), torch.from_numpy(v_col[i]), wi))


def test_expert_stack_compresses_as_jax(unit):
    """Stage-0 compression of the MoE subtree: every expert stack and the
    shared experts are targets with (E,)-shaped selectors, the router an
    extra; packed bytes and selectors bit-equal to JAX's, the fp32 scales
    within 1e-6 relative (the mean sums in another order), as the dense
    compress test holds them."""
    jp, p = unit["bases"]["fp"]
    ft = _fine_tune(numpy_flat(jp), 31)
    dm = C.compress(p, bridge.params_from_numpy(ft, "cpu"))
    jdm = unit["jdms"][0]
    assert sorted(dm.deltas) == sorted(jdm.deltas)
    assert list(dm.extras) == list(jdm.extras) == ["router"]
    e = unit["tcfg"].num_experts
    assert tuple(dm.deltas["w_gate"].use_row.shape) == (e,)
    for path, je in jdm.deltas.items():
        for f in ("packed", "use_row"):
            a = bridge.to_numpy(getattr(dm.deltas[path], f))
            np.testing.assert_array_equal(a, np.asarray(getattr(je, f)))
        for f in ("v_row", "v_col"):
            a = bridge.to_numpy(getattr(dm.deltas[path], f))
            np.testing.assert_allclose(a, np.asarray(getattr(je, f)),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("e", [1, 4, 64])
@pytest.mark.parametrize("m", [1, 4, 7, 16, 17, 120])
@pytest.mark.parametrize("nk", [(1408, 2048), (2048, 1408), (96, 264)])
@pytest.mark.parametrize("w_size", [4, 1])
def test_stacked_plan_covers_k(e, m, nk, w_size):
    """The stacked GEMM's launch plan: the whole K covered once with no
    empty split, each split a whole number of its kernel's K steps; a
    streaming launch runs the least row tier (1, 2, 4, 8, 16) that holds m
    and its split's x rows and scales fit the block's shared memory;
    deepseek-moe-16b's 64 experts fill the card with at most three K splits
    where one product takes up to eleven."""
    from repro_torch.kernels import bitlinear as BL
    n, k = nk
    splits, per = BL.stacked_plan(m, n, k, 2, w_size, e)
    assert splits >= 1 and (splits - 1) * per < k <= splits * per
    step = (BL.STREAM_SPAN[w_size] if m <= BL.STREAM_MAX_M else BL.TILE_K)
    assert per % step == 0
    if m <= BL.STREAM_MAX_M:
        tier = BL.stack_tier(m)
        assert tier in (1, 2, 4, 8, 16) and tier >= m and tier // 2 < m
        assert per * (4 + tier * 2) <= BL.STACK_STREAM_SMEM
    if e == 64 and n > 1000:
        assert splits <= 3
