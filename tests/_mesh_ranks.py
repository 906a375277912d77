"""Rank-side half of the mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_cuda.py``): what one rank of a spawned group runs.

The parent test process runs the JAX package and writes the weights, the
delta models and the requests to a pickle (numpy, the bridge's exchange
format); each rank reads it, serves or checks on its own blocks and
returns plain data (token lists, numpy arrays, floats) that the parent
asserts on.  Nothing here imports JAX, so a rank never loads it.
"""
import contextlib
import dataclasses
import pathlib
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.core import calibration as C
from repro_torch.core import delta as CD
from repro_torch.core import loader as L
from repro_torch.core import store as ST
from repro_torch.distributed import sharding as S
from repro_torch.kernels import dispatch as D
from repro_torch.kernels import ops as K
from repro_torch.models import build_model
from repro_torch.models import delta_overlay as DO
from repro_torch.models.param import split
from repro_torch.serving import Deployment
from repro_torch.serving.variants import VariantRegistry

BATCH, PROMPT, MAX_LEN = 4, 12, 24
BUDGETS = [2, 5, 3, 4, 1, 3]
NAMES = ["__base__", "v0", "v1"]
SCHEDULERS = {"continuous": dict(scheduler="continuous", bank_size=4),
              "group-fused": dict(scheduler="group", mode="fused"),
              "group-dense": dict(scheduler="group", mode="dense")}
LAYERS = {"deepseek-moe-16b": 3}
# the int8-base runs of the mesh groups: (arch, scheduler) pairs
INT8_RUNS = {"deepseek-7b": ("continuous", "group-fused", "group-dense"),
             "deepseek-moe-16b": ("continuous", "group-fused")}
# the weights whose int8 blocks a rank sends back: a column-parallel, a
# row-parallel (the in dim sharded: the row absmax all-reduced) and an
# expert stack
INT8_BLOCK_PATHS = {"deepseek-7b": ("layers.attn.wq", "layers.attn.wo",
                                    "layers.mlp.w_down"),
                    "deepseek-moe-16b": ("layers.moe.w_gate",
                                         "layers.moe.w_down",
                                         "pre_layers.attn.wo")}
# the launcher under a mesh over an int8 base, with one update cycle
LAUNCH_ARGV = ["--arch", "deepseek-7b", "--reduced", "--num-layers", "2",
               "--variants", "2", "--requests", "3", "--new-tokens", "3",
               "--batch", "2", "--mode", "fused", "--scheduler",
               "continuous", "--base-dtype", "int8", "--updates", "1",
               "--device", "cpu"]


def port_config(arch: str, compute_dtype: str = "float32"):
    return dataclasses.replace(TC.get_config(arch).reduced(),
                               num_layers=LAYERS.get(arch, 2),
                               compute_dtype=compute_dtype, remat=False)


def load(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def setup(arch: str, d: dict, device="cpu"):
    """(model, base params, axes, [DeltaModel]) of one arch's data."""
    model = build_model(port_config(arch))
    _, axes = split(model.init(0, device="cpu"))
    params = bridge.params_from_numpy(d["flat"], device)
    dms = [bridge.delta_model_from_numpy(x, device) for x in d["dms"]]
    return model, params, axes, dms


def names_for(sched: str, base_dtype: str = "fp") -> list:
    """The variants the requests cycle over.  Over an int8 base the group
    dense runs serve the variants alone: one JAX group-dense engine cannot
    serve a base request (QuantWeight params) beside a dense variant (fp16
    params), since it keys its compiled steps on the overlay's structure
    alone."""
    if base_dtype == "int8" and sched == "group-dense":
        return NAMES[1:]
    return NAMES


def serve(dep, d: dict, names=NAMES) -> list:
    """Publish v0, v1; serve the data's requests round-robin over
    ``names``; every request's tokens."""
    for i, dm in enumerate(d["dm_objs"]):
        dep.publish(f"v{i}", dm)
    rids = [dep.submit(p, variant=names[i % len(names)],
                       max_new_tokens=BUDGETS[i % len(BUDGETS)])
            for i, p in enumerate(d["prompts"])]
    dep.drain()
    return [dep.result(r).out_tokens for r in rids]


def deployment(model, params, axes, mesh, device="cpu", **kw):
    if mesh is not None:
        kw.update(mesh=mesh, param_axes=axes, graphs=False)
    return Deployment(model, params, device=device, batch_size=BATCH,
                      prompt_len=PROMPT, max_len=MAX_LEN, **kw)


def _ctx(mesh, params, axes, batch_axes=()):
    """The mesh context over params placed on ``mesh`` (as the engine
    builds it)."""
    rules = S.rules_for("decode")
    specs = S.tree_pspecs(params, axes, rules, mesh)
    local = S.place(params, specs, mesh)
    lay = S.Layout.from_params(
        {p: tuple(t.shape) for p, t in C.flatten_params(params).items()},
        DO.flatten_axes(axes), mesh, rules)
    return local, specs, lambda: S.shard_ctx(mesh, rules, lay, batch_axes)


# ---------------------------------------------------------------------------
# per-rank kernels against the unsharded op
# ---------------------------------------------------------------------------

def _bound(x: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    """How far a rank's result may lie from the reference (the single-card
    op on the whole operands: the kernel on a card, the plain version on
    the CPU): each is within the GEMM bound 1e-5·Σ|x||Ŵ| + 1e-6 of the
    exact product — the rank's summed over the ranks' K-tiles — so twice
    that bound."""
    return 2 * (1e-5 * (x.abs().to(torch.float64)
                        @ w_hat.abs().to(torch.float64).T) + 1e-6)


def _entry(dm, path, layer):
    e = DO.from_delta_entry(dm.deltas[path])
    return DO.OverlayEntry(packed=e.packed[layer], v_row=e.v_row[layer],
                           v_col=e.v_col[layer])


def dispatch_checks(mesh, d7: dict, dmoe: dict, device="cpu") -> dict:
    """{check name: max |err| / bound} of every per-rank entry point (and
    its gathered ``no_dispatch`` twin) on the operands a rank holds,
    against the rank's block of the same op on the whole operands on the
    same device (``_bound``); ``unpack_apply`` as the largest |err| (a
    per-tile rebuild: exact)."""
    out = {}
    gen = torch.Generator().manual_seed(5)
    model, params, axes, dms = setup("deepseek-7b", d7)
    local, specs, ctx = _ctx(mesh, params, axes)
    flat, fspecs = C.flatten_params(params), DO.flatten_axes(specs)
    faxes = DO.flatten_axes(axes)
    dev = torch.device(device)

    def to(t):
        return t.to(dev)

    for path in ("layers.attn.wq", "layers.attn.wo", "layers.mlp.w_down"):
        w = flat[path][0]
        n, k = w.shape
        wspec = fspecs[path][1:]
        ent = [_entry(dm, path, 0) for dm in dms]
        x = torch.randn((6, k), generator=gen)
        sp = DO.entry_shardings_from_weight(wspec, 2)
        x_l = S.block(x, (None, wspec[1]), mesh)
        w_l = S.block(w, wspec, mesh)
        # single-variant fused GEMM
        e = ent[0]
        want = K.bitlinear_axes(to(x), to(e.packed), to(e.v_row),
                                to(e.v_col), to(w)).cpu()
        w_hats = [w] + [(en.v_row.float()[:, None]
                         + en.v_col.float()[None, :])
                        * CD.unpack_signs(en.packed, k, torch.float32) + w
                        for en in ent]
        bound = S.block(_bound(x, w_hats[1]), (None, wspec[0]), mesh)
        want_l = S.block(want, (None, wspec[0]), mesh)
        args = [to(S.block(e.packed, sp.packed, mesh)),
                to(S.block(e.v_row, sp.v_row, mesh)),
                to(S.block(e.v_col, sp.v_col, mesh)), to(w_l)]
        for mode in ("per_rank", "gathered"):
            with ctx(), _mode(mode):
                got = K.bitlinear_axes(to(x_l), *args,
                                       waxes=faxes[path][1:])
            out[f"axes {path} {mode}"] = float(
                ((got.cpu() - want_l).abs() / bound).max())
        # banked: slot 0 base (zeros), slots 1, 2 the variants
        bank = [torch.stack([torch.zeros_like(getattr(ent[0], f))]
                            + [getattr(en, f) for en in ent])
                for f in ("packed", "v_row", "v_col")]
        vidx = torch.tensor([0, 1, 2, 1, 2, 0], dtype=torch.int32)
        want = K.bitlinear_axes_banked(to(x), to(vidx), *map(to, bank),
                                       to(w)).cpu()
        want_l = S.block(want, (None, wspec[0]), mesh)
        bound = S.block(torch.stack([_bound(x[m:m + 1], w_hats[int(v)])[0]
                                     for m, v in enumerate(vidx)]),
                        (None, wspec[0]), mesh)
        bank_l = [S.block(b, (None,) + s, mesh)
                  for b, s in zip(bank, (sp.packed, sp.v_row, sp.v_col))]
        for mode in ("per_rank", "gathered"):
            with ctx(), _mode(mode):
                got = K.bitlinear_axes_banked(
                    to(x_l), to(vidx), *map(to, bank_l), to(w_l),
                    waxes=faxes[path][1:])
            out[f"banked {path} {mode}"] = float(
                ((got.cpu() - want_l).abs() / bound).max())
        # unpack_apply over the layer stack, row and col modes
        full = dms[0].deltas[path]
        lead = (None,) + wspec
        for mode, v in (("row", full.v_row), ("col", full.v_col)):
            want = K.unpack_apply(to(full.packed), to(v.float()),
                                  to(flat[path]), mode=mode,
                                  out_dtype=torch.float32).cpu()
            psp = DO.entry_shardings_from_weight(fspecs[path], 3)
            vspec = psp.v_row if mode == "row" else psp.v_col
            for dmode in ("per_rank", "gathered"):
                with ctx(), _mode(dmode):
                    got = K.unpack_apply(
                        to(S.block(full.packed, psp.packed, mesh)),
                        to(S.block(v.float(), vspec, mesh)),
                        to(S.block(flat[path], lead, mesh)), mode=mode,
                        out_dtype=torch.float32, waxes=faxes[path])
                out[f"unpack {path} {mode} {dmode}"] = float(
                    (got.cpu() - S.block(want, lead, mesh)).abs().max())
    # expert stacks of the MoE arch
    model, params, axes, dms = setup("deepseek-moe-16b", dmoe)
    local, specs, ctx = _ctx(mesh, params, axes)
    flat, fspecs = C.flatten_params(params), DO.flatten_axes(specs)
    faxes = DO.flatten_axes(axes)
    for path in ("layers.moe.w_gate", "layers.moe.w_down"):
        w = flat[path][0]
        e_n, n, k = w.shape
        wspec = fspecs[path][1:]
        ent = _entry(dms[0], path, 0)
        xe = torch.randn((e_n, 5, k), generator=gen)
        want = K.bitlinear_axes_stacked(to(xe), to(ent.packed),
                                        to(ent.v_row), to(ent.v_col),
                                        to(w)).cpu()
        sp = DO.entry_shardings_from_weight(wspec, 3)
        bound = torch.stack([
            _bound(xe[i], (ent.v_row[i].float()[:, None]
                           + ent.v_col[i].float()[None, :]).abs()
                   + w[i].abs()) for i in range(e_n)])
        want_l = S.block(want, (wspec[0], None, wspec[1]), mesh)
        bound_l = S.block(bound, (wspec[0], None, wspec[1]), mesh)
        xe_l = S.block(xe, (wspec[0], None, wspec[2]), mesh)
        for mode in ("per_rank", "gathered"):
            with ctx(), _mode(mode):
                got = K.bitlinear_axes_stacked(
                    to(xe_l), to(S.block(ent.packed, sp.packed, mesh)),
                    to(S.block(ent.v_row, sp.v_row, mesh)),
                    to(S.block(ent.v_col, sp.v_col, mesh)),
                    to(S.block(w, wspec, mesh)), waxes=faxes[path][1:])
            out[f"stacked {path} {mode}"] = float(
                ((got.cpu() - want_l).abs() / bound_l).max())
    return out


def _mode(mode: str):
    """``no_dispatch()`` for the gathered twin, nothing per rank."""
    return D.no_dispatch() if mode == "gathered" else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# logits, tokens, bank and patches on a mesh
# ---------------------------------------------------------------------------

def mesh_logits(mesh, arch: str, d: dict) -> dict:
    """Base and fused-overlay forward logits (B, S, V) on the mesh, the
    rows split over "data" and gathered back."""
    model, params, axes, dms = setup(arch, d)
    rules = S.rules_for("decode")
    part = S.resolve_spec((BATCH,), ("act_batch",), rules, mesh)[0]
    rows = S._names(part)
    local, specs, ctx = _ctx(mesh, params, axes, rows)
    tokens = torch.from_numpy(d["tokens"])
    nloc = BATCH // mesh.names_size(rows)
    lo = mesh.index(rows) * nloc
    batch = {"tokens": tokens[lo:lo + nloc]}
    out = {}
    with torch.no_grad(), ctx():
        lg, _ = model.forward(local, batch)
        out["base"] = S.all_gather(lg, rows, 0, mesh).numpy()
        pv, ov, _ = L.device_put_overlay(local, dms[0],
                                         param_shardings=specs, mesh=mesh)
        lg, _ = model.forward(pv, batch, overlay=ov)
        out["fused"] = S.all_gather(lg, rows, 0, mesh).numpy()
    return out


def mesh_tokens(mesh, arch: str, d: dict, kds=("shard_map", "gspmd"),
                scheds=tuple(SCHEDULERS), device="cpu",
                base_dtype: str = "fp") -> dict:
    """{(kernel_dispatch, scheduler): tokens} of sharded Deployments."""
    model, params, axes, dms = setup(arch, d)
    d = dict(d, dm_objs=dms)
    out = {}
    for kd in kds:
        for name in scheds:
            dep = deployment(model, params, axes, mesh, device=device,
                             kernel_dispatch=kd, base_dtype=base_dtype,
                             **SCHEDULERS[name])
            out[(kd, name)] = serve(dep, d, names_for(name, base_dtype))
    return out


# speculative rounds under a mesh: label -> Deployment keywords over the
# continuous scheduler's; adaptive k up to 4 over both dispatch modes and
# bases, and on deepseek-7b a fixed k=1 and an async-admission run
SPEC_RUNS = {(kd, bd): dict(kernel_dispatch=kd, base_dtype=bd)
             for kd in ("shard_map", "gspmd") for bd in ("fp", "int8")}
SPEC_EXTRA = {("shard_map", "fp", "k1"): dict(draft_k=1),
              ("shard_map", "fp", "async"): dict(async_admission=True,
                                                 admission_pacing_s=0.0)}


def spec_tokens(mesh, arch: str, d: dict, runs: dict,
                device="cpu") -> dict:
    """{label: (tokens, ladder snapshot)} of speculative Deployments on
    ``mesh``, one per entry of ``runs``."""
    model, params, axes, dms = setup(arch, d)
    d = dict(d, dm_objs=dms)
    out = {}
    for label, kw in runs.items():
        kw = {"draft_k": 4, **kw}
        dep = deployment(model, params, axes, mesh, device=device,
                         speculative=True, **SCHEDULERS["continuous"], **kw)
        tokens = serve(dep, d)
        out[label] = (tokens, dep.status()["speculative"])
        dep.close()
    return out


def _stand_in_build(tmp):
    """A build callable for the compile cache without ``nvcc``: one of
    torch's own shared objects stands in for the kernel library."""
    src = sorted((pathlib.Path(torch.__file__).parent / "lib")
                 .glob("libc10.so*"))[0]
    time.sleep(0.05)
    dest = pathlib.Path(tmp) / "stand-in.so"
    shutil.copyfile(src, dest)
    return dest, "stand-in report"


def cache_race(path: str, barrier, queue) -> None:
    """One of several processes that load one key of the compile cache at
    ``path`` at once (after ``barrier``): puts (its counters, the report,
    whether the library loaded) on ``queue``."""
    from repro_torch.core import compile_cache as CC
    cache = CC.CompileCache(path)
    barrier.wait()
    lib, report = cache.load(("stand-in",), _stand_in_build)
    queue.put((dict(cache.stats), report, lib is not None))


def warm_checks(mesh, d: dict, cache_dir: str, device="cpu",
                pods: bool = False) -> dict:
    """``warmup()`` on a mesh, per scheduler (the continuous one alone on
    pod-local banks, which refuse speculative decoding): the outcomes,
    then the tokens of the same traffic as the unwarmed runs (the mesh
    groups' requests; the pod traffic on pod-local banks).  The
    Deployment names a compile cache every rank shares (fresh), whose
    library the ranks load in turns (``launch.mesh.load_kernels``, a
    stand-in build); then every rank loads one key of another fresh
    directory at once.  The rank's ``status()["compile_cache"]``, both
    caches' counters and anything quarantined."""
    from repro_torch.core import compile_cache as CC
    from repro_torch.launch import mesh as LM
    model, params, axes, dms = setup("deepseek-7b", d)
    prev = CC.set_default(None)
    out = {}
    try:
        for sched in ("continuous",) if pods else ("continuous",
                                                   "speculative"):
            kw = dict(scheduler=sched, compile_cache_dir=f"{cache_dir}/turns")
            if pods:
                dep = Deployment(model, params, device=device, mesh=mesh,
                                 param_axes=axes, graphs=False,
                                 pod_banks=True, **POD_DEP, **kw)
            else:
                dep = deployment(model, params, axes, mesh, device=device,
                                 bank_size=4, **kw)
            if sched == "continuous":
                LM.load_kernels(mesh, lambda: CC.get_default().load(
                    ("stand-in",), _stand_in_build))
            outcomes = dep.warmup()
            if pods:
                for i, dm in enumerate(dms):
                    dep.publish(f"v{i}", dm)
                rids = [dep.submit(POD_PROMPT, variant=v,
                                   max_new_tokens=POD_NEW_TOKENS)
                        for v in POD_TRAFFIC]
                dep.drain()
                tokens = [dep.result(r).out_tokens for r in rids]
            else:
                tokens = serve(dep, dict(d, dm_objs=dms))
            st = dep.status()
            out[sched] = {"outcomes": outcomes, "tokens": tokens,
                          "cache": st["compile_cache"],
                          "warmed": st["warmed"]}
            dep.close()
        mesh.barrier()
        race = CC.CompileCache(f"{cache_dir}/race")
        _, report = race.load(("stand-in",), _stand_in_build)
        out["race"] = (dict(race.stats), report)
        mesh.barrier()
        out["quarantined"] = [
            q.name for sub in ("turns", "race")
            for q in (pathlib.Path(cache_dir) / sub).glob("quarantine/*")]
    finally:
        CC.set_default(prev)
    return out


def int8_blocks(mesh, arch: str, d: dict) -> dict:
    """The registry's int8 base on this rank's blocks: its quant_stats,
    and for each of ``INT8_BLOCK_PATHS`` the payload's spec with the q and
    scale blocks (numpy)."""
    model, params, axes, _ = setup(arch, d)
    dep = deployment(model, params, axes, mesh, base_dtype="int8",
                     **SCHEDULERS["continuous"])
    reg = dep.registry
    flat = C.flatten_params(reg.base_params)
    specs = DO.flatten_axes(reg.param_shardings)
    return {"stats": reg.quant_stats,
            "blocks": {p: (specs[p], flat[p].q.cpu().numpy(),
                           flat[p].scale.cpu().numpy())
                       for p in INT8_BLOCK_PATHS[arch]}}


def bank_checks(mesh, d: dict) -> dict:
    """Bank admit / evict / re-admit on the rank's blocks against the
    same sequence on the whole base; apply_update on local blocks against
    the block of the whole patch; per-rank bank bytes."""
    model, params, axes, dms = setup("deepseek-7b", d)
    local, specs, _ = _ctx(mesh, params, axes)
    whole = VariantRegistry(params, mode="fused", bank_size=3)
    mine = VariantRegistry(local, mode="fused", bank_size=3, mesh=mesh,
                           param_shardings=specs, param_axes=axes,
                           base_fp=whole.base_fp)
    out = {}
    for reg in (whole, mine):
        reg.set_version("v0", None, dms[0])
        reg.set_version("v1", None, dms[1])
        reg.bank_resolve("v0")
        reg.bank_resolve("v1")
        reg.evict("v0")
        reg.bank_resolve("v0")            # re-admit into the freed slot
    fspecs = DO.flatten_axes(specs)
    same = True
    for path, leaf in whole.bank._flat.items():
        ax = DO.bank_axis(path)
        spec = fspecs[path]
        if isinstance(leaf, DO.OverlayEntry):
            sp = DO.entry_shardings_from_weight(spec, leaf.packed.dim() - 1)
            pairs = [(getattr(leaf, f), getattr(mine.bank._flat[path], f),
                      getattr(sp, f)) for f in ("packed", "v_row", "v_col")]
        else:
            pairs = [(leaf, mine.bank._flat[path], spec)]
        for g, l, s in pairs:
            s = tuple(s)[:ax] + (None,) + tuple(s)[ax:]
            same &= torch.equal(S.block(g, s, mesh), l)
    out["bank_blocks_equal"] = bool(same)
    out["slots"] = (whole.bank.slot_of("v0"), mine.bank.slot_of("v0"))
    out["per_device"] = mine.bank.per_device_nbytes()
    out["bank_nbytes"] = mine.bank.nbytes()
    out["whole_nbytes"] = whole.bank.nbytes()
    # apply_update on the rank's blocks
    with tempfile.TemporaryDirectory() as tmp:
        ST.save_update_patch(dms[0], dms[1], tmp)
        _, dp, ep = ST.load_update_patch(tmp)
    new_whole = L.apply_update(dms[0], dp, ep)
    new_local = L.apply_update(L.place_delta_model(dms[0], specs, mesh),
                               dp, ep, param_shardings=specs, mesh=mesh)
    placed = L.place_delta_model(new_whole, specs, mesh)
    eq = all(torch.equal(getattr(placed.deltas[p], f),
                         getattr(new_local.deltas[p], f))
             for p in placed.deltas
             for f in ("packed", "v_row", "v_col", "use_row"))
    eq &= all(torch.equal(placed.extras[p], new_local.extras[p])
              for p in placed.extras)
    out["update_blocks_equal"] = bool(eq)
    out["patched_modules"] = len(dp) + len(ep)
    return out


def store_tokens(mesh, d: dict, root: str) -> dict:
    """publish, update, serve, rollback, serve through a store in a
    directory every rank shares (rank 0 writes)."""
    model, params, axes, dms = setup("deepseek-7b", d)
    dep = deployment(model, params, axes, mesh, root_dir=root,
                     **SCHEDULERS["continuous"])
    out = {"versions": [dep.publish("v0", dms[0]),
                        dep.update("v0", dms[1])]}
    names = ["__base__", "v0"]

    def run():
        rids = [dep.submit(p, variant=names[i % 2], max_new_tokens=3)
                for i, p in enumerate(d["prompts"][:4])]
        dep.drain()
        return [dep.result(r).out_tokens for r in rids]
    out["after_update"] = run()
    out["rollback"] = dep.rollback("v0")
    out["after_rollback"] = run()
    out["refused"] = store_refusals(dep)
    out["after_refusals"] = run()
    return out


def store_refusals(dep) -> list:
    """Writes the store refuses (rank 0 finds the fault) raise on every
    rank, with rank 0's error; the serving after them shows the ranks
    still in step."""
    got = []
    for write in (lambda: dep.rollback("v0", 99),
                  lambda: dep.update("nope", None),
                  lambda: dep.rollback("nope")):
        try:
            write()
            got.append(None)
        except (KeyError, ValueError) as e:
            got.append((type(e).__name__, str(e)))
    return got


# ---------------------------------------------------------------------------
# async admission on a mesh; pod-local banks on a (pod, data, model) mesh
# ---------------------------------------------------------------------------

# the JAX pod-bank tests' traffic (tests/test_pod_banks.py): skewed to v0,
# so v0 re-routes to a pod that holds it
POD_TRAFFIC = ["v0", "v0", "v1", "v0", "v1", "v0", "v1", "v0"]
POD_DEP = dict(batch_size=4, prompt_len=16, max_len=64, bank_size=4)
POD_NEW_TOKENS = 4
POD_PROMPT = np.arange(1, 9)
# label -> Deployment keywords; "global" is one bank replicated over the
# pods, the A/B reference of the pod-local runs
POD_RUNS = {
    "global": {},
    "global int8": dict(base_dtype="int8"),
    "pods": dict(pod_banks=True),
    "pods gspmd": dict(pod_banks=True, kernel_dispatch="gspmd"),
    "pods async": dict(pod_banks=True, async_admission=True),
    "pods int8": dict(pod_banks=True, base_dtype="int8"),
}


class _Counted:
    """Counts a mesh's host-group agreements (``agree_min``) and records
    the decode step of each admission commit, around one deployment."""

    def __init__(self, dep):
        self.agreements = 0
        self.commits = []
        mesh, adm = dep.engine.mesh, dep.admission
        inner_agree = mesh.agree_min

        def agree(values):
            self.agreements += 1
            return inner_agree(values)
        object.__setattr__(mesh, "agree_min", agree)
        self._undo = [lambda: object.__delattr__(mesh, "agree_min")]
        if adm is not None:
            inner_commit = adm._commit

            def commit(t):
                ok = inner_commit(t)
                if ok:
                    self.commits.append((dep.metrics["decode_steps"],
                                         t.vkey, t.pod))
                return ok
            adm._commit = commit

    def close(self):
        for undo in self._undo:
            undo()


def _slow(dm, seconds: float):
    """A lazy artifact that takes ``seconds`` to load."""
    def load():
        time.sleep(seconds)
        return dm
    return load


def pod_run(mesh, model, params, axes, dms, device="cpu", delay=0.0,
            prefetch_pods=(), **kw) -> dict:
    """The pod traffic on one Deployment of ``mesh``: tokens, statuses,
    the router's counters, per-pod bank bytes and residents, the
    admission bytes, async commits (with the decode step of each) and the
    host-group agreements the run made.  ``delay`` > 0 publishes each
    variant as a lazy artifact that takes that long to load here;
    ``prefetch_pods`` starts each variant's ingest toward those pods too
    (publish starts it toward pod 0)."""
    if kw.get("async_admission"):
        kw.setdefault("admission_pacing_s", 0.0)
    dep = Deployment(model, params, device=device, mesh=mesh,
                     param_axes=axes, graphs=False, **POD_DEP, **kw)
    counted = _Counted(dep)
    for i, dm in enumerate(dms):
        dep.publish(f"v{i}", _slow(dm, delay) if delay else dm)
        for pod in prefetch_pods:
            dep.admission.prefetch(f"v{i}", pod)
    rids = [dep.submit(POD_PROMPT, variant=v,
                       max_new_tokens=POD_NEW_TOKENS) for v in POD_TRAFFIC]
    dep.drain()
    st = dep.status()
    bank = dep.registry.bank
    out = {"tokens": [dep.result(r).out_tokens for r in rids],
           "status": [dep.result(r).status for r in rids],
           "affinity": st["affinity"],
           "bank_per_pod": st["hbm"]["bank_per_pod"],
           "resident_per_pod": st["hbm"]["bank_resident_per_pod"],
           "admit_bytes": (bank.stats["admit_bytes_in_pod"],
                           bank.stats["admit_bytes_cross_pod"]),
           "async_admits": dep.metrics["async_admits"],
           "commits": counted.commits,
           "agreements": counted.agreements}
    counted.close()
    dep.close()
    return out


def pod_async_checks(mesh, model, params, axes, dms, device="cpu",
                     **kw) -> dict:
    """Async admission's agreement on a mesh: a run whose ranks load at
    different speeds (rank r takes r * 20 ms a variant) commits each ticket
    at the same decode step on every rank (on pod-local banks each variant
    goes to both pods: a ticket per (version, pod)); a variant whose load
    fails on
    the first rank of each pod alone fails its request on every rank, with
    that rank's error; base traffic with no ticket live makes no
    agreement."""
    out = {"paced": pod_run(mesh, model, params, axes, dms, device,
                            delay=0.02 * mesh.rank, async_admission=True,
                            prefetch_pods=(1,) if kw.get("pod_banks")
                            else (), **kw)}
    dep = Deployment(model, params, device=device, mesh=mesh,
                     param_axes=axes, graphs=False, async_admission=True,
                     admission_pacing_s=0.0, max_retries=0, **POD_DEP,
                     **kw)
    counted = _Counted(dep)
    rids = [dep.submit(POD_PROMPT, max_new_tokens=2) for _ in range(3)]
    dep.drain()
    out["base_agreements"] = counted.agreements
    dm = dms[0]

    def flaky():
        if mesh.index(("data", "model")) == 0:
            raise IOError(f"artifact unreadable on rank {mesh.rank}")
        return dm
    dep.registry.set_version("bad", None, flaky)
    dep.publish("v1", dms[1])
    rids += [dep.submit(POD_PROMPT, variant=v, max_new_tokens=2)
             for v in ("bad", "v1", "__base__")]
    dep.drain()
    out["failure"] = [(dep.result(r).status, dep.result(r).error,
                       dep.result(r).out_tokens) for r in rids]
    counted.close()
    dep.close()
    return out


def pod_bank_checks(mesh, d: dict) -> dict:
    """``OverlayBank(pods=2)`` of 3 slots a pod on this rank's blocks, the
    JAX package's per-pod semantics case for case
    (``tests/test_pod_banks.py::test_pod_bank_per_pod_slots_and_eviction``),
    every outcome recorded; and which local slot this rank wrote."""
    from repro_torch.serving.variants import OverlayBank
    model, params, axes, dms = setup("deepseek-7b", d)
    local, specs, _ = _ctx(mesh, params, axes)
    dm1, dm2 = (L.place_delta_model(dm, specs, mesh) for dm in dms)
    bank = OverlayBank(local, 3, mesh=mesh, pods=2)
    out = {"total_slots": bank.total_slots,
           "base_slots": (bank.base_slot(0), bank.base_slot(1))}

    def refused(fn):
        try:
            fn()
        except RuntimeError as e:
            return str(e)
        return None
    s_a0, pay0 = bank.admit("a@v1", dm1, pod=0)
    s_a1, pay1 = bank.admit("a@v1", dm1, pod=1)
    path = "layers.attn.wq"
    out.update(
        slots=(s_a0, s_a1), payload=(pay0, pay1),
        pods_holding=bank.pods_holding("a@v1"),
        slot_of_pod1=bank.slot_of("a@v1", pod=1),
        resident=sorted(bank.resident()), pod_resident=bank.pod_resident(),
        admit_bytes=(bank.stats["admit_bytes_in_pod"],
                     bank.stats["admit_bytes_cross_pod"]),
        slot_bytes=bank._slot_bytes,
        wrote=torch.equal(bank._flat[path].packed[:, 1],
                          DO.from_delta_entry(dm1.deltas[path]).packed),
        per_pod=bank.per_pod_nbytes(), per_device=bank.per_device_nbytes())
    bank.pin("a@v1", pod=0)
    out["evict_pinned_pod0"] = refused(lambda: bank.evict("a@v1", pod=0))
    out["evict_pinned_any"] = refused(lambda: bank.evict("a@v1"))
    bank.evict("a@v1", pod=1)
    out["after_evict"] = bank.pods_holding("a@v1")
    out["cleared"] = not bank._flat[path].packed[:, 1].any().item() \
        if bank.pod == 1 else None
    bank.unpin("a@v1", pod=0)
    bank.mark_staging("b@v1", pod=1)
    out["staging"] = (bank.staging("b@v1"), bank.staging("b@v1", pod=1),
                      bank.staging("b@v1", pod=0))
    out["evict_staging"] = refused(lambda: bank.evict("b@v1", pod=1))
    bank.unmark_staging("b@v1", pod=1)
    bank.admit("b@v1", dm2, pod=0)
    bank.admit("a@v1", dm1, pod=1)
    ev0 = bank.stats["evictions"]
    s_c, _ = bank.admit("c@v1", dm2, pod=0)
    out.update(lru_slot=s_c, lru_evictions=bank.stats["evictions"] - ev0,
               lru_holding=bank.pods_holding("a@v1"),
               merged="c@v1" in bank._slots,
               pod1_table=sorted(bank._pod_slots[1].items()))
    return out


def pod_checks(mesh, d: dict, device="cpu") -> dict:
    """Every pod-bank check of a (pod, data, model) rank: the runs of
    ``POD_RUNS``, async admission's agreement on the pod-local bank, the
    per-pod bank semantics and the launcher with ``--pod-banks``."""
    model, params, axes, dms = setup("deepseek-7b", d)
    out = {"coords": mesh.coords,
           "runs": {label: pod_run(mesh, model, params, axes, dms, device,
                                   **kw)
                    for label, kw in POD_RUNS.items()},
           "async": pod_async_checks(mesh, model, params, axes, dms,
                                     device, pod_banks=True),
           "bank": pod_bank_checks(mesh, d)}
    from repro_torch.launch import serve as SV
    out["launcher"] = SV._mesh_rank(mesh, POD_LAUNCH_ARGV)
    return out


def moe_pod_checks(mesh, d: dict, device="cpu") -> dict:
    """MoE under pod-local banks: deepseek-moe-16b over the pod traffic,
    each run of ``POD_RUNS`` (the global bank beside them)."""
    model, params, axes, dms = setup("deepseek-moe-16b", d)
    return {label: pod_run(mesh, model, params, axes, dms, device, **kw)
            for label, kw in POD_RUNS.items()}


# the launcher with pod-local banks on (2, 1, 2)
POD_LAUNCH_ARGV = ["--arch", "deepseek-7b", "--reduced", "--num-layers", "2",
                   "--variants", "2", "--requests", "6", "--new-tokens", "3",
                   "--batch", "4", "--mode", "fused", "--scheduler",
                   "continuous", "--mesh", "2,1,2", "--pod-banks",
                   "--device", "cpu"]


def async_mesh_checks(mesh, d: dict, device="cpu") -> dict:
    """Async admission on a (data, model) mesh: the continuous run's
    traffic served sync and async (ranks at different ingest paces), and
    the agreement's failure and no-ticket cases."""
    model, params, axes, dms = setup("deepseek-7b", d)
    return {"sync": pod_run(mesh, model, params, axes, dms, device),
            "async": pod_async_checks(mesh, model, params, axes, dms,
                                      device)}


def run(mesh, path: str, plan: dict) -> dict:
    """Everything one spawn of a mesh shape checks (one spawn per shape
    serves a whole test module)."""
    torch.set_num_threads(1)
    data = load(path)
    device = str(mesh.device)
    out = {"coords": mesh.coords, "backend": mesh.backend,
           "device": device}
    if plan.get("dispatch"):
        out["dispatch"] = dispatch_checks(mesh, data["deepseek-7b"],
                                          data["deepseek-moe-16b"],
                                          device=device)
    for arch in plan.get("logits", ()):
        out[("logits", arch)] = mesh_logits(mesh, arch, data[arch])
    for arch, scheds in plan.get("tokens", {}).items():
        out[("tokens", arch)] = mesh_tokens(mesh, arch, data[arch],
                                            scheds=scheds, device=device)
    for arch, scheds in plan.get("int8", {}).items():
        out[("int8 tokens", arch)] = mesh_tokens(
            mesh, arch, data[arch], scheds=scheds, device=device,
            base_dtype="int8")
        out[("int8 blocks", arch)] = int8_blocks(mesh, arch, data[arch])
    if plan.get("launcher"):
        from repro_torch.launch import serve as SV
        out["launcher"] = SV._mesh_rank(mesh, LAUNCH_ARGV)
    if plan.get("bank"):
        out["bank"] = bank_checks(mesh, data["deepseek-7b"])
    if plan.get("store"):
        out["store"] = store_tokens(mesh, data["deepseek-7b"], plan["store"])
    if plan.get("async"):
        out["async"] = async_mesh_checks(mesh, data["deepseek-7b"],
                                         device=device)
    if plan.get("pods"):
        out["pods"] = pod_checks(mesh, data["deepseek-7b"], device=device)
    for arch, runs in plan.get("spec", {}).items():
        out[("spec", arch)] = spec_tokens(mesh, arch, data[arch], runs,
                                          device=device)
    if plan.get("moe_pods"):
        out["moe pods"] = moe_pod_checks(mesh, data["deepseek-moe-16b"],
                                         device=device)
    if plan.get("warm"):
        out["warm"] = warm_checks(mesh, data["deepseek-7b"], plan["warm"],
                                  device=device, pods=bool(plan.get("pods")))
    for arch in plan.get("train", ()):
        out[("train", arch)] = mesh_train(mesh, data[f"train {arch}"], arch,
                                          device=device)
    for arch in plan.get("train_wide", ()):
        out[("train wide", arch)] = mesh_train(
            mesh, data[f"train wide {arch}"], arch, device=device, steps=1)
    if plan.get("drop"):
        arch = plan["drop"]
        out["drop"] = drop_continue(mesh, data[f"train {arch}"], arch,
                                    device=device)
    if plan.get("cross_pod"):
        out["cross pod"] = cross_pod_checks(mesh, data["train deepseek-7b"],
                                            device=device)
    return out


# ---------------------------------------------------------------------------
# training under a mesh
# ---------------------------------------------------------------------------

# ``tests/test_torch_train.py``'s schedule; the global batch splits over
# "data"
TRAIN_LR = dict(peak_lr=5e-3, warmup=2, total_steps=10)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 16, 3
# rows long enough that each data rank's 2 x 2048 tokens hold whole MoE
# capacity groups (4096 tokens): the aux loss's per-rank shares
WIDE_SEQ = 2048


def train_config(arch: str, fields: dict = None):
    """Reduced ``arch`` at 2 layers, fp32 compute, no remat (``fields``
    override more)."""
    kw = {"num_layers": 2, "compute_dtype": "float32", "remat": False,
          **(fields or {})}
    return dataclasses.replace(TC.get_config(arch).reduced(), **kw)


def assert_train_matches(got: dict, want: dict,
                         limits: tuple = (1e-5, 1e-5)) -> None:
    """The mesh-training bar: losses, ``moe_aux`` and ``grad_norm`` within
    1e-5 rel, the same ``lr``; the step-1 gradients, made whole, within
    1e-5 of each tensor's largest |g| (``BWD_TOL``); the final params
    within 1e-3 abs (``tests/test_torch_train.py``).  ``limits`` (the
    later steps' metrics rel, the step-1 gradients) replace the two
    1e-5s for a case whose fp32 steps part from the reference by more
    (``_mesh_family_ranks.TRAIN_LIMITS``)."""
    later, grad_tol = limits
    assert len(got["metrics"]) == len(want["metrics"])
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in ("loss", "grad_norm", "moe_aux", "total_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5 if i == 0
                                       else later, atol=1e-12,
                                       err_msg=f"{k} step {i + 1}")
        assert g["lr"] == w["lr"]
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        err = np.abs(got["grads"][k] - w).max()
        assert err <= grad_tol * np.abs(w).max(), (k, err, np.abs(w).max())
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=0, atol=1e-3,
                                   err_msg=k)


def with_frontend(batches: list, cfg, seed: int = 0) -> list:
    """``batches`` with the family's stubbed frontend inputs added to each,
    drawn with numpy from ``seed`` (a seed or a ``Generator``, which goes
    on from where it stands): the audio family's "frames" (B,
    encoder_frames, d_model), the VLM's "image_embeds" (B,
    num_image_tokens, d_model), fp32; the others' batches as they are."""
    rng = np.random.default_rng(seed)
    for b in batches:
        n = b["tokens"].shape[0]
        if cfg.family == "audio":
            b["frames"] = rng.standard_normal(
                (n, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            b["image_embeds"] = rng.standard_normal(
                (n, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batches


def port_train_data(arch: str, fields: dict = None, seq: int = TRAIN_SEQ,
                    steps: int = TRAIN_STEPS) -> dict:
    """The port's own train data of ``arch`` (no JAX): its initial params
    from seed 0 as numpy and ``steps`` batches of ``SyntheticLM(seed=0)``
    of ``seq`` tokens a row (with the family's frontend inputs:
    :func:`with_frontend`)."""
    from repro_torch.data.pipeline import SyntheticLM
    model = build_model(train_config(arch, fields))
    params, _ = split(model.init(0, device="cpu"))
    src = SyntheticLM(model.cfg.vocab_size, seed=0)
    return {"flat": bridge.params_to_numpy(params),
            "batches": with_frontend([{k: np.asarray(v) for k, v in
                                       src.lm_batch(i, TRAIN_BATCH,
                                                    seq).items()}
                                      for i in range(steps)], model.cfg)}


def _whole(tree, specs, mesh) -> dict:
    if mesh is None:
        return bridge.params_to_numpy(tree)
    return bridge.params_to_numpy(S.unplace(tree, specs, mesh))


def mesh_train(mesh, d: dict, arch: str, fields: dict = None,
               device="cpu", steps: int = TRAIN_STEPS) -> dict:
    """``steps`` of ``make_train_step(param_axes=)`` on ``mesh`` under the
    train rules (in one process for ``mesh`` None), from the data's flat
    params (placed) over its batches: each step's metrics, the step-1
    gradients and the final params made whole (numpy)."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import loop as TL
    from repro_torch.train import step as TS
    model = build_model(train_config(arch, fields))
    _, axes = split(model.init(0, device="meta"))
    rules = S.rules_for("train")
    params = bridge.params_from_numpy(d["flat"], device)
    state = TS.TrainState(0, params, adamw_init(params))
    specs = None
    if mesh is not None:
        specs = TL.state_specs(model, mesh, rules)
        state = S.place(state, specs, mesh)
    grads: list = []

    def first(g):
        if not grads:
            grads.append(g)
        return g
    step = TS.make_train_step(model, param_axes=axes, grad_transform=first,
                              **TRAIN_LR)
    metrics = []
    ctx = S.shard_ctx(mesh, rules) if mesh is not None \
        else contextlib.nullcontext()
    with ctx:
        for batch in d["batches"][:steps]:
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "grads": _whole(grads[0], specs and specs.params, mesh),
            "params": _whole(state.params, specs and specs.params, mesh)}


def drop_continue(mesh, d: dict, arch: str, device="cpu") -> list:
    """2 steps on ``mesh``, a drop to the (1, 2) mesh of its first two
    ranks (``train.loop.remesh`` and ``drop_and_continue``), 1 more step
    there: the losses this rank saw."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import loop as TL
    from repro_torch.train import step as TS
    model = build_model(train_config(arch))
    _, axes = split(model.init(0, device="meta"))
    rules = S.rules_for("train")
    specs = TL.state_specs(model, mesh, rules)
    params = bridge.params_from_numpy(d["flat"], device)
    state = S.place(TS.TrainState(0, params, adamw_init(params)), specs,
                    mesh)
    step = TS.make_train_step(model, param_axes=axes, **TRAIN_LR)
    losses = []
    with S.shard_ctx(mesh, rules):
        for batch in d["batches"][:2]:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    shape, new_specs = TL.remesh(model, state, mesh, 1, 2, rules)
    sub, state = TL.drop_and_continue(state, specs, mesh, new_specs, shape)
    if sub is not None:
        with S.shard_ctx(sub, rules):
            state, m = step(state, d["batches"][2])
            losses.append(float(m["loss"]))
    return losses


def cross_pod_checks(mesh, d: dict, device="cpu") -> dict:
    """The step-1 gradients of the rank's pod's batch (one process's
    ``value_and_grad``, the pods' batches differ), their packed signs and
    fp16 scales, ``cross_pod_grad_mean`` of them over "pod" and the bytes
    this rank sent; numpy."""
    from repro_torch.distributed import compression as GC
    from repro_torch.train import step as TS
    model = build_model(train_config("deepseek-7b"))
    params = bridge.params_from_numpy(d["flat"], device)
    batch = d["batches"][mesh.coord("pod")]
    _, _, grads = TS.value_and_grad(TS.make_loss_fn(model), params, batch)
    sent: list = []
    mean = GC.cross_pod_grad_mean(grads, mesh, sent=sent)
    flat = C.flatten_params(grads)
    return {"grads": bridge.params_to_numpy(grads),
            "quantized": {k: tuple(t.cpu().numpy() for t in GC.quantize(g))
                          for k, g in flat.items() if GC._compressible(g)},
            "mean": bridge.params_to_numpy(mean), "sent": sum(sent),
            "wire": sum(GC.wire_bytes(g)[0] for g in flat.values())}


def refuse_world(mesh):
    """A rank that raises on purpose: the world is not a (2, 2) mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    make_host_mesh(2, 2)
