"""Rank-side half of ``tests/test_torch_mesh_families.py``: what one rank
of a spawned group runs for the audio, VLM, xLSTM and Zamba families and
the sequence-TP attention config.

The parent writes the weights, the delta models, the requests and the
frontend inputs to a pickle (numpy, the bridge's exchange format); each
rank serves or computes on its own blocks and returns plain data.  Nothing
here imports JAX.
"""
import dataclasses
from typing import Optional

import torch

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.core import loader as L
from repro_torch.distributed import sharding as S
from repro_torch.models import build_model
from repro_torch.models import layers as LY
from repro_torch.models.param import split
from repro_torch.serving import Deployment
from repro_torch.serving.variants import OverlayBank

import _mesh_ranks as R

ARCHS = ("whisper-base", "internvl2-76b", "xlstm-350m", "zamba2-7b")
# reduced depths: xlstm-350m one (3 mLSTM, 1 sLSTM) super-block; zamba2-7b
# one shared-block application and a trailing Mamba2 block
FIELDS = {"whisper-base": dict(num_layers=2),
          "internvl2-76b": dict(num_layers=2),
          "xlstm-350m": dict(num_layers=4),
          "zamba2-7b": dict(num_layers=4),
          # 2 mLSTM heads over a model axis of 4: a rank's block of
          # d_inner cuts a head
          "xlstm-350m-2h": dict(num_layers=4, num_heads=2),
          # 6 q heads over a model axis of 4: sequence-TP attention
          "starcoder2-3b": dict(num_layers=2, num_heads=6, num_kv_heads=2,
                                head_dim=16)}
# the cases trained under a mesh: their config's fields (2 layers unless
# they say; the families at the depths of ``FIELDS``, every block kind
# present)
TRAIN_FIELDS = {"starcoder2-3b": dict(num_heads=6, num_kv_heads=2,
                                      head_dim=16),
                **{c: FIELDS[c] for c in ARCHS + ("xlstm-350m-2h",)}}
# the cases (1, 4) trains (every family trains on (1, 2) and (2, 2)): the
# head-cut cases (zamba2-7b's and the 2-head xlstm-350m's 2 heads,
# xlstm-350m's w_ff1 cut 4 ways) and the 6-head config
TRAIN_QUAD = ("zamba2-7b", "xlstm-350m", "xlstm-350m-2h", "starcoder2-3b")
# the cases whose fp32 steps part from the reference by more than the
# mesh-training bar, and the limits they take instead (``_mesh_ranks
# .assert_train_matches``'s ``limits``: the later steps' metrics rel, the
# step-1 gradients of each tensor's max |g|; their first step's metrics
# keep 1e-5 and their params 1e-3).  xLSTM's step-1 gradients are
# ill-conditioned in fp32: in float64 the port's and JAX's agree to
# 1.2e-13 of max in every leaf, while JAX's own fp32 gradients lie up to
# 2.9e-5 from them (embed) and the port's up to 4.1e-5 (mlstm.wq;
# ``tools/train_gaps.py --fp64``).  Against JAX's fp32 step the mesh
# ranks' step-1 gradients part by up to 2.9e-5 (mlstm.wq on (1, 4)) and
# their later metrics by up to 3.1e-5 rel (``tools/train_gaps.py``)
TRAIN_LIMITS = {"xlstm-350m": (1e-4, 5e-5), "xlstm-350m-2h": (1e-4, 5e-5)}
# on an H100 against one process on the CPU (``test_torch_cuda``):
# xlstm-350m's later grad_norm 4.80e-4 rel apart, the 2-head case's
# 1.70e-5, zamba2-7b's 2.04e-5 (``chip_smoke.py``'s ``MESH_TRAIN_LIMITS``
# is this table but for its own 2-head case, 1 mLSTM + 1 sLSTM)
TRAIN_LIMITS_CARD = {"xlstm-350m": (2e-3, 1e-5),
                     "xlstm-350m-2h": (1e-4, 5e-5),
                     "zamba2-7b": (1e-4, 1e-5)}
ARCH_OF = {"xlstm-350m-2h": "xlstm-350m"}
SEQ_ARCH = "starcoder2-3b"
# prompt lengths of the sequence-TP runs: a multiple of the model axis
# (the "seq" branch) and one that is not (the flat-q_dim branch)
SEQ_PROMPTS = (12, 10)
BATCH, PROMPT, MAX_LEN = 4, 12, 32
BUDGETS = R.BUDGETS
NAMES = R.NAMES
SCHEDULERS = {k: R.SCHEDULERS[k] for k in ("continuous", "group-fused")}
# the speculative scheduler (adaptive k up to 4): its tokens are the
# continuous scheduler's
SPEC = dict(R.SCHEDULERS["continuous"], speculative=True, draft_k=4)
KDS = ("shard_map", "gspmd")
LOGIT_LEN = 8
CACHE_DTYPE = torch.float32


def arch_of(case: str) -> str:
    return ARCH_OF.get(case, case)


def port_config(case: str):
    return dataclasses.replace(TC.get_config(arch_of(case)).reduced(),
                               compute_dtype="float32", remat=False,
                               **FIELDS[case])


def setup(arch: str, d: dict, device="cpu"):
    """(model, base params, axes, [DeltaModel]) of one arch's data."""
    model = build_model(port_config(arch))
    _, axes = split(model.init(0, device="cpu"))
    params = bridge.params_from_numpy(d["flat"], device)
    dms = [bridge.delta_model_from_numpy(x, device) for x in d["dms"]]
    return model, params, axes, dms


def serve(model, params, axes, dms, d: dict, mesh, sched: str,
          kd: str = "shard_map", device="cpu",
          prompt_len: int = PROMPT, ladder: Optional[list] = None) -> list:
    """Publish v0, v1; serve the data's requests round-robin over
    ``NAMES`` (on ``mesh``, or in one process for None); every request's
    tokens.  ``sched`` "speculative" serves ``SPEC`` and appends the
    ladder snapshot to ``ladder``."""
    kw = dict(SPEC if sched == "speculative" else SCHEDULERS[sched])
    if mesh is not None:
        kw.update(mesh=mesh, param_axes=axes, graphs=False,
                  kernel_dispatch=kd)
    dep = Deployment(model, params, device=device, batch_size=BATCH,
                     prompt_len=prompt_len, max_len=MAX_LEN, **kw)
    for i, dm in enumerate(dms):
        dep.publish(f"v{i}", dm)
    rids = [dep.submit(p, variant=NAMES[i % len(NAMES)],
                       max_new_tokens=BUDGETS[i % len(BUDGETS)])
            for i, p in enumerate(d["prompts"])]
    dep.drain()
    out = [dep.result(r).out_tokens for r in rids]
    if ladder is not None:
        ladder.append(dep.status()["speculative"])
    dep.close()
    return out


def batch_of(d: dict, rows=slice(None)) -> dict:
    """The logits batch (tokens and the family's frontend inputs), rows
    ``rows``."""
    return {k: torch.from_numpy(v[rows]) for k, v in d["batch"].items()}


def prefill_decode(model, params, batch, overlay=None, vidx=None,
                   gather=lambda t: t) -> tuple:
    """(prefill last logits, one decode step's logits), numpy, each made
    whole over the rows by ``gather``; the greedy token of the whole
    prefill feeds the decode."""
    lg, cache = model.prefill(params, batch, MAX_LEN, cache_dtype=CACHE_DTYPE,
                              overlay=overlay, variant_idx=vidx)
    tok = torch.argmax(lg, dim=-1).to(torch.int32)
    dl, _ = model.decode_step(params, tok, cache, overlay=overlay,
                              variant_idx=vidx)
    return gather(lg).numpy(), gather(dl).numpy()


def bank_of(params, dms, mesh=None, specs=None) -> tuple:
    """A 4-slot OverlayBank holding v0, v1 (placed on ``mesh``), and the
    rows' slots [base, v0, v1, v0]."""
    bank = OverlayBank(params, 4, mesh=mesh)
    slots = []
    for i, dm in enumerate(dms):
        if mesh is not None:
            dm = L.place_delta_model(dm, specs, mesh)
        slots.append(bank.admit(f"v{i}", dm)[0])
    vidx = torch.tensor([0, slots[0], slots[1], slots[0]], dtype=torch.int32)
    return bank, vidx


def family_logits(mesh, arch: str, d: dict) -> dict:
    """{mode: (prefill, decode) logits} of the rank's rows made whole, for
    a single-variant fused overlay and a mixed-variant bank."""
    model, params, axes, dms = setup(arch, d)
    rules = S.rules_for("decode")
    rows = S._names(S.resolve_spec((BATCH,), ("act_batch",), rules,
                                   mesh)[0])
    local, specs, ctx = R._ctx(mesh, params, axes, rows)
    nloc = BATCH // mesh.names_size(rows)
    mine = slice(mesh.index(rows) * nloc, (mesh.index(rows) + 1) * nloc)
    batch = batch_of(d, mine)

    def gather(t):
        return S.all_gather(t, rows, 0, mesh)
    out = {}
    with torch.no_grad(), ctx():
        pv, ov, _ = L.device_put_overlay(local, dms[0],
                                         param_shardings=specs, mesh=mesh)
        out["fused"] = prefill_decode(model, pv, batch, ov, gather=gather)
        bank, vidx = bank_of(local, dms, mesh, specs)
        out["banked"] = prefill_decode(model, local, batch, bank.tree,
                                       vidx[mine], gather=gather)
    return out


def unsharded_logits(arch: str, d: dict) -> dict:
    """The port's logits in one process (the reference of
    :func:`family_logits`)."""
    model, params, _, dms = setup(arch, d)
    batch = batch_of(d)
    with torch.no_grad():
        pv, ov, _ = L.device_put_overlay(params, dms[0])
        out = {"fused": prefill_decode(model, pv, batch, ov)}
        bank, vidx = bank_of(params, dms)
        out["banked"] = prefill_decode(model, params, batch, bank.tree, vidx)
    return out


def rmsnorm_check(mesh, seed: int = 0) -> float:
    """Largest |err| of the rmsnorm over a feature dim the model axis
    splits (each rank its block, the sum of squares summed over the ranks)
    against the whole one, on the rank's block."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((3, 5, 64), generator=gen)
    scale = 1 + 0.1 * torch.randn((64,), generator=gen)
    whole = LY.rmsnorm(x, scale, 1e-6)
    with S.shard_ctx(mesh, S.rules_for("decode")):
        got = LY.rmsnorm(LY.rank_block(x, "model"),
                         LY.rank_block(scale, "model"), 1e-6, part="model")
        want = LY.rank_block(whole, "model")
    return float((got - want).abs().max())


def rmsnorm_grad_check(mesh, seed: int = 1) -> dict:
    """The rmsnorm over a feature dim the model axis splits, under grad
    and the train rules, on ``mesh``'s device: the largest |err| of the
    rank's ``dx`` and ``dscale`` against its blocks of the whole norm's
    gradients, over their largest |value| (the fp32 ``dscale`` sums 15
    rows, so an absolute 1e-6 would be two of its ulps), and whether its
    forward without grad equals, bit for bit,
    the forward-only formula (the fp32 sum of squares psummed, divided by
    the whole dim)."""
    dev = mesh.device
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((3, 5, 64), generator=gen).to(dev)
    scale = (1 + 0.1 * torch.randn((64,), generator=gen)).to(dev)
    dy = torch.randn((3, 5, 64), generator=gen).to(dev)
    xw, sw = (t.clone().requires_grad_(True) for t in (x, scale))
    with torch.enable_grad():
        dxw, dsw = torch.autograd.grad(LY.rmsnorm(xw, sw, 1e-6), (xw, sw),
                                       dy)
    with S.shard_ctx(mesh, S.rules_for("train")):
        xb, sb = (LY.rank_block(t, "model").clone().requires_grad_(True)
                  for t in (x, scale))
        with torch.enable_grad():
            dxb, dsb = torch.autograd.grad(
                LY.rmsnorm(xb, sb, 1e-6, part="model"), (xb, sb),
                LY.rank_block(dy, "model"))
        want = (LY.rank_block(dxw, "model"), LY.rank_block(dsw, "model"))
        with torch.no_grad():
            got = LY.rmsnorm(xb, sb, 1e-6, part="model")
            xf = xb.to(torch.float32)
            ss = S.psum((xf * xf).sum(dim=-1, keepdim=True), "model")
            inv = torch.rsqrt(ss / 64 + 1e-6)
            plain = xb * inv.to(xb.dtype) * sb.to(xb.dtype)
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    return {"dx": rel(dxb, want[0]), "dscale": rel(dsb, want[1]),
            "forward bits": bool(torch.equal(got, plain)),
            "device": str(dev)}


def run(mesh, path: str, plan: dict) -> dict:
    """Everything one spawn of a mesh shape checks."""
    torch.set_num_threads(1)
    data = R.load(path)
    device = str(mesh.device)
    out = {"coords": mesh.coords, "rmsnorm": rmsnorm_check(mesh),
           "rmsnorm grad": rmsnorm_grad_check(mesh)}
    for arch, scheds in plan.get("tokens", {}).items():
        model, params, axes, dms = setup(arch, data[arch], device)
        out[("tokens", arch)] = {
            (kd, s): serve(model, params, axes, dms, data[arch], mesh, s, kd,
                           device)
            for kd in KDS for s in scheds}
    for arch in plan.get("logits", ()):
        out[("logits", arch)] = family_logits(mesh, arch, data[arch])
    if plan.get("seq"):
        out["seq"], out["seq layouts"] = seq_runs(mesh, data[SEQ_ARCH],
                                                  device)
    for case in plan.get("train", ()):
        out[("train", case)] = R.mesh_train(
            mesh, data[f"train {case}"], arch_of(case),
            fields=TRAIN_FIELDS[case], device=device)
    for arch in plan.get("spec", ()):
        model, params, axes, dms = setup(arch, data[arch], device)
        for kd in KDS:
            ladder: list = []
            tokens = serve(model, params, axes, dms, data[arch], mesh,
                           "speculative", kd, device, ladder=ladder)
            out[("spec", arch, kd)] = (tokens, ladder[0])
    return out


def seq_runs(mesh, d: dict, device="cpu") -> tuple:
    """The sequence-TP config served at each of ``SEQ_PROMPTS``: ({(kd,
    prompt_len): tokens}, {prompt_len: the attention layouts taken})."""
    from repro_torch.models import attention as A
    model, params, axes, dms = setup(SEQ_ARCH, d, device)
    tokens, layouts = {}, {}
    orig = A.head_split
    for n in SEQ_PROMPTS:
        seen = set()

        def recorded(cfg, s=None):
            split = orig(cfg, s)
            seen.add(split)
            return split
        A.head_split = recorded
        try:
            for kd in KDS:
                tokens[(kd, n)] = serve(model, params, axes, dms, d, mesh,
                                        "continuous", kd, device,
                                        prompt_len=n)
        finally:
            A.head_split = orig
        layouts[n] = seen
    return tokens, layouts
