"""Serving launcher (port of ``repro.launch.serve``): a deployment over
synthetic delta variants, driven through ``serving/api.Deployment``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --num-layers 4 --mode fused --scheduler continuous

``--arch`` is any registered arch (``repro_torch.configs.ARCHS``):
qwen3-8b, deepseek-7b, starcoder2-3b, gemma3-12b, deepseek-moe-16b,
moonshot-v1-16b-a3b, internvl2-76b (the VLM backbone: every prompt follows
``num_image_tokens`` zero image embeddings, and the caches hold them),
whisper-base (encoder-decoder: every request's zero encoder frames go
through the encoder), xlstm-350m (``--num-layers`` a multiple of 8: 7
mLSTM + 1 sLSTM) and zamba2-7b (the shared attention block after every
6th Mamba2 layer).

Builds a random base model from a seed, makes ``--variants`` synthetic
fine-tunes (base + 0.005·noise on every matrix), compresses each with
calibration stage 0, publishes them, and serves ``--requests`` requests
round-robin over the base and the variants.  ``--scheduler group`` (the
default) serves one variant per batch: ``--mode dense`` materialises each
variant (the ``unpack_apply`` kernel), ``--mode fused`` keeps it packed
(the ``bitlinear_axes`` kernel in every overlaid projection).
``--scheduler continuous`` serves mixed-variant batches from an overlay
bank of ``variants + 2`` slots (the ``bitlinear_axes_banked`` kernel) and
needs ``--mode fused``.  ``--speculative`` decodes those lanes by
base-as-draft rounds (drafts on the base weights, one banked verify of
``--draft-k`` + 1 tokens a lane; same tokens) and prints the acceptance.
``--warmup`` readies every step before the requests (the slot scheduler's
steps captured as CUDA graphs on a card) and ``--compile-cache DIR`` loads
the kernel library from DIR, building it there only on a miss; the run
prints the capture and build counters, its seconds from start to the first
token and every request's tokens.  ``--base-dtype int8`` holds the base's target
matrices as int8 plus fp16 per-channel scales (the kernels dequantize in
their tile pass) and prints the quantized bytes.  ``--store-dir DIR``
publishes the variants as artifacts in a ``core/store.VariantStore`` under
DIR and serves them from it (default: in memory).  ``--async-admission``
(the slot schedulers) loads and stages each variant on a background
worker, paced by ``--admission-pacing`` seconds between modules, and
commits it between decode steps; the run prints the pipeline's counters.
``--max-retries`` bounds the retries of a request whose variant fails to
load.  ``--max-resident N`` bounds the registry's residents (0: 2 for
``--mode dense``, 8 for fused).  ``--updates N`` runs the paper's frequent
update after the requests, as the JAX launcher does: N times, v0's
fine-tune moves on by ``ft + 0.2·(ft − base)`` and ships as
``Deployment.update`` (an XOR/RLE patch with a store), the pointer swaps
(printed as ``update {u}: v0 -> version {v}``) and ``--batch`` v0 requests
are served; then ``rollback("v0")`` (``rollback: v0 -> version {v}``) and
one more v0 request.  The run ends with the TTFT line, ``ttft: p50=…
p99=… (n=…)``, from ``status()["ttft"]``.  ``--num-layers`` cuts depth
only; ``--reduced`` selects the small test widths.  Runs on ``--device``
(default cuda).

``--mesh DATA,MODEL`` (or ``POD,DATA,MODEL``) serves over a (data, model)
(or (pod, data, model)) mesh of ranks, one process each (``launch/mesh``;
explicit SPMD, ``distributed/sharding``): under ``torchrun``
(``WORLD_SIZE`` set) this process is one rank, else the launcher starts
the ranks itself (``launch.mesh.spawn``: NCCL when every rank has a card
of its own, else gloo over shared card 0) and checks that every rank
served the same tokens; every ``--arch`` serves there.
``--kernel-dispatch`` picks per-rank
kernels (``shard_map``, the default) or the gathered global kernels
(``gspmd``).  ``--base-dtype int8`` and ``--updates`` serve under a mesh as
on one device (each rank quantizes its blocks to the single-device bytes;
with ``--store-dir`` rank 0 writes and a refused write raises on every
rank), and the run prints each rank's base and bank bytes; so does
``--async-admission`` (the ranks agree on each commit).  Mesh serving runs
its steps eagerly.  ``--speculative`` serves under a mesh, and every rank
prints its ladder snapshot (``speculative rank R:``; the ranks walk the
ladder in step); ``--warmup`` readies every step on every rank (each
outcome "eager"), and ``--compile-cache DIR`` is the cache every rank
loads the kernel library through (rank 0 first).  ``--pod-banks`` (a
3-value ``--mesh`` and ``--scheduler continuous``, not ``--speculative``)
keeps one overlay bank per pod of ``variants + 2`` slots and routes each
request to a pod that holds its variant, MoE archs included; the run adds
the router's ``affinity:`` line, the bank bytes and residents per pod and
the admission bytes in and across pods.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import calibration as C
from repro_torch.core import compile_cache as CC
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.param import split
from repro_torch.serving import Deployment
from repro_torch.tree import tree_leaves, tree_map

PROMPT_LEN = 16
MAX_LEN = 64


def cache_len(cfg, prompt_len: int = PROMPT_LEN,
              new_tokens: int = MAX_LEN - PROMPT_LEN) -> int:
    """KV slots a request needs: a VLM's image prefix, the padded prompt
    and the new tokens (a write past the cache would land on its last
    slot)."""
    return cfg.num_image_tokens + prompt_len + new_tokens


def make_config(arch: str, reduced: bool = False, num_layers: int = 0):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return cfg


def fine_tune(base, seed: int, scale: float = 0.005):
    """Synthetic fine-tune: every matrix (ndim >= 2) plus scaled normal
    noise drawn from a generator seeded with ``seed``."""
    dev = tree_leaves(base)[0].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def noisy(t):
        if t.dim() < 2:
            return t
        return t + scale * torch.randn(t.shape, generator=gen, device=dev,
                                       dtype=t.dtype)
    return tree_map(noisy, base)


def continue_tune(tune, base):
    """The next fine-tune of a variant's lineage (``--updates``): every
    matrix of ``tune`` moved on by 0.2 times its delta from ``base``."""
    step = 0.2
    ft, b = C.flatten_params(tune), C.flatten_params(base)
    return C.unflatten_like(tune, {
        p: t + step * (t - b[p]) if t.dim() >= 2 else t
        for p, t in ft.items()})


def build_variants(cfg, n_variants: int, device, seed: int = 0,
                   with_axes: bool = False):
    """(model, base params (seeded), [DeltaModel of each synthetic
    fine-tune]) — and the params' logical axes with ``with_axes``; each
    fine-tune is freed once compressed."""
    model = build_model(cfg)
    base, axes = split(model.init(seed, device=device))
    dms = [C.compress(base, fine_tune(base, 100 + i))
           for i in range(n_variants)]
    return (model, base, dms, axes) if with_axes else (model, base, dms)


def deploy(model, base, dms, *, mode: str, scheduler: str, batch: int,
           device, max_resident: int = 0, bank_size: int = 0,
           base_dtype: str = "fp", root_dir=None,
           prompt_len: int = PROMPT_LEN, max_len: int = 0,
           draft_k: int = 4, graphs: bool = True, **kw):
    """A Deployment over ``base`` with ``dms`` published as v0..v{n-1}
    (as store artifacts under ``root_dir`` when given); prompts padded to
    ``prompt_len``, caches of ``max_len`` (default ``cache_len``: room for
    48 new tokens); ``draft_k`` for ``scheduler="speculative"``;
    ``graphs=False`` runs the slot scheduler's steps eagerly; ``kw`` goes
    to ``Deployment`` (``async_admission``, ``max_retries``,
    ``admission_pacing_s``)."""
    dep = Deployment(model, base, root_dir=root_dir, mode=mode,
                     scheduler=scheduler, draft_k=draft_k,
                     batch_size=batch, prompt_len=prompt_len,
                     max_len=max_len or cache_len(model.cfg, prompt_len),
                     max_resident=max_resident or (8 if mode == "fused"
                                                   else 2),
                     bank_size=bank_size or len(dms) + 2, device=device,
                     base_dtype=base_dtype, graphs=graphs, **kw)
    for i, dm in enumerate(dms):
        dep.publish(f"v{i}", dm)
    return dep


def submit_requests(dep, cfg, n_requests: int, new_tokens, names=None,
                    rng=None) -> list:
    """Queue ``n_requests`` random 8-token prompts round-robin over
    ``names`` (default: the deployment's variants, base first);
    ``new_tokens`` is one budget or a sequence of budgets cycled over the
    requests; the prompts come from ``rng`` (default: a new generator
    seeded with 0), so a caller that passes one continues its stream.
    Returns the request ids."""
    rng = np.random.default_rng(0) if rng is None else rng
    names = dep.variants() if names is None else names
    budgets = [new_tokens] if isinstance(new_tokens, int) else new_tokens
    return [dep.submit(rng.integers(1, cfg.vocab_size, size=8),
                       variant=names[i % len(names)],
                       max_new_tokens=budgets[i % len(budgets)])
            for i in range(n_requests)]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut depth to this many layers (0: as configured)")
    ap.add_argument("--variants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--mode", choices=("dense", "fused"), default="dense")
    ap.add_argument("--scheduler", choices=("group", "continuous"),
                    default="group",
                    help="continuous: mixed-variant lanes over the overlay "
                         "bank (needs --mode fused); group: one variant "
                         "per batch")
    ap.add_argument("--base-dtype", choices=("fp", "int8"), default="fp",
                    help="int8: target matrices held as int8 + fp16 "
                         "per-channel scales")
    ap.add_argument("--store-dir", default=None,
                    help="persist the variants as store artifacts here and "
                         "serve them from it (default: in memory)")
    ap.add_argument("--speculative", action="store_true",
                    help="base-as-draft speculative decoding on the "
                         "continuous lanes (needs --mode fused): the same "
                         "tokens, up to draft-k + 1 a lane per round")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="longest speculative draft (the adaptive ladder "
                         "steps down under low acceptance)")
    ap.add_argument("--warmup", action="store_true",
                    help="ready every step before the requests: the slot "
                         "scheduler's decode steps and rounds captured as "
                         "CUDA graphs on a card")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="directory of built kernel libraries: loaded from "
                         "there, built there on a miss (also "
                         "REPRO_COMPILE_CACHE_DIR)")
    ap.add_argument("--async-admission", action="store_true",
                    help="load and stage each variant on a background "
                         "worker and commit it between decode steps "
                         "(publish returns without blocking; needs "
                         "--scheduler continuous or --speculative)")
    ap.add_argument("--admission-pacing", type=float, default=0.002,
                    metavar="SECONDS",
                    help="async admission: the worker's sleep between "
                         "artifact modules (0 disables)")
    ap.add_argument("--max-resident", type=int, default=0,
                    help="registry residents (0: 2 for dense, 8 for fused)")
    ap.add_argument("--updates", type=int, default=0,
                    help="update + hot-swap cycles on variant v0 after the "
                         "requests, then a rollback")
    ap.add_argument("--max-retries", type=int, default=1,
                    help="retries of a request whose variant fails to "
                         "load before it fails")
    ap.add_argument("--mesh", default=None,
                    metavar="DATA,MODEL | POD,DATA,MODEL",
                    help="serve on a (data, model) mesh of ranks, or with "
                         "three values a (pod, data, model) one, one "
                         "process each (default: one device)")
    ap.add_argument("--pod-banks", action="store_true",
                    help="pod-local overlay banks and affinity routing: "
                         "one bank per pod, requests steered to the pod "
                         "that holds their variant (needs a 3-value --mesh "
                         "and --scheduler continuous)")
    ap.add_argument("--kernel-dispatch", choices=("shard_map", "gspmd"),
                    default="shard_map",
                    help="mesh delta GEMMs: per-rank kernels (default) or "
                         "the gathered global kernels")
    ap.add_argument("--device", default="cuda")
    return ap


def _mesh_shape(ap, args):
    """(data, model) or (pod, data, model) of ``--mesh``, or None."""
    parts = []
    if args.mesh:
        try:
            parts = [int(p) for p in args.mesh.split(",")]
        except ValueError:
            parts = []
        if len(parts) not in (2, 3):
            ap.error("--mesh expects DATA,MODEL or POD,DATA,MODEL, e.g. "
                     "--mesh 1,2 or --mesh 2,1,2")
    if args.pod_banks:
        if len(parts) != 3:
            ap.error("--pod-banks needs a 3-value --mesh POD,DATA,MODEL")
        if args.scheduler != "continuous" or args.speculative:
            ap.error("--pod-banks requires --scheduler continuous (the "
                     "affinity router lives in the slot scheduler)")
    return tuple(parts) or None


def _mesh_rank(mesh, argv) -> list:
    """One rank of a self-started mesh: serve, return the tokens."""
    return _serve(_parser().parse_args(argv), mesh, time.perf_counter())


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    shape = _mesh_shape(ap, args)
    if shape is None:
        _serve(args, None, t_start)
        return
    from repro_torch.launch import mesh as LM
    if args.compile_cache:
        # every rank loads the kernel library through this cache, before
        # it serves (launch.mesh.load_kernels: rank 0 first)
        os.environ["REPRO_COMPILE_CACHE_DIR"] = args.compile_cache
    if "WORLD_SIZE" in os.environ:
        # under torchrun: this process is one rank
        world = int(os.environ["WORLD_SIZE"])
        backend = LM.backend_for(args.device, world)
        rank = int(os.environ["RANK"])
        dev = LM.rank_device(args.device, backend, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.distributed.init_process_group(
            backend,
            timeout=datetime.timedelta(seconds=LM.DEFAULT_TIMEOUT_S))
        mesh = LM.mesh_of_shape(shape, device=dev)
        LM.load_kernels(mesh)
        _serve(args, mesh, t_start)
        torch.distributed.destroy_process_group()
        return
    tokens = LM.spawn(_mesh_rank, shape, device=args.device,
                      args=(list(sys.argv[1:] if argv is None else argv),))
    if any(t != tokens[0] for t in tokens):
        raise RuntimeError("the mesh's ranks served different tokens")
    print(f"mesh: {len(tokens)} ranks served the same tokens")


def _line(*parts) -> None:
    """``print(*parts)`` as one write, flushed: a mesh's ranks print to one
    stream, and ``print`` writes each part and the newline apart, so
    another rank's line could land inside this one."""
    sys.stdout.write(" ".join(map(str, parts)) + "\n")
    sys.stdout.flush()


def _serve(args, mesh, t_start: float) -> list:
    """Build, publish and serve (on this rank of ``mesh``, if any); the
    report prints once (rank 0).  Returns every request's tokens."""
    ap = _parser()
    say = print if mesh is None else _line if mesh.rank == 0 \
        else (lambda *a: None)
    if args.speculative:
        if args.mode != "fused":
            ap.error("--speculative verifies through the packed overlay "
                     "bank and needs --mode fused")
        args.scheduler = "speculative"
    if args.scheduler == "continuous" and args.mode != "fused":
        ap.error("--scheduler continuous serves from the overlay bank and "
                 "needs --mode fused")
    if args.async_admission and args.scheduler == "group":
        ap.error("--async-admission commits staged variants into the "
                 "overlay bank between decode steps and needs --scheduler "
                 "continuous (or --speculative)")

    device = resolve_device(args.device) if mesh is None else mesh.device
    if mesh is not None:
        say(f"mesh: {dict(zip(mesh.axis_names, mesh.shape))} backend "
            f"{mesh.backend} kernel-dispatch {args.kernel_dispatch}")
    if args.compile_cache:
        CC.set_default(CC.CompileCache(args.compile_cache))
    cfg = make_config(args.arch, args.reduced, args.num_layers)
    mesh_kw = {} if mesh is None else dict(
        mesh=mesh, kernel_dispatch=args.kernel_dispatch, graphs=False,
        pod_banks=args.pod_banks)
    if args.updates and args.variants < 1:
        ap.error("--updates moves variant v0 on: needs --variants >= 1")
    model, base, dms, axes = build_variants(cfg, args.variants, device,
                                            with_axes=True)
    if mesh is not None:
        mesh_kw["param_axes"] = axes
    dep = deploy(model, base, dms, mode=args.mode, scheduler=args.scheduler,
                 batch=args.batch, device=device,
                 max_resident=args.max_resident,
                 base_dtype=args.base_dtype, root_dir=args.store_dir,
                 max_len=cache_len(cfg, PROMPT_LEN,
                                   max(args.new_tokens,
                                       MAX_LEN - PROMPT_LEN)),
                 draft_k=args.draft_k, async_admission=args.async_admission,
                 admission_pacing_s=args.admission_pacing,
                 max_retries=args.max_retries, **mesh_kw)
    del dms
    if not args.updates:
        del base
    if args.base_dtype == "int8":
        qs = dep.registry.quant_stats
        say(f"int8 base: {qs['targets']} targets, "
              f"{qs['fp_bytes']} -> {qs['int8_bytes']} bytes "
              f"(ratio {qs['ratio']:.3f})")
    if args.warmup:
        say("warmup:", json.dumps(dep.warmup()))
    rng = np.random.default_rng(0)
    rids = submit_requests(dep, cfg, args.requests, args.new_tokens,
                           rng=rng)
    dep.drain()
    if args.updates:
        rids += _update_cycles(dep, cfg, base, args, rng, say)
    reqs = [dep.result(r) for r in rids]
    if dep.store is not None:
        say("store:", {n: {"versions": dep.store.versions(n),
                             "artifact_bytes": dep.store.artifact_bytes(
                                 n, dep.store.latest(n))}
                         for n in dep.store.names()})
    say("metrics:", dep.metrics)
    if args.speculative:
        say("speculative:", dep.status()["speculative"])
        if mesh is not None:
            # every rank's ladder: the ranks walk it in step
            _line(f"speculative rank {mesh.rank}:",
                  dep.status()["speculative"])
    say("registry:", dep.stats)
    if dep.admission is not None:
        say("admission:", dep.admission.stats)
        say("staging-pool:", dep.admission.pool.stats)
    st = dep.status()
    say("compiles:", st["steps"])
    say("compile-cache:", st["compile_cache"])
    first = min(r.first_token_at for r in reqs)
    say("startup:", json.dumps({
        "warmup_seconds": dep.metrics["warmup_seconds"],
        "first_token_seconds": first - t_start,
        "first_token_unix": time.time() - (time.perf_counter() - first)}))
    say("tokens:", json.dumps([r.out_tokens for r in reqs]))
    hbm = st["hbm"]
    say("hbm:", {k: hbm[k] for k in ("base_dtype", "base_bytes",
                                       "bank_bytes")})
    if mesh is not None:
        say("base per-device bytes:", hbm["base_per_device"])
        if dep.registry.bank is not None:
            say("bank per-device bytes:", st["mesh"]["bank_per_device"])
    if args.pod_banks:
        af = st["affinity"]
        say(f"affinity: pods={af['pods']} hits={af['hits']} "
            f"misses={af['misses']} hit_rate={af['hit_rate']:.3f}")
        say("bank per-pod bytes:", hbm["bank_per_pod"])
        say("bank residents per pod:", hbm["bank_resident_per_pod"])
        bank = dep.registry.bank
        if bank is not None:
            say(f"admission bytes: in-pod={bank.stats['admit_bytes_in_pod']}"
                f" cross-pod={bank.stats['admit_bytes_cross_pod']}")
    tt = st["ttft"]
    say(f"ttft: p50={tt['p50_seconds']:.4f}s p99={tt['p99_seconds']:.4f}s "
        f"(n={tt['count']})")
    dep.close()
    return [r.out_tokens for r in reqs]


def _update_cycles(dep, cfg, base, args, rng, say) -> list:
    """``--updates``: v0's fine-tune (made again from its seed, as
    ``build_variants`` made it) moved on and shipped ``args.updates``
    times, each followed by a wave of ``args.batch`` v0 requests; then a
    rollback and one more v0 request.  Returns the request ids."""
    rids = []
    tune = fine_tune(base, 100)
    for u in range(args.updates):
        tune = continue_tune(tune, base)
        v = dep.update("v0", C.compress(base, tune))
        say(f"update {u}: v0 -> version {v}")
        rids += submit_requests(dep, cfg, args.batch, args.new_tokens,
                                names=["v0"], rng=rng)
        dep.drain()
    v = dep.rollback("v0")
    say(f"rollback: v0 -> version {v}")
    rids += submit_requests(dep, cfg, 1, args.new_tokens, names=["v0"],
                            rng=rng)
    dep.drain()
    return rids


if __name__ == "__main__":
    main()
