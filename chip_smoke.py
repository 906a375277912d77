#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: ``nvidia-smi`` name and power limit; fails without a CUDA device;
2. build: compiles the CUDA kernels from ``src/repro_torch/csrc`` and prints
   ``nvcc -Xptxas -v`` (registers, shared memory, spills per kernel);
3. kernels: each kernel's wrapper at the serving path's shapes of qwen3-8b
   (full width), held against its plain PyTorch version on the same inputs
   and timed with CUDA events (L2 flushed before every launch) beside its
   bound, the plain version and, where one exists, a single PyTorch call;
   the banked kernel also beside the single-variant kernel on the same x;
4. reference: a reduced qwen3-8b served on the card through the kernels
   and on the CPU through the plain versions, same weights and requests,
   with the group scheduler (dense and fused) and the continuous scheduler
   (heterogeneous budgets): greedy tokens must be identical;
5. serve: qwen3-8b at full width cut to 4 layers, 2 synthetic variants,
   batch 4, through ``Deployment``: 8 requests x 8 new tokens with the
   group scheduler in dense and in fused mode, then 12 requests with
   budgets 4, 6, .. 12 round-robin over base, v0 and v1 with the
   continuous scheduler (bank of 4 slots).  The launch counters are zeroed
   right before each run and must show the run's kernel; the continuous run
   must launch the banked kernel 28 times (7 projections x 4 layers) per
   prefill and per decode step.  One fused prefill is repeated through the
   plain versions and the logit difference printed; one decode step of
   each run is profiled.

Then it prints the kernel summary as one JSON line, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.

Tolerances: ``unpack_apply`` performs the plain version's arithmetic
exactly (one fp32 add per element), so it must be bit-identical.
``bitlinear_axes`` and ``bitlinear_axes_banked`` form the same fp32 Ŵ and
sum products in another order: |kernel - plain| <= 1e-5 · Σ_k |x||Ŵ| + 1e-6
per output (Ŵ of the row's own bank slot).  TF32 is off for every fp32
product run here (the plain versions and the library yardstick included).
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
ARCH = "qwen3-8b"
SERVE_LAYERS = 4
LANES, PROMPT = 4, 16         # serving batch and padded prompt length
BANK_VIDX = [0, 1, 2, 1]      # kernel phase: base, two variants, mixed
CONT_BUDGETS = [4, 6, 8, 10, 12]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of a call, L2 flushed before each launch."""

    def __init__(self, device):
        self.flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, reps: int = 5, warmup: int = 1) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def projections(cfg) -> list:
    d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    return [("wq", q, d), ("wk", kv, d), ("wv", kv, d), ("wo", d, q),
            ("w_gate", ff, d), ("w_up", ff, d), ("w_down", d, ff)]


def counters() -> dict:
    from repro_torch.kernels import bitlinear as BL
    from repro_torch.kernels import unpack_apply as UA
    return {"unpack_apply": UA.launches, "bitlinear_axes": BL.launches,
            "bitlinear_axes_banked": BL.banked_launches}


def zero_counters() -> None:
    from repro_torch.kernels import bitlinear as BL
    from repro_torch.kernels import unpack_apply as UA
    UA.launches = 0
    BL.launches = 0
    BL.banked_launches = 0


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def banked_rows(name, n, k, gen, dev, timer, wb, packed, v_row, v_col):
    """``bitlinear_axes_banked`` at one projection shape, over a bank of 4
    slots built from the stack's first three layers (slot 0 zero = base,
    slot 1 row-scaled, slot 2 col-scaled, slot 3 row-scaled):
    M=4 lanes with vidx [0,1,2,1], M=64 (the same lanes x 16 tokens) and
    an all-base M=4 batch held against the plain fp32 x @ W_bᵀ."""
    from repro_torch.core import delta as D
    from repro_torch.kernels import bitlinear as BL

    w0 = wb[0].contiguous()
    zero_n = torch.zeros_like(v_row[0])
    zero_k = torch.zeros_like(v_col[0])
    bp = torch.stack([torch.zeros_like(packed[0]), packed[0], packed[1],
                      packed[2]]).contiguous()
    bvr = torch.stack([zero_n, v_row[0], zero_n, v_row[2]]).to(
        torch.float16).contiguous()
    bvc = torch.stack([zero_k, zero_k, v_col[1], zero_k]).to(
        torch.float16).contiguous()
    w_abs = []
    for s in range(4):
        signs = D.unpack_signs(bp[s], k)
        w_abs.append(((bvr[s].float()[:, None] + bvc[s].float()[None, :])
                      * signs + w0).abs())
        del signs
    rows = []
    cases = [("M=4", BANK_VIDX), ("M=64", [s for s in BANK_VIDX
                                           for _ in range(PROMPT)]),
             ("M=4 all-base", [0] * LANES)]
    for label, vlist in cases:
        m = len(vlist)
        vidx = torch.tensor(vlist, dtype=torch.int32, device=dev)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        got = BL.bitlinear_axes_banked_p(x, vidx, bp, bvr, bvc, w0)
        if label.endswith("all-base"):
            want = x.float() @ w0.T
        else:
            want = BL.plain_banked(x.float(), vidx, bp, bvr, bvc, w0)
        scale = torch.zeros_like(want)
        for s in set(vlist):
            scale = torch.where(vidx[:, None] == s,
                                x.float().abs() @ w_abs[s].T, scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
        assert ok, (name, label, err)
        named = sorted(set(vlist) - {0})
        nbytes = (x.numel() * 2 + m * 4 + w0.numel() * 4 + m * n * 4
                  + len(named) * (n * k // 8 + (n + k) * 2))
        b, by = bound_ms(nbytes, 2 * m * n * k + 2 * n * k * len(named))
        vr1, vc1, p1 = bvr[1], bvc[1], bp[1]
        rows.append({
            "shape": f"{name} {label} N={n} K={k}", "m": m, "case": label,
            "max_abs_err": err,
            "ms": timer.ms(lambda: BL.bitlinear_axes_banked_p(
                x, vidx, bp, bvr, bvc, w0), reps=20, warmup=3),
            "plain_ms": timer.ms(lambda: BL.plain_banked(
                x, vidx, bp, bvr, bvc, w0), reps=10, warmup=2),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            # the single-variant kernel on the same x: a uniform batch
            "uniform_ms": timer.ms(lambda: BL.bitlinear_axes_p(
                x, p1, vr1, vc1, w0), reps=20, warmup=3)})
        del got, want, scale
    return rows


def kernel_phase(cfg, dev, timer) -> tuple:
    from repro_torch.core import delta as D
    from repro_torch.kernels import bitlinear as BL
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import unpack_apply as UA

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    L = SERVE_LAYERS
    ua_rows, bl_rows, bk_rows = [], [], []
    for name, n, k in projections(cfg):
        wb = torch.randn((L, n, k), generator=gen, device=dev) * k ** -0.5
        delta = torch.randn((L, n, k), generator=gen, device=dev) * 0.005
        packed = D.pack_signs(D.sign_mask(delta))
        v_row = D.init_scale(delta, "row")
        v_col = D.init_scale(delta, "col")
        del delta
        # -- unpack_apply: the dense load's row and col launches ----------
        for mode, v in (("row", v_row), ("col", v_col)):
            got = K.unpack_apply(packed, v, wb, mode=mode,
                                 out_dtype=torch.float32)
            want = UA.plain(packed, v, wb, mode, dtype=torch.float32)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            assert torch.equal(got, want), (name, mode, err)
            del got, want
            nbytes = packed.numel() + v.numel() * 4 + 2 * wb.numel() * 4
            b, by = bound_ms(nbytes, wb.numel())
            ua_rows.append({
                "shape": f"{name} {mode} ({L},{n},{k})", "max_abs_err": err,
                "ms": timer.ms(lambda: K.unpack_apply(
                    packed, v, wb, mode=mode, out_dtype=torch.float32)),
                "plain_ms": timer.ms(lambda: UA.plain(
                    packed, v, wb, mode, dtype=torch.float32)),
                "bound_ms": b, "bound_by": by, "library_ms": None})
        # -- bitlinear_axes: layer 0's overlay entry, row-selected ---------
        w0, p0 = wb[0].contiguous(), packed[0].contiguous()
        vr = v_row[0].to(torch.float16)
        vc = torch.zeros(k, dtype=torch.float16, device=dev)
        signs = D.unpack_signs(p0, k)
        w_hat = (vr.float()[:, None] + vc.float()[None, :]) * signs + w0
        w_abs = w_hat.abs()
        del signs
        for m in (LANES, LANES * PROMPT):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            got = BL.bitlinear_axes_p(x, p0, vr, vc, w0)
            want = BL.plain(x.float(), p0, vr, vc, w0)
            scale = x.float().abs() @ w_abs.T
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
            assert ok, (name, m, err)
            x32 = x.float()
            nbytes = (x.numel() * 2 + p0.numel() + (n + k) * 2
                      + w0.numel() * 4 + m * n * 4)
            b, by = bound_ms(nbytes, 2 * m * n * k + 2 * n * k)
            bl_rows.append({
                "shape": f"{name} M={m} N={n} K={k}", "m": m,
                "max_abs_err": err,
                "ms": timer.ms(lambda: BL.bitlinear_axes_p(x, p0, vr, vc, w0),
                               reps=20, warmup=3),
                "plain_ms": timer.ms(lambda: BL.plain(x, p0, vr, vc, w0),
                                     reps=20, warmup=3),
                "bound_ms": b, "bound_by": by,
                "library_ms": timer.ms(lambda: torch.matmul(x32, w_hat.T),
                                       reps=20, warmup=3)})
        del w_hat, w_abs
        # -- bitlinear_axes_banked: a bank of 4 slots ----------------------
        bk_rows += banked_rows(name, n, k, gen, dev, timer, wb, packed,
                               v_row, v_col)
        del wb, packed, v_row, v_col, w0, p0
        torch.cuda.empty_cache()
    for r in ua_rows + bl_rows + bk_rows:
        extra = (f" uniform_ms={r['uniform_ms']:.4f}" if "uniform_ms" in r
                 else "")
        print(f"  {r['shape']:40s} err={r['max_abs_err']:.3g} "
              f"kernel_ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']}{extra}")
    print("kernels: [unpack_apply: bit-identical to plain at "
          f"{len(ua_rows)} shapes, bitlinear_axes: within 1e-5 relative at "
          f"{len(bl_rows)} shapes, bitlinear_axes_banked: within 1e-5 "
          f"relative at {len(bk_rows)} shapes]")
    return ua_rows, bl_rows, bk_rows


def summary(name, source, replaces, rows, unit):
    """One JSON kernel entry: times summed over ``rows`` (one unit of the
    serving path), the largest error, per-shape rows kept beside.  The
    unit is bound by whichever of bytes and operations dominates its
    calls' bounds."""
    bound = sum(r["bound_ms"] for r in rows)
    by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    by = "bytes" if by_bytes >= bound - by_bytes else "operations"
    lib = [r["library_ms"] for r in rows]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound, "bound_by": by,
            "library_ms": None if None in lib else sum(lib),
            "unit": unit, "shapes": rows}


# ---------------------------------------------------------------------------
# serving phases
# ---------------------------------------------------------------------------

def reference_phase(dev) -> None:
    """Reduced qwen3-8b, fp32 compute: kernels on the card vs the plain
    versions on the CPU, same base, variants and requests."""
    import dataclasses

    from repro_torch.core import calibration as C
    from repro_torch.launch import serve as SV
    from repro_torch.models import build_model
    from repro_torch.models.param import split
    from repro_torch.serving import Deployment

    cfg = dataclasses.replace(SV.make_config(ARCH, reduced=True),
                              num_layers=2, compute_dtype="float32")
    model = build_model(cfg)
    base, _ = split(model.init(0, device="cpu"))
    dms = [C.compress(base, SV.fine_tune(base, 100 + i)) for i in range(2)]
    runs = [("group", "dense", 4), ("group", "fused", 4),
            ("continuous", "fused", [2, 5, 3, 4])]
    for scheduler, mode, budgets in runs:
        tokens = {}
        for where in ("cpu", dev):
            zero_counters()
            dep = Deployment(model, base, mode=mode, scheduler=scheduler,
                             batch_size=4, prompt_len=SV.PROMPT_LEN,
                             max_len=SV.MAX_LEN, bank_size=4, device=where)
            for i, dm in enumerate(dms):
                dep.publish(f"v{i}", dm)
            rids = SV.submit_requests(dep, cfg, 6, budgets)
            dep.drain()
            tokens[str(where)] = [dep.result(r).out_tokens for r in rids]
        launched = {k: v for k, v in counters().items() if v}
        assert tokens["cpu"] == tokens[str(dev)], (scheduler, mode, tokens)
        assert launched, (scheduler, mode, "no kernel launched on the card")
        print(f"reference {scheduler} {mode}: card tokens == cpu plain "
              f"tokens ({sum(map(len, tokens['cpu']))} tokens, card "
              f"launches {launched})")


def profile_decode(model, params, overlay, dev, label, step_ms,
                   vidx=None) -> None:
    """One decode step of batch 4 under ``torch.profiler``: summed device
    time, the kernels that take the most, and the device's idle share of
    the serve run's mean decode step (``step_ms``, unprofiled)."""
    from repro_torch.launch import serve as SV

    batch = {"tokens": torch.ones((LANES, SV.PROMPT_LEN), dtype=torch.int64,
                                  device=dev)}
    _, cache = model.prefill(params, batch, SV.MAX_LEN, overlay=overlay,
                             variant_idx=vidx)
    tok = torch.ones(LANES, dtype=torch.int32, device=dev)
    model.decode_step(params, tok, cache, overlay=overlay,
                      variant_idx=vidx)   # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        model.decode_step(params, tok, cache, overlay=overlay,
                          variant_idx=vidx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side events only: an operator's own row repeats the time of
    # the kernels it launched
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if not events:
        print(f"profile {label} decode step: wall_ms={wall_ms:.3f} "
              "device time not measured (the profiler saw no device work)")
        return
    print(f"profile {label} decode step: device_busy_ms={busy_ms:.3f} "
          f"profiled_wall_ms={wall_ms:.3f} serve_step_ms={step_ms:.3f} "
          f"idle_share={max(0.0, 1 - busy_ms / step_ms):.3f}")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms  calls={e.count:4d}  "
              f"{e.key[:70]}")


def drive(dep, cfg, label, n_requests, budgets, setup_s) -> tuple:
    """Serve ``n_requests`` round-robin over the deployment's variants with
    the launch counters zeroed right before; every request must finish
    with exactly its budget.  Returns (tokens per request, launches)."""
    from repro_torch.launch import serve as SV

    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    rids = SV.submit_requests(dep, cfg, n_requests, budgets)
    dep.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    reqs = [dep.result(r) for r in rids]
    want = [budgets[i % len(budgets)] for i in range(n_requests)]
    assert all(r.status == "done" and len(r.out_tokens) == w
               for r, w in zip(reqs, want)), \
        [(r.status, len(r.out_tokens), w) for r, w in zip(reqs, want)]
    assert all(0 <= t < cfg.padded_vocab for r in reqs
               for t in r.out_tokens)
    m = dep.metrics
    print(f"serve {label}: setup_s={setup_s:.3f} wall_s={wall:.3f} "
          f"tokens={m['tokens_generated']} "
          f"tokens_per_s={m['tokens_generated'] / wall:.2f} "
          f"prefill_s={m['prefill_seconds']:.4f} "
          f"decode_s={m['decode_seconds']:.4f} "
          f"decode_steps={m['decode_steps']} prefills={m['prefills']} "
          f"peak_mem_GB={peak / 1e9:.2f} launches={launches} "
          f"registry={dep.stats}")
    return [r.out_tokens for r in reqs], launches


def serve_phase(dev) -> dict:
    from repro_torch.kernels import ops as K
    from repro_torch.launch import serve as SV

    cfg = SV.make_config(ARCH, num_layers=SERVE_LAYERS)
    launches, tokens = {}, {}
    step_ms = {}

    def mean_step_ms(dep):
        m = dep.metrics
        return 1e3 * m["decode_seconds"] / m["decode_steps"]

    # -- group scheduler, dense residency ---------------------------------
    t0 = time.perf_counter()
    dep = SV.build_deployment(cfg, mode="dense", scheduler="group",
                              n_variants=2, batch=LANES, device=dev)
    torch.cuda.synchronize()
    tokens["dense"], launches["dense"] = drive(
        dep, cfg, "dense", 8, [8], time.perf_counter() - t0)
    assert launches["dense"]["unpack_apply"] > 0, launches
    params, overlay = dep.registry.resolve("v0")
    profile_decode(dep.model, params, overlay, dev, "dense",
                   mean_step_ms(dep))
    del dep, params, overlay
    gc.collect()
    torch.cuda.empty_cache()

    # -- group scheduler, fused residency ---------------------------------
    t0 = time.perf_counter()
    model, base, dms = SV.build_variants(cfg, 2, dev)
    dep = SV.deploy(model, base, dms, mode="fused", scheduler="group",
                    batch=LANES, device=dev)
    torch.cuda.synchronize()
    tokens["fused"], launches["fused"] = drive(
        dep, cfg, "fused", 8, [8], time.perf_counter() - t0)
    assert launches["fused"]["bitlinear_axes"] > 0, launches
    params, overlay = dep.registry.resolve("v0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (LANES, PROMPT),
                                     generator=gen, device=dev)}
    got, _ = model.prefill(params, batch, SV.MAX_LEN, overlay=overlay)
    with K.plain_versions():
        want, _ = model.prefill(params, batch, SV.MAX_LEN, overlay=overlay)
    assert bool(torch.isfinite(got).all()) and got.shape == (
        LANES, cfg.padded_vocab), got.shape
    diff = (got.float() - want.float()).abs().max().item()
    print(f"fused prefill kernels vs plain versions: max |logit diff| = "
          f"{diff:.4g} (max |logit| = {want.float().abs().max().item():.4g})")
    profile_decode(model, params, overlay, dev, "fused", mean_step_ms(dep))
    # the continuous run's requests, served grouped: the agreement yardstick
    rids = SV.submit_requests(dep, cfg, 12, CONT_BUDGETS)
    dep.drain()
    grouped = [dep.result(r).out_tokens for r in rids]
    del dep, params, overlay, got, want
    gc.collect()
    torch.cuda.empty_cache()
    same = sum(a == b for ra, rb in zip(tokens["dense"], tokens["fused"])
               for a, b in zip(ra, rb))
    total = sum(len(r) for r in tokens["dense"])
    print(f"dense vs fused greedy agreement: {same}/{total} tokens "
          "(fused keeps fp16 vectors and extras by design)")

    # -- continuous scheduler: mixed batches through the overlay bank -----
    t0 = time.perf_counter()
    dep = SV.deploy(model, base, dms, mode="fused", scheduler="continuous",
                    batch=LANES, bank_size=4, device=dev)
    torch.cuda.synchronize()
    tokens["continuous"], launches["continuous"] = drive(
        dep, cfg, "continuous", 12, CONT_BUDGETS, time.perf_counter() - t0)
    m = dep.metrics
    per_pass = 7 * SERVE_LAYERS
    calls = m["prefills"] + m["decode_steps"]
    assert launches["continuous"]["bitlinear_axes_banked"] == \
        per_pass * calls, (launches["continuous"], calls)
    assert m["admitted"] == m["retired"] == 12, m
    bank = dep.registry.bank
    print(f"continuous: banked launches {per_pass} x ({m['prefills']} "
          f"prefills + {m['decode_steps']} decode steps) = "
          f"{launches['continuous']['bitlinear_axes_banked']}; bank "
          f"{bank.size} slots, {bank.nbytes() / 1e9:.3f} GB "
          f"(resident {bank.resident()}); engine {dep.status()['metrics']}")
    same = sum(a == b for ra, rb in zip(tokens["continuous"], grouped)
               for a, b in zip(ra, rb))
    total = sum(len(r) for r in grouped)
    print(f"continuous vs group fused greedy agreement: {same}/{total} "
          "tokens (printed, not asserted: bf16 activations can flip a "
          "rounding)")
    slots = [dep.registry.bank_resolve(v) for v in ("v0", "v1")]
    vidx = torch.tensor([0, slots[0], slots[1], slots[0]], dtype=torch.int32,
                        device=dev)
    profile_decode(model, dep.registry.base_params, bank.tree, dev,
                   f"continuous mixed (vidx {vidx.tolist()})",
                   mean_step_ms(dep), vidx=vidx)
    del dep, bank, model, base, dms
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    # the port comes from this checkout: without it, fail before any output
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card} | torch.cuda: {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s\n{build.ptxas_report()}")

    cfg = get_config(ARCH)
    timer = Timer(dev)
    ua_rows, bl_rows, bk_rows = kernel_phase(cfg, dev, timer)
    del timer
    torch.cuda.empty_cache()
    reference_phase(dev)
    launches = serve_phase(dev)

    ua = summary("unpack_apply", "src/repro_torch/csrc/unpack_apply.cu",
                 "src/repro/kernels/unpack_apply.py:54", ua_rows,
                 f"one dense variant load: 7 stacks x (row, col), "
                 f"L={SERVE_LAYERS}")
    ua["launches"] = launches["dense"]["unpack_apply"]
    bl = summary("bitlinear_axes", "src/repro_torch/csrc/bitlinear_axes.cu",
                 "src/repro/kernels/bitlinear.py:222",
                 [r for r in bl_rows if r["m"] == LANES],
                 "one layer's decode step: 7 projections at M=4")
    bl["shapes"] = bl_rows
    bl["launches"] = launches["fused"]["bitlinear_axes"]
    bk = summary("bitlinear_axes_banked",
                 "src/repro_torch/csrc/bitlinear_axes_banked.cu",
                 "src/repro/kernels/bitlinear.py:178",
                 [r for r in bk_rows if r["case"] == "M=4"],
                 "one layer's mixed decode step: 7 projections at M=4, "
                 f"vidx {BANK_VIDX} over a bank of 4 slots")
    bk["shapes"] = bk_rows
    bk["launches"] = launches["continuous"]["bitlinear_axes_banked"]
    print(json.dumps({"kernels": [ua, bl, bk]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
