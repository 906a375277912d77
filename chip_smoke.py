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
4. reference: a reduced qwen3-8b served on the card through the kernels
   and on the CPU through the plain versions, same weights and requests:
   greedy tokens must be identical;
5. serve: qwen3-8b at full width cut to 4 layers, 2 synthetic variants, 8
   requests x 8 new tokens, batch 4, through ``Deployment`` in dense and in
   fused mode; the launch counters are zeroed right before each run and
   must show the mode's kernel; one fused prefill is repeated through the
   plain versions and the logit difference printed.

Then it prints the kernel summary as one JSON line, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.

Tolerances: ``unpack_apply`` performs the plain version's arithmetic
exactly (one fp32 add per element), so it must be bit-identical.
``bitlinear_axes`` forms the same fp32 Ŵ and sums products in another
order: |kernel - plain| <= 1e-5 · Σ_k |x||Ŵ| + 1e-6 per output.
TF32 is off for every fp32 product run here (the plain versions and the
library yardstick included).
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


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(cfg, dev, timer) -> list:
    from repro_torch.core import delta as D
    from repro_torch.kernels import bitlinear as BL
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import unpack_apply as UA

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    L = SERVE_LAYERS
    ua_rows, bl_rows = [], []
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
        for m in (4, 64):
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
        del wb, packed, v_row, v_col, w0, p0, w_hat, w_abs
        torch.cuda.empty_cache()
    for r in ua_rows + bl_rows:
        print(f"  {r['shape']:34s} err={r['max_abs_err']:.3g} "
              f"kernel_ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']}")
    print("kernels: [unpack_apply: bit-identical to plain at "
          f"{len(ua_rows)} shapes, bitlinear_axes: within 1e-5 relative at "
          f"{len(bl_rows)} shapes]")
    return ua_rows, bl_rows


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
    for mode in ("dense", "fused"):
        tokens = {}
        for where in ("cpu", dev):
            dep = Deployment(model, base, mode=mode, batch_size=4,
                             prompt_len=SV.PROMPT_LEN, max_len=SV.MAX_LEN,
                             device=where)
            for i, dm in enumerate(dms):
                dep.publish(f"v{i}", dm)
            rids = SV.submit_requests(dep, cfg, 6, 4)
            dep.drain()
            tokens[str(where)] = [dep.result(r).out_tokens for r in rids]
        assert tokens["cpu"] == tokens[str(dev)], (mode, tokens)
        print(f"reference {mode}: card tokens == cpu plain tokens "
              f"({sum(map(len, tokens['cpu']))} tokens)")


def profile_decode(dep, dev, mode, step_ms) -> None:
    """One decode step of variant v0 under ``torch.profiler``: summed
    device time, the kernels that take the most, and the device's idle
    share of the serve run's mean decode step (``step_ms``, unprofiled)."""
    from repro_torch.launch import serve as SV

    params, overlay = dep.registry.resolve("v0")
    batch = {"tokens": torch.ones((4, SV.PROMPT_LEN), dtype=torch.int64,
                                  device=dev)}
    _, cache = dep.model.prefill(params, batch, SV.MAX_LEN, overlay=overlay)
    tok = torch.ones(4, dtype=torch.int32, device=dev)
    dep.model.decode_step(params, tok, cache, overlay=overlay)   # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        dep.model.decode_step(params, tok, cache, overlay=overlay)
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
        print(f"profile {mode} decode step: wall_ms={wall_ms:.3f} "
              "device time not measured (the profiler saw no device work)")
        return
    print(f"profile {mode} decode step: device_busy_ms={busy_ms:.3f} "
          f"profiled_wall_ms={wall_ms:.3f} serve_step_ms={step_ms:.3f} "
          f"idle_share={max(0.0, 1 - busy_ms / step_ms):.3f}")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms  calls={e.count:4d}  "
              f"{e.key[:70]}")


def serve_phase(dev) -> dict:
    from repro_torch.kernels import bitlinear as BL
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import unpack_apply as UA
    from repro_torch.launch import serve as SV

    cfg = SV.make_config(ARCH, num_layers=SERVE_LAYERS)
    results, launches = {}, {}
    for mode in ("dense", "fused"):
        t0 = time.perf_counter()
        dep = SV.build_deployment(cfg, mode=mode, n_variants=2, batch=4,
                                  device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        UA.launches = 0
        BL.launches = 0
        t0 = time.perf_counter()
        rids = SV.submit_requests(dep, cfg, 8, 8)
        dep.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[mode] = {"unpack_apply": UA.launches,
                          "bitlinear_axes": BL.launches}
        peak = torch.cuda.max_memory_allocated()
        reqs = [dep.result(r) for r in rids]
        assert all(r.status == "done" and len(r.out_tokens) == 8
                   for r in reqs), [(r.status, r.out_tokens) for r in reqs]
        assert all(0 <= t < cfg.padded_vocab for r in reqs
                   for t in r.out_tokens)
        results[mode] = [r.out_tokens for r in reqs]
        m = dep.metrics
        print(f"serve {mode}: setup_s={setup_s:.3f} wall_s={wall:.3f} "
              f"tokens={m['tokens_generated']} "
              f"tokens_per_s={m['tokens_generated'] / wall:.2f} "
              f"prefill_s={m['prefill_seconds']:.4f} "
              f"decode_s={m['decode_seconds']:.4f} "
              f"decode_steps={m['decode_steps']} prefills={m['prefills']} "
              f"peak_mem_GB={peak / 1e9:.2f} launches={launches[mode]} "
              f"registry={dep.stats}")
        if mode == "dense":
            assert launches[mode]["unpack_apply"] > 0, launches
        else:
            assert launches[mode]["bitlinear_axes"] > 0, launches
            params, overlay = dep.registry.resolve("v0")
            gen = torch.Generator(device=dev)
            gen.manual_seed(1)
            batch = {"tokens": torch.randint(1, cfg.vocab_size, (4, 16),
                                             generator=gen, device=dev)}
            got, _ = dep.model.prefill(params, batch, SV.MAX_LEN,
                                       overlay=overlay)
            with K.plain_versions():
                want, _ = dep.model.prefill(params, batch, SV.MAX_LEN,
                                            overlay=overlay)
            assert bool(torch.isfinite(got).all()) and got.shape == (
                4, cfg.padded_vocab), got.shape
            diff = (got.float() - want.float()).abs().max().item()
            print(f"fused prefill kernels vs plain versions: max |logit "
                  f"diff| = {diff:.4g} (max |logit| = "
                  f"{want.float().abs().max().item():.4g})")
        profile_decode(dep, dev, mode,
                       1e3 * m["decode_seconds"] / m["decode_steps"])
        del dep
        gc.collect()
        torch.cuda.empty_cache()
    same = sum(a == b for ra, rb in zip(results["dense"], results["fused"])
               for a, b in zip(ra, rb))
    total = sum(len(r) for r in results["dense"])
    print(f"dense vs fused greedy agreement: {same}/{total} tokens "
          "(fused keeps fp16 vectors and extras by design)")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card} | torch.cuda: {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s\n{build.ptxas_report()}")

    cfg = get_config(ARCH)
    timer = Timer(dev)
    ua_rows, bl_rows = kernel_phase(cfg, dev, timer)
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
                 [r for r in bl_rows if r["m"] == 4],
                 "one layer's decode step: 7 projections at M=4")
    bl["shapes"] = bl_rows
    bl["launches"] = launches["fused"]["bitlinear_axes"]
    print(json.dumps({"kernels": [ua, bl]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
