#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: ``nvidia-smi`` name and power limit; fails without a CUDA device;
2. build: compiles the CUDA kernels from ``src/repro_torch/csrc`` and prints
   ``nvcc -Xptxas -v`` (registers, shared memory, spills per kernel), then
   that report's lines for the redesigned kernels under demangled names;
3. kernels: each kernel body's wrapper at the serving path's shapes of
   qwen3-8b (full width), over an fp32 base and over an int8 base
   (``core/quantize``), held against its plain PyTorch version on the same
   inputs and timed with CUDA events (L2 flushed before every launch)
   beside its bound, the plain version and, where one exists, a single
   PyTorch call; ``bitlinear_axes`` also beside ``torch.sum`` over its fp32
   W_b (the read rate the timer sees); the banked kernel at M=4 over two
   and three distinct slots, M=8, 16, 17 and 64 and all-base, each beside
   the single-variant kernel on the same x (M=8, 12 and 20 are the
   speculative verify's layouts for drafts of 1, 2 and 4: each lane's k+1
   rows together, printed apart beside the single-variant kernel and the
   byte bound); ``bitlinear_p`` in row, col and
   scalar mode; the streaming kernel's 8- and 16-row tiers (M=8, 16 at wo
   and w_gate) beside its 4-row tier once per four rows and the tiled
   kernel;
4. reference: a reduced qwen3-8b served on the card through the kernels
   and on the CPU through the plain versions, same weights and requests,
   with the group scheduler (dense and fused) and the continuous scheduler
   (heterogeneous budgets) and the speculative scheduler (drafts of up to
   4; its tokens must also equal the continuous run's), over an fp32 and
   an int8 base: greedy tokens
   must be identical; the int8 base quantized on the card must equal the
   one quantized on the CPU byte for byte;
5. DeltaLinear: ``core/bitdelta.DeltaLinear`` in apply mode "onfly" (the
   caller of ``bitlinear_p``) over the seven projections of one full-width
   qwen3-8b layer at M=4 and M=64, over an fp32 and an int8 base, counters
   zeroed right before each run and held against the dense apply mode;
6. serve: qwen3-8b at full width cut to 4 layers, 2 synthetic variants,
   batch 4, through ``Deployment``: 8 requests x 8 new tokens with the
   group scheduler in dense and in fused mode, then 12 requests with
   budgets 4, 6, .. 12 round-robin over base, v0 and v1 with the
   continuous scheduler (bank of 4 slots); then the same three runs over
   an int8 base (``base_dtype="int8"``, same weights, variants, requests
   and bank).  The launch counters are zeroed right before each run and
   must show the run's kernel; the continuous runs must launch the banked
   kernel 28 times (7 projections x 4 layers) per prefill and per decode
   step; the int8 runs must hold the targets at under 0.3 of their fp32
   bytes.  One fused prefill is repeated through the plain versions and the
   logit difference printed; one decode step of each run is profiled;
   int8-vs-fp greedy agreement is printed, not asserted (random weights at
   full width give near-tied logits);
7. flash (run right after the kernel phase): ``ops.flash_attention_fwd``
   (the ``flash_attn.cu`` kernels: fp32 on the CUDA cores, bf16 on the
   tensor cores) over qwen3-8b's heads (32 q, 8 kv,
   hd 128) at B=1 for S=T in {16, 512, 4096}, causal and not, fp32 and
   bf16, plus hd 256, an odd S (77), absolute offsets and a block whose
   first rows see no key; counters zeroed right before; each output held
   against the plain version; kernel, plain version and
   ``scaled_dot_product_attention`` timed;
8. lifecycle (the paper's pipeline, full width, 4 layers): the kernel on a
   real prefill's q/k/v (layer 0 after qk-norm and RoPE) against
   ``attention.flash_attention``; ``calibrate_transformer`` (stages 0-3) of
   a synthetic fine-tune on 2 SyntheticLM batches of 4 x 64 tokens; publish
   into a store under ``build/`` (removed at exit); 8 continuous requests
   over base and the variant; an attention-only refresh shipped as a patch;
   rollback; a second Deployment over the same directory.  Tokens served
   from the store must equal those of the same DeltaModel served without a
   store, and rollback and restart must serve version 1's tokens; prints
   each step's seconds, artifact and patch bytes against the fp16
   checkpoint, held-out logit MSE at stage 0 and after calibration, and
   peak device memory.  A reduced copy (calibrated on the CPU) runs the
   same lifecycle through a store on the card and on the CPU, right after
   the reference phase: tokens must be identical.

9. other archs, kernels (after the flash phase): ``bitlinear_axes`` and
   the banked GEMM at M=4 ([0,1,2,1]) and at the prefill's rows (M=64;
   lanes on [0,1,2,1]) at every distinct projection shape of
   deepseek-7b, starcoder2-3b, gemma3-12b and deepseek-moe-16b
   (attention, its dense first layer and its shared experts), fp32 and
   int8 base, each against its plain version;
10. stacked: ``bitlinear_axes_stacked_p`` over deepseek-moe-16b's 64
   experts (1408 x 2048 and 2048 x 1408), every expert live, at 1, 4, 7
   and 120 rows an expert (1 and 7 the serving path's decode and prefill
   capacity), fp32 and int8 base, one launch a call, against its plain
   version and timed beside ``torch.bmm`` over a built Ŵ stack;
11. other archs, reference (after the lifecycle reference): each of
   deepseek-7b, starcoder2-3b, gemma3-12b, deepseek-moe-16b and
   moonshot-v1-16b-a3b reduced, group fused and continuous over an fp32
   and an int8 base, card against CPU plain tokens (identical); gemma3's
   padded prompt of 20 and its budgets run past its reduced window of 16;
12. other archs, full width (after the lifecycle phase): deepseek-7b and
   starcoder2-3b, 2 layers, 4 requests x 8 tokens, group fused;
   deepseek-moe-16b, 2 layers (64 experts, top-6, capacity 1.25), group
   fused and continuous over an fp32 and an int8 base (the stacked kernel
   counted per call); gemma3-12b, 6 layers (one 5:1 period), continuous
   over an fp32 and an int8 base with prompts of 1100-1300 tokens, so
   every local layer's 1024-slot ring wraps.  After each MoE and gemma3
   run one fused prefill (same batch, on the card) holds every delta GEMM
   launch to the GEMM bound against its plain version on the same
   operands (whatever the routing) and prints its max |logit diff|
   against the plain versions; an MoE prefill run twice must give the
   same logits bit for bit; then one profiled decode step (device-busy
   time, idle share, the stacked kernels' share) and the run's peak device
   memory.  Then the routed rows: the stacked launches of the first
   expert layer in one prefill and one decode step (group fused) or in
   the four slot passes of one continuous decode step over the mixed
   batch [0, v0, v1, v0] are captured and replayed on their own operands:
   each held to the GEMM bound, the outputs of its dead experts (no routed
   row: all-zero x) exactly 0 and those of its live ones bit-equal to a
   launch with the dead rows filled with random values, each row printing
   its live experts and timed beside the plain version and ``torch.bmm``
   over the full built Ŵ stack, its bound counting the live experts'
   weights (the full stack's beside it).
13. encoder-decoder and VLM: phase 9 covers whisper-base's and
   internvl2-76b's shapes too, at M=4 and at their prefills' rows (4 x
   1500 frames = 6000; 4 x (256 image + 32 text) = 1152, internvl2's
   w_down splitting K = 28672 56 ways in the banked GEMM), and phase 11
   runs both reduced (card against CPU tokens, identical);
14. whisper-base at full width, 2 encoder and 2 decoder layers of 6
   (``WHISPER_LAYERS``; after gemma3-12b): one
   base prefill timed with the port's 500-key attention chunks and the
   JAX module's 4-key ones; group dense, group fused and continuous over
   a 4-slot bank, over an fp32 and an int8 base, 1500 stub frames a
   lane; after each fused and continuous run every delta GEMM launch of
   one prefill (6000 rows at the encoder and the cross-attention's wk/wv)
   held to the GEMM bound, a repeat bit-identical, logits beside the
   plain versions, one decode step profiled;
15. internvl2-76b at full width, 2 layers: 256 zero image
   embeddings + 32-token prompts, fp32 base, group fused then continuous
   over a 3-slot bank, the same checks at 1152 rows, peak device memory
   printed beside the reckoning in ``vlm_phase``.
16. the recurrent families: phase 9 covers xlstm-350m's and zamba2-7b's
   shapes too (N = 8, 112 and 128; K = 1344), phase 11 runs both reduced
   (group dense too), and the script ends with xlstm-350m at full width,
   8 layers (7 mLSTM, 1 sLSTM), and zamba2-7b at full width, 7 layers
   (one application of the shared block): group dense, group fused and
   continuous over a 4-slot bank, over an fp32 and an int8 base, the
   banked GEMM counted (53 and 42 launches a prefill and a step), after
   each fused and continuous run every delta GEMM launch of one prefill
   held to the GEMM bound, a repeat bit-identical, logits beside the plain
   versions, one decode step profiled, peak memory printed.
17. speculative decoding (``speculative_phase``, right after the serve
   phase): qwen3-8b at full width, 4 layers, the serve phase's 12
   continuous requests over a 4-slot bank, first with the continuous
   scheduler, then with the speculative one (drafts of up to 4 on the
   base weights, adaptive), over an fp32 and an int8 base, then over an
   fp32 base with a near-base pair of variants (fine-tunes at 0.0005);
   xlstm-350m (phase 16's 8 layers) over its fp32 base the same way
   (its verify steps the recurrence k+1 times and rewinds by snapshot).
   Each speculative run must finish every request with its budget, launch
   the banked GEMM exactly once a projection a prefill and a verify round
   (28 a prefill and a round for qwen3-8b; 53 x (k+1) a round for
   xlstm) and no other delta kernel (the drafts launch none); it prints
   tokens/s beside the continuous run's, the rounds, the acceptance, the
   ladder's walk, the token agreement with the continuous run (printed,
   not asserted: the verify sums in another order than a decode step, so
   a bf16 near-tie may flip) and one profiled round (the draft and the
   verify each under the profiler: device-busy time, idle share of the
   unprofiled round), and peak memory.  Phases 4 and 11 run the
   speculative scheduler reduced for one arch of each family (qwen3-8b,
   deepseek-moe-16b, internvl2-76b, whisper-base, xlstm-350m, zamba2-7b),
   and a speculative ``Deployment`` over reduced gemma3-12b must refuse its
   ring caches.

18. compile-once serving (``core/compile_cache``, ``serving/engine``):
   every continuous and speculative run above replays CUDA graphs.
   ``drive`` warms each such deployment up first (every decode step and
   round captured, with and without the bank; prefills run once eagerly)
   and then asserts that the run captures nothing more and replays one
   graph a step or round, so the launch counts stay those of eager
   serving; the reference phases hold graphed card tokens against the
   CPU's eager ones.  The qwen3-8b runs of phase 17 (continuous and
   speculative, fp32, int8, near-base), xlstm-350m's, and the fp32
   continuous runs of whisper-base, zamba2-7b, deepseek-moe-16b and
   gemma3-12b are served again with ``graphs=False`` on the same
   requests (``eager_twin``): tokens must be identical; it prints both
   runs' mean step, tokens/s, allocated and reserved peak memory and
   idle share, the warmup and capture seconds and the step counters, a
   graphed k=4 round's replay time beside its eager time, speculative
   against continuous tokens/s under graphs and eagerly, and the
   recurrent state's copy-back time.  The script ends with a warm
   restart (``restart_phase``): the serving launcher with ``--warmup
   --compile-cache`` on this script's build directory, as a fresh
   process, must build no kernel, capture nothing after its warmup and
   emit the tokens of the same run in this process; its
   restart-to-first-token is printed beside the cold build.
19. async admission (``serving/admission``; ``admission_phase``, right
   after the lifecycle phase): qwen3-8b at full width, 4 layers, a store
   under ``build/``, the graphed continuous scheduler warmed up, 4 lanes,
   a 4-slot bank.  The same traffic twice, synchronously (the variant
   loads inline on the serving thread) and with ``async_admission=True``:
   a warm variant admitted first, then two base lanes of
   ``ADMIT_BASE_BUDGET`` tokens decode while a variant is published (a
   full artifact) and requested, then updated by an attention-only patch
   and requested again, served in slices (``drain(max_steps=)``) with the
   control-plane calls between them.  Hard checks: identical tokens in
   the twins, every budget exact, at least one step with an admission in
   flight, no capture after warmup, one replay a step, every async bank
   admission committed by the pipeline, 28 banked launches a prefill and
   a step.  Printed: the steady base-lane step, each admission step and
   the longest step against it, the decode calls, publish- and
   update-to-first-token, the staging seconds, the staging pool's
   counters and peak pinned bytes, peak device memory, the card.  Right
   after the lifecycle reference, ``admission_reference_phase`` runs the
   same traffic reduced (fp32 compute) with async admission on the card
   and synchronously on the CPU, continuous and speculative: tokens and
   versions identical.
20. the training side, reduced (``train_reference_phase``, after the
   admission reference): the RMSNorm and flash-attention backward passes
   at qwen3-8b's shapes (fp32 and bf16; causal, not, a window, a KV
   offset with rows that see no key), card against CPU (the output within
   ``FLASH_TOL``, each gradient within ``BWD_TOL`` of its tensor's largest
   entry: 1e-5 fp32, 2^-7 bf16); reduced qwen3-8b and deepseek-moe-16b (fp32
   compute) take 3 train steps on the card and on the CPU from the same
   initial params (losses within 1e-5 rel, params within 1e-3 abs); a
   checkpoint written from the card restores on the CPU bit for bit.
21. the paper's pipeline on a pair the port trains (``train_phase``,
   after the admission phase): qwen3-8b at full width, 2 layers, bf16
   compute, remat on, batch 2 x 512 on SyntheticLM(seed=0): an
   uninterrupted ``make_train_step`` loop; the ``Trainer`` with 1-bit
   gradient compression (loss must fall); the base through the
   ``Trainer``, preempted after step 2 (its checkpoint restored must
   equal the saved state bit for bit) and resumed (losses against the
   uninterrupted loop's: bit-exact, else within 1e-4 rel); a fine-tune
   on SyntheticLM(seed=7); ``calibrate_transformer`` of the trained pair
   per-axis and scalar, each at the lr of ``TRAIN_CAL_LRS`` that does best
   on a tuning batch (axes, summed held-out val MSE and the logit MSE on
   another, held-out batch printed, not gated); the variant published
   into a store under ``build/`` and served through the continuous scheduler over the fp32
   and an int8 base (14 banked launches a prefill and a step, budgets
   exact, no kernel launched while training; int8 greedy agreement
   printed).  Prints the step's median time, tokens/s and its forward +
   backward and AdamW halves, peak device memory, checkpoint bytes, save
   and restore seconds and the disk free before the first save; writes
   one full-width checkpoint (the machine takes 45 GiB of disk writes a
   call: the compressed and the resumed runs' end-of-run saves are
   recorded, not written) and removes it and the store.
22. mesh-sharded serving (``mesh_phase``, after the train phase): ranks
   of a (data, model) mesh over ``torch.distributed``, over an fp32 and
   an int8 base, the speculative scheduler in the reduced groups and at
   full width, ``warmup()`` in one reduced group (see its docstring); then
   pod-local overlay banks on a (pod, data, model) mesh (``pods_phase``,
   right after: reduced (2, 1, 2) deepseek-7b and deepseek-moe-16b against
   the CPU and the global bank, full width (2, 1, 1) qwen3-8b, then
   deepseek-moe-16b, with every per-rank banked and stacked launch of a
   wave checked, and the launcher with ``--pod-banks``; see its
   docstring).
23. the launcher's frequent update on one card (``launcher_phase``, the
   last phase): ``python -m repro_torch.launch.serve`` at full width, 2
   layers, with ``--updates 2 --max-resident 2``: the version lines,
   every request's budget and the TTFT line.

Each phase prints its seconds.  Then it prints the kernel summary as one
JSON line (the entries of a kernel
whose first CUDA design was replaced carry ``design``: the design now run),
the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.

Tolerances: ``unpack_apply`` performs the plain version's arithmetic
exactly (one fp32 add per element; over an int8 base one fp32 product
first), so it must be bit-identical.  The GEMMs (``bitlinear_axes``,
``bitlinear_axes_banked``, ``bitlinear_axes_stacked``, ``bitlinear_p``)
form the same fp32 Ŵ and sum
products in another order: |kernel - plain| <= 1e-5 · Σ_k |x||Ŵ| + 1e-6 per
output (Ŵ of the row's own bank slot).  ``flash_attention`` sums its
products and softmax in another order than its dense plain version: within
2e-4 abs+rel in fp32; in bf16 within 5e-4 + 1e-2·|plain| (both round one
fp32 value to bf16, so they differ by one bf16 step at most), asserted to
stay under a tenth of the median |output| at S=T=4096.  TF32 is off for every fp32 product run here
(the plain versions and the library yardstick included).
"""
from __future__ import annotations

import contextlib
import gc
import io
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
# dense peak rate of one H100 SXM by operand type (NVIDIA's data sheet):
# bf16 x bf16 on the tensor cores; a product with an fp32 operand at the
# fp32 rate outside the tensor cores
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
ARCH = "qwen3-8b"
SERVE_LAYERS = 4
LANES, PROMPT = 4, 16         # serving batch and padded prompt length
BANK_VIDX = [0, 1, 2, 1]      # kernel phase: base, two variants, mixed
TIER_SHAPES = ("wo", "w_gate")  # kernel phase: the M=8, 16 streaming tiers
CONT_BUDGETS = [4, 6, 8, 10, 12]
SPEC_K = 4                    # speculative runs: the longest draft
# the banked GEMM's rows in a verify round of LANES lanes, draft k -> M
VERIFY_M = {k: LANES * (k + 1) for k in (1, 2, 4)}
NEAR_SCALE = 0.0005           # near-base fine-tunes: the shipped-delta regime


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


def bound(nbytes: float, flops: float, dtype=torch.float32) -> dict:
    """A row's ``bound_ms``: the larger of bytes over the memory rate and
    operations over the peak for the operands' type (``peak_tflops``)."""
    peak = PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "peak_tflops": peak / 1e12}


def projections(cfg) -> list:
    d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    return [("wq", q, d), ("wk", kv, d), ("wv", kv, d), ("wo", d, q),
            ("w_gate", ff, d), ("w_up", ff, d), ("w_down", d, ff)]


def counters() -> dict:
    from repro_torch.kernels import bitlinear as BL
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import unpack_apply as UA
    return {"unpack_apply": UA.launches, "bitlinear_axes": BL.launches,
            "bitlinear_axes_banked": BL.banked_launches,
            "bitlinear_axes_stacked": BL.stacked_launches,
            "bitlinear": BL.static_launches,
            "flash_attention": FA.launches}


def zero_counters() -> None:
    from repro_torch.kernels import bitlinear as BL
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import unpack_apply as UA
    UA.launches = 0
    BL.launches = 0
    BL.banked_launches = 0
    BL.stacked_launches = 0
    BL.static_launches = 0
    FA.launches = 0


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _base(base) -> tuple:
    """(payload, scale or None, fp32 dense, resident bytes) of a base
    operand: an fp32 tensor or an int8 ``QuantWeight``."""
    from repro_torch.core import quantize as Q
    if Q.is_quant(base):
        return base.q, base.scale, Q.dequantize(base), base.nbytes()
    return base, None, base, base.numel() * base.element_size()


def _check_gemm(label, got, want, x, w_abs) -> float:
    """|kernel - plain| <= 1e-5 · Σ_k |x||Ŵ| + 1e-6 per output."""
    scale = x.float().abs() @ w_abs.T
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all()), (
        label, err)
    return err


def _build_flops(n, k, q8) -> int:
    """Ŵ-tile work per weight element: the delta add (the dual-axis scale
    sum folds into it) and, over an int8 base, the dequant product."""
    return n * k * (2 + int(q8))


def unpack_rows(name, timer, packed, v_row, v_col, base) -> list:
    """``unpack_apply`` over the L-layer stack: the dense load's row and
    col launches; bit-identical to the plain version."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import unpack_apply as UA

    wq, ws, _, base_bytes = _base(base)
    rows = []
    for mode, v in (("row", v_row), ("col", v_col)):
        got = K.unpack_apply(packed, v, base, mode=mode,
                             out_dtype=torch.float32)
        want = UA.plain(packed, v, wq, mode, dtype=torch.float32,
                        w_scale=ws)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert torch.equal(got, want), (name, mode, ws is not None, err)
        del got, want
        nbytes = packed.numel() + v.numel() * 4 + base_bytes + wq.numel() * 4
        rows.append({
            "shape": f"{name} {mode} {tuple(wq.shape)}", "max_abs_err": err,
            "ms": timer.ms(lambda: K.unpack_apply(
                packed, v, base, mode=mode, out_dtype=torch.float32)),
            "plain_ms": timer.ms(lambda: UA.plain(
                packed, v, wq, mode, dtype=torch.float32, w_scale=ws)),
            **bound(nbytes, wq.numel() * (1 + int(ws is not None))),
            "library_ms": None})
    return rows


def axes_rows(name, n, k, gen, dev, timer, p0, vr0, base,
              ms=(LANES, LANES * PROMPT)) -> list:
    """``bitlinear_axes`` on layer 0's overlay entry, row-selected, at M=4
    (decode) and M=64 (prefill), or at the rows ``ms``."""
    from repro_torch.core import delta as D
    from repro_torch.kernels import bitlinear as BL

    wq, ws, wf, base_bytes = _base(base)
    vr = vr0.to(torch.float16)
    vc = torch.zeros(k, dtype=torch.float16, device=dev)
    signs = D.unpack_signs(p0, k)
    w_hat = (vr.float()[:, None] + vc.float()[None, :]) * signs + wf
    w_abs = w_hat.abs()
    del signs
    rows = []
    for m in ms:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        got = BL.bitlinear_axes_p(x, p0, vr, vc, wq, ws)
        want = BL.plain(x.float(), p0, vr, vc, wq, w_scale=ws)
        err = _check_gemm((name, m), got, want, x, w_abs)
        x32 = x.float()
        nbytes = (x.numel() * 2 + p0.numel() + (n + k) * 2 + base_bytes
                  + m * n * 4)
        rows.append({
            "shape": f"{name} M={m} N={n} K={k}", "m": m,
            "max_abs_err": err,
            "splits": BL.gemm_plan(m, n, k, 2, wq.element_size())[0],
            "ms": timer.ms(lambda: BL.bitlinear_axes_p(x, p0, vr, vc, wq, ws),
                           reps=20, warmup=3),
            "plain_ms": timer.ms(lambda: BL.plain(x, p0, vr, vc, wq,
                                                  w_scale=ws),
                                 reps=20, warmup=3),
            **bound(nbytes, 2 * m * n * k + _build_flops(
                n, k, ws is not None)),
            "library_ms": timer.ms(lambda: torch.matmul(x32, w_hat.T),
                                   reps=20, warmup=3)})
        if ws is None:
            # the read rate this timer sees: one PyTorch reduction reading
            # the fp32 W_b once (a reference for the byte bound)
            rows[-1]["read_ms"] = timer.ms(lambda: wq.sum(), reps=20,
                                           warmup=3)
    return rows


def tier_rows(name, n, k, gen, dev, timer, p0, vr0, base) -> list:
    """``bitlinear_axes`` at M=8 and M=16, where the streaming kernel runs
    its 8- and 16-row tiers, against the 4-row tier launched once per group
    of four rows (W_b read once per group) and the tiled kernel, timed at
    M=17 (its one 64-row tile costs the same for M = 1..64); each result
    held to the GEMM bound."""
    from repro_torch.core import delta as D
    from repro_torch.kernels import bitlinear as BL

    wq, ws, wf, _ = _base(base)
    vr = vr0.to(torch.float16)
    vc = torch.zeros(k, dtype=torch.float16, device=dev)
    w_abs = ((vr.float()[:, None] + vc.float()[None, :])
             * D.unpack_signs(p0, k) + wf).abs()
    x = torch.randn((17, k), generator=gen, device=dev).to(torch.bfloat16)
    _check_gemm((name, 17), BL.bitlinear_axes_p(x, p0, vr, vc, wq, ws),
                BL.plain(x.float(), p0, vr, vc, wq, w_scale=ws), x, w_abs)
    tiles_ms = timer.ms(lambda: BL.bitlinear_axes_p(x, p0, vr, vc, wq, ws),
                        reps=20, warmup=3)
    rows = []
    for m in (8, 16):
        xm = x[:m]
        groups = [x[g:g + 4] for g in range(0, m, 4)]
        want = BL.plain(xm.float(), p0, vr, vc, wq, w_scale=ws)
        for got in (BL.bitlinear_axes_p(xm, p0, vr, vc, wq, ws),
                    torch.cat([BL.bitlinear_axes_p(g, p0, vr, vc, wq, ws)
                               for g in groups])):
            _check_gemm((name, m), got, want, xm, w_abs)
        rows.append({
            "shape": f"{name} M={m} N={n} K={k}"
                     + (" int8" if ws is not None else " fp32"),
            "tier_ms": timer.ms(lambda: BL.bitlinear_axes_p(
                xm, p0, vr, vc, wq, ws), reps=20, warmup=3),
            "groups_of_4_ms": timer.ms(lambda: [BL.bitlinear_axes_p(
                g, p0, vr, vc, wq, ws) for g in groups], reps=20, warmup=3),
            "tiles_m17_ms": tiles_ms})
    return rows


def banked_rows(name, n, k, gen, dev, timer, packed, v_row, v_col,
                base, only=None, prefill=0) -> list:
    """``bitlinear_axes_banked`` at one projection shape, over a bank of 4
    slots built from the stack's first three layers (slot 0 zero = base,
    slot 1 row-scaled, slot 2 col-scaled, slot 3 row-scaled) and layer 0's
    base: M=4 lanes with vidx [0,1,2,1] and with [1,2,3,1] (three distinct
    slots), each lane's row repeated (its tokens, lane-major as the engine
    lays them out) to M=8 and M=16 (two and four groups of four rows of the
    streaming kernel), M=17 (4 tokens a lane and one more row: the tiled
    kernel, microtiles that span slots) and M=64 (16 tokens a lane), and an all-base M=4 batch held against the plain fp32
    x @ W_bᵀ; each timed beside the single-variant kernel on the same x.
    M=8, 12 and 20 are also the speculative verify's layouts (``VERIFY_M``:
    k+1 = 2, 3, 5 tokens a lane for the draft lengths 1, 2, 4; M=20 the
    tiled kernel).
    ``only`` keeps the cases of those labels; ``prefill`` adds a
    continuous prefill of that many rows a lane, lanes on [0,1,2,1]
    (label "M=<4 x prefill> lanes")."""
    from repro_torch.core import delta as D
    from repro_torch.kernels import bitlinear as BL

    wq, ws, w0, base_bytes = _base(base)
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
    def lanes(tokens):
        return [s for s in BANK_VIDX for _ in range(tokens)]

    cases = [("M=4", BANK_VIDX), ("M=4 three slots", [1, 2, 3, 1]),
             ("M=8", lanes(2)), ("M=12", lanes(3)), ("M=16", lanes(4)),
             ("M=17", lanes(4) + BANK_VIDX[:1]), ("M=20", lanes(5)),
             ("M=64", [s for s in BANK_VIDX for _ in range(PROMPT)]),
             ("M=4 all-base", [0] * LANES)]
    if only is not None:
        cases = [c for c in cases if c[0] in only]
    if prefill:
        cases.append((f"M={LANES * prefill} lanes", lanes(prefill)))
    for label, vlist in cases:
        m = len(vlist)
        vidx = torch.tensor(vlist, dtype=torch.int32, device=dev)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        got = BL.bitlinear_axes_banked_p(x, vidx, bp, bvr, bvc, wq, ws)
        if label.endswith("all-base"):
            want = x.float() @ w0.T
        else:
            want = BL.plain_banked(x.float(), vidx, bp, bvr, bvc, wq,
                                   w_scale=ws)
        scale = torch.zeros_like(want)
        for s in set(vlist):
            scale = torch.where(vidx[:, None] == s,
                                x.float().abs() @ w_abs[s].T, scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
        assert ok, (name, label, ws is not None, err)
        named = sorted(set(vlist) - {0})
        nbytes = (x.numel() * 2 + m * 4 + base_bytes + m * n * 4
                  + len(named) * (n * k // 8 + (n + k) * 2))
        row_bound = bound(nbytes, 2 * m * n * k
                          + n * k * (2 * len(named) + int(ws is not None)))
        vr1, vc1, p1 = bvr[1], bvc[1], bp[1]
        rows.append({
            "shape": f"{name} {label} N={n} K={k}", "m": m, "case": label,
            "max_abs_err": err,
            "splits": BL.gemm_plan(m, n, k, 2, wq.element_size(),
                                   banked=True)[0],
            "ms": timer.ms(lambda: BL.bitlinear_axes_banked_p(
                x, vidx, bp, bvr, bvc, wq, ws), reps=20, warmup=3),
            "plain_ms": timer.ms(lambda: BL.plain_banked(
                x, vidx, bp, bvr, bvc, wq, w_scale=ws), reps=10, warmup=2),
            **row_bound, "library_ms": None,
            # the single-variant kernel on the same x: a uniform batch
            "uniform_ms": timer.ms(lambda: BL.bitlinear_axes_p(
                x, p1, vr1, vc1, wq, ws), reps=20, warmup=3)})
        del got, want, scale
    return rows


def static_rows(name, n, k, gen, dev, timer, p0, vr0, vc0, base) -> list:
    """``bitlinear_p`` (static mode) on layer 0's sign plane in row, col
    and scalar mode, at M=4 and M=64; the vector is fp32, as the wrapper
    hands it to the kernel."""
    from repro_torch.core import delta as D
    from repro_torch.kernels import bitlinear as BL
    from repro_torch.kernels import ops as K

    wq, ws, wf, base_bytes = _base(base)
    rows = []
    for mode, v in (("row", vr0), ("col", vc0), ("scalar", vr0.mean())):
        v = v.float().contiguous()
        v2d = K._v2d(v, mode, (), n, k)
        w_hat = D.reconstruct(p0, v, wf, mode, dtype=torch.float32)
        w_abs = w_hat.abs()
        for m in (LANES, LANES * PROMPT):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            got = BL.bitlinear_p(x, p0, v2d, wq, ws)
            want = BL.plain_static(x.float(), p0, v, wq, mode, w_scale=ws)
            err = _check_gemm((name, mode, m), got, want, x, w_abs)
            x32 = x.float()
            nbytes = (x.numel() * 2 + p0.numel() + v.numel() * 4
                      + base_bytes + m * n * 4)
            rows.append({
                "shape": f"{name} {mode} M={m} N={n} K={k}", "m": m,
                "mode": mode, "max_abs_err": err,
                "ms": timer.ms(lambda: BL.bitlinear_p(x, p0, v2d, wq, ws),
                               reps=20, warmup=3),
                "plain_ms": timer.ms(lambda: BL.plain_static(
                    x, p0, v, wq, mode, w_scale=ws), reps=10, warmup=2),
                **bound(nbytes, 2 * m * n * k + _build_flops(
                    n, k, ws is not None) - n * k),
                "library_ms": timer.ms(lambda: torch.matmul(x32, w_hat.T),
                                       reps=20, warmup=3)})
        del w_hat, w_abs
    return rows


# kernel-body entries of the JSON line: (name, source, replaces)
KERNELS = [
    ("unpack_apply", "src/repro_torch/csrc/unpack_apply.cu",
     "src/repro/kernels/unpack_apply.py:54"),
    ("unpack_apply_q8", "src/repro_torch/csrc/unpack_apply.cu",
     "src/repro/kernels/unpack_apply.py:44"),
    ("bitlinear_axes", "src/repro_torch/csrc/bitlinear_axes.cu",
     "src/repro/kernels/bitlinear.py:222"),
    ("bitlinear_axes_q8", "src/repro_torch/csrc/bitlinear_axes.cu",
     "src/repro/kernels/bitlinear.py:98"),
    ("bitlinear_axes_banked", "src/repro_torch/csrc/bitlinear_axes_banked.cu",
     "src/repro/kernels/bitlinear.py:178"),
    ("bitlinear_axes_banked_q8",
     "src/repro_torch/csrc/bitlinear_axes_banked.cu",
     "src/repro/kernels/bitlinear.py:152"),
    ("bitlinear", "src/repro_torch/csrc/bitlinear.cu",
     "src/repro/kernels/bitlinear.py:35"),
    ("bitlinear_q8", "src/repro_torch/csrc/bitlinear.cu",
     "src/repro/kernels/bitlinear.py:76"),
    # bitlinear_axes_p as the JAX MoE layer vmaps it over the experts
    # (src/repro/models/moe.py:83, `_expert_mm`)
    ("bitlinear_axes_stacked",
     "src/repro_torch/csrc/bitlinear_axes_stacked.cu",
     "src/repro/kernels/bitlinear.py:222"),
    ("bitlinear_axes_stacked_q8",
     "src/repro_torch/csrc/bitlinear_axes_stacked.cu",
     "src/repro/kernels/bitlinear.py:98"),
    ("flash_attention", "src/repro_torch/csrc/flash_attn.cu",
     "src/repro/kernels/flash_attn.py:73"),
]


def kernel_phase(cfg, dev, timer) -> dict:
    """{kernel-body name: per-shape rows} over the seven projections."""
    from repro_torch.core import delta as D
    from repro_torch.core import quantize as Q

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    L = SERVE_LAYERS
    rows = {name: [] for name, _, _ in KERNELS}
    tiers = []
    for name, n, k in projections(cfg):
        wb = torch.randn((L, n, k), generator=gen, device=dev) * k ** -0.5
        delta = torch.randn((L, n, k), generator=gen, device=dev) * 0.005
        packed = D.pack_signs(D.sign_mask(delta))
        v_row = D.init_scale(delta, "row")
        v_col = D.init_scale(delta, "col")
        del delta
        qw = Q.quantize_weight(wb)
        p0 = packed[0].contiguous()
        for suffix, stack, layer0 in (
                ("", wb, wb[0].contiguous()),
                ("_q8", qw, Q.QuantWeight(q=qw.q[0], scale=qw.scale[0]))):
            rows["unpack_apply" + suffix] += unpack_rows(
                name, timer, packed, v_row, v_col, stack)
            rows["bitlinear_axes" + suffix] += axes_rows(
                name, n, k, gen, dev, timer, p0, v_row[0], layer0)
            if name in TIER_SHAPES:
                tiers += tier_rows(name, n, k, gen, dev, timer, p0,
                                   v_row[0], layer0)
            rows["bitlinear_axes_banked" + suffix] += banked_rows(
                name, n, k, gen, dev, timer, packed, v_row, v_col, layer0)
            rows["bitlinear" + suffix] += static_rows(
                name, n, k, gen, dev, timer, p0, v_row[0], v_col[0], layer0)
        del wb, qw, packed, v_row, v_col, p0
        torch.cuda.empty_cache()
    print_rows(rows)
    print("  -- bitlinear_axes streaming row tiers (M=8: 8 rows, M=16: 16 "
          "rows) vs the 4-row tier once per 4 rows vs the tiled kernel at "
          "M=17")
    for r in tiers:
        print(f"  {r['shape']:44s} tier_ms={r['tier_ms']:.4f} "
              f"groups_of_4_ms={r['groups_of_4_ms']:.4f} "
              f"tiles_m17_ms={r['tiles_m17_ms']:.4f}")
    print("  -- bitlinear_axes_banked in the speculative verify's layouts "
          "(each lane of [0,1,2,1] k+1 times; M = 4(k+1)) vs the "
          "single-variant kernel on the same x")
    for name in ("bitlinear_axes_banked", "bitlinear_axes_banked_q8"):
        for k, m in VERIFY_M.items():
            verify = [r for r in rows[name] if r["case"] == f"M={m}"]
            for r in verify:
                print(f"  {name:25s} {r['shape']:36s} k={k} "
                      f"kernel_ms={r['ms']:.4f} "
                      f"single_variant_ms={r['uniform_ms']:.4f} "
                      f"ratio={r['ms'] / r['uniform_ms']:.2f} "
                      f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                      f"err={r['max_abs_err']:.3g}")
            unit = {key: sum(r[key] for r in verify)
                    for key in ("ms", "uniform_ms", "bound_ms")}
            print(f"  {name:25s} one layer's 7 projections at M={m} (k={k}):"
                  f" kernel_ms={unit['ms']:.4f} single_variant_ms="
                  f"{unit['uniform_ms']:.4f} bound_ms={unit['bound_ms']:.4f}"
                  f" ({unit['bound_ms'] / unit['ms']:.0%} of the bound)")
    print("kernels: unpack_apply bit-identical to plain at "
          f"{len(rows['unpack_apply']) + len(rows['unpack_apply_q8'])} "
          "shapes (fp32 and int8 base); every GEMM within 1e-5 relative at "
          + ", ".join(f"{len(r)} shapes ({k})" for k, r in rows.items()
                      if r and not k.startswith("unpack")))
    return rows


def print_rows(rows: dict, heading: str = "") -> None:
    """One line per kernel row: error, times, bound."""
    for kname, krows in rows.items():
        print(f"  -- {kname}{heading}")
        for r in krows:
            extra = "".join(f" {key}={r[key]:.4f}" for key in
                            ("uniform_ms", "read_ms", "full_bound_ms")
                            if key in r)
            if r.get("splits", 1) > 1:
                extra += f" k_splits={r['splits']}"
            print(f"  {r['shape']:44s} err={r['max_abs_err']:.3g} "
                  f"kernel_ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                  f"({r['bound_by']}, {r['peak_tflops']:.0f} TF/s) "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']}{extra}")


def summary(name, source, replaces, rows, unit):
    """One JSON kernel entry: times summed over ``rows`` (one unit of the
    serving path), the largest error, per-shape rows kept beside.  The
    unit is bound by whichever of bytes and operations dominates its
    calls' bounds."""
    bound = sum(r["bound_ms"] for r in rows)
    by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    by = "bytes" if by_bytes >= bound - by_bytes else "operations"
    (peak,) = {r["peak_tflops"] for r in rows}
    lib = [r["library_ms"] for r in rows]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound, "bound_by": by, "peak_tflops": peak,
            "library_ms": None if None in lib else sum(lib),
            "unit": unit, "shapes": rows}


# ---------------------------------------------------------------------------
# flash phase
# ---------------------------------------------------------------------------

# (atol, rtol) against the plain version.  Both sum in fp32 and round once
# to the output type, so in bf16 they differ by at most one bf16 step of the
# output (2^-7 of it at most) plus fp32 noise.
FLASH_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (5e-4, 1e-2)}


def flash_within(got, want) -> tuple[bool, float, float]:
    """(|got - want| <= atol + rtol·|want| everywhere, max |err|, the
    limit at the median |want|)."""
    atol, rtol = FLASH_TOL[want.dtype]
    want = want.float()
    diff = (got.float() - want).abs()
    typical = want.abs().median().item()
    return (bool((diff <= atol + rtol * want.abs()).all()),
            diff.max().item(), typical)
FLASH_UNIT = "S=T=4096 causal bf16"


def flash_cases(cfg) -> list:
    """(label, B, Hq, Hkv, hd, S, T, causal, q_offset, kv_offset, dtype):
    qwen3-8b's heads at B=1 for S=T in {16, 512, 4096}, causal and not, fp32
    and bf16; one hd-256 shape; an odd S; absolute offsets, including a
    block whose first rows see no key (q_offset < kv_offset)."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cases = [(f"S=T={s} {'causal' if c else 'full'} {n}", 1, hq, hkv, hd, s,
              s, c, 0, 0, dt)
             for s in (16, 512, 4096) for c in (True, False)
             for n, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16))]
    for n, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cases += [
            (f"hd=256 S=T=512 causal {n}", 1, 16, 8, 256, 512, 512, True, 0,
             0, dt),
            (f"S=T=77 causal {n}", 1, hq, hkv, hd, 77, 77, True, 0, 0, dt),
            (f"S=128 T=512 q_off=384 {n}", 1, hq, hkv, hd, 128, 512, True,
             384, 0, dt),
            (f"S=T=256 kv_off=40 (no-key rows) {n}", 1, hq, hkv, hd, 256,
             256, True, 0, 40, dt)]
    return cases


def _visible_pairs(s, t, causal, q_off, kv_off) -> int:
    """(query, key) pairs this run's data needs: under the causal mask the
    visible keys of each row; a row that sees none averages all T keys."""
    if not causal:
        return s * t
    i = np.arange(s)
    seen = np.clip(q_off + i - kv_off + 1, 0, t)
    return int(np.where(seen == 0, t, seen).sum())


def flash_phase(cfg, dev, timer) -> tuple:
    """``ops.flash_attention_fwd`` over the flash cases, the launch counters
    zeroed right before; each output held against the plain version
    (``plain_versions()``); then per case the kernel, the plain version and
    SDPA (where one call computes the same function) timed.  Returns
    (rows, launches)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import ops as K

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = flash_cases(cfg)
    inputs = []
    for _, b, hq, hkv, hd, s, t, _, _, _, dt in cases:
        inputs.append(tuple(torch.randn(shape, generator=gen, device=dev
                                        ).to(dt)
                            for shape in ((b, s, hq, hd), (b, t, hkv, hd),
                                          (b, t, hkv, hd))))
    torch.cuda.synchronize()
    zero_counters()
    outs = [K.flash_attention_fwd(q, k, v, causal=c, q_offset=qo,
                                  kv_offset=ko)
            for (q, k, v), (_, _, _, _, _, _, _, c, qo, ko, _)
            in zip(inputs, cases)]
    torch.cuda.synchronize()
    launches = counters()
    assert launches["flash_attention"] == len(cases), launches
    rows = []
    for (q, k, v), out, case in zip(inputs, outs, cases):
        label, b, hq, hkv, hd, s, t, causal, qo, ko, dt = case
        with K.plain_versions():
            want = K.flash_attention_fwd(q, k, v, causal=causal,
                                         q_offset=qo, kv_offset=ko)
        ok, err, typical = flash_within(out, want)
        assert bool(torch.isfinite(out).all()) and ok, (label, err)
        atol, rtol = FLASH_TOL[dt]
        if s == 4096:
            # the limit must stay well below the values it checks, whose
            # typical size falls as sqrt(e/T)
            assert atol + rtol * typical < 0.1 * typical, (label, typical)
        del want
        qf = q.transpose(1, 2).contiguous().reshape(b * hq, s, hd)
        kf = k.transpose(1, 2).contiguous().reshape(b * hkv, t, hd)
        vf = v.transpose(1, 2).contiguous().reshape(b * hkv, t, hd)
        kw = dict(group=hq // hkv, causal=causal, q_offset=qo, kv_offset=ko)
        es = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * es
        flops = 4 * b * hq * hd * _visible_pairs(s, t, causal, qo, ko)
        library = None
        if qo == ko == 0 and s == t:
            q4, k4, v4 = (x.reshape(b, -1, x.shape[1], hd)
                          for x in (qf, kf, vf))
            library = timer.ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, enable_gqa=True),
                reps=10, warmup=2)
        rows.append({
            "shape": label, "case": label, "max_abs_err": err,
            "median_abs_out": typical,
            "ms": timer.ms(lambda: FA.flash_attention_fwd_p(qf, kf, vf, **kw),
                           reps=10, warmup=2),
            "plain_ms": timer.ms(lambda: FA.plain(qf, kf, vf, **kw), reps=3,
                                 warmup=1),
            **bound(nbytes, flops, dt), "library_ms": library})
        del qf, kf, vf
    del inputs, outs
    torch.cuda.empty_cache()
    print("  -- flash_attention")
    for r in rows:
        print(f"  {r['shape']:38s} err={r['max_abs_err']:.3g} "
              f"median|o|={r['median_abs_out']:.3g} "
              f"kernel_ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}, {r['peak_tflops']:.0f} TF/s) "
              f"plain_ms={r['plain_ms']:.4f} sdpa_ms={r['library_ms']}")
    worst = {n: max(r["max_abs_err"] for r in rows if r["shape"].endswith(n))
             for n in ("fp32", "bf16")}
    print(f"flash: {len(cases)} cases within {FLASH_TOL[torch.float32]} "
          f"(fp32) / {FLASH_TOL[torch.bfloat16]} (bf16) (atol, rtol) of the "
          f"plain version; largest |err| fp32 {worst['fp32']:.3g}, bf16 "
          f"{worst['bf16']:.3g}; launches {launches}")
    return rows, launches


def prefill_flash_check(model, params, cfg, dev) -> None:
    """The kernel on the q/k/v a full-width prefill computes (layer 0 after
    qk-norm and RoPE, 2 x 512 tokens): within ``FLASH_TOL`` of the plain
    version, and against the chunked ``attention.flash_attention`` the
    model runs.  That one rounds q·hd^-½ and the probabilities to bf16, as
    the JAX one does, which moves each weight by up to about 2^-8 of itself:
    it is held within 2e-2 of the attention-weighted |v| (the plain version
    on |v|), the most such reweighting can move an output."""
    from repro_torch.kernels import ops as K
    from repro_torch.models import attention as A
    from repro_torch.models.layers import embed_lookup, rmsnorm

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    tokens = torch.randint(1, cfg.vocab_size, (2, 512), generator=gen,
                           device=dev)
    layer0 = {k: v[0] for k, v in params["layers"]["attn"].items()}
    with torch.no_grad():
        x = embed_lookup(params["embed"], tokens, cfg.compute_dtype)
        h = rmsnorm(x, params["layers"]["ln1"][0], cfg.norm_eps)
        q, k, v = A.qkv_project(layer0, h, cfg,
                                torch.arange(512, device=dev),
                                cfg.rope_theta)
        zero_counters()
        got = K.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        launched = counters()["flash_attention"]
        with K.plain_versions():
            exact = K.flash_attention_fwd(q, k, v, causal=True)
            v_abs = K.flash_attention_fwd(q.float(), k.float(),
                                          v.float().abs(), causal=True)
        chunked = A.flash_attention(q, k, v, causal=True)
    assert launched == 1 and got.dtype == q.dtype == torch.bfloat16
    ok, err, typical = flash_within(got, exact)
    assert ok, err
    diff = (got.float() - chunked.float()).abs()
    err_chunked = diff.max().item()
    assert bool((diff <= 2e-2 * v_abs).all()), err_chunked
    print(f"flash on full-width prefill q/k/v {tuple(q.shape)} / "
          f"{tuple(k.shape)} (layer 0, after qk-norm and RoPE): within "
          f"{FLASH_TOL[torch.bfloat16]} (atol, rtol) of the plain version, "
          f"max |err| {err:.3g} (median |o| {typical:.3g}); against "
          f"attention.flash_attention max |err| {err_chunked:.3g}, at most "
          f"{(diff / v_abs).max().item():.3g} of the attention-weighted |v| "
          f"(limit 2e-2)")


# ---------------------------------------------------------------------------
# serving phases
# ---------------------------------------------------------------------------

# the kernel each serving run must show in its launch counters
RUN_KERNEL = {"dense": "unpack_apply", "fused": "bitlinear_axes",
              "continuous": "bitlinear_axes_banked",
              "speculative": "bitlinear_axes_banked"}


def reference_phase(dev) -> None:
    """Reduced qwen3-8b, fp32 compute: kernels on the card vs the plain
    versions on the CPU, same base, variants and requests, over an fp32 and
    an int8 base."""
    import dataclasses

    from repro_torch.core import calibration as C
    from repro_torch.core import quantize as Q
    from repro_torch.launch import serve as SV
    from repro_torch.models import build_model
    from repro_torch.models.param import split
    from repro_torch.serving import Deployment

    cfg = dataclasses.replace(SV.make_config(ARCH, reduced=True),
                              num_layers=2, compute_dtype="float32")
    model = build_model(cfg)
    base, _ = split(model.init(0, device="cpu"))
    dms = [C.compress(base, SV.fine_tune(base, 100 + i)) for i in range(2)]
    # the int8 base quantized on the card equals the CPU's, byte for byte
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    weights = [leaf for path, leaf in C.flatten_params(base).items()
               if C.is_target(path, leaf)]
    weights.append(torch.randn((12288, 4096), generator=gen) * 4096 ** -0.5)
    for w in weights:
        on_cpu, on_card = Q.quantize_weight(w), Q.quantize_weight(w.to(dev))
        assert torch.equal(on_card.q.cpu(), on_cpu.q) and torch.equal(
            on_card.scale.cpu().view(torch.int16),
            on_cpu.scale.view(torch.int16))
    print(f"reference: int8 quantization on the card == on the cpu for "
          f"{len(weights)} weights (bytes and scale bits)")
    reference_runs(dev, model, base, dms,
                   [("group", "dense", 4), ("group", "fused", 4),
                    ("continuous", "fused", [2, 5, 3, 4]),
                    ("speculative", "fused", [2, 5, 3, 4])],
                   SV.PROMPT_LEN, SV.MAX_LEN)


def divergence(dep, model, rids, got, want, prompt_len) -> str:
    """Where two runs' tokens first differ: the request, the position, the
    two tokens and the top-2 logit margin there, from a teacher-forced
    forward of the request's padded prompt and the tokens before it
    through ``dep``'s weights for the request's variant (its bank slot,
    or its group-mode resident)."""
    from repro_torch.serving.engine import frontend_stub

    for i, (a, b) in enumerate(zip(got, want)):
        pos = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                   None)
        if pos is None:
            continue
        r = dep.result(rids[i])
        prompt = np.zeros(prompt_len, np.int64)
        tail = r.tokens[-prompt_len:]
        prompt[:len(tail)] = tail
        seq = torch.tensor(np.concatenate([prompt, np.asarray(
            a[:pos], np.int64)]), device=dep.device)[None]
        batch = {"tokens": seq, **frontend_stub(model.cfg, 1, dep.device)}
        reg = dep.registry
        if dep.engine.scheduler == "group":
            params, overlay = reg.resolve(r.variant)
            vidx = None
        else:
            params, overlay = reg.base_params, reg.bank.tree
            vidx = torch.tensor([reg.bank_resolve(r.variant)],
                                device=dep.device)
        logits, _ = model.forward(params, batch, overlay=overlay,
                                  variant_idx=vidx)
        top = torch.topk(logits[0, -1].float(), 2).values
        return (f"request {i} ({r.variant}) position {pos}: {a[pos]} vs "
                f"{b[pos]}, top-2 logit margin "
                f"{(top[0] - top[1]).item():.4g}")
    return "no position differs"


def reference_runs(dev, model, base, dms, runs, prompt_len,
                   max_len) -> None:
    """Each (scheduler, mode, budgets) run over an fp32 and an int8 base,
    on the CPU through the plain versions and on the card through the
    kernels: 6 requests round-robin over base, v0 and v1, prompts padded to
    ``prompt_len``, caches of ``max_len``; tokens must be identical and the
    card run must launch the run's kernel (and, for an MoE model in fused
    mode, the stacked expert GEMM).  A speculative run (drafts of up to
    ``SPEC_K``) must also give the tokens of the continuous run with the
    same budgets, which ``runs`` lists before it.  A mismatch reports
    where it starts and the top-2 logit margin there (``divergence``)."""
    from repro_torch.launch import serve as SV
    from repro_torch.serving import Deployment

    cfg = model.cfg
    for base_dtype in ("fp", "int8"):
        served = {}
        for scheduler, mode, budgets in runs:
            tokens = {}
            for where in ("cpu", dev):
                zero_counters()
                dep = Deployment(model, base, mode=mode,
                                 scheduler=scheduler, batch_size=4,
                                 prompt_len=prompt_len,
                                 max_len=max_len,
                                 bank_size=4, device=where,
                                 base_dtype=base_dtype, draft_k=SPEC_K)
                for i, dm in enumerate(dms):
                    dep.publish(f"v{i}", dm)
                rids = SV.submit_requests(dep, cfg, 6, budgets)
                dep.drain()
                tokens[str(where)] = [dep.result(r).out_tokens for r in rids]
            launched = {k: v for k, v in counters().items() if v}
            run = mode if scheduler == "group" else scheduler
            assert tokens["cpu"] == tokens[str(dev)], (
                cfg.name, base_dtype, scheduler, mode, divergence(
                    dep, model, rids, tokens[str(dev)], tokens["cpu"],
                    prompt_len))
            assert launched.get(RUN_KERNEL[run], 0) > 0, (
                cfg.name, base_dtype, scheduler, mode, launched)
            if cfg.family == "moe" and mode == "fused":
                assert launched.get("bitlinear_axes_stacked", 0) > 0, (
                    cfg.name, base_dtype, scheduler, launched)
            served[scheduler, str(budgets)] = tokens["cpu"]
            extra = ""
            if scheduler == "speculative":
                assert tokens["cpu"] == served["continuous", str(budgets)], (
                    cfg.name, base_dtype, divergence(
                        dep, model, rids, tokens[str(dev)],
                        served["continuous", str(budgets)], prompt_len))
                extra = (" == continuous tokens (acceptance "
                         f"{dep.status()['speculative']['acceptance']:.3f})")
            print(f"reference {cfg.name} {base_dtype} {scheduler} {mode}: "
                  f"card tokens == cpu plain tokens{extra} "
                  f"({sum(map(len, tokens['cpu']))} tokens, card launches "
                  f"{launched})")


def deltalinear_phase(cfg, dev) -> dict:
    """``DeltaLinear(apply_mode="onfly")`` — the path of ``bitlinear_p`` —
    over the seven projections of one full-width layer, each on its
    best static axis, at M=4 and M=64, over an fp32 and an int8 base.
    Counters are zeroed right before each run; every output is held against
    the dense apply mode (over the dequantized base for int8).  Returns
    {base dtype: launches}."""
    from repro_torch.core import bitdelta as BD
    from repro_torch.core import delta as D
    from repro_torch.core import quantize as Q

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    lins = []
    for name, n, k in projections(cfg):
        wb = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
        wf = wb + 0.005 * torch.randn((n, k), generator=gen, device=dev)
        mode = BD.best_static_axis(wb, wf)
        lins.append((name, BD.DeltaLinear.from_pair(wb, wf, mode)))
        del wf
    xs = {k: [torch.randn((m, k), generator=gen, device=dev)
              for m in (LANES, LANES * PROMPT)]
          for k in {k for _, _, k in projections(cfg)}}
    launches = {}
    for base_dtype in ("fp", "int8"):
        if base_dtype == "int8":
            lins = [(name, BD.DeltaLinear(lin.packed, lin.v,
                                          Q.quantize_weight(lin.w_base),
                                          lin.mode))
                    for name, lin in lins]
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        ys = [[lin(x, apply_mode="onfly") for x in xs[lin.shape[1]]]
              for _, lin in lins]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[base_dtype] = counters()
        assert launches[base_dtype]["bitlinear"] == 2 * len(lins), launches
        err = 0.0
        for (name, lin), ys_lin in zip(lins, ys):
            wf = Q.dequantize(lin.w_base) if Q.is_quant(lin.w_base) \
                else lin.w_base
            dense = BD.DeltaLinear(lin.packed, lin.v, wf, lin.mode)
            w_abs = D.reconstruct(lin.packed, lin.v, wf, lin.mode,
                                  dtype=torch.float32).abs()
            for x, y in zip(xs[lin.shape[1]], ys_lin):
                err = max(err, _check_gemm((name, base_dtype), y,
                                           dense(x, apply_mode="dense"),
                                           x, w_abs))
        print(f"deltalinear {base_dtype}: {len(lins)} projections x M=4, "
              f"M=64 onfly, modes {[lin.mode for _, lin in lins]}, within "
              f"1e-5 relative of dense (max |err| {err:.3g}), wall "
              f"{wall * 1e3:.2f} ms, launches {launches[base_dtype]}")
    del lins, xs, ys
    torch.cuda.empty_cache()
    return launches


def profile_decode(model, params, overlay, dev, label, step_ms,
                   vidx=None, prompt_len=None, max_len=None):
    """One decode step of batch 4 under ``torch.profiler``: summed device
    time, the kernels that take the most, and the device's idle share of
    the serve run's mean decode step (``step_ms``, unprofiled).  The cache
    comes from a prefill of ``prompt_len`` tokens (default the serve
    launcher's) and the engine's frontend stub (whisper's frames, a VLM's
    image prefix) into ``max_len`` slots (default ``serve.cache_len``).  Prompts and the decoded token
    differ between lanes (seeded), so an MoE layer routes them as serving
    does: its stacked GEMM skips only the experts none of them picks.
    Returns the device-busy ms (None where the profiler saw nothing)."""
    from repro_torch.launch import serve as SV

    prompt_len = prompt_len or SV.PROMPT_LEN
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    vocab = model.cfg.vocab_size
    cache = profile_cache(model, params, overlay, dev, vidx, gen,
                          prompt_len, max_len)
    tok = torch.randint(1, vocab, (LANES,), generator=gen, device=dev,
                        dtype=torch.int32)
    model.decode_step(params, tok, cache, overlay=overlay,
                      variant_idx=vidx)   # warm-up
    events, busy_ms, wall_ms = profiled(lambda: model.decode_step(
        params, tok, cache, overlay=overlay, variant_idx=vidx))
    stacked = [e for e in events if "stacked_" in e.key
               or "live_kernel" in e.key]
    if not events:
        print(f"profile {label} decode step: wall_ms={wall_ms:.3f} "
              "device time not measured (the profiler saw no device work)")
        return None
    print(f"profile {label} decode step: device_busy_ms={busy_ms:.3f} "
          f"profiled_wall_ms={wall_ms:.3f} serve_step_ms={step_ms:.3f} "
          f"idle_share={max(0.0, 1 - busy_ms / step_ms):.3f}"
          + (f" stacked_ms={sum(map(_dev_us, stacked)) / 1e3:.3f} "
             f"stacked_launches={sum(e.count for e in stacked)}"
             if stacked else ""))
    for e in sorted(events, key=_dev_us, reverse=True)[:8]:
        print(f"    {_dev_us(e) / 1e3:9.3f} ms  calls={e.count:4d}  "
              f"{e.key[:70]}")
    return busy_ms


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def profiled(fn) -> tuple:
    """(device-side profiler events, device-busy ms, wall ms) of ``fn()``
    under ``torch.profiler``; only device events count (an operator's own
    row repeats the time of the kernels it launched)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA and _dev_us(e) > 0]
    return events, sum(map(_dev_us, events)) / 1e3, wall_ms


def profile_cache(model, params, overlay, dev, vidx, gen, prompt_len,
                  max_len):
    """The cache of a ``LANES`` x ``prompt_len`` prefill of seeded random
    tokens and the engine's frontend stub, into ``max_len`` slots (default
    ``serve.cache_len``)."""
    from repro_torch.launch import serve as SV
    from repro_torch.serving.engine import frontend_stub

    batch = {"tokens": torch.randint(1, model.cfg.vocab_size,
                                     (LANES, prompt_len), generator=gen,
                                     device=dev),
             **frontend_stub(model.cfg, LANES, dev)}
    _, cache = model.prefill(params, batch,
                             max_len or SV.cache_len(model.cfg, prompt_len),
                             overlay=overlay, variant_idx=vidx)
    return cache


def drive(dep, cfg, label, n_requests, budgets, setup_s,
          prompt_range=None, stats=None) -> tuple:
    """Serve ``n_requests`` round-robin over the deployment's variants with
    the launch counters zeroed right before; every request must finish
    with exactly its budget.  Prompts are the serve launcher's 8 random
    tokens, or ``long_requests`` of a (lo, hi) ``prompt_range``.  A slot
    scheduler serving through CUDA graphs is warmed up first (every step
    captured before the counters are zeroed): the run must capture
    nothing more and replay one graph a decode step or round.  ``stats``
    (a dict) receives the run's wall seconds, tokens/s, mean step ms,
    peak memory, warmup and capture seconds and step counters.  Returns
    (tokens per request, launches)."""
    from repro_torch.launch import serve as SV

    graphs = dep.engine.graphs
    if graphs:
        outcomes = dep.warmup()
        captured = sum(v == "captured" for v in outcomes.values())
        st = dep.status()["steps"]
        print(f"warmup {label}: {dep.metrics['warmup_seconds']:.3f} s, "
              f"{captured} graphs captured in {st['compile_seconds']:.3f} "
              f"s ({sorted(k for k, v in outcomes.items() if v == 'captured')}"
              f"), the rest {sorted(set(outcomes.values()) - {'captured'})}")
    steps0 = dict(dep.status()["steps"])
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    if prompt_range is None:
        rids = SV.submit_requests(dep, cfg, n_requests, budgets)
    else:
        rids = long_requests(dep, cfg, n_requests, budgets, *prompt_range)
    dep.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    # the graphs' private pool is reserved, not allocated, between replays
    reserved = torch.cuda.max_memory_reserved()
    reqs = [dep.result(r) for r in rids]
    want = [budgets[i % len(budgets)] for i in range(n_requests)]
    assert all(r.status == "done" and len(r.out_tokens) == w
               for r, w in zip(reqs, want)), \
        [(r.status, len(r.out_tokens), w) for r, w in zip(reqs, want)]
    assert all(0 <= t < cfg.padded_vocab for r in reqs
               for t in r.out_tokens)
    m = dep.metrics
    steps = dep.status()["steps"]
    if graphs:
        assert steps["compiles"] == steps0["compiles"], (label, steps0, steps)
        assert steps["cache_hits"] - steps0["cache_hits"] == \
            m["decode_steps"], (label, steps0, steps, m["decode_steps"])
    elif dep.engine.scheduler != "group":
        assert steps["compiles"] == steps["cache_hits"] == 0, (label, steps)
    print(f"serve {label}: setup_s={setup_s:.3f} wall_s={wall:.3f} "
          f"tokens={m['tokens_generated']} "
          f"tokens_per_s={m['tokens_generated'] / wall:.2f} "
          f"prefill_s={m['prefill_seconds']:.4f} "
          f"decode_s={m['decode_seconds']:.4f} "
          f"decode_steps={m['decode_steps']} prefills={m['prefills']} "
          f"peak_mem_GB={peak / 1e9:.2f} (reserved "
          f"{reserved / 1e9:.2f}) launches={launches} "
          f"graphs={graphs} steps={steps} registry={dep.stats}")
    if stats is not None:
        stats.update(wall_s=wall, tokens_per_s=m["tokens_generated"] / wall,
                     step_ms=1e3 * m["decode_seconds"] / max(
                         m["decode_steps"], 1),
                     peak_gb=peak / 1e9, reserved_gb=reserved / 1e9,
                     warmup_s=m["warmup_seconds"],
                     capture_s=steps["compile_seconds"], steps=steps)
    return [r.out_tokens for r in reqs], launches


def copy_back_ms(dep, timer) -> tuple:
    """(bytes, device ms) of the copy-back a graphed step ends with: every
    leaf of the live cache that the model's step rebinds written from a
    fresh tensor (timed on clones of the whole cache, L2 flushed; leaves
    the step writes in place are skipped by the engine, so this is an
    upper bound)."""
    from repro_torch.serving import engine as E
    from repro_torch.tree import tree_leaves, tree_map

    live = dep.engine._cache
    new = tree_map(torch.clone, live)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(live))
    ms = timer.ms(lambda: E._copy_back(live, new), reps=10, warmup=2)
    del new
    return nbytes, ms


def eager_twin(deploy, cfg, label, n_requests, budgets, tokens, graphed,
               prompt_range=None) -> dict:
    """The graphed run ``label`` served again with ``graphs=False``
    (``deploy(graphs)`` builds its Deployment), the same requests: the
    tokens must equal the graphed run's bit for bit.  Prints the two runs
    side by side: mean step (or round), tokens/s, peak memory, the
    device's idle share of a step where the graphed run's ``busy_ms`` was
    profiled, and the graphed run's warmup, capture seconds and step
    counters.  Returns the eager run's ``drive`` stats."""
    t0 = time.perf_counter()
    dep = deploy(graphs=False)
    torch.cuda.synchronize()
    eager = {}
    got, _ = drive(dep, cfg, f"{label} eager", n_requests, budgets,
                   time.perf_counter() - t0, prompt_range, stats=eager)
    del dep
    gc.collect()
    torch.cuda.empty_cache()
    differ = [(i, j) for i, (a, b) in enumerate(zip(got, tokens))
              for j, (x, y) in enumerate(zip(a, b)) if x != y]
    assert got == tokens and not differ, (label, differ[:8])
    busy = graphed.get("busy_ms")
    idle = "" if busy is None else (
        f"; device busy {busy:.3f} ms a step, idle share eager "
        f"{max(0.0, 1 - busy / eager['step_ms']):.3f} -> graphed "
        f"{max(0.0, 1 - busy / graphed['step_ms']):.3f}")
    print(f"graphs {label}: mean step eager {eager['step_ms']:.3f} ms -> "
          f"graphed {graphed['step_ms']:.3f} ms "
          f"(x{eager['step_ms'] / graphed['step_ms']:.2f}); tokens_per_s "
          f"eager {eager['tokens_per_s']:.2f} -> graphed "
          f"{graphed['tokens_per_s']:.2f}; peak_mem_GB allocated eager "
          f"{eager['peak_gb']:.2f} -> graphed {graphed['peak_gb']:.2f}, "
          f"reserved {eager['reserved_gb']:.2f} -> "
          f"{graphed['reserved_gb']:.2f}{idle}; warmup "
          f"{graphed['warmup_s']:.3f} s, capture "
          f"{graphed['capture_s']:.3f} s, steps {graphed['steps']}; tokens "
          f"identical ({sum(map(len, tokens))} tokens)")
    return eager


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
    model, base, dms = SV.build_variants(cfg, 2, dev)
    dep = SV.deploy(model, base, dms, mode="dense", scheduler="group",
                    batch=LANES, device=dev)
    del model, base, dms
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
    del dep, bank
    gc.collect()
    torch.cuda.empty_cache()

    # -- the same three runs over an int8 base ------------------------------
    for run, scheduler, mode, n_req, budgets in (
            ("dense", "group", "dense", 8, [8]),
            ("fused", "group", "fused", 8, [8]),
            ("continuous", "continuous", "fused", 12, CONT_BUDGETS)):
        label = f"{run} int8"
        t0 = time.perf_counter()
        dep = SV.deploy(model, base, dms, mode=mode, scheduler=scheduler,
                        batch=LANES, bank_size=4, device=dev,
                        base_dtype="int8")
        torch.cuda.synchronize()
        qs = dep.registry.quant_stats
        assert qs["ratio"] < 0.3, qs
        tokens[label], launches[label] = drive(
            dep, cfg, label, n_req, budgets, time.perf_counter() - t0)
        assert launches[label][RUN_KERNEL[run]] > 0, launches[label]
        m = dep.metrics
        if run == "continuous":
            calls = m["prefills"] + m["decode_steps"]
            assert launches[label]["bitlinear_axes_banked"] == \
                7 * SERVE_LAYERS * calls, (launches[label], calls)
            assert m["admitted"] == m["retired"] == n_req, m
        same = sum(a == b for ra, rb in zip(tokens[label], tokens[run])
                   for a, b in zip(ra, rb))
        total = sum(len(r) for r in tokens[run])
        print(f"{label}: quant_stats {qs}; hbm {dep.status()['hbm']}; "
              f"int8 vs fp greedy agreement {same}/{total} tokens (printed, "
              "not asserted: random weights at full width give near-tied "
              "logits)")
        if run == "continuous":
            bank = dep.registry.bank
            slots = [dep.registry.bank_resolve(v) for v in ("v0", "v1")]
            vidx = torch.tensor([0, slots[0], slots[1], slots[0]],
                                dtype=torch.int32, device=dev)
            profile_decode(model, dep.registry.base_params, bank.tree, dev,
                           f"{label} mixed (vidx {vidx.tolist()})",
                           mean_step_ms(dep), vidx=vidx)
            del bank
        else:
            params, overlay = dep.registry.resolve("v0")
            profile_decode(model, params, overlay, dev, label,
                           mean_step_ms(dep))
            del params, overlay
        del dep
        gc.collect()
        torch.cuda.empty_cache()
    del model, base, dms
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# lifecycle phases: calibrate -> publish -> serve -> update -> rollback ->
# restart, with a store
# ---------------------------------------------------------------------------

ATTN = ("wq", "wk", "wv", "wo")


def attention_refresh(base, ft, seed: int, scale: float = 0.002):
    """The fine-tune with fresh noise on its attention matrices only: the
    localized update that ships as a patch."""
    from repro_torch.core import calibration as C

    gen = torch.Generator(device=next(iter(C.flatten_params(ft).values()))
                          .device)
    gen.manual_seed(seed)
    flat = {p: (t + scale * torch.randn(t.shape, generator=gen,
                                        device=t.device, dtype=t.dtype)
                if p.split(".")[-1] in ATTN else t)
            for p, t in C.flatten_params(ft).items()}
    return C.compress(base, C.unflatten_like(base, flat))


def lifecycle_serve(dep, cfg, requests) -> list:
    """Serve ``requests`` (tokens, variant, budget); every request must
    finish with its budget.  Returns (tokens, served version) per
    request."""
    rids = [dep.submit(t, variant=v, max_new_tokens=n)
            for t, v, n in requests]
    dep.drain()
    out = []
    for r, (_, _, n) in zip(rids, requests):
        req = dep.result(r)
        assert req.status == "done" and len(req.out_tokens) == n, (
            req.status, len(req.out_tokens), n, req.error)
        assert all(0 <= t < cfg.padded_vocab for t in req.out_tokens)
        out.append((req.out_tokens, dep.status(r)["version"]))
    return out


def lifecycle_requests(cfg, n: int, budgets) -> list:
    rng = np.random.default_rng(11)
    return [(rng.integers(1, cfg.vocab_size, size=8),
             ("__base__", "task")[i % 2], budgets[i % len(budgets)])
            for i in range(n)]


def lifecycle_phase(dev) -> dict:
    """The paper's pipeline at full width (qwen3-8b, 4 layers): calibrate a
    synthetic fine-tune (stages 0-3) on SyntheticLM batches, publish it into
    a store, serve continuous requests from it, update with an
    attention-only refresh (a patch), roll back, then restart a second
    Deployment over the same directory; the store-served tokens must equal
    those of the same DeltaModel served without a store.  Also checks the
    flash kernel on a real prefill's q/k/v.  Returns the serving run's
    launches."""
    import tempfile

    from repro_torch.core import calibration as C
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as T
    from repro_torch.serving import Deployment

    cfg = SV.make_config(ARCH, num_layers=SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    secs = {}
    t0 = time.perf_counter()
    model, base, _ = SV.build_variants(cfg, 0, dev)   # the serve phase's base
    ft = SV.fine_tune(base, 100)
    torch.cuda.synchronize()
    secs["setup"] = time.perf_counter() - t0
    prefill_flash_check(model, base, cfg, dev)

    src = SyntheticLM(cfg.vocab_size, seed=7)
    batches = [src.lm_batch(1000 + i, LANES, 64) for i in range(2)]
    held = {"tokens": torch.from_numpy(src.lm_batch(9999, LANES, 64)[
        "tokens"]).to(dev).long()}

    def held_out_mse(dm) -> float:
        with torch.no_grad():
            student = C.apply_delta(base, dm)
            got = T.forward(student, held, cfg)[0].float()
            del student
            return float(((teacher - got) ** 2).mean())

    with torch.no_grad():
        teacher = T.forward(ft, held, cfg)[0].float()
    mse0 = held_out_mse(C.compress(base, ft))
    t0 = time.perf_counter()
    dm, report = C.calibrate_transformer(model, base, ft, batches, epochs=1,
                                         e2e_epochs=1)
    torch.cuda.synchronize()
    secs["calibrate"] = time.perf_counter() - t0
    mse1 = held_out_mse(dm)
    del teacher
    fp16_bytes = C.fp16_checkpoint_nbytes(ft)
    update = attention_refresh(base, ft, seed=200)
    del ft
    gc.collect()
    torch.cuda.empty_cache()
    axes = {p: "".join(a[0] for a in v) for p, v in report["axis"].items()}
    print(f"lifecycle calibrate: {secs['calibrate']:.2f} s (2 batches x "
          f"{LANES} x 64 tokens, epochs=1, e2e_epochs=1, lr 1e-4); held-out "
          f"logit MSE stage 0 {mse0:.6g} -> calibrated {mse1:.6g}; axes "
          f"{axes}; e2e losses {report['e2e_losses']}")

    requests = lifecycle_requests(cfg, 8, [4, 6, 8])
    # warmed: every step captured before the counted serve
    kw = dict(mode="fused", scheduler="continuous", batch_size=LANES,
              prompt_len=PROMPT, max_len=SV.MAX_LEN, bank_size=4, device=dev,
              warmup=True)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        t0 = time.perf_counter()
        dep = Deployment(model, base, root_dir=root, **kw)
        assert dep.publish("task", dm) == 1
        secs["publish"] = time.perf_counter() - t0
        full_bytes = dep.store.artifact_bytes("task", 1)
        zero_counters()
        t0 = time.perf_counter()
        served = {"v1": lifecycle_serve(dep, cfg, requests)}
        torch.cuda.synchronize()
        secs["serve v1"] = time.perf_counter() - t0
        launches = counters()
        m = dep.metrics
        assert launches["bitlinear_axes_banked"] == 7 * SERVE_LAYERS * (
            m["prefills"] + m["decode_steps"]), (launches, m)
        t0 = time.perf_counter()
        assert dep.update("task", update) == 2
        secs["update"] = time.perf_counter() - t0
        patch_bytes = dep.store.artifact_bytes("task", 2)
        assert dep.store.version_info("task", 2)["kind"] == "patch"
        t0 = time.perf_counter()
        served["v2"] = lifecycle_serve(dep, cfg, requests)
        secs["serve v2"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        assert dep.rollback("task") == 1
        secs["rollback"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        served["rollback"] = lifecycle_serve(dep, cfg, requests)
        secs["serve rollback"] = time.perf_counter() - t0
        stats = dict(dep.stats)
        del dep
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dep = Deployment(model, base, root_dir=root, **kw)
        secs["restart"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        served["restart"] = lifecycle_serve(dep, cfg, requests)
        secs["serve restart"] = time.perf_counter() - t0
        del dep
        gc.collect()
        torch.cuda.empty_cache()
    dep = Deployment(model, base, **kw)               # no store
    dep.publish("task", dm)
    served["no store"] = lifecycle_serve(dep, cfg, requests)
    del dep, dm, update
    gc.collect()
    peak = torch.cuda.max_memory_allocated()

    def toks(run):
        return [t for t, _ in served[run]]
    versions = {run: [v for _, v in served[run]] for run in served}
    assert versions["v1"] == [None, 1] * 4 and versions["v2"] == [None, 2] * 4
    assert versions["rollback"] == versions["restart"] == versions["v1"]
    assert toks("v1") == toks("no store"), "store vs in-memory tokens"
    assert toks("rollback") == toks("v1") and toks("restart") == toks("v1")
    changed = sum(a != b for a, b in zip(toks("v1"), toks("v2")))
    print(f"lifecycle: artifact {full_bytes} B vs fp16 checkpoint "
          f"{fp16_bytes} B ({fp16_bytes / full_bytes:.2f}x smaller); patch "
          f"{patch_bytes} B ({patch_bytes / full_bytes:.4f} of the full "
          f"artifact); seconds {({k: round(v, 3) for k, v in secs.items()})}"
          f"; peak device memory {peak / 1e9:.2f} GB; registry {stats}")
    print(f"lifecycle: store-served tokens == in-memory tokens (8 requests, "
          f"{sum(map(len, toks('v1')))} tokens); rollback and restart serve "
          f"v1's tokens; v2 changed {changed} of 8 requests; serve launches "
          f"{launches}")
    del model, base
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def lifecycle_reference_phase(dev) -> None:
    """The lifecycle at reduced widths (fp32 compute): one calibrated
    DeltaModel (calibrated on the CPU), published, served, updated by patch
    and rolled back through a store on the card and on the CPU; every
    stage's tokens must be identical."""
    import dataclasses
    import tempfile

    from repro_torch.core import calibration as C
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import serve as SV
    from repro_torch.models import build_model
    from repro_torch.models.param import split
    from repro_torch.serving import Deployment

    cfg = dataclasses.replace(SV.make_config(ARCH, reduced=True),
                              num_layers=2, compute_dtype="float32")
    model = build_model(cfg)
    base, _ = split(model.init(0, device="cpu"))
    ft = SV.fine_tune(base, 100)
    src = SyntheticLM(cfg.vocab_size, seed=7)
    dm, _ = C.calibrate_transformer(
        model, base, ft, [src.lm_batch(1000 + i, 4, 32) for i in range(2)],
        epochs=2, e2e_epochs=2, lr=1e-3, e2e_lr=1e-3)
    update = attention_refresh(base, ft, seed=200)
    requests = lifecycle_requests(cfg, 6, [2, 5, 3])
    served = {}
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    for where in ("cpu", dev):
        with tempfile.TemporaryDirectory(dir=build) as root:
            zero_counters()
            dep = Deployment(model, base, root_dir=root, batch_size=4,
                             prompt_len=SV.PROMPT_LEN, max_len=SV.MAX_LEN,
                             bank_size=4, device=where)
            dep.publish("task", dm)
            runs = [lifecycle_serve(dep, cfg, requests)]
            dep.update("task", update)
            runs.append(lifecycle_serve(dep, cfg, requests))
            dep.rollback("task")
            runs.append(lifecycle_serve(dep, cfg, requests))
            restart = Deployment(model, base, root_dir=root, batch_size=4,
                                 prompt_len=SV.PROMPT_LEN,
                                 max_len=SV.MAX_LEN, bank_size=4,
                                 device=where)
            runs.append(lifecycle_serve(restart, cfg, requests))
            served[str(where)] = runs
            if str(where) != "cpu":
                assert counters()["bitlinear_axes_banked"] > 0, counters()
    assert served["cpu"] == served[str(dev)], served
    print(f"reference lifecycle: card tokens and versions == cpu at publish, "
          f"update (patch), rollback and restart "
          f"({sum(len(t) for run in served['cpu'] for t, _ in run)} tokens)")


# ---------------------------------------------------------------------------
# async admission (serving/admission): ingest, staging and a between-step
# commit while lanes decode through graph replays
# ---------------------------------------------------------------------------

ADMIT_BASE_BUDGET = 200   # each base request; two base lanes kept busy
ADMIT_BUDGET = 16         # each variant request
ADMIT_STEADY = 20         # steps served before the publish


def admission_traffic(dep, cfg, name, dm, update) -> dict:
    """The admission phase's traffic on one deployment, served one step at
    a time (``drain(max_steps=1)``) with the control-plane calls between
    steps.  A warm variant (``update``, registered in memory) is admitted
    first: a base row decodes through the banked kernel once the bank
    holds a variant and through the plain matmuls before, so both twins
    must switch before the measured traffic.  Then two base lanes decode ``ADMIT_BASE_BUDGET``-token
    requests, each followed by the next (queued a step before it
    finishes), until the end of the traffic; after ``ADMIT_STEADY`` steps ``dm`` is published as
    ``name`` (a full artifact) and requested, and once that request is
    done ``update`` is published (an attention-only patch) and requested
    again.  Every step records its gap (from its call to its end, so an
    inline load at the top of the loop counts), whether an admission was
    in flight, whether its loop ran a prefill and whether it committed a
    staged version.  Returns the tokens, the step record and the
    timings."""
    rng = np.random.default_rng(23)
    dep.registry.set_version("warm", 1, update)
    rid = dep.submit(rng.integers(1, cfg.vocab_size, size=8), variant="warm",
                     max_new_tokens=2)
    dep.drain()
    assert dep.result(rid).status == "done", dep.result(rid).error
    eng, adm = dep.engine, dep.admission
    steps0, m0 = dict(dep.status()["steps"]), dict(dep.metrics)
    adm0 = dict(adm.stats) if adm else {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    eng.record_step_times, eng.step_times = True, []
    steps = []          # (gap s, decode call s, busy, prefill, commit)
    base, variant = [], []          # rids
    out = {"first": {}, "publish_s": {}, "admit_step": {}}
    plan = [("publish", dm), ("update", update)]

    def base_prompt(i):
        return np.random.default_rng(1000 + i).integers(1, cfg.vocab_size,
                                                         size=8)
    while True:
        if plan and (not variant and len(steps) >= ADMIT_STEADY or
                     variant and dep.status(variant[-1])["status"] ==
                     "done"):
            kind, payload = plan.pop(0)
            t0 = time.perf_counter()
            v = (dep.publish(name, payload) if kind == "publish"
                 else dep.update(name, payload))
            t1 = time.perf_counter()
            variant.append(dep.submit(rng.integers(1, cfg.vocab_size,
                                                   size=8),
                                      variant=name,
                                      max_new_tokens=ADMIT_BUDGET))
            out["publish_s"][kind], out[kind] = t1 - t0, (v, t1)
        if not plan and dep.status(variant[-1])["status"] == "done":
            break
        # two base lanes at every step: a request that retires in this
        # step has its successor queued already, so the step's loop admits
        # it (a loop with no live lane would wait on the pipeline instead
        # of stepping, and no base lane would decode through the ingest)
        while sum(dep.status(r)["status"] != "done" and ADMIT_BASE_BUDGET
                  - dep.status(r)["tokens_generated"] > 1
                  for r in base) < 2:
            base.append(dep.submit(base_prompt(len(base)),
                                   max_new_tokens=ADMIT_BASE_BUDGET))
        p0, c0 = dep.metrics["prefills"], dep.metrics["async_admits"]
        before = [dep.status(r)["status"] for r in variant]
        t0 = time.perf_counter()
        dep.drain(max_steps=1)
        t_end, dt, busy = eng.step_times[-1]
        steps.append((t_end - t0, dt, busy, dep.metrics["prefills"] > p0,
                      dep.metrics["async_admits"] > c0))
        for r, was, kind in zip(variant, before, ("publish", "update")):
            if was in ("queued", "admitting") and \
                    dep.status(r)["status"] != was:
                out["admit_step"][kind] = len(steps) - 1
    dep.drain()
    torch.cuda.synchronize()
    eng.record_step_times = False
    for r in base:
        req = dep.result(r)
        assert req.status == "done" and \
            len(req.out_tokens) == ADMIT_BASE_BUDGET, (req.status,
                                                       len(req.out_tokens))
    for (kind, _), r in zip((("publish", 0), ("update", 0)), variant):
        req = dep.result(r)
        v, t1 = out[kind]
        assert req.status == "done" and len(req.out_tokens) == ADMIT_BUDGET
        assert dep.status(r)["version"] == v == (1 if kind == "publish"
                                                 else 2), (kind, v)
        assert all(0 <= t < cfg.padded_vocab for t in req.out_tokens)
        out["first"][kind] = req.first_token_at - t1
    st, m = dep.status()["steps"], dep.metrics
    out.update(
        base_tokens=[dep.result(r).out_tokens for r in base],
        tokens=[dep.result(r).out_tokens for r in variant],
        steps=steps, launches=counters(),
        captures=st["compiles"] - steps0["compiles"],
        replays=st["cache_hits"] - steps0["cache_hits"],
        decode_steps=m["decode_steps"] - m0["decode_steps"],
        prefills=m["prefills"] - m0["prefills"],
        async_admits=m["async_admits"] - m0["async_admits"],
        commits=(adm.stats["commits"] - adm0["commits"] if adm else 0),
        stage_s=(adm.stats["stage_seconds"] - adm0["stage_seconds"]
                 if adm else 0.0),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def admission_phase(dev) -> dict:
    """Async admission at full width (qwen3-8b, 4 layers, 4 lanes, a
    4-slot bank, graphed continuous scheduler warmed up, a store under
    ``build/``): the same traffic (``admission_traffic``) served by a
    synchronous twin (the variant loads inline, on the serving thread) and
    an async one (``async_admission=True``).  Prints, per twin, the steady
    base-lane step (the median over steps with no prefill, no commit and
    no admission in flight), each admission step (the request's prefill,
    and the inline load or the commit) and the longest step against it,
    the decode calls, publish-to-first-token and update-to-first-token,
    peak device memory and, for the async twin, the steps with an ingest
    in flight, the staging seconds, the staging pool's counters and peak
    pinned bytes.  Then the hard checks: every request finished with its
    budget, the twins' tokens identical (the base requests both served
    and the variant requests), at least one async step with an admission
    in flight, no capture after warmup and one replay a step, every async
    bank admission committed by the pipeline, 28 banked launches a prefill
    and a step.  Returns each twin's launches."""
    import tempfile

    from repro_torch.core import calibration as C
    from repro_torch.launch import serve as SV
    from repro_torch.serving import Deployment

    cfg = SV.make_config(ARCH, num_layers=SERVE_LAYERS)
    model, base, _ = SV.build_variants(cfg, 0, dev)
    ft = SV.fine_tune(base, 110)
    dm = C.compress(base, ft)
    update = attention_refresh(base, ft, seed=210)
    del ft
    gc.collect()
    torch.cuda.empty_cache()
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    runs = {}
    with tempfile.TemporaryDirectory(dir=build) as root:
        for mode in ("sync", "async"):
            t0 = time.perf_counter()
            dep = Deployment(
                model, base, root_dir=root, mode="fused",
                scheduler="continuous", batch_size=LANES, prompt_len=PROMPT,
                max_len=PROMPT + ADMIT_BASE_BUDGET + 8, bank_size=4,
                device=dev, warmup=True, async_admission=mode == "async")
            setup = time.perf_counter() - t0
            run = admission_traffic(dep, cfg, f"task-{mode}", dm, update)
            run["setup_s"] = setup
            if dep.admission is not None:
                run["pool"] = dict(dep.admission.pool.stats)
                run["bank_admits"] = dep.registry.bank.stats["admits"]
                run["all_commits"] = dep.admission.stats["commits"]
                run["all_async_admits"] = dep.metrics["async_admits"]
            dep.close()
            del dep
            gc.collect()
            torch.cuda.empty_cache()
            runs[mode] = run
    card = card_line()
    for mode, run in runs.items():
        gap, call, busy, prefill, commit = (np.array(c) for c in
                                            zip(*run["steps"]))
        quiet = ~busy & ~prefill & ~commit
        steady = float(np.median(gap[quiet]))
        worst = int(np.argmax(gap))
        admits = ", ".join(
            f"{kind} {gap[i] * 1e3:.3f} ms (x{gap[i] / steady:.2f})"
            for kind, i in run["admit_step"].items())
        extra = ""
        if mode == "async":
            pool = run["pool"]
            ingest = gap[busy & ~prefill & ~commit]
            extra = (f"; {int(busy.sum())} of {len(gap)} steps with an "
                     f"admission in flight; of those with no prefill and "
                     f"no commit ({len(ingest)}) the longest "
                     f"{ingest.max() * 1e3:.3f} ms "
                     f"(x{ingest.max() / steady:.2f}), median "
                     f"{np.median(ingest) * 1e3:.3f} ms; stage_seconds "
                     f"{run['stage_s']:.3f} for 2 versions; staging pool "
                     f"{pool}, peak pinned {pool['peak_bytes']} B")
        print(f"admission {mode}: {len(gap)} steps, {len(run['base_tokens'])}"
              f" base requests; steady base-lane step (median, "
              f"{int(quiet.sum())} steps) {steady * 1e3:.3f} ms; the "
              f"admission steps (the request's prefill included): {admits};"
              f" longest step {gap[worst] * 1e3:.3f} ms (step {worst}, "
              f"x{gap[worst] / steady:.2f}; the JAX benchmark's stall gate "
              f"is < 2x); decode call median {np.median(call) * 1e3:.3f} "
              f"ms, longest {call.max() * 1e3:.3f}; publish-to-first-token "
              f"{run['first']['publish']:.3f} s (publish call "
              f"{run['publish_s']['publish']:.3f} s), update-to-first-token "
              f"{run['first']['update']:.3f} s (update call "
              f"{run['publish_s']['update']:.3f} s); setup "
              f"{run['setup_s']:.3f} s; captures after warmup "
              f"{run['captures']}, replays {run['replays']} = steps "
              f"{run['decode_steps']}; async_admits {run['async_admits']}; "
              f"peak device memory {run['peak_gb']:.2f} GB; launches "
              f"{run['launches']}{extra}; card {card}")
    sync, asy = runs["sync"], runs["async"]
    n = min(len(sync["base_tokens"]), len(asy["base_tokens"]))
    for what, a, b in (("base", sync["base_tokens"][:n],
                        asy["base_tokens"][:n]),
                       ("variant", sync["tokens"], asy["tokens"])):
        differ = [(i, j) for i, (x, y) in enumerate(zip(a, b))
                  for j, (p, q) in enumerate(zip(x, y)) if p != q]
        assert a == b and not differ, (what, differ[:8])
    for mode, run in runs.items():
        assert run["captures"] == 0, (mode, run["captures"])
        assert run["replays"] == run["decode_steps"], (mode, run)
        assert run["launches"]["bitlinear_axes_banked"] == 7 * SERVE_LAYERS * (
            run["prefills"] + run["decode_steps"]), (mode, run["launches"])
    assert any(busy for _, _, busy, _, _ in asy["steps"]), \
        "no step overlapped an admission"
    assert asy["async_admits"] == asy["commits"] == 2, asy["commits"]
    assert asy["all_async_admits"] == asy["all_commits"] == \
        asy["bank_admits"], (asy["all_commits"], asy["bank_admits"])
    assert sync["async_admits"] == 0
    print(f"admission: async tokens == sync tokens ({n} base requests of "
          f"{ADMIT_BASE_BUDGET} tokens, 2 variant requests of "
          f"{ADMIT_BUDGET}); no capture after warmup; "
          f"{asy['commits']} commits through the pipeline")
    del model, base, dm, update
    gc.collect()
    torch.cuda.empty_cache()
    return {f"admission {mode}": run["launches"] for mode, run in runs.items()}


def admission_reference_phase(dev) -> None:
    """Reduced qwen3-8b (2 layers, fp32 compute) through a store: the
    admission traffic (a warm variant, base lanes, a published variant
    requested while they decode, then a patch) served with async admission
    on the card and synchronously on the CPU, with the continuous and the
    speculative scheduler; tokens and versions must be identical and the
    card run must commit both versions through the pipeline."""
    import dataclasses
    import tempfile

    from repro_torch.core import calibration as C
    from repro_torch.launch import serve as SV
    from repro_torch.models import build_model
    from repro_torch.models.param import split
    from repro_torch.serving import Deployment

    cfg = dataclasses.replace(SV.make_config(ARCH, reduced=True),
                              num_layers=2, compute_dtype="float32")
    model = build_model(cfg)
    base, _ = split(model.init(0, device="cpu"))
    ft = SV.fine_tune(base, 110, scale=0.05)
    dm = C.compress(base, ft)
    update = attention_refresh(base, ft, seed=210, scale=0.02)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    for scheduler in ("continuous", "speculative"):
        served = {}
        for where in ("cpu", dev):
            with tempfile.TemporaryDirectory(dir=build) as root:
                zero_counters()
                dep = Deployment(model, base, root_dir=root,
                                 scheduler=scheduler, batch_size=4,
                                 prompt_len=SV.PROMPT_LEN,
                                 max_len=SV.PROMPT_LEN + 64, bank_size=4,
                                 device=where, draft_k=SPEC_K,
                                 async_admission=where != "cpu")
                rng = np.random.default_rng(5)
                dep.publish("warm", dm, wait=True)
                rids = [dep.submit(rng.integers(1, cfg.vocab_size, size=8),
                                   max_new_tokens=40) for _ in range(2)]
                dep.drain(max_steps=2)
                for kind, payload in (("publish", dm), ("update", update)):
                    if kind == "publish":
                        dep.publish("task", payload)
                    else:
                        dep.update("task", payload)
                    rids.append(dep.submit(
                        rng.integers(1, cfg.vocab_size, size=8),
                        variant="task", max_new_tokens=6))
                    # decoding before the next pointer move, in both runs
                    while dep.status(rids[-1])["status"] in ("queued",
                                                             "admitting"):
                        dep.drain(max_steps=1)
                    dep.drain(max_steps=3)
                dep.drain()
                served[str(where)] = [(dep.result(r).out_tokens,
                                       dep.status(r)["version"])
                                      for r in rids]
                if where != "cpu":
                    launched = counters()["bitlinear_axes_banked"]
                    commits = dep.admission.stats["commits"]
                dep.close()
        assert served["cpu"] == served[str(dev)], (scheduler, served)
        assert [v for _, v in served["cpu"]] == [None, None, 1, 2]
        assert launched > 0 and commits == 3, (launched, commits)
        print(f"reference admission {scheduler}: async on the card == sync "
              f"on the cpu, tokens and versions "
              f"({sum(len(t) for t, _ in served['cpu'])} tokens, 3 commits, "
              f"{launched} banked launches)")


# ---------------------------------------------------------------------------
# the training side (train/step, train/loop, checkpoint/manager,
# distributed/compression): reduced card-vs-CPU parity, then the paper's
# pipeline at full width on a pair the port trained itself
# ---------------------------------------------------------------------------

TRAIN_REF = ("qwen3-8b", "deepseek-moe-16b")
# one layer (two until the mesh phase served speculative decoding): the
# checkpoint's bytes are the vocab's tables and their Adam moments, and a
# layer less writes and reads 2.3 GB less
TRAIN_LAYERS = 1
TRAIN_BATCH, TRAIN_SEQ = 2, 512
TRAIN_STEPS, TRAIN_RESUME = 4, 2   # the base: preempted after 2, resumed
FT_STEPS = 3
# Adam's first steps move every weight by about lr along its gradient's
# sign, so a pre-activation at d_model 4096 moves by up to ~4096·lr: 1e-3
# overshoots (loss 12.4 -> 23.4 on the card), 1e-4 falls
TRAIN_LR = dict(peak_lr=1e-4, warmup=1)
# calibration's Adam moves each scale by about lr a step, and the
# fine-tune's deltas are about 3e-4 (3 Adam steps near 1e-4), where the
# default lr (1e-4) was sized for the 0.005 synthetic fine-tunes: the lr of
# each mode (per-axis, scalar) is picked by the logit MSE on a tuning batch
# that is not the reported held-out one
TRAIN_CAL_LRS = (1e-4, 1e-5, 1e-6)
# a backward pass, card vs CPU: max |diff| <= tol · max |CPU result|.  The
# sums run in another order; in bf16 a rounding of an intermediate (p, dS,
# the rows' coefficients) may flip by one step, which moves its products
# at the scale of the tensor, not of the element: fp32 1e-5, bf16 one bf16
# step (2^-7) of the tensor's largest entry
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def grad_within(got, want, dtype) -> tuple[bool, float]:
    """(max |got - want| <= BWD_TOL[dtype] · max |want|, that ratio)."""
    got, want = got.detach().cpu().float(), want.detach().float()
    ratio = ((got - want).abs().max() / want.abs().max()).item()
    return ratio <= BWD_TOL[dtype], ratio
def _grads(fn, inputs, dout, device) -> list:
    leaves = [t.detach().to(device).requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    out.backward(dout.to(device))
    return [out] + [t.grad for t in leaves]


def _state_to(state, device):
    """A TrainState's tensors copied to ``device``."""
    import dataclasses

    from repro_torch.tree import tree_map
    return dataclasses.replace(
        state, params=tree_map(lambda t: t.to(device), state.params),
        opt=dataclasses.replace(state.opt, mu=tree_map(
            lambda t: t.to(device), state.opt.mu), nu=tree_map(
                lambda t: t.to(device), state.opt.nu)))


def _states_equal(a, b) -> bool:
    """Every leaf of two TrainStates equal bit for bit (compared on the
    CPU when the two sit on different devices)."""
    from repro_torch.checkpoint.manager import _flat
    fa, fb = _flat(a), _flat(b)
    if list(fa) != list(fb):
        return False
    for k, x in fa.items():
        y = fb[k]
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x.to(y.device), y):
                return False
        elif x != y:
            return False
    return True


def train_reference_phase(dev) -> None:
    """The training side reduced, card against CPU: qwen3-8b and
    deepseek-moe-16b (fp32 compute, 2 layers) take 3 train steps from the
    same initial params on each; losses within 1e-5 rel, params within
    1e-3 abs (Adam's first steps move a weight whose gradient sits at
    rounding noise by up to 2·lr, 5e-3 here).  The flash and RMSNorm
    backward passes at qwen3-8b's shapes, card against CPU: the flash
    output within ``FLASH_TOL``, each gradient within ``BWD_TOL`` of its
    tensor's largest entry.  A checkpoint
    written from the card restores on the CPU bit for bit."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import serve as SV
    from repro_torch.models import attention as AT
    from repro_torch.models import build_model
    from repro_torch.models import layers as LY
    from repro_torch.train import step as TS

    full = SV.make_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    hq, hkv, hd = full.num_heads, full.num_kv_heads, full.head_dim
    for dtype in (torch.float32, torch.bfloat16):
        for shape, scale_shape in (((2, 512, full.d_model), (full.d_model,)),
                                   ((2, 512, hq, hd), (hd,))):
            x = torch.randn(shape, generator=gen).to(dtype)
            scale = 1 + 0.1 * torch.randn(scale_shape, generator=gen)
            dy = torch.randn(shape, generator=gen).to(dtype)

            def rms(a, s):
                return LY.rmsnorm(a, s, full.norm_eps)
            want = _grads(rms, (x, scale), dy, "cpu")
            got = _grads(rms, (x, scale), dy, dev)
            errs = []
            for name, g, w in zip(("y", "dx", "dscale"), got, want):
                ok, err = grad_within(g, w, dtype)
                assert ok, ("rmsnorm", dtype, scale_shape, name, err)
                errs.append(f"{name} {err:.2e}")
            print(f"train reference: rmsnorm backward {str(dtype)[6:]} "
                  f"x {shape} scale {scale_shape}: card == cpu, max |diff| "
                  f"/ max |cpu| {', '.join(errs)} (limit {BWD_TOL[dtype]})")
        for case in (dict(causal=True), dict(causal=False),
                     dict(causal=True, window=100, chunk=128),
                     dict(causal=True, kv_offset=64, chunk=128)):
            q = torch.randn((1, 512, hq, hd), generator=gen).to(dtype)
            k, v = (torch.randn((1, 512, hkv, hd), generator=gen).to(dtype)
                    for _ in range(2))
            do = torch.randn(q.shape, generator=gen).to(dtype)

            def flash(*a):
                return AT.flash_attention(*a, **case)
            want = _grads(flash, (q, k, v), do, "cpu")
            got = _grads(flash, (q, k, v), do, dev)
            ok, err, _ = flash_within(got[0].detach().cpu(), want[0])
            assert ok, ("flash forward", dtype, case, err)
            errs = [f"o {err:.2e} (FLASH_TOL)"]
            for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
                ok, err = grad_within(g, w, dtype)
                assert ok, ("flash", dtype, case, name, err)
                errs.append(f"{name} {err:.2e}")
            print(f"train reference: flash backward {str(dtype)[6:]} "
                  f"S=T=512 {case}: card == cpu, max |diff| / max |cpu| "
                  f"{', '.join(errs)} (limit {BWD_TOL[dtype]})")

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    for arch in TRAIN_REF:
        cfg = dataclasses.replace(SV.make_config(arch, reduced=True),
                                  num_layers=2, compute_dtype="float32")
        model = build_model(cfg)
        init = TS.init_train_state(model, 0, "cpu")
        src = SyntheticLM(cfg.vocab_size, seed=0)
        batches = [src.lm_batch(i, 2, 32) for i in range(3)]
        runs = {}
        for where in ("cpu", dev):
            state = _state_to(init, where)
            step = TS.make_train_step(model, peak_lr=5e-3, warmup=2,
                                      total_steps=10)
            losses = []
            for batch in batches:
                state, m = step(state, batch)
                losses.append(m["loss"].item())
            runs[str(where)] = (losses, state)
        (cpu_l, cpu_s), (card_l, card_s) = runs["cpu"], runs[str(dev)]
        np.testing.assert_allclose(card_l, cpu_l, rtol=1e-5)
        from repro_torch.checkpoint.manager import _flat
        perr = max((a.cpu() - _flat(cpu_s.params)[k]).abs().max().item()
                   for k, a in _flat(card_s.params).items())
        assert perr <= 1e-3, (arch, perr)
        with tempfile.TemporaryDirectory(dir=build) as ckdir:
            CheckpointManager(ckdir).save(3, card_s)
            step_n, restored = CheckpointManager(ckdir).restore_latest(
                cpu_s)
        assert step_n == 3 and _states_equal(card_s, restored), arch
        print(f"train reference {arch}: 3 steps, losses card {card_l} cpu "
              f"{cpu_l}; max |param diff| {perr:.3g}; a checkpoint written "
              f"from the card restores on the cpu bit for bit")


def _timed_io(mgr, log: list):
    """Time ``mgr``'s saves and restores into ``log`` as (verb, step,
    seconds, bytes on disk)."""
    save, restore = mgr.save, mgr.restore

    def timed_save(step, state, *a, **kw):
        t0 = time.perf_counter()
        path = save(step, state, *a, **kw)
        log.append(("save", step, time.perf_counter() - t0,
                    (path / "arrays.npz").stat().st_size))
        return path

    def timed_restore(step, template):
        t0 = time.perf_counter()
        out = restore(step, template)
        torch.cuda.synchronize()
        log.append(("restore", step, time.perf_counter() - t0, None))
        return out
    mgr.save, mgr.restore = timed_save, timed_restore
    return mgr


def _recorded_saves(mgr, log: list):
    """``mgr``'s saves are logged into ``log`` as ("recorded save", step,
    0.0, None) and write nothing.  The card's machine takes 45 GiB of disk
    writes a call, and serialising and hashing a full-width state takes
    about 45 s on its host, so the train phase writes one full-width
    checkpoint (19.6 GB: the save path and its time) and records the
    Trainer's other saves."""
    def recorded_save(step, state, *a, **kw):
        log.append(("recorded save", step, 0.0, None))
    mgr.save = recorded_save
    return mgr


def _val_mse(report: dict) -> float:
    """A calibration report's held-out val MSE summed over modules and
    layers: the chosen axis's (the smaller of row and col) per matrix."""
    return float(sum(min(v) if isinstance(v, (tuple, list)) else v
                     for per_layer in report["val_mse"].values()
                     for v in per_layer))


def train_phase(dev) -> dict:
    """The paper's pipeline on a pair the port trains itself, at full
    width: qwen3-8b, ``TRAIN_LAYERS`` layers, bf16 compute, remat on,
    batch ``TRAIN_BATCH`` x ``TRAIN_SEQ``.  An uninterrupted
    ``make_train_step`` loop of ``TRAIN_STEPS`` on SyntheticLM(seed=0);
    the same through ``Trainer`` with 1-bit gradient compression (loss
    must fall); then the base through ``Trainer``, preempted after
    ``TRAIN_RESUME`` steps (its checkpoint, the one the phase writes to
    disk, restored must equal the saved state bit for bit) and resumed to
    ``TRAIN_STEPS`` (the losses compared with the uninterrupted loop's:
    bit-exact, else within 1e-4 rel); the compressed and the resumed
    runs' end-of-run saves are ``_recorded_saves`` (the card's machine
    takes 45 GiB of disk writes a call);
    ``FT_STEPS`` of fine-tuning on SyntheticLM(seed=7); calibration of the
    trained pair per-axis and scalar (BitDelta), each at its best lr of
    ``TRAIN_CAL_LRS`` on a tuning batch, printed; the variant
    published into a store under ``build/`` and served through the
    continuous scheduler over the fp32 base and over an int8 base (banked
    launches counted, every budget exact; greedy agreement printed).
    Prints the step's median time and tokens/s, its split into forward +
    backward and the AdamW update, peak device memory, checkpoint bytes,
    save and restore seconds, and the disk free before the first save.
    Removes its checkpoints and store at the end.  Returns the serving
    runs' launches."""
    import dataclasses
    import shutil
    import statistics
    import tempfile

    from repro_torch.core import calibration as C
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import serve as SV
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.train import step as TS
    from repro_torch.train.loop import LoopConfig, Trainer

    cfg = SV.make_config(ARCH, num_layers=TRAIN_LAYERS)
    assert cfg.remat and cfg.compute_dtype == "bfloat16"
    model = build_model(cfg)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    lcfg = LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_RESUME,
                      batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0,
                      **TRAIN_LR)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    ios: list = []
    secs = {}
    with tempfile.TemporaryDirectory(dir=build) as root:
        free = shutil.disk_usage(root).free
        print(f"train: disk free before the first save {free / 1e9:.1f} GB "
              f"under {build}")

        # 1. the uninterrupted loop, and a step split into its two halves
        t0 = time.perf_counter()
        state = TS.init_train_state(model, 0, dev)
        n_params = sum(t.numel() for t in C.flatten_params(
            state.params).values())
        step = TS.make_train_step(model, total_steps=TRAIN_STEPS, **TRAIN_LR)
        src = SyntheticLM(cfg.vocab_size, seed=0)
        ref_losses, ref_s, ref_gn = [], [], []
        for i in range(TRAIN_STEPS):
            batch = src.lm_batch(i, TRAIN_BATCH, TRAIN_SEQ)
            t1 = time.perf_counter()
            state, m = step(state, batch)
            ref_losses.append(m["loss"].item())
            ref_s.append(time.perf_counter() - t1)
            ref_gn.append(m["grad_norm"].item())
        # the one-card run the mesh phase's full-width training is held to
        TRAIN_ONE_CARD[ARCH] = dict(
            losses=ref_losses[:MESH_TRAIN_FULL_STEPS],
            grad_norm=ref_gn[:MESH_TRAIN_FULL_STEPS])
        loss_fn = TS.make_loss_fn(model)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, _, grads = TS.value_and_grad(loss_fn, state.params, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        adamw_update(state.params, grads, state.opt, lr=cosine_schedule(
            state.step, TRAIN_LR["warmup"], TRAIN_STEPS,
            TRAIN_LR["peak_lr"]), weight_decay=0.1)
        torch.cuda.synchronize()
        split = (t2 - t1, time.perf_counter() - t2)
        del state, grads, m
        gc.collect()
        torch.cuda.empty_cache()
        secs["loop"] = time.perf_counter() - t0
        med = statistics.median(ref_s[1:])
        print(f"train: {n_params} parameters; uninterrupted loop losses "
              f"{ref_losses}; step s {[round(s, 4) for s in ref_s]}: median "
              f"{1e3 * med:.1f} ms after the first, "
              f"{tokens_per_step / med:.0f} tokens/s; one step split: "
              f"forward + backward {1e3 * split[0]:.1f} ms, AdamW update "
              f"{1e3 * split[1]:.1f} ms")

        # 2. 1-bit gradient compression with error feedback
        t0 = time.perf_counter()
        comp = Trainer(model, os.path.join(root, "compress"),
                       dataclasses.replace(lcfg, grad_compress=True,
                                           ckpt_every=100), device=dev)
        _recorded_saves(comp.ckpt, ios)
        res_c = comp.run()
        assert res_c["losses"][-1] < res_c["losses"][0], res_c["losses"]
        del comp, res_c["state"]
        gc.collect()
        torch.cuda.empty_cache()
        secs["compressed"] = time.perf_counter() - t0
        print(f"train: grad_compress losses {res_c['losses']} (fall: held)")

        # 3. the base: preempted, restored bit for bit, resumed
        t0 = time.perf_counter()
        ckdir = os.path.join(root, "base")
        first = Trainer(model, ckdir, lcfg, device=dev)
        _timed_io(first.ckpt, ios)
        res1 = first.run(interrupt_at=TRAIN_RESUME)
        assert res1["interrupted"] and res1["completed"] == TRAIN_RESUME
        del first
        second = Trainer(model, ckdir, lcfg, device=dev)
        # the resumed run's restore is held against the saved state, which
        # is dropped right after, before the run's steps
        saved = {"state": res1.pop("state")}
        restore = second.ckpt.restore

        def checked_restore(step, template):
            out = restore(step, template)
            assert _states_equal(out, saved.pop("state")), "restore != saved"
            return out
        second.ckpt.restore = checked_restore
        _recorded_saves(_timed_io(second.ckpt, ios), ios)
        res2 = second.run()
        assert not saved, "the resumed run restored nothing"
        assert res2["completed"] == TRAIN_STEPS and not res2["interrupted"]
        got = res1["losses"] + res2["losses"]
        exact = got == ref_losses
        np.testing.assert_allclose(got, ref_losses, rtol=1e-4)
        secs["preempt+resume"] = time.perf_counter() - t0
        trainer_s = res1["step_seconds"] + res2["step_seconds"]
        print(f"train: preempted after step {TRAIN_RESUME}, the checkpoint "
              f"restored == the saved state bit for bit; resumed losses "
              f"{got} vs uninterrupted {ref_losses}: "
              f"{'bit-exact' if exact else 'within 1e-4 rel, not bit-exact'}"
              f"; trainer step s {[round(t, 4) for t in trainer_s]}")

        # 4. the fine-tune, continuing the optimizer as the quickstart does
        t0 = time.perf_counter()
        state = res2["state"]
        base = state.params
        step = TS.make_train_step(model, total_steps=TRAIN_STEPS + FT_STEPS,
                                  **TRAIN_LR)
        ft_src = SyntheticLM(cfg.vocab_size, seed=7)
        ft_losses = []
        for i in range(FT_STEPS):
            state, m = step(state, ft_src.lm_batch(i, TRAIN_BATCH,
                                                   TRAIN_SEQ))
            ft_losses.append(m["loss"].item())
        ft = state.params
        del state, m, res2
        gc.collect()
        torch.cuda.empty_cache()
        counts = counters()
        assert not any(counts.values()), counts   # no kernel on the step
        train_peak = torch.cuda.max_memory_allocated()
        secs["fine-tune"] = time.perf_counter() - t0
        print(f"train: fine-tune losses {ft_losses}; peak device memory "
              f"while training {train_peak / 1e9:.2f} GB; kernel launches "
              f"during training {counts}")

    by_verb = {v: [r for r in ios if r[0] == v]
               for v in ("save", "recorded save", "restore")}
    (_, _, save_s, nbytes), = by_verb["save"]
    print(f"train: checkpoint {nbytes} B written once, in {save_s:.2f} s "
          f"({nbytes / save_s / 1e9:.2f} GB/s); the compressed and the "
          f"resumed runs' end-of-run saves recorded at steps "
          f"{[r[1] for r in by_verb['recorded save']]}; restores "
          f"{[round(r[2], 2) for r in by_verb['restore']]} s (the "
          f"resumed trainer's, sha-checked); checkpoint removed")

    # 5. calibration of the trained pair: per-axis, then scalar (BitDelta),
    # each at the lr that does best on the tuning batch
    t0 = time.perf_counter()
    batches = [ft_src.lm_batch(1000 + i, LANES, 64) for i in range(2)]

    def logit_mse(index: int):
        batch = {"tokens": torch.from_numpy(ft_src.lm_batch(
            index, LANES, 64)["tokens"]).to(dev).long()}
        with torch.no_grad():
            teacher = T.forward(ft, batch, cfg)[0].float()

        def mse(dm) -> float:
            with torch.no_grad():
                out = T.forward(C.apply_delta(base, dm), batch, cfg)[0]
                return float(((teacher - out.float()) ** 2).mean())
        return mse
    tune_mse, held_out = logit_mse(5000), logit_mse(9999)
    tuned = {}
    for scalar in (False, True):
        runs = []
        for lr in TRAIN_CAL_LRS:
            dm_lr, rep_lr = C.calibrate_transformer(
                model, base, ft, batches, epochs=1, e2e_epochs=1,
                scalar=scalar, lr=lr, e2e_lr=lr)
            runs.append((tune_mse(dm_lr), lr, dm_lr, rep_lr))
        tuned[scalar] = min(runs, key=lambda r: r[0])
        print(f"train calibrate lr ({'scalar' if scalar else 'per-axis'}):"
              f" tuning-batch logit MSE "
              f"{ {r[1]: float(f'{r[0]:.6g}') for r in runs} } (stage 0 "
              f"{tune_mse(C.compress(base, ft)):.6g}); lr {tuned[scalar][1]}"
              f" chosen")
        del runs
    (_, lr_axis, dm, rep), (_, lr_scalar, dm_s, rep_s) = tuned[False], \
        tuned[True]
    mse0, mse_axis, mse_scalar = (held_out(C.compress(base, ft)),
                                  held_out(dm), held_out(dm_s))
    del tuned, tune_mse, held_out, dm_s, ft
    gc.collect()
    torch.cuda.empty_cache()
    secs["calibrate x6"] = time.perf_counter() - t0
    axes = {p: "".join(a[0] for a in v) for p, v in rep["axis"].items()}
    print(f"train calibrate (trained pair): axes {axes}; held-out val MSE "
          f"summed over modules per-axis {_val_mse(rep):.6g} vs scalar "
          f"{_val_mse(rep_s):.6g}; held-out logit MSE stage 0 {mse0:.6g}, "
          f"per-axis {mse_axis:.6g} (lr {lr_axis}), scalar {mse_scalar:.6g} "
          f"(lr {lr_scalar}); e2e losses "
          f"per-axis {rep['e2e_losses']} scalar {rep_s['e2e_losses']} "
          f"(recorded, not gated)")

    # 6. publish and serve the trained variant, over fp32 and int8 bases
    t0 = time.perf_counter()
    tokens, launches = {}, {}
    with tempfile.TemporaryDirectory(dir=build) as store:
        for label, kw in (("trained continuous", dict(root_dir=store)),
                          ("trained continuous int8",
                           dict(base_dtype="int8"))):
            t1 = time.perf_counter()
            dep = SV.deploy(model, base, [dm], mode="fused",
                            scheduler="continuous", batch=LANES,
                            bank_size=4, device=dev, **kw)
            torch.cuda.synchronize()
            tokens[label], launches[label] = drive(
                dep, cfg, label, 8, [4, 6, 8], time.perf_counter() - t1)
            m = dep.metrics
            assert launches[label]["bitlinear_axes_banked"] == \
                7 * TRAIN_LAYERS * (m["prefills"] + m["decode_steps"]), (
                    launches[label], m)
            assert m["admitted"] == m["retired"] == 8, m
            dep.close()
            del dep
            gc.collect()
            torch.cuda.empty_cache()
    fp, q8 = tokens["trained continuous"], tokens["trained continuous int8"]
    same = sum(a == b for ra, rb in zip(fp, q8) for a, b in zip(ra, rb))
    total = sum(len(r) for r in fp)
    secs["serve x2"] = time.perf_counter() - t0
    print(f"train serve: the trained variant published into a store and "
          f"served with base lanes, every budget exact; int8 vs fp32 base "
          f"greedy agreement {same}/{total} = {same / total:.4f} over the "
          f"served prompts (recorded, not gated); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; seconds "
          f"{({k: round(v, 2) for k, v in secs.items()})}")
    del model, base, dm
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the other decoder archs: deepseek-7b, starcoder2-3b, gemma3-12b (ring
# caches), deepseek-moe-16b and moonshot-v1-16b-a3b (MoE)
# ---------------------------------------------------------------------------

NEW_ARCHS = ("deepseek-7b", "starcoder2-3b", "gemma3-12b",
             "deepseek-moe-16b", "moonshot-v1-16b-a3b")
ENCDEC_VLM = ("whisper-base", "internvl2-76b")
RECURRENT = ("xlstm-350m", "zamba2-7b")
# reduced reference phase: layers (gemma3: its [local, global] pattern once;
# MoE: the dense first layer and two expert layers; xlstm: one super-block
# of 3 mLSTM + 1 sLSTM; zamba: 2 applications of the shared block and a
# trailing Mamba2 block, the reduced defaults) and a padded prompt of 20
# tokens, past gemma3's reduced window of 16, so its ring wraps in prefill
# and again in decode (and one chunk of 20 in mLSTM and SSD)
REF_LAYERS = {"deepseek-moe-16b": 3, "moonshot-v1-16b-a3b": 3,
              "xlstm-350m": 4, "zamba2-7b": 7}
REF_PROMPT = 20
# one reduced arch per family (qwen3-8b in the reference phase) also runs
# the speculative scheduler in the reference phases
SPEC_REF = ("deepseek-moe-16b", "internvl2-76b", "whisper-base",
            "xlstm-350m", "zamba2-7b")


def stacked_ms(cfg) -> tuple:
    """An expert's rows in the stacked GEMM: the main path's, the capacity
    of one group of a decode step's ``LANES`` tokens (1) and of a
    ``LANES`` x ``PROMPT`` prefill (7, the streaming kernel's 8-row tier),
    and beside them 4 (the 4-row tier) and 120 (a 4 x 256-token prefill,
    the tiled kernel)."""
    from repro_torch.models.moe import capacity
    return tuple(sorted({capacity(LANES, cfg), capacity(LANES * PROMPT, cfg),
                         4, capacity(LANES * 256, cfg)}))


def recurrent_shapes(cfg) -> list:
    """The distinct (N, K) of xlstm's or zamba's overlaid projections:
    xlstm's w_up (also w_gate, sLSTM's w_zi and w_if), wq (wk, wv),
    mLSTM's w_if (2 x heads rows), w_down, w_ff1 and w_ff2 (K = 1344);
    zamba's w_z (w_xc), w_bc, w_dt, w_out (the shared wq, wk, wv too: K =
    2d), the shared wo and MLP."""
    d = cfg.d_model
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import slstm_ffn
        f = slstm_ffn(d)
        return [("w_up", 2 * d, d), ("wq", 2 * d, 2 * d),
                ("mlstm w_if", 2 * cfg.num_heads, 2 * d),
                ("w_down", d, 2 * d), ("w_ff1", 2 * f, d),
                ("w_ff2", d, f)]
    return [("w_z", 2 * d, d), ("w_bc", 2 * cfg.ssm_state, d),
            ("w_dt", cfg.ssm_heads, d), ("w_out", d, 2 * d),
            ("shared wo", d, cfg.q_dim), ("shared w_gate", cfg.d_ff, d),
            ("shared w_down", d, cfg.d_ff)]


def arch_shapes(cfg) -> list:
    """The distinct (N, K) of an arch's overlaid 2-D projections:
    attention and the dense MLP (whisper's w_in / w_out); for an MoE arch
    the dense MLP of its first layers and its shared experts' MLP (the
    expert stacks are the stacked GEMM's); the recurrent families'
    ``recurrent_shapes``."""
    if cfg.family in ("ssm", "hybrid"):
        return recurrent_shapes(cfg)
    d = cfg.d_model
    mlps = [("", cfg.d_ff)]
    if cfg.family == "moe":
        mlps = ([("dense ", cfg.d_ff)] if cfg.moe_first_dense else []) + [
            ("shared ", cfg.expert_d_ff * cfg.num_shared_experts)]
    w_in, w_out = ("w_in", "w_out") if cfg.family == "audio" else (
        "w_gate", "w_down")
    seen, out = set(), []
    for name, n, k in (("wq", cfg.q_dim, d), ("wk", cfg.kv_dim, d),
                       ("wo", d, cfg.q_dim),
                       *((f"{pre}{w}", nk[0], nk[1]) for pre, ff in mlps
                         for w, nk in ((w_in, (ff, d)),
                                       (w_out, (d, ff))))):
        if (n, k) not in seen:
            seen.add((n, k))
            out.append((name, n, k))
    return out


VLM_LAYERS, VLM_PROMPT = 2, 32   # internvl2-76b: depth cut, padded prompt


def prefill_rows(cfg) -> int:
    """A lane's rows in a prefill's delta GEMMs: the padded prompt;
    whisper's encoder frames (its encoder and cross-attention wk/wv); a
    VLM's image prefix and prompt."""
    if cfg.family == "audio":
        return cfg.encoder_frames
    if cfg.family == "vlm":
        return cfg.num_image_tokens + VLM_PROMPT
    return PROMPT


def arch_kernel_phase(dev, timer) -> dict:
    """``bitlinear_axes`` at M=4 and at the prefill's rows (4 lanes x
    ``prefill_rows``: 64; whisper-base 6000, internvl2-76b 1152) and the
    banked GEMM at M=4 ([0,1,2,1]) and at those rows (lanes on [0,1,2,1])
    at every distinct projection shape of the new archs (moonshot-v1-16b-a3b
    has deepseek-moe-16b's widths), over an fp32 and an int8 base, each
    held against its plain version with the GEMM bound and timed beside it
    (single-variant: and ``torch.matmul`` over a built Ŵ); K of 11008,
    3840, 2816, 1408 and xlstm's 1344 are no whole number of the streaming
    kernel's warp steps, xlstm's mLSTM w_if (N = 8) and zamba's w_dt (112)
    and w_bc (128) are the narrowest N, and internvl2-76b's w_down (K =
    28672) splits K 56 ways in the banked GEMM at 1152 rows.  Returns
    {kernel body: rows}."""
    from repro_torch.configs import get_config
    from repro_torch.core import delta as D
    from repro_torch.core import quantize as Q

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rows = {name: [] for name in ("bitlinear_axes", "bitlinear_axes_q8",
                                  "bitlinear_axes_banked",
                                  "bitlinear_axes_banked_q8")}
    for arch in NEW_ARCHS[:4] + ENCDEC_VLM + RECURRENT:
        cfg = get_config(arch)
        per_lane = prefill_rows(cfg)
        for name, n, k in arch_shapes(cfg):
            label = f"{arch} {name}"
            wb = torch.randn((3, n, k), generator=gen, device=dev) * k ** -0.5
            delta = torch.randn((3, n, k), generator=gen, device=dev) * 0.005
            packed = D.pack_signs(D.sign_mask(delta))
            v_row = D.init_scale(delta, "row")
            v_col = D.init_scale(delta, "col")
            del delta
            qw = Q.quantize_weight(wb[0])
            p0 = packed[0].contiguous()
            for suffix, layer0 in (("", wb[0].contiguous()), ("_q8", qw)):
                rows["bitlinear_axes" + suffix] += axes_rows(
                    label, n, k, gen, dev, timer, p0, v_row[0], layer0,
                    ms=(LANES, LANES * per_lane))
                rows["bitlinear_axes_banked" + suffix] += banked_rows(
                    label, n, k, gen, dev, timer, packed, v_row, v_col,
                    layer0, only=("M=4",), prefill=per_lane)
            del wb, qw, packed, v_row, v_col, p0
            torch.cuda.empty_cache()
    print_rows(rows, " (other archs)")
    print("arch kernels: every GEMM within 1e-5 relative at "
          + ", ".join(f"{len(r)} shapes ({k})" for k, r in rows.items()))
    return rows


def stacked_phase(dev, timer) -> dict:
    """``bitlinear_axes_stacked_p`` over deepseek-moe-16b's expert stacks
    (E=64: w_gate/w_up 1408 x 2048, w_down 2048 x 1408; half the experts
    row-scaled, half col-scaled) at M in ``stacked_ms`` rows per expert,
    bf16 x, over an fp32 and an int8 base: one launch per call (counter),
    held against its plain version with the GEMM bound per expert, timed
    beside the plain version and ``torch.bmm`` over a pre-built fp32 Ŵ
    stack (the yardstick: one PyTorch call for the same product).  Returns
    {kernel body: rows}."""
    from repro_torch.configs import get_config
    from repro_torch.core import delta as D
    from repro_torch.core import quantize as Q
    from repro_torch.kernels import bitlinear as BL

    cfg = get_config("deepseek-moe-16b")
    e, f, d = cfg.num_experts, cfg.expert_d_ff, cfg.d_model
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    rows = {"bitlinear_axes_stacked": [], "bitlinear_axes_stacked_q8": []}
    for name, n, k in (("w_gate", f, d), ("w_down", d, f)):
        wb = torch.randn((e, n, k), generator=gen, device=dev) * k ** -0.5
        delta = torch.randn((e, n, k), generator=gen, device=dev) * 0.005
        packed = D.pack_signs(D.sign_mask(delta))
        use_row = (torch.arange(e, device=dev) % 2 == 0)[:, None]
        v_row = torch.where(use_row, D.init_scale(delta, "row"), 0.0).to(
            torch.float16)
        v_col = torch.where(use_row, 0.0, D.init_scale(delta, "col")).to(
            torch.float16)
        del delta
        qw = Q.quantize_weight(wb)
        signs = D.unpack_signs(packed, k)
        for suffix, base in (("", wb), ("_q8", qw)):
            wq, ws, wf, base_bytes = _base(base)
            w_hat = (v_row.float()[:, :, None] + v_col.float()[:, None, :]
                     ) * signs + wf
            w_abs_t = w_hat.abs().transpose(1, 2)
            for m in stacked_ms(cfg):
                x = torch.randn((e, m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                before = BL.stacked_launches
                got = BL.bitlinear_axes_stacked_p(x, packed, v_row, v_col,
                                                  wq, ws)
                torch.cuda.synchronize()
                assert BL.stacked_launches == before + 1
                want = BL.plain_stacked(x.float(), packed, v_row, v_col, wq,
                                        w_scale=ws)
                scale = torch.bmm(x.float().abs(), w_abs_t)
                err = (got - want).abs().max().item()
                assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6
                             ).all()), (name, m, suffix, err)
                del got, want, scale
                x32 = x.float()
                w_hat_t = w_hat.transpose(1, 2)
                nbytes = (x.numel() * 2 + packed.numel()
                          + (v_row.numel() + v_col.numel()) * 2 + base_bytes
                          + e * m * n * 4)
                rows["bitlinear_axes_stacked" + suffix].append({
                    "shape": f"deepseek-moe-16b {name} E={e} M={m} N={n} "
                             f"K={k}", "m": m, "proj": name,
                    "max_abs_err": err,
                    "ms": timer.ms(lambda: BL.bitlinear_axes_stacked_p(
                        x, packed, v_row, v_col, wq, ws), reps=20, warmup=3),
                    "plain_ms": timer.ms(lambda: BL.plain_stacked(
                        x, packed, v_row, v_col, wq, w_scale=ws), reps=3,
                        warmup=1),
                    **bound(nbytes, 2 * e * m * n * k + _build_flops(
                        e * n, k, ws is not None)),
                    "library_ms": timer.ms(lambda: torch.bmm(x32, w_hat_t),
                                           reps=20, warmup=3)})
            del w_hat, w_abs_t
        del wb, qw, packed, v_row, v_col, signs
        torch.cuda.empty_cache()
    print_rows(rows, " (library_ms: torch.bmm over a built Ŵ stack)")
    print(f"stacked: {sum(map(len, rows.values()))} cases within 1e-5 "
          "relative of the plain version, one launch each")
    return rows


def arch_reference_phase(dev) -> None:
    """Each new arch reduced, fp32 compute: group fused and continuous over
    an fp32 and an int8 base (whisper-base, xlstm-350m and zamba2-7b:
    group dense too), card kernels against the CPU plain versions
    (``reference_runs``); tokens identical.  gemma3's 20-token padded
    prompt and budgets up to 5 run past its reduced window of 16;
    internvl2-76b's caches hold its 8 image tokens besides; whisper-base's
    16 stub frames run through its 2 encoder layers; the recurrent archs
    carry their states past the prompt (one chunk of 20)."""
    import dataclasses

    from repro_torch.core import calibration as C
    from repro_torch.launch import serve as SV
    from repro_torch.models import build_model
    from repro_torch.models.param import split
    from repro_torch.serving import Deployment

    for arch in NEW_ARCHS + ENCDEC_VLM + RECURRENT:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(SV.make_config(arch, reduced=True),
                                  num_layers=REF_LAYERS.get(arch, 2),
                                  compute_dtype="float32")
        model = build_model(cfg)
        base, _ = split(model.init(0, device="cpu"))
        dms = [C.compress(base, SV.fine_tune(base, 100 + i))
               for i in range(2)]
        runs = [("group", "fused", 4), ("continuous", "fused", [2, 5, 3, 4])]
        if cfg.family in ("audio", "ssm", "hybrid"):
            runs.insert(0, ("group", "dense", 4))
        if arch in SPEC_REF:
            runs.append(("speculative", "fused", [2, 5, 3, 4]))
        reference_runs(dev, model, base, dms, runs, REF_PROMPT,
                       SV.cache_len(cfg, REF_PROMPT, SV.MAX_LEN))
        if cfg.local_global_pattern:
            try:
                Deployment(model, base, speculative=True, device=dev)
            except ValueError as e:
                assert "windowless" in str(e), e
                print(f"reference {arch}: speculative Deployment refused "
                      f"({e})")
            else:
                raise AssertionError(f"{arch}: a speculative Deployment "
                                     "over ring caches was accepted")
        print(f"reference {arch}: {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def gemms_checked():
    """Inside the block every launch of the three fused delta GEMMs is held
    against its plain version on the same operands, to the GEMM bound
    1e-5 · Σ|x||Ŵ| + 1e-6 (Ŵ of the row's own bank slot or expert):
    whatever routing a run took, each kernel is checked at the shapes the
    path gave it.  The checks launch no kernel.  Yields a list of
    (kernel, x shape, max |err|), one per launch; a launch over an int8
    base names its body with ``_q8``."""
    from repro_torch.core import delta as D
    from repro_torch.kernels import bitlinear as BL

    log = []
    kernels = {name: getattr(BL, name) for name in (
        "bitlinear_axes_p", "bitlinear_axes_banked_p",
        "bitlinear_axes_stacked_p")}

    def w_abs(packed, v_row, v_col, wq, ws):
        wf = wq.float() if ws is None else wq.float() * ws.float()[..., None]
        return ((v_row.float()[..., :, None] + v_col.float()[..., None, :])
                * D.unpack_signs(packed, wq.shape[-1]) + wf).abs()

    def held(name, x, got, want, scale, w_scale):
        name += "_q8" if w_scale is not None else ""
        diff = (got - want).abs()
        err = diff.max().item()
        assert bool((diff <= 1e-5 * scale + 1e-6).all()), (
            name, tuple(x.shape), err)
        log.append((name, tuple(x.shape), err))
        return got

    def axes(x, packed, v_row, v_col, wq, w_scale=None):
        got = kernels["bitlinear_axes_p"](x, packed, v_row, v_col, wq,
                                          w_scale=w_scale)
        want = BL.plain(x.float(), packed, v_row, v_col, wq, w_scale=w_scale)
        scale = x.float().abs() @ w_abs(packed, v_row, v_col, wq,
                                        w_scale).T
        return held("bitlinear_axes", x, got, want, scale, w_scale)

    def banked(x, vidx, packed, v_row, v_col, wq, w_scale=None):
        # an id outside the bank would trap the kernel: hold it first
        assert 0 <= int(vidx.min()) and int(vidx.max()) < packed.shape[0], (
            vidx.tolist(), packed.shape[0])
        got = kernels["bitlinear_axes_banked_p"](x, vidx, packed, v_row,
                                                 v_col, wq, w_scale=w_scale)
        want = BL.plain_banked(x.float(), vidx, packed, v_row, v_col, wq,
                               w_scale=w_scale)
        scale = torch.zeros_like(want)
        for v in vidx.unique().tolist():
            scale = torch.where(vidx[:, None] == v, x.float().abs() @ w_abs(
                packed[v], v_row[v], v_col[v], wq, w_scale).T, scale)
        return held("bitlinear_axes_banked", x, got, want, scale, w_scale)

    def stacked(x, packed, v_row, v_col, wq, w_scale=None):
        got = kernels["bitlinear_axes_stacked_p"](x, packed, v_row, v_col,
                                                  wq, w_scale=w_scale)
        want = BL.plain_stacked(x.float(), packed, v_row, v_col, wq,
                                w_scale=w_scale)
        scale = torch.bmm(x.float().abs(), w_abs(
            packed, v_row, v_col, wq, w_scale).transpose(1, 2))
        return held("bitlinear_axes_stacked", x, got, want, scale, w_scale)

    BL.bitlinear_axes_p, BL.bitlinear_axes_banked_p = axes, banked
    BL.bitlinear_axes_stacked_p = stacked
    try:
        yield log
    finally:
        for name, fn in kernels.items():
            setattr(BL, name, fn)


@contextlib.contextmanager
def stacked_captured():
    """Inside the block every launch of the stacked GEMM runs as usual and
    leaves its operands in the yielded list: (x copied, then the weight
    operands by reference, which the caller's model keeps alive)."""
    from repro_torch.kernels import bitlinear as BL

    log = []
    kernel = BL.bitlinear_axes_stacked_p

    def stacked(x, packed, v_row, v_col, wq, w_scale=None):
        log.append((x.clone(), packed, v_row, v_col, wq, w_scale))
        return kernel(x, packed, v_row, v_col, wq, w_scale=w_scale)

    BL.bitlinear_axes_stacked_p = stacked
    try:
        yield log
    finally:
        BL.bitlinear_axes_stacked_p = kernel


def routed_row(tag, proj, ops, timer, seed) -> dict:
    """A captured stacked launch replayed on its own operands: held to the
    GEMM bound against the plain version; its dead experts' outputs (all-0
    rows of x) exactly 0 and its live ones bit-equal to a launch in which
    the dead rows hold random values; timed beside the plain version and
    ``torch.bmm`` over a built fp32 Ŵ stack.  Its bound counts the live
    experts' weights; the full stack's bound rides beside it."""
    from repro_torch.core import delta as D
    from repro_torch.kernels import bitlinear as BL

    x, packed, v_row, v_col, wq, ws = ops
    e, m, k = x.shape
    n = wq.shape[1]
    live = x.reshape(e, -1).ne(0).any(1)
    n_live = int(live.sum())
    got = BL.bitlinear_axes_stacked_p(x, packed, v_row, v_col, wq, ws)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    filled = torch.where(live[:, None, None], x, torch.randn(
        x.shape, generator=gen, device=x.device).to(x.dtype))
    again = BL.bitlinear_axes_stacked_p(filled, packed, v_row, v_col, wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(got[~live], torch.zeros_like(got[~live])), tag
    assert torch.equal(got[live], again[live]), tag
    del filled, again
    wf = wq.float() if ws is None else wq.float() * ws.float()[..., None]
    w_hat = (v_row.float()[:, :, None] + v_col.float()[:, None, :]) \
        * D.unpack_signs(packed, k) + wf
    del wf
    want = BL.plain_stacked(x.float(), packed, v_row, v_col, wq, w_scale=ws)
    scale = torch.bmm(x.float().abs(), w_hat.abs().transpose(1, 2))
    err = (got - want).abs().max().item()
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all()), (
        tag, proj, err)
    del got, want, scale
    per_expert = (wq.element_size() * n * k + packed[0].numel()
                  + (v_row[0].numel() + v_col[0].numel())
                  * v_row.element_size() + (2 * n if ws is not None else 0))
    io = x.numel() * x.element_size() + e * m * n * 4

    def bound_of(experts):
        return bound(experts * per_expert + io,
                     2 * experts * m * n * k + _build_flops(
                         experts * n, k, ws is not None))

    x32, w_hat_t = x.float(), w_hat.transpose(1, 2)
    row = {"shape": f"deepseek-moe-16b {tag} {proj} E={e} M={m} N={n} K={k} "
                    f"live={n_live}",
           "m": m, "proj": proj, "routed": tag, "live": n_live,
           "max_abs_err": err,
           "ms": timer.ms(lambda: BL.bitlinear_axes_stacked_p(
               x, packed, v_row, v_col, wq, ws), reps=20, warmup=3),
           "plain_ms": timer.ms(lambda: BL.plain_stacked(
               x, packed, v_row, v_col, wq, w_scale=ws), reps=3, warmup=1),
           **bound_of(n_live),
           "full_bound_ms": bound_of(e)["bound_ms"],
           "library_ms": timer.ms(lambda: torch.bmm(x32, w_hat_t), reps=20,
                                  warmup=3)}
    del w_hat, w_hat_t, x32
    return row


def routed_phase(dep, model, cfg, dev, label, continuous) -> list:
    """The stacked launches of the first expert layer, as the main path
    routes them, replayed (``routed_row``): the group fused pass of one
    prefill (LANES x PROMPT tokens: capacity 7) and one decode step
    (capacity 1), or the four slot passes of one continuous decode step
    over a mixed batch [0, v0, v1, v0] (the fourth slot no lane names)."""
    from repro_torch.launch import serve as SV

    if continuous:
        slots = [dep.registry.bank_resolve(v) for v in ("v0", "v1")]
        vidx = torch.tensor([0, slots[0], slots[1], slots[0]],
                            dtype=torch.int32, device=dev)
        params, overlay = dep.registry.base_params, dep.registry.bank.tree
        passes = dep.registry.bank.size
    else:
        vidx = None
        params, overlay = dep.registry.resolve("v0")
        passes = 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (LANES, SV.PROMPT_LEN),
                                     generator=gen, device=dev)}
    with stacked_captured() as pre:
        _, cache = model.prefill(params, batch, SV.MAX_LEN, overlay=overlay,
                                 variant_idx=vidx)
    tok = torch.randint(1, cfg.vocab_size, (LANES,), generator=gen,
                        device=dev, dtype=torch.int32)
    with stacked_captured() as dec:
        model.decode_step(params, tok, cache, overlay=overlay,
                          variant_idx=vidx)
    torch.cuda.synchronize()
    del cache
    run = "continuous" if continuous else "fused"
    captured = [("decode", dec)] + ([] if continuous else [("prefill", pre)])
    timer = Timer(dev)
    rows = []
    for step, log in captured:
        assert len(log) % (3 * passes) == 0, (step, len(log))
        for i, ops in enumerate(log[:3 * passes]):
            tag = f"{run} {step}" + (f" slot {i // 3}" if continuous else "")
            rows.append(routed_row(tag, EXPERT_PROJ[i % 3], ops, timer,
                                   seed=i))
    del pre, dec, timer, params, overlay
    torch.cuda.empty_cache()
    print(f"{label}: routed stacked launches of the first expert layer "
          f"(live experts of 64): "
          + ", ".join(f"{r['routed']} {r['proj']} {r['live']}"
                      for r in rows)
          + "; dead outputs exactly 0, live ones bit-equal with the dead "
          "rows filled")
    return rows


EXPERT_PROJ = ("w_gate", "w_up", "w_down")   # an expert pass's launch order


def serve_checks(dep, model, cfg, dev, label, prompt_len, max_len,
                 continuous: bool, repeat: bool = False,
                 stats=None) -> list:
    """After a full-width run: the fused prefill through the kernels (one
    batch, on the card; continuous: the bank over a mixed vidx), each of
    its delta GEMM launches held to the GEMM bound against its plain
    version on the same operands (``gemms_checked``), its logits beside
    the same prefill through the plain versions; with ``repeat`` the
    prefill is run again and must give the same logits bit for bit.  Then
    one decode step under the profiler (device-busy time, idle share;
    ``stats["busy_ms"]`` receives the busy time).  Returns the checked
    launches."""
    from repro_torch.kernels import ops as K
    from repro_torch.serving.engine import frontend_stub

    m = dep.metrics
    step_ms = 1e3 * m["decode_seconds"] / max(m["decode_steps"], 1)
    if continuous:
        slots = [dep.registry.bank_resolve(v) for v in ("v0", "v1")]
        vidx = torch.tensor([0, slots[0], slots[1], slots[0]],
                            dtype=torch.int32, device=dev)
        params, overlay = dep.registry.base_params, dep.registry.bank.tree
        label = f"{label} mixed (vidx {vidx.tolist()})"
    else:
        vidx = None
        params, overlay = dep.registry.resolve("v0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (LANES, prompt_len),
                                     generator=gen, device=dev),
             **frontend_stub(cfg, LANES, dev)}
    with gemms_checked() as checked:
        got, _ = model.prefill(params, batch, max_len, overlay=overlay,
                               variant_idx=vidx)
        torch.cuda.synchronize()
    assert checked, label
    if repeat:
        again, _ = model.prefill(params, batch, max_len, overlay=overlay,
                                 variant_idx=vidx)
        assert torch.equal(got, again), (
            label, (got.float() - again.float()).abs().max().item())
        del again
    with K.plain_versions():
        want, _ = model.prefill(params, batch, max_len, overlay=overlay,
                                variant_idx=vidx)
    assert bool(torch.isfinite(got).all()) and got.shape == (
        LANES, cfg.padded_vocab), got.shape
    errs = {}
    for name, shape, err in checked:
        errs.setdefault(name, []).append(err)
    print(f"{label}: fused prefill ({LANES} x {prompt_len} tokens, rows "
          f"{sorted({shape[-2] for _, shape, _ in checked})}): "
          + ", ".join(f"{len(e)} {n} launches within the GEMM bound (max "
                      f"|err| {max(e):.3g})" for n, e in errs.items())
          + (", a repeat bit-identical" if repeat else "")
          + f"; logits vs plain versions: max |diff| = "
          f"{(got.float() - want.float()).abs().max().item():.4g} (max "
          f"|logit| = {want.float().abs().max().item():.4g})")
    del got, want
    busy = profile_decode(model, params, overlay, dev, label, step_ms,
                          vidx=vidx, prompt_len=prompt_len, max_len=max_len)
    if stats is not None:
        stats["busy_ms"] = busy
    del params, overlay
    return checked


def long_requests(dep, cfg, n: int, budgets, lo: int, hi: int) -> list:
    """``n`` prompts of ``lo``..``hi`` random tokens round-robin over base,
    v0 and v1, budgets cycled; returns the request ids."""
    rng = np.random.default_rng(12)
    names = dep.variants()
    return [dep.submit(rng.integers(1, cfg.vocab_size,
                                    size=int(rng.integers(lo, hi + 1))),
                       variant=names[i % len(names)],
                       max_new_tokens=budgets[i % len(budgets)])
            for i in range(n)]


# gemma3-12b at full width, one 5:1 period: prompts of 1100-1300 tokens
# (padded to 1300), so every local layer's 1024-slot ring wraps in the
# prefill, and budgets of 8-16.
GEMMA_LAYERS, GEMMA_BUDGETS = 6, [8, 12, 16, 10, 14, 9]
GEMMA_PROMPTS = (1100, 1300)


def gemma3_phase(dev) -> dict:
    """gemma3-12b, full width, 6 layers (one period: 5 local layers with a
    1024-slot ring, one global), 2 variants, continuous serving over a bank
    of 4 slots, over an fp32 and an int8 base.  Memory, reckoned before
    the run (fp32): base 9.4 GB (the tied 262144 x 3840 table 4.0 GB);
    each variant's DeltaModel about 2.2 GB (its fp16 table); the bank holds
    every slot's table as an fp32 extra, 4 x 4.0 GB; the continuous step
    casts each slot's table to bf16 (2.0 GB at a time); prefill logits of
    4 x 1300 positions 2.7 GB: about 40 GB at peak, under the card's 80.
    The measured peaks are printed.  Returns {run: launches}."""
    from repro_torch.launch import serve as SV
    from repro_torch.models.transformer import layer_pattern

    cfg = SV.make_config("gemma3-12b", num_layers=GEMMA_LAYERS)
    prompt_len = GEMMA_PROMPTS[1]
    max_len = prompt_len + max(GEMMA_BUDGETS)
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, base, dms = SV.build_variants(cfg, 2, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"gemma3-12b: {GEMMA_LAYERS} layers, windows "
          f"{[e['window'] for e in layer_pattern(cfg)]}, setup "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    for base_dtype in ("fp", "int8"):
        label = f"gemma3-12b continuous {base_dtype}"

        def deploy(graphs=True, base_dtype=base_dtype):
            return SV.deploy(model, base, dms, mode="fused",
                             scheduler="continuous", batch=LANES,
                             bank_size=4, device=dev, base_dtype=base_dtype,
                             prompt_len=prompt_len, max_len=max_len,
                             graphs=graphs)
        t0 = time.perf_counter()
        dep = deploy()
        torch.cuda.synchronize()
        graphed = {}
        tokens, launches[label] = drive(
            dep, cfg, label, 6, GEMMA_BUDGETS, time.perf_counter() - t0,
            prompt_range=GEMMA_PROMPTS, stats=graphed)
        m = dep.metrics
        assert launches[label]["bitlinear_axes_banked"] == \
            7 * GEMMA_LAYERS * (m["prefills"] + m["decode_steps"]), \
            launches[label]
        assert m["admitted"] == m["retired"] == 6, m
        serve_checks(dep, model, cfg, dev, label, prompt_len, max_len,
                     continuous=True, stats=graphed)
        del dep
        gc.collect()
        torch.cuda.empty_cache()
        if base_dtype == "fp":
            eager_twin(deploy, cfg, label, 6, GEMMA_BUDGETS, tokens,
                       graphed, prompt_range=GEMMA_PROMPTS)
    del model, base, dms
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# deepseek-moe-16b: the dense first layer and one expert layer (cut from
# 4 to keep the script inside its time limit once the mesh phase served
# an int8 base)
MOE_LAYERS = 2


def moe_phase(dev) -> dict:
    """deepseek-moe-16b, full width (64 experts, top-6, capacity 1.25, two
    shared experts), ``MOE_LAYERS`` layers, 2 variants: group fused and
    continuous (a bank of 4 slots), over an fp32 and an int8 base.
    Memory, reckoned before the run (fp32) at 4 layers: base 8.8 GB (the
    three expert layers 6.6 GB);
    the bank's extras (both tables and the routers) 4 x 1.7 GB; under 30
    GB at peak.  The stacked expert GEMM must launch in every run: at
    decode with 4 lanes each expert gets capacity 1 (M=1), at a 4 x 16
    prefill 7 rows; the prefill's launches must have the rows
    ``stacked_phase`` checked.  After each run its stacked launches are
    captured and replayed as routed (``routed_phase``).  Returns ({run:
    launches}, {kernel body: routed rows})."""
    from repro_torch.launch import serve as SV

    cfg = SV.make_config("deepseek-moe-16b", num_layers=MOE_LAYERS)
    launches = {}
    routed = {"bitlinear_axes_stacked": [], "bitlinear_axes_stacked_q8": []}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, base, dms = SV.build_variants(cfg, 2, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"deepseek-moe-16b: {MOE_LAYERS} layers, setup peak_mem_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    n_moe = MOE_LAYERS - cfg.moe_first_dense
    for base_dtype in ("fp", "int8"):
        for scheduler in ("group", "continuous"):
            run = "fused" if scheduler == "group" else "continuous"
            label = f"deepseek-moe-16b {run}" + (
                " int8" if base_dtype == "int8" else "")

            def deploy(graphs=True, scheduler=scheduler,
                       base_dtype=base_dtype):
                return SV.deploy(model, base, dms, mode="fused",
                                 scheduler=scheduler, batch=LANES,
                                 bank_size=4, device=dev,
                                 base_dtype=base_dtype, graphs=graphs)
            t0 = time.perf_counter()
            dep = deploy()
            torch.cuda.synchronize()
            budgets = [8] if scheduler == "group" else CONT_BUDGETS
            graphed = {}
            tokens, launches[label] = drive(
                dep, cfg, label, 8, budgets,
                time.perf_counter() - t0 + setup_s, stats=graphed)
            got = launches[label]
            m = dep.metrics
            calls = m["prefills"] + m["decode_steps"]
            # three stacked GEMMs per expert layer per pass; the continuous
            # step runs one pass per bank slot, every call; the group
            # scheduler's base batches run no overlay
            per_call = 3 * n_moe * (4 if scheduler == "continuous" else 1)
            stacked = got["bitlinear_axes_stacked"]
            if scheduler == "continuous":
                assert stacked == per_call * calls, (got, calls)
            else:
                assert 0 < stacked < per_call * calls and \
                    stacked % per_call == 0, (got, calls)
            assert got[RUN_KERNEL[run]] > 0, got
            checked = serve_checks(
                dep, model, cfg, dev, label, SV.PROMPT_LEN, SV.MAX_LEN,
                continuous=scheduler == "continuous", repeat=True,
                stats=graphed)
            ms = {shape[1] for name, shape, _ in checked
                  if name.removesuffix("_q8") == "bitlinear_axes_stacked"}
            assert ms and ms <= set(stacked_ms(cfg)), (ms, stacked_ms(cfg))
            routed["bitlinear_axes_stacked" + (
                "_q8" if base_dtype == "int8" else "")] += routed_phase(
                dep, model, cfg, dev, label, scheduler == "continuous")
            del dep
            gc.collect()
            torch.cuda.empty_cache()
            if scheduler == "continuous" and base_dtype == "fp":
                eager_twin(deploy, cfg, label, 8, budgets, tokens, graphed)
    del model, base, dms
    gc.collect()
    torch.cuda.empty_cache()
    print_rows(routed, " routed (library_ms: torch.bmm over the full built Ŵ"
               " stack)")
    return launches, routed


def whisper_launches(cfg) -> tuple:
    """(delta GEMM launches per prefill, per decode step) of whisper with
    every projection overlaid: the encoder's six projections a layer; the
    decoder's ten a layer in the forward plus the cross-attention's wk/wv
    again for the cache; a decode step's eight a layer (the cross K/V come
    from the cache)."""
    return (6 * cfg.encoder_layers + 12 * cfg.num_layers,
            8 * cfg.num_layers)


def chunk_prefill(model, params, dev) -> None:
    """One whisper-base prefill of the base (4 lanes, 16 tokens, 1500 stub
    frames) timed with the port's 500-key chunks for the non-causal
    attention (``attention.even_chunk``) and with the JAX module's 4-key
    ones (``_pick_chunk`` halving 512), median of 3 on the host clock
    after a warm-up; the logits of the two are printed side by side."""
    from repro_torch.launch import serve as SV
    from repro_torch.models import attention as A
    from repro_torch.serving.engine import frontend_stub

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    batch = {"tokens": torch.randint(1, model.cfg.vocab_size,
                                     (LANES, SV.PROMPT_LEN), generator=gen,
                                     device=dev),
             **frontend_stub(model.cfg, LANES, dev)}
    even = A.even_chunk
    out = {}
    try:
        for name, chunker in (("500-key", even),
                              ("jax 4-key", lambda t, chunk=512:
                               A._pick_chunk(t, chunk))):
            A.even_chunk = chunker
            secs = []
            for _ in range(4):
                t0 = time.perf_counter()
                logits, _ = model.prefill(params, batch, SV.cache_len(
                    model.cfg))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            out[name] = (float(np.median(secs[1:])), logits)
    finally:
        A.even_chunk = even
    (s_ours, ours), (s_jax, theirs) = out.values()
    print(f"whisper-base base prefill ({LANES} x {SV.PROMPT_LEN} tokens, "
          f"{model.cfg.encoder_frames} frames): 500-key chunks "
          f"{s_ours:.4f} s, the JAX module's 4-key chunks {s_jax:.4f} s; "
          f"max |logit diff| {(ours.float() - theirs.float()).abs().max().item():.4g} "
          f"(max |logit| {theirs.float().abs().max().item():.4g})")


# whisper-base's encoder and decoder layers in its phase (of 6 each: cut
# to keep the script inside its time limit)
WHISPER_LAYERS = 2


def whisper_phase(dev) -> dict:
    """whisper-base at full width, ``WHISPER_LAYERS`` encoder and decoder
    layers (1500 zero frames a lane from the engine's stub), 2 variants,
    4 lanes: first ``chunk_prefill``, then ``six_runs`` (the continuous
    runs count ``whisper_launches`` a prefill and a step; the checked
    prefill's launches take 6000 rows at the encoder and the
    cross-attention's wk/wv).  Memory: the fp32 base is 0.28 GB.  Returns
    {run: launches}."""
    from repro_torch.launch import serve as SV

    import dataclasses
    cfg = dataclasses.replace(SV.make_config("whisper-base"),
                              num_layers=WHISPER_LAYERS,
                              encoder_layers=WHISPER_LAYERS)
    per_prefill, per_step = whisper_launches(cfg)
    t0 = time.perf_counter()
    model, base, dms = SV.build_variants(cfg, 2, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"whisper-base: {cfg.encoder_layers} + {cfg.num_layers} layers, "
          f"{cfg.encoder_frames} frames, setup {setup_s:.2f} s")
    chunk_prefill(model, base, dev)
    launches = six_runs(dev, cfg, model, base, dms, per_prefill, per_step)
    del model, base, dms
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def six_runs(dev, cfg, model, base, dms, per_prefill, per_step) -> dict:
    """Group dense, group fused and continuous over a 4-slot bank, over an
    fp32 and an int8 base, of ``model`` with ``dms`` published: 8 group
    requests x 8 tokens, 12 continuous ones with ``CONT_BUDGETS``.  The
    continuous runs must launch the banked GEMM ``per_prefill`` times a
    prefill and ``per_step`` a decode step.  After each fused and
    continuous run ``serve_checks`` holds every delta GEMM launch of one
    prefill (``per_prefill`` of them, at the rows of the prompts and of
    the frontend: ``prefill_rows``) to the GEMM bound, repeats the prefill
    (bit-identical), prints its logits beside the plain versions and
    profiles one decode step; after a dense run one decode step of v0 is
    profiled.  Each run prints its peak device memory (serving and
    checks).  The fp32 continuous run (CUDA graphs) is served again
    eagerly (``eager_twin``).  Returns {run: launches}."""
    from repro_torch.launch import serve as SV

    launches = {}
    rows = {LANES * SV.PROMPT_LEN, LANES * prefill_rows(cfg)}
    for base_dtype in ("fp", "int8"):
        for run, scheduler, mode in (("dense", "group", "dense"),
                                     ("fused", "group", "fused"),
                                     ("continuous", "continuous", "fused")):
            label = f"{cfg.name} {run}" + (
                " int8" if base_dtype == "int8" else "")

            def deploy(graphs=True, mode=mode, scheduler=scheduler,
                       base_dtype=base_dtype):
                return SV.deploy(model, base, dms, mode=mode,
                                 scheduler=scheduler, batch=LANES,
                                 bank_size=4, device=dev,
                                 base_dtype=base_dtype, graphs=graphs)
            t0 = time.perf_counter()
            dep = deploy()
            torch.cuda.synchronize()
            n_req, budgets = (8, [8]) if scheduler == "group" else (
                12, CONT_BUDGETS)
            graphed = {}
            tokens, launches[label] = drive(dep, cfg, label, n_req, budgets,
                                            time.perf_counter() - t0,
                                            stats=graphed)
            got = launches[label]
            m = dep.metrics
            assert got[RUN_KERNEL[run]] > 0, got
            if run == "continuous":
                assert got["bitlinear_axes_banked"] == (
                    per_prefill * m["prefills"]
                    + per_step * m["decode_steps"]), (got, m)
                assert m["admitted"] == m["retired"] == n_req, m
            if run == "dense":
                params, overlay = dep.registry.resolve("v0")
                profile_decode(model, params, overlay, dev, label,
                               1e3 * m["decode_seconds"] / m["decode_steps"])
                del params, overlay
            else:
                checked = serve_checks(dep, model, cfg, dev, label,
                                       SV.PROMPT_LEN, SV.cache_len(cfg),
                                       continuous=run == "continuous",
                                       repeat=True, stats=graphed)
                assert len(checked) == per_prefill, len(checked)
                assert {shape[0] for _, shape, _ in checked} == rows
            print(f"{label}: peak_mem_GB="
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
            if run == "continuous" and base_dtype == "fp":
                nbytes, ms = copy_back_ms(dep, Timer(dev))
                print(f"{label}: copy-back of the live state (upper bound: "
                      f"every leaf) {nbytes / 1e9:.3f} GB in {ms:.3f} ms, "
                      f"{ms / graphed['step_ms']:.3f} of the graphed step")
            del dep
            gc.collect()
            torch.cuda.empty_cache()
            if run == "continuous" and base_dtype == "fp":
                eager_twin(deploy, cfg, label, n_req, budgets, tokens,
                           graphed)
    return launches


def vlm_phase(dev) -> dict:
    """internvl2-76b at full width (d 8192, d_ff 28672, untied 128256-row
    tables), 2 layers, fp32 base, 2 variants, 4 lanes of 256 zero image
    embeddings (the engine's stub) + 32-token padded prompts: group fused,
    then continuous over a 3-slot bank (base + the two variants), the first
    deployment freed before the second.  Memory, reckoned before the run:
    base 15.25 GB (a layer 3.42 GB, each table 4.20 GB); each variant's
    DeltaModel 8.62 GB (its fine-tuned tables as fp32 extras); group
    fused: each resident's tables as fp16 extras, 4.20 GB; the bank holds
    every slot's tables as fp32 extras, 3 x 8.62 GB; transients: a 2.10 GB
    bf16 table cast per bank slot, the banked w_down's (56, 1152, 8192)
    fp32 split-K workspace 2.11 GB: about 60 GB at peak, under the card's
    80.  Each run: every banked launch counted, ``serve_checks`` (1152-row
    prefills, K = 28672 at w_down), the peak printed.  Returns {run:
    launches}."""
    from repro_torch.launch import serve as SV

    cfg = SV.make_config("internvl2-76b", num_layers=VLM_LAYERS)
    max_len = SV.cache_len(cfg, VLM_PROMPT, max(CONT_BUDGETS))
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, base, dms = SV.build_variants(cfg, 2, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"internvl2-76b: {VLM_LAYERS} layers, {cfg.num_image_tokens} "
          f"image tokens + {VLM_PROMPT}-token prompts, caches of {max_len}; "
          f"setup {setup_s:.2f} s peak_mem_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    for scheduler in ("group", "continuous"):
        run = "fused" if scheduler == "group" else "continuous"
        label = f"internvl2-76b {run}"
        t0 = time.perf_counter()
        dep = SV.deploy(model, base, dms, mode="fused", scheduler=scheduler,
                        batch=LANES, bank_size=3, device=dev,
                        prompt_len=VLM_PROMPT, max_len=max_len)
        torch.cuda.synchronize()
        n_req, budgets = (8, [8]) if scheduler == "group" else (
            12, CONT_BUDGETS)
        _, launches[label] = drive(dep, cfg, label, n_req, budgets,
                                   time.perf_counter() - t0)
        got = launches[label]
        m = dep.metrics
        assert got[RUN_KERNEL[run]] > 0, got
        if run == "continuous":
            assert got["bitlinear_axes_banked"] == 7 * VLM_LAYERS * (
                m["prefills"] + m["decode_steps"]), (got, m)
            assert m["admitted"] == m["retired"] == n_req, m
        checked = serve_checks(dep, model, cfg, dev, label, VLM_PROMPT,
                               max_len, continuous=run == "continuous",
                               repeat=True)
        assert len(checked) == 7 * VLM_LAYERS, len(checked)
        assert {shape[0] for _, shape, _ in checked} == {
            LANES * prefill_rows(cfg)}
        print(f"{label}: peak_mem_GB="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} (since the "
              "run began: deployment, serving, checks)")
        del dep
        gc.collect()
        torch.cuda.empty_cache()
    del model, base, dms
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# full-width recurrent runs: xlstm-350m at 8 of 24 layers (one period: 7
# mLSTM and 1 sLSTM; cut from 24 to keep the script inside its time limit
# once the mesh phase served an int8 base; fp32 base 2.1 GB at 24);
# zamba2-7b at 7 of 81 layers (one application of the shared block and
# one trailing Mamba2 block; cut from 13 for the same reason; fp32 base
# 5.95 GB at 13, 27.2 GB at 81)
RECURRENT_LAYERS = {"xlstm-350m": 8, "zamba2-7b": 7}
SPEC_RECURRENT = "xlstm-350m"   # also served speculatively: the snapshot path


def recurrent_launches(cfg) -> tuple:
    """(delta GEMM launches per prefill, per decode step) of xlstm or
    zamba with every projection overlaid: mLSTM's seven and sLSTM's four
    a layer (21 x 7 + 3 x 4 = 159 at full depth, 7 x 7 + 4 = 53 at 8
    layers); a Mamba2 block's five and the shared block's seven an
    application (13 x 5 + 2 x 7 = 79 at 13 layers, 7 x 5 + 7 = 42 at 7:
    the prefill projects each application's q/k/v once)."""
    if cfg.family == "ssm":
        n_s = cfg.num_layers // (cfg.mlstm_ratio + 1)
        n = 7 * n_s * cfg.mlstm_ratio + 4 * n_s
    else:
        n = 5 * cfg.num_layers + 7 * (cfg.num_layers // cfg.attn_every)
    return n, n


def recurrent_phase(dev, arch) -> dict:
    """xlstm-350m (8 layers) or zamba2-7b (7 layers) at full width, 2
    variants, 4 lanes: ``six_runs`` (group dense through ``unpack_apply``,
    zamba's unstacked ``shared.*`` entries too; the continuous runs count
    ``recurrent_launches`` a prefill and a step); xlstm-350m then
    ``spec_runs`` over the fp32 base (its verify steps the recurrence k+1
    times and rewinds by snapshot).  Returns {run: launches}."""
    from repro_torch.launch import serve as SV

    cfg = SV.make_config(arch, num_layers=RECURRENT_LAYERS[arch])
    per_prefill, per_step = recurrent_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, base, dms = SV.build_variants(cfg, 2, dev)
    torch.cuda.synchronize()
    print(f"{arch}: {cfg.num_layers} layers, {per_prefill} delta GEMMs a "
          f"prefill and a step, setup {time.perf_counter() - t0:.2f} s "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    launches = six_runs(dev, cfg, model, base, dms, per_prefill, per_step)
    if arch == SPEC_RECURRENT:
        launches.update(spec_runs(dev, cfg, model, base, dms, arch, "fp",
                                  per_step, snapshot=True))
    del model, base, dms
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dense_archs_phase(dev) -> dict:
    """deepseek-7b and starcoder2-3b at full width, 2 layers: 4 requests x
    8 tokens, group scheduler, fused (``bitlinear_axes`` in every
    projection).  Returns {run: launches}."""
    from repro_torch.launch import serve as SV

    launches = {}
    for arch in ("deepseek-7b", "starcoder2-3b"):
        cfg = SV.make_config(arch, num_layers=2)
        t0 = time.perf_counter()
        model, base, dms = SV.build_variants(cfg, 2, dev)
        dep = SV.deploy(model, base, dms, mode="fused", scheduler="group",
                        batch=LANES, device=dev)
        torch.cuda.synchronize()
        label = f"{arch} fused"
        _, launches[label] = drive(dep, cfg, label, 4, [8],
                                   time.perf_counter() - t0)
        assert launches[label]["bitlinear_axes"] > 0, launches[label]
        del dep, model, base, dms
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# speculative decoding: base-as-draft rounds over the bank
# ---------------------------------------------------------------------------

DELTA_KERNELS = ("unpack_apply", "bitlinear_axes", "bitlinear_axes_banked",
                 "bitlinear_axes_stacked", "bitlinear")


def profile_round(model, params, bank, vidx, dev, label, k, prompt_len,
                  max_len, dep=None):
    """One speculative round of draft length ``k`` over ``LANES`` lanes
    (after a prefill through the bank and a warm-up round): its unprofiled
    time, then the draft's k base steps and the banked verify (accept and
    rewind included) each under ``torch.profiler``: device-busy and wall
    ms, the device's idle share of the round and the verify's largest
    kernels.  The draft must launch no delta kernel.  With ``dep`` (a
    drained deployment serving through CUDA graphs) its captured round of
    draft length ``k`` is replayed too, timed on the host clock over its
    idle lanes: the idle share of a graphed round.  Returns the round's
    device-busy ms."""
    from repro_torch.serving import speculative as SP

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cache = profile_cache(model, params, bank, dev, vidx, gen, prompt_len,
                          max_len)
    tok = torch.randint(1, model.cfg.vocab_size, (LANES,), generator=gen,
                        device=dev, dtype=torch.int32)
    round_fn = SP.make_round_fn(model, k)
    _, _, tok, cache = round_fn(params, bank, vidx, tok, cache)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, tok, cache = round_fn(params, bank, vidx, tok, cache)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3
    out = {}
    before = counters()
    d_events, d_busy, d_wall = profiled(lambda: out.update(
        drafts=SP.draft(model, params, tok, cache, k)))
    assert counters() == before, (label, before, counters())
    v_events, v_busy, v_wall = profiled(lambda: out.update(
        round=SP.verify(model, params, bank, vidx, tok, out["drafts"],
                        cache)))
    launched = {n: counters()[n] - before[n] for n in before}
    print(f"profile {label} round k={k}: round_ms={round_ms:.3f} "
          f"draft_busy_ms={d_busy:.3f} draft_wall_ms={d_wall:.3f} "
          f"verify_busy_ms={v_busy:.3f} verify_wall_ms={v_wall:.3f} "
          f"idle_share={max(0.0, 1 - (d_busy + v_busy) / round_ms):.3f} "
          f"accepted={out['round'][1].tolist()} draft_delta_launches=0 "
          f"verify_launches={ {n: c for n, c in launched.items() if c} }")
    for name, events in (("draft", d_events), ("verify", v_events)):
        for e in sorted(events, key=_dev_us, reverse=True)[:4]:
            print(f"    {name:6s} {_dev_us(e) / 1e3:9.3f} ms  "
                  f"calls={e.count:4d}  {e.key[:64]}")
    if dep is not None and dep.engine.graphs:
        assert dep.engine.active() == 0
        step = dep.engine._graphs[("spec", f"spec_k{k}")]
        before = counters()
        step.replay()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step.replay()
            torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) * 1e3 / 5
        replayed = counters()["bitlinear_axes_banked"] - \
            before["bitlinear_axes_banked"]
        print(f"profile {label} round k={k} graphed: replay_ms="
              f"{graph_ms:.3f} (eager round_ms={round_ms:.3f}) "
              f"device_busy_ms={d_busy + v_busy:.3f} idle_share="
              f"{max(0.0, 1 - (d_busy + v_busy) / graph_ms):.3f} "
              f"banked launches a replay {replayed // 6}")
    return d_busy + v_busy


def spec_runs(dev, cfg, model, base, dms, label, base_dtype, per_pass,
              snapshot) -> dict:
    """The serve phase's 12 requests (``CONT_BUDGETS``) over base, v0 and
    v1 with the continuous scheduler, then with the speculative one
    (drafts of up to ``SPEC_K``, adaptive), both over a 4-slot bank.  The
    continuous run launches the banked GEMM ``per_pass`` times a prefill
    and a step; the speculative run ``per_pass`` times a prefill and a
    round's verify (``snapshot``: the recurrent verify steps k+1 times, so
    ``per_pass`` x (k+1)) and no other delta kernel: the drafts launch
    none.  Prints tokens/s of both, rounds, acceptance, the ladder's walk,
    the token agreement (not asserted at full width: bf16 near-ties may
    flip between the verify's and the decode step's summation orders) and
    one profiled step and round.  Both runs go through CUDA graphs and are
    served again eagerly (``eager_twin``: the same tokens, bit for bit).
    Returns {run: launches}."""
    from repro_torch.launch import serve as SV

    suffix = " int8" if base_dtype == "int8" else ""
    launches, tokens, rate, step, eager_rate = {}, {}, {}, {}, {}
    for scheduler in ("continuous", "speculative"):
        beside = " beside speculative" if scheduler == "continuous" else ""
        run = f"{label} {scheduler}{beside}{suffix}"

        def deploy(graphs=True, scheduler=scheduler):
            return SV.deploy(model, base, dms, mode="fused",
                             scheduler=scheduler, batch=LANES, bank_size=4,
                             device=dev, base_dtype=base_dtype,
                             draft_k=SPEC_K, graphs=graphs)
        t0 = time.perf_counter()
        dep = deploy()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        ks = []
        if scheduler == "speculative":
            observe = dep.engine.spec.observe

            def record(k, accepted, lanes, observe=observe):
                ks.append(k)
                observe(k, accepted, lanes)
            dep.engine.spec.observe = record
        graphed = {}
        tokens[scheduler], got = drive(dep, cfg, run, 12, CONT_BUDGETS,
                                       setup_s, stats=graphed)
        m = dep.metrics
        rate[scheduler] = graphed["tokens_per_s"]
        step[scheduler] = graphed["step_ms"]
        launches[run] = got
        assert m["admitted"] == m["retired"] == 12, m
        slots = [dep.registry.bank_resolve(v) for v in ("v0", "v1")]
        vidx = torch.tensor([0, slots[0], slots[1], slots[0]],
                            dtype=torch.int32, device=dev)
        mixed = f"{run} mixed (vidx {vidx.tolist()})"
        if scheduler == "continuous":
            assert got["bitlinear_axes_banked"] == per_pass * (
                m["prefills"] + m["decode_steps"]), (got, m)
            graphed["busy_ms"] = profile_decode(
                model, dep.registry.base_params, dep.registry.bank.tree,
                dev, mixed, step[scheduler], vidx=vidx)
        else:
            assert m["spec_rounds"] == len(ks) > 0, (m, ks)
            verify = sum(per_pass * (k + 1 if snapshot else 1) for k in ks)
            assert got["bitlinear_axes_banked"] == (
                per_pass * m["prefills"] + verify), (got, m, ks)
            assert not any(got[n] for n in DELTA_KERNELS
                           if n != "bitlinear_axes_banked"), got
            snap = dep.status()["speculative"]
            same = sum(a == b for ra, rb in zip(tokens["speculative"],
                                                tokens["continuous"])
                       for a, b in zip(ra, rb))
            total = sum(map(len, tokens["continuous"]))
            print(f"{run}: rounds={m['spec_rounds']} acceptance="
                  f"{snap['acceptance']:.3f} (ema "
                  f"{snap['acceptance_ema']:.3f}) current_k="
                  f"{snap['current_k']} ladder={snap['ladder']} k_per_round="
                  f"{ks} tokens_per_round="
                  f"{m['tokens_generated'] / m['spec_rounds']:.2f}; "
                  f"banked launches {per_pass} x {m['prefills']} prefills + "
                  f"{verify} in verifies, no other delta kernel; "
                  f"tokens_per_s {rate['speculative']:.2f} vs continuous "
                  f"{rate['continuous']:.2f} "
                  f"(x{rate['speculative'] / rate['continuous']:.2f}); mean "
                  f"round {step['speculative']:.3f} ms vs continuous step "
                  f"{step['continuous']:.3f} ms; agreement with continuous "
                  f"{same}/{total} tokens (printed, not asserted)")
            # the round's own busy time and graphed replay: a mean round
            # mixes the ladder's k, so the twin prints no idle share
            profile_round(model, dep.registry.base_params,
                          dep.registry.bank.tree, vidx, dev, mixed, SPEC_K,
                          SV.PROMPT_LEN, SV.cache_len(cfg), dep=dep)
            print(f"{run}: peak_mem_GB="
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        del dep
        gc.collect()
        torch.cuda.empty_cache()
        eager_rate[scheduler] = eager_twin(
            deploy, cfg, run, 12, CONT_BUDGETS, tokens[scheduler],
            graphed)["tokens_per_s"]
    print(f"{label}{suffix} speculative vs continuous tokens/s: graphed "
          f"{rate['speculative']:.2f} / {rate['continuous']:.2f} "
          f"(x{rate['speculative'] / rate['continuous']:.2f}); eager "
          f"{eager_rate['speculative']:.2f} / {eager_rate['continuous']:.2f} "
          f"(x{eager_rate['speculative'] / eager_rate['continuous']:.2f})")
    return launches


def speculative_phase(dev) -> dict:
    """qwen3-8b at full width, ``SERVE_LAYERS`` layers, 4 lanes, 2
    variants: ``spec_runs`` over an fp32 and an int8 base with the serve
    phase's fine-tunes (base + 0.005·N(0,1)), then over an fp32 base with
    a near-base pair (``NEAR_SCALE``): 28 banked launches a prefill and a
    round.  Returns {run: launches}."""
    from repro_torch.core import calibration as C
    from repro_torch.launch import serve as SV

    cfg = SV.make_config(ARCH, num_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    model, base, dms = SV.build_variants(cfg, 2, dev)
    near = [C.compress(base, SV.fine_tune(base, 100 + i, NEAR_SCALE))
            for i in range(2)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"speculative: {ARCH}, {SERVE_LAYERS} layers, draft k up to "
          f"{SPEC_K}, setup {time.perf_counter() - t0:.2f} s")
    launches = {}
    for label, variants, base_dtype in ((ARCH, dms, "fp"),
                                        (ARCH, dms, "int8"),
                                        (f"{ARCH} near-base", near, "fp")):
        launches.update(spec_runs(dev, cfg, model, base, variants, label,
                                  base_dtype, 7 * SERVE_LAYERS,
                                  snapshot=False))
    del model, base, dms, near
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# warm restart: a fresh serving process over the script's build
# ---------------------------------------------------------------------------

RESTART_ARGS = ["--arch", ARCH, "--reduced", "--mode", "fused",
                "--speculative", "--draft-k", str(SPEC_K), "--requests", "8",
                "--new-tokens", "8", "--warmup"]


def launcher_lines(text: str) -> dict:
    """The launcher's result lines ("tokens: ...") by name."""
    keys = ("warmup", "compiles", "compile-cache", "startup", "tokens")
    return {k: v for k, _, v in (line.partition(": ")
                                 for line in text.splitlines()) if k in keys}


def restart_phase(dev, build_s: float) -> None:
    """Warm restart (DESIGN.md §14): ``repro_torch.launch.serve`` with
    ``RESTART_ARGS`` (reduced qwen3-8b, speculative, ``--warmup``) run in
    this process, then as a fresh process with ``--compile-cache`` on the
    directory this script built the kernels into.  The fresh process must
    load the library without building it, capture its graphs in
    ``warmup()`` and none after, and emit this process's tokens.  Prints
    its restart-to-first-token (from the spawn to its first token) beside
    this script's cold build."""
    import ast
    import io

    from repro_torch.kernels import build
    from repro_torch.launch import serve as SV

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        SV.main(RESTART_ARGS)
    here = launcher_lines(buf.getvalue())
    cache_dir = str(build._loaded_through[0].path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *RESTART_ARGS,
         "--compile-cache", cache_dir], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=900)
    wall = time.time() - t0
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    there = launcher_lines(proc.stdout)
    cache = ast.literal_eval(there["compile-cache"])
    steps = ast.literal_eval(there["compiles"])
    outcomes = json.loads(there["warmup"])
    startup = json.loads(there["startup"])
    captured = sum(v == "captured" for v in outcomes.values())
    assert cache["builds"] == 0 and cache["hits"] == 1, cache
    assert steps["compiles"] == captured > 0, (steps, outcomes)
    assert steps["cache_hits"] > 0, steps
    assert json.loads(there["tokens"]) == json.loads(here["tokens"]), (
        there["tokens"], here["tokens"])
    print(f"restart: a fresh `python -m repro_torch.launch.serve "
          f"{' '.join(RESTART_ARGS)} --compile-cache {cache_dir}`: "
          f"compile cache {cache}; {captured} graphs captured in warmup "
          f"({startup['warmup_seconds']:.3f} s), none after (steps "
          f"{steps}); tokens == this process's "
          f"({sum(map(len, json.loads(here['tokens'])))} tokens); "
          f"restart-to-first-token {startup['first_token_unix'] - t0:.2f} s "
          f"(process wall {wall:.2f} s) against this script's cold kernel "
          f"build {build_s:.1f} s")


# ---------------------------------------------------------------------------
# the launcher's frequent update: update + hot-swap cycles, then rollback
# ---------------------------------------------------------------------------

# qwen3-8b at 1 layer (2 until every family trained in the mesh phase)
LAUNCH_ARGS = ["--arch", ARCH, "--num-layers", "1", "--mode", "fused",
               "--scheduler", "continuous", "--updates", "2",
               "--max-resident", "2"]
LAUNCH_REQUESTS = 12 + 2 * LANES + 1   # the requests, two waves, one more
LAUNCH_BUDGET = 8                      # the launcher's --new-tokens default


def launcher_phase(dev) -> None:
    """``python -m repro_torch.launch.serve`` with ``LAUNCH_ARGS`` as a
    fresh process on the card (qwen3-8b at full width, 1 layer, 3
    variants, 12 requests over the continuous scheduler, then two update
    cycles on v0 and a rollback; the kernel library loaded from this
    script's build): the version lines must read 2, 3, then rollback to
    2, every request must finish with its budget, and the TTFT line is
    printed."""
    import re

    from repro_torch.kernels import build
    cache_dir = str(build._loaded_through[0].path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH_ARGS,
         "--compile-cache", cache_dir], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=600)
    wall = time.time() - t0
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    lines = version_lines(proc.stdout)
    assert lines == ["update 0: v0 -> version 2", "update 1: v0 -> version 3",
                     "rollback: v0 -> version 2"], lines
    tokens = json.loads(launcher_lines(proc.stdout)["tokens"])
    assert [len(t) for t in tokens] == [LAUNCH_BUDGET] * LAUNCH_REQUESTS, (
        [len(t) for t in tokens])
    ttft = re.search(r"^ttft: .*$", proc.stdout, re.M)
    assert ttft, proc.stdout[-2000:]
    print(f"launcher: `python -m repro_torch.launch.serve "
          f"{' '.join(LAUNCH_ARGS)}`: {lines}; {len(tokens)} requests, "
          f"every one {LAUNCH_BUDGET} tokens; {ttft.group(0)}; process "
          f"wall {wall:.1f} s")


# ---------------------------------------------------------------------------
# mesh-sharded serving: ranks over torch.distributed (launch/mesh.spawn)
# ---------------------------------------------------------------------------

MESH_REF_SHAPES = ((1, 2), (2, 1), (2, 2))
MESH_REF_ARCHS = ("deepseek-7b", "deepseek-moe-16b")
MESH_KDS = ("shard_map", "gspmd")
MESH_RUNS = {"continuous": dict(scheduler="continuous", mode="fused"),
             "group fused": dict(scheduler="group", mode="fused"),
             "group dense": dict(scheduler="group", mode="dense")}
# the speculative scheduler (drafts of up to 4, adaptive) on a mesh: its
# tokens are the continuous scheduler's (the variant's greedy chain)
MESH_SPEC_RUN = dict(scheduler="speculative", mode="fused")
# one arch a family, served speculatively in the reduced (1, 2) and (2, 2)
# groups (shard_map dispatch)
MESH_SPEC_ARCHS = ("deepseek-7b", "deepseek-moe-16b", "whisper-base",
                   "internvl2-76b", "xlstm-350m", "zamba2-7b")
# the reduced group whose continuous deepseek-7b deployment runs
# ``warmup()`` before its traffic
MESH_WARM_SHAPE = (2, 1)
# the full-width (1, 2) entries that also serve speculatively
MESH_SPEC_FULL = ("qwen3-8b",)
MESH_REF_BUDGETS = [2, 5, 3, 4]
MESH_FULL_SHAPE = (1, 2)
# (arch, layers, compute dtype or None for the config's own); depth cut
# from 4 to keep the script inside its time limit once the int8 runs
# joined, and qwen3-8b from 2 to 1 once every family trained in the main
# full-width group (deepseek-moe-16b: the dense first layer and one
# expert layer)
MESH_FULL = (("qwen3-8b", 1, None), ("deepseek-moe-16b", 2, None))
# deepseek-moe-16b at fp32 compute, run by ``--mesh-only`` only: with the
# rounding to bf16 gone, the mesh and one card differ only in the order
# of fp32 sums (a witness of the bf16 runs' agreement)
MESH_FP32_TWIN = (("deepseek-moe-16b", 4, "float32"),)
MESH_FULL_RUNS = {"continuous": (12, CONT_BUDGETS),
                  "group fused": (8, [8])}
MESH_TIMEOUT_S = 600
# intra-op threads of a reduced rank: the reduced groups' ranks
# share the host's cores, and their tensors are tiny (PyTorch's default,
# a thread a core in every rank, oversubscribes the host)
REDUCED_THREADS = 1
MESH_KERNELS = ("unpack_apply", "bitlinear_axes", "bitlinear_axes_banked",
                "bitlinear_axes_stacked")
# over an int8 base: the reduced meshes, and the full-width (1, 2) runs
MESH_INT8_SHAPES = ((1, 2), (2, 2))
MESH_INT8_FULL = {"qwen3-8b": ("continuous", "group fused"),
                  "deepseek-moe-16b": ("continuous",)}
# the launcher inside the reduced (1, 2) group: an int8 base, one update
MESH_LAUNCH_ARGV = ["--arch", "deepseek-7b", "--reduced", "--variants", "2",
                    "--requests", "4", "--new-tokens", "3", "--batch",
                    str(LANES), "--mode", "fused", "--scheduler",
                    "continuous", "--base-dtype", "int8", "--updates", "1"]
# the audio, VLM, xLSTM and Zamba families under a mesh: reduced in the
# (1, 2) and (2, 2) groups; in a (1, 4) group beside them zamba2-7b and
# xlstm-350m with 2 heads (2 SSM or mLSTM heads over 4 ranks: a rank's
# block of d_inner cuts a head) and the sequence-TP config (reduced
# starcoder2-3b with 6 q heads)
MESH_FAMILIES = ("whisper-base", "internvl2-76b", "xlstm-350m", "zamba2-7b")
MESH_FAMILY_SHAPES = ((1, 2), (2, 2))
MESH_FAMILY_RUNS = ("continuous", "group fused")
MESH_QUAD_SHAPE = (1, 4)
MESH_QUAD_ARCHS = ("zamba2-7b", "xlstm-350m-2h")
MESH_SEQ_ARCH = "starcoder2-3b"
MESH_SEQ_FIELDS = dict(num_heads=6, num_kv_heads=2, head_dim=16)
# the reduced cases that change a config: {case: (arch, fields)};
# xlstm-350m-2h runs one mLSTM and one sLSTM layer (its mLSTM block cuts
# a head at half the reduced depth: every collective waits on the host)
MESH_CASES = {MESH_SEQ_ARCH: (MESH_SEQ_ARCH, MESH_SEQ_FIELDS),
              "xlstm-350m-2h": ("xlstm-350m", dict(num_heads=2, num_layers=2,
                                                   mlstm_ratio=1))}
# reduced depths on a mesh: zamba2-7b one shared-block application and a
# trailing Mamba2 block (every collective of a step waits on the host)
MESH_REF_LAYERS = {**REF_LAYERS, "zamba2-7b": 4}
# prompt lengths of the sequence-TP runs: a multiple of the model axis
# (sequence-TP) and one that is not (JAX's flat-q_dim branch)
MESH_SEQ_PROMPTS = (16, 14)
# full width on (1, 2), in the full-width group after ``MESH_FULL``:
# (arch, layers (0: the config's own), compute dtype); depth cut, widths
# the configs' own
MESH_FAMILY_FULL = (("whisper-base", 0, None), ("xlstm-350m", 8, None),
                    ("zamba2-7b", 7, None), ("internvl2-76b", 1, None))
# the full-width entries served by a second (1, 2) group beside the first:
# the smallest families (a rank's peak under 2 GB), so the two groups'
# ranks fit the card together (the card's memory in use stays under
# ``MESH_PEAK_GB``: with zamba2-7b here too it reached 71.50 GB) and the
# phase waits on the longer group alone
MESH_FULL_SIDE = ("whisper-base", "xlstm-350m")
MESH_FAMILY_FULL_RUNS = {"continuous": (8, [4, 6, 8]),
                         "group fused": (4, [6])}
# variants and bank slots of a full-width run (``MESH_FULL``'s: 3 and 4);
# internvl2-76b: each variant carries both 128256 x 8192 fp32 tables
MESH_FAMILY_VARIANTS = {"internvl2-76b": 1}
MESH_FAMILY_BANK = {"internvl2-76b": 2}
# the weights whose all-reduced product ``allreduce_check`` holds
ALLREDUCE_PATHS = {"qwen3-8b": ("layers.attn.wo", "layers.mlp.w_down"),
                   "whisper-base": ("dec_layers.self_attn.wo",
                                    "dec_layers.mlp.w_out"),
                   "xlstm-350m": ("mlstm.w_down",),
                   "zamba2-7b": ("mamba.w_out",),
                   "internvl2-76b": ("layers.attn.wo", "layers.mlp.w_down")}
MESH_PEAK_GB = 75.0           # the full-width ranks' peaks, summed; and
# the card's memory in use by every process on it, sampled while the
# groups of a mesh or pods phase run (``CardInUse``)


class CardInUse:
    """The card's memory in use by every process on it (``cudaMemGetInfo``),
    sampled every ``period`` s on a thread from ``start`` to ``stop``:
    ``peak_gb`` is a lower bound of the true peak."""

    def __init__(self, dev, period: float = 0.05):
        import threading
        self.dev, self.period = dev, period
        self.peak_gb = 0.0
        self.total_gb = torch.cuda.mem_get_info(dev)[1] / 1e9
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self) -> None:
        while not self._stop.is_set():
            free, total = torch.cuda.mem_get_info(self.dev)
            self.peak_gb = max(self.peak_gb, (total - free) / 1e9)
            self._stop.wait(self.period)

    def start(self) -> "CardInUse":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def full_plan(arch: str) -> tuple:
    """(variants, bank slots, runs) of a full-width mesh entry; an entry
    of ``MESH_SPEC_FULL`` serves the continuous run's requests
    speculatively too."""
    if arch in MESH_FAMILIES:
        return (MESH_FAMILY_VARIANTS.get(arch, 2),
                MESH_FAMILY_BANK.get(arch, 4), MESH_FAMILY_FULL_RUNS)
    if arch in MESH_SPEC_FULL:
        return 3, 4, dict(MESH_FULL_RUNS,
                          speculative=MESH_FULL_RUNS["continuous"])
    return 3, 4, MESH_FULL_RUNS


def mesh_full_config(arch, layers, dtype):
    """(label, cfg) of one ``MESH_FULL`` entry; the label names a compute
    dtype other than the config's own."""
    import dataclasses

    from repro_torch.launch import serve as SV
    cfg = SV.make_config(arch, num_layers=layers)
    if dtype is None:
        return arch, cfg
    return f"{arch} {dtype}", dataclasses.replace(cfg, compute_dtype=dtype)


def mesh_ref_setup(case):
    """(cfg, model, base, [2 DeltaModels], axes) of a reduced arch (or a
    case of ``MESH_CASES``) at fp32 compute, made on the CPU from seeds:
    every rank and the script make the same."""
    import dataclasses

    from repro_torch.launch import serve as SV
    arch, fields = MESH_CASES.get(case, (case, {}))
    cfg = dataclasses.replace(SV.make_config(arch, reduced=True), **{
        "num_layers": MESH_REF_LAYERS.get(arch, 2),
        "compute_dtype": "float32", **fields})
    model, base, dms, axes = SV.build_variants(cfg, 2, "cpu",
                                               with_axes=True)
    return cfg, model, base, dms, axes


def mesh_deploy(model, base, dms, axes, mesh, device, run, bank=4, **kw):
    """A Deployment of ``run`` (``MESH_RUNS``, or "speculative") over
    ``base`` with ``dms`` published, ``bank`` slots (a pod), on ``mesh``
    (eager steps: a gloo collective cannot be captured) or, with ``mesh``
    None, on ``device`` alone."""
    from repro_torch.launch import serve as SV
    if mesh is not None:
        kw.update(mesh=mesh, param_axes=axes, graphs=False)
    sched = MESH_SPEC_RUN if run == "speculative" else MESH_RUNS[run]
    return SV.deploy(model, base, dms, batch=LANES, device=device,
                     bank_size=bank, **sched, **kw)


def ref_run(run: str) -> str:
    """The CPU plain run whose tokens a card run of label ``run`` must
    equal: a speculative run's are the continuous one's, a warmed run's
    the unwarmed one's."""
    return run.replace("speculative", "continuous").removesuffix(" warmed")


def mesh_store_run(model, base, dms, axes, mesh, device, root) -> dict:
    """One publish, update (a patch), serve, rollback, serve through a
    store under ``root`` (on a mesh rank 0 writes, every rank reads)."""
    from repro_torch.launch import serve as SV
    dep = mesh_deploy(model, base, [], axes, mesh, device, "continuous",
                      root_dir=root)
    out = {"versions": [dep.publish("v0", dms[0]),
                        dep.update("v0", dms[1])]}

    def serve():
        rids = SV.submit_requests(dep, model.cfg, 4, [3])
        dep.drain()
        return [dep.result(r).out_tokens for r in rids]
    out["after update"] = serve()
    out["rollback"] = dep.rollback("v0")
    out["after rollback"] = serve()
    return out


def mesh_family_runs(mesh, archs, out: dict) -> None:
    """``MESH_FAMILY_RUNS`` of each reduced arch of ``archs`` on this rank,
    both kernel dispatch modes, into ``out["runs"]``: tokens and
    launches."""
    from repro_torch.launch import serve as SV
    t0 = time.perf_counter()
    for arch in archs:
        cfg, model, base, dms, axes = mesh_ref_setup(arch)
        for kd in MESH_KDS:
            for run in MESH_FAMILY_RUNS:
                zero_counters()
                dep = mesh_deploy(model, base, dms, axes, mesh, mesh.device,
                                  run, kernel_dispatch=kd)
                rids = SV.submit_requests(dep, cfg, 6, MESH_REF_BUDGETS)
                dep.drain()
                out["runs"][arch, kd, run] = {
                    "tokens": [dep.result(r).out_tokens for r in rids],
                    "launches": counters()}
    out["family_s"] = round(time.perf_counter() - t0, 1)


def mesh_quad_rank(mesh) -> dict:
    """One rank of the reduced (1, 4) mesh: the cases of
    ``MESH_QUAD_ARCHS`` and the sequence-TP config at each of
    ``MESH_SEQ_PROMPTS`` (continuous), both kernel dispatch modes; with
    the attention layouts each prompt length took; then the cases of
    ``MESH_TRAIN_QUAD`` trained on the mesh (``mesh_train_rank``)."""
    from repro_torch.launch import serve as SV
    from repro_torch.models import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"coords": mesh.coords, "device": str(mesh.device),
           "backend": mesh.backend, "runs": {}, "layouts": {}}
    mesh_family_runs(mesh, MESH_QUAD_ARCHS, out)
    cfg, model, base, dms, axes = mesh_ref_setup(MESH_SEQ_ARCH)
    orig = A.head_split
    for n in MESH_SEQ_PROMPTS:
        seen = set()

        def recorded(c, s=None):
            split = orig(c, s)
            seen.add(split)
            return split
        A.head_split = recorded
        try:
            for kd in MESH_KDS:
                zero_counters()
                dep = mesh_deploy(model, base, dms, axes, mesh, mesh.device,
                                  "continuous", kernel_dispatch=kd,
                                  prompt_len=n)
                rids = SV.submit_requests(dep, cfg, 6, MESH_REF_BUDGETS)
                dep.drain()
                out["runs"][MESH_SEQ_ARCH, kd, f"prompt {n} continuous"] = {
                    "tokens": [dep.result(r).out_tokens for r in rids],
                    "launches": counters()}
        finally:
            A.head_split = orig
        out["layouts"][n] = sorted(seen)
    # the 6 q heads served speculatively: the verify's T = k+1 rows read
    # the whole cache, so it takes "whole" at every prompt length
    zero_counters()
    n = MESH_SEQ_PROMPTS[0]
    dep = mesh_deploy(model, base, dms, axes, mesh, mesh.device,
                      "speculative", prompt_len=n)
    rids = SV.submit_requests(dep, cfg, 6, MESH_REF_BUDGETS)
    dep.drain()
    out["runs"][MESH_SEQ_ARCH, "shard_map", f"prompt {n} speculative"] = {
        "tokens": [dep.result(r).out_tokens for r in rids],
        "launches": counters(), "ladder": dep.status()["speculative"]}
    out["train"] = mesh_train_rank(mesh, tuple(MESH_TRAIN_QUAD), False)
    out["seconds"] = round(time.perf_counter() - t0, 1)
    return out


def mesh_ref_rank(mesh, store_root, int8: bool, families: bool,
                  spec: bool = False, warm: bool = False,
                  drop: bool = False) -> dict:
    """One rank of a reduced mesh on the card: both archs, every run, both
    kernel dispatch modes, over an fp32 base and (``int8``) an int8 one
    (and on (1, 2) the store lifecycle and the launcher's update run,
    ``mesh_launcher_run``); with ``families`` the runs of
    ``MESH_FAMILIES`` (``mesh_family_runs``); with ``spec`` each arch of
    ``MESH_SPEC_ARCHS`` served speculatively (its ladder snapshot kept);
    with ``warm`` deepseek-7b's continuous deployment warmed up first
    (``warmup()``'s outcomes kept); tokens and the run's launches on this
    rank; then ``MESH_TRAIN_ARCHS`` (with ``families`` also
    ``MESH_FAMILIES``) trained on the mesh, and with ``drop`` the
    drop-and-continue (``mesh_train_rank``)."""
    from repro_torch.launch import serve as SV
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"coords": mesh.coords, "device": str(mesh.device),
           "backend": mesh.backend, "runs": {}}
    dtypes = ("fp", "int8") if int8 else ("fp",)
    if families:
        mesh_family_runs(mesh, MESH_FAMILIES, out)
    for arch in MESH_SPEC_ARCHS if spec else ():
        cfg, model, base, dms, axes = mesh_ref_setup(arch)
        zero_counters()
        dep = mesh_deploy(model, base, dms, axes, mesh, mesh.device,
                          "speculative")
        rids = SV.submit_requests(dep, cfg, 6, MESH_REF_BUDGETS)
        dep.drain()
        out["runs"][arch, "shard_map", "speculative"] = {
            "tokens": [dep.result(r).out_tokens for r in rids],
            "launches": counters(), "ladder": dep.status()["speculative"]}
    if warm:
        cfg, model, base, dms, axes = mesh_ref_setup("deepseek-7b")
        dep = mesh_deploy(model, base, dms, axes, mesh, mesh.device,
                          "continuous")
        out["warmup"] = dep.warmup()
        zero_counters()
        rids = SV.submit_requests(dep, cfg, 6, MESH_REF_BUDGETS)
        dep.drain()
        out["runs"]["deepseek-7b", "shard_map", "continuous warmed"] = {
            "tokens": [dep.result(r).out_tokens for r in rids],
            "launches": counters()}
    for arch in MESH_REF_ARCHS:
        cfg, model, base, dms, axes = mesh_ref_setup(arch)
        for bd in dtypes:
            for kd in MESH_KDS:
                for run in MESH_RUNS:
                    zero_counters()
                    dep = mesh_deploy(model, base, dms, axes, mesh,
                                      mesh.device, run, kernel_dispatch=kd,
                                      base_dtype=bd)
                    rids = SV.submit_requests(dep, cfg, 6, MESH_REF_BUDGETS)
                    dep.drain()
                    out["runs"][arch, kd, mesh_run(run, bd)] = {
                        "tokens": [dep.result(r).out_tokens for r in rids],
                        "launches": counters()}
        if store_root and arch == MESH_REF_ARCHS[0]:
            out["store"] = mesh_store_run(model, base, dms, axes, mesh,
                                          mesh.device, store_root)
    if store_root:
        out["launcher"] = mesh_launcher_run(mesh)
    out["train"] = mesh_train_rank(
        mesh, MESH_TRAIN_ARCHS + (MESH_FAMILIES if families else ()),
        drop)
    return out


def mesh_run(run: str, base_dtype: str) -> str:
    """A run's label: its scheduler, then " int8" over an int8 base."""
    return run + (" int8" if base_dtype == "int8" else "")


def version_lines(text: str) -> list:
    """The launcher's ``update …`` and ``rollback: …`` lines."""
    return [ln for ln in text.splitlines()
            if ln.startswith(("update ", "rollback:"))]


def mesh_launcher_run(mesh) -> dict:
    """``launch.serve`` on this rank with ``MESH_LAUNCH_ARGV`` (an int8
    base, continuous, one update), then the same calls made directly on a
    Deployment of the same mesh: build the variants on the rank's card from
    the launcher's seeds, serve the requests, update v0 with its fine-tune
    moved on, serve a wave of v0 requests, roll back, serve one more.
    Returns the launcher's version lines (rank 0 prints them) and tokens,
    and the direct run's versions and tokens."""
    from repro_torch.core import calibration as C
    from repro_torch.launch import serve as SV
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tokens = SV._mesh_rank(mesh, MESH_LAUNCH_ARGV)
    cfg = SV.make_config("deepseek-7b", reduced=True)
    model, base, dms, axes = SV.build_variants(cfg, 2, mesh.device,
                                               with_axes=True)
    dep = SV.deploy(model, base, dms, mode="fused", scheduler="continuous",
                    batch=LANES, device=mesh.device, base_dtype="int8",
                    mesh=mesh, param_axes=axes, graphs=False)
    rng = np.random.default_rng(0)
    rids = SV.submit_requests(dep, cfg, 4, 3, rng=rng)
    dep.drain()
    tune = SV.continue_tune(SV.fine_tune(base, 100), base)
    versions = [dep.update("v0", C.compress(base, tune))]
    rids += SV.submit_requests(dep, cfg, LANES, 3, names=["v0"], rng=rng)
    dep.drain()
    versions.append(dep.rollback("v0"))
    rids += SV.submit_requests(dep, cfg, 1, 3, names=["v0"], rng=rng)
    dep.drain()
    return {"lines": version_lines(buf.getvalue()), "tokens": tokens,
            "direct_versions": versions,
            "direct_tokens": [dep.result(r).out_tokens for r in rids]}


def allreduce_check(mesh, dep, base, dm, path: str) -> dict:
    """The all-reduced projection of a weight whose in dim is sharded
    (layer 0 of ``path``), per rank on the rank's blocks, against the
    single-card kernel on the whole operands on this rank's card: within
    the GEMM bound summed over the ranks' K-tiles plus the single-card
    kernel's own, 2e-5·Σ|x||Ŵ| + (M+1)·1e-6.  Over an int8 base the
    rank's blocks are the ones it serves (its registry's), the whole
    weight is quantized on the card, and both run the q8 body."""
    from repro_torch.core import delta as D
    from repro_torch.core import quantize as Q
    from repro_torch.core.calibration import flatten_params
    from repro_torch.distributed import sharding as S
    from repro_torch.kernels import ops as K
    from repro_torch.models import delta_overlay as DO
    from repro_torch.models.delta_overlay import flatten_axes

    dev = mesh.device
    w = flatten_params(base)[path][0].to(dev)
    e = DO.from_delta_entry(dm.deltas[path])
    ent = [t[0].to(dev) for t in (e.packed, e.v_row, e.v_col)]
    spec = flatten_axes(dep.registry.param_shardings)[path][1:]
    waxes = flatten_axes(dep.registry.param_axes)[path][1:]
    assert spec[1] is not None, (path, spec)
    sp = DO.entry_shardings_from_weight(spec, 2)
    w_local = S.block(w, spec, mesh)
    if dep.registry.base_dtype == "int8":
        served = flatten_params(dep.registry.base_params)[path]
        w_local = Q.QuantWeight(q=served.q[0], scale=served.scale[0])
        w = Q.quantize_weight(w)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((LANES, w.shape[1]), generator=gen, device=dev)
    with dep.engine._ctx():
        got = K.bitlinear_axes(
            S.block(x, (None, spec[1]), mesh),
            *(S.block(t, s, mesh) for t, s in zip(ent, (sp.packed, sp.v_row,
                                                         sp.v_col))),
            w_local, waxes=waxes)
    want = K.bitlinear_axes(x, *ent, w)
    w_hat = (ent[1].float()[:, None] + ent[2].float()[None, :]) \
        * D.unpack_signs(ent[0], w.shape[1]) + _base(w)[2]
    scale = x.abs() @ w_hat.abs().T
    tol = 2e-5 * scale + (mesh.axis_size("model") + 1) * 1e-6
    err = (got - want).abs()
    assert bool((err <= tol).all()), (path, err.max().item())
    return {"path": path, "max_abs_err": err.max().item(),
            "max_err_over_tol": (err / tol).max().item()}


@contextlib.contextmanager
def routing_recorded():
    """Every top-k selection of the MoE layers while the block runs, in
    order: the router's top-k of each layer, then its capacity selection
    (``moe.top_k``, called twice a layer); each as (scores on the host,
    k).  Every rank holds the whole scores."""
    from repro_torch.models import moe
    calls, inner = [], moe.top_k

    def record(score, k):
        calls.append((score.detach().float().cpu(), k))
        return inner(score, k)
    moe.top_k = record
    try:
        yield calls
    finally:
        moe.top_k = inner


def first_parting(mine, other):
    """Where two runs' MoE selections (``routing_recorded``) first differ,
    or None: {"i", "kind", "k", "rows", "dist", "gaps", "tie"}, the
    selection, how far the two runs' scores there lie apart, the least
    gap, on each side, between the last score chosen and the first one
    left out in the rows whose choice differs, and whether both gaps lie
    under the scores' distance (a near-tie that the distance decides).
    A count or shape mismatch is {"i", "what", "tie": False}."""
    from repro_torch.models import moe
    if len(mine) != len(other):
        return {"i": None, "what": f"{len(mine)} vs {len(other)} "
                "selections", "tie": False}
    for i, ((a, k), (b, _)) in enumerate(zip(mine, other)):
        if a.shape != b.shape:
            return {"i": i, "what": f"shapes {tuple(a.shape)} vs "
                    f"{tuple(b.shape)}", "tie": False}
        ia = moe.top_k(a, k)[1].sort(-1).values
        ib = moe.top_k(b, k)[1].sort(-1).values
        rows = (ia != ib).any(-1)
        if not bool(rows.any()):
            continue
        dist = (a - b).abs().max().item()

        def gap(t):
            v = t.sort(-1, descending=True).values[rows]
            return (v[:, k - 1] - v[:, k]).min().item()
        gaps = (gap(a), gap(b))
        return {"i": i, "kind": "router top-k" if i % 2 == 0 else
                "capacity", "k": k, "rows": int(rows.sum()), "dist": dist,
                "gaps": gaps, "tie": max(gaps) < dist}
    return None


def tokens_or_tie(a: dict, b: dict, names: tuple) -> str:
    """Two MoE runs of the same requests in the same lanes (each with its
    ``tokens`` and ``routing``, ``routing_recorded``): "" when their
    tokens are the same; else where their routing first parts, which must
    be a near-tie: both gaps under the two runs' score distance, itself
    under ``TIE_DIST`` (reduced MoE's router scores lie close together,
    so another fp32 sum order can decide one; every later difference
    follows from it)."""
    if a["tokens"] == b["tokens"]:
        return ""
    p = first_parting(a["routing"], b["routing"])
    assert p is not None and p["tie"] and p["dist"] < TIE_DIST, (names, p)
    return routing_parting(a["routing"], b["routing"], names)


def routing_parting(mine, other, names=("mesh", "one card")) -> str:
    """``first_parting`` of two runs' MoE selections, as a line."""
    p = first_parting(mine, other)
    if p is None:
        return f"all {len(mine)} selections the same"
    if "what" in p:
        return f"selection {p['i']}: {p['what']}"
    return (f"selection {p['i']} of {len(mine)} ({p['kind']}, k={p['k']}): "
            f"{p['rows']} row(s) differ; scores apart by {p['dist']:.3g}; "
            f"gap at the cut {p['gaps'][0]:.3g} ({names[0]}), "
            f"{p['gaps'][1]:.3g} ({names[1]})")


def int8_blocks_check(mesh, dep, base) -> dict:
    """Every int8 block this rank serves against the single-card
    quantization's block: each target leaf of the whole base quantized on
    the card (``quantize_weight``, one leaf at a time), cut by the
    registry's spec (the scale's without its in dim), bit for bit.
    Returns the leaves checked and those whose in dim is sharded."""
    from repro_torch.core import quantize as Q
    from repro_torch.core.calibration import flatten_params
    from repro_torch.distributed import sharding as S
    from repro_torch.models.delta_overlay import flatten_axes
    served = flatten_params(dep.registry.base_params)
    specs = flatten_axes(dep.registry.param_shardings)
    whole = flatten_params(base)
    n = in_sharded = 0
    for path, mine in served.items():
        if not Q.is_quant(mine):
            continue
        qw = Q.quantize_weight(whole[path].to(mesh.device))
        spec = specs[path]
        assert torch.equal(S.block(qw.q, spec, mesh), mine.q), path
        assert torch.equal(S.block(qw.scale, spec[:-1], mesh).view(
            torch.int16), mine.scale.view(torch.int16)), path
        n += 1
        in_sharded += spec[-1] is not None
        del qw
    return {"leaves": n, "in_dim_sharded": in_sharded}


def mesh_full_rank(mesh, entries, train: bool = False) -> dict:
    """One rank of the full-width (1, 2) mesh over ``entries``
    (``MESH_FULL``'s, maybe the fp32 twin's, then ``MESH_FAMILY_FULL``'s),
    the variants, bank and runs of ``full_plan`` (``MESH_FULL``: 3
    variants, continuous over a 4-slot bank and group fused), then the
    runs of ``MESH_INT8_FULL`` over an int8 base; per run its tokens,
    launches, tokens/s, mean step, peak memory and base bytes on the rank;
    every delta GEMM launch of one prefill and one decode step held to its
    plain version on the same local operands (``gemms_checked``); the
    all-reduced products of ``ALLREDUCE_PATHS`` against the single-card
    kernel, over both bases; every int8 block
    against the single-card quantization (``int8_blocks_check``); for
    MoE, rank 0's routing choices in a rerun of the same requests
    (``routing_recorded``).  The runs over one base dtype share one
    Deployment (its placed base and published variants), each served by
    an engine of its own (``mesh_engine``).  With ``train``, qwen3-8b
    and then the families of ``MESH_FAMILY_TRAIN_FULL`` trained at full
    width after the entries, one at a time (``mesh_full_train``)."""
    from repro_torch.launch import serve as SV
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    out = {"coords": mesh.coords, "device": str(dev),
           "backend": mesh.backend, "runs": {}, "checks": {}, "routing": {},
           "seconds": {}}
    for entry in entries:
        t_entry = time.perf_counter()
        arch, cfg = mesh_full_config(*entry)
        n_var, bank, full_runs = full_plan(entry[0])
        # the ranks build the whole base and variants in turns (their
        # fine-tunes are whole copies of the base), and each keeps them
        # on the host: only its blocks stay on the card
        for turn in range(mesh.size):
            if turn == mesh.rank:
                model, base, dms, axes = SV.build_variants(
                    cfg, n_var, dev, with_axes=True)
                base = tree_map(lambda t: t.cpu(), base)
                dms = [tree_map(lambda t: t.cpu(), dm) for dm in dms]
                gc.collect()
                torch.cuda.empty_cache()
            mesh.barrier()
        runs = [(run, "fp") for run in full_runs] + [
            (run, "int8") for run in MESH_INT8_FULL.get(arch, ())]
        dep = None
        for i, (run, bd) in enumerate(runs):
            n_req, budgets = full_runs[run]
            label = mesh_run(run, bd)
            torch.cuda.reset_peak_memory_stats(dev)
            if dep is None:
                dep = mesh_deploy(model, base, dms, axes, mesh, dev, run,
                                  bank=bank, base_dtype=bd)
            else:
                mesh_engine(dep, model, run)
            if bd == "int8" and run == MESH_INT8_FULL[arch][0]:
                out["checks"][arch, "int8 blocks"] = int8_blocks_check(
                    mesh, dep, base)
            mesh_warm(dep, cfg)
            zero_counters()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            rids = SV.submit_requests(dep, cfg, n_req, budgets)
            dep.drain()
            torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            m = dep.metrics
            out["runs"][arch, label] = {
                "tokens": [dep.result(r).out_tokens for r in rids],
                "launches": counters(),
                "tokens_per_s": m["tokens_generated"] / secs,
                "mean_step_ms": 1e3 * m["decode_seconds"]
                / max(1, m["decode_steps"]),
                "prefill_s": m["prefill_seconds"],
                "decode_s": m["decode_seconds"], "seconds": secs,
                "prefills": m["prefills"], "decode_steps": m["decode_steps"],
                "peak_GB": torch.cuda.max_memory_allocated(dev) / 1e9,
                "base_GB": dep.registry.base_nbytes() / 1e9,
                "ladder": dep.status().get("speculative")}
            # a speculative wave of budget 2: one prefill and one round's
            # verify, each banked launch on the rank's lanes checked
            with gemms_checked() as log:
                rids = SV.submit_requests(dep, cfg, LANES, [2])
                dep.drain()
            out["checks"][arch, label] = {
                "launches": len(log),
                "kernels": sorted({name for name, _, _ in log}),
                "q8": sum(name.endswith("_q8") for name, _, _ in log),
                "max_abs_err": max(err for _, _, err in log)}
            if arch.startswith("deepseek-moe-16b"):
                # the same requests again, every routing choice recorded
                with routing_recorded() as calls:
                    rids = SV.submit_requests(dep, cfg, n_req, budgets)
                    dep.drain()
                out["routing"][arch, label] = {
                    "tokens": [dep.result(r).out_tokens for r in rids],
                    "calls": calls if mesh.rank == 0 else None}
            if run == "continuous" and arch in ALLREDUCE_PATHS:
                out["checks"][arch, mesh_run("all-reduce", bd)] = [
                    allreduce_check(mesh, dep, base, dms[0], p)
                    for p in ALLREDUCE_PATHS[arch]]
            if i + 1 == len(runs) or runs[i + 1][1] != bd:
                dep.close()
                dep = None
                gc.collect()
                torch.cuda.empty_cache()
        del model, base, dms
        gc.collect()
        out["seconds"][arch] = round(time.perf_counter() - t_entry, 1)
    if train:
        out["train"] = {}
        for arch, layers in ((ARCH, TRAIN_LAYERS),) + MESH_FAMILY_TRAIN_FULL:
            t_entry = time.perf_counter()
            torch.cuda.empty_cache()
            out["train"][arch] = mesh_full_train(mesh, arch, layers)
            out["seconds"][f"train {arch}"] = round(
                time.perf_counter() - t_entry, 1)
    return out


def mesh_engine(dep, model, run: str) -> None:
    """Serve ``dep`` (its placed base, published variants and residents)
    with a fresh engine of ``run``'s scheduler, on the same mesh, lanes
    and lengths: a run over the same base pays no second placement."""
    from repro_torch.serving.engine import ServingEngine
    eng = dep.engine
    sched = MESH_SPEC_RUN if run == "speculative" else MESH_RUNS[run]
    assert sched["mode"] == dep.registry.mode, (run, dep.registry.mode)
    dep.engine = ServingEngine(
        model, dep.registry, batch_size=eng.batch_size,
        prompt_len=eng.prompt_len, max_len=eng.max_len,
        max_retries=eng.max_retries, scheduler=sched["scheduler"],
        graphs=False, mesh=eng.mesh, kernel_dispatch=eng.kernel_dispatch)


def mesh_warm(dep, cfg) -> None:
    """Every published variant resident (a bank slot, or a fused resident
    under the group scheduler) and one short wave served, so a timed run
    pays neither a variant's load nor a process's first launches."""
    from repro_torch.launch import serve as SV
    with dep.engine._ctx():
        for name in dep.variants()[1:]:
            if dep.engine.scheduler != "group":
                dep.registry.bank_resolve(name)
            else:
                dep.registry.resolve(name)
    SV.submit_requests(dep, cfg, LANES, [1])
    dep.drain()
    dep.engine.metrics.update({k: 0 if isinstance(v, int) else 0.0
                               for k, v in dep.engine.metrics.items()})


# ---------------------------------------------------------------------------
# training under a mesh
# ---------------------------------------------------------------------------

# reduced cases (2 layers, fp32 compute, from seed 0 on the CPU) trained
# in the reduced mesh groups: {case: the config's fields}; the decoder
# and MoE archs on (1, 2), (2, 1) and (2, 2), on (1, 4) qwen3-8b (4 q and
# 2 KV heads: the GQA layout, a KV head cut over two ranks) and the 6-head
# starcoder2-3b (q heads that do not divide 4: the "whole" layout)
MESH_TRAIN_ARCHS = ("deepseek-7b", "deepseek-moe-16b")
MESH_TRAIN_QUAD = {"qwen3-8b": {}, MESH_SEQ_ARCH: MESH_SEQ_FIELDS,
                   # the head-cut cases: 2 SSM or mLSTM heads over 4 ranks
                   "zamba2-7b": {}, "xlstm-350m-2h": {}}
# the depths of the reduced train cases (2 layers otherwise), each
# holding every block kind of its family: xlstm-350m one super-block (3
# mLSTM + 1 sLSTM), zamba2-7b one shared-block application and a
# trailing Mamba2 block; xlstm-350m-2h takes ``MESH_CASES``' 1 mLSTM + 1
# sLSTM.  ``MESH_FAMILIES`` train in the (1, 2) and (2, 2) groups
# (``MESH_FAMILY_SHAPES``)
MESH_TRAIN_LAYERS = {"xlstm-350m": 4, "zamba2-7b": 4}
# the cases whose fp32 steps part from one process by more than the
# mesh-training bar, and the limits they take instead (the later steps'
# metrics rel, the step-1 gradients of max |g|; their first step's
# metrics keep 1e-5 and their params 1e-3): the tests'
# ``_mesh_family_ranks.TRAIN_LIMITS_CARD``, which says why, but for the
# 2-head case, which is 1 mLSTM + 1 sLSTM here (3 + 1 there).  On an H100
# against one process on the CPU: xlstm-350m's later grad_norm 4.80e-4
# rel apart, zamba2-7b's 2.04e-5, the 2-head case's 9.91e-7 and its
# step-1 gradients 1.09e-5 of max
MESH_TRAIN_LIMITS = {"xlstm-350m": (2e-3, 1e-5),
                     "xlstm-350m-2h": (1e-5, 5e-5),
                     "zamba2-7b": (1e-4, 1e-5)}
MESH_TRAIN_LR = dict(peak_lr=5e-3, warmup=2, total_steps=10)
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_STEPS = 4, 16, 3
# the group that trains 2 steps, drops to the (1, 2) mesh of its first two
# ranks and trains 1 more
MESH_DROP_SHAPE, MESH_DROP_TO = (2, 2), (1, 2)
# full width on the full-width (1, 2) group, after its serving entries:
# qwen3-8b at ``train_phase``'s configuration, 2 steps of its run
MESH_TRAIN_FULL_STEPS = 2
# then the families at ``train_phase``'s batch, bf16 and remat, at the
# depth that holds every kind of block each has (arch, layers; 0: the
# config's own): whisper-base whole (6 + 6), xlstm-350m one super-block
# of 7 mLSTM + 1 sLSTM, zamba2-7b with its shared block applied once (its
# full-width serving depth).  internvl2-76b is left out: one layer and its
# untied 128256 x 8192 tables are 2.96 B parameters, about 55 GB a rank
# at qwen3-8b's 26.82 GB a rank for 1.44 B, and two ranks share one card
MESH_FAMILY_TRAIN_FULL = (("whisper-base", 0), ("xlstm-350m", 8),
                          ("zamba2-7b", 7))
# the one-card runs' first losses and grad norms by arch (qwen3-8b's from
# ``train_phase``'s uninterrupted loop, or ``one_card_train`` when that
# phase did not run)
TRAIN_ONE_CARD: dict = {}


def train_batch(cfg, src, i: int, rows: int, seq: int) -> dict:
    """Batch ``i`` of ``src`` (SyntheticLM) with the family's stubbed
    frontend inputs drawn with numpy from ``i``: whisper's "frames" (rows,
    encoder_frames, d_model), the VLM's "image_embeds" (rows,
    num_image_tokens, d_model), the stubs of the tests'
    ``_mesh_ranks.with_frontend``; the same on every rank."""
    batch = src.lm_batch(i, rows, seq)
    rng = np.random.default_rng(i)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (rows, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (rows, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def train_case(case: str):
    """(model, axes, initial params on the CPU, batches) of a reduced
    train case (an arch, or a case of ``MESH_CASES``); every rank and the
    script make the same."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import serve as SV
    from repro_torch.models import build_model
    from repro_torch.models.param import split
    arch, fields = MESH_CASES.get(case, (case, {}))
    fields = {"num_layers": MESH_TRAIN_LAYERS.get(arch, 2),
              **MESH_TRAIN_QUAD.get(case, {}), **fields,
              "compute_dtype": "float32", "remat": False}
    cfg = dataclasses.replace(SV.make_config(arch, reduced=True), **fields)
    model = build_model(cfg)
    params, axes = split(model.init(0, device="cpu"))
    src = SyntheticLM(cfg.vocab_size, seed=0)
    batches = [train_batch(cfg, src, i, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ)
               for i in range(MESH_TRAIN_STEPS)]
    return model, axes, params, batches


def train_run(case: str, mesh=None, device="cpu") -> dict:
    """``MESH_TRAIN_STEPS`` of ``make_train_step(param_axes=)`` under the
    train rules on ``mesh`` (the state placed by ``train.loop
    .state_specs``), or in one process on ``device`` for None: each
    step's metrics, and the step-1 gradients and final params made whole
    (CPU tensors by path)."""
    from repro_torch.core.calibration import flatten_params
    from repro_torch.distributed import sharding as S
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import loop as TL
    from repro_torch.train import step as TS
    from repro_torch.tree import tree_map
    model, axes, params, batches = train_case(case)
    params = tree_map(lambda t: t.to(device), params)
    state = TS.TrainState(0, params, adamw_init(params))
    rules = S.rules_for("train")
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
                              **MESH_TRAIN_LR)
    metrics = []
    with (S.shard_ctx(mesh, rules) if mesh is not None
          else contextlib.nullcontext()):
        for batch in batches:
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})

    def whole(tree):
        if mesh is not None:
            tree = S.unplace(tree, specs.params, mesh)
        return {k: t.cpu() for k, t in flatten_params(tree).items()}
    return {"metrics": metrics, "grads": whole(grads[0]),
            "params": whole(state.params)}


def train_drop(mesh) -> list:
    """deepseek-7b: 2 steps on ``mesh``, ``remesh`` to ``MESH_DROP_TO``
    and ``drop_and_continue`` onto its ranks, 1 more step there; the
    losses this rank saw."""
    from repro_torch.distributed import sharding as S
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import loop as TL
    from repro_torch.train import step as TS
    from repro_torch.tree import tree_map
    model, axes, params, batches = train_case("deepseek-7b")
    params = tree_map(lambda t: t.to(mesh.device), params)
    rules = S.rules_for("train")
    specs = TL.state_specs(model, mesh, rules)
    state = S.place(TS.TrainState(0, params, adamw_init(params)), specs,
                    mesh)
    step = TS.make_train_step(model, param_axes=axes, **MESH_TRAIN_LR)
    losses = []
    with S.shard_ctx(mesh, rules):
        for batch in batches[:2]:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    shape, new_specs = TL.remesh(model, state, mesh, *MESH_DROP_TO, rules)
    sub, state = TL.drop_and_continue(state, specs, mesh, new_specs, shape)
    if sub is not None:
        with S.shard_ctx(sub, rules):
            state, m = step(state, batches[2])
            losses.append(float(m["loss"]))
    return losses


def train_within(got: dict, want: dict, case: str) -> tuple:
    """The worst of each measure of a mesh train run of ``case`` against a
    reference: the first step's metrics' relative gaps, the later steps',
    gradients' max |diff| over the tensor's max |g| and params' max
    |diff|, each asserted within its limit (``train_reference_phase``'s
    tolerances: 1e-5, 1e-5, ``BWD_TOL`` 1e-5 and 1e-3; the later and
    gradient limits ``MESH_TRAIN_LIMITS``' for its cases).  Returns (the
    gaps, the limits)."""
    later, grad_tol = MESH_TRAIN_LIMITS.get(
        case, (1e-5, BWD_TOL[torch.float32]))
    limits = {"step 1": 1e-5, "later": later, "grad": grad_tol,
              "param": 1e-3}

    def rel(steps):
        return {k: max((abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                        for g, w in steps), default=0.0)
                for k in ("loss", "grad_norm", "moe_aux")}
    pairs = list(zip(got["metrics"], want["metrics"]))
    first, rest = rel(pairs[:1]), rel(pairs[1:])
    grad = max(((got["grads"][k] - w).abs().max()
                / w.abs().max().clamp(min=1e-30)).item()
               for k, w in want["grads"].items())
    param = max((got["params"][k] - w).abs().max().item()
                for k, w in want["params"].items())
    out = {**{f"{k} rel step 1": v for k, v in first.items()},
           **{f"{k} rel later": v for k, v in rest.items()},
           "grad": grad, "param": param}
    assert all(v <= 1e-5 for v in first.values()), (case, out)
    assert all(v <= later for v in rest.values()), (case, out)
    assert grad <= grad_tol and param <= 1e-3, (case, out)
    assert [g["lr"] for g in got["metrics"]] == [
        w["lr"] for w in want["metrics"]], (case, out)
    return out, limits


def mesh_train_rank(mesh, cases, drop: bool) -> dict:
    """A reduced rank's training: ``train_run`` of each case, and with
    ``drop`` the drop-and-continue (``train_drop``)."""
    t0 = time.perf_counter()
    out = {case: train_run(case, mesh, mesh.device) for case in cases}
    if drop:
        out["drop"] = train_drop(mesh)
    out["seconds"] = round(time.perf_counter() - t0, 1)
    return out


def full_train_config(arch: str, layers: int):
    """The full-width config a train run of ``arch`` takes: qwen3-8b at
    ``train_phase``'s ``TRAIN_LAYERS``, a family at its entry of
    ``MESH_FAMILY_TRAIN_FULL``; bf16 compute and remat (the configs'
    own)."""
    from repro_torch.launch import serve as SV
    cfg = SV.make_config(arch, num_layers=layers)
    assert cfg.remat and cfg.compute_dtype == "bfloat16", cfg
    return cfg


def one_card_train(dev, arch: str = ARCH, layers: int = TRAIN_LAYERS
                   ) -> dict:
    """``arch`` at full width on one card (qwen3-8b at ``train_phase``'s
    configuration): ``MESH_TRAIN_FULL_STEPS`` steps of its uninterrupted
    loop (the same state and batches as ``mesh_full_train``): losses and
    grad norms."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train import step as TS
    cfg = full_train_config(arch, layers)
    model = build_model(cfg)
    state = TS.init_train_state(model, 0, dev)
    step = TS.make_train_step(model, total_steps=TRAIN_STEPS, **TRAIN_LR)
    src = SyntheticLM(cfg.vocab_size, seed=0)
    out = {"losses": [], "grad_norm": []}
    for i in range(MESH_TRAIN_FULL_STEPS):
        state, m = step(state, train_batch(cfg, src, i, TRAIN_BATCH,
                                           TRAIN_SEQ))
        out["losses"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_full_train(mesh, arch: str = ARCH, layers: int = TRAIN_LAYERS
                    ) -> dict:
    """``arch`` at full width (``full_train_config``: bf16 compute, remat,
    ``TRAIN_LR``) on this rank of the full-width (1, 2) mesh:
    ``MESH_TRAIN_FULL_STEPS`` steps of the uninterrupted loop's batches
    from its initial state (each rank draws the whole params on its card
    in turn and keeps its blocks, which ``sharding.place`` copies):
    losses, grad norms, each step's ms and the rank's peak memory."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import sharding as S
    from repro_torch.models import build_model
    from repro_torch.models.param import split
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import loop as TL
    from repro_torch.train import step as TS
    dev = mesh.device
    cfg = full_train_config(arch, layers)
    model = build_model(cfg)
    rules = S.rules_for("train")
    specs = TL.state_specs(model, mesh, rules)
    _, axes = split(model.init(0, device="meta"))
    torch.cuda.reset_peak_memory_stats(dev)
    local = None
    for turn in range(mesh.size):
        if turn == mesh.rank:
            params, _ = split(model.init(0, device=dev))
            local = S.place(params, specs.params, mesh)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        mesh.barrier()
    state = TS.TrainState(0, local, adamw_init(local))
    step = TS.make_train_step(model, param_axes=axes,
                              total_steps=TRAIN_STEPS, **TRAIN_LR)
    src = SyntheticLM(cfg.vocab_size, seed=0)
    out = {"losses": [], "grad_norm": [], "step_ms": []}
    with S.shard_ctx(mesh, rules):
        for i in range(MESH_TRAIN_FULL_STEPS):
            batch = train_batch(cfg, src, i, TRAIN_BATCH, TRAIN_SEQ)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            out["losses"].append(m["loss"].item())
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
            out["grad_norm"].append(m["grad_norm"].item())
    out["peak_GB"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del state, local, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cross_pod_run(mesh) -> dict:
    """The step-1 gradients of reduced deepseek-7b on the batch of the
    rank's pod (one process's ``value_and_grad`` on its card), their
    ``cross_pod_grad_mean`` over "pod" and the bytes it sent against
    ``wire_bytes``; CPU tensors by path."""
    from repro_torch.core.calibration import flatten_params
    from repro_torch.distributed import compression as GC
    from repro_torch.train import step as TS
    from repro_torch.tree import tree_map
    model, _, params, batches = train_case("deepseek-7b")
    params = tree_map(lambda t: t.to(mesh.device), params)
    _, _, grads = TS.value_and_grad(TS.make_loss_fn(model), params,
                                    batches[mesh.coord("pod")])
    sent: list = []
    mean = GC.cross_pod_grad_mean(grads, mesh, sent=sent)
    flat = flatten_params(grads)
    return {"grads": {k: t.cpu() for k, t in flat.items()},
            "mean": {k: t.cpu() for k, t in flatten_params(mean).items()},
            "sent": sum(sent),
            "wire": sum(GC.wire_bytes(g)[0] for g in flat.values())}


def check_train(shape, ranks, train_want: dict, dev) -> None:
    """Every rank's train runs (``mesh_train_rank``) against the
    one-process runs on the CPU and on the card (``train_want``, by (case,
    device)); the drop-and-continue's losses against the uninterrupted
    ones."""
    for case in ranks[0]["train"]:
        if case in ("drop", "seconds"):
            continue
        worst = {}
        for g in ranks:
            assert g["train"][case]["metrics"] == ranks[0]["train"][
                case]["metrics"], (shape, case, "ranks disagree")
            for where in ("cpu", dev):
                worst[str(where)], lim = train_within(
                    g["train"][case], train_want[case, str(where)], case)
        print(f"mesh {shape} train {case}: 3 steps under "
              "rules_for('train'), every rank's metrics, gathered "
              "step-1 gradients and final params against one process "
              "(last rank's worst gaps; limits: metrics "
              f"{lim['step 1']:.0e} rel at step 1, {lim['later']:.0e} "
              f"later, grads {lim['grad']:.0e} of max |g|, params "
              f"{lim['param']:.0e} abs): "
              + "; ".join(f"{w} " + ", ".join(
                  f"{k} {v:.2e}" for k, v in gaps.items())
                  for w, gaps in worst.items()))
    if "drop" in ranks[0]["train"]:
        for where in ("cpu", dev):
            want = [m["loss"] for m in train_want[
                "deepseek-7b", str(where)]["metrics"]]
            for g in ranks:
                got = g["train"]["drop"]
                assert len(got) == (3 if g["coords"][0] == 0 else 2), g
                np.testing.assert_allclose(got, want[:len(got)],
                                           rtol=1e-5)
        print(f"mesh {shape} train drop-and-continue: 2 steps, remesh "
              f"to {MESH_DROP_TO} and 1 more: losses "
              f"{ranks[0]['train']['drop']} within 1e-5 rel of 3 "
              f"uninterrupted one-process steps (card "
              f"{[m['loss'] for m in train_want['deepseek-7b', str(dev)]['metrics']]})")
    print(f"mesh {shape} train: rank 0 {ranks[0]['train']['seconds']} s")


def mesh_refuse(mesh):
    """A rank that raises on purpose: the world is not a (2, 2) mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    make_host_mesh(2, 2)


def mesh_single_card(dev, entries, mesh_tokens: dict,
                     mesh_routing: dict) -> dict:
    """The full-width runs of ``mesh_full_rank`` on one card, eagerly:
    the tokens the mesh's (``mesh_tokens``, by (arch, run)) are compared
    with, and for each request whose tokens part from the mesh's, the
    top-2 logit margin on one card where they part (``divergence``: a
    batch-of-one forward, whose MoE capacity groups are not the served
    batch's); for each run in ``mesh_routing``, the first routing choice
    where one card's rerun parts from the mesh's (``routing_parting``)."""
    from repro_torch.launch import serve as SV
    out = {}
    for entry in entries:
        arch, cfg = mesh_full_config(*entry)
        n_var, bank, full_runs = full_plan(entry[0])
        model, base, dms = SV.build_variants(cfg, n_var, dev)
        runs = [(run, "fp") for run in full_runs] + [
            (run, "int8") for run in MESH_INT8_FULL.get(arch, ())]
        for run, bd in runs:
            n_req, budgets = full_runs[run]
            label = mesh_run(run, bd)
            dep = mesh_deploy(model, base, dms, None, None, dev, run,
                              bank=bank, graphs=False, base_dtype=bd)
            mesh_warm(dep, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rids = SV.submit_requests(dep, cfg, n_req, budgets)
            dep.drain()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            m = dep.metrics
            tokens = [dep.result(r).out_tokens for r in rids]
            theirs = mesh_tokens[arch, label]
            out[arch, label] = {
                "tokens": tokens,
                "ladder": dep.status().get("speculative"),
                "tokens_per_s": m["tokens_generated"] / secs,
                "mean_step_ms": 1e3 * m["decode_seconds"]
                / max(1, m["decode_steps"]),
                "margins": [divergence(dep, model, [rid], [mine], [other],
                                       SV.PROMPT_LEN).rpartition(" ")[2]
                            for rid, mine, other in zip(rids, tokens,
                                                        theirs)
                            if mine != other]}
            if (arch, label) in mesh_routing:
                with routing_recorded() as calls:
                    rids = SV.submit_requests(dep, cfg, n_req, budgets)
                    dep.drain()
                theirs = mesh_routing[arch, label]
                out[arch, label]["routing"] = (
                    f"rerun tokens as the timed run's: mesh "
                    f"{theirs['tokens'] == mesh_tokens[arch, label]}, "
                    "one card "
                    f"{[dep.result(r).out_tokens for r in rids] == tokens}; "
                    + routing_parting(theirs["calls"], calls))
            # a deployment's bank and residents go before the next one's
            del dep
            gc.collect()
            torch.cuda.empty_cache()
        del model, base, dms
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_phase(dev, fp32_twin: bool = False) -> dict:
    """Mesh-sharded serving (explicit SPMD, ``distributed/sharding``):
    ranks started by ``launch.mesh.spawn``, each rank its own card over
    NCCL when there are cards enough, else card 0 shared over gloo (the
    kernels run on the card either way).  The kernel library was built
    before any rank starts; rank 0 loads it first.

    1. reduced deepseek-7b and deepseek-moe-16b (fp32 compute) on (1, 2),
       (2, 1) and (2, 2) at once: continuous banked, group fused and group
       dense, 2 variants, both kernel dispatch modes, over an fp32 base
       and, on ``MESH_INT8_SHAPES``, over an int8 base (each rank
       quantizes its blocks; the q8 kernel bodies run per rank); every
       rank's tokens must equal the single-process CPU plain path's over
       the same base; on (1, 2) one publish, update and rollback through
       a store (rank 0 writes) with the CPU's tokens and versions, and
       ``launch.serve`` over an int8 base with ``--updates 1`` whose
       version lines and tokens must equal the same calls made directly
       on a Deployment of the same mesh (``mesh_launcher_run``);
    2. full width on (1, 2): qwen3-8b (1 layer) and deepseek-moe-16b (2
       layers, 64 experts, top-6; with ``fp32_twin`` also
       deepseek-moe-16b at 4 layers and fp32 compute), 3 variants,
       continuous over a 4-slot bank and group fused, then
       ``MESH_INT8_FULL``'s runs over an int8 base; every rank's int8
       blocks bit-identical to the single-card quantization's
       (``int8_blocks_check``); every per-rank delta GEMM launch (q8
       bodies included) of one prefill and one decode step within the
       GEMM bound of its plain version on the same local operands; the
       all-reduced wo and w_down against the single-card kernel over both
       bases; token agreement with the same runs on one card over the
       same base (printed: bf16 near-ties move with the all-reduce's
       order) and, for MoE, the first routing choice where the two part
       (``routing_parting``), launches per rank, peak memory and base
       bytes per rank, tokens/s and the mean step;
    3. a rank that raises (a world that is not the mesh's size) must end
       its group with an error within the deadline.

    Speculative decoding and ``warmup()`` under a mesh: in 1., each arch
    of ``MESH_SPEC_ARCHS`` served speculatively on (1, 2) and (2, 2), and
    the 6-head config on (1, 4), every rank's tokens equal to the CPU's
    continuous tokens and every rank's ladder snapshot the same; on
    ``MESH_WARM_SHAPE`` a continuous deployment warmed first (the CPU's
    outcome keys, each "eager"; then the CPU's tokens); in 2., qwen3-8b
    served speculatively too, every per-rank banked launch of a wave's
    prefill and verify round checked, exact budgets, token agreement and
    acceptance beside one card's speculative run.

    The audio, VLM, xLSTM and Zamba families: in 1., the runs of
    ``MESH_FAMILIES`` (continuous and group fused, both kernel dispatch
    modes) on (1, 2) and (2, 2), and a (1, 4) group with the cases of
    ``MESH_QUAD_ARCHS`` and the 6-head sequence-TP config at two prompt
    lengths (the attention layouts each took asserted); in 2.,
    ``MESH_FAMILY_FULL``, with the all-reduced products of
    ``ALLREDUCE_PATHS``, exact budgets and the ranks' peaks summed under
    ``MESH_PEAK_GB``: internvl2-76b after ``MESH_FULL`` in one group, the
    entries of ``MESH_FULL_SIDE`` in a second group beside it.

    Training under a mesh: in 1., the cases of ``MESH_TRAIN_ARCHS`` on
    every reduced group, the families of ``MESH_FAMILIES`` on (1, 2)
    and (2, 2) and the cases of ``MESH_TRAIN_QUAD`` on (1, 4), 3 fp32
    steps a case, every rank held to one process on the CPU and on the
    card (``check_train``; the recurrent families' later metrics or
    step-1 gradients to ``MESH_TRAIN_LIMITS``), and (2, 2) dropped to
    (1, 2) after 2
    steps;
    in 2., after the main group's serving entries, qwen3-8b and then the
    families of ``MESH_FAMILY_TRAIN_FULL`` trained 2 steps at full width
    (bf16, remat, ``TRAIN_BATCH`` x ``TRAIN_SEQ``), their losses within
    2^-7 rel of one card's first 2 steps.

    Every group of 1. and 2. starts at once, so the full-width times are
    taken beside the reduced ranks, and
    the card's memory in use by every process on it, sampled while they
    run, must stay under ``MESH_PEAK_GB`` too.

    Returns {run label: [launches of each rank]}."""
    import shutil
    import tempfile

    from repro_torch.launch import mesh as LM
    from repro_torch.launch import serve as SV

    n_cards = torch.cuda.device_count()
    backends = {shape: LM.backend_for("cuda", shape[0] * shape[1])
                for shape in MESH_REF_SHAPES}
    print(f"mesh: {n_cards} card(s); backends {backends}")
    launches = {}
    # 1. reduced, card against the CPU
    store_root = tempfile.mkdtemp(prefix="mesh_store_", dir=os.path.join(
        ROOT, "build"))
    print(f"mesh: this process holds "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB before the ranks "
          "start")
    # every group starts at once: the reduced ranks' tiny steps wait on
    # the shared card and on the host hop of each collective, the
    # full-width ranks mostly on host copies, so they overlap (the
    # full-width times are taken under that contention)
    entries = MESH_FULL + (MESH_FP32_TWIN if fp32_twin else ()) \
        + MESH_FAMILY_FULL
    side = tuple(e for e in entries if e[0] in MESH_FULL_SIDE)
    t0 = time.perf_counter()
    for arch, layers in MESH_FAMILY_TRAIN_FULL:
        # the one-card runs the families' full-width mesh training is
        # held to, before any rank holds the card
        TRAIN_ONE_CARD[arch] = one_card_train(dev, arch, layers)
    print(f"mesh: one-card full-width train runs of "
          f"{[a for a, _ in MESH_FAMILY_TRAIN_FULL]}: "
          f"{time.perf_counter() - t0:.1f} s")
    card = CardInUse(dev).start()
    t_ref = time.perf_counter()
    if ARCH not in TRAIN_ONE_CARD:
        # the one-card run the full-width mesh training is held to, when
        # the train phase did not run before (``--mesh-only``)
        TRAIN_ONE_CARD[ARCH] = one_card_train(dev)
    full = [LM.start(mesh_full_rank, MESH_FULL_SHAPE, device="cuda",
                     timeout_s=MESH_TIMEOUT_S, args=(group, train))
            for group, train in ((tuple(e for e in entries
                                        if e not in side), True),
                                 (side, False))]
    quad = LM.start(mesh_quad_rank, MESH_QUAD_SHAPE, device="cuda",
                    timeout_s=MESH_TIMEOUT_S, threads=REDUCED_THREADS)
    groups = {shape: LM.start(mesh_ref_rank, shape, device="cuda",
                              timeout_s=MESH_TIMEOUT_S,
                              args=(store_root if shape == (1, 2)
                                    else None, shape in MESH_INT8_SHAPES,
                                    shape in MESH_FAMILY_SHAPES,
                                    shape in MESH_FAMILY_SHAPES,
                                    shape == MESH_WARM_SHAPE,
                                    shape == MESH_DROP_SHAPE),
                              threads=REDUCED_THREADS)
              for shape in MESH_REF_SHAPES}
    t0 = time.perf_counter()
    # the CPU plain runs are as small as the reduced ranks' and share the
    # host's cores with every rank
    threads = torch.get_num_threads()
    torch.set_num_threads(REDUCED_THREADS)
    want = {}
    for arch in dict.fromkeys(MESH_FAMILIES + MESH_QUAD_ARCHS
                              + (MESH_SEQ_ARCH,)):
        cfg, model, base, dms, axes = mesh_ref_setup(arch)
        runs = ([(run, run, SV.PROMPT_LEN) for run in MESH_FAMILY_RUNS]
                if arch != MESH_SEQ_ARCH else
                [(f"prompt {n} continuous", "continuous", n)
                 for n in MESH_SEQ_PROMPTS])
        for label, run, n in runs:
            dep = mesh_deploy(model, base, dms, axes, None, "cpu", run,
                              prompt_len=n)
            rids = SV.submit_requests(dep, cfg, 6, MESH_REF_BUDGETS)
            dep.drain()
            want[arch, label] = [dep.result(r).out_tokens for r in rids]
            assert [len(t) for t in want[arch, label]] == [
                MESH_REF_BUDGETS[i % len(MESH_REF_BUDGETS)]
                for i in range(6)], (arch, label)
    for arch in MESH_REF_ARCHS:
        cfg, model, base, dms, axes = mesh_ref_setup(arch)
        for run in MESH_RUNS:
            for bd in ("fp", "int8"):
                dep = mesh_deploy(model, base, dms, axes, None, "cpu", run,
                                  base_dtype=bd)
                rids = SV.submit_requests(dep, cfg, 6, MESH_REF_BUDGETS)
                dep.drain()
                want[arch, mesh_run(run, bd)] = [dep.result(r).out_tokens
                                                 for r in rids]
        if arch == MESH_REF_ARCHS[0]:
            with tempfile.TemporaryDirectory() as tmp:
                want_store = mesh_store_run(model, base, dms, axes, None,
                                            "cpu", tmp)
            # the outcome keys warmup() returns on one device
            want_warm = set(mesh_deploy(model, base, dms, axes, None, "cpu",
                                        "continuous").warmup())
    # the reduced train cases in one process, on the CPU and on the card
    train_want = {(case, str(where)): train_run(case, None, where)
                  for case in dict.fromkeys(
                      MESH_TRAIN_ARCHS + MESH_FAMILIES
                      + tuple(MESH_TRAIN_QUAD))
                  for where in ("cpu", dev)}
    torch.set_num_threads(threads)
    print(f"mesh reference: CPU plain runs and the reduced train cases in "
          f"one process {time.perf_counter() - t0:.1f} s")


    def check_reduced(shape, ranks):
        """Every rank's tokens and launches of a reduced group against
        the CPU's; its launches into ``launches``."""
        for r, got in enumerate(ranks):
            for (arch, kd, run), res in got["runs"].items():
                ref = want[arch, ref_run(run)]
                assert res["tokens"] == ref, (
                    shape, r, arch, kd, run, res["tokens"], ref)
                kernel = RUN_KERNEL[ref_run(run).removesuffix(
                    " int8").split()[-1]]
                assert res["launches"][kernel] > 0, (shape, arch, run, res)
                if "speculative" in run:
                    # the ranks walked the ladder in step
                    assert res["ladder"] == ranks[0]["runs"][
                        arch, kd, run]["ladder"], (shape, arch, run)
                    assert res["ladder"]["rounds"] > 0, res["ladder"]
                if arch == "deepseek-moe-16b" \
                        and not run.startswith("group dense"):
                    assert res["launches"]["bitlinear_axes_stacked"] > 0
            if "warmup" in got:
                assert set(got["warmup"]) == want_warm, got["warmup"]
                assert set(got["warmup"].values()) == {"eager"}, \
                    got["warmup"]
            if "store" in got:
                assert got["store"] == want_store, (got["store"], want_store)
            if "launcher" in got:
                lr = got["launcher"]
                assert lr["tokens"] == lr["direct_tokens"], lr
                assert lr["direct_versions"] == [2, 1], lr
                assert lr["lines"] == ([] if r else [
                    "update 0: v0 -> version 2",
                    "rollback: v0 -> version 1"]), lr["lines"]
                assert [len(t) for t in lr["tokens"]] == [3] * (
                    4 + LANES + 1), lr["tokens"]
        for (arch, kd, run) in ranks[0]["runs"]:
            launches[f"mesh {arch} reduced {run} {kd} {shape}"] = [
                g["runs"][arch, kd, run]["launches"] for g in ranks]
        if shape == MESH_QUAD_SHAPE:
            # the 6-head config: sequence-TP at a prompt length that
            # splits over 4 ranks, every head on every rank at one that
            # does not (JAX's flat-q_dim branch) and at decode (s = 1)
            for g in ranks:
                assert g["layouts"] == {
                    n: ["seq", "whole"] if n % 4 == 0 else ["whole"]
                    for n in MESH_SEQ_PROMPTS}, g["layouts"]
            print(f"mesh {shape} reduced ({ranks[0]['backend']}, rank 0 "
                  f"{ranks[0]['seconds']} s): every "
                  f"rank's tokens == CPU plain tokens for "
                  f"{len(ranks[0]['runs'])} runs of {MESH_QUAD_ARCHS} (2 SSM "
                  f"or mLSTM heads over 4 ranks) and {MESH_SEQ_ARCH} with "
                  f"{MESH_SEQ_FIELDS['num_heads']} q heads (attention "
                  f"layouts by prompt length {ranks[0]['layouts']}; both "
                  "kernel dispatch modes; speculative at prompt "
                  f"{MESH_SEQ_PROMPTS[0]}: the continuous tokens, one "
                  "ladder on every rank)")
            return
        n_int8 = sum("int8" in run for _, _, run in ranks[0]["runs"])
        n_fam = sum(a in MESH_FAMILIES for a, _, _ in ranks[0]["runs"])
        spec = {a: (r["ladder"]["acceptance"], r["ladder"]["rounds"])
                for (a, _, run), r in ranks[0]["runs"].items()
                if run == "speculative"}
        print(f"mesh {shape} reduced ({ranks[0]['backend']}, "
              f"{sorted({g['device'] for g in ranks})}): every rank's "
              f"tokens == CPU plain tokens for {len(ranks[0]['runs'])} runs "
              f"({n_int8} over an int8 base; both kernel dispatch modes"
              + (f"; {n_fam} of {MESH_FAMILIES}, rank 0 "
                 f"{ranks[0]['family_s']} s" if n_fam else "") + ")"
              + (f"; speculative == the CPU's continuous tokens, one "
                 f"ladder on every rank, (acceptance, rounds) {spec}"
                 if spec else "")
              + (f"; warmup() {len(ranks[0]['warmup'])} entries, each "
                 "'eager', the CPU's keys, then the CPU's tokens"
                 if "warmup" in ranks[0] else "")
              + ("; store publish/update/rollback == CPU "
                 f"{want_store['versions']}, rollback to "
                 f"{want_store['rollback']}; launch.serve --base-dtype int8"
                 " --updates 1 on the mesh: "
                 f"{ranks[0]['launcher']['lines']}, tokens == the direct "
                 "update + rollback run's on every rank"
                 if shape == (1, 2) else ""))
    for shape, group in groups.items():
        ranks = group.join()
        check_reduced(shape, ranks)
        check_train(shape, ranks, train_want, dev)
    shutil.rmtree(store_root, ignore_errors=True)
    ranks = quad.join()
    check_reduced(MESH_QUAD_SHAPE, ranks)
    check_train(MESH_QUAD_SHAPE, ranks, train_want, dev)
    print(f"mesh reduced: {time.perf_counter() - t_ref:.1f} s, the four "
          "meshes beside the full-width ranks")
    # 2. full width: the mesh (each rank's results of both groups
    # merged), then the same runs on one card
    ranks, side_ranks = (group.join() for group in full)
    card.stop()
    for mine, other in zip(ranks, side_ranks):
        for key in ("runs", "checks", "routing", "seconds"):
            mine[key].update(other[key])
    for arch, layers in ((ARCH, TRAIN_LAYERS),) + MESH_FAMILY_TRAIN_FULL:
        one = TRAIN_ONE_CARD[arch]
        cfg = full_train_config(arch, layers)
        depth = (f"{cfg.encoder_layers} + {cfg.num_layers}"
                 if cfg.family == "audio" else f"{cfg.num_layers}")
        for g in ranks:
            tr = g["train"][arch]
            assert tr["losses"] == ranks[0]["train"][arch]["losses"], (
                arch, "ranks disagree")
            gaps = [abs(a - b) / abs(b) for a, b in zip(tr["losses"],
                                                        one["losses"])]
            assert all(x <= 2 ** -7 for x in gaps), (arch, tr["losses"],
                                                     one, gaps)
            print(f"mesh full width train {arch} ({depth} layers, bf16, "
                  f"remat, {TRAIN_BATCH} x {TRAIN_SEQ}) rank "
                  f"{g['coords']}: losses {tr['losses']} vs one card "
                  f"{one['losses']} (rel gap {max(gaps):.2e}, limit 2^-7); "
                  f"grad_norm {tr['grad_norm']} vs one card "
                  f"{one['grad_norm']} (rel gap "
                  f"{max(abs(a - b) / b for a, b in zip(tr['grad_norm'], one['grad_norm'])):.2e}); "
                  f"step ms {[round(x, 1) for x in tr['step_ms']]}; peak "
                  f"{tr['peak_GB']:.2f} GB")
        peaks = [g["train"][arch]["peak_GB"] for g in ranks]
        assert sum(peaks) < MESH_PEAK_GB, (arch, peaks)
    print(f"mesh full width {MESH_FULL_SHAPE} ({ranks[0]['backend']}, "
          f"{sorted({g['device'] for g in ranks})}): "
          f"{time.perf_counter() - t_ref:.1f} s since the groups started; "
          f"rank 0 per entry (build, place, serve, checks) "
          f"{ranks[0]['seconds']}")
    print(f"mesh: the card's memory in use by every process on it while "
          f"the groups ran, sampled every {card.period * 1e3:.0f} ms: peak "
          f"{card.peak_gb:.2f} GB of {card.total_gb:.2f}")
    assert card.peak_gb < MESH_PEAK_GB, card.peak_gb
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    single = mesh_single_card(dev, entries,
                              {key: run["tokens"] for key, run
                               in ranks[0]["runs"].items()},
                              ranks[0]["routing"])
    print(f"mesh full width: single-card runs {time.perf_counter() - t0:.1f}"
          " s")
    for key, _ in ranks[0]["runs"].items():
        arch, run = key
        toks = [g["runs"][key]["tokens"] for g in ranks]
        assert all(t == toks[0] for t in toks), (key, "ranks disagree")
        ref = single[key]["tokens"]
        agree = sum(a == b for x, y in zip(toks[0], ref)
                    for a, b in zip(x, y))
        total = sum(len(y) for y in ref)
        same = sum(x == y for x, y in zip(toks[0], ref))
        assert [len(t) for t in toks[0]] == [len(t) for t in ref], key
        # every request finishes with its budget
        n_req, budgets = full_plan(arch.split()[0])[2][
            run.removesuffix(" int8")]
        assert [len(t) for t in toks[0]] == [
            budgets[i % len(budgets)] for i in range(n_req)], key
        peaks = [g["runs"][key]["peak_GB"] for g in ranks]
        assert sum(peaks) < MESH_PEAK_GB, (key, peaks)
        per_rank = [g["runs"][key]["launches"] for g in ranks]
        for kernel in (("bitlinear_axes_banked",)
                       if run.startswith(("continuous", "speculative"))
                       else ("bitlinear_axes",)):
            assert all(p[kernel] > 0 for p in per_rank), (key, per_rank)
        if arch.startswith("deepseek-moe-16b"):
            assert all(p["bitlinear_axes_stacked"] > 0 for p in per_rank)
        launches[f"mesh {arch} {run} {MESH_FULL_SHAPE}"] = per_rank
        chk = [g["checks"][key] for g in ranks]
        # every checked launch of an int8 run ran a q8 body, and only then
        assert all(c["q8"] == (c["launches"] if "int8" in run else 0)
                   for c in chk), (key, chk)
        spec_note = ""
        if run.startswith("speculative"):
            ladders = [g["runs"][key]["ladder"] for g in ranks]
            assert all(ld == ladders[0] for ld in ladders), ladders
            # the checked wave's prefill and verify round: banked only
            assert all(c["kernels"] == ["bitlinear_axes_banked"]
                       for c in chk), chk
            spec_note = (f"; acceptance {ladders[0]['acceptance']:.3f} in "
                         f"{ladders[0]['rounds']} rounds, k now "
                         f"{ladders[0]['current_k']}, the same ladder on "
                         "every rank (one card "
                         f"{single[key]['ladder']['acceptance']:.3f} in "
                         f"{single[key]['ladder']['rounds']} rounds)")
        r0 = ranks[0]["runs"][key]
        print(f"mesh {arch} {run}: tokens agree with one card "
              f"{agree}/{total} ({same}/{len(ref)} requests whole; one "
              f"card's top-2 logit margin where each other one parts: "
              f"{single[key]['margins']}); one "
              f"card eager: tokens/s {single[key]['tokens_per_s']:.1f}, "
              f"mean step {single[key]['mean_step_ms']:.2f} ms; mesh rank "
              f"0: {r0['seconds']:.2f} s, prefill {r0['prefill_s']:.2f} s, "
              f"decode {r0['decode_s']:.2f} s, {r0['prefills']} prefills, "
              f"{r0['decode_steps']} steps; launches per rank "
              f"{[{k: v for k, v in p.items() if v} for p in per_rank]}; "
              f"tokens/s {[round(g['runs'][key]['tokens_per_s'], 1) for g in ranks]}; "
              f"mean step ms {[round(g['runs'][key]['mean_step_ms'], 2) for g in ranks]}; "
              f"peak GB per rank {[round(g['runs'][key]['peak_GB'], 2) for g in ranks]}; "
              f"base GB per rank {[round(g['runs'][key]['base_GB'], 3) for g in ranks]}; "
              f"checked prefill+step: {[c['launches'] for c in chk]} "
              f"launches ({chk[0]['kernels']}) within the GEMM bound, max "
              f"|err| {max(c['max_abs_err'] for c in chk):.3e}{spec_note}")
        if "routing" in single[key]:
            print(f"mesh {arch} {run}: MoE routing, mesh vs one card: "
                  f"{single[key]['routing']}")
    for g in ranks:
        for (arch, label), checks in g["checks"].items():
            if not label.startswith("all-reduce"):
                continue
            for c in checks:
                print(f"mesh {arch} {label} rank {g['coords']}: {c['path']} "
                      "vs the single-card kernel max |err| "
                      f"{c['max_abs_err']:.3e} ({c['max_err_over_tol']:.3f} "
                      "of the summed bound)")
        assert {a for a, label in g["checks"]
                if label == "all-reduce"} == set(ALLREDUCE_PATHS), \
            sorted(g["checks"])
        for arch in MESH_INT8_FULL:
            c = g["checks"][arch, "int8 blocks"]
            assert c["leaves"] > 0 and c["in_dim_sharded"] > 0, c
            print(f"mesh int8 blocks rank {g['coords']} {arch}: "
                  f"{c['leaves']} quantized leaves ({c['in_dim_sharded']} "
                  "with the in dim sharded: the row absmax all-reduced) "
                  "bit-identical to the single-card quantization's blocks")
    if len({g["device"] for g in ranks}) == 1:
        print("mesh: the ranks share one card: these times say nothing of "
              "tensor-parallel speed-up")
    # 3. a rank that raises ends its group
    t0 = time.perf_counter()
    try:
        LM.spawn(mesh_refuse, (1, 2), device="cuda", timeout_s=120)
    except LM.RankFailure as e:
        assert "needs 4 ranks" in str(e), e
        secs = time.perf_counter() - t0
        assert secs < 120, secs
        print(f"mesh failure: a rank that raised ended its group in "
              f"{secs:.1f} s (deadline 120 s): "
              f"{str(e).strip().splitlines()[-1]}")
    else:
        raise AssertionError("a mismatched world size was accepted")
    return launches


# ---------------------------------------------------------------------------
# pod-local overlay banks on a (pod, data, model) mesh
# ---------------------------------------------------------------------------

# the JAX pod-bank tests' traffic: skewed to v0, so v0 re-routes warm
POD_TRAFFIC = ["v0", "v0", "v1", "v0", "v1", "v0", "v1", "v0"]
POD_REF_SHAPE = (2, 1, 2)
POD_REF_BUDGET = 4
POD_REF_RUNS = ("global", "pods shard_map", "pods gspmd",
                "pods shard_map async", "pods gspmd async")
# reduced deepseek-moe-16b in the same group: the global bank and the
# pod-local one under both kernel dispatch modes, over both bases
POD_MOE = "deepseek-moe-16b"
POD_MOE_RUNS = ("global", "pods shard_map", "pods gspmd")
# an MoE layer's tokens depend on the lanes' layout (a capacity group is
# the whole batch), and the affinity router lays ``POD_TRAFFIC`` out
# otherwise than one device's first-free-lane admission; this traffic's
# two waves land in the same lanes on both (v0 in pod 0's lanes, v1 in
# pod 1's, each at local slot 1 of its pod's bank), so the reduced MoE
# runs can be held to the CPU's tokens
POD_MOE_TRAFFIC = ["v0", "v0", "v1", "v1"] * 2
# the largest distance between two runs' router scores at which a parting
# still counts as a near-tie (fp32 sum order, not a different input)
TIE_DIST = 1e-3
# full width on (2, 1, 1) after the qwen3-8b ranks: deepseek-moe-16b, the
# dense first layer and one expert layer
POD_MOE_LAYERS = 2
POD_FULL_SHAPE = (2, 1, 1)
# qwen3-8b's depth on (2, 1, 1): 1 (2 until every family trained in the
# mesh phase, which took the time)
POD_FULL_LAYERS = 1
POD_FULL_BANK = 3             # slots a pod: the base and both variants
POD_FULL_BUDGET = 8
# (label, Deployment keywords, base dtype, warm both variants into both
# pods first); "global" is one bank replicated over the pods
POD_FULL_RUNS = (
    ("pods", dict(pod_banks=True), "fp", False),
    ("global", {}, "fp", False),
    ("pods int8", dict(pod_banks=True), "int8", False),
    ("pods warm", dict(pod_banks=True), "fp", True),
    ("pods warm async", dict(pod_banks=True, async_admission=True,
                             admission_pacing_s=0.0), "fp", True))
POD_LAUNCH_ARGS = ["--arch", "deepseek-7b", "--reduced", "--variants", "2",
                   "--requests", "6", "--new-tokens", "3", "--batch",
                   str(LANES), "--mode", "fused", "--scheduler",
                   "continuous", "--mesh", "2,1,1", "--pod-banks"]


def pod_kw(label: str) -> dict:
    """Deployment keywords of a reduced pod run's label."""
    if label == "global":
        return {}
    return dict(pod_banks=True, kernel_dispatch=label.split()[1],
                async_admission=label.endswith("async"),
                admission_pacing_s=0.0)


def pod_traffic(dep, cfg, budget: int, traffic=POD_TRAFFIC) -> list:
    """``traffic`` (default ``POD_TRAFFIC``) with the launcher's seeded
    prompts, drained; the request ids."""
    rng = np.random.default_rng(0)
    rids = [dep.submit(rng.integers(1, cfg.vocab_size, size=8), variant=v,
                       max_new_tokens=budget) for v in traffic]
    dep.drain()
    return rids


def pod_stats(dep, rids, budget: int) -> dict:
    """Tokens (every request with its budget), the router's counters,
    bank bytes and residents per pod and the admission bytes."""
    tokens = [dep.result(r).out_tokens for r in rids]
    assert [len(t) for t in tokens] == [budget] * len(rids), tokens
    st = dep.status()
    bank = dep.registry.bank
    return {"tokens": tokens, "affinity": st["affinity"],
            "bank_per_pod": st["hbm"]["bank_per_pod"],
            "resident_per_pod": st["hbm"]["bank_resident_per_pod"],
            "admit_bytes": (bank.stats["admit_bytes_in_pod"],
                            bank.stats["admit_bytes_cross_pod"])}


def pods_ref_rank(mesh) -> dict:
    """One rank of the reduced (2, 1, 2) mesh on the card: deepseek-7b at
    fp32 compute over an fp32 and an int8 base, the global bank and the
    pod-local one under both kernel dispatch modes, sync and async; then
    ``POD_MOE``'s runs of ``POD_MOE_RUNS`` (MoE under pod-local banks)
    over both bases; tokens, launches, router and bank counters of each
    run (an MoE run's label starts with the arch); first, the compressed
    cross-pod gradient exchange (``cross_pod_run``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"coords": mesh.coords, "device": str(mesh.device),
           "backend": mesh.backend, "runs": {},
           "cross pod": cross_pod_run(mesh)}
    for arch, labels in (("deepseek-7b", POD_REF_RUNS),
                         (POD_MOE, POD_MOE_RUNS)):
        cfg, model, base, dms, axes = mesh_ref_setup(arch)
        for bd in ("fp", "int8"):
            for label in labels:
                zero_counters()
                dep = mesh_deploy(model, base, dms, axes, mesh, mesh.device,
                                  "continuous", base_dtype=bd,
                                  **pod_kw(label))
                with routing_recorded() as calls:
                    rids = pod_traffic(dep, cfg, POD_REF_BUDGET,
                                       POD_TRAFFIC if arch == "deepseek-7b"
                                       else POD_MOE_TRAFFIC)
                name = mesh_run(label, bd)
                out["runs"][name if arch == "deepseek-7b"
                            else f"{arch} {name}"] = dict(
                    pod_stats(dep, rids, POD_REF_BUDGET),
                    launches=counters(),
                    async_admits=dep.metrics["async_admits"],
                    routing=calls if arch == POD_MOE else None)
                dep.close()
    return out


def pod_warm(dep) -> None:
    """Both variants resident in both pods before the traffic (through
    the admission pipeline on an async deployment, in the same order), so
    a sync and an async run route and batch alike."""
    names = dep.variants()[1:]
    for name in names:
        for pod in range(dep.registry.pods):
            if dep.admission is not None:
                dep.admission.prefetch(name, pod)
            else:
                with dep.engine._ctx():
                    dep.registry.bank_resolve(name, pod)
    if dep.admission is not None:
        dep.admission.wait(timeout=300.0)


def pods_full_rank(mesh) -> dict:
    """One rank of the full-width (2, 1, 1) mesh: qwen3-8b at 1 layer, 2
    variants, the continuous scheduler over ``POD_FULL_BANK`` slots a pod,
    the skewed traffic, each run of ``POD_FULL_RUNS`` timed; one more wave
    of the traffic through ``gemms_checked`` after each cold pod-local
    run (every per-rank banked launch, on pod-local slot ids, against its
    plain version on the same local operands)."""
    from repro_torch.launch import serve as SV
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    cfg = SV.make_config(ARCH, num_layers=POD_FULL_LAYERS)
    for turn in range(mesh.size):
        if turn == mesh.rank:
            model, base, dms, axes = SV.build_variants(cfg, 2, dev,
                                                       with_axes=True)
            base = tree_map(lambda t: t.cpu(), base)
            dms = [tree_map(lambda t: t.cpu(), dm) for dm in dms]
            gc.collect()
            torch.cuda.empty_cache()
        mesh.barrier()
    out = {"coords": mesh.coords, "device": str(dev),
           "backend": mesh.backend, "runs": {}}
    for label, kw, bd, warm in POD_FULL_RUNS:
        torch.cuda.reset_peak_memory_stats(dev)
        dep = mesh_deploy(model, base, dms, axes, mesh, dev, "continuous",
                          bank=POD_FULL_BANK, base_dtype=bd, **kw)
        if warm:
            pod_warm(dep)
        zero_counters()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rids = pod_traffic(dep, cfg, POD_FULL_BUDGET)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        m = dep.metrics
        res = dict(pod_stats(dep, rids, POD_FULL_BUDGET),
                   launches=counters(), seconds=secs,
                   mean_step_ms=1e3 * m["decode_seconds"]
                   / max(1, m["decode_steps"]),
                   decode_steps=m["decode_steps"],
                   commits=(dep.admission.stats["commits"]
                            if dep.admission is not None else None),
                   peak_GB=torch.cuda.max_memory_allocated(dev) / 1e9,
                   bank_GB=dep.registry.bank.nbytes() / 1e9)
        if not warm and kw.get("pod_banks"):
            with gemms_checked() as log:
                pod_traffic(dep, cfg, 2)
            res["checked"] = {
                "launches": len(log),
                "kernels": sorted({name for name, _, _ in log}),
                "max_abs_err": max(err for _, _, err in log)}
        out["runs"][label] = res
        dep.close()
        del dep
        gc.collect()
        torch.cuda.empty_cache()
    return out


def pods_moe_rank(mesh) -> dict:
    """One rank of the full-width (2, 1, 1) mesh for MoE under pod-local
    banks: ``POD_MOE`` at ``POD_MOE_LAYERS`` layers, 2 variants, the
    continuous scheduler over ``POD_FULL_BANK`` slots a pod, the skewed
    traffic timed; then one more wave through ``gemms_checked`` (every
    per-rank stacked launch on the pod's slots and every banked one on
    pod-local ids, against its plain version on the same local
    operands)."""
    from repro_torch.launch import serve as SV
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    cfg = SV.make_config(POD_MOE, num_layers=POD_MOE_LAYERS)
    for turn in range(mesh.size):
        if turn == mesh.rank:
            model, base, dms, axes = SV.build_variants(cfg, 2, dev,
                                                       with_axes=True)
            base = tree_map(lambda t: t.cpu(), base)
            dms = [tree_map(lambda t: t.cpu(), dm) for dm in dms]
            gc.collect()
            torch.cuda.empty_cache()
        mesh.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    dep = mesh_deploy(model, base, dms, axes, mesh, dev, "continuous",
                      bank=POD_FULL_BANK, pod_banks=True)
    zero_counters()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rids = pod_traffic(dep, cfg, POD_FULL_BUDGET)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    m = dep.metrics
    res = dict(pod_stats(dep, rids, POD_FULL_BUDGET), launches=counters(),
               seconds=secs, mean_step_ms=1e3 * m["decode_seconds"]
               / max(1, m["decode_steps"]), decode_steps=m["decode_steps"],
               peak_GB=torch.cuda.max_memory_allocated(dev) / 1e9)
    with gemms_checked() as log:
        pod_traffic(dep, cfg, 2)
    res["checked"] = {"launches": len(log),
                      "kernels": sorted({name for name, _, _ in log}),
                      "by_kernel": {k: sum(name == k for name, _, _ in log)
                                    for k in {name for name, _, _ in log}},
                      "max_abs_err": max(err for _, _, err in log)}
    dep.close()
    return {"coords": mesh.coords, "device": str(dev),
            "backend": mesh.backend, "run": res}


def pods_single_card(dev) -> dict:
    """The cold traffic of ``pods_full_rank`` on one card (the global bank
    of the same size, eager): its tokens and mean step."""
    from repro_torch.launch import serve as SV
    cfg = SV.make_config(ARCH, num_layers=POD_FULL_LAYERS)
    model, base, dms = SV.build_variants(cfg, 2, dev)
    dep = mesh_deploy(model, base, dms, None, None, dev, "continuous",
                      bank=POD_FULL_BANK, graphs=False)
    torch.cuda.synchronize(dev)
    rids = pod_traffic(dep, cfg, POD_FULL_BUDGET)
    torch.cuda.synchronize(dev)
    m = dep.metrics
    out = {"tokens": [dep.result(r).out_tokens for r in rids],
           "mean_step_ms": 1e3 * m["decode_seconds"]
           / max(1, m["decode_steps"])}
    del dep, model, base, dms
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_cross_pod(ranks, dev) -> None:
    """Each rank's ``cross_pod_grad_mean`` against the mean of the pods'
    ``quantize``/``dequantize`` computed in this process on the card, in
    rank order, bit for bit; the bytes each rank sent against
    ``wire_bytes``."""
    from repro_torch.distributed import compression as GC
    coords = [g["coords"] for g in ranks]
    n_leaves = 0
    for g in ranks:
        got = g["cross pod"]
        assert got["sent"] == got["wire"], (g["coords"], got["sent"],
                                            got["wire"])
        pods = [ranks[coords.index((p,) + g["coords"][1:])]["cross pod"][
            "grads"] for p in range(POD_REF_SHAPE[0])]
        for k, mean in got["mean"].items():
            xs = [p[k].to(dev) for p in pods]
            if GC._compressible(xs[0]):
                xs = [GC.dequantize(*GC.quantize(x), x.shape[-1])
                      for x in xs]
            acc = xs[0].float()
            for x in xs[1:]:
                acc = acc + x.float()
            want = (acc / len(xs)).to(mean.dtype).cpu()
            assert torch.equal(mean, want), (g["coords"], k)
            n_leaves += 1
    print(f"pods {POD_REF_SHAPE} cross_pod_grad_mean over 'pod' (reduced "
          f"deepseek-7b step-1 gradients, each pod its own batch): every "
          f"rank's mean == the pods' quantize/dequantize mean in rank order "
          f"on one card, bit for bit, {n_leaves // len(ranks)} leaves a "
          f"rank; bytes sent a rank {ranks[0]['cross pod']['sent']} == "
          f"wire_bytes (fp32: "
          f"{4 * sum(t.numel() for t in ranks[0]['cross pod']['grads'].values())})")


def pods_phase(dev) -> dict:
    """Pod-local overlay banks (``OverlayBank(pods=)``, the engine's
    affinity router, the lanes' slot ids translated to their pod's bank
    once a step) on a (pod, data, model) mesh whose ranks share card 0
    over gloo:

    1. reduced deepseek-7b (fp32 compute) on (2, 1, 2), over an fp32 and
       an int8 base: the global bank, then pod-local banks under both
       kernel dispatch modes, sync and async; every rank's tokens must
       equal the single-process CPU plain path's and the global bank's;
       the router must count hits and misses on the sync pod runs, and a
       pod-local bank must cross no pod boundary on admission where the
       global one does;
    2. full width on (2, 1, 1): qwen3-8b at 1 layer, 2 variants, the
       skewed traffic cold (pods, global, pods over an int8 base) and warm
       (pods sync and async: tokens must be equal); every per-rank banked
       launch of a checked wave, fp32 and q8 bodies, within the GEMM
       bound of its plain version; launches a rank, bank bytes per pod
       against the global bank's, admission bytes, hits and misses, and
       the mean step a rank beside one card's;
    3. ``python -m repro_torch.launch.serve --mesh 2,1,1 --pod-banks``
       (reduced deepseek-7b) as a fresh process.

    MoE under pod-local banks: in 1., reduced deepseek-moe-16b over the
    same traffic, the global bank and pod-local banks under both
    dispatch modes, over both bases, every rank's tokens the CPU's and
    the global bank's; in 2., once the qwen3-8b ranks have exited,
    deepseek-moe-16b at ``POD_MOE_LAYERS`` layers on (2, 1, 1) (beside
    the single-card qwen3-8b run): exact budgets, and every per-rank
    stacked and banked launch of a checked wave, on the pod's slots and
    pod-local ids, within the GEMM bound of its plain version.

    The three run at once (the full-width ranks' times are taken beside
    the other two; the card's memory in use by every process on it is
    sampled meanwhile; while the MoE ranks run it must stay under
    ``MESH_PEAK_GB``).

    Returns {run label: [launches of each rank]}."""
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import serve as SV

    launches = {}
    cache_dir = str(build._loaded_through[0].path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_COMPILE_CACHE_DIR=cache_dir)
    t_launch = time.perf_counter()
    # its own process group: a failure here ends the launcher and its ranks
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *POD_LAUNCH_ARGS],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT, start_new_session=True)
    try:
        # 1. reduced, card against the CPU, beside the full-width ranks
        # (as in the mesh phase: the two wait on different things)
        t0 = time.perf_counter()
        card = CardInUse(dev).start()
        full = LM.start(pods_full_rank, POD_FULL_SHAPE, device="cuda",
                        timeout_s=MESH_TIMEOUT_S)
        group = LM.start(pods_ref_rank, POD_REF_SHAPE, device="cuda",
                         timeout_s=MESH_TIMEOUT_S, threads=REDUCED_THREADS)
        want, cpu_routing = {}, {}
        for arch in ("deepseek-7b", POD_MOE):
            cfg, model, base, dms, axes = mesh_ref_setup(arch)
            for bd in ("fp", "int8"):
                dep = mesh_deploy(model, base, dms, axes, None, "cpu",
                                  "continuous", base_dtype=bd)
                with routing_recorded() as calls:
                    rids = pod_traffic(dep, cfg, POD_REF_BUDGET,
                                       POD_TRAFFIC if arch == "deepseek-7b"
                                       else POD_MOE_TRAFFIC)
                want[arch, bd] = [dep.result(r).out_tokens for r in rids]
                cpu_routing[arch, bd] = {"tokens": want[arch, bd],
                                         "routing": calls}
        ranks = group.join()
        check_cross_pod(ranks, dev)
        moe_partings = {}
        for r, got in enumerate(ranks):
            for label, res in got["runs"].items():
                bd = "int8" if label.endswith("int8") else "fp"
                arch = POD_MOE if label.startswith(POD_MOE) else \
                    "deepseek-7b"
                assert res["launches"]["bitlinear_axes_banked"] > 0, (
                    r, label, res["launches"])
                if arch == POD_MOE:
                    assert res["launches"]["bitlinear_axes_stacked"] > 0, (
                        r, label, res["launches"])
                    assert res["tokens"] == ranks[0]["runs"][label][
                        "tokens"], (r, label, "ranks disagree")
                    # the CPU's tokens and the global bank's on the mesh,
                    # up to a routing near-tie (``tokens_or_tie``)
                    glob = got["runs"][mesh_run(f"{POD_MOE} global", bd)]
                    for ref, names in ((cpu_routing[arch, bd], "CPU"),
                                       (glob, "global bank")):
                        note = tokens_or_tie(res, ref, (label, names))
                        if note and r == 0:
                            moe_partings[label, names] = note
                    label = label.removeprefix(f"{POD_MOE} ")
                else:
                    assert res["tokens"] == want[arch, bd], (
                        r, label, res["tokens"], want[arch, bd])
                af = res["affinity"]
                if label.startswith("pods"):
                    assert af["pods"] == 2 and af["misses"] > 0, (label, af)
                    assert sorted(res["bank_per_pod"]) == [0, 1], res
                    assert res["admit_bytes"][1] == 0, (label, res)
                    if "async" in label:
                        assert res["async_admits"] > 0, (label, res)
                    else:
                        assert af["hits"] > 0, (label, af)
                else:
                    assert res["admit_bytes"][1] == res["admit_bytes"][0] \
                        > 0, (label, res)
        for label in ranks[0]["runs"]:
            launches[f"pods reduced {label} {POD_REF_SHAPE}"] = [
                g["runs"][label]["launches"] for g in ranks]
        r0 = ranks[0]["runs"]
        n_moe = sum(k.startswith(POD_MOE) for k in r0)
        print(f"pods {POD_REF_SHAPE} reduced ({ranks[0]['backend']}, "
              f"{sorted({g['device'] for g in ranks})}): every rank's "
              f"tokens == CPU plain tokens == the global bank's for "
              f"{len(r0) - n_moe} deepseek-7b runs (both dispatch modes, "
              f"sync and async, fp32 and int8 base); affinity (sync, rank "
              f"0) {r0['pods shard_map']['affinity']}; admission bytes "
              f"(in-pod, cross-pod) pods {r0['pods shard_map']['admit_bytes']}"
              f" global {r0['global']['admit_bytes']}; "
              f"{time.perf_counter() - t0:.1f} s")
        print(f"pods {POD_REF_SHAPE} reduced {POD_MOE}, {n_moe} runs over "
              f"{POD_MOE_TRAFFIC} (both dispatch modes, fp32 and int8 base; "
              f"affinity {r0[POD_MOE + ' pods shard_map']['affinity']}): "
              "every rank's tokens == the CPU plain tokens and the global "
              "bank's on the mesh"
              + (f", except where the routing first parts at a near-tie: "
                 f"{moe_partings}" if moe_partings else ", in every run"))
        # 2. full width on (2, 1, 1), then the same cold traffic on one card
        ranks = full.join()
        card.stop()
        print(f"pods full width {POD_FULL_SHAPE} ({ranks[0]['backend']}, "
              f"{sorted({g['device'] for g in ranks})}): "
              f"{time.perf_counter() - t0:.1f} s since the groups started; "
              "the card's memory in use by every process on it, sampled "
              f"every {card.period * 1e3:.0f} ms: peak {card.peak_gb:.2f} "
              f"GB of {card.total_gb:.2f}")
        gc.collect()
        torch.cuda.empty_cache()
        # MoE at full width once the qwen3-8b ranks are gone, beside the
        # single-card qwen3-8b run
        t0 = time.perf_counter()
        card = CardInUse(dev).start()
        moe = LM.start(pods_moe_rank, POD_FULL_SHAPE, device="cuda",
                       timeout_s=MESH_TIMEOUT_S)
        single = pods_single_card(dev)
        print(f"pods full width: single-card run "
              f"{time.perf_counter() - t0:.1f} s")
        moe_ranks = moe.join()
        card.stop()
        per = [g["run"] for g in moe_ranks]
        assert all(p["tokens"] == per[0]["tokens"] for p in per), (
            POD_MOE, "ranks disagree")
        assert all(p["admit_bytes"][1] == 0 for p in per), per
        for p in per:
            assert p["launches"]["bitlinear_axes_stacked"] > 0, p
            assert p["launches"]["bitlinear_axes_banked"] > 0, p
            assert set(p["checked"]["kernels"]) == {
                "bitlinear_axes_stacked", "bitlinear_axes_banked"}, p
        assert card.peak_gb < MESH_PEAK_GB, card.peak_gb
        launches[f"pods {POD_MOE} pods {POD_FULL_SHAPE}"] = [
            p["launches"] for p in per]
        r0 = per[0]
        print(f"pods {POD_MOE} ({POD_MOE_LAYERS} layers) pods "
              f"{POD_FULL_SHAPE} ({moe_ranks[0]['backend']}): every budget "
              f"exact, the ranks' tokens the same; affinity "
              f"{r0['affinity']}; residents per pod "
              f"{r0['resident_per_pod']}; admission bytes (in-pod, "
              f"cross-pod) {r0['admit_bytes']}; launches per rank "
              f"{[{k: v for k, v in p['launches'].items() if v} for p in per]}"
              f"; mean step ms per rank "
              f"{[round(p['mean_step_ms'], 2) for p in per]}; "
              f"{r0['decode_steps']} steps, {r0['seconds']:.2f} s; peak GB "
              f"per rank {[round(p['peak_GB'], 2) for p in per]}; checked "
              f"wave: {[p['checked']['by_kernel'] for p in per]} launches "
              f"within the GEMM bound on the pod's slots and pod-local ids, "
              f"max |err| {max(p['checked']['max_abs_err'] for p in per):.3e}"
              f"; the card's memory in use peak {card.peak_gb:.2f} GB; "
              f"{time.perf_counter() - t0:.1f} s with the single-card run")
        for label, _, bd, _ in POD_FULL_RUNS:
            per = [g["runs"][label] for g in ranks]
            toks = [p["tokens"] for p in per]
            assert all(t == toks[0] for t in toks), (label, "ranks disagree")
            kernel = "bitlinear_axes_banked"
            assert all(p["launches"][kernel] > 0 for p in per), (label, per)
            launches[f"pods {ARCH} {label} {POD_FULL_SHAPE}"] = [
                p["launches"] for p in per]
            ref = single["tokens"]
            agree = sum(a == b for x, y in zip(toks[0], ref)
                        for a, b in zip(x, y))
            r0 = per[0]
            bank_gb = {p: round(b / 1e9, 3)
                       for p, b in r0["bank_per_pod"].items()}
            fired = [{k: v for k, v in p["launches"].items() if v}
                     for p in per]
            line = (f"pods {ARCH} {label}: tokens agree with one card "
                    f"{agree}/{sum(len(y) for y in ref)}"
                    + (" (its fp32 base)" if bd == "int8" else "")
                    + f"; affinity {r0['affinity']}; bank GB per pod "
                    f"{bank_gb}; residents per pod "
                    f"{r0['resident_per_pod']}; admission bytes (in-pod, "
                    f"cross-pod) {r0['admit_bytes']}; launches per rank "
                    f"{fired}; mean step ms per rank "
                    f"{[round(p['mean_step_ms'], 2) for p in per]} (one card "
                    f"{single['mean_step_ms']:.2f}); {r0['decode_steps']} "
                    f"steps, {r0['seconds']:.2f} s; peak GB per rank "
                    f"{[round(p['peak_GB'], 2) for p in per]}")
            if label.startswith("pods") and "warm" not in label:
                assert r0["affinity"]["hits"] > 0 \
                    and r0["affinity"]["misses"] > 0, (label, r0["affinity"])
                assert all(p["admit_bytes"][1] == 0 for p in per), per
                chk = [p["checked"] for p in per]
                q8 = "_q8" if bd == "int8" else ""
                assert all(f"bitlinear_axes_banked{q8}" in c["kernels"]
                           for c in chk), chk
                line += (f"; checked wave: {[c['launches'] for c in chk]} "
                         f"launches ({chk[0]['kernels']}) within the GEMM "
                         f"bound on pod-local ids, max |err| "
                         f"{max(c['max_abs_err'] for c in chk):.3e}")
            print(line)
        glob = ranks[0]["runs"]["global"]
        assert glob["admit_bytes"][1] == glob["admit_bytes"][0] > 0, glob
        warm = [g["runs"]["pods warm"]["tokens"] for g in ranks]
        warm_async = [g["runs"]["pods warm async"]["tokens"] for g in ranks]
        assert warm_async == warm, "async pod run's tokens differ from sync"
        # both variants committed into both pods through the agreement
        assert all(g["runs"]["pods warm async"]["commits"] == 4
                   for g in ranks), [g["runs"]["pods warm async"]
                                     for g in ranks]
        print(f"pods full width: the warm async run's tokens == the warm "
              f"sync run's on every rank; ranks share one card: these times "
              f"say nothing of pod-parallel speed-up")
        ended_first = launcher.poll() is not None
        stdout, stderr = launcher.communicate(timeout=600)
    finally:
        if launcher.poll() is None:
            os.killpg(launcher.pid, 9)
            launcher.communicate()
    # 3. the launcher
    assert launcher.returncode == 0, stdout[-2000:] + stderr[-4000:]
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith(("affinity:", "bank per-pod bytes:",
                               "admission bytes:", "mesh: 2 ranks"))]
    assert len(lines) == 4, stdout[-3000:]
    print(f"pods launcher: `python -m repro_torch.launch.serve "
          f"{' '.join(POD_LAUNCH_ARGS)}`: {lines}; "
          + ("ended before the mesh runs, beside them" if ended_first else
             f"ended {time.perf_counter() - t_launch:.1f} s after its start"))
    return launches



# kernel bodies whose first CUDA design was replaced: the design now run
GEMM_DESIGN = "streaming (M <= 16) + cp.async tiles (M > 16)"
BANKED_DESIGN = ("streaming, one Ŵ per distinct slot in registers (M <= 16)"
                 " + cp.async tiles, one Ŵ tile per distinct slot (M > 16)")
STACKED_DESIGN = ("blocks with all-zero x write zeros and read no weight; "
                  "streaming at 1, 2, 4, 8, 16 rows (M <= 16; int8 at 1-2 "
                  "rows: the split sum) + 128 x 128 cp.async tiles, Ŵ built "
                  "once per launch at M <= 128")
REDESIGNED = {"bitlinear_axes": GEMM_DESIGN, "bitlinear_axes_q8": GEMM_DESIGN,
              "bitlinear_axes_banked": BANKED_DESIGN,
              "bitlinear_axes_banked_q8": BANKED_DESIGN,
              "bitlinear": GEMM_DESIGN, "bitlinear_q8": GEMM_DESIGN,
              "bitlinear_axes_stacked": STACKED_DESIGN,
              "bitlinear_axes_stacked_q8": STACKED_DESIGN,
              "flash_attention": "bf16: wgmma + TMA; fp32: CUDA cores"}


def kernel_entries(rows, launches, dl_launches, fl_launches,
                   arch_rows, mesh_launches) -> list:
    """One JSON entry per kernel body: times summed over one unit of its
    path (a unit's first member gives each row's multiplicity in it),
    launches from the main-path run that drives it and, as
    ``path_launches``, from every serving run that launched it (the other
    archs' full-width runs); as ``mesh_launches`` each mesh run's launches
    on every rank (the ``_q8`` bodies: the runs over an int8 base); the rows
    at the other archs' projection shapes ride beside as
    ``arch_shapes``."""
    units = {
        "unpack_apply": (lambda r: True, "dense", "unpack_apply",
                         f"one dense variant load: 7 stacks x (row, col), "
                         f"L={SERVE_LAYERS}"),
        "bitlinear_axes": (lambda r: r["m"] == LANES, "fused",
                           "bitlinear_axes",
                           "one layer's decode step: 7 projections at M=4"),
        "bitlinear_axes_banked": (
            lambda r: r["case"] == "M=4", "continuous",
            "bitlinear_axes_banked",
            "one layer's mixed decode step: 7 projections at M=4, "
            f"vidx {BANK_VIDX} over a bank of 4 slots"),
        "bitlinear": (lambda r: r["m"] == LANES and r["mode"] == "row",
                      "deltalinear", "bitlinear",
                      "7 projections at M=4, row mode"),
        "flash_attention": (lambda r: r["case"] == FLASH_UNIT, "flash",
                            "flash_attention",
                            "one layer's prefill attention, qwen3-8b heads "
                            f"(32 q, 8 kv, hd 128), B=1, {FLASH_UNIT}"),
        "bitlinear_axes_stacked": (
            lambda r: r.get("routed") == "fused decode",
            "deepseek-moe-16b fused",
            "bitlinear_axes_stacked",
            "one deepseek-moe-16b expert layer's group fused decode step at "
            "batch 4, as the main path routed it: the w_gate, w_up and "
            "w_down stacks, E=64, M=1 (capacity 1), the step's live "
            "experts"),
    }
    entries = []
    for name, source, replaces in KERNELS:
        q8 = name.endswith("_q8")
        keep, run, counter, unit = units[name.removesuffix("_q8")]
        if run == "flash":
            unit_name = unit
        else:
            unit_name = unit + (" (int8 base)" if q8 else " (fp32 base)")
        unit_rows = [r for r in rows[name] for _ in range(int(keep(r)))]
        entry = summary(name, source, replaces, unit_rows, unit_name)
        entry["shapes"] = rows[name]
        if name in arch_rows:
            entry["arch_shapes"] = arch_rows[name]
        if run == "flash":
            entry["launches"] = fl_launches[counter]
        elif run == "deltalinear":
            entry["launches"] = dl_launches["int8" if q8 else "fp"][counter]
        else:
            entry["launches"] = launches[run + (" int8" if q8 else "")][
                counter]
        assert entry["launches"] > 0, (name, entry["launches"])
        # every serving run's launches of this body, the new archs' too
        entry["path_launches"] = {
            run: got[counter] for run, got in launches.items()
            if got.get(counter) and run.endswith(" int8") == q8}
        if counter in MESH_KERNELS:
            entry["mesh_launches"] = {
                run: [r[counter] for r in ranks]
                for run, ranks in mesh_launches.items()
                if ("int8" in run) == q8 and any(r[counter] for r in ranks)}
            assert entry["mesh_launches"], (name, "no mesh launch")
        if name in REDESIGNED:
            entry["design"] = REDESIGNED[name]
        entries.append(entry)
    return entries


def resources(report: str) -> list[str]:
    """The ``nvcc -Xptxas -v`` lines of every instantiation of the
    redesigned kernels (the streaming and tiled delta GEMMs, single-variant,
    banked and expert-stacked with the stacked one's pre-pass, the bf16
    wgmma flash kernel): registers, spill bytes and static shared memory, under
    the kernel's name demangled by the toolkit's ``cu++filt`` (mangled where
    it is missing).  Their shared memory is dynamic, sized at launch."""
    import re
    from repro_torch.kernels import build
    keep = ("stream_gemm_kernel", "tile_gemm_kernel", "banked_stream_kernel",
            "banked_tile_kernel", "flash_fwd_wgmma_kernel",
            "stacked_stream_kernel", "stacked_tile_kernel", "live_kernel")
    found, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in keep) else None
            if name:
                found.append([name])
        elif name and ("spill stores" in line or "Used" in line):
            found[-1].append(line.split(" : ")[-1].strip())
    filt = os.path.join(os.path.dirname(build.nvcc()), "cu++filt")
    names = [f[0] for f in found]
    if found and os.path.exists(filt):
        names = subprocess.run([filt, *names], capture_output=True,
                               text=True, check=True).stdout.splitlines()
    return [f"  {n}: {'; '.join(f[1:])}" for n, f in zip(names, found)]


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
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s, compile cache {build.cache_stats()}\n"
          f"{build.ptxas_report()}")
    print("redesigned kernels (registers, spills, shared memory):")
    print("\n".join(resources(build.ptxas_report())))

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.1f} s")
        return out

    if sys.argv[1:] == ["--mesh-only"]:
        # the mesh phase alone (development runs; prints no result line)
        mesh_launches = timed("mesh", mesh_phase, dev, True)
        print("mesh launches: " + json.dumps(mesh_launches))
        return
    if sys.argv[1:] == ["--pods-only"]:
        # the pod-bank phase alone (development runs; no result line)
        pod_launches = timed("pods", pods_phase, dev)
        print("pods launches: " + json.dumps(pod_launches))
        return
    cfg = get_config(ARCH)
    timer = Timer(dev)
    rows = timed("kernels", kernel_phase, cfg, dev, timer)
    rows["flash_attention"], fl_launches = timed("flash", flash_phase, cfg,
                                                 dev, timer)
    arch_rows = timed("arch kernels", arch_kernel_phase, dev, timer)
    rows.update(timed("stacked", stacked_phase, dev, timer))
    del timer
    torch.cuda.empty_cache()
    timed("reference", reference_phase, dev)
    timed("lifecycle reference", lifecycle_reference_phase, dev)
    timed("admission reference", admission_reference_phase, dev)
    timed("train reference", train_reference_phase, dev)
    timed("arch reference", arch_reference_phase, dev)
    dl_launches = timed("deltalinear", deltalinear_phase, cfg, dev)
    launches = timed("serve", serve_phase, dev)
    launches.update(timed("speculative", speculative_phase, dev))
    launches["lifecycle"] = timed("lifecycle", lifecycle_phase, dev)
    launches.update(timed("admission", admission_phase, dev))
    launches.update(timed("train", train_phase, dev))
    mesh_launches = timed("mesh", mesh_phase, dev)
    mesh_launches.update(timed("pods", pods_phase, dev))
    launches.update(timed("dense archs", dense_archs_phase, dev))
    moe_launches, routed = timed("deepseek-moe-16b", moe_phase, dev)
    launches.update(moe_launches)
    for name, extra in routed.items():
        rows[name] += extra
    launches.update(timed("gemma3-12b", gemma3_phase, dev))
    launches.update(timed("whisper-base", whisper_phase, dev))
    launches.update(timed("internvl2-76b", vlm_phase, dev))
    for arch in RECURRENT:
        launches.update(timed(arch, recurrent_phase, dev, arch))
    timed("restart", restart_phase, dev, build_s)
    timed("launcher", launcher_phase, dev)
    print("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()}))
    print(json.dumps({"kernels": kernel_entries(rows, launches, dl_launches,
                                                fl_launches, arch_rows,
                                                mesh_launches)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
