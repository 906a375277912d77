#!/usr/bin/env python3
"""Compare builds of the expert-stacked delta GEMM on one NVIDIA GPU.

Builds ``src/repro_torch/csrc/bitlinear_axes_stacked.cu`` once per variant
(``NAME=FLAGS``: extra ``nvcc`` flags, such as a ``-D`` of a knob added to
the source for an experiment; none for the source as it is), all at once,
each into its own library under ``build/stacked_bench/``, and
optionally a parent tree's copy of the same source (``--parent DIR``: a
checkout whose ``src/repro_torch`` holds the earlier kernel and its
``stacked_plan``).  Then, at deepseek-moe-16b's expert stacks (E=64, w_gate
1408 x 2048, w_down 2048 x 1408, bf16 x, fp32 and int8 base, half the
experts row-scaled), it holds every build against the plain version
(1e-5 * sum |x||W^| + 1e-6 per output) and times them in turns (parent,
variants, variants reversed, parent; L2 flushed before each launch; the
median of each) at M in ``--ms``, with every expert live and with
``--live`` experts live (the others' rows zero, as the MoE layer hands
over the experts no token routes to).  Prints each build's ptxas lines
for the stacked kernels, one line per case, and the card's name and power
limit.  Run from the root of a checkout::

    python3 tools/stacked_gemm_bench.py new= --parent build/parent
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
E = 64
SHAPES = (("w_gate", 1408, 2048), ("w_down", 2048, 1408))

_P, _I = ctypes.c_void_p, ctypes.c_int


def build(name: str, src_dir: pathlib.Path, flags: list[str], out_dir):
    """Start nvcc for one build; returns (name, lib path, process)."""
    from repro_torch.kernels import build as B
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib_{name}.so"
    cmd = [B.nvcc(), *B.NVCC_FLAGS, *flags, "-shared", "-I", str(src_dir),
           str(src_dir / "bitlinear_axes_stacked.cu"), "-o", str(lib)]
    return name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)


def ptxas_lines(report: str) -> list[str]:
    """Registers, spills and stack of each stacked kernel instantiation."""
    out, name, props = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(stacked_\w+?kernel|live_kernel)(\w*)", m.group(1))
            name = (k.group(1) + k.group(2)[:40]) if k else None
        elif name and "spill stores" in line:
            props = line.split(" : ")[-1].strip()
        elif name and "Used" in line:
            out.append(f"    {name}: {props}; {line.split(' : ')[-1].strip()}")
            name = None
    return out


class Timer:
    def __init__(self, device):
        self.flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)

    def times(self, fn, reps: int) -> list[float]:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            t = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            t.record()
            pairs.append((s, t))
        torch.cuda.synchronize()
        return [s.elapsed_time(t) for s, t in pairs]


def caller(lib_path: pathlib.Path, plan, with_live: bool):
    """A function (x, packed, v_row, v_col, wq, ws) -> y over one build."""
    from repro_torch.kernels import bitlinear as BL
    from repro_torch.kernels import build as B
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.repro_bitlinear_axes_stacked
    fn.argtypes = ([_P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P]
                   + ([_P] if with_live else []) + [_I] * 6 + [_P])
    fn.restype = _I

    def call(x, packed, v_row, v_col, wq, ws):
        e, m, k = x.shape
        n = wq.shape[1]
        splits, kps = plan(m, n, k, x.element_size(), wq.element_size(), e)
        y = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
        work = (torch.empty((splits, e, m, n), dtype=torch.float32,
                            device=x.device) if splits > 1 else None)
        live = [] if not with_live else [
            torch.empty(e * -(-m // BL.stack_tile_m(m)) * splits,
                        dtype=torch.int32, device=x.device).data_ptr()
            if m > 16 else None]
        rc = fn(x.data_ptr(), B.DTYPE_CODES[x.dtype], packed.data_ptr(),
                v_row.data_ptr(), v_col.data_ptr(),
                B.DTYPE_CODES[v_row.dtype], wq.data_ptr(),
                B.DTYPE_CODES[wq.dtype], None if ws is None else ws.data_ptr(),
                y.data_ptr(), None if work is None else work.data_ptr(),
                *live, e, m, n, k, splits, kps,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{lib_path.name}: launch failed ({rc})")
        return y
    return call


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+", help="NAME=FLAGS")
    ap.add_argument("--parent", help="an earlier checkout to compare with")
    ap.add_argument("--ms", default="1,2,7,120")
    ap.add_argument("--live", type=int, default=21)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stacked_gemm_bench: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import delta as D
    from repro_torch.core import quantize as Q
    from repro_torch.kernels import bitlinear as BL

    out_dir = ROOT / "build" / "stacked_bench"
    flags_of = {name: flags.split() for name, _, flags in
                (v.partition("=") for v in args.variants)}
    jobs = [build(name, ROOT / "src/repro_torch/csrc", flags, out_dir)
            for name, flags in flags_of.items()]
    builds = {}
    if args.parent:
        parent = pathlib.Path(args.parent).resolve()
        jobs.append(build("parent", parent / "src/repro_torch/csrc", [],
                          out_dir))
        spec = importlib.util.spec_from_file_location(
            "parent_bitlinear", parent / "src/repro_torch/kernels/bitlinear.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        parent_plan = mod.stacked_plan
    for name, lib, proc in jobs:
        report, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}\n{report}")
        print(f"build {name}:")
        print("\n".join(ptxas_lines(report)))
        builds[name] = (caller(lib, parent_plan, False) if name == "parent"
                        else caller(lib, BL.stacked_plan, True))
    order = list(builds)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    timer = Timer(dev)
    rng = np.random.default_rng(18)
    ms = [int(v) for v in args.ms.split(",")]
    for proj, n, k in SHAPES:
        wb = torch.randn((E, n, k), generator=gen, device=dev) * k ** -0.5
        delta = torch.randn((E, n, k), generator=gen, device=dev) * 0.005
        packed = D.pack_signs(D.sign_mask(delta))
        rows = (torch.arange(E, device=dev) % 2 == 0)[:, None]
        v_row = torch.where(rows, D.init_scale(delta, "row"), 0.0).half()
        v_col = torch.where(rows, 0.0, D.init_scale(delta, "col")).half()
        del delta
        signs = D.unpack_signs(packed, k)
        for base_name, base in (("fp32", wb), ("int8", Q.quantize_weight(wb))):
            wq, ws = (base.q, base.scale) if Q.is_quant(base) else (base, None)
            wf = Q.dequantize(base) if Q.is_quant(base) else base
            w_abs_t = ((v_row.float()[:, :, None] + v_col.float()[:, None, :])
                       * signs + wf).abs().transpose(1, 2)
            for m in ms:
                for live_n in (E, args.live):
                    x = torch.randn((E, m, k), generator=gen, device=dev).to(
                        torch.bfloat16)
                    dead = torch.from_numpy(np.sort(rng.choice(
                        E, E - live_n, replace=False))).to(dev)
                    x[dead] = 0
                    want = BL.plain_stacked(x.float(), packed, v_row, v_col,
                                            wq, w_scale=ws)
                    scale = torch.bmm(x.float().abs(), w_abs_t)
                    errs = {}
                    for name, fn in builds.items():
                        got = fn(x, packed, v_row, v_col, wq, ws)
                        torch.cuda.synchronize()
                        diff = (got - want).abs()
                        errs[name] = diff.max().item()
                        assert bool((diff <= 1e-5 * scale + 1e-6).all()), (
                            name, proj, base_name, m, live_n, errs[name])
                        if name != "parent":
                            assert bool((got[dead] == 0).all()), name
                    del want, scale
                    times = {name: [] for name in order}
                    for name in order + order[::-1]:
                        fn = builds[name]
                        times[name] += timer.times(
                            lambda: fn(x, packed, v_row, v_col, wq, ws),
                            args.reps)
                    w_bytes = wq.element_size() * n * k + n * k / 8 + 2 * (
                        n + k) + (2 * n if ws is not None else 0)
                    nbytes = live_n * w_bytes + x.numel() * 2 + E * m * n * 4
                    bound = max(nbytes / HBM_BYTES_PER_S,
                                2 * live_n * m * n * k / FP32_FLOPS) * 1e3
                    print(f"{proj} {base_name} M={m} live={live_n}/{E} "
                          f"bound_ms={bound:.4f} " + " ".join(
                              f"{name}_ms={float(np.median(t)):.4f}"
                              for name, t in times.items())
                          + " max_err=" + ",".join(
                              f"{v:.2g}" for v in errs.values()))
            del w_abs_t
        del wb, packed, v_row, v_col, signs
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
