"""Build and bind the CUDA kernels under ``repro_torch/csrc``.

Each ``.cu`` source compiles with ``nvcc`` for Hopper (``sm_90a``) into an
object — all sources at once, one process each — and the objects link into
one shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, into ``build/repro_torch/`` at the root of the
checkout, under a name that hashes the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing library.

Nothing here runs at import time: a host without ``nvcc`` or a card can
import every module of the package.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("unpack_apply.cu", "bitlinear_axes.cu",
           "bitlinear_axes_banked.cu", "bitlinear_axes_stacked.cu",
           "bitlinear.cu", "flash_attn.cu")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "repro_unpack_apply": [_P, _P, _L, _L, _L, _P, _I, _P, _P, _I, _L, _L,
                           _L, _P],
    "repro_bitlinear_axes": [_P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P],
    "repro_bitlinear_axes_banked": [_P, _I, _P, _P, _P, _P, _I, _P, _I, _P,
                                    _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_bitlinear_axes_stacked": [_P, _I, _P, _P, _P, _I, _P, _I, _P, _P,
                                     _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_bitlinear": [_P, _I, _P, _P, _L, _L, _P, _I, _P, _P, _P, _I, _I,
                        _I, _I, _I, _P],
    "repro_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _F, _P],
}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME); the "
                       "CUDA kernels cannot be built on this host")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile() -> tuple[pathlib.Path, str]:
    """Compile every source (in parallel) and link; returns (library path,
    the compiler's per-kernel resource report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    report_path = lib_path.with_suffix(".ptxas.txt")
    if lib_path.exists() and report_path.exists():
        return lib_path, report_path.read_text()
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = pathlib.Path(tmp) / (src + ".o")
            cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report = []
        failed = []
        for src, _, p in procs:
            out, _ = p.communicate()
            report.append(f"== {src}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(report))
        tmp_lib = pathlib.Path(tmp) / lib_path.name
        link = subprocess.run(
            [exe, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in procs), "-ldl"],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout + link.stderr)
        report_path.write_text("\n".join(report))
        os.replace(tmp_lib, lib_path)
    return lib_path, report_path.read_text()


@functools.cache
def _loaded() -> tuple[ctypes.CDLL, str]:
    path, report = _compile()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib, report


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    return _loaded()[0]


def ptxas_report() -> str:
    """``nvcc -Xptxas -v`` output of the build: registers, shared memory
    and spills per kernel instantiation."""
    return _loaded()[1]


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the raw handle the C
    entry points take."""
    return torch.cuda.current_stream(device).cuda_stream
