"""Build and bind the CUDA kernels under ``repro_torch/csrc``.

Each ``.cu`` source compiles with ``nvcc`` for Hopper (``sm_90a``) into an
object — all sources at once, one process each — and the objects link into
one shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, through the process's compile cache
(``core/compile_cache.CompileCache``; by default ``build/repro_torch/`` at
the root of the checkout, ``REPRO_COMPILE_CACHE_DIR`` names another), under
a key over the sources, the flags and the environment: an edited source or
another toolchain rebuilds, an unchanged one loads the stored library, and
a stored library that cannot load is moved aside and rebuilt.

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

import torch

from repro_torch.core import compile_cache as CC

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
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
    """sha256 over every file under ``csrc/``, with its name."""
    h = hashlib.sha256()
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: pathlib.Path) -> tuple[pathlib.Path, str]:
    """Compile every source (in parallel) and link, under ``out_dir``;
    returns (library path, the compiler's per-kernel resource report)."""
    exe = nvcc()
    procs = []
    for src in SOURCES:
        obj = out_dir / (src + ".o")
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
    lib_path = out_dir / "librepro_torch.so"
    link = subprocess.run(
        [exe, *ARCH_FLAGS, "-shared", "-o", str(lib_path),
         *(str(obj) for _, obj, _ in procs), "-ldl"],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed\n" + link.stdout + link.stderr)
    return lib_path, "\n".join(report)


_loaded_through: list = []   # the cache the library was loaded through


@functools.cache
def _loaded() -> tuple[ctypes.CDLL, str]:
    cache = CC.get_default()
    lib, report = cache.load(("kernel-library", tuple(NVCC_FLAGS),
                              tuple(SOURCES), _digest()), _compile)
    _loaded_through.append(cache)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib, report


def cache_stats() -> dict:
    """The compile cache's counters: of the cache the library was loaded
    through, or of the process default before its first use."""
    cache = _loaded_through[0] if _loaded_through else CC.get_default()
    return dict(cache.stats)


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
