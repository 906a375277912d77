"""Compile-once serving (port of ``repro.core.compile_cache``): a
persistent cache of the built kernel library, and :class:`CapturedStep`,
a CUDA graph of one fixed-shape serving step.

Restart-to-first-token is a serving SLO.  The JAX package pays for it in
XLA compiles and persists the compiled executables.  The port pays in two
other places:

* the ``nvcc`` build of ``csrc/`` (about two minutes on an H100), which
  :class:`CompileCache` persists: a directory of built libraries keyed by
  the sources, the compiler flags and the environment;
* the host's dispatch of every operator of a decode step (PyTorch runs
  eagerly), which a :class:`CapturedStep` removes: the step is captured
  once as a CUDA graph and each later step is one replay.  A graph cannot
  outlive its process, so the engine captures its steps again after every
  restart (``ServingEngine.warmup`` does it before traffic).

Safety model, as in the JAX package: a stale or broken entry can only
MISS, never load a wrong library.

* every key is a sha256 over the caller's parts (sources and flags) and
  :func:`env_fingerprint` (torch and CUDA versions, the ``nvcc`` version
  line, the device's name and compute capability), so an upgrade or an
  edited source degrades to a build, not a wrong answer;
* each entry restates its environment in cleartext metadata, re-checked
  before the library is loaded (against hand-copied cache directories);
* an entry whose metadata is missing, unreadable or names another
  environment, or whose library ``ctypes.CDLL`` cannot load, is counted in
  ``stats`` (``corrupt`` / ``env_mismatch``), moved aside into
  ``quarantine/`` and rebuilt: it never raises on the serving path.

Processes may share one cache directory (the ranks of a mesh).  A store
writes each of an entry's files beside it and moves it into place with
``os.replace``, the library last, so a reader never sees a half-written
meta or report, and a library without its meta is a broken entry, never
one in flight.  Two processes that miss the same key at once both build
and both store the same entry, each whole.  Under a mesh the ranks also
take turns (``launch.mesh.load_kernels``): rank 0 loads, building on a
miss, and the other ranks load after a barrier, as hits.

``REPRO_COMPILE_CACHE_DIR`` sets the process default (as in the JAX
package); without it the default is ``build/repro_torch/`` at the root of
the checkout.  The kernel library loads once a process, through the cache
that is the default at its first use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import time
from typing import Callable, Optional

import torch

_FORMAT = 1
_PKG = pathlib.Path(__file__).resolve().parents[1]          # src/repro_torch
DEFAULT_DIR = _PKG.parents[1] / "build" / "repro_torch"


# -- fingerprints --------------------------------------------------------------

def code_fingerprint(root: Optional[pathlib.Path] = None) -> str:
    """sha256 over every ``repro_torch`` source: each ``.py`` file and
    everything under ``csrc/``, with its relative path.  Written into each
    cache entry's metadata: which code built it."""
    root = _PKG if root is None else pathlib.Path(root)
    h = hashlib.sha256()
    files = sorted(set(root.rglob("*.py")) | {
        p for p in (root / "csrc").rglob("*") if p.is_file()})
    for p in files:
        h.update(str(p.relative_to(root)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc_line() -> str:
    """The last line of ``nvcc --version`` ("none" without a compiler)."""
    from repro_torch.kernels import build
    try:
        out = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "none"
    lines = out.strip().splitlines()
    return lines[-1] if lines else "none"


@functools.cache
def env_fingerprint() -> tuple:
    """Everything outside the sources that decides whether a built library
    loads and is right here: torch and its CUDA version, the compiler,
    the device's name and compute capability ("none" on a host without a
    card)."""
    if torch.cuda.is_available():
        device = (torch.cuda.get_device_name(0),
                  "sm_%d%d" % torch.cuda.get_device_capability(0))
    else:
        device = ("none", "none")
    return (torch.__version__, str(torch.version.cuda), _nvcc_line(),
            *device)


# -- the cache -----------------------------------------------------------------

class CompileCache:
    """Directory-backed store of built kernel libraries.

    ``load(parts, build)`` returns (loaded library, build report): a hit
    loads the stored library; a miss (also after any corruption or
    environment mismatch) calls ``build(dir)``, which builds the library
    under a fresh directory and returns (library path, report), and stores
    it.  ``stats`` counts hits, misses, builds, build seconds, corrupt
    entries and environment mismatches."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.stats = {"hits": 0, "misses": 0, "builds": 0,
                      "build_seconds": 0.0, "corrupt": 0, "env_mismatch": 0}

    def key(self, *parts) -> str:
        """sha256 over ``parts`` (strings, numbers, tuples) and the
        environment fingerprint."""
        payload = repr((parts, env_fingerprint())).encode()
        return hashlib.sha256(payload).hexdigest()[:16]

    def _files(self, key: str) -> tuple:
        stem = f"librepro_torch_{key}"
        return (self.path / f"{stem}.so", self.path / f"{stem}.meta.json",
                self.path / f"{stem}.ptxas.txt")

    def _quarantine(self, files, reason: str) -> None:
        """Move an entry's files aside (never delete what may be evidence)
        and count why."""
        self.stats[reason] += 1
        dest = self.path / "quarantine"
        dest.mkdir(parents=True, exist_ok=True)
        stamp = f"{time.time_ns()}"
        for f in files:
            if f.exists():
                os.replace(f, dest / f"{f.name}.{reason}.{stamp}")

    def get(self, key: str):
        """(loaded library, report) or None: a miss, also for an entry
        that is broken or names another environment (counted, moved
        aside)."""
        lib_path, meta_path, report_path = files = self._files(key)
        if not lib_path.exists():
            return None
        try:
            meta = json.loads(meta_path.read_text())
            report = report_path.read_text()
            ok = meta.get("format") == _FORMAT
        except (OSError, ValueError, AttributeError):
            ok = False
        if not ok:
            self._quarantine(files, "corrupt")
            return None
        if tuple(meta.get("env", ())) != env_fingerprint():
            self._quarantine(files, "env_mismatch")
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            self._quarantine(files, "corrupt")
            return None
        return lib, report

    def load(self, parts: tuple, build: Callable) -> tuple:
        """The library of ``parts``: stored, else built by ``build(dir)``
        (-> (library path, report)) and stored atomically."""
        key = self.key(*parts)
        hit = self.get(key)
        if hit is not None:
            self.stats["hits"] += 1
            return hit
        self.stats["misses"] += 1
        self.path.mkdir(parents=True, exist_ok=True)
        lib_path, meta_path, report_path = self._files(key)
        t0 = time.perf_counter()
        tmp = self.path / f"tmp-{key}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        try:
            built, report = build(tmp)
            # each file lands whole (written beside it, then os.replace),
            # the library last: a reader that sees the library sees its
            # complete report and meta
            for text, dest in ((report, report_path), (json.dumps({
                    "format": _FORMAT, "env": list(env_fingerprint()),
                    "parts": repr(parts), "code": code_fingerprint()}),
                    meta_path)):
                staged = tmp / dest.name
                staged.write_text(text)
                os.replace(staged, dest)
            os.replace(built, lib_path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.stats["builds"] += 1
        self.stats["build_seconds"] += time.perf_counter() - t0
        return ctypes.CDLL(str(lib_path)), report


# -- process default -------------------------------------------------------------
# One cache per process: the kernel library is process-wide.
# REPRO_COMPILE_CACHE_DIR names its directory, Deployment(compile_cache_dir=)
# installs another before the library's first use, tests their own.

_default: Optional[CompileCache] = None


def get_default() -> CompileCache:
    global _default
    if _default is None:
        _default = CompileCache(os.environ.get("REPRO_COMPILE_CACHE_DIR")
                                or DEFAULT_DIR)
    return _default


def set_default(cache: Optional[CompileCache]) -> Optional[CompileCache]:
    """Install (or, with None, reset to the environment's) the process
    default; returns the previous one so tests can restore it."""
    global _default
    prev, _default = _default, cache
    return prev


# -- captured steps --------------------------------------------------------------

def _counters() -> list:
    """(module, name) of every kernel wrapper's launch counter."""
    from repro_torch.kernels import bitlinear, flash_attn, unpack_apply
    return [(unpack_apply, "launches"), (bitlinear, "launches"),
            (bitlinear, "banked_launches"), (bitlinear, "stacked_launches"),
            (bitlinear, "static_launches"), (flash_attn, "launches")]


def _read_counters() -> list:
    return [getattr(mod, name) for mod, name in _counters()]


def _add_counters(delta: list) -> None:
    for (mod, name), d in zip(_counters(), delta):
        setattr(mod, name, getattr(mod, name) + d)


class CapturedStep:
    """One fixed-shape step held as a CUDA graph, the twin of a compiled
    executable: ``replay()`` runs it with one launch.

    Capture follows PyTorch's recipe: ``warm()`` (the step's computation
    without its writes to the live state) runs eagerly on a side stream
    first, so everything made lazily on a first call (the kernel library,
    library handles, cached tables) exists outside the graph's memory;
    then ``body()`` (the computation and its writes) is captured into
    ``pool``, which every graph of one engine shares.  Nothing that
    ``body`` allocates may be read after it: its results reach the caller
    only through the live tensors it writes.

    A graph replays the addresses it was captured on: ``pointers`` records
    them, and the caller re-captures when they change.  A kernel wrapper
    counts its launches while it is captured, though nothing runs then:
    the capture takes the counts back and each replay adds them again.  A
    step that cannot be captured (one that waits for the device, say)
    raises; there is no eager fallback.

    The capture runs in ``thread_local`` mode: only this thread's calls
    are checked against it.  An admission worker (``serving/admission``)
    may stage a variant meanwhile, and its ``cudaMalloc``, pinned
    ``cudaHostAlloc``, event waits and copies on its own stream would
    invalidate a capture in the default ``global`` mode."""

    def __init__(self, warm: Callable, body: Callable, *, pool,
                 pointers: tuple):
        self.pointers = pointers
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.no_grad():
            warm()
        torch.cuda.current_stream().wait_stream(side)
        before = _read_counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(
                self.graph, pool=pool, capture_error_mode="thread_local"):
            body()
        self.launches = [a - b for a, b in zip(_read_counters(), before)]
        _add_counters([-d for d in self.launches])
        self.seconds = time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        _add_counters(self.launches)
