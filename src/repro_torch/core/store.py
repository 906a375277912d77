"""Delta artifact store (port of ``repro.core.store``): serialization,
manifest and version lineage, in the JAX package's on-disk format — an
artifact either package writes, the other reads.

Artifact layout (one directory per published version of a variant)::

  manifest.json   paths, shapes, axis selections, sha256 per tensor, the
                  base-checkpoint fingerprint (guards against applying a
                  delta to the wrong base) and the version lineage: variant
                  name, monotonic version id, parent version, kind
                  ("full" | "patch")
  deltas.npz      full publish: packed masks (uint8) + scale vectors (fp16)
  extras.npz      full publish: uncompressed fine-tuned leaves, fp16
  patch.npz       incremental publish: zero-run-suppressed XOR of the
                  parent's wire buffers (``core/delta`` wire helpers)

:class:`VariantStore` arranges versions under ``root/<name>/v%04d`` with a
``versions.json`` lineage index per variant whose ``latest`` field is the
serving pointer.  Manifests and indexes are finalized with a tmp file and
``os.replace``, so a crash mid-publish never leaves a readable torn file.

Payloads are read and written as numpy arrays; a loaded artifact holds
CPU tensors, and the loader (``core/loader``) moves each module to the
device.  The read side streams each module in bounded chunks
(``iter_artifact_modules``), checks its sha on the host and calls an
optional ``pacer`` between modules, so an ingest thread
(``serving/admission``) yields the host to the serving thread as it goes;
:class:`StagingPool` holds the reusable (on a card, page-locked) host
buffers such an ingest stages through.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import pathlib
import threading
import zipfile
from typing import Callable, Iterator, Optional

import numpy as np
import numpy.lib.format as _npformat
import torch

from repro_torch.core import delta as D
from repro_torch.core.calibration import (DeltaEntry, DeltaModel,
                                          flatten_params)
from repro_torch.distributed import sharding as SH


def _sha(arr: np.ndarray) -> str:
    """The JAX store's digest (sha256 of the C-order bytes), hashed from
    the array's own buffer: no copy, and hashlib lets other threads run
    meanwhile (an ingest thread must not hold the interpreter for the
    length of a copy of a 1 GB embedding table)."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha256(flat).hexdigest()[:16]


def _np(t) -> np.ndarray:
    """A tensor's values as a host numpy array (bf16 widened to fp32,
    exactly; the callers cast to the wire dtype in numpy, as the JAX store
    does after ``jax.device_get``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def base_fingerprint(base_params) -> str:
    """Cheap fingerprint of the base checkpoint: per leaf (sorted by
    dot-path) the path, the shape rendered as a tuple, and the bytes of the
    first 64 elements — equal to the JAX package's for the same weights."""
    h = hashlib.sha256()
    for path, leaf in sorted(flatten_params(base_params).items()):
        h.update(path.encode())
        h.update(str(tuple(leaf.shape)).encode())
        head = leaf.detach().reshape(-1)[:64].cpu()
        if head.dtype in (torch.bfloat16, torch.float16):
            head = head.view(torch.int16)
        h.update(head.numpy().tobytes())
    return h.hexdigest()[:16]


STORE_VERSION = 3   # v3: version lineage (variant/version/parent/kind)
                    # v2: artifact_bytes + per-file sizes persisted on disk


def _write_manifest(out: pathlib.Path, manifest: dict) -> None:
    """Atomic finalize: the manifest appears complete or not at all."""
    tmp = out / "manifest.json.tmp"
    tmp.write_text(json.dumps(manifest, indent=2))
    os.replace(tmp, out / "manifest.json")


def read_manifest(in_dir) -> dict:
    """Read and structurally validate a manifest (v1-v3); a torn or
    truncated file raises IOError."""
    path = pathlib.Path(in_dir) / "manifest.json"
    if not path.exists():
        raise IOError(f"no manifest at {path}")
    try:
        manifest = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise IOError(f"torn or corrupt manifest {path}: {e}") from e
    if not isinstance(manifest, dict) or \
            not {"deltas", "extras"} <= set(manifest):
        raise IOError(f"torn or corrupt manifest {path}: "
                      "missing required sections")
    return manifest


def _check_sizes(path: pathlib.Path, manifest: dict, what: str) -> None:
    """Each payload file's size against the manifest's record."""
    for fname, nbytes in manifest.get("files", {}).items():
        actual = (path / fname).stat().st_size \
            if (path / fname).exists() else -1
        if actual != nbytes:
            raise IOError(f"truncated {what}: {fname} is {actual} bytes, "
                          f"manifest records {nbytes}")


# ---------------------------------------------------------------------------
# streamed per-module read (the async admission pipeline's read side)
# ---------------------------------------------------------------------------

DEFAULT_CHUNK_BYTES = 4 << 20   # bounded read granularity per payload chunk


def _shares_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors' storages overlap (a zero-copy alias)."""
    if a.device != b.device:
        return False
    sa, sb = a.untyped_storage(), b.untyped_storage()
    a0, b0 = sa.data_ptr(), sb.data_ptr()
    return a0 < b0 + sb.nbytes() and b0 < a0 + sa.nbytes()


class StagingPool:
    """Reusable host staging buffers for streamed ingest and staged
    host-to-device transfers.

    ``take(shape, dtype)`` returns a host tensor of that shape and dtype
    (a torch or a numpy dtype), reusing a released buffer of the same byte
    size when one is free; ``give`` releases a buffer back.  The pool
    keeps at most ``max_buffers`` per size class, so an ingest's peak host
    memory is O(largest buffer x in-flight window), not O(artifact).  With
    ``pin_memory`` (on a card) the buffers are page-locked, which is what
    makes a ``non_blocking`` copy from them asynchronous.

    Two rules keep a recycled buffer from rewriting data still in use:

    * a buffer given back with the ``event`` of a copy that reads it is
      handed out again only once that event has completed: ``take`` skips
      it while the copy runs and, when its class is full, waits for the
      oldest one;
    * a buffer that shares memory with a ``live`` tensor is dropped, never
      recycled: on the CPU ``tensor.to("cpu")`` returns the tensor itself,
      so a "transferred" buffer there IS the staged data (the hazard the
      JAX store probes for with ``_device_put_copies``).

    ``stats``: takes, reuses, waits (a take that waited for a copy), drops,
    and the bytes of the buffers the pool owns now and at most."""

    def __init__(self, max_buffers: int = 2, *, pin_memory: bool = False):
        self.max_buffers = max_buffers
        self.pin_memory = pin_memory
        self._free: dict[int, list] = {}      # nbytes -> [(raw, event)]
        self._lock = threading.Lock()
        self.stats = {"takes": 0, "reuses": 0, "waits": 0, "drops": 0,
                      "bytes": 0, "peak_bytes": 0}

    def take(self, shape, dtype) -> torch.Tensor:
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        shape = tuple(int(d) for d in shape)
        count = int(np.prod(shape))
        nbytes = count * torch.empty(0, dtype=dtype).element_size()
        with self._lock:
            self.stats["takes"] += 1
            bucket = self._free.get(nbytes, [])
            i = next((j for j, (_, ev) in enumerate(bucket)
                      if ev is None or ev.query()), None)
            if i is None and len(bucket) >= self.max_buffers:
                i = 0                           # the oldest copy ends first
                self.stats["waits"] += 1
            raw, event = bucket.pop(i) if i is not None else (None, None)
            if raw is not None:
                self.stats["reuses"] += 1
        if raw is None:
            raw = torch.empty(nbytes, dtype=torch.uint8,
                              pin_memory=self.pin_memory)
            with self._lock:
                self.stats["bytes"] += nbytes
                self.stats["peak_bytes"] = max(self.stats["peak_bytes"],
                                               self.stats["bytes"])
        elif event is not None:
            event.synchronize()
        return raw.view(dtype).reshape(shape)

    def give(self, buf, *, event=None, live=()) -> None:
        """Release ``buf`` (a tensor or numpy array the pool handed out)
        once ``event`` (a copy reading it; None: no copy pending) has
        completed; dropped when it shares memory with a tensor of ``live``
        or when its class is full."""
        if isinstance(buf, np.ndarray):
            buf = torch.from_numpy(buf)
        raw = buf.reshape(-1).view(torch.uint8)
        nbytes = raw.numel()
        with self._lock:
            bucket = self._free.setdefault(nbytes, [])
            if any(_shares_memory(raw, t) for t in live) or \
                    len(bucket) >= self.max_buffers:
                self.stats["drops"] += 1
                self.stats["bytes"] -= nbytes
                return
            bucket.append((raw, event))


def _stream_npz_member(zf: zipfile.ZipFile, member: str, *,
                       chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                       pool: Optional[StagingPool] = None) -> np.ndarray:
    """Read one .npy member of an (uncompressed) npz in bounded chunks into
    a host array (a ``pool`` buffer when given), checking truncation per
    chunk: a short stream raises IOError at the first missing byte."""
    with zf.open(member) as f:
        version = _npformat.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = _npformat.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = _npformat.read_array_header_2_0(f)
        else:                       # exotic npy version: no streaming path
            return _npformat.read_array(f)
        count = int(np.prod(shape))
        out = (pool.take(shape, dtype).numpy() if pool is not None
               else np.empty(count, dtype).reshape(shape))
        buf = out.reshape(-1).view(np.uint8)
        nbytes = count * dtype.itemsize
        got = 0
        while got < nbytes:
            want = min(int(chunk_bytes), nbytes - got)
            n = f.readinto(memoryview(buf)[got:got + want])
            if not n:
                raise IOError(
                    f"truncated artifact member {member}: got {got} of "
                    f"{nbytes} bytes")
            got += n
        if fortran:                 # np.savez writes C-order; be tolerant
            out = out.reshape(-1).reshape(shape[::-1]).T
    return out


def iter_artifact_modules(in_dir, *, verify: bool = True,
                          chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                          pool: Optional[StagingPool] = None,
                          pacer: Optional[Callable[[], None]] = None
                          ) -> Iterator[tuple]:
    """Stream a FULL artifact module by module: yields
    ``("delta", path, info, {packed, v_row, v_col, use_row})`` then
    ``("extra", path, info, array)``, all host numpy arrays read in bounded
    chunks (into ``pool`` buffers when given: the consumer gives each back
    once it has copied it), each module's sha checked (``verify``) before
    it is handed on.  ``pacer`` (if given) is called after each module: a
    background ingest passes a short sleep, so it yields the host between
    modules instead of holding it for the whole read."""
    path = pathlib.Path(in_dir)
    manifest = read_manifest(path)
    if manifest.get("kind", "full") != "full":
        raise ValueError(
            f"{path} holds an incremental update patch (parent version "
            f"{manifest.get('lineage', {}).get('parent_version')}); "
            "materialise it via VariantStore.load")
    if verify:
        _check_sizes(path, manifest, "artifact")
    with zipfile.ZipFile(path / "deltas.npz") as zf:
        for p, info in manifest["deltas"].items():
            key = p.replace(".", "__")
            fields = {f: _stream_npz_member(zf, f"{key}__{f}.npy",
                                            chunk_bytes=chunk_bytes,
                                            pool=pool)
                      for f in ("packed", "v_row", "v_col", "use_row")}
            if verify and _sha(fields["packed"]) != info["sha"]:
                raise IOError(f"corrupt mask for {p}")
            yield "delta", p, info, fields
            if pacer is not None:
                pacer()
    with zipfile.ZipFile(path / "extras.npz") as zf:
        for p, info in manifest["extras"].items():
            arr = _stream_npz_member(zf, p.replace(".", "__") + ".npy",
                                     chunk_bytes=chunk_bytes, pool=pool)
            if verify and _sha(arr) != info["sha"]:
                raise IOError(f"corrupt extra for {p}")
            yield "extra", p, info, arr
            if pacer is not None:
                pacer()


def save_artifact(dm: DeltaModel, out_dir, *, base_fp: Optional[str] = None,
                  meta: Optional[dict] = None,
                  lineage: Optional[dict] = None) -> dict:
    """Full publish.  ``lineage`` records {variant, version,
    parent_version} for VariantStore-managed artifacts."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    manifest = {"version": STORE_VERSION, "kind": "full",
                "base_fingerprint": base_fp, "lineage": lineage or {},
                "meta": meta or {}, "deltas": {}, "extras": {}}
    dz, ez = {}, {}
    for path, e in dm.deltas.items():
        key = path.replace(".", "__")
        w = _wire_entry(e)
        for f in ("packed", "v_row", "v_col", "use_row"):
            dz[f"{key}__{f}"] = w[f]
        manifest["deltas"][path] = {
            "packed_shape": list(w["packed"].shape),
            "scalar": bool(e.scalar),
            "sha": _sha(w["packed"]),
            "axis_counts": {
                "row": int(w["use_row"].sum()),
                "col": int(w["use_row"].size - w["use_row"].sum())},
        }
    for path, v in dm.extras.items():
        arr = _np(v).astype(np.float16)
        ez[path.replace(".", "__")] = arr
        manifest["extras"][path] = {"shape": list(arr.shape),
                                    "sha": _sha(arr)}
    np.savez(out / "deltas.npz", **dz)
    np.savez(out / "extras.npz", **ez)
    manifest["files"] = {f: (out / f).stat().st_size
                         for f in ("deltas.npz", "extras.npz")}
    manifest["artifact_bytes"] = sum(manifest["files"].values())
    _write_manifest(out, manifest)
    return manifest


def load_artifact(in_dir, *, expect_base_fp: Optional[str] = None,
                  verify: bool = True,
                  chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                  pacer: Optional[Callable[[], None]] = None) -> DeltaModel:
    """Load a FULL artifact (manifest v1, v2 or v3) as CPU tensors: packed
    uint8, fp32 vectors, bool selectors, fp16 extras, streamed per module
    (``iter_artifact_modules``: ``verify``, ``chunk_bytes`` and ``pacer``
    pass through).  Patch artifacts need their parent and load through
    ``VariantStore.load``."""
    path = pathlib.Path(in_dir)
    manifest = read_manifest(path)
    if manifest.get("kind", "full") == "full" and expect_base_fp and \
            manifest.get("base_fingerprint") and \
            manifest["base_fingerprint"] != expect_base_fp:
        raise ValueError(
            f"artifact built for base {manifest['base_fingerprint']}, "
            f"got {expect_base_fp}")
    deltas, extras = {}, {}
    for kind, p, info, payload in iter_artifact_modules(
            path, verify=verify, chunk_bytes=chunk_bytes, pacer=pacer):
        if kind == "delta":
            deltas[p] = DeltaEntry(
                packed=torch.from_numpy(payload["packed"]),
                v_row=torch.from_numpy(payload["v_row"]).to(torch.float32),
                v_col=torch.from_numpy(payload["v_col"]).to(torch.float32),
                use_row=torch.from_numpy(payload["use_row"]),
                scalar=info["scalar"])
        else:
            extras[p] = torch.from_numpy(payload)
    return DeltaModel(deltas=deltas, extras=extras)


# ---------------------------------------------------------------------------
# incremental update patches (kind="patch")
# ---------------------------------------------------------------------------

def _wire_entry(e: DeltaEntry) -> dict:
    """One delta entry in the WIRE domain (what a full publish stores):
    uint8 packed planes, fp16 vectors, bool selector."""
    return {"packed": _np(e.packed).astype(np.uint8),
            "v_row": _np(e.v_row).astype(np.float16),
            "v_col": _np(e.v_col).astype(np.float16),
            "use_row": _np(e.use_row).astype(bool)}


def save_update_patch(parent_dm: DeltaModel, new_dm: DeltaModel, out_dir, *,
                      base_fp: Optional[str] = None,
                      meta: Optional[dict] = None,
                      lineage: Optional[dict] = None) -> dict:
    """Incremental publish: ``new_dm`` as a patch against ``parent_dm`` (the
    materialised parent version).  Per changed module: the RLE-encoded XOR
    of each changed wire buffer; unchanged modules cost nothing.  The
    manifest records the sha of each patched module's result, so
    materialisation verifies against the same bar as a full publish.

    Raises ValueError when the module structure changed — publish full."""
    if set(parent_dm.deltas) != set(new_dm.deltas) or \
            set(parent_dm.extras) != set(new_dm.extras):
        raise ValueError(
            "module structure changed between versions; publish full")
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    manifest = {"version": STORE_VERSION, "kind": "patch",
                "base_fingerprint": base_fp, "lineage": lineage or {},
                "meta": meta or {}, "deltas": {}, "extras": {}}
    pz = {}

    def encode(key: str, field: str, old: np.ndarray, new: np.ndarray
               ) -> bool:
        starts, lens, lits = D.zrle_encode(D.xor_bytes(old, new))
        if starts.size == 0:
            return False
        pz[f"{key}__{field}_starts"] = starts
        pz[f"{key}__{field}_lens"] = lens
        pz[f"{key}__{field}_lits"] = lits
        return True

    for path, ne in new_dm.deltas.items():
        pe = parent_dm.deltas[path]
        if pe.scalar != ne.scalar:
            raise ValueError(
                f"{path}: scalar mode changed between versions; publish full")
        old, new = _wire_entry(pe), _wire_entry(ne)
        key = path.replace(".", "__")
        changed = [f for f in ("packed", "v_row", "v_col", "use_row")
                   if encode(key, f, old[f], new[f])]
        if not changed:
            continue                    # module untouched by this version
        manifest["deltas"][path] = {
            "packed_shape": list(new["packed"].shape),
            "scalar": bool(ne.scalar),
            "sha": _sha(new["packed"]),
            "changed": changed,
            "sizes": {f: int(new[f].nbytes)
                      for f in ("packed", "v_row", "v_col", "use_row")}}
    for path, nv in new_dm.extras.items():
        old = _np(parent_dm.extras[path]).astype(np.float16)
        new = _np(nv).astype(np.float16)
        if not encode(path.replace(".", "__"), "x", old, new):
            continue
        manifest["extras"][path] = {"shape": list(new.shape),
                                    "sha": _sha(new)}
    np.savez(out / "patch.npz", **pz)
    manifest["files"] = {"patch.npz": (out / "patch.npz").stat().st_size}
    manifest["artifact_bytes"] = manifest["files"]["patch.npz"]
    _write_manifest(out, manifest)
    return manifest


def load_update_patch(in_dir, *, verify: bool = True
                      ) -> tuple[dict, dict, dict]:
    """Read a patch artifact -> (manifest, delta_patches, extras_patches),
    the dense XOR buffers ``loader.apply_update`` consumes."""
    path = pathlib.Path(in_dir)
    manifest = read_manifest(path)
    if manifest.get("kind") != "patch":
        raise ValueError(f"{path} is not an update patch")
    if verify:
        _check_sizes(path, manifest, "patch")
    pz = np.load(path / "patch.npz")

    def decode(key: str, field: str, nbytes: int) -> np.ndarray:
        if f"{key}__{field}_starts" not in pz:
            return np.zeros(nbytes, np.uint8)      # field untouched
        return D.zrle_decode(pz[f"{key}__{field}_starts"],
                             pz[f"{key}__{field}_lens"],
                             pz[f"{key}__{field}_lits"], nbytes)

    delta_patches, extras_patches = {}, {}
    for p, info in manifest["deltas"].items():
        key = p.replace(".", "__")
        sz = info["sizes"]
        delta_patches[p] = {
            "packed": decode(key, "packed", sz["packed"]),
            "v_row": decode(key, "v_row", sz["v_row"]).view(np.uint16),
            "v_col": decode(key, "v_col", sz["v_col"]).view(np.uint16),
            "use_row": decode(key, "use_row", sz["use_row"]
                              ).view(np.bool_)}
    for p, info in manifest["extras"].items():
        key = p.replace(".", "__")
        nbytes = 2 * int(np.prod(info["shape"]))
        extras_patches[p] = decode(key, "x", nbytes).view(np.uint16)
    return manifest, delta_patches, extras_patches


# ---------------------------------------------------------------------------
# VariantStore: versioned variant library (the publish side of the
# lifecycle; serving/api.Deployment is the serving side)
# ---------------------------------------------------------------------------

class VariantStore:
    """A library of variants, each a lineage of immutable versions.

    Layout::

        root/<name>/versions.json      lineage index + ``latest`` pointer
        root/<name>/v0001/             full publish (manifest v3 + npz)
        root/<name>/v0002/             full OR patch (parent_version=1)

    Version ids are monotonic per variant (rollback moves the pointer; a
    later publish still gets max+1).  Version directories are immutable
    once the index commits, so materialised versions are cached (LRU of
    ``cache_versions``) and rollback is a constant-time pointer move.
    Publish, rollback and load hold one reentrant lock (``publish_update``
    loads its parent under it): the control thread publishes while the
    admission pipeline's ingest thread loads, and both share the
    materialisation cache and the index files.

    On a mesh (``param_shardings``, the base's spec tree, and ``mesh``)
    every rank runs the same calls over one shared directory: ``publish``,
    ``publish_update`` and ``rollback`` write from rank 0 only, which then
    sends every rank its outcome (``Mesh.share``): the other ranks read the
    committed version from the index, or raise rank 0's error, so a
    refused write raises on every rank and the ranks stay in step.  ``load``
    returns the rank's blocks (``loader.place_delta_model``): the chain
    walk itself runs on the host's whole copy of each version, so every
    patched module is still checked against the sha its publisher
    recorded, and only the rank's blocks go on to the card."""

    INDEX = "versions.json"

    def __init__(self, root, *, base_fp: Optional[str] = None,
                 cache_versions: int = 4, param_shardings=None, mesh=None):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.base_fp = base_fp
        self.cache_versions = max(1, cache_versions)
        self._cache: "collections.OrderedDict[tuple, DeltaModel]" = \
            collections.OrderedDict()
        self._lock = threading.RLock()
        self.param_shardings = param_shardings
        self.mesh = mesh

    def _write(self, name: str, fn: Callable[[], int]) -> int:
        """Run the write ``fn`` (it returns the version it committed) under
        the lock.  On a mesh only rank 0 runs it; every rank then gets
        rank 0's outcome: the version, read back from the index, or rank
        0's exception, raised on every rank."""
        if self.mesh is None:
            with self._lock:
                return fn()
        err = None
        if self.mesh.rank == 0:
            try:
                with self._lock:
                    fn()
            except Exception as e:      # sent to every rank, then raised
                err = e
        sent = None if err is None else SH.portable_error(err)
        got = self.mesh.share(sent)
        if err is not None:
            raise err
        if got is not None:
            cls, args = got
            raise cls(*args)
        return self.latest(name)

    # -- index -------------------------------------------------------------
    def _vdir(self, name: str, version: int) -> pathlib.Path:
        return self.root / name / f"v{version:04d}"

    def _read_index(self, name: str) -> dict:
        p = self.root / name / self.INDEX
        if not p.exists():
            raise KeyError(f"unknown variant {name!r}")
        try:
            return json.loads(p.read_text())
        except json.JSONDecodeError as e:
            raise IOError(f"torn or corrupt index {p}: {e}") from e

    def _write_index(self, name: str, idx: dict) -> None:
        d = self.root / name
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / (self.INDEX + ".tmp")
        tmp.write_text(json.dumps(idx, indent=2))
        os.replace(tmp, d / self.INDEX)     # pointer moves are atomic

    def names(self) -> list:
        return sorted(p.parent.name
                      for p in self.root.glob(f"*/{self.INDEX}"))

    def versions(self, name: str) -> list:
        return sorted(int(v) for v in self._read_index(name)["versions"])

    def latest(self, name: str) -> int:
        return int(self._read_index(name)["latest"])

    def version_info(self, name: str, version: int) -> dict:
        idx = self._read_index(name)
        try:
            return idx["versions"][str(version)]
        except KeyError:
            raise KeyError(f"variant {name!r} has no version {version}")

    def lineage(self, name: str, version: Optional[int] = None) -> list:
        """Version chain [full, ..., version] in patch-apply order."""
        v = self.latest(name) if version is None else version
        chain = []
        while True:
            info = self.version_info(name, v)
            chain.append(v)
            if info["kind"] == "full":
                return list(reversed(chain))
            v = int(info["parent"])

    # -- publish / update / rollback ---------------------------------------
    def _next_version(self, name: str) -> tuple[dict, int]:
        try:
            idx = self._read_index(name)
        except KeyError:
            idx = {"schema": 1, "latest": 0, "versions": {}}
        vers = [int(v) for v in idx["versions"]]
        return idx, max(vers, default=0) + 1

    @staticmethod
    def _check_name(name: str) -> None:
        """Variant names become directory names: a safe charset, no path
        traversal; '@' is reserved for ``name@vN`` version addressing."""
        ok = bool(name) and name not in (".", "..") and \
            all(c.isalnum() or c in "._-" for c in name)
        if not ok:
            raise ValueError(f"invalid variant name {name!r}")

    def _commit(self, name: str, idx: dict, v: int, kind: str, parent,
                manifest: dict) -> int:
        idx["versions"][str(v)] = {
            "kind": kind, "parent": parent, "dir": self._vdir(name, v).name,
            "artifact_bytes": manifest["artifact_bytes"]}
        idx["latest"] = v
        self._write_index(name, idx)
        return v

    def publish(self, name: str, dm: DeltaModel, *,
                meta: Optional[dict] = None) -> int:
        """Full publish: next monotonic version, latest pointer advances;
        ``meta`` lands in the manifest.  Order: payload npz -> atomic
        manifest -> atomic index; an unfinished version never becomes
        visible."""
        self._check_name(name)

        def write() -> int:
            idx, v = self._next_version(name)
            manifest = save_artifact(
                dm, self._vdir(name, v), base_fp=self.base_fp, meta=meta,
                lineage={"variant": name, "version": v,
                         "parent_version": None})
            return self._commit(name, idx, v, "full", None, manifest)
        return self._write(name, write)

    def publish_update(self, name: str, dm: DeltaModel, *,
                       meta: Optional[dict] = None) -> int:
        """Incremental publish: ``dm`` becomes the next version as a patch
        against the current latest (which must exist)."""
        self._check_name(name)

        def write() -> int:
            parent_v = self.latest(name)
            parent = self._whole(name, parent_v)
            idx, v = self._next_version(name)
            manifest = save_update_patch(
                parent, dm, self._vdir(name, v), base_fp=self.base_fp,
                meta=meta, lineage={"variant": name, "version": v,
                                    "parent_version": parent_v})
            return self._commit(name, idx, v, "patch", parent_v, manifest)
        return self._write(name, write)

    def rollback(self, name: str, to_version: Optional[int] = None) -> int:
        """Move the ``latest`` pointer back — constant time, no artifact
        IO.  Default target: the highest version id below the pointer."""
        return self._write(name,
                           lambda: self._rollback_locked(name, to_version))

    def _rollback_locked(self, name: str, to_version: Optional[int]) -> int:
        idx = self._read_index(name)
        cur = int(idx["latest"])
        if to_version is None:
            older = [int(v) for v in idx["versions"] if int(v) < cur]
            if not older:
                raise ValueError(
                    f"variant {name!r} has no version below {cur}")
            to_version = max(older)
        if str(to_version) not in idx["versions"]:
            raise KeyError(f"variant {name!r} has no version {to_version}")
        idx["latest"] = int(to_version)
        self._write_index(name, idx)
        return int(to_version)

    # -- materialisation ---------------------------------------------------
    def load(self, name: str, version: Optional[int] = None, *,
             verify: bool = True,
             pacer: Optional[Callable[[], None]] = None) -> DeltaModel:
        """Materialise a version: the nearest full ancestor (or the deepest
        cached one), then patches forward (``loader.apply_update``).
        Results are cached per (name, version).  ``pacer`` runs between the
        modules of a full artifact's streamed read and after each chain
        step; the lock is held across its sleeps, so a pacing ingest
        delays a concurrent publish and never interleaves with it.  On a
        mesh the result is the rank's blocks."""
        dm = self._whole(name, version, verify=verify, pacer=pacer)
        if self.param_shardings is None:
            return dm
        from repro_torch.core import loader as L
        return L.place_delta_model(dm, self.param_shardings, self.mesh)

    def _whole(self, name: str, version: Optional[int], *,
               verify: bool = True, pacer=None) -> DeltaModel:
        with self._lock:
            return self._load_locked(name, version, verify=verify,
                                     pacer=pacer)

    def _load_locked(self, name: str, version: Optional[int], *,
                     verify: bool, pacer) -> DeltaModel:
        from repro_torch.core import loader as L
        v = self.latest(name) if version is None else int(version)
        if (name, v) in self._cache:
            self._cache.move_to_end((name, v))
            return self._cache[(name, v)]
        chain = self.lineage(name, v)
        start = 0
        for i in range(len(chain) - 1, -1, -1):
            if (name, chain[i]) in self._cache:
                start = i
                break
        for step in chain[start:]:
            if (name, step) in self._cache:
                self._cache.move_to_end((name, step))
                continue
            vdir = self._vdir(name, step)
            info = self.version_info(name, step)
            if info["kind"] == "full":
                dm = load_artifact(vdir, expect_base_fp=self.base_fp,
                                   verify=verify, pacer=pacer)
            else:
                manifest, dpatch, epatch = load_update_patch(vdir,
                                                             verify=verify)
                if self.base_fp and manifest.get("base_fingerprint") and \
                        manifest["base_fingerprint"] != self.base_fp:
                    raise ValueError(
                        f"patch built for base "
                        f"{manifest['base_fingerprint']}, got {self.base_fp}")
                dm = L.apply_update(self._cache[(name, int(info["parent"]))],
                                    dpatch, epatch)
                if verify:
                    self._verify_patched(manifest, dm, vdir)
            self._cache[(name, step)] = dm
            if pacer is not None:
                pacer()
        dm = self._cache[(name, v)]
        self._cache.move_to_end((name, v))
        # trim after the chain walk: a parent never vanishes before its
        # patch applies
        while len(self._cache) > self.cache_versions:
            self._cache.popitem(last=False)
        return dm

    @staticmethod
    def _verify_patched(manifest: dict, dm: DeltaModel,
                        vdir: pathlib.Path) -> None:
        """Patched modules must hash to the sha the publisher recorded —
        catches corruption and a patch applied to the wrong parent."""
        for p, info in manifest["deltas"].items():
            if _sha(_np(dm.deltas[p].packed).astype(np.uint8)) != info["sha"]:
                raise IOError(f"patched mask mismatch for {p} in {vdir}")
        for p, info in manifest["extras"].items():
            if _sha(_np(dm.extras[p]).astype(np.float16)) != info["sha"]:
                raise IOError(f"patched extra mismatch for {p} in {vdir}")

    def artifact_bytes(self, name: str, version: int) -> int:
        return int(self.version_info(name, version)["artifact_bytes"])


def save_checkpoint_fp16(params, out_path) -> int:
    """Full fp16 checkpoint (the baseline the paper compares load against);
    keys are the dot-paths with '.' -> '__'.  Returns its bytes on disk."""
    flat = {path.replace(".", "__"): _np(leaf).astype(np.float16)
            for path, leaf in flatten_params(params).items()}
    p = pathlib.Path(out_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, **flat)
    return p.stat().st_size
