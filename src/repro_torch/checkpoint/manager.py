"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``):
atomic, hashed, retained, resumable.

Layout: <dir>/step_<N>/ {manifest.json, arrays.npz}, written to a tmp
directory and renamed (atomic on POSIX), so a crash mid-save never leaves
a half-written checkpoint that restore would pick up.  Restore scans
newest -> oldest and skips candidates that fail integrity checks (torn
files from a dead writer, bit rot).  A checkpoint that is whole but does
not fit the template (another model's keys, shapes or dtypes) is no torn
one: it raises :class:`TemplateMismatch`, so a run started with another
configuration on the same directory stops before it could overwrite it.

The on-disk format is the JAX package's: the same flat keys (a dataclass
field is ``.name``, a dict key its name, joined by ``__``: ``.step``,
``.params__layers__attn__wk``, ``.opt__.count``), the same dtypes (a Python
int leaf, such as ``TrainState.step``, as an int32 scalar), the same
16-hex sha256 prefix of each array's C-order bytes, and ``arrays.npz`` as
``np.savez`` writes it.  Each package restores the other's checkpoints.
Leaves are written one at a time (copied to the host, hashed from the
array's own buffer, streamed into the archive), so the host holds one
leaf, not the whole state.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import shutil
import time
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.bridge import to_numpy, to_tensor

# what a torn or corrupt checkpoint raises on restore
_TORN = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


class TemplateMismatch(Exception):
    """A whole checkpoint that does not fit the restore template: a key of
    the template missing from its manifest, another shape, or an integer
    leaf where the template holds a float one (or the reverse)."""


def _items(tree, prefix=()):
    """(key path, leaf) pairs in the JAX package's flattening order: dict
    keys sorted, dataclass fields in declaration order, None no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _items(getattr(tree, f.name), prefix + ("." + f.name,))
    else:
        yield prefix, tree


def _flat(tree) -> dict:
    """{flat key: leaf}, the JAX package's ``_flat`` keys."""
    return {"__".join(path): leaf for path, leaf in _items(tree)}


def _rebuild(template, values: dict, prefix=()):
    """``template``'s structure with each leaf taken from ``values`` by its
    flat key."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, values, prefix + (str(i),))
                              for i, v in enumerate(template))
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), values,
                             prefix + ("." + f.name,))
            for f in dataclasses.fields(template)})
    return values["__".join(prefix)]


def _host(leaf) -> np.ndarray:
    """A leaf as the array the JAX package would write: tensors copied to
    the host (bf16 as uint16 bits), Python ints as int32 scalars."""
    if isinstance(leaf, torch.Tensor):
        return to_numpy(leaf)
    return np.asarray(leaf, dtype=np.int32 if isinstance(leaf, int) else None)


def _sha(arr: np.ndarray) -> str:
    """sha256 of the C-order bytes (the JAX package's digest), hashed from
    the array's own buffer without a copy."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha256(flat).hexdigest()[:16]


def _is_float(dtype: str) -> bool:
    """Whether a manifest dtype holds floats (bf16 is written as its uint16
    bits by the port, as ``bfloat16`` by the JAX package)."""
    return dtype in ("bfloat16", "uint16") or np.dtype(dtype).kind == "f"


def _check_fits(name: str, tensors: dict, template) -> None:
    """Raise :class:`TemplateMismatch` unless every leaf of ``template``
    has a manifest entry of its shape and dtype class."""
    for key, leaf in _flat(template).items():
        if key not in tensors:
            raise TemplateMismatch(f"{name}: no {key!r} in the checkpoint")
        info = tensors[key]
        if isinstance(leaf, torch.Tensor):
            shape, is_float = tuple(leaf.shape), leaf.is_floating_point()
        else:
            shape, is_float = (), isinstance(leaf, float)
        if tuple(info["shape"]) != shape or _is_float(info["dtype"]) != \
                is_float:
            raise TemplateMismatch(
                f"{name}:{key} is {info['dtype']}{info['shape']}, the "
                f"template's {getattr(leaf, 'dtype', type(leaf).__name__)}"
                f"{list(shape)}")


def _leaf_like(arr: np.ndarray, leaf):
    """A restored array in the template leaf's type, dtype and device."""
    if isinstance(leaf, torch.Tensor):
        # np.load hands over a fresh writable array: no copy on the host
        t = (to_tensor(arr, "cpu") if arr.dtype == np.uint16
             else torch.from_numpy(arr))
        return t.to(leaf.device).to(leaf.dtype)
    return type(leaf)(arr)


def write_arrays(file, state) -> dict:
    """Stream every leaf of ``state`` into ``file`` (a path or a writable
    binary stream) as ``np.savez`` lays an archive out (stored
    ``<key>.npy`` members), one leaf on the host at a time; returns the
    manifest's ``tensors`` entry (shape, dtype, sha of each key)."""
    tensors = {}
    with zipfile.ZipFile(file, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in _flat(state).items():
            arr = _host(leaf)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            tensors[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                            "sha": _sha(arr)}
            del arr
    return tensors


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: Any, extra_meta: Optional[dict] = None
             ) -> pathlib.Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}_{time.time_ns()}"
        tmp.mkdir(parents=True)
        manifest = {"step": int(step), "time": time.time(),
                    "meta": extra_meta or {},
                    "tensors": write_arrays(tmp / "arrays.npz", state)}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic publish
        self._retain()
        return final

    def _retain(self) -> None:
        ckpts = self.list_steps()
        for step in ckpts[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{step:08d}", ignore_errors=True)
        for p in self.dir.glob(".tmp_step_*"):   # dead writers
            shutil.rmtree(p, ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def list_steps(self) -> list:
        steps = []
        for p in self.dir.glob("step_*"):
            try:
                steps.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(steps)

    def restore_latest(self, template: Any) -> tuple[Optional[int], Any]:
        """Newest VALID checkpoint restored into template's structure;
        (None, template) if none usable.  A whole checkpoint that does not
        fit ``template`` raises :class:`TemplateMismatch`."""
        for step in reversed(self.list_steps()):
            try:
                return step, self.restore(step, template)
            except _TORN:
                continue  # torn/corrupt: fall back to the previous one
        return None, template

    def restore(self, step: int, template: Any) -> Any:
        """Checkpoint ``step`` in ``template``'s structure, each leaf on
        the template leaf's device and in its dtype; a leaf whose bytes do
        not match the manifest's sha raises ``OSError``, a manifest that
        does not fit ``template`` :class:`TemplateMismatch`."""
        path = self.dir / f"step_{step:08d}"
        tensors = json.loads((path / "manifest.json").read_text())["tensors"]
        _check_fits(path.name, tensors, template)
        out = {}
        with np.load(path / "arrays.npz") as data:
            for key, leaf in _flat(template).items():
                arr = data[key]
                if _sha(arr) != tensors[key]["sha"]:
                    raise OSError(f"integrity failure in {path.name}:{key}")
                out[key] = _leaf_like(arr, leaf)
                del arr
        return _rebuild(template, out)
