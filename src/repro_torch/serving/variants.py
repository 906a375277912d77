"""Multi-tenant variant registry (port of the dense/fused part of
``repro.serving.variants``): many fine-tunes over one resident base.

Residency modes:

* ``dense`` — the artifact is reconstructed into a full materialised copy
  of the params (``loader.apply_artifact``, the ``unpack_apply`` kernel).
* ``fused`` — the variant stays packed on the device as a delta overlay
  (``loader.device_put_overlay``); forward fuses it into each GEMM.

``resolve(name)`` returns ``(params, overlay)`` — overlay is None for the
base and for dense residents — through an LRU of at most ``max_resident``
residents.  Variants are versioned: residents are keyed ``name@vN``,
``set_version`` moves the serving pointer (the hot-swap) and ``rollback``
moves it back.

The overlay bank (mixed-variant batches), the int8 base and the compile
cache are not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

from repro_torch.core import loader as L
from repro_torch.core import store as S
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class _Resident:
    params: object
    overlay: Optional[dict]        # None => dense materialisation
    nbytes: int                    # device bytes added on top of the base


_MISSING = object()


class VariantRegistry:
    """Versioned serving-side variant table with one serving pointer per
    variant and an LRU of device residents keyed per version."""

    def __init__(self, base_params, *, max_resident: int = 2,
                 mode: str = "dense"):
        if mode not in ("dense", "fused"):
            raise ValueError(f"unknown residency mode {mode!r}")
        self._base_fp = S.base_fingerprint(base_params)
        self._dense_nbytes = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(base_params))
        self.base_params = base_params
        self.max_resident = max_resident
        self.mode = mode
        self._versions: dict[str, dict] = {}   # name -> {version: artifact}
        self._current: dict[str, Optional[int]] = {}   # serving pointer
        self._modes: dict[str, str] = {}          # per-variant override
        self._resident: "collections.OrderedDict[str, _Resident]" = \
            collections.OrderedDict()
        self.stats = {"swaps": 0, "hits": 0, "swap_seconds": 0.0,
                      "transferred_bytes": 0, "resident_bytes": 0,
                      "evictions": 0}

    @property
    def base_fp(self) -> str:
        return self._base_fp

    # -- names and versions ------------------------------------------------
    def _parse(self, nameish: str) -> tuple:
        """A plain name follows the serving pointer; ``name@vN`` pins N."""
        if nameish == "__base__" or nameish in self._versions:
            return nameish, self._current.get(nameish)
        if "@v" in nameish:
            name, _, tail = nameish.rpartition("@v")
            if name in self._versions and tail.isdigit() \
                    and int(tail) in self._versions[name]:
                return name, int(tail)
        raise KeyError(f"unknown variant {nameish!r}")

    @staticmethod
    def _vkey(name: str, version) -> str:
        return name if version is None else f"{name}@v{version}"

    def set_version(self, name: str, version, artifact=None,
                    mode: Optional[str] = None):
        """Register ``artifact`` under (name, version) if given, then move
        the serving pointer to ``version``; the previous version's resident
        is dropped."""
        if mode is not None:
            if mode not in ("dense", "fused"):
                raise ValueError(f"unknown residency mode {mode!r}")
            self._modes[name] = mode
        vers = self._versions.setdefault(name, {})
        if artifact is not None:
            vers[version] = artifact
        elif version not in vers:
            raise KeyError(
                f"variant {name!r} has no registered version {version}")
        prev = self._current.get(name, _MISSING)
        self._current[name] = version
        if prev is not _MISSING and prev != version:
            r = self._resident.pop(self._vkey(name, prev), None)
            if r is not None:
                self.stats["resident_bytes"] -= r.nbytes
                self.stats["evictions"] += 1
        return version

    def rollback(self, name: str, to_version=None):
        """Pointer move to a registered version (default: the highest one
        below the current pointer)."""
        if name not in self._versions:
            raise KeyError(f"unknown variant {name!r}")
        if to_version is None:
            cur = self._current.get(name)
            older = [v for v in self._versions[name]
                     if v is not None and (cur is None or v < cur)]
            if not older:
                raise ValueError(
                    f"variant {name!r} has no version below {cur}")
            to_version = max(older)
        return self.set_version(name, to_version)

    def registered(self) -> list:
        return ["__base__"] + sorted(self._versions)

    def versions(self, name: str) -> list:
        if name not in self._versions:
            raise KeyError(f"unknown variant {name!r}")
        return sorted(v for v in self._versions[name] if v is not None)

    def current_version(self, nameish: str):
        return self._parse(nameish)[1]

    def next_version(self, name: str) -> int:
        known = [v for v in self._versions.get(name, {}) if v is not None]
        return max(known, default=0) + 1

    def has_variant(self, name: str) -> bool:
        return name in self._versions

    def variant_mode(self, nameish: str) -> str:
        name = self._parse(nameish)[0] if nameish != "__base__" else nameish
        return self._modes.get(name, self.mode)

    # -- resolution --------------------------------------------------------
    def resolve(self, nameish: str):
        """(params, overlay) for a variant's current version (or an explicit
        ``name@vN``), LRU-cached per version key; '__base__' serves the
        resident base."""
        if nameish == "__base__":
            return self.base_params, None
        name, version = self._parse(nameish)
        vkey = self._vkey(name, version)
        if vkey in self._resident:
            self._resident.move_to_end(vkey)
            self.stats["hits"] += 1
            r = self._resident[vkey]
            return r.params, r.overlay
        dm = self._versions[name][version]
        if self.variant_mode(name) == "fused":
            params, overlay, st = L.device_put_overlay(self.base_params, dm)
            nbytes = L.fused_resident_bytes(self.base_params, params, overlay)
        else:
            params, st = L.apply_artifact(self.base_params, dm)
            overlay, nbytes = None, self._dense_nbytes
        self.stats["swaps"] += 1
        self.stats["swap_seconds"] += st["seconds"]
        self.stats["transferred_bytes"] += st["transferred_bytes"]
        resident = _Resident(params, overlay, nbytes)
        self._resident[vkey] = resident
        self.stats["resident_bytes"] += nbytes
        while len(self._resident) > self.max_resident:
            _, evicted = self._resident.popitem(last=False)   # evict LRU
            self.stats["resident_bytes"] -= evicted.nbytes
            self.stats["evictions"] += 1
        return resident.params, resident.overlay
