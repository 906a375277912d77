"""Multi-tenant variant registry (port of ``repro.serving.variants``
without pod-local banks): many fine-tunes over one resident base.

A registered artifact is a ``DeltaModel``, a zero-argument callable that
returns one (lazy store materialisation, ``serving/api.Deployment``) or an
artifact directory (``core/store.load_artifact``, verified against the
base's fingerprint).  A failed load counts in ``stats["load_failures"]``
and re-raises, so the engine's retry budget applies.  An unknown name
consults the ``hydrator`` hook once before raising.

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

For MIXED-VARIANT batches (the continuous scheduler) the registry also
keeps an :class:`OverlayBank`: fused residents stacked along a bank axis,
slot 0 reserved for the base, with pin/unpin guarding in-flight variants
and slot reuse on eviction.  ``bank_resolve(name)`` admits a variant and
returns its slot index — the per-batch-row ``variant_idx`` the banked
kernel consumes.

The base is held in full precision or, with ``base_dtype="int8"``, as
int8 plus one fp16 scale per output channel on every target matrix
(``core/quantize``): the fused and banked kernels and the dense load
dequantize it in their tile pass.  Artifacts are fingerprinted against the
fp base, before quantization.  On a mesh each rank quantizes its own blocks
to the single-device bytes (``quantize.quantize_base(mesh=)``) and the
registry's ``param_shardings`` carry the QuantWeight placements.
``reserve_bank`` allocates the bank before its first admit, so the
engine's warmup can capture the banked steps against it
(``core/compile_cache.CapturedStep``).

Async admission (``serving/admission``, attached as ``admission``): an
ingest thread loads a version (``_load(pacer=)``) and stages it on the
device; the serving thread commits it between steps
(``_bank_admit(block=False, transfers=)``: ``OverlayBank.admit_async``
waits on the staging events on the serving stream, then writes the slot in
place).  While a version is staging its key is marked on the bank, and
``evict`` refuses it.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

import torch

from repro_torch.core import loader as L
from repro_torch.core import quantize as Q
from repro_torch.core import store as S
from repro_torch.core.calibration import (DeltaModel, flatten_params,
                                          is_target)
from repro_torch.models import delta_overlay as DO
from repro_torch.tree import tree_leaves


class OverlayBank:
    """Stacked fused residents: one banked overlay tree whose leaves carry
    a bank axis of ``size`` slots (``delta_overlay.bank_axis``).

    * slot 0 is the BASE: zero delta vectors (Ŵ = W_b exactly) and base
      extras — ``variant_idx == 0`` means "serve this row from the base";
    * slots 1..size-1 hold fused variants (packed masks, fp16 axis vectors,
      fp16-rounded extras), admitted and evicted with slot reuse;
    * pinned variants (in-flight requests) are never evicted — ``evict``
      raises and LRU pressure skips them.

    The bank is allocated at full size on the first admit, or before it by
    ``reserve()`` from the base's calibration targets (the recipe
    ``calibration.compress`` follows), so resident-byte accounting is per
    bank, not per variant.  Admission writes one slot of every leaf in
    place (the JAX bank runs a donated jitted scatter for the same effect),
    so the bank's tensors never move: a captured step keeps reading them.
    ``tree`` stays None until the first admit, as the JAX bank does: until
    then the continuous scheduler serves without a bank."""

    def __init__(self, base_params, size: int, mesh=None):
        if size < 2:
            raise ValueError("bank needs >= 2 slots (base + 1 variant)")
        self.size = size
        self.mesh = mesh
        self._base_flat = flatten_params(base_params)
        self._flat: Optional[dict] = None   # path -> banked leaf
        self._tree: Optional[dict] = None   # nested view of _flat
        self.tree: Optional[dict] = None    # _tree, once a variant landed
        self._slots: dict = {}              # vkey -> slot
        self._pins: dict = {}               # vkey -> in-flight count
        self._lru: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self._free = list(range(size - 1, 0, -1))   # pop() -> lowest slot
        self._staging: set = set()          # vkeys mid-admission
        self.stats = {"admits": 0, "evictions": 0}

    def base_slot(self) -> int:
        """Slot serving base semantics (never admitted or evicted)."""
        return 0

    # -- structure ---------------------------------------------------------
    def _ensure_tree(self, dm: DeltaModel) -> None:
        if self._flat is None:
            self._allocate({p: DO.from_delta_entry(e)
                            for p, e in dm.deltas.items()}, set(dm.extras))
        if set(dm.deltas) != self._template_deltas or \
                set(dm.extras) != self._template_extras:
            raise ValueError(
                "variant structure differs from the bank template "
                "(all banked variants must share one calibration "
                "recipe)")
        self.tree = self._tree

    def reserve(self) -> dict:
        """Allocate the bank before the first admit, shaped as
        ``calibration.compress`` shapes a variant of the base: an entry
        for every target matrix, an extra for every other leaf.  Returns
        the banked tree (all slots serve the base until admits)."""
        if self._flat is None:
            entries = {}
            for path, w in self._base_flat.items():
                if is_target(path, w):
                    lead, (n, k) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
                    entries[path] = DO.OverlayEntry(
                        packed=torch.empty(lead + (n, k // 8),
                                           dtype=torch.uint8, device="meta"),
                        v_row=torch.empty(lead + (n,), dtype=torch.float16,
                                          device="meta"),
                        v_col=torch.empty(lead + (k,), dtype=torch.float16,
                                          device="meta"))
            self._allocate(entries, set(self._base_flat) - set(entries))
        return self._tree

    def _allocate(self, entries: dict, extras: set) -> None:
        """The bank's tensors: zero entries shaped like ``entries`` (one
        variant's, any device) and every slot of each extra holding the
        base value."""
        flat = {}
        for path, ent in entries.items():
            flat[path] = DO.bank_zeros(path, ent, self.size,
                                       device=self._base_flat[path].device)
        for path in extras:
            flat[path] = DO.bank_extra_base(path, self._base_flat[path],
                                            self.size)
        self._flat = flat
        self._template_deltas = set(entries)
        self._template_extras = set(extras)
        tree: dict = {}
        for path, leaf in flat.items():
            DO.insert_entry(tree, path, leaf)
        self._tree = tree

    def _write(self, dm: DeltaModel, slot: int, transfers=()) -> None:
        """Write one variant into ``slot`` of every leaf, in place:
        canonicalise each DeltaEntry (fp16 axis vectors, zeroed unselected
        axis) and fp16-round each extras leaf into the base dtype.  Staged
        ``transfers`` (``loader.Transfer``) order the writes on the current
        stream: they wait on every module's staging event, and the staged
        tensors are marked used on this stream, so the caching allocator
        does not hand their memory to the staging stream before the writes
        have read them."""
        staged = [f for f in transfers if f.event is not None]
        stream = torch.cuda.current_stream() if staged else None
        for f in staged:
            stream.wait_event(f.event)
        for path, e in dm.deltas.items():
            ent = DO.from_delta_entry(e)
            bank = self._flat[path]
            idx = DO.bank_index(path, slot)
            bank.packed[idx] = ent.packed.to(bank.packed.device)
            bank.v_row[idx] = ent.v_row.to(bank.v_row.device,
                                           bank.v_row.dtype)
            bank.v_col[idx] = ent.v_col.to(bank.v_col.device,
                                           bank.v_col.dtype)
        for path, v in dm.extras.items():
            bank = self._flat[path]
            idx = DO.bank_index(path, slot)
            bank[idx] = v.to(torch.float16).to(bank.device, bank.dtype)
        for f in staged:
            for t in f.tensors:
                t.record_stream(stream)

    # -- lifecycle ---------------------------------------------------------
    def holds(self, name: str) -> bool:
        return name in self._slots

    def slot_of(self, name: str) -> int:
        if name == "__base__":
            return self.base_slot()
        return self._slots[name]

    def resident(self) -> list:
        return list(self._lru)

    def has_capacity(self) -> bool:
        """A new variant can be admitted: a free slot exists or some
        resident is unpinned (evictable).  Lets callers refuse before
        paying for the admission."""
        return bool(self._free) or any(
            self._pins.get(c, 0) == 0 for c in self._lru)

    def admit(self, name: str, dm: Optional[DeltaModel],
              transfers=()) -> tuple[int, int]:
        """Place ``dm`` into a slot (reusing evicted slots, evicting the
        LRU unpinned resident when full); ``transfers`` are the staged
        copies of ``dm`` (``_write``).  A resident ``name`` is an LRU
        touch.  Returns (slot, payload_bytes)."""
        if name == "__base__":
            return self.base_slot(), 0
        if name in self._slots:
            self._lru.move_to_end(name)
            return self._slots[name], 0
        self._ensure_tree(dm)
        if not self._free:
            for cand in self._lru:
                if self._pins.get(cand, 0) == 0:
                    # the slot is reassigned at once and admit overwrites
                    # every leaf of it: skip the clear
                    self._release(cand, clear=False)
                    break
            else:
                raise RuntimeError(
                    "overlay bank full: every resident is pinned by an "
                    "in-flight request")
        slot = self._free.pop()
        payload = sum(e.packed.numel() + 2 * e.v_row.numel()
                      + 2 * e.v_col.numel() for e in dm.deltas.values())
        payload += sum(2 * v.numel() for v in dm.extras.values())
        self._write(dm, slot, transfers)
        self._slots[name] = slot
        self._lru[name] = None
        self.stats["admits"] += 1
        return slot, payload

    def admit_async(self, name: str, dm: DeltaModel,
                    transfers=()) -> tuple:
        """``admit`` without a host fence: returns ``(slot, payload_bytes,
        fence)``, where ``fence()`` blocks until the slot writes have
        landed.  The writes run on the current (serving) stream after the
        staging events, so the next step on that stream reads the new
        slot in place with no host wait; the fence is for callers that
        need a wall-clock boundary."""
        slot, payload = self.admit(name, dm, transfers)
        if tree_leaves(self._flat)[0].is_cuda:
            done = torch.cuda.Event()
            done.record()
            fence = done.synchronize
        else:
            def fence():
                return None
        return slot, payload, fence

    # -- staging marks (async admission) -------------------------------------
    def mark_staging(self, name: str) -> None:
        self._staging.add(name)

    def unmark_staging(self, name: str) -> None:
        self._staging.discard(name)

    def staging(self, name: str) -> bool:
        return name in self._staging

    def pin(self, name: str) -> None:
        if name != "__base__":
            self._pins[name] = self._pins.get(name, 0) + 1

    def unpin(self, name: str) -> None:
        if name != "__base__" and name in self._pins:
            self._pins[name] = max(0, self._pins[name] - 1)

    def pinned(self, name: str) -> bool:
        return self._pins.get(name, 0) > 0

    def evict(self, name: str) -> None:
        """Free ``name``'s slot for reuse; refuses while the variant is
        pinned (mid-flight requests reference its slot index) or still
        staging on the admission pipeline (its commit would race the
        eviction)."""
        if self.staging(name):
            raise RuntimeError(
                f"variant {name!r} is staging on the admission pipeline; "
                "wait for the admission to land before evicting")
        if name in self._slots and self.pinned(name):
            raise RuntimeError(
                f"variant {name!r} is pinned by in-flight requests; "
                "retire them before evicting")
        if name in self._slots:
            self._release(name, clear=True)

    def _release(self, name: str, *, clear: bool) -> None:
        """Drop a resident and recycle its slot; ``clear`` resets the slot
        to base semantics (skipped when the slot is reassigned at once)."""
        slot = self._slots.pop(name)
        self._lru.pop(name, None)
        self._pins.pop(name, None)
        if clear:
            for path in self._template_deltas:
                DO.bank_clear_entry(path, self._flat[path], slot)
            for path in self._template_extras:
                DO.bank_set_extra_base(path, self._flat[path], slot,
                                       self._base_flat[path])
        self._free.append(slot)
        self.stats["evictions"] += 1

    def nbytes(self) -> int:
        if self._flat is None:
            return 0
        return DO.overlay_nbytes(self._flat)

    def per_device_nbytes(self) -> dict:
        """Resident bank bytes per device: {device: bytes} on one card,
        {rank: bytes} on a mesh (``_per_rank``)."""
        return _per_rank(self.nbytes(), self.mesh, tree_leaves(self._flat))


def _per_rank(nbytes: int, mesh, leaves) -> dict:
    """{rank: bytes} over a mesh whose ranks each hold ``nbytes`` — every
    rank's block of a leaf has the same shape, since ``resolve_spec`` shards
    a dim only over axes that divide it — or {device: bytes} off a mesh."""
    if mesh is None:
        out: dict = {}
        for t in leaves:
            key = str(t.device)
            out[key] = out.get(key, 0) + t.numel() * t.element_size()
        return out
    return {r: nbytes for r in range(mesh.size)}


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
                 mode: str = "dense", bank_size: int = 8,
                 base_dtype: str = "fp", mesh=None, param_shardings=None,
                 param_axes=None, base_fp: Optional[str] = None):
        if mode not in ("dense", "fused"):
            raise ValueError(f"unknown residency mode {mode!r}")
        if base_dtype not in ("fp", "int8"):
            raise ValueError(f"unknown base dtype {base_dtype!r}")
        if mesh is not None:
            if param_shardings is None or param_axes is None:
                raise ValueError("a registry on a mesh needs the base's "
                                 "param_shardings and param_axes")
        self.mesh = mesh
        self.param_axes = param_axes
        # fingerprint and dense-copy accounting come from the FP base:
        # artifacts are calibrated against (and verified by) the full-
        # precision weights, and a dense resident reconstructs to fp
        self._base_fp = base_fp or S.base_fingerprint(base_params)
        self._dense_nbytes = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(base_params))
        self.base_dtype = base_dtype
        self.quant_stats = None
        if base_dtype == "int8":
            # on a mesh each rank quantizes its placed blocks, the row
            # absmax all-reduced over a sharded in dim, and the spec tree
            # takes the QuantWeight placements (quant_sharding)
            base_params, param_shardings, self.quant_stats = \
                Q.quantize_base(base_params, param_shardings, mesh)
        self.param_shardings = param_shardings
        self.base_params = base_params
        self.max_resident = max_resident
        self.mode = mode
        self.bank_size = bank_size
        self.bank: Optional[OverlayBank] = None   # created on first use
        self._bank_lock = threading.Lock()
        self._bank_evictions_seen = 0
        # serving/admission.AdmissionPipeline of an async deployment
        self.admission = None
        # lazy-hydration hook (serving/api.Deployment): called with a
        # variant name when _parse misses; True -> retry the parse
        self.hydrator = None
        self._versions: dict[str, dict] = {}   # name -> {version: artifact}
        self._current: dict[str, Optional[int]] = {}   # serving pointer
        self._modes: dict[str, str] = {}          # per-variant override
        self._resident: "collections.OrderedDict[str, _Resident]" = \
            collections.OrderedDict()
        self.stats = {"swaps": 0, "hits": 0, "swap_seconds": 0.0,
                      "transferred_bytes": 0, "load_failures": 0,
                      "resident_bytes": 0, "evictions": 0}

    @property
    def base_fp(self) -> str:
        return self._base_fp

    @property
    def device(self) -> torch.device:
        """The device the base (and every resident) lives on."""
        return tree_leaves(self.base_params)[0].device

    # -- base residency accounting -----------------------------------------
    def base_nbytes(self) -> int:
        """Resident base-weight bytes (int8 payloads + scales when
        quantized: a QuantWeight's leaves are both tensors)."""
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self.base_params))

    def base_per_device_nbytes(self) -> dict:
        """{device -> resident base-weight bytes} on one card; {rank ->
        bytes of its blocks} on a mesh."""
        return _per_rank(self.base_nbytes(), self.mesh,
                         tree_leaves(self.base_params))

    # -- names and versions ------------------------------------------------
    def _parse(self, nameish: str) -> tuple:
        """A plain name follows the serving pointer; ``name@vN`` pins N.
        An unknown name consults the ``hydrator`` once before raising."""
        try:
            return self._parse_known(nameish)
        except KeyError:
            if self.hydrator is None:
                raise
            base = nameish.rpartition("@v")[0] if "@v" in nameish \
                else nameish
            if not self.hydrator(base):
                raise
            return self._parse_known(nameish)

    def _parse_known(self, nameish: str) -> tuple:
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

    def register(self, name: str, artifact, mode: Optional[str] = None
                 ) -> None:
        """Unversioned registration (``set_version(name, None, ...)``):
        ``artifact`` as ``set_version`` takes it; ``mode`` overrides the
        registry's residency mode for this variant."""
        self.set_version(name, None, artifact, mode=mode)

    def set_version(self, name: str, version, artifact=None,
                    mode: Optional[str] = None):
        """Register ``artifact`` (a DeltaModel, a zero-argument callable
        returning one, or an artifact directory) under (name, version) if
        given, then move the serving pointer to ``version``; the previous
        version's resident is dropped."""
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
        dm = self._load(name, version)
        if self.variant_mode(name) == "fused":
            params, overlay, st = L.device_put_overlay(self.base_params, dm)
            nbytes = L.fused_resident_bytes(self.base_params, params, overlay)
        else:
            params, st = L.apply_artifact(self.base_params, dm,
                                          param_axes=self.param_axes)
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

    def params_for(self, name: str):
        """Materialised params of a dense-mode variant (or the base).  A
        fused-mode variant raises before anything loads or the LRU and
        swap counters move: use ``resolve``."""
        if name != "__base__" and self.variant_mode(name) == "fused":
            raise ValueError(
                f"variant {name!r} is fused-mode (packed overlay); "
                "use resolve() to get (params, overlay)")
        return self.resolve(name)[0]

    def resident(self) -> list:
        """Version keys of the dense and fused residents, LRU first (the
        bank's residents: ``bank.resident()``)."""
        return list(self._resident)

    def resident_nbytes(self, nameish: str) -> int:
        """Device bytes a resident adds on top of the base (by name,
        ``name@vN`` or version key); KeyError when it is not resident."""
        return self._resident[self._bank_key(nameish)].nbytes

    def _load(self, name: str, version, pacer=None) -> DeltaModel:
        """The registered artifact of (name, version) as a DeltaModel.
        ``pacer`` (the admission worker's) reaches the streamed read of an
        artifact directory and of a callable that advertises
        ``accepts_pacer`` (``Deployment._store_ref``); other callables keep
        their zero-argument contract."""
        art = self._versions[name][version]
        if isinstance(art, DeltaModel):
            return self._local(art)
        try:
            if callable(art):
                if pacer is not None and getattr(art, "accepts_pacer",
                                                 False):
                    return self._local(art(pacer=pacer))
                return self._local(art())
            return self._local(S.load_artifact(
                str(art), expect_base_fp=self._base_fp, pacer=pacer))
        except Exception:
            # a corrupt or missing artifact must not take the node down:
            # count it and let the engine re-queue or fail the request
            self.stats["load_failures"] += 1
            raise

    def _local(self, dm: DeltaModel) -> DeltaModel:
        """``dm`` as this rank holds it: its blocks on a mesh (a placed
        variant, such as a mesh store returns, passes through)."""
        if self.mesh is None:
            return dm
        return L.place_delta_model(dm, self.param_shardings, self.mesh)

    # -- banked resolution (mixed-variant batches) -------------------------
    def _ensure_bank(self) -> OverlayBank:
        """The overlay bank, created on first use, once: the serving thread
        and the admission pipeline (marking a ticket) may both come
        first."""
        with self._bank_lock:
            if self.bank is None:
                self.bank = OverlayBank(self.base_params, self.bank_size,
                                        mesh=self.mesh)
            return self.bank

    def reserve_bank(self) -> dict:
        """Allocate the overlay bank now, before its first admit
        (``OverlayBank.reserve``), and return its tree: warmup captures the
        banked steps against the tensors later admits write into.  The
        bank's bytes count as resident from here."""
        bank = self._ensure_bank()
        before = bank.nbytes()
        tree = bank.reserve()
        self.stats["resident_bytes"] += bank.nbytes() - before
        return tree

    def _bank_admit(self, vkey: str, dm: DeltaModel, *, block: bool = True,
                    transfers=()) -> int:
        """Write ``dm`` into the bank under ``vkey`` and book the swap
        stats (the one path of the synchronous admit and the admission
        pipeline's commit); ``resident_bytes`` tracks the bank allocation
        (charged when the bank is allocated, not per admitted variant).
        ``block=False`` skips the host fence: the writes are queued on the
        serving stream, after ``transfers``' staging events, ahead of the
        next step."""
        bank = self._ensure_bank()
        before = bank.nbytes()
        t0 = time.perf_counter()
        slot, payload, fence = bank.admit_async(vkey, dm, transfers)
        if block:
            fence()
        self.stats["swaps"] += 1
        self.stats["swap_seconds"] += time.perf_counter() - t0
        self.stats["transferred_bytes"] += payload
        self.stats["resident_bytes"] += bank.nbytes() - before
        self.stats["evictions"] += (bank.stats["evictions"]
                                    - self._bank_evictions_seen)
        self._bank_evictions_seen = bank.stats["evictions"]
        return slot

    def bank_resolve(self, nameish: str) -> int:
        """Admit the current version of ``nameish`` (or an explicit
        ``name@vN``) into the overlay bank and return its slot index — the
        per-row ``variant_idx`` value; '__base__' is slot 0."""
        bank = self._ensure_bank()
        if nameish == "__base__":
            return bank.base_slot()
        name, version = self._parse(nameish)
        vkey = self._vkey(name, version)
        if bank.holds(vkey):
            self.stats["hits"] += 1
            return bank.admit(vkey, None)[0]   # LRU touch, no payload
        if bank.tree is not None and not bank.has_capacity():
            raise RuntimeError(
                "overlay bank full: every resident is pinned by an "
                "in-flight request")
        return self._bank_admit(vkey, self._load(name, version))

    def bank_acquire(self, nameish: str) -> tuple:
        """Admit AND pin in one step: returns (slot, version_key).  The
        caller unpins with the returned KEY, not the request's variant
        name: the serving pointer may move while the request is in flight,
        and the pin must stay on the version the request decodes."""
        slot = self.bank_resolve(nameish)
        vkey = "__base__" if nameish == "__base__" \
            else self._vkey(*self._parse(nameish))
        self.bank.pin(vkey)
        return slot, vkey

    def spec_resolve(self) -> tuple:
        """The speculative scheduler's weights: (draft params, verify
        bank).  Drafts serve the base through the shared base params with
        overlay None (no delta kernel in a draft step); the verify serves
        every lane's variant through the same bank and per-row slots the
        continuous scheduler decodes with, so admission, pinning, hot-swap
        and rollback behave alike under both.  The bank is None until the
        first variant admission."""
        return self.base_params, (self.bank.tree if self.bank else None)

    def _bank_key(self, nameish: str) -> str:
        """Caller-facing name -> bank/resident key: version keys and
        unversioned names pass through; plain names of versioned variants
        follow the serving pointer."""
        if nameish == "__base__":
            return nameish
        if self.bank is not None and self.bank.holds(nameish):
            return nameish
        if nameish in self._resident:
            return nameish
        try:
            return self._vkey(*self._parse(nameish))
        except KeyError:
            return nameish

    def bank_pin(self, nameish: str) -> None:
        if self.bank is not None:
            self.bank.pin(self._bank_key(nameish))

    def bank_unpin(self, nameish: str) -> None:
        if self.bank is not None:
            self.bank.unpin(self._bank_key(nameish))

    def evict(self, nameish: str) -> None:
        """Evict a variant's device residency by name (current version),
        explicit ``name@vN``, or raw version key.  A banked variant still
        staging on the admission pipeline, or pinned by in-flight requests,
        is refused before anything is dropped."""
        key = self._bank_key(nameish)
        if self.bank is not None and self.bank.staging(key):
            raise RuntimeError(
                f"variant {key!r} is staging on the admission pipeline; "
                "wait for the admission to land before evicting")
        if self.bank is not None and self.bank.pinned(key):
            raise RuntimeError(
                f"variant {key!r} is pinned by in-flight requests; "
                "retire them before evicting")
        r = self._resident.pop(key, None)
        if r is not None:
            self.stats["resident_bytes"] -= r.nbytes
            self.stats["evictions"] += 1
        if self.bank is not None and self.bank.holds(key):
            # bank bytes stay allocated: the slot is reusable, not freed
            before = self.bank.stats["evictions"]
            self.bank.evict(key)
            self.stats["evictions"] += self.bank.stats["evictions"] - before
            self._bank_evictions_seen = self.bank.stats["evictions"]
