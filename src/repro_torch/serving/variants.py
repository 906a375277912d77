"""Multi-tenant variant registry (port of ``repro.serving.variants``):
many fine-tunes over one resident base.

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
kernel consumes.  With ``pod_banks=True`` on a mesh with a "pod" axis the
bank is pod-local (``OverlayBank(pods=)``): each pod has its own slot
table, pins, LRU and free list over its own range of global slot ids, and
``bank_resolve``/``bank_acquire``/``bank_pin``/``bank_unpin`` take the pod
the engine's affinity router chose (``bank_pods_holding`` is its signal).
An MoE model's pod bank is the dense family's recipe over its leaves: a
stacked entry for each expert stack, the router and every other leaf as
extras, reserved and admitted per pod, and counted in the admission bytes
by the same rule.  ``reserve_bank`` under pod-local banks allocates this
pod's slots only, shaped as the first admission into the pod would
allocate them (``OverlayBank.reserve``).

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
    then the continuous scheduler serves without a bank.

    POD-LOCAL banks (``pods`` > 1, on a mesh whose "pod" axis has that
    size; DESIGN.md §17): the slot space grows to ``pods * size`` GLOBAL
    slots, pod p owning [p*size, (p+1)*size) with its base slot p*size.
    Slot table, pins, LRU and free list are kept per pod, so two pods admit
    and evict independently, and every slot id this class returns is
    global.  A rank holds only its own pod's ``size`` slots of every leaf
    (``pod``): the engine hands its kernels pod-local ids (global - p*size).
    Every rank keeps every pod's host tables, so the router on every rank
    makes the same choice; only pod p's ranks write an admission into pod
    p (``writes``), and their bank is allocated from the base's recipe
    (``reserve``) on every rank at the first admit into any pod, as the
    JAX bank allocates its whole slot axis."""

    def __init__(self, base_params, size: int, mesh=None, pods: int = 1):
        if size < 2:
            raise ValueError("bank needs >= 2 slots (base + 1 variant)")
        if pods < 1:
            raise ValueError("pods must be >= 1")
        self.size = size                    # slots PER POD (incl. base)
        self.pods = pods
        self.total_slots = size * pods
        self.mesh = mesh
        # the pods the mesh spans (1 without a "pod" axis): the copies of a
        # bank replicated over them, the cross-pod term of the admission
        # byte accounting
        self._mesh_pods = (mesh.axis_size("pod") or 1) if mesh is not None \
            else 1
        if pods > 1 and pods != self._mesh_pods:
            raise ValueError(
                f"pod-local bank with pods={pods} needs a mesh whose 'pod' "
                f"axis has that size (the mesh spans {self._mesh_pods})")
        # the pod whose slot range this rank holds
        self.pod = mesh.coord("pod") if pods > 1 else 0
        self._base_flat = flatten_params(base_params)
        self._flat: Optional[dict] = None   # path -> banked leaf
        self._tree: Optional[dict] = None   # nested view of _flat
        self.tree: Optional[dict] = None    # _tree, once a variant landed
        self._slot_bytes = 0                # one variant's payload here
        # per-pod residency state; LOCAL slot ids (0 = the pod's base)
        self._pod_slots: list = [dict() for _ in range(pods)]
        self._pins: list = [dict() for _ in range(pods)]
        self._lru: list = [collections.OrderedDict() for _ in range(pods)]
        self._free: list = [list(range(size - 1, 0, -1))
                            for _ in range(pods)]   # pop() -> lowest slot
        self._staging: set = set()          # (pod, vkey) mid-admission
        self.stats = {"admits": 0, "evictions": 0,
                      # one payload lands in the admitting pod; a bank
                      # replicated over the mesh's pods writes (pods - 1)
                      # more copies across them, a pod-local bank none
                      "admit_bytes_in_pod": 0, "admit_bytes_cross_pod": 0}

    @property
    def _slots(self) -> dict:
        """Merged view {vkey -> GLOBAL slot} across pods (the first pod
        holding it)."""
        out: dict = {}
        for p, table in enumerate(self._pod_slots):
            for name, local in table.items():
                out.setdefault(name, self._global(p, local))
        return out

    def _global(self, pod: int, local: int) -> int:
        return pod * self.size + local

    def base_slot(self, pod: int = 0) -> int:
        """GLOBAL slot serving base semantics for ``pod`` (never admitted
        or evicted)."""
        return pod * self.size

    def writes(self, pod: int) -> bool:
        """This rank holds ``pod``'s slots (every rank, off pod-local
        banks): an admission into ``pod`` reads the artifact and writes
        its slot here."""
        return self.pods == 1 or pod == self.pod

    # -- structure ---------------------------------------------------------
    def _ensure_tree(self, dm: Optional[DeltaModel]) -> None:
        if self._flat is None:
            if self.pods > 1:
                self.reserve()
            else:
                self._allocate({p: DO.from_delta_entry(e)
                                for p, e in dm.deltas.items()},
                               set(dm.extras))
        if dm is not None:
            self.check(dm)
        self.tree = self._tree

    def check(self, dm: DeltaModel) -> None:
        """Raise unless ``dm`` has the bank's structure: the template's
        entries and extras (the base's recipe on a pod-local bank, before
        the bank is allocated)."""
        if self._flat is None and self.pods > 1:
            entries, extras = self._recipe()
            deltas, extra = set(entries), set(extras)
        elif self._flat is None:
            return
        else:
            deltas, extra = self._template_deltas, self._template_extras
        if set(dm.deltas) != deltas or set(dm.extras) != extra:
            raise ValueError(
                "variant structure differs from the bank template "
                "(all banked variants must share one calibration "
                "recipe)")

    def _recipe(self) -> tuple:
        """({target path: meta OverlayEntry}, {other paths}) of the base,
        shaped as ``calibration.compress`` shapes a variant."""
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
        return entries, set(self._base_flat) - set(entries)

    def reserve(self) -> dict:
        """Allocate the bank before the first admit, shaped as
        ``calibration.compress`` shapes a variant of the base: an entry
        for every target matrix, an extra for every other leaf.  Returns
        the banked tree (all slots serve the base until admits)."""
        if self._flat is None:
            self._allocate(*self._recipe())
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
        # the template before the tensors: the ingest worker checks a
        # variant against it (``check``) while the serving thread allocates
        self._template_deltas = set(entries)
        self._template_extras = set(extras)
        self._flat = flat
        # one variant's payload on this rank (the admission-byte unit)
        idx = {p: DO.bank_index(p, 0) for p in flat}
        self._slot_bytes = sum(
            e.packed[idx[p]].numel() + 2 * e.v_row[idx[p]].numel()
            + 2 * e.v_col[idx[p]].numel() for p, e in flat.items()
            if p in entries)
        self._slot_bytes += sum(2 * flat[p][idx[p]].numel() for p in extras)
        tree: dict = {}
        for path, leaf in flat.items():
            DO.insert_entry(tree, path, leaf)
        self._tree = tree

    def _write(self, dm: DeltaModel, slot: int, transfers=()) -> None:
        """Write one variant into local ``slot`` of every leaf, in place:
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
            # rounded to fp16 on the bank's device (a host copy of a
            # full-width embedding table would round on the CPU)
            bank[idx] = v.to(bank.device).to(torch.float16).to(bank.dtype)
        for f in staged:
            for t in f.tensors:
                t.record_stream(stream)

    # -- lifecycle ---------------------------------------------------------
    def holds(self, name: str, pod: Optional[int] = None) -> bool:
        """``name`` resident in ``pod`` (in any pod when None)."""
        if pod is not None:
            return name in self._pod_slots[pod]
        return any(name in t for t in self._pod_slots)

    def pods_holding(self, name: str) -> list:
        """Pods where ``name`` is resident: the affinity router's
        signal."""
        return [p for p, t in enumerate(self._pod_slots) if name in t]

    def slot_of(self, name: str, pod: int = 0) -> int:
        if name == "__base__":
            return self.base_slot(pod)
        return self._global(pod, self._pod_slots[pod][name])

    def resident(self, pod: Optional[int] = None) -> list:
        if pod is not None:
            return list(self._lru[pod])
        seen: dict = {}
        for lru in self._lru:
            for name in lru:
                seen.setdefault(name, None)
        return list(seen)

    def pod_resident(self) -> dict:
        """{pod -> [resident version keys], LRU first}."""
        return {p: list(lru) for p, lru in enumerate(self._lru)}

    def has_capacity(self, pod: int = 0) -> bool:
        """A new variant can be admitted into ``pod``: a free slot exists
        or some resident is unpinned (evictable).  Lets callers refuse
        before paying for the admission."""
        return bool(self._free[pod]) or any(
            self._pins[pod].get(c, 0) == 0 for c in self._lru[pod])

    def admit(self, name: str, dm: Optional[DeltaModel], pod: int = 0,
              transfers=()) -> tuple[int, int]:
        """Place ``dm`` into a slot of ``pod`` (reusing evicted slots,
        evicting the pod's LRU unpinned resident when full); ``transfers``
        are the staged copies of ``dm`` (``_write``).  A resident ``name``
        is an LRU touch.  A rank outside ``pod`` (``writes``) takes
        ``dm=None`` and books the slot without writing.  Returns (GLOBAL
        slot, bytes written on this rank)."""
        if name == "__base__":
            return self.base_slot(pod), 0
        table = self._pod_slots[pod]
        if name in table:
            self._lru[pod].move_to_end(name)
            return self._global(pod, table[name]), 0
        self._ensure_tree(dm if self.writes(pod) else None)
        if not self._free[pod]:
            for cand in self._lru[pod]:
                if self._pins[pod].get(cand, 0) == 0:
                    # the slot is reassigned at once and admit overwrites
                    # every leaf of it: skip the clear
                    self._release(cand, pod, clear=False)
                    break
            else:
                raise RuntimeError(
                    f"overlay bank full (pod {pod}): every resident is "
                    "pinned by an in-flight request")
        local = self._free[pod].pop()
        payload = 0
        if self.writes(pod):
            payload = sum(e.packed.numel() + 2 * e.v_row.numel()
                          + 2 * e.v_col.numel() for e in dm.deltas.values())
            payload += sum(2 * v.numel() for v in dm.extras.values())
            self._write(dm, local, transfers)
        table[name] = local
        self._lru[pod][name] = None
        self.stats["admits"] += 1
        # a pod-local bank puts the slot on one pod's ranks; a replicated
        # one puts a copy on every pod of the mesh
        copies = 1 if self.pods > 1 else self._mesh_pods
        self.stats["admit_bytes_in_pod"] += self._slot_bytes
        self.stats["admit_bytes_cross_pod"] += self._slot_bytes * (copies - 1)
        return self._global(pod, local), payload

    def admit_async(self, name: str, dm: Optional[DeltaModel],
                    transfers=(), pod: int = 0) -> tuple:
        """``admit`` without a host fence: returns ``(slot, payload_bytes,
        fence)``, where ``fence()`` blocks until the slot writes have
        landed.  The writes run on the current (serving) stream after the
        staging events, so the next step on that stream reads the new
        slot in place with no host wait; the fence is for callers that
        need a wall-clock boundary."""
        slot, payload = self.admit(name, dm, pod, transfers)
        if tree_leaves(self._flat)[0].is_cuda:
            done = torch.cuda.Event()
            done.record()
            fence = done.synchronize
        else:
            def fence():
                return None
        return slot, payload, fence

    # -- staging marks (async admission) -------------------------------------
    def mark_staging(self, name: str, pod: int = 0) -> None:
        self._staging.add((pod, name))

    def unmark_staging(self, name: str, pod: int = 0) -> None:
        self._staging.discard((pod, name))

    def staging(self, name: str, pod: Optional[int] = None) -> bool:
        if pod is not None:
            return (pod, name) in self._staging
        return any(n == name for _, n in self._staging)

    def pin(self, name: str, pod: int = 0) -> None:
        if name != "__base__":
            pins = self._pins[pod]
            pins[name] = pins.get(name, 0) + 1

    def unpin(self, name: str, pod: int = 0) -> None:
        pins = self._pins[pod]
        if name != "__base__" and name in pins:
            pins[name] = max(0, pins[name] - 1)

    def pinned(self, name: str, pod: Optional[int] = None) -> bool:
        if pod is not None:
            return self._pins[pod].get(name, 0) > 0
        return any(p.get(name, 0) > 0 for p in self._pins)

    def evict(self, name: str, pod: Optional[int] = None) -> None:
        """Free ``name``'s slot in ``pod`` (in every holding pod when None)
        for reuse; refuses while the variant is pinned (mid-flight
        requests reference its slot index) or still staging on the
        admission pipeline (its commit would race the eviction)."""
        pods = [pod] if pod is not None else self.pods_holding(name)
        if self.staging(name, pod):
            raise RuntimeError(
                f"variant {name!r} is staging on the admission pipeline; "
                "wait for the admission to land before evicting")
        for p in pods:
            if name in self._pod_slots[p] and self.pinned(name, p):
                raise RuntimeError(
                    f"variant {name!r} is pinned by in-flight requests "
                    f"(pod {p}); retire them before evicting")
        for p in pods:
            if name in self._pod_slots[p]:
                self._release(name, p, clear=True)

    def _release(self, name: str, pod: int, *, clear: bool) -> None:
        """Drop a resident of ``pod`` and recycle its slot; ``clear``
        resets the slot to base semantics where this rank holds it
        (skipped when the slot is reassigned at once)."""
        local = self._pod_slots[pod].pop(name)
        self._lru[pod].pop(name, None)
        self._pins[pod].pop(name, None)
        if clear and self.writes(pod):
            for path in self._template_deltas:
                DO.bank_clear_entry(path, self._flat[path], local)
            for path in self._template_extras:
                DO.bank_set_extra_base(path, self._flat[path], local,
                                       self._base_flat[path])
        self._free[pod].append(local)
        self.stats["evictions"] += 1

    def nbytes(self) -> int:
        """This rank's bank bytes (on a pod-local bank: its pod's slots)."""
        if self._flat is None:
            return 0
        return DO.overlay_nbytes(self._flat)

    def per_device_nbytes(self) -> dict:
        """Resident bank bytes per device: {device: bytes} on one card,
        {rank: bytes} on a mesh (``_per_rank``)."""
        return _per_rank(self.nbytes(), self.mesh, tree_leaves(self._flat))

    def per_pod_nbytes(self) -> dict:
        """{pod -> bank bytes its ranks hold}: ``per_device_nbytes`` summed
        by the ranks' pod coordinate (pod 0 holds all without a "pod"
        axis).  A pod-local bank shows each pod holding its own slot
        range; a replicated one the whole bank in every pod."""
        if self._flat is None:
            return {}
        per = self.per_device_nbytes()
        if self.mesh is None or self._mesh_pods == 1:
            return {0: sum(per.values())} if per else {}
        per_pod = self.mesh.size // self._mesh_pods    # "pod" leads
        out: dict = {}
        for r, nbytes in per.items():
            out[r // per_pod] = out.get(r // per_pod, 0) + nbytes
        return out


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
                 param_axes=None, base_fp: Optional[str] = None,
                 pod_banks: bool = False):
        if mode not in ("dense", "fused"):
            raise ValueError(f"unknown residency mode {mode!r}")
        if base_dtype not in ("fp", "int8"):
            raise ValueError(f"unknown base dtype {base_dtype!r}")
        # pod-local overlay banks: the bank's slot space splits per pod of
        # the mesh's "pod" axis (OverlayBank(pods=)); off, one bank
        # replicated over the mesh
        self.pod_banks = pod_banks
        self.pods = 1
        if pod_banks:
            if mesh is None:
                raise ValueError(
                    "pod_banks=True needs a mesh with a 'pod' axis "
                    "(launch.mesh.make_host_mesh(pod=...))")
            if mesh.axis_size("pod") is None:
                raise ValueError(
                    "pod_banks=True but the mesh has no 'pod' axis")
            self.pods = mesh.axis_size("pod")
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
                                        mesh=self.mesh, pods=self.pods)
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

    def _bank_admit(self, vkey: str, dm: Optional[DeltaModel], *,
                    block: bool = True, transfers=(), pod: int = 0) -> int:
        """Write ``dm`` into ``pod``'s slots of the bank under ``vkey`` and
        book the swap stats (the one path of the synchronous admit and the
        admission pipeline's commit); ``resident_bytes`` tracks the bank
        allocation (charged when the bank is allocated, not per admitted
        variant).  ``block=False`` skips the host fence: the writes are
        queued on the serving stream, after ``transfers``' staging events,
        ahead of the next step.  A rank outside ``pod`` passes ``dm=None``
        and books the slot alone."""
        bank = self._ensure_bank()
        before = bank.nbytes()
        t0 = time.perf_counter()
        slot, payload, fence = bank.admit_async(vkey, dm, transfers, pod)
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

    def bank_resolve(self, nameish: str, pod: int = 0) -> int:
        """Admit the current version of ``nameish`` (or an explicit
        ``name@vN``) into ``pod``'s slots of the overlay bank and return
        its GLOBAL slot index — the per-row ``variant_idx`` value;
        '__base__' is the pod's base slot (slot 0 off pod-local banks)."""
        bank = self._ensure_bank()
        if nameish == "__base__":
            return bank.base_slot(pod)
        name, version = self._parse(nameish)
        vkey = self._vkey(name, version)
        if bank.holds(vkey, pod):
            self.stats["hits"] += 1
            return bank.admit(vkey, None, pod)[0]   # LRU touch, no payload
        if bank.tree is not None and not bank.has_capacity(pod):
            raise RuntimeError(
                f"overlay bank full (pod {pod}): every resident is pinned "
                "by an in-flight request")
        return self._bank_admit(vkey, self._pod_load(name, version, pod),
                                pod=pod)

    def _pod_load(self, name: str, version, pod: int):
        """The variant an admission into ``pod`` writes: loaded where this
        rank holds ``pod``'s slots, None elsewhere.  On a pod-local bank the
        ranks then agree (``Mesh.raise_first``): a load or a structure
        check that fails on any rank raises its error on every rank, so
        every rank's tables stay the same."""
        bank = self._ensure_bank()
        if self.pods == 1:
            return self._load(name, version)
        dm, err = None, None
        if bank.writes(pod):
            try:
                dm = self._load(name, version)
                bank.check(dm)
            except Exception as e:      # noqa: BLE001 — every rank raises it
                err = e
        self.mesh.raise_first(err)
        return dm

    def bank_acquire(self, nameish: str, pod: int = 0) -> tuple:
        """Admit AND pin in one step: returns (slot, version_key).  The
        caller unpins with the returned KEY, not the request's variant
        name: the serving pointer may move while the request is in flight,
        and the pin must stay on the version the request decodes."""
        slot = self.bank_resolve(nameish, pod)
        vkey = "__base__" if nameish == "__base__" \
            else self._vkey(*self._parse(nameish))
        self.bank.pin(vkey, pod)
        return slot, vkey

    def bank_pods_holding(self, nameish: str) -> list:
        """Pods where the variant's current version is bank-resident: the
        affinity router's signal (empty before the bank exists)."""
        if self.bank is None:
            return []
        return self.bank.pods_holding(self._bank_key(nameish))

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

    def bank_pin(self, nameish: str, pod: int = 0) -> None:
        if self.bank is not None:
            self.bank.pin(self._bank_key(nameish), pod)

    def bank_unpin(self, nameish: str, pod: int = 0) -> None:
        if self.bank is not None:
            self.bank.unpin(self._bank_key(nameish), pod)

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
            # bank bytes stay allocated: the slot is reusable, not freed;
            # a pod-local bank frees the key's slot in every holding pod
            before = self.bank.stats["evictions"]
            self.bank.evict(key)
            self.stats["evictions"] += self.bank.stats["evictions"] - before
            self._bank_evictions_seen = self.bank.stats["evictions"]
